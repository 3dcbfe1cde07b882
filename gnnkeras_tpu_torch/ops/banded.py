"""Banded aggregation: the block-diagonal decomposition of a banded
operator, the counterpart of ``gnnkeras_tpu.ops.banded``.

Large banded graphs (road networks, meshes, sequence graphs) have BCSR
blocks at a few distinct tile offsets ``src_tile − dst_tile`` (band ≤ 128:
offsets {−1, 0, 1} plus a few wraparound blocks).  Each offset's blocks form
one dense block-diagonal operator in destination-tile space, so the
aggregation is a handful of diagonal products of tile-shifted state:

    out[:, j·T:(j+1)·T]  =  Σ_o  state[:, (j+o)·T:(j+o+1)·T] @ B_o[j]

Each diagonal is a slot-128 ``StripOperator`` and its product the strip
kernel (``ops/strip.py``: int8 mask + per-column scale, forward and
backward kernels).  The tile shift is a slice and a pad of the
feature-major state; autograd of the shift is the opposite shift, which is
what the transposed operator needs.  Offsets too sparse to be worth a full
diagonal (below ``min_fill`` of the tiles, e.g. the wraparound corner
blocks) ride a plain BCSR residual, plain torch ops whose transpose autograd
takes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.ops.bcsr import _MAX_BAND_FACTOR, BcsrMatrix, bcsr_aggregate_t, build_bcsr, empty_bcsr, pad_bcsr
from gnnkeras_tpu_torch.ops.strip import TILE, StripFactorError, StripOperator, _finalize_strips, strip_aggregate_t
from gnnkeras_tpu_torch.utils.pytree import register_tensor_dataclass


@dataclasses.dataclass(frozen=True)
class BandedOperator:
    """Per-offset dense-diagonal StripOperators plus the sparse remainder as
    BCSR.  ``offsets[i]`` is the tile shift of ``diags[i]``."""

    diags: Tuple[StripOperator, ...]
    residual: Optional[BcsrMatrix]
    offsets: Tuple[int, ...]
    n_tiles: int

    def to(self, device, non_blocking: bool = False) -> "BandedOperator":
        mv = lambda x: x.to(device, non_blocking=non_blocking)
        return dataclasses.replace(self, diags=tuple(mv(d) for d in self.diags),
                                   residual=None if self.residual is None else mv(self.residual))


register_tensor_dataclass(BandedOperator, static=("offsets", "n_tiles"))


def _dense_offsets_from(off, dst, t: int, min_fill: float) -> Tuple[int, ...]:
    """Offsets whose distinct destination tiles reach ``min_fill · t``: one
    pass over the unique (offset, dst tile) pairs."""
    if len(off) == 0:
        return ()
    base = int(off.min())
    pair = (off - base) * np.int64(t) + dst // TILE
    uniq = native.unique_i64(pair)
    per_off = np.bincount((uniq // t).astype(np.int64))
    return tuple(int(i) + base for i in np.flatnonzero(per_off >= min_fill * t))


def _live_arcs(src, dst, weight):
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    live = weight != 0
    return src[live], dst[live], weight[live]


def build_banded_operator(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n_padded: int,
    dtype="int8",
    max_diagonals: int = 6,
    min_fill: float = 0.1,
    force_offsets: Optional[Tuple[int, ...]] = None,
    strict_int8: bool = False,
    device="cpu",
) -> Optional[BandedOperator]:
    """Host-side construction, placed on ``device``.  None when no offset
    reaches ``min_fill`` tile occupancy, or more than ``max_diagonals`` do
    (no band structure: use BCSR), or the remainder is not block-thin.
    ``force_offsets`` builds diagonals for exactly the given offsets (zero
    diagonals where there are no such edges).  int8 storage that does not
    factor degrades to bfloat16 with a warning, or, with ``strict_int8``,
    returns None (``agg_dtype='auto'``: the quantised form only when it is
    exact)."""
    if n_padded % TILE:
        raise ValueError(f"n_padded {n_padded} must be a multiple of {TILE}")
    t = n_padded // TILE
    src, dst, weight = _live_arcs(src, dst, weight)

    off = src // TILE - dst // TILE
    if force_offsets is not None:
        dense_offs = [int(o) for o in force_offsets]
    else:
        dense_offs = list(_dense_offsets_from(off, dst, t, min_fill))
        if not dense_offs or len(dense_offs) > max_diagonals:
            return None

    diags = []
    in_diag = np.zeros(len(src), dtype=bool)
    for o in dense_offs:
        sel = off == o
        in_diag |= sel
        s, d, w = src[sel], dst[sel], weight[sel]
        strip = np.zeros((t, TILE, TILE), np.float32)
        native.scatter_add_3d(strip, d // TILE, s % TILE, d % TILE, w)  # diagonal index = destination tile
        try:
            blocks, scale = _finalize_strips(strip, dtype, device)
        except StripFactorError as err:
            if strict_int8:
                return None
            warnings.warn(
                "int8 mask+scale banded storage does not apply: "
                f"{err}; storing the diagonals as dense bfloat16 instead",
                RuntimeWarning,
                stacklevel=2,
            )
            dtype = "bfloat16"  # the later diagonals stay bf16 too
            blocks, scale = _finalize_strips(strip, dtype, device)
        diags.append(StripOperator(strip=blocks, residual=None, scale=scale, slot=TILE))

    residual = None
    if np.any(~in_diag):
        sr, dr, wr = src[~in_diag], dst[~in_diag], weight[~in_diag]
        # a dense band plus a large scattered remainder would make an
        # unbounded dense-block residual: decline, the caller falls back
        if len(native.unique_i64(sr // TILE * t + dr // TILE)) > _MAX_BAND_FACTOR * t:
            return None
        residual = build_bcsr(sr, dr, wr, n_padded, max_band_factor=10**9, device=device)
    return BandedOperator(diags=tuple(diags), residual=residual, offsets=tuple(dense_offs), n_tiles=t)


def uniformize_residuals(bops):
    """Give every operator of a list the same residual structure (present,
    one block count): absent residuals become the all-zero operator."""
    have = [b.residual for b in bops if b.residual is not None]
    if not have:
        return list(bops)
    need = max(int(r.blocks.shape[0]) for r in have)
    out = []
    for b in bops:
        if b.residual is None:
            dev = b.diags[0].strip.device if b.diags else "cpu"
            r = empty_bcsr(b.n_tiles, b.n_tiles, need, device=dev)
        else:
            r = pad_bcsr(b.residual, need)
        out.append(dataclasses.replace(b, residual=r))
    return out


def dense_offsets(src, dst, weight, n_padded: int, min_fill: float = 0.1) -> Tuple[int, ...]:
    """The tile offsets that would become diagonals (the detection half of
    ``build_banded_operator``)."""
    src, dst, _ = _live_arcs(src, dst, weight)
    return _dense_offsets_from(src // TILE - dst // TILE, dst, n_padded // TILE, min_fill)


def _shift_tiles(state_t: torch.Tensor, o: int) -> torch.Tensor:
    """State shifted left by ``o`` tiles along the node axis, zero filled:
    ``x[:, j·T:] = state[:, (j+o)·T:]``.  Its autograd is the opposite
    shift."""
    if o == 0:
        return state_t
    n = state_t.shape[1]
    k = abs(o) * TILE
    if o > 0:
        return F.pad(state_t[:, k:], (0, k))
    return F.pad(state_t[:, : n - k], (k, 0))


def banded_aggregate_t(state_t: torch.Tensor, bop: BandedOperator) -> torch.Tensor:
    """``Mᵀ·state`` on feature-major state through the diagonal
    decomposition: one strip-kernel launch per diagonal (and, in the
    backward, one of its transpose), plus the residual's BCSR einsum;
    differentiable in ``state_t``."""
    out = None
    for o, sop in zip(bop.offsets, bop.diags):
        contrib = strip_aggregate_t(_shift_tiles(state_t, o).contiguous(), sop)
        out = contrib if out is None else out + contrib
    if bop.residual is not None:
        r = bcsr_aggregate_t(state_t, bop.residual)
        out = r if out is None else out + r
    return torch.zeros_like(state_t) if out is None else out


def banded_aggregate(state: torch.Tensor, bop: BandedOperator) -> torch.Tensor:
    """Row-major interface (transpose sandwich; the feature-major engine is
    the intended consumer); feature rows padded to a multiple of 8 and cut
    back."""
    d = state.shape[1]
    d_pad = -(-d // 8) * 8
    st = state.T
    if d_pad != d:
        st = F.pad(st, (0, 0, 0, d_pad - d))
    return banded_aggregate_t(st.contiguous(), bop)[:d].T
