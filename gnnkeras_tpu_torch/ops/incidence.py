"""Arc-row select and its transpose through the union incidence pairs, the
arc-focused readout of ``gnnkeras_tpu.ops.incidence``.

The arc readout reads ``state[arc_src]`` and ``state[arc_dst]``; the
gradient of that gather is a scatter-add of the (A, d) cotangent rows into
(N, d) node rows.  The batch carries the incidence structure per (arc tile,
node tile) pair: for each of the pair's 128 arc rows, the local column
(node % 128) of its source endpoint when that endpoint lies in the pair's
node tile, else -1; likewise for the destination.  The ``f_*`` arrays hold
the pairs sorted by arc tile (the select walks them per arc tile), the
``b_*`` arrays the same pairs sorted by node tile (the scatter walks them
per node tile); ``f_start`` / ``b_start`` are the run offsets.

``incidence_select`` is the forward kernel and ``incidence_scatter`` the
backward (both in ``csrc/incidence.cu``); on a CPU tensor each runs its
plain PyTorch version (``_incidence_select_plain``,
``_incidence_scatter_plain``).  ``incidence_gather`` is the differentiable
pair: a ``torch.autograd.Function`` whose forward is the select and whose
backward is the scatter.  The select is also the custom operator
``gnnkeras_tpu_torch::incidence_select``, which an exported program calls.  The select is an exact copy, bit for bit; the
scatter sums each node's incident-arc cotangents in f32, in a fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.utils.pytree import register_tensor_dataclass

TILE = 128

_PAIR_KB = 16  # pair lists are padded to a multiple of this, as in the JAX package

# acceptance bound: average union (src ∪ dst endpoint) node tiles touched per
# arc tile; beyond it the structure declines and the plain gather is used
_MAX_PAIRS_PER_ARC_TILE = 12

# the scatter's plain version forms one-hot products this many pairs at a time
_PLAIN_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class IncidencePairs:
    """Union incidence structure over (arc tile, node tile) pairs.

    ``cols_src[k, r]`` is the local column of arc row ``arc_tile[k]·128 + r``'s
    source endpoint when that endpoint lies in ``node_tile[k]``, else -1
    (also for rows past the arc count); ``cols_dst`` likewise for the
    destination.  ``b_*`` are sorted by node tile, ``f_*`` by arc tile; both
    hold the same pairs.  Pairs from ``n_live`` on are inert padding (all
    cols -1) at the tail of both orders.  The live count is a one-element
    tensor (``live``), which the kernels read on the device: a program
    saved by ``torch.export`` takes it from each batch as an input."""

    b_arc_tile: torch.Tensor  # (B,) i32
    b_node_tile: torch.Tensor  # (B,) i32
    b_cols_src: torch.Tensor  # (B, 128) i32, -1 = no contribution
    b_cols_dst: torch.Tensor  # (B, 128) i32
    b_start: torch.Tensor  # (n_node_tiles + 1,) i32 run offsets per node tile
    f_arc_tile: torch.Tensor  # (B,) i32
    f_node_tile: torch.Tensor  # (B,) i32
    f_cols_src: torch.Tensor  # (B, 128) i32
    f_cols_dst: torch.Tensor  # (B, 128) i32
    f_start: torch.Tensor  # (n_arc_tiles + 1,) i32 run offsets per arc tile
    live: torch.Tensor  # (1,) i32 count of live pairs
    n_arc_tiles: int
    n_node_tiles: int

    @property
    def n_pairs(self) -> int:
        return int(self.b_arc_tile.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.live[0])

    @property
    def device(self) -> torch.device:
        return self.f_cols_src.device

    def to(self, device) -> "IncidencePairs":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)}
        )


register_tensor_dataclass(IncidencePairs, static=("n_arc_tiles", "n_node_tiles"))


def build_incidence_pairs(arc_src: np.ndarray, arc_dst: np.ndarray, n_nodes_padded: int) -> Optional[IncidencePairs]:
    """Host-side construction (CPU tensors).  Returns None when
    ``n_nodes_padded`` is not 128-aligned, an endpoint lies outside it, or
    the union pair count exceeds ``_MAX_PAIRS_PER_ARC_TILE`` per arc tile.
    Every arc row takes part, padding rows included, so the select gives
    exactly what ``state[arc_src]`` gives."""
    a = len(arc_src)
    if a == 0 or n_nodes_padded % TILE:
        return None
    n_arc_tiles = -(-a // TILE)
    n_node_tiles = n_nodes_padded // TILE
    rows = np.arange(a, dtype=np.int64)
    srcn = np.asarray(arc_src).astype(np.int64)
    dstn = np.asarray(arc_dst).astype(np.int64)
    if srcn.min() < 0 or srcn.max() >= n_nodes_padded or dstn.min() < 0 or dstn.max() >= n_nodes_padded:
        return None
    at = rows // TILE
    key_s = at * n_node_tiles + srcn // TILE
    key_d = at * n_node_tiles + dstn // TILE
    uniq, inverse = native.unique_i64(np.concatenate([key_s, key_d]), return_inverse=True)
    B = len(uniq)
    if B > _MAX_PAIRS_PER_ARC_TILE * n_arc_tiles:
        return None

    # uniq ascends by key, arc-tile-major: the select's order
    f_arc_tile = (uniq // n_node_tiles).astype(np.int32)
    f_node_tile = (uniq % n_node_tiles).astype(np.int32)
    f_cols_src = np.full((B, TILE), -1, np.int32)
    f_cols_dst = np.full((B, TILE), -1, np.int32)
    r_local = rows % TILE
    f_cols_src[inverse[:a], r_local] = srcn % TILE
    f_cols_dst[inverse[a:], r_local] = dstn % TILE

    order = np.argsort(f_node_tile, kind="stable")  # the scatter's order

    def _pad(arr, fill):
        b_pad = -(-B // _PAIR_KB) * _PAIR_KB
        if b_pad == B:
            return arr
        return np.concatenate([arr, np.full((b_pad - B,) + arr.shape[1:], fill, arr.dtype)])

    # inert padding keeps each order sorted: the last tile on the run axis,
    # tile 0 on the other, cols all -1
    b_node_tile = _pad(f_node_tile[order], n_node_tiles - 1)
    f_arc_padded = _pad(f_arc_tile, n_arc_tiles - 1)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return IncidencePairs(
        b_arc_tile=T(_pad(f_arc_tile[order], 0)),
        b_node_tile=T(b_node_tile),
        b_cols_src=T(_pad(f_cols_src[order], -1)),
        b_cols_dst=T(_pad(f_cols_dst[order], -1)),
        b_start=T(np.searchsorted(b_node_tile, np.arange(n_node_tiles + 1))),
        f_arc_tile=T(f_arc_padded),
        f_node_tile=T(_pad(f_node_tile, 0)),
        f_cols_src=T(_pad(f_cols_src, -1)),
        f_cols_dst=T(_pad(f_cols_dst, -1)),
        f_start=T(np.searchsorted(f_arc_padded, np.arange(n_arc_tiles + 1))),
        live=T([B]),
        n_arc_tiles=n_arc_tiles,
        n_node_tiles=n_node_tiles,
    )


def pad_incidence_pairs(inc: Optional[IncidencePairs], n_pairs: int) -> Optional[IncidencePairs]:
    """Pad the pair list to ``n_pairs`` (rounded up to a multiple of
    ``_PAIR_KB``) with inert pairs (all cols -1) on the last tile of each
    order, so only the final run offsets move."""
    if inc is None:
        return None
    n_pairs = -(-max(int(n_pairs), 1) // _PAIR_KB) * _PAIR_KB
    e = n_pairs - inc.n_pairs
    if e <= 0:
        return inc

    def cat(x, fill):
        return torch.cat([x, torch.full((e,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)])

    def last_plus(start):
        start = start.clone()
        start[-1] += e
        return start

    return dataclasses.replace(
        inc,
        b_arc_tile=cat(inc.b_arc_tile, 0),
        b_node_tile=cat(inc.b_node_tile, inc.n_node_tiles - 1),
        b_cols_src=cat(inc.b_cols_src, -1),
        b_cols_dst=cat(inc.b_cols_dst, -1),
        b_start=last_plus(inc.b_start),
        f_arc_tile=cat(inc.f_arc_tile, inc.n_arc_tiles - 1),
        f_node_tile=cat(inc.f_node_tile, 0),
        f_cols_src=cat(inc.f_cols_src, -1),
        f_cols_dst=cat(inc.f_cols_dst, -1),
        f_start=last_plus(inc.f_start),
    )


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _incidence_select_plain(state: torch.Tensor, inc: IncidencePairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per pair, each arc row with a column ≥ 0 takes a copy of that node
    row; rows no pair touches stay zero.  (A_pad, d) each, exact."""
    return _select_plain(state, inc.f_arc_tile, inc.f_node_tile, inc.f_cols_src, inc.f_cols_dst, inc.n_arc_tiles)


def _select_plain(state, f_arc_tile, f_node_tile, f_cols_src, f_cols_dst, n_arc_tiles: int):
    d = state.shape[1]
    dev = state.device
    a_pad = n_arc_tiles * TILE
    arc_rows = (f_arc_tile.long()[:, None] * TILE + torch.arange(TILE, device=dev)).reshape(-1)
    node0 = f_node_tile.long()[:, None] * TILE
    out = []
    for cols in (f_cols_src, f_cols_dst):
        cols = cols.long()
        # entries with col -1 write a spare row past the end, dropped after:
        # no data-dependent shapes, so the copy also runs inside a CUDA graph
        dest = torch.where(cols.reshape(-1) >= 0, arc_rows, a_pad)
        y = torch.zeros((a_pad + 1, d), dtype=state.dtype, device=dev)
        y[dest] = state[(node0 + cols.clamp(min=0)).reshape(-1)]
        out.append(y[:a_pad])
    return out[0], out[1]


def _incidence_scatter_plain(ct_src: torch.Tensor, ct_dst: torch.Tensor, inc: IncidencePairs) -> torch.Tensor:
    """``Inc_srcᵀ·ct_src + Inc_dstᵀ·ct_dst``: per pair, the one-hot of its
    cols transposed times its arc tile's cotangent rows, summed per node
    tile.  (A, d) cotangents with A ≤ A_pad → (N, d)."""
    a, d = ct_src.shape
    a_pad = inc.n_arc_tiles * TILE
    dev = ct_src.device
    tiles = []
    for ct in (ct_src, ct_dst):
        if a != a_pad:
            ct = torch.cat([ct, ct.new_zeros((a_pad - a, d))])
        tiles.append(ct.reshape(inc.n_arc_tiles, TILE, d))
    iota = torch.arange(TILE, device=dev, dtype=inc.b_cols_src.dtype)
    out = torch.zeros((inc.n_node_tiles, TILE, d), dtype=ct_src.dtype, device=dev)
    for p0 in range(0, inc.n_pairs, _PLAIN_CHUNK):
        sl = slice(p0, p0 + _PLAIN_CHUNK)
        at = inc.b_arc_tile[sl].long()
        prod = 0
        for cols, t in zip((inc.b_cols_src[sl], inc.b_cols_dst[sl]), tiles):
            one_hot = (cols[:, :, None] == iota).to(ct_src.dtype)  # (kb, arc rows, node cols)
            prod = prod + torch.bmm(one_hot.transpose(1, 2), t[at])
        out.index_add_(0, inc.b_node_tile[sl].long(), prod)
    return out.reshape(inc.n_node_tiles * TILE, d)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_pairs(name: str, x: torch.Tensor, inc: IncidencePairs) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D (rows, d) tensor, got {tuple(x.shape)}")
    if inc.device != x.device:
        raise ValueError(f"{name}: incidence pairs on {inc.device}, operand on {x.device}")


def _cuda_operands(name: str, tensors, ints) -> None:
    """Raise on what the kernel does not take."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tensors[0].device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: operands must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.dtype != torch.int32 or not t.is_contiguous() or t.device != tensors[0].device for t in ints):
        raise ValueError(f"{name}: incidence pairs must be contiguous int32 on the operand's device")


def _vector_width(d: int, tensors) -> int:
    """Floats per load: 4 (16 bytes) where every row starts 16-byte
    aligned, else 2, else 1."""
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def incidence_select(state: torch.Tensor, inc: IncidencePairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(state[arc_src], state[arc_dst])`` through the pairs: (N, d) f32 →
    two (A_pad, d) arrays, A_pad = 128·n_arc_tiles, rows past the arc count
    zero.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``gnn_incidence_select``, counted in ``kernels.LAUNCHES``."""
    _check_pairs("incidence_select", state, inc)
    if state.device.type != "cpu" and state.shape[0] != inc.n_node_tiles * TILE:
        raise ValueError(f"incidence_select: state has {state.shape[0]} rows, pairs cover {inc.n_node_tiles * TILE}")
    return _incidence_select_op(state, inc.f_arc_tile, inc.f_node_tile, inc.f_cols_src, inc.f_cols_dst,
                                inc.f_start, inc.live, inc.n_arc_tiles)


@torch.library.custom_op("gnnkeras_tpu_torch::incidence_select", mutates_args=())
def _incidence_select_op(state: torch.Tensor, f_arc_tile: torch.Tensor, f_node_tile: torch.Tensor,
                         f_cols_src: torch.Tensor, f_cols_dst: torch.Tensor, f_start: torch.Tensor,
                         live: torch.Tensor, n_arc_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select as one operator of ``torch.library`` over the pairs'
    select-order arrays, so that ``torch.export`` records it as one node:
    the kernel on the card, the plain version on the CPU."""
    if state.device.type == "cpu":
        return _select_plain(state, f_arc_tile, f_node_tile, f_cols_src, f_cols_dst, n_arc_tiles)
    from gnnkeras_tpu_torch import kernels

    _cuda_operands("incidence_select", (state,), (f_start, f_node_tile, f_cols_src, f_cols_dst, live))
    d = state.shape[1]
    a_pad = n_arc_tiles * TILE
    y_src = torch.empty((a_pad, d), dtype=state.dtype, device=state.device)
    y_dst = torch.empty_like(y_src)
    fn = kernels.load("incidence").gnn_incidence_select
    with torch.cuda.device(state.device):
        err = fn(state.data_ptr(), f_start.data_ptr(), f_node_tile.data_ptr(), f_cols_src.data_ptr(),
                 f_cols_dst.data_ptr(), y_src.data_ptr(), y_dst.data_ptr(), d, n_arc_tiles, live.data_ptr(),
                 _vector_width(d, (state, y_src, y_dst)), kernels.stream_of(state))
    kernels.check(err, "incidence_select")
    kernels.LAUNCHES["incidence_select"] += 1
    return y_src, y_dst


@_incidence_select_op.register_fake
def _(state, f_arc_tile, f_node_tile, f_cols_src, f_cols_dst, f_start, live, n_arc_tiles):
    rows = (n_arc_tiles * TILE, state.shape[1])
    return state.new_empty(rows), state.new_empty(rows)


def incidence_scatter(ct_src: torch.Tensor, ct_dst: torch.Tensor, inc: IncidencePairs) -> torch.Tensor:
    """The select's transpose ``Inc_srcᵀ·ct_src + Inc_dstᵀ·ct_dst``: two
    (A, d) f32 cotangents, A ≤ A_pad → (N, d).  A CPU tensor takes the
    plain version; a CUDA tensor launches ``gnn_incidence_scatter``,
    counted in ``kernels.LAUNCHES``."""
    _check_pairs("incidence_scatter", ct_src, inc)
    if ct_src.shape != ct_dst.shape or ct_src.device != ct_dst.device:
        raise ValueError(f"incidence_scatter: cotangents {tuple(ct_src.shape)} and {tuple(ct_dst.shape)} differ")
    if ct_src.shape[0] > inc.n_arc_tiles * TILE:
        raise ValueError(f"incidence_scatter: {ct_src.shape[0]} rows > {inc.n_arc_tiles * TILE} the pairs cover")
    if ct_src.device.type == "cpu":
        return _incidence_scatter_plain(ct_src, ct_dst, inc)
    from gnnkeras_tpu_torch import kernels

    _cuda_operands("incidence_scatter", (ct_src, ct_dst),
                   (inc.b_start, inc.b_arc_tile, inc.b_cols_src, inc.b_cols_dst, inc.live))
    a, d = ct_src.shape
    out = torch.empty((inc.n_node_tiles * TILE, d), dtype=ct_src.dtype, device=ct_src.device)
    fn = kernels.load("incidence").gnn_incidence_scatter
    with torch.cuda.device(ct_src.device):
        err = fn(ct_src.data_ptr(), ct_dst.data_ptr(), a, inc.b_start.data_ptr(), inc.b_arc_tile.data_ptr(),
                 inc.b_cols_src.data_ptr(), inc.b_cols_dst.data_ptr(), out.data_ptr(), d, inc.n_node_tiles,
                 inc.live.data_ptr(), kernels.stream_of(ct_src))
    kernels.check(err, "incidence_scatter")
    kernels.LAUNCHES["incidence_scatter"] += 1
    return out


class _IncidenceGather(torch.autograd.Function):
    """Select forward, scatter backward (the pairs are data: no gradient)."""

    @staticmethod
    def forward(ctx, state, n_rows, inc):
        ctx.inc = inc
        y_src, y_dst = incidence_select(state, inc)
        return y_src[:n_rows], y_dst[:n_rows]

    @staticmethod
    def backward(ctx, ct_src, ct_dst):
        # an output the loss does not read comes back as zeros (autograd
        # materialises missing gradients by default)
        return incidence_scatter(ct_src.contiguous(), ct_dst.contiguous(), ctx.inc), None, None


def incidence_gather(state: torch.Tensor, n_rows: int, inc: IncidencePairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(state[arc_src], state[arc_dst])`` for the first ``n_rows`` arcs of
    the pairs, as (n_rows, d) rows, differentiable in ``state`` (N, d),
    through the select and, backward, the scatter."""
    return _IncidenceGather.apply(state, n_rows, inc)
