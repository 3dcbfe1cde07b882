"""Compact-strip aggregation on feature-major state, the counterpart of
``gnnkeras_tpu.ops.strip``.

Graphs packed into ``slot``-node sub-slots of 128-node tiles make each
tile's within-slot adjacency block diagonal.  It is stored per tile as a
compact (slot, 128) strip, ``strip[t][i, j] = w(edge 128t + slot·(j // slot)
+ i → 128t + j)``, which expands to the 128×128 block diagonal.  At slot 128
the strip is the dense diagonal block itself.  Edges that cross slots go to
a BCSR residual.

In the mixed format (``blocks`` is not None, slot 32/64 batches from
``packing.order_tiles_by_format``) tiles [0, Ts) are slot-pure and hold
compact strips, tiles [Ts, Ts + Tb) hold graphs larger than a slot and
store full diagonal blocks, so no within-tile edge pays the residual, which
keeps only the edges that cross tiles.

With ``int8`` storage each strip and block factors exactly into a 0/1 mask
times one f32 scale per destination column (sum/normalized/average
aggregation over deduplicated arcs); otherwise the weights are stored
directly in f32 or bf16 with no scale.

``strip_matmul`` is the forward kernel and ``strip_matmul_t`` its backward
(both in ``csrc/strip_matmul.cu``, one launch for both regions; every
operand on a 16-byte boundary); on a CPU tensor each runs its plain
PyTorch version (``_strip_matmul_plain``, ``_strip_matmul_t_plain``).  The
backward reads the forward operator
transposed on chip, so no transposed operator is stored.  ``strip_matmul``
is differentiable through a ``torch.autograd.Function`` whose backward is
``strip_matmul_t``; its forward is the custom operator
``gnnkeras_tpu_torch::strip_matmul``, which an exported program calls.  The
BCSR residual stays plain torch ops, so autograd takes its transpose.

``round_state=True`` (bf16 slot-pure strips only; the experiment tools in
``tools/bench_strip_compact.py`` and ``tools/bench_strip64.py`` pass it, the
model's path never does) selects the kernels' bf16-state instantiation: the
state or cotangent is rounded to bf16 before the product, as the JAX
package's experiment scripts compute it, where the model's kernel lifts the
operator to f32 and keeps the state.  It is not differentiable.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.ops.bcsr import BcsrMatrix, bcsr_aggregate_t, build_bcsr
from gnnkeras_tpu_torch.utils.pytree import register_tensor_dataclass

TILE = 128
D_SUB = 8  # feature-row granularity of the feature-major state
SLOTS = (32, 64, TILE)

# The mixed layout aligns its strip region to this many tiles
# (``packing.order_tiles_by_format``).  No CUDA grid needs it; it keeps node
# positions equal to the JAX package's, whose Pallas grid steps 16 tiles.
K_TILES = 16

_STORAGE = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}


class StripFactorError(ValueError):
    """int8 mask+scale storage requested but the operator's weights are not
    column-factorable."""


@dataclasses.dataclass(frozen=True)
class StripOperator:
    """Compact strips (tiles [0, Ts)), in the mixed format full diagonal
    blocks (tiles [Ts, Ts + Tb)), the cross-slot BCSR residual and, for int8
    storage, the per-column scales."""

    strip: torch.Tensor  # (Ts, slot, TILE)
    residual: Optional[BcsrMatrix]
    scale: Optional[torch.Tensor]  # (Ts, TILE) f32 per-column scale (int8 storage)
    slot: int
    blocks: Optional[torch.Tensor] = None  # (Tb, TILE, TILE), mixed format
    blocks_scale: Optional[torch.Tensor] = None  # (Tb, TILE) f32 (int8 storage)

    def to(self, device) -> "StripOperator":
        mv = lambda x: None if x is None else x.to(device)
        return dataclasses.replace(self, strip=mv(self.strip), residual=mv(self.residual), scale=mv(self.scale),
                                   blocks=mv(self.blocks), blocks_scale=mv(self.blocks_scale))


register_tensor_dataclass(StripOperator, static=("slot",))


def storage_name(dtype) -> str:
    """'int8' / 'float32' / 'bfloat16' from a name or a numpy dtype."""
    name = str(getattr(dtype, "name", dtype))
    if name not in _STORAGE:
        raise ValueError(f"unsupported strip storage dtype {dtype!r}; use one of {sorted(_STORAGE)}")
    return name


def _finalize_strips(strip: np.ndarray, dtype, device):
    """Host f32 strips → (storage, scale) tensors.  ``int8`` factors them
    into mask and scale (``StripFactorError`` when the weights do not
    factor); a float dtype stores the weights directly with no scale."""
    name = storage_name(dtype)
    if name == "int8":
        fac = native.factor_mask_scale(strip)
        if fac is None:
            raise StripFactorError(
                "strip weights are not column-constant; int8 mask+scale "
                "storage needs one weight per destination (sum/normalized/"
                "average aggregation over deduplicated arcs)"
            )
        mask, scale = fac
        return torch.from_numpy(mask).to(device), torch.from_numpy(scale).to(device)
    return torch.from_numpy(strip).to(_STORAGE[name]).to(device), None


def build_strip_operator(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n_padded: int,
    slot: int = TILE,
    dtype="float32",
    n_strip_tiles: Optional[int] = None,
    device="cpu",
) -> StripOperator:
    """Host-side construction over slot-packed node positions.  ``dtype``
    is the storage: ``int8`` (mask + scale), ``float32`` or ``bfloat16``.

    ``n_strip_tiles`` selects the mixed format: tiles [0, n_strip_tiles)
    store compact strips, the rest full diagonal blocks; it must be a
    multiple of ``K_TILES`` or the tile count (``order_tiles_by_format``
    aligns it)."""
    if n_padded % TILE:
        raise ValueError(f"n_padded {n_padded} must be a multiple of {TILE}")
    if slot not in SLOTS:
        raise ValueError(f"slot {slot} must be one of {SLOTS}")
    t = n_padded // TILE
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    live = weight != 0  # padded rows would only force an all-zero residual
    src, dst, weight = src[live], dst[live], weight[live]

    in_slot = (src // slot) == (dst // slot)
    blocks = None
    if n_strip_tiles is not None:
        ns = int(n_strip_tiles)
        if ns % K_TILES and ns != t:
            raise ValueError(f"n_strip_tiles {ns} must be a K_TILES ({K_TILES}) multiple")
        if ns > t:
            raise ValueError(f"n_strip_tiles {ns} exceeds tile count {t}")
        boundary = ns * TILE
        within_tile = (src // TILE) == (dst // TILE)
        in_strip = in_slot & within_tile & (dst < boundary)
        in_block = within_tile & (dst >= boundary)
        s, d, w = src[in_strip], dst[in_strip], weight[in_strip]
        strip = np.zeros((ns, slot, TILE), np.float32)
        native.scatter_add_3d(strip, d // TILE, s % slot, d % TILE, w)
        sb, db, wb = src[in_block], dst[in_block], weight[in_block]
        blocks = np.zeros((t - ns, TILE, TILE), np.float32)
        native.scatter_add_3d(blocks, db // TILE - ns, sb % TILE, db % TILE, wb)
        rest = ~(in_strip | in_block)
    else:
        s, d, w = src[in_slot], dst[in_slot], weight[in_slot]
        strip = np.zeros((t, slot, TILE), np.float32)
        native.scatter_add_3d(strip, d // TILE, s % slot, d % TILE, w)
        rest = ~in_slot

    residual = None
    if np.any(rest):
        residual = build_bcsr(src[rest], dst[rest], weight[rest], n_padded, max_band_factor=10**9, device=device)
    strip_t, scale = _finalize_strips(strip, dtype, device)
    blocks_t = blocks_scale = None
    if blocks is not None:
        blocks_t, blocks_scale = _finalize_strips(blocks, dtype, device)
    return StripOperator(strip=strip_t, residual=residual, scale=scale, slot=slot, blocks=blocks_t,
                         blocks_scale=blocks_scale)


def build_strip_or_bf16(src, dst, weight, n_padded, dtype, device, slot: int = TILE,
                        n_strip_tiles: Optional[int] = None) -> StripOperator:
    """``build_strip_operator``, falling back (with a warning) to bf16 weight
    storage when int8 mask+scale storage does not factor."""
    try:
        return build_strip_operator(src, dst, weight, n_padded, slot=slot, dtype=dtype, n_strip_tiles=n_strip_tiles,
                                    device=device)
    except StripFactorError as err:
        warnings.warn(
            "int8 mask+scale strip storage does not apply to this batch: the "
            f"operator weights are not column-factorable ({err}); storing the "
            "strip as dense bfloat16 instead",
            RuntimeWarning,
            stacklevel=3,
        )
        return build_strip_operator(src, dst, weight, n_padded, slot=slot, dtype="bfloat16",
                                    n_strip_tiles=n_strip_tiles, device=device)


def strip_to_dense(op: StripOperator, dtype="bfloat16") -> StripOperator:
    """An int8 mask+scale operator as direct weights in ``dtype`` (float32 or
    bfloat16); a float operator is returned as it is."""
    if op.scale is None:
        return op
    store = _STORAGE[storage_name(dtype)]
    dense = lambda mask, scale: None if mask is None else (mask.float() * scale[:, None, :]).to(store)
    return dataclasses.replace(op, strip=dense(op.strip, op.scale), scale=None,
                               blocks=dense(op.blocks, op.blocks_scale), blocks_scale=None)


def _expand(strip: torch.Tensor, slot: int) -> torch.Tensor:
    """(T, slot, 128) compact strips → (T, 128, 128) block diagonals:
    entry (i, j) is ``strip[i % slot, j]`` where ``i // slot == j // slot``."""
    if slot == TILE:
        return strip
    rows = strip.repeat(1, TILE // slot, 1)
    idx = torch.arange(TILE, device=strip.device) // slot
    return rows * (idx[:, None] == idx[None, :]).to(strip.dtype)


def _full_operator(strip, scale, blocks, blocks_scale, slot):
    """The (T, 128, 128) operator of every tile and its (T, 128) scale (or
    None): the expanded strips, then the full blocks."""
    ops, scales = [_expand(strip, slot)], [scale]
    if blocks is not None:
        ops.append(blocks)
        scales.append(blocks_scale)
    op = ops[0] if len(ops) == 1 else torch.cat(ops)
    if scale is None:
        return op, None
    return op, scales[0] if len(scales) == 1 else torch.cat(scales)


def _strip_matmul_plain(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor],
                        blocks: Optional[torch.Tensor] = None, blocks_scale: Optional[torch.Tensor] = None,
                        slot: int = TILE, round_state: bool = False) -> torch.Tensor:
    """Per-tile product of the (d, 128) state tiles with the upcast blocks
    (compact strips expanded), then the per-column scale: the kernel's own
    decomposition.  ``round_state`` rounds the state to bf16 first."""
    if round_state:
        state_t = state_t.to(torch.bfloat16).to(state_t.dtype)
    op, sc = _full_operator(strip, scale, blocks, blocks_scale, slot)
    d, n = state_t.shape
    t = op.shape[0]
    tiles = state_t.reshape(d, t, TILE).permute(1, 0, 2)  # (T, d, 128)
    out = torch.bmm(tiles, op.to(state_t.dtype))
    if sc is not None:
        out = out * sc[:, None, :]
    return out.permute(1, 0, 2).reshape(d, n)


def _strip_matmul_t_plain(ct_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor],
                          blocks: Optional[torch.Tensor] = None, blocks_scale: Optional[torch.Tensor] = None,
                          slot: int = TILE, round_state: bool = False) -> torch.Tensor:
    """The backward's decomposition: per tile, the cotangent scaled along
    the contraction axis, times the transposed upcast block.
    ``round_state`` rounds the cotangent to bf16 first."""
    if round_state:
        ct_t = ct_t.to(torch.bfloat16).to(ct_t.dtype)
    op, sc = _full_operator(strip, scale, blocks, blocks_scale, slot)
    d, n = ct_t.shape
    t = op.shape[0]
    tiles = ct_t.reshape(d, t, TILE).permute(1, 0, 2)  # (T, d, 128)
    if sc is not None:
        tiles = tiles * sc[:, None, :]
    out = torch.bmm(tiles, op.to(ct_t.dtype).transpose(1, 2))
    return out.permute(1, 0, 2).reshape(d, n)


def _check_operands(name: str, x: torch.Tensor, strip, scale, blocks, blocks_scale, slot: int,
                    round_state: bool = False) -> None:
    if round_state and (strip.dtype != torch.bfloat16 or blocks is not None):
        raise ValueError(f"{name}: round_state takes bf16 slot-pure strips, got {strip.dtype} "
                         f"{'with' if blocks is not None else 'without'} blocks")
    if slot not in SLOTS:
        raise ValueError(f"{name}: slot {slot} must be one of {SLOTS}")
    if x.dim() != 2 or strip.dim() != 3 or tuple(strip.shape[1:]) != (slot, TILE):
        raise ValueError(f"{name}: bad shapes state {tuple(x.shape)}, strip {tuple(strip.shape)} at slot {slot}")
    ts = strip.shape[0]
    tb = 0
    if blocks is not None:
        if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (TILE, TILE) or blocks.dtype != strip.dtype:
            raise ValueError(f"{name}: blocks {tuple(blocks.shape)} {blocks.dtype} must be (Tb, {TILE}, {TILE}) "
                             f"{strip.dtype}")
        tb = blocks.shape[0]
    if x.shape[1] != (ts + tb) * TILE:
        raise ValueError(f"{name}: state has {x.shape[1]} columns, operator covers {(ts + tb) * TILE}")
    int8 = strip.dtype == torch.int8
    if int8 != (scale is not None) or (blocks is not None and int8 != (blocks_scale is not None)):
        raise ValueError(f"{name}: int8 storage needs scales, float storage takes none")
    if scale is not None and tuple(scale.shape) != (ts, TILE):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} must be {(ts, TILE)}")
    if blocks_scale is not None and tuple(blocks_scale.shape) != (tb, TILE):
        raise ValueError(f"{name}: blocks_scale {tuple(blocks_scale.shape)} must be {(tb, TILE)}")


@torch.library.custom_op("gnnkeras_tpu_torch::strip_matmul", mutates_args=())
def _strip_matmul_op(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor],
                     blocks: Optional[torch.Tensor], blocks_scale: Optional[torch.Tensor], slot: int) -> torch.Tensor:
    """The forward as one operator of ``torch.library``, so that
    ``torch.export`` records it as one node: the kernel on the card, the
    plain version on the CPU."""
    return _launch_or_plain("strip_matmul", state_t, strip, scale, blocks, blocks_scale, slot)


@_strip_matmul_op.register_fake
def _(state_t, strip, scale, blocks, blocks_scale, slot):
    return torch.empty_like(state_t)


class _StripMatmul(torch.autograd.Function):
    """The diagonal-block product with the backward kernel as its gradient
    (the operator is data: it gets no gradient)."""

    @staticmethod
    def forward(ctx, state_t, strip, scale, blocks, blocks_scale, slot):
        ctx.save_for_backward(strip, scale, blocks, blocks_scale)
        ctx.slot = slot
        return _strip_matmul_op(state_t, strip, scale, blocks, blocks_scale, slot)

    @staticmethod
    def backward(ctx, ct_t):
        strip, scale, blocks, blocks_scale = ctx.saved_tensors
        grad = strip_matmul_t(ct_t.contiguous(), strip, scale, blocks, blocks_scale, ctx.slot)
        return grad, None, None, None, None, None


def strip_matmul(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 blocks: Optional[torch.Tensor] = None, blocks_scale: Optional[torch.Tensor] = None,
                 slot: int = TILE, round_state: bool = False) -> torch.Tensor:
    """``out[:, tile t] = (state_t[:, tile t] @ M[t]) * scale[t]``,
    differentiable in ``state_t``.

    state_t (d_pad, 128·T) f32 feature-major; ``strip`` (Ts, slot, 128)
    compact strips (slot 32, 64 or 128) for tiles [0, Ts) and ``blocks``
    (T − Ts, 128, 128) full blocks for the rest (None when Ts = T); int8
    storage with ``scale`` (Ts, 128) and ``blocks_scale`` (T − Ts, 128) f32,
    or f32/bf16 weights with no scales.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.  ``round_state``: the
    bf16-state product of the experiment tools (module docstring)."""
    _check_operands("strip_matmul", state_t, strip, scale, blocks, blocks_scale, slot, round_state)
    if round_state:
        return _launch_or_plain("strip_matmul", state_t, strip, scale, blocks, blocks_scale, slot, True)
    return _StripMatmul.apply(state_t, strip, scale, blocks, blocks_scale, slot)


def strip_matmul_t(ct_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor] = None,
                   blocks: Optional[torch.Tensor] = None, blocks_scale: Optional[torch.Tensor] = None,
                   slot: int = TILE, round_state: bool = False) -> torch.Tensor:
    """The backward of ``strip_matmul``:
    ``out[:, tile t] = (ct_t[:, tile t] · diag(scale[t])) @ M[t]ᵀ``.
    Same operands and devices as ``strip_matmul``."""
    _check_operands("strip_matmul_t", ct_t, strip, scale, blocks, blocks_scale, slot, round_state)
    return _launch_or_plain("strip_matmul_t", ct_t, strip, scale, blocks, blocks_scale, slot, round_state)


_MASK_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_BF16_STATE = 3  # bf16 weights, state rounded to bf16 (``round_state``)
_PLAIN = {"strip_matmul": _strip_matmul_plain, "strip_matmul_t": _strip_matmul_t_plain}


def _launch_or_plain(name: str, x, strip, scale, blocks, blocks_scale, slot: int, round_state: bool = False):
    """The plain version for a CPU tensor; for a CUDA tensor the kernel's
    launch, counted in ``kernels.LAUNCHES[name]`` (the bf16-state
    instantiation in ``LAUNCHES[name + "_bf16_state"]``), or an error."""
    if x.device.type == "cpu":
        return _PLAIN[name](x, strip, scale, blocks, blocks_scale, slot, round_state)
    from gnnkeras_tpu_torch import kernels

    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    d = x.shape[0]
    operands = [o for o in (x, strip, scale, blocks, blocks_scale) if o is not None]
    if any(o.device != x.device for o in operands):
        raise ValueError(f"{name}: operands on different devices")
    if not all(o.is_contiguous() for o in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(o.data_ptr() % 16 for o in operands):  # the kernel's 16-byte asynchronous copies
        raise ValueError(f"{name}: every operand must start on a 16-byte boundary")
    if x.dtype != torch.float32 or any(s is not None and s.dtype != torch.float32 for s in (scale, blocks_scale)):
        raise ValueError(f"{name}: state and scale must be float32")
    if strip.dtype not in _MASK_KIND:
        raise ValueError(f"{name}: unsupported operator dtype {strip.dtype}")
    if d % D_SUB:
        raise ValueError(f"{name}: feature rows {d} must be a multiple of {D_SUB}")
    out = torch.empty_like(x)
    ptr = lambda o: None if o is None else o.data_ptr()
    fn = getattr(kernels.load("strip_matmul"), f"gnn_{name}")
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), strip.data_ptr(), ptr(scale), strip.shape[0], slot, ptr(blocks), ptr(blocks_scale),
            _BF16_STATE if round_state else _MASK_KIND[strip.dtype], out.data_ptr(), d, x.shape[1] // TILE,
            kernels.stream_of(x),
        )
    kernels.check(err, name)
    kernels.LAUNCHES[name + "_bf16_state" if round_state else name] += 1
    return out


def diag_operands(op: StripOperator):
    """(strip, scale, blocks, blocks_scale, slot) of the operator's block
    diagonal as the kernel takes them: slot-pure strips; mixed, both
    regions; or, with no strip tile (Ts = 0), the full blocks at slot 128.
    An empty block region is dropped."""
    blocks, blocks_scale = op.blocks, op.blocks_scale
    if blocks is not None and op.strip.shape[0] == 0:
        return blocks, blocks_scale, None, None, TILE
    if blocks is not None and blocks.shape[0] == 0:
        blocks = blocks_scale = None
    return op.strip, op.scale, blocks, blocks_scale, op.slot


def strip_aggregate_t(state_t: torch.Tensor, op: StripOperator) -> torch.Tensor:
    """``Adjᵀ·state`` on feature-major state: (d_pad, N) → (d_pad, N),
    through the diagonal blocks plus the BCSR residual when present;
    differentiable in ``state_t``."""
    out = strip_matmul(state_t, *diag_operands(op))
    if op.residual is not None:
        out = out + bcsr_aggregate_t(state_t, op.residual)
    return out
