"""Compact-strip aggregation at slot = 128 (dense diagonal blocks) on
feature-major state, the forward of ``gnnkeras_tpu.ops.strip``.

Under ``slot_pack=128`` packing every graph of at most 128 nodes lies inside
one 128-node tile, so the within-tile part of the aggregation operator is one
dense 128×128 block per tile, ``strip[t][i, j] = w(edge 128t+i → 128t+j)``.
Edges that cross tiles (graphs larger than a tile) go to a BCSR residual.
With ``int8`` storage each block factors exactly into a 0/1 mask times one
f32 scale per destination column (sum/normalized/average aggregation over
deduplicated arcs); otherwise the weights are stored directly in f32 or
bf16 with no scale.

``strip_matmul`` is the forward kernel and ``strip_matmul_t`` its backward
(both in ``csrc/strip_matmul.cu``); on a CPU tensor each runs its plain
PyTorch version (``_strip_matmul_plain``, ``_strip_matmul_t_plain``).  The
backward reads the forward blocks transposed on chip, so no transposed
operator is stored.  ``strip_matmul`` is differentiable through a
``torch.autograd.Function`` whose backward is ``strip_matmul_t``; its
forward is the custom operator ``gnnkeras_tpu_torch::strip_matmul``, which
an exported program calls.  The BCSR residual stays plain torch ops, so
autograd takes its transpose.  The compact
slot 32/64 strips (mixed format) come with a later slice.
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

_STORAGE = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}


class StripFactorError(ValueError):
    """int8 mask+scale storage requested but the operator's weights are not
    column-factorable."""


@dataclasses.dataclass(frozen=True)
class StripOperator:
    """Dense diagonal blocks, the cross-tile BCSR residual and, for int8
    storage, the per-column scale."""

    strip: torch.Tensor  # (T, slot, TILE)
    residual: Optional[BcsrMatrix]
    scale: Optional[torch.Tensor]  # (T, TILE) f32 per-column scale (int8 storage)
    slot: int

    def to(self, device) -> "StripOperator":
        mv = lambda x: None if x is None else x.to(device)
        return dataclasses.replace(self, strip=mv(self.strip), residual=mv(self.residual), scale=mv(self.scale))


register_tensor_dataclass(StripOperator, static=("slot",))


def storage_name(dtype) -> str:
    """'int8' / 'float32' / 'bfloat16' from a name or a numpy dtype."""
    name = str(getattr(dtype, "name", dtype))
    if name not in _STORAGE:
        raise ValueError(f"unsupported strip storage dtype {dtype!r}; use one of {sorted(_STORAGE)}")
    return name


def _finalize_strips(strip: np.ndarray, dtype, device):
    """Host f32 strips → (blocks, scale) storage tensors.  ``int8`` factors them into mask
    and scale (``StripFactorError`` when the weights do not factor); a float
    dtype stores the weights directly with no scale."""
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
    device="cpu",
) -> StripOperator:
    """Host-side construction over tile-packed node positions.  ``dtype``
    is the block storage: ``int8`` (mask + scale), ``float32`` or
    ``bfloat16``."""
    if n_padded % TILE:
        raise ValueError(f"n_padded {n_padded} must be a multiple of {TILE}")
    if slot != TILE:
        raise NotImplementedError("compact strips with slot < 128 (the mixed format) are not ported yet")
    t = n_padded // TILE
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    live = weight != 0  # padded rows would only force an all-zero residual
    src, dst, weight = src[live], dst[live], weight[live]

    in_slot = (src // slot) == (dst // slot)
    s, d, w = src[in_slot], dst[in_slot], weight[in_slot]
    strip = np.zeros((t, slot, TILE), np.float32)
    native.scatter_add_3d(strip, d // TILE, s % slot, d % TILE, w)

    residual = None
    if np.any(~in_slot):
        rest = ~in_slot
        residual = build_bcsr(src[rest], dst[rest], weight[rest], n_padded,
                              max_band_factor=10**9, device=device)
    blocks, scale = _finalize_strips(strip, dtype, device)
    return StripOperator(strip=blocks, residual=residual, scale=scale, slot=slot)


def build_strip_or_bf16(src, dst, weight, n_padded, dtype, device) -> StripOperator:
    """``build_strip_operator``, falling back (with a warning) to bf16 weight
    storage when int8 mask+scale storage does not factor."""
    try:
        return build_strip_operator(src, dst, weight, n_padded, dtype=dtype, device=device)
    except StripFactorError as err:
        warnings.warn(
            "int8 mask+scale strip storage does not apply to this batch: the "
            f"operator weights are not column-factorable ({err}); storing the "
            "strip as dense bfloat16 instead",
            RuntimeWarning,
            stacklevel=3,
        )
        return build_strip_operator(src, dst, weight, n_padded, dtype="bfloat16", device=device)


def _strip_matmul_plain(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-tile product of the (d, 128) state tiles with the upcast blocks,
    then the per-column scale: the kernel's own decomposition."""
    d, n = state_t.shape
    t = strip.shape[0]
    tiles = state_t.reshape(d, t, TILE).permute(1, 0, 2)  # (T, d, 128)
    out = torch.bmm(tiles, strip.to(state_t.dtype))
    if scale is not None:
        out = out * scale[:, None, :]
    return out.permute(1, 0, 2).reshape(d, n)


def _strip_matmul_t_plain(ct_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The backward's decomposition: per tile, the cotangent scaled along
    the contraction axis, times the transposed upcast block."""
    d, n = ct_t.shape
    t = strip.shape[0]
    tiles = ct_t.reshape(d, t, TILE).permute(1, 0, 2)  # (T, d, 128)
    if scale is not None:
        tiles = tiles * scale[:, None, :]
    out = torch.bmm(tiles, strip.to(ct_t.dtype).transpose(1, 2))
    return out.permute(1, 0, 2).reshape(d, n)


def _check_operands(name: str, x: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor]) -> None:
    if x.dim() != 2 or strip.dim() != 3 or tuple(strip.shape[1:]) != (TILE, TILE):
        raise ValueError(f"{name}: bad shapes state {tuple(x.shape)}, strip {tuple(strip.shape)}")
    t = strip.shape[0]
    if x.shape[1] != t * TILE:
        raise ValueError(f"{name}: state has {x.shape[1]} columns, operator covers {t * TILE}")
    if (strip.dtype == torch.int8) != (scale is not None):
        raise ValueError(f"{name}: int8 storage needs a scale, float storage takes none")
    if scale is not None and tuple(scale.shape) != (t, TILE):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} must be {(t, TILE)}")


@torch.library.custom_op("gnnkeras_tpu_torch::strip_matmul", mutates_args=())
def _strip_matmul_op(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward as one operator of ``torch.library``, so that
    ``torch.export`` records it as one node: the kernel on the card, the
    plain version on the CPU."""
    return _launch_or_plain("strip_matmul", state_t, strip, scale)


@_strip_matmul_op.register_fake
def _(state_t, strip, scale):
    return torch.empty_like(state_t)


class _StripMatmul(torch.autograd.Function):
    """The diagonal-block product with the backward kernel as its gradient
    (the operator is data: it gets no gradient)."""

    @staticmethod
    def forward(ctx, state_t, strip, scale):
        ctx.save_for_backward(strip, scale)
        return _strip_matmul_op(state_t, strip, scale)

    @staticmethod
    def backward(ctx, ct_t):
        strip, scale = ctx.saved_tensors
        return strip_matmul_t(ct_t.contiguous(), strip, scale), None, None


def strip_matmul(state_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[:, tile t] = (state_t[:, tile t] @ strip[t]) * scale[t]``,
    differentiable in ``state_t``.

    state_t (d_pad, 128·T) f32 feature-major; strip (T, 128, 128) int8 with
    ``scale`` (T, 128) f32, or f32/bf16 weights with ``scale=None``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check_operands("strip_matmul", state_t, strip, scale)
    return _StripMatmul.apply(state_t, strip, scale)


def strip_matmul_t(ct_t: torch.Tensor, strip: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward of ``strip_matmul``:
    ``out[:, tile t] = (ct_t[:, tile t] · diag(scale[t])) @ strip[t]ᵀ``.
    Same operands and devices as ``strip_matmul``."""
    _check_operands("strip_matmul_t", ct_t, strip, scale)
    return _launch_or_plain("strip_matmul_t", ct_t, strip, scale)


_MASK_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_PLAIN = {"strip_matmul": _strip_matmul_plain, "strip_matmul_t": _strip_matmul_t_plain}


def _launch_or_plain(name: str, x, strip, scale):
    """The plain version for a CPU tensor; for a CUDA tensor the kernel's
    launch, counted in ``kernels.LAUNCHES[name]``, or an error."""
    if x.device.type == "cpu":
        return _PLAIN[name](x, strip, scale)
    from gnnkeras_tpu_torch import kernels

    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    d = x.shape[0]
    operands = (x, strip) if scale is None else (x, strip, scale)
    if any(o.device != x.device for o in operands):
        raise ValueError(f"{name}: operands on different devices")
    if not all(o.is_contiguous() for o in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if strip.data_ptr() % 4:
        raise ValueError(f"{name}: the operator must start on a 4-byte boundary")
    if x.dtype != torch.float32 or (scale is not None and scale.dtype != torch.float32):
        raise ValueError(f"{name}: state and scale must be float32")
    if strip.dtype not in _MASK_KIND:
        raise ValueError(f"{name}: unsupported operator dtype {strip.dtype}")
    if d % D_SUB:
        raise ValueError(f"{name}: feature rows {d} must be a multiple of {D_SUB}")
    out = torch.empty_like(x)
    fn = getattr(kernels.load("strip_matmul"), f"gnn_{name}")
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), strip.data_ptr(), _MASK_KIND[strip.dtype],
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            d, strip.shape[0], kernels.stream_of(x),
        )
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def strip_aggregate_t(state_t: torch.Tensor, op: StripOperator) -> torch.Tensor:
    """``Adjᵀ·state`` on feature-major state: (d_pad, N) → (d_pad, N),
    through the diagonal blocks plus the BCSR residual when present;
    differentiable in ``state_t``."""
    out = strip_matmul(state_t, op.strip, op.scale)
    if op.residual is not None:
        out = out + bcsr_aggregate_t(state_t, op.residual)
    return out
