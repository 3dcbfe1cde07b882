"""Whole-unfold kernel for tile-packed batches whose every edge lies inside
its 128-node tile, on feature-major state (the transposed variant of
``gnnkeras_tpu.ops.fused``).

Each tile's whole ``max_iteration`` unfolding is independent of every other
tile, so it runs in one launch:

    per tile t, per iteration:
        agg = s · A_t                           (A_t bf16, src rows × dst cols)
        s   = act(W_sᵀ·s + W_aᵀ·agg + c)

Inference BatchNorm folds into the Dense weights and the batch-constant arc
label sum into ``c`` (``GNNnodeBased.fold_transition``).  ``fused_unfold_t``
is the kernel (``csrc/fused_unfold.cu``); on a CPU tensor it runs its plain
PyTorch version ``_fused_unfold_t_plain``.  The row-major ``fused_unfold``
comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch import native

TILE = 128
D_SUB = 8

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772

# selu spelled with exp(x) - 1, as the JAX kernel spells it (its TPU
# lowering has no expm1)
_ACTIVATIONS = {
    "selu": lambda x: _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * (torch.exp(x) - 1.0)),
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}
_ACT_CODES = {"selu": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "linear": 4}


@dataclasses.dataclass(frozen=True)
class FusedDiagOperator:
    """Dense diagonal aggregation blocks, one per tile; every edge
    intra-tile."""

    blocks: torch.Tensor  # (T, TILE, TILE)
    tile: int

    def to(self, device) -> "FusedDiagOperator":
        return dataclasses.replace(self, blocks=self.blocks.to(device))


def build_fused_diag_t(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n_padded: int,
    dtype=torch.bfloat16,
    tile: int = TILE,
    device="cpu",
) -> Optional[FusedDiagOperator]:
    """Blocks stored src rows × dst cols (``aggᵀ = sᵀ·A_t`` per tile).
    Returns None when any edge crosses a tile boundary."""
    if n_padded % tile != 0:
        return None
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    live = weight != 0.0
    src, dst, weight = src[live], dst[live], weight[live]
    if np.any(src // tile != dst // tile):
        return None
    blocks = np.zeros((n_padded // tile, tile, tile), np.float32)
    native.scatter_add_3d(blocks, dst // tile, src % tile, dst % tile, weight)
    return FusedDiagOperator(blocks=torch.from_numpy(blocks).to(dtype).to(device), tile=tile)


def _fused_unfold_t_plain(state0_t, const_t, ws_t, wa_t, blocks, n_iter: int, activation: str):
    """``n_iter`` iterations of per-tile ``s·A_t`` then the transition, in
    plain PyTorch with the blocks upcast to f32."""
    act = _ACTIVATIONS[activation]
    d, n = state0_t.shape
    t = blocks.shape[0]
    a = blocks.to(torch.float32)
    s = state0_t
    for _ in range(n_iter):
        agg = torch.bmm(s.reshape(d, t, TILE).permute(1, 0, 2), a).permute(1, 0, 2).reshape(d, n)
        s = act(ws_t @ s + wa_t @ agg + const_t)
    return s


def fused_unfold_t(
    state0_t: torch.Tensor,
    const_t: torch.Tensor,
    w_state: torch.Tensor,
    w_agg: torch.Tensor,
    op: FusedDiagOperator,
    n_iter: int,
    activation: str = "selu",
) -> torch.Tensor:
    """Whole unfold on feature-major state.  state0_t / const_t are
    (d_pad, N) with zero pad rows; w_state / w_agg are the row-major (d, h)
    Dense weights, transposed and zero-padded to (d_pad, d_pad) here (the
    zero pad columns keep pad rows from leaking into real rows).  Returns the
    (d_pad, N) state.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    d_pad, n = state0_t.shape
    d, h = w_state.shape
    if d != h:
        raise ValueError("fused_unfold_t: the state width must be invariant across iterations")
    if d_pad % D_SUB or d_pad < d:
        raise ValueError(f"fused_unfold_t: d_pad {d_pad} must be a multiple of {D_SUB} and >= {d}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"fused_unfold_t: unsupported activation {activation!r}")
    t = op.blocks.shape[0]
    if op.tile != TILE or tuple(op.blocks.shape[1:]) != (TILE, TILE) or n != t * TILE:
        raise ValueError(f"fused_unfold_t: state has {n} columns, operator covers {t * op.tile}")
    pad_w = lambda w: F.pad(w.T, (0, d_pad - d, 0, d_pad - h)).contiguous()
    ws_t, wa_t = pad_w(w_state), pad_w(w_agg)
    if state0_t.device.type == "cpu":
        return _fused_unfold_t_plain(state0_t, const_t, ws_t, wa_t, op.blocks, int(n_iter), activation)
    return _fused_unfold_t_cuda(state0_t, const_t, ws_t, wa_t, op.blocks, int(n_iter), activation)


def _fused_unfold_t_cuda(state0_t, const_t, ws_t, wa_t, blocks, n_iter, activation):
    from gnnkeras_tpu_torch import kernels

    if state0_t.device.type != "cuda":
        raise ValueError(f"fused_unfold_t: no kernel for device {state0_t.device}")
    operands = (state0_t, const_t, ws_t, wa_t, blocks)
    if any(x.device != state0_t.device for x in operands):
        raise ValueError("fused_unfold_t: operands on different devices")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("fused_unfold_t: operands must be contiguous")
    if any(x.dtype != torch.float32 for x in operands[:4]) or blocks.dtype != torch.bfloat16:
        raise ValueError("fused_unfold_t: state, const and weights must be float32, blocks bfloat16")
    if const_t.shape != state0_t.shape:
        raise ValueError("fused_unfold_t: const and state shapes differ")
    d_pad = state0_t.shape[0]
    if d_pad not in (8, 16, 24, 32):
        raise ValueError(f"fused_unfold_t: the kernel takes d_pad in (8, 16, 24, 32), got {d_pad}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError("fused_unfold_t is inference-only; call under torch.no_grad()")
    out = torch.empty_like(state0_t)
    lib = kernels.load("fused_unfold")
    with torch.cuda.device(state0_t.device):
        err = lib.gnn_fused_unfold_t(
            state0_t.data_ptr(), const_t.data_ptr(), ws_t.data_ptr(), wa_t.data_ptr(),
            blocks.data_ptr(), out.data_ptr(), d_pad, blocks.shape[0], n_iter,
            _ACT_CODES[activation], kernels.stream_of(state0_t),
        )
    kernels.check(err, "fused_unfold_t")
    kernels.LAUNCHES["fused_unfold_t"] += 1
    return out
