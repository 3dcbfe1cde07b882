"""Whole-unfold kernels for tile-packed batches whose every edge lies inside
its 128-node tile, counterpart of ``gnnkeras_tpu.ops.fused``.

Each tile's whole ``max_iteration`` unfolding is independent of every other
tile, so it runs in one launch.  Two layouts, as in the JAX package:

- feature-major (the serving route of ``Predictor``), ``fused_unfold_t``:

      per tile t, per iteration:
          agg = s · A_t                         (A_t bf16, src rows × dst cols)
          s   = act(W_sᵀ·s + W_aᵀ·agg + c)

- row-major (``GNNnodeBased.forward_fused``), ``fused_unfold``, with the
  state (N, d) unpadded and the blocks in bf16 or f32 (dst rows × src cols):

      per tile t, per iteration, cd the blocks' dtype:
          sc  = cd(s)
          agg = A_t · sc                        (f32 sums)
          s   = act(sc · cd(W_s) + cd(agg) · cd(W_a) + c)

  With bf16 blocks the state, both weights and the aggregate are rounded to
  bf16 (to nearest even) before every product, as the JAX kernel rounds
  them; with f32 blocks nothing is rounded.

Inference BatchNorm folds into the Dense weights and the batch-constant arc
label sum into ``c`` (``GNNnodeBased.fold_transition``).  The kernels are
``csrc/fused_unfold.cu`` and ``csrc/fused_unfold_rm.cu``; on a CPU tensor
each wrapper runs its plain PyTorch version (``_fused_unfold_t_plain``,
``_fused_unfold_plain``).
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


def _diag_blocks(src, dst, weight, n_padded, tile, dst_rows: bool):
    """(T, tile, tile) f32 host blocks, dst rows × src cols when
    ``dst_rows``, else src rows × dst cols; None when an edge crosses a tile
    (or ``n_padded`` is not a tile multiple)."""
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
    rows, cols = (dst, src) if dst_rows else (src, dst)
    native.scatter_add_3d(blocks, dst // tile, rows % tile, cols % tile, weight)
    return blocks


def build_fused_diag(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n_padded: int,
    dtype=torch.bfloat16,
    tile: int = TILE,
    device="cpu",
) -> Optional[FusedDiagOperator]:
    """Blocks for the row-major ``fused_unfold``, stored dst rows × src cols
    (``agg_t = A_t·s_t`` per tile), in bf16 or f32.  Returns None when any
    edge crosses a tile boundary."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"build_fused_diag: blocks are stored in bfloat16 or float32, not {dtype}")
    blocks = _diag_blocks(src, dst, weight, n_padded, tile, dst_rows=True)
    if blocks is None:
        return None
    return FusedDiagOperator(blocks=torch.from_numpy(blocks).to(dtype).to(device), tile=tile)


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
    blocks = _diag_blocks(src, dst, weight, n_padded, tile, dst_rows=False)
    if blocks is None:
        return None
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
    Dense weights, transposed and zero-padded to (d_pad, d_pad) (the zero
    pad columns keep pad rows from leaking into real rows): here for the
    plain version, by the kernel as it stages them.  Returns the (d_pad, N)
    state.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
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
    if state0_t.device.type == "cpu":
        pad_w = lambda w: F.pad(w.T, (0, d_pad - d, 0, d_pad - h)).contiguous()
        return _fused_unfold_t_plain(state0_t, const_t, pad_w(w_state), pad_w(w_agg), op.blocks, int(n_iter),
                                     activation)
    ws, wa = (w.to(torch.float32).contiguous() for w in (w_state, w_agg))
    return _fused_unfold_t_cuda(state0_t, const_t, ws, wa, op.blocks, int(n_iter), activation)


def _fused_unfold_t_cuda(state0_t, const_t, ws, wa, blocks, n_iter, activation):
    """The kernel on (d_pad, N) state and constant and the row-major (d, d)
    weights, which it transposes and zero-pads to (d_pad, d_pad) as it
    stages them."""
    from gnnkeras_tpu_torch import kernels

    if state0_t.device.type != "cuda":
        raise ValueError(f"fused_unfold_t: no kernel for device {state0_t.device}")
    operands = (state0_t, const_t, ws, wa, blocks)
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
    if any(x.data_ptr() % 16 for x in (state0_t, const_t, blocks)):
        raise ValueError("fused_unfold_t: state, const and blocks must start on a 16-byte boundary")
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError("fused_unfold_t is inference-only; call under torch.no_grad()")
    out = torch.empty_like(state0_t)
    lib = kernels.load("fused_unfold")
    with torch.cuda.device(state0_t.device):
        err = lib.gnn_fused_unfold_t(
            state0_t.data_ptr(), const_t.data_ptr(), ws.data_ptr(), wa.data_ptr(),
            blocks.data_ptr(), out.data_ptr(), d_pad, ws.shape[0], blocks.shape[0], n_iter,
            _ACT_CODES[activation], kernels.stream_of(state0_t),
        )
    kernels.check(err, "fused_unfold_t")
    kernels.LAUNCHES["fused_unfold_t"] += 1
    return out


# --------------------------------------------------------------------------
# Row-major whole unfold (kernel row 4)
# --------------------------------------------------------------------------

# the widths the row-major kernel is built for: d is padded on chip to 16 or 32
MAX_ROW_MAJOR_D = 32


def _fused_unfold_plain(state0, const, w_state, w_agg, blocks, n_iter: int, activation: str):
    """``n_iter`` iterations of per-tile ``A_t·sc`` then the transition, in
    plain PyTorch, rounding to the blocks' dtype where the kernel does (the
    weights once, the state and the aggregate every iteration).  bf16 values
    are upcast before every product (a bf16 product is exact in f32), so
    only the f32 summation order can differ from the kernel."""
    act = _ACTIVATIONS[activation]
    cd = blocks.dtype
    n, d = state0.shape
    t = blocks.shape[0]
    a = blocks.to(torch.float32)
    rnd = lambda x: x.to(cd).to(torch.float32)
    ws, wa = rnd(w_state), rnd(w_agg)
    s = state0.to(torch.float32)
    for _ in range(n_iter):
        sc = rnd(s)
        agg = torch.bmm(a, sc.reshape(t, TILE, d)).reshape(n, d)
        s = act(sc @ ws + rnd(agg) @ wa + const)
    return s


def fused_unfold(
    state0: torch.Tensor,
    const: torch.Tensor,
    w_state: torch.Tensor,
    w_agg: torch.Tensor,
    op: FusedDiagOperator,
    n_iter: int,
    activation: str = "selu",
    tiles_per_step: int = 8,
) -> torch.Tensor:
    """Whole unfold on row-major state: state0 (N, d) f32, const (N, h) f32
    (folded BatchNorm shift, arc-label sum and bias), w_state / w_agg the
    folded (d, h) Dense rows; d == h.  Returns the (N, h) state after
    ``n_iter`` iterations.  ``tiles_per_step`` is the JAX kernel's grid
    blocking on the TPU; it is validated and changes neither the result nor
    the CUDA launch (persistent blocks walking the tiles).  A CPU tensor takes the plain
    version; a CUDA tensor launches ``gnn_fused_unfold``."""
    n, d = state0.shape
    if w_state.shape != (d, d) or w_agg.shape != (d, d) or tuple(const.shape) != (n, d):
        raise ValueError(
            f"fused_unfold: the state width must be invariant across iterations: state {tuple(state0.shape)}, "
            f"const {tuple(const.shape)}, w_state {tuple(w_state.shape)}, w_agg {tuple(w_agg.shape)}"
        )
    if activation not in _ACTIVATIONS:
        raise ValueError(f"fused_unfold: unsupported activation {activation!r}")
    if int(tiles_per_step) != tiles_per_step or tiles_per_step < 1:
        raise ValueError(f"fused_unfold: tiles_per_step must be a positive int, got {tiles_per_step!r}")
    t = op.blocks.shape[0]
    if op.tile != TILE or tuple(op.blocks.shape[1:]) != (TILE, TILE) or n != t * TILE:
        raise ValueError(f"fused_unfold: state has {n} rows, operator covers {t * op.tile}")
    cd = op.blocks.dtype
    if cd not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_unfold: blocks must be bfloat16 or float32, got {cd}")
    ws, wa = (w.detach().to(torch.float32).contiguous() for w in (w_state, w_agg))
    if state0.device.type == "cpu":
        return _fused_unfold_plain(state0, const, ws, wa, op.blocks, int(n_iter), activation)
    return _fused_unfold_cuda(state0, const, ws, wa, op.blocks, int(n_iter), activation)


_BLOCK_KIND = {torch.bfloat16: 0, torch.float32: 1}


def _fused_unfold_cuda(state0, const, ws, wa, blocks, n_iter, activation):
    from gnnkeras_tpu_torch import kernels

    if state0.device.type != "cuda":
        raise ValueError(f"fused_unfold: no kernel for device {state0.device}")
    operands = (state0, const, ws, wa, blocks)
    if any(x.device != state0.device for x in operands):
        raise ValueError("fused_unfold: operands on different devices")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("fused_unfold: operands must be contiguous")
    if state0.dtype != torch.float32 or const.dtype != torch.float32:
        raise ValueError("fused_unfold: state and const must be float32")
    d = state0.shape[1]
    if not 1 <= d <= MAX_ROW_MAJOR_D:
        raise ValueError(f"fused_unfold: the kernel takes state widths 1 to {MAX_ROW_MAJOR_D}, got {d}")
    if any(x.data_ptr() % 16 for x in (state0, const, blocks)):
        raise ValueError("fused_unfold: state, const and blocks must start on a 16-byte boundary")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (state0, const)):
        raise NotImplementedError("fused_unfold is inference-only; call under torch.no_grad()")
    out = torch.empty_like(state0)
    lib = kernels.load("fused_unfold_rm")
    with torch.cuda.device(state0.device):
        err = lib.gnn_fused_unfold(
            state0.data_ptr(), const.data_ptr(), ws.data_ptr(), wa.data_ptr(), blocks.data_ptr(),
            _BLOCK_KIND[blocks.dtype], out.data_ptr(), d, blocks.shape[0], n_iter, _ACT_CODES[activation],
            kernels.stream_of(state0),
        )
    kernels.check(err, "fused_unfold")
    kernels.LAUNCHES["fused_unfold"] += 1
    return out
