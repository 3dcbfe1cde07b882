"""Block-sparse (BCSR) neighbour aggregation, plain and quantised.

Merged disjoint-union batches and banded graphs tile into a thin band of
dense 128×128 blocks; aggregation is a tile gather, one batched block
product and a segment sum over destination tiles:

    gathered = state_tiles[src_tile]
    prod     = einsum('bij,bid->bjd', blocks, gathered)
    agg      = segment_sum(prod, dst_tile, n_tiles)

``blocks[b][i, j] = w(edge src_tile[b]·T+i → dst_tile[b]·T+j)``.  The JAX
package leaves the float products to its compiler (plain einsums, no Pallas
kernel), so here they are ``torch.einsum`` plus ``index_add_``; blocks cast
to bf16 multiply the state rounded to bf16 and sum in f32, as JAX's
``preferred_element_type=f32`` does.

``QuantBcsr`` stores the blocks as an int8 0/1 mask with one f32 scale per
(block, destination column), or as bf16 weights: the counterpart of the JAX
package's quantised BCSR, whose per-block products are a Pallas kernel.
Beside the dense ``mask`` (which the JAX parity and the dense references
read) it carries each block's nonzero entries as two compressed lists,
built on the host by ``quantize_bcsr``: by destination column (the
forward's) and by source row (the backward's), with the bf16 weights in
each order.  The whole ``Mᵀ·state`` (gather, products, sum per destination
tile) is one CUDA kernel per direction (``csrc/qbcsr.cu``), and neither
reads a dense block: ``qbcsr_matmul`` walks each destination tile's blocks
through ``row_ptr`` and, per block, each column's list; its backward
``qbcsr_matmul_t`` walks each source tile's blocks through ``src_order`` /
``src_row_ptr`` and, per block, each row's list.  So no transposed copy of
the operator is stored (the JAX package keeps one, ``mask_t``).  On a CPU
tensor each wrapper runs its plain PyTorch version, a walk of the same
lists (``_qbcsr_list_matmul_plain``, ``_qbcsr_list_matmul_t_plain``);
``_qbcsr_matmul_plain`` and ``_qbcsr_matmul_t_plain`` compute the same from
the dense mask, independent references.  The dense mask goes to the card
with the operator (``to()`` moves every tensor); no kernel reads it.  The
forward is also the custom operator ``gnnkeras_tpu_torch::qbcsr_matmul``,
which an exported program calls with each batch's lists.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.ops.segment import segment_sum
from gnnkeras_tpu_torch.utils.dtypes import floatx
from gnnkeras_tpu_torch.utils.pytree import register_tensor_dataclass

TILE = 128

# build BCSR only while the nonzero blocks stay within this multiple of the
# diagonal; beyond it the dense blocks outweigh the edge-list scatter
_MAX_BAND_FACTOR = 8

# quantised block lists are padded to a multiple of this: the CUDA kernels do
# not need it, but it keeps the blocks equal to the JAX package's, block for block
_QB_KB = 16

_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class BcsrMatrix:
    """Dense T×T blocks plus (src, dst) tile ids, sorted by dst tile.  Rows
    index the source axis, columns the destination axis."""

    blocks: torch.Tensor  # (B, T, T)
    src_tile: torch.Tensor  # (B,) int32
    dst_tile: torch.Tensor  # (B,) int32
    n_src_tiles: int
    n_dst_tiles: int
    tile: int

    def to(self, device, non_blocking: bool = False) -> "BcsrMatrix":
        mv = lambda x: x.to(device, non_blocking=non_blocking)
        return dataclasses.replace(self, blocks=mv(self.blocks), src_tile=mv(self.src_tile), dst_tile=mv(self.dst_tile))


register_tensor_dataclass(BcsrMatrix, static=("n_src_tiles", "n_dst_tiles", "tile"))


def build_bcsr(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n_src_padded: int,
    n_dst_padded: Optional[int] = None,
    tile: int = TILE,
    max_band_factor: int = _MAX_BAND_FACTOR,
    device="cpu",
) -> Optional[BcsrMatrix]:
    """Host-side construction; None when the block structure is too dense
    to pay off."""
    if n_dst_padded is None:
        n_dst_padded = n_src_padded
    if n_src_padded % tile != 0 or n_dst_padded % tile != 0:
        raise ValueError(f"padded sizes ({n_src_padded},{n_dst_padded}) must be multiples of tile {tile}")
    n_src_tiles = n_src_padded // tile
    n_dst_tiles = n_dst_padded // tile
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)

    live = weight != 0.0
    src_l, dst_l, w_l = src[live], dst[live], weight[live]
    block_key = (src_l // tile) * n_dst_tiles + dst_l // tile
    uniq, inverse = native.unique_i64(block_key, return_inverse=True)
    n_blocks = len(uniq)
    if n_blocks > max_band_factor * max(n_src_tiles, n_dst_tiles):
        return None

    order = np.argsort(uniq % n_dst_tiles, kind="stable")  # sort blocks by dst tile
    rank = np.empty_like(order)
    rank[order] = np.arange(n_blocks)

    blocks = np.zeros((max(n_blocks, 1), tile, tile), dtype=floatx())
    native.scatter_add_3d(blocks, rank[inverse], src_l % tile, dst_l % tile, w_l)

    uniq_sorted = uniq[order]
    src_tile = (uniq_sorted // n_dst_tiles).astype(np.int32)
    dst_tile = (uniq_sorted % n_dst_tiles).astype(np.int32)
    if n_blocks == 0:
        src_tile = np.zeros(1, np.int32)
        dst_tile = np.zeros(1, np.int32)
    return BcsrMatrix(
        blocks=torch.from_numpy(blocks).to(device),
        src_tile=torch.from_numpy(src_tile).to(device),
        dst_tile=torch.from_numpy(dst_tile).to(device),
        n_src_tiles=n_src_tiles,
        n_dst_tiles=n_dst_tiles,
        tile=tile,
    )


def _block_products(gathered: torch.Tensor, blocks: torch.Tensor, equation: str) -> torch.Tensor:
    """``einsum(equation)`` of gathered state tiles (already in the blocks'
    dtype) with the blocks; bf16 blocks multiply in f32, so the products of
    the rounded operands sum in f32."""
    if blocks.dtype == torch.bfloat16:
        gathered, blocks = gathered.float(), blocks.float()
    return torch.einsum(equation, gathered, blocks)


def bcsr_aggregate(state: torch.Tensor, m: BcsrMatrix) -> torch.Tensor:
    """``Mᵀ·state``: (n_src_tiles·T, d) → (n_dst_tiles·T, d)."""
    d = state.shape[1]
    operand = state.to(m.blocks.dtype)
    gathered = operand.reshape(m.n_src_tiles, m.tile, d)[m.src_tile.long()]  # (B, T, d)
    prod = _block_products(gathered, m.blocks, "bid,bij->bjd").float()
    agg = segment_sum(prod, m.dst_tile, m.n_dst_tiles)
    return agg.reshape(m.n_dst_tiles * m.tile, d).to(state.dtype)


def bcsr_aggregate_t(state_t: torch.Tensor, m: BcsrMatrix) -> torch.Tensor:
    """``Mᵀ·state`` on feature-major state: (d, n_src_tiles·T) →
    (d, n_dst_tiles·T)."""
    d = state_t.shape[0]
    operand = state_t.to(m.blocks.dtype)
    gathered = operand.reshape(d, m.n_src_tiles, m.tile)[:, m.src_tile.long()]  # (d, B, T)
    prod = _block_products(gathered, m.blocks, "dbi,bij->bdj").float()
    agg = segment_sum(prod, m.dst_tile, m.n_dst_tiles)  # (n_dst, d, T)
    return agg.permute(1, 0, 2).reshape(d, m.n_dst_tiles * m.tile).to(state_t.dtype)


def transpose_bcsr(m: BcsrMatrix) -> BcsrMatrix:
    """Swap src/dst tiles and transpose each block: the operator of
    ``Adjacency·x`` (outgoing aggregation)."""
    order = torch.argsort(m.src_tile, stable=True)
    return BcsrMatrix(
        blocks=m.blocks.transpose(1, 2)[order].contiguous(),
        src_tile=m.dst_tile[order],
        dst_tile=m.src_tile[order],
        n_src_tiles=m.n_dst_tiles,
        n_dst_tiles=m.n_src_tiles,
        tile=m.tile,
    )


def cast_bcsr(m: Optional[BcsrMatrix], dtype) -> Optional[BcsrMatrix]:
    """``m`` with its blocks stored in ``dtype`` (a name or a torch dtype)."""
    if m is None:
        return None
    if not isinstance(dtype, torch.dtype):
        if str(dtype) not in _FLOAT_DTYPES:
            raise ValueError(f"unsupported block dtype {dtype!r}; use one of {sorted(_FLOAT_DTYPES)}")
        dtype = _FLOAT_DTYPES[str(dtype)]
    return dataclasses.replace(m, blocks=m.blocks.to(dtype))


def pad_bcsr(m: Optional[BcsrMatrix], n_blocks: int) -> Optional[BcsrMatrix]:
    """Zero-pad the block list to ``n_blocks`` (exact: zero blocks add
    nothing).  Padding targets the last destination tile, which keeps the
    sorted-by-dst layout."""
    if m is None:
        return None
    extra = n_blocks - int(m.blocks.shape[0])
    if extra <= 0:
        return m
    dev = m.blocks.device
    return dataclasses.replace(
        m,
        blocks=torch.cat([m.blocks, torch.zeros((extra,) + tuple(m.blocks.shape[1:]), dtype=m.blocks.dtype, device=dev)]),
        src_tile=torch.cat([m.src_tile, torch.zeros(extra, dtype=m.src_tile.dtype, device=dev)]),
        dst_tile=torch.cat([m.dst_tile, torch.full((extra,), m.n_dst_tiles - 1, dtype=m.dst_tile.dtype, device=dev)]),
    )


def empty_bcsr(n_src_tiles: int, n_dst_tiles: int, n_blocks: int, tile: int = TILE, dtype=None,
               device="cpu") -> BcsrMatrix:
    """An all-zero operator of ``n_blocks`` blocks (at least one), the
    identity of block aggregation: it gives operators that must share one
    structure the same residual where some have none."""
    dtype = torch.from_numpy(np.zeros(0, floatx())).dtype if dtype is None else dtype
    n_blocks = max(int(n_blocks), 1)
    return BcsrMatrix(
        blocks=torch.zeros((n_blocks, tile, tile), dtype=dtype, device=device),
        src_tile=torch.zeros(n_blocks, dtype=torch.int32, device=device),
        dst_tile=torch.full((n_blocks,), max(n_dst_tiles - 1, 0), dtype=torch.int32, device=device),
        n_src_tiles=int(n_src_tiles),
        n_dst_tiles=int(n_dst_tiles),
        tile=tile,
    )


# -- quantised blocks: int8 mask + per-column scale, or bf16 weights ----------


@dataclasses.dataclass(frozen=True)
class QuantBcsr:
    """Quantised block operator, blocks sorted by destination tile.

    ``mask`` is int8 0/1 with ``scale`` the per-(block, destination column)
    f32 factor, or bf16 weights with ``scale=None``.  ``row_ptr[j] ..
    row_ptr[j+1]`` are destination tile j's blocks; ``src_order`` lists the
    blocks sorted (stably) by source tile and ``src_row_ptr`` delimits each
    source tile's run in it, for the backward, which reads the same blocks
    transposed.

    The kernels read the nonzero entries of ``mask`` as lists instead.
    Block b's entries are ``nz_start[b] .. nz_start[b+1]`` of each list.
    By destination column (the forward's): column c's entries are
    ``col_start[b, c] .. col_start[b, c+1]`` after ``nz_start[b]``, their
    source rows ``col_rows`` ascending, their bf16 weights ``col_weights``
    (None for the int8 mask, whose entries are 1).  By source row (the
    backward's) likewise: ``row_start``, ``row_cols``, ``row_weights``."""

    mask: torch.Tensor  # (B, T, T) int8 or bf16
    scale: Optional[torch.Tensor]  # (B, T) f32 or None
    src_tile: torch.Tensor  # (B,) i32
    dst_tile: torch.Tensor  # (B,) i32, sorted
    row_ptr: torch.Tensor  # (n_dst_tiles + 1,) i32
    src_order: torch.Tensor  # (B,) i32
    src_row_ptr: torch.Tensor  # (n_src_tiles + 1,) i32
    nz_start: torch.Tensor  # (B + 1,) i32 each block's first entry in both lists
    col_start: torch.Tensor  # (B, T + 1) i16 block-local offsets of each destination column
    col_rows: torch.Tensor  # (nnz,) u8 source row of each entry, by (block, column, row)
    col_weights: Optional[torch.Tensor]  # (nnz,) bf16 in col_rows' order, or None (int8)
    row_start: torch.Tensor  # (B, T + 1) i16 block-local offsets of each source row
    row_cols: torch.Tensor  # (nnz,) u8 destination column of each entry, by (block, row, column)
    row_weights: Optional[torch.Tensor]  # (nnz,) bf16 in row_cols' order, or None (int8)
    n_src_tiles: int
    n_dst_tiles: int
    tile: int

    def to(self, device, non_blocking: bool = False) -> "QuantBcsr":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


register_tensor_dataclass(QuantBcsr, static=("n_src_tiles", "n_dst_tiles", "tile"))


def _block_index(src_tile: torch.Tensor, dst_tile: torch.Tensor, n_src: int, n_dst: int):
    """(row_ptr, src_order, src_row_ptr) of a block list sorted by
    destination tile, on the tile ids' device."""
    dev, i32 = dst_tile.device, torch.int32
    row_ptr = torch.searchsorted(dst_tile, torch.arange(n_dst + 1, dtype=dst_tile.dtype, device=dev)).to(i32)
    src_order = torch.argsort(src_tile, stable=True)
    by_src = src_tile[src_order].contiguous()
    src_row_ptr = torch.searchsorted(by_src, torch.arange(n_src + 1, dtype=by_src.dtype, device=dev)).to(i32)
    return row_ptr, src_order.to(i32), src_row_ptr


def _entry_lists(mask: torch.Tensor) -> dict:
    """The per-block nonzero lists of a (B, T, T) int8 0/1 or bf16 mask on
    the host, as the ``QuantBcsr`` fields ``nz_start``, ``col_start``,
    ``col_rows``, ``col_weights``, ``row_start``, ``row_cols`` and
    ``row_weights``.  An entry is nonzero where ``mask`` is; the weights are
    the mask's own bf16 values (None for int8)."""
    b, t = int(mask.shape[0]), int(mask.shape[1])
    # NumPy compares int8 faster than torch does; it has no bf16
    nz = mask.numpy() != 0 if mask.dtype == torch.int8 else (mask != 0).numpy()
    flat = np.flatnonzero(nz)  # by (block, row, column)
    blk, rest = np.divmod(flat, t * t)
    row, col = np.divmod(rest, t)
    if len(blk) >= 2**31:
        raise ValueError(f"{len(blk)} nonzero entries: the lists' offsets are int32")
    by_col = np.argsort(blk * t + col, kind="stable")  # by (block, column, row)

    def starts(counts):
        out = np.zeros((b, t + 1), np.int16)  # at most T·T = 16,384 a block
        np.cumsum(counts.reshape(b, t), axis=1, out=out[:, 1:])
        return torch.from_numpy(out)

    nz_start = np.zeros(b + 1, np.int32)
    np.cumsum(np.bincount(blk, minlength=b), out=nz_start[1:])
    weights = None
    if mask.dtype == torch.bfloat16:
        weights = mask[torch.from_numpy(blk), torch.from_numpy(row), torch.from_numpy(col)]
    return dict(
        nz_start=torch.from_numpy(nz_start),
        col_start=starts(np.bincount(blk * t + col, minlength=b * t)),
        col_rows=torch.from_numpy(row[by_col].astype(np.uint8)),
        col_weights=None if weights is None else weights[torch.from_numpy(by_col)].contiguous(),
        row_start=starts(np.bincount(blk * t + row, minlength=b * t)),
        row_cols=torch.from_numpy(col.astype(np.uint8)),
        row_weights=weights,
    )


def quantize_bcsr(m: Optional[BcsrMatrix], dtype="int8", device=None) -> Optional[QuantBcsr]:
    """Host-side quantisation of a built operator, placed on ``device``
    (default: ``m``'s).  ``int8`` needs the column-constant factorisation
    (sum/normalized/average over deduplicated arcs) and falls back to bf16
    weights, with a warning, where it does not hold; ``bfloat16`` stores the
    weights.  The block list is padded to a multiple of 16 with zero blocks
    at the last destination tile.  The kernels' nonzero lists are built
    here too, from the padded mask."""
    if m is None:
        return None
    if str(dtype) not in ("int8", "bfloat16"):
        raise ValueError(f"unsupported quantised storage {dtype!r}; use 'int8' or 'bfloat16'")
    device = m.blocks.device if device is None else device
    blocks = m.blocks.cpu().float().numpy()
    scale = None
    if str(dtype) == "int8":
        fac = native.factor_mask_scale(blocks)
        if fac is not None:
            mask, scale = fac
        else:
            warnings.warn(
                "int8 mask+scale BCSR storage does not apply: the operator "
                "weights are not column-factorable (parallel arcs, or "
                "per-arc weights); storing the blocks as bfloat16 instead",
                RuntimeWarning,
                stacklevel=2,
            )
    if scale is None:
        mask_t = torch.from_numpy(blocks).to(torch.bfloat16)
    else:
        mask_t = torch.from_numpy(mask)
    src_tile, dst_tile = m.src_tile.cpu(), m.dst_tile.cpu()
    b = mask_t.shape[0]
    extra = -(-max(b, 1) // _QB_KB) * _QB_KB - b
    scale_t = None if scale is None else torch.from_numpy(scale)
    if extra:
        mask_t = torch.cat([mask_t, mask_t.new_zeros((extra,) + tuple(mask_t.shape[1:]))])
        if scale_t is not None:
            scale_t = torch.cat([scale_t, scale_t.new_zeros((extra, scale_t.shape[1]))])
        src_tile = torch.cat([src_tile, src_tile.new_zeros(extra)])
        dst_tile = torch.cat([dst_tile, dst_tile.new_full((extra,), m.n_dst_tiles - 1)])
    row_ptr, src_order, src_row_ptr = _block_index(src_tile, dst_tile, m.n_src_tiles, m.n_dst_tiles)
    mask_t = mask_t.contiguous()
    return QuantBcsr(
        mask=mask_t, scale=scale_t, src_tile=src_tile.contiguous(), dst_tile=dst_tile.contiguous(),
        row_ptr=row_ptr, src_order=src_order, src_row_ptr=src_row_ptr, **_entry_lists(mask_t),
        n_src_tiles=m.n_src_tiles, n_dst_tiles=m.n_dst_tiles, tile=m.tile,
    ).to(device)


def pad_qbcsr(qm: Optional[QuantBcsr], n_blocks: int) -> Optional[QuantBcsr]:
    """``pad_bcsr`` for quantised operators: zero blocks at the last
    destination tile up to ``n_blocks`` rounded up to a multiple of 16; the
    walk indices are rebuilt on the operator's device, and the nonzero
    lists get empty blocks."""
    if qm is None:
        return None
    n_blocks = -(-max(int(n_blocks), 1) // _QB_KB) * _QB_KB
    e = n_blocks - int(qm.mask.shape[0])
    if e <= 0:
        return qm
    zpad = lambda a: torch.cat([a, a.new_zeros((e,) + tuple(a.shape[1:]))])
    src_tile = torch.cat([qm.src_tile, qm.src_tile.new_zeros(e)])
    dst_tile = torch.cat([qm.dst_tile, qm.dst_tile.new_full((e,), qm.n_dst_tiles - 1)])
    row_ptr, src_order, src_row_ptr = _block_index(src_tile, dst_tile, qm.n_src_tiles, qm.n_dst_tiles)
    # the padding blocks hold no entries: their offsets repeat the end
    nz_start = torch.cat([qm.nz_start, qm.nz_start[-1:].expand(e)])
    return dataclasses.replace(
        qm, mask=zpad(qm.mask), scale=None if qm.scale is None else zpad(qm.scale), src_tile=src_tile,
        dst_tile=dst_tile, row_ptr=row_ptr, src_order=src_order, src_row_ptr=src_row_ptr, nz_start=nz_start,
        col_start=zpad(qm.col_start), row_start=zpad(qm.row_start),
    )


def _qbcsr_matmul_plain(x, mask, scale, src_tile, dst_tile, n_dst: int) -> torch.Tensor:
    """``out[:, tile j] = Σ_{b: dst_tile[b]=j} (x[:, tile src_tile[b]] @
    mask[b]) · diag(scale[b])``: gather, per-block products, the scale on
    the output columns, segment sum."""
    d = x.shape[0]
    gathered = x.reshape(d, -1, TILE)[:, src_tile.long()]  # (d, B, T)
    prod = torch.einsum("dbi,bij->bdj", gathered, mask.to(x.dtype))
    if scale is not None:
        prod = prod * scale[:, None, :]
    out = segment_sum(prod, dst_tile, n_dst)  # (n_dst, d, T)
    return out.permute(1, 0, 2).reshape(d, n_dst * TILE)


def _qbcsr_matmul_t_plain(ct, mask, scale, src_tile, dst_tile, n_src: int) -> torch.Tensor:
    """The backward: ``out[:, tile i] = Σ_{b: src_tile[b]=i} (ct[:, tile
    dst_tile[b]] · diag(scale[b])) @ mask[b]ᵀ``, the scale on the input
    columns."""
    d = ct.shape[0]
    gathered = ct.reshape(d, -1, TILE)[:, dst_tile.long()]  # (d, B, T)
    if scale is not None:
        gathered = gathered * scale[None]
    prod = torch.einsum("dbj,bij->bdi", gathered, mask.to(ct.dtype))
    out = segment_sum(prod, src_tile, n_src)  # (n_src, d, T)
    return out.permute(1, 0, 2).reshape(d, n_src * TILE)


def _entry_groups(nz_start: torch.Tensor, starts: torch.Tensor, n_entries: int) -> torch.Tensor:
    """``block·T + c`` for each entry of a list whose block-local offsets by
    ``c`` (a column or a row) are ``starts``: the last (block, c) whose
    global offset is at most the entry's.  No host sync, so the walks run
    inside a CUDA graph."""
    first = (nz_start[:-1, None].long() + starts[:, :TILE].long()).reshape(-1)  # non-decreasing
    k = torch.arange(n_entries, device=first.device)
    return torch.searchsorted(first, k, right=True) - 1


def _qbcsr_list_matmul_plain(x, scale, col_weights, src_tile, dst_tile, nz_start, col_start, col_rows,
                             n_dst: int) -> torch.Tensor:
    """The forward kernel's plain version, a walk of the column lists:
    per block and destination column c, ``part = Σ x[:, 128·src + r]·w``
    over the column's entries (w = 1 for the int8 mask), then ``part ·
    scale[b, c]`` summed into ``out[:, 128·dst + c]``."""
    d, n_blocks = x.shape[0], src_tile.shape[0]
    bc = _entry_groups(nz_start, col_start, col_rows.shape[0])
    b = bc // TILE
    vals = x[:, src_tile.long()[b] * TILE + col_rows.long()]  # (d, nnz)
    if col_weights is not None:
        vals = vals * col_weights.to(x.dtype)
    part = x.new_zeros((d, n_blocks * TILE)).index_add_(1, bc, vals)
    if scale is not None:
        part = part * scale.reshape(-1)
    cols = (dst_tile.long()[:, None] * TILE + torch.arange(TILE, device=x.device)).reshape(-1)
    return x.new_zeros((d, n_dst * TILE)).index_add_(1, cols, part)


def _qbcsr_list_matmul_t_plain(ct, scale, row_weights, src_tile, dst_tile, nz_start, row_start, row_cols,
                               n_src: int) -> torch.Tensor:
    """The backward kernel's plain version, a walk of the row lists: per
    block and source row r, ``out[:, 128·src + r] += Σ ct[:, 128·dst + c] ·
    scale[b, c] · w`` over the row's entries."""
    br = _entry_groups(nz_start, row_start, row_cols.shape[0])
    b, r, c = br // TILE, br % TILE, row_cols.long()
    vals = ct[:, dst_tile.long()[b] * TILE + c]  # (d, nnz)
    if scale is not None:
        vals = vals * scale[b, c]
    if row_weights is not None:
        vals = vals * row_weights.to(ct.dtype)
    return ct.new_zeros((ct.shape[0], n_src * TILE)).index_add_(1, src_tile.long()[b] * TILE + r, vals)


def _check_qbcsr(name: str, x: torch.Tensor, mask, scale, n_in_tiles: int) -> None:
    if x.dim() != 2 or mask.dim() != 3 or tuple(mask.shape[1:]) != (TILE, TILE):
        raise ValueError(f"{name}: bad shapes state {tuple(x.shape)}, blocks {tuple(mask.shape)}")
    if x.shape[1] != n_in_tiles * TILE:
        raise ValueError(f"{name}: state has {x.shape[1]} columns, operator takes {n_in_tiles * TILE}")
    if (mask.dtype == torch.int8) != (scale is not None):
        raise ValueError(f"{name}: int8 blocks need a scale, bf16 blocks take none")
    if scale is not None and tuple(scale.shape) != (mask.shape[0], TILE):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} must be {(mask.shape[0], TILE)}")


def _launch_qbcsr(name: str, x, scale, weights, tile_ids, order, ptr, nz_start, starts, ids,
                  n_out: int) -> torch.Tensor:
    """One launch of ``gnn_{name}`` on the card, counted in
    ``kernels.LAUNCHES[name]``, or an error.  ``tile_ids`` are the tiles the
    kernel reads the state from (src for the forward, dst for the backward),
    ``order`` the walk order (None: the blocks' own), ``ptr`` the per-output
    -tile run offsets; ``nz_start`` / ``starts`` / ``ids`` / ``weights`` the
    direction's nonzero lists (the int8 mask has a scale and no weights,
    bf16 weights no scale)."""
    from gnnkeras_tpu_torch import kernels

    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    d = x.shape[0]
    operands = [t for t in (x, scale, weights, tile_ids, order, ptr, nz_start, starts, ids) if t is not None]
    if any(o.device != x.device for o in operands):
        raise ValueError(f"{name}: operands on different devices")
    if not all(o.is_contiguous() for o in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.dtype != torch.float32 or (scale is not None and scale.dtype != torch.float32):
        raise ValueError(f"{name}: state and scale must be float32")
    if (scale is None) == (weights is None) or (weights is not None and weights.dtype != torch.bfloat16):
        raise ValueError(f"{name}: the lists need either a scale (int8) or bf16 weights")
    if any(t.dtype != torch.int32 for t in (tile_ids, ptr, nz_start) + (() if order is None else (order,))):
        raise ValueError(f"{name}: tile ids and offsets must be int32")
    if starts.dtype != torch.int16 or tuple(starts.shape) != (tile_ids.shape[0], TILE + 1) or ids.dtype != torch.uint8:
        raise ValueError(f"{name}: lists must be (blocks, 129) int16 offsets and uint8 ids")
    if d % 8:
        raise ValueError(f"{name}: feature rows {d} must be a multiple of 8")
    out = x.new_empty((d, n_out * TILE))
    ptr_of = lambda t: None if t is None else t.data_ptr()
    fn = getattr(kernels.load("qbcsr"), f"gnn_{name}")
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), ptr_of(scale), ptr_of(weights), tile_ids.data_ptr(), ptr_of(order), ptr.data_ptr(),
            nz_start.data_ptr(), starts.data_ptr(), ids.data_ptr(), out.data_ptr(), d, x.shape[1] // TILE, n_out,
            kernels.stream_of(x),
        )
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


@torch.library.custom_op("gnnkeras_tpu_torch::qbcsr_matmul", mutates_args=())
def _qbcsr_matmul_op(x: torch.Tensor, scale: Optional[torch.Tensor], col_weights: Optional[torch.Tensor],
                     src_tile: torch.Tensor, dst_tile: torch.Tensor, row_ptr: torch.Tensor, nz_start: torch.Tensor,
                     col_start: torch.Tensor, col_rows: torch.Tensor, n_dst: int) -> torch.Tensor:
    """The forward as one operator of ``torch.library``, so that
    ``torch.export`` records it as one node that takes the lists from each
    batch: the kernel on the card, the plain list walk on the CPU."""
    if x.device.type == "cpu":
        return _qbcsr_list_matmul_plain(x, scale, col_weights, src_tile, dst_tile, nz_start, col_start, col_rows,
                                        n_dst)
    return _launch_qbcsr("qbcsr_matmul", x, scale, col_weights, src_tile, None, row_ptr, nz_start, col_start,
                         col_rows, n_dst)


@_qbcsr_matmul_op.register_fake
def _(x, scale, col_weights, src_tile, dst_tile, row_ptr, nz_start, col_start, col_rows, n_dst):
    return x.new_empty((x.shape[0], n_dst * TILE))


def qbcsr_matmul(x: torch.Tensor, qm: QuantBcsr) -> torch.Tensor:
    """``Mᵀ·x`` on feature-major f32 state (d multiple of 8, n_src_tiles·128
    columns) → (d, n_dst_tiles·128): kernel row 8's forward (not
    differentiable; ``qbcsr_aggregate_t`` is)."""
    _check_qbcsr("qbcsr_matmul", x, qm.mask, qm.scale, qm.n_src_tiles)
    return _qbcsr_matmul_op(x, qm.scale, qm.col_weights, qm.src_tile, qm.dst_tile, qm.row_ptr, qm.nz_start,
                            qm.col_start, qm.col_rows, qm.n_dst_tiles)


def qbcsr_matmul_t(ct: torch.Tensor, qm: QuantBcsr) -> torch.Tensor:
    """The backward of ``qbcsr_matmul``: ``M·ct``, (d, n_dst_tiles·128) →
    (d, n_src_tiles·128), the same blocks read transposed (through the row
    lists) with the scale on the input columns."""
    _check_qbcsr("qbcsr_matmul_t", ct, qm.mask, qm.scale, qm.n_dst_tiles)
    if ct.device.type == "cpu":
        return _qbcsr_list_matmul_t_plain(ct, qm.scale, qm.row_weights, qm.src_tile, qm.dst_tile, qm.nz_start,
                                          qm.row_start, qm.row_cols, qm.n_src_tiles)
    return _launch_qbcsr("qbcsr_matmul_t", ct, qm.scale, qm.row_weights, qm.dst_tile, qm.src_order,
                         qm.src_row_ptr, qm.nz_start, qm.row_start, qm.row_cols, qm.n_src_tiles)


class _QbcsrMatmul(torch.autograd.Function):
    """The quantised block product with its backward kernel as the gradient
    (the operator is data: it gets no gradient)."""

    @staticmethod
    def forward(ctx, x, qm):
        ctx.qm = qm
        return qbcsr_matmul(x, qm)

    @staticmethod
    def backward(ctx, ct):
        return qbcsr_matmul_t(ct.contiguous(), ctx.qm), None


def qbcsr_aggregate_t(state_t: torch.Tensor, qm: QuantBcsr) -> torch.Tensor:
    """``Mᵀ·state`` on feature-major state through the quantised blocks,
    differentiable in ``state_t``; feature rows are padded to a multiple of
    8 for the kernel and cut back."""
    d = state_t.shape[0]
    d_pad = -(-d // 8) * 8
    x = state_t if d_pad == d else F.pad(state_t, (0, 0, 0, d_pad - d))
    out = _QbcsrMatmul.apply(x.contiguous(), qm)
    return out if d_pad == d else out[:d]


def qbcsr_aggregate(state: torch.Tensor, qm: QuantBcsr) -> torch.Tensor:
    """Row-major interface (transpose sandwich; the feature-major engine is
    the intended consumer)."""
    return qbcsr_aggregate_t(state.T, qm).T
