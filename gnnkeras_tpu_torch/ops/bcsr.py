"""Block-sparse (BCSR) neighbour aggregation.

Merged disjoint-union batches tile into a thin band of dense 128×128 blocks;
aggregation is a tile gather, one batched block product and a segment sum
over destination tiles:

    gathered = state_tiles[src_tile]
    prod     = einsum('bij,bid->bjd', blocks, gathered)
    agg      = segment_sum(prod, dst_tile, n_tiles)

``blocks[b][i, j] = w(edge src_tile[b]·T+i → dst_tile[b]·T+j)``.  The JAX
package also leaves these products to its compiler (plain einsums, no Pallas
kernel), so here they are ``torch.einsum`` plus ``index_add_``.  Counterpart
of ``gnnkeras_tpu.ops.bcsr`` up to ``pad_bcsr``; ``QuantBcsr`` comes with a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.ops.segment import segment_sum
from gnnkeras_tpu_torch.utils.dtypes import floatx

TILE = 128

# build BCSR only while the nonzero blocks stay within this multiple of the
# diagonal; beyond it the dense blocks outweigh the edge-list scatter
_MAX_BAND_FACTOR = 8


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

    def to(self, device) -> "BcsrMatrix":
        return dataclasses.replace(
            self, blocks=self.blocks.to(device), src_tile=self.src_tile.to(device),
            dst_tile=self.dst_tile.to(device),
        )


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


def bcsr_aggregate(state: torch.Tensor, m: BcsrMatrix) -> torch.Tensor:
    """``Mᵀ·state``: (n_src_tiles·T, d) → (n_dst_tiles·T, d)."""
    d = state.shape[1]
    operand = state.to(m.blocks.dtype)
    gathered = operand.reshape(m.n_src_tiles, m.tile, d)[m.src_tile.long()]  # (B, T, d)
    prod = torch.einsum("bij,bid->bjd", m.blocks, gathered).float()
    agg = segment_sum(prod, m.dst_tile, m.n_dst_tiles)
    return agg.reshape(m.n_dst_tiles * m.tile, d).to(state.dtype)


def bcsr_aggregate_t(state_t: torch.Tensor, m: BcsrMatrix) -> torch.Tensor:
    """``Mᵀ·state`` on feature-major state: (d, n_src_tiles·T) →
    (d, n_dst_tiles·T)."""
    d = state_t.shape[0]
    operand = state_t.to(m.blocks.dtype)
    gathered = operand.reshape(d, m.n_src_tiles, m.tile)[:, m.src_tile.long()]  # (d, B, T)
    prod = torch.einsum("dbi,bij->bdj", gathered, m.blocks).float()
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
