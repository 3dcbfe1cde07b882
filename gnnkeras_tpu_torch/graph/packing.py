"""Tile-aligned graph packing (NumPy), the port's copy of
``gnnkeras_tpu.graph.packing``.

Whole graphs are placed into 128-node tiles so no graph straddles a tile
boundary: the aggregation operator becomes block diagonal and the per-graph
readout tile-local.  The layout is a node permutation with gaps; every
consumer is mask-driven, so semantics are unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _slot_ranks(starts: np.ndarray, tile0: np.ndarray) -> np.ndarray:
    """Rank of each graph among the graphs whose first tile it shares, in
    start order (spanning graphs own their run, so they get rank 0)."""
    order = np.argsort(starts, kind="stable")
    rank = np.zeros(len(starts), np.int64)
    last_tile, next_rank = -1, 0
    for g in order:
        t = int(tile0[g])
        if t != last_tile:
            last_tile, next_rank = t, 0
        rank[g] = next_rank
        next_rank += 1
    return rank


def pack_tiles(graph_sizes: np.ndarray, tile: int = 128) -> Tuple[np.ndarray, int]:
    """First-fit-decreasing packing of per-graph node counts into
    ``tile``-node bins.  Graphs of a tile or more take an exclusive aligned
    run of tiles.  Returns (start_offset_per_graph, total_padded_nodes)."""
    n_graphs = len(graph_sizes)
    order = np.argsort(-np.asarray(graph_sizes), kind="stable")
    starts = np.zeros(n_graphs, dtype=np.int64)
    bins = []  # [capacity_left, next_offset]
    n_tiles = 0
    for g in order:
        size = int(graph_sizes[g])
        if size >= tile:
            starts[g] = n_tiles * tile
            n_tiles += size // tile + (1 if size % tile else 0)
            continue
        for b in bins:
            if b[0] >= size:
                starts[g] = b[1]
                b[1] += size
                b[0] -= size
                break
        else:
            starts[g] = n_tiles * tile
            bins.append([tile - size, n_tiles * tile + size])
            n_tiles += 1
    return starts, n_tiles * tile


def order_tiles_by_format(
    starts: np.ndarray, graph_sizes: np.ndarray, slot: int, tile: int = 128, align: int = 1
) -> Tuple[np.ndarray, int, int]:
    """Permute tiles so slot-pure tiles (every resident graph ≤ ``slot``)
    precede tiles holding any larger graph: the mixed-format strip operator
    stores the former as compact strips and the latter as full diagonal
    blocks.  The strip region is padded with empty tiles to a multiple of
    ``align``; spanning (> tile) runs stay contiguous (stable partition).
    Returns (new_starts, n_strip_tiles, total_padded_nodes)."""
    starts = np.asarray(starts, dtype=np.int64)
    sizes = np.asarray(graph_sizes, dtype=np.int64)
    if len(starts) == 0:
        return starts, 0, 0
    tile0 = starts // tile
    end_tile = (starts + np.maximum(sizes, 1) - 1) // tile
    n_tiles = int(end_tile.max()) + 1
    is_block = np.zeros(n_tiles, bool)
    for g in np.flatnonzero(sizes > slot):
        is_block[tile0[g] : end_tile[g] + 1] = True
    ns_raw = int((~is_block).sum())
    ns = -(-ns_raw // align) * align
    order = np.argsort(is_block, kind="stable")
    new_of_old = np.empty(n_tiles, np.int64)
    new_of_old[order[:ns_raw]] = np.arange(ns_raw)
    new_of_old[order[ns_raw:]] = ns + np.arange(n_tiles - ns_raw)
    new_starts = new_of_old[tile0] * tile + starts % tile
    return new_starts, ns, (ns + n_tiles - ns_raw) * tile


def positions_from_starts(graph_of_node: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Node positions for a per-graph start layout: node i of graph g lands
    at ``starts[g] + rank_of_i_within_g`` (original relative order)."""
    graph_of_node = np.asarray(graph_of_node, dtype=np.int64)
    n_graphs = int(graph_of_node.max()) + 1 if len(graph_of_node) else 0
    sizes = np.bincount(graph_of_node, minlength=n_graphs)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    if np.all(np.diff(graph_of_node) >= 0):
        ranks = np.arange(len(graph_of_node)) - first[graph_of_node]
    else:
        order = np.argsort(graph_of_node, kind="stable")
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.arange(len(order)) - first[graph_of_node[order]]
    return starts[graph_of_node] + ranks


def packed_node_positions(graph_of_node: np.ndarray, tile: int = 128) -> Tuple[np.ndarray, int]:
    """Node positions under ``pack_tiles``."""
    graph_of_node = np.asarray(graph_of_node, dtype=np.int64)
    n_graphs = int(graph_of_node.max()) + 1 if len(graph_of_node) else 0
    starts, n_padded = pack_tiles(np.bincount(graph_of_node, minlength=n_graphs), tile)
    return positions_from_starts(graph_of_node, starts), n_padded


def pack_slots(graph_sizes: np.ndarray, slot: int = 32, tile: int = 128) -> Tuple[np.ndarray, int]:
    """Two-level first-fit-decreasing packing: graphs ≤ ``slot`` nodes share
    slot bins, graphs of 2..tile/slot slots take a contiguous slot run within
    one tile, graphs > ``tile`` nodes take exclusive aligned tile runs.
    ``slot == tile`` gives the pure diagonal-block layout.  Returns
    (start_offset_per_graph, total_padded_nodes)."""
    if tile % slot:
        raise ValueError(f"tile {tile} must be a multiple of slot {slot}")
    sizes = np.asarray(graph_sizes, dtype=np.int64)
    order = np.argsort(-sizes, kind="stable")
    starts = np.zeros(len(sizes), dtype=np.int64)
    slots_per_tile = tile // slot
    tiles: list = []  # [free_slot_count, next_free_slot, tile_index]
    slot_bins: list = []  # [capacity_left, next_offset]
    n_tiles = 0
    for g in order:
        size = int(sizes[g])
        if size > tile:
            starts[g] = n_tiles * tile
            n_tiles += -(-size // tile)
            continue
        k = -(-max(size, 1) // slot)
        if k > 1:
            for t in tiles:
                if t[0] >= k:
                    starts[g] = t[2] * tile + t[1] * slot
                    t[1] += k
                    t[0] -= k
                    break
            else:
                starts[g] = n_tiles * tile
                tiles.append([slots_per_tile - k, k, n_tiles])
                n_tiles += 1
            continue
        for b in slot_bins:
            if b[0] >= size:
                starts[g] = b[1]
                b[1] += size
                b[0] -= size
                break
        else:  # open a fresh slot in the first tile with one free
            for t in tiles:
                if t[0] >= 1:
                    host = t
                    break
            else:
                host = [slots_per_tile, 0, n_tiles]
                tiles.append(host)
                n_tiles += 1
            off = host[2] * tile + host[1] * slot
            host[1] += 1
            host[0] -= 1
            starts[g] = off
            slot_bins.append([slot - size, off + size])
    return starts, n_tiles * tile


def graph_slots_from_starts(starts: np.ndarray, graph_sizes: np.ndarray, tile: int = 128):
    """Per-graph readout-slot assignment for a packing in which each graph
    lies within one tile or owns an exclusive aligned tile run.

    Returns ``(tile0, rank, n_tiles, g_max, spanning)``: first tile, rank
    among the graphs of that tile, tile count, most graphs in one tile, and
    the mask of graphs larger than a tile."""
    starts = np.asarray(starts, dtype=np.int64)
    sizes = np.asarray(graph_sizes, dtype=np.int64)
    tile0 = starts // tile
    spanning = sizes > tile
    n_tiles = int(np.max((starts + np.maximum(sizes, 1) - 1) // tile)) + 1 if len(starts) else 0
    rank = _slot_ranks(starts, tile0)
    g_max = int(rank.max()) + 1 if len(rank) else 1
    return tile0, rank, n_tiles, g_max, spanning


def packed_graph_slots(graph_sizes: np.ndarray, tile: int = 128):
    """``graph_slots_from_starts`` for the ``pack_tiles`` layout."""
    sizes = np.asarray(graph_sizes, dtype=np.int64)
    starts, n_padded = pack_tiles(sizes, tile)
    tile0 = starts // tile
    rank = _slot_ranks(starts, tile0)
    g_max = int(rank.max()) + 1 if len(rank) else 1
    return tile0, rank, n_padded // tile, g_max, sizes > tile
