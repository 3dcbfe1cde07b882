"""Slot-64 compact strips on row-major state, on one NVIDIA card.

    python -m gnnkeras_tpu_torch.tools.bench_strip64

The port of the JAX package's experiment script ``scripts/bench_strip64.py``
(``pack_slot64``, ``strip64_aggregate``, ``packed_aggregate``).  Graphs of at
most 64 nodes are first-fit into 64-node slots (two per 128-node tile); a
graph of 65-128 nodes owns a whole tile and one above 128 an aligned run of
tiles, so the edges that cross a slot boundary (those of the larger graphs)
go to a BCSR residual.  The strip stores each tile's block diagonal
TRANSPOSED: ``cm[t, dst % 64, src % 128] = w(src → dst)``, and the product
on row-major (N, d) state is ``out[tile] = expand(cm[t]) @ x[tile]``.

On the card that is the strip backward kernel (``gnn_strip_matmul_t`` of
``csrc/strip_matmul.cu``) at slot 64 on the transposed state,
``out_rmᵀ = xᵀ @ expand(cm)ᵀ``: one transpose of the state in, one of the
result out (both timed by ``chip_smoke.py``).  With a bf16 strip it takes the
kernel's bf16-state instantiation, which rounds the state to bf16 before the
product, as the script's kernel does.  The script's K tiles per grid step
(a TPU grid-overhead mechanism) leave only the shape rule
``T % k_tiles == 0``; its lane-packed ``(N/8, 128)`` view of the (N, 16)
state (a TPU lane mechanism) is a reshape around the same function.

The script reads Mutagenicity; its data is not in the repository, so this
tool runs on ``data/synthetic.bench_graph()``.  It checks strip plus residual
against the dense ``np.add.at`` aggregation, as the script does, and times
the strip product (f32 and bf16) and the residual with CUDA events around a
CUDA graph.  Needs a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch.ops.strip import D_SUB, TILE, strip_matmul_t
from gnnkeras_tpu_torch.tools.bench_strip_compact import graph_ms

SLOT = 64


def pack_slot64(sizes: np.ndarray):
    """(start of each graph, padded node count): graphs of at most 64 nodes
    first-fit into 64-node slots in order of decreasing size; 65-128 nodes
    own one aligned tile; larger graphs an aligned run of tiles."""
    order = np.argsort(-sizes, kind="stable")
    starts = np.zeros(len(sizes), np.int64)
    bins = []  # [free, next offset] per open 64-node slot
    n_tiles = 0
    for g in order:
        s = int(sizes[g])
        if s > TILE:
            starts[g] = n_tiles * TILE
            n_tiles += -(-s // TILE)
        elif s > SLOT:
            starts[g] = n_tiles * TILE
            n_tiles += 1
        else:
            for b in bins:
                if b[0] >= s:
                    starts[g] = b[1]
                    b[1] += s
                    b[0] -= s
                    break
            else:  # a new tile: two fresh slots
                base = n_tiles * TILE
                starts[g] = base
                bins.append([SLOT - s, base + s])
                bins.append([SLOT, base + SLOT])
                n_tiles += 1
    return starts, n_tiles * TILE


def strip64_aggregate(state: torch.Tensor, strip: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """state (N, d) f32 x the transposed compact strip (T, 64, 128) f32 or
    bf16 → (N, d); N = 128·T and T % ``k_tiles`` == 0.  A bf16 strip
    multiplies the state rounded to bf16."""
    n, d = state.shape
    t = strip.shape[0]
    if n != t * TILE or t % k_tiles:
        raise ValueError(f"{t} tiles and {n} rows: need N = 128·T and T % {k_tiles} == 0")
    d_pad = -(-d // D_SUB) * D_SUB
    x_t = F.pad(state.T, (0, 0, 0, d_pad - d)).contiguous()
    out_t = strip_matmul_t(x_t, strip, slot=SLOT, round_state=strip.dtype == torch.bfloat16)
    return out_t[:d].T.contiguous()


def packed_aggregate(state_p: torch.Tensor, strip: torch.Tensor, k_tiles: int, d_pad: int) -> torch.Tensor:
    """``strip64_aggregate`` on the (N·d_pad/128, 128) lane-packed view of
    (N, d_pad) state, returned in the same view."""
    rows = state_p.shape[0]
    if rows != strip.shape[0] * TILE * d_pad // 128 or state_p.shape[1] != 128:
        raise ValueError(f"packed state {tuple(state_p.shape)} does not hold {strip.shape[0]} tiles of width {d_pad}")
    return strip64_aggregate(state_p.reshape(-1, d_pad), strip, k_tiles).reshape(rows, 128)


def build(seed: int = 0, merged=None):
    """The slot-64 packing of a merged batch (default: the synthetic bench
    batch): (strip (T, 64, 128) f32, residual ``BcsrMatrix`` or None, N, src,
    dst, w, in_slot)."""
    from gnnkeras_tpu_torch.data.synthetic import bench_graph
    from gnnkeras_tpu_torch.ops.bcsr import build_bcsr

    merged = bench_graph(seed) if merged is None else merged
    g_of_n = merged.graph_of_node.astype(np.int64)
    sizes = np.bincount(g_of_n)
    starts, n = pack_slot64(sizes)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos = starts[g_of_n] + (np.arange(len(g_of_n)) - first[g_of_n])
    src = pos[merged.arcs[:, 0].astype(np.int64)]
    dst = pos[merged.arcs[:, 1].astype(np.int64)]
    w = merged.arcnode_weight.astype(np.float64)
    in_slot = (src // SLOT) == (dst // SLOT)
    strip = np.zeros((n // TILE, SLOT, TILE), np.float32)
    s, d, ww = src[in_slot], dst[in_slot], w[in_slot]
    np.add.at(strip, (d // TILE, d % SLOT, s % TILE), ww)
    residual = None
    if not in_slot.all():
        residual = build_bcsr(src[~in_slot], dst[~in_slot], w[~in_slot], n, max_band_factor=10**9)
    return strip, residual, n, src, dst, w, in_slot


def dense_reference(state: np.ndarray, src, dst, w) -> np.ndarray:
    """Every edge's aggregation by ``np.add.at`` (the script's check)."""
    ref = np.zeros_like(state)
    np.add.at(ref, dst, state[src] * w[:, None].astype(np.float32))
    return ref


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_strip64: needs an NVIDIA card")
    from gnnkeras_tpu_torch.ops.bcsr import bcsr_aggregate

    dev = torch.device("cuda")
    strip, residual, n, src, dst, w, in_slot = build(args.seed)
    d = 14
    state = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    ref = dense_reference(state, src, dst, w)
    print(json.dumps({"data": "synthetic bench_graph (Mutagenicity is not in the repository)", "N": n,
                      "T": n // TILE, "edges": int(len(src)), "in_slot": float(in_slot.mean()),
                      "residual_blocks": 0 if residual is None else int(residual.blocks.shape[0])}))
    x = torch.from_numpy(state).to(dev)
    res_dev = None if residual is None else residual.to(dev)
    for storage in (torch.float32, torch.bfloat16):
        sp = torch.from_numpy(strip).to(storage).to(dev)
        got = strip64_aggregate(x, sp, 1)
        if res_dev is not None:
            got = got + bcsr_aggregate(x, res_dev)
        ms = graph_ms([lambda: strip64_aggregate(x, sp, 1)])
        print(json.dumps({"kernel": "strip64_aggregate", "strip": str(storage).replace("torch.", ""), "ms": ms,
                          "strip_plus_residual_max_abs_err_vs_dense": float(np.abs(got.cpu().numpy() - ref).max()),
                          "reference_scale": float(np.abs(ref).max())}))
    if res_dev is not None:
        print(json.dumps({"kernel": "residual bcsr_aggregate", "ms": graph_ms([lambda: bcsr_aggregate(x, res_dev)])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
