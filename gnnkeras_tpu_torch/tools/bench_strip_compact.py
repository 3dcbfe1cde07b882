"""Compact slot-32 strips on feature-major state, on one NVIDIA card.

    python -m gnnkeras_tpu_torch.tools.bench_strip_compact

The port of the JAX package's experiment scripts
``scripts/bench_pallas_compact.py`` (``strip_aggregate``) and
``scripts/bench_strip_blocked.py`` (``blocked_aggregate``).  Graphs are
packed into 32-node sub-slots of 128-node tiles, so within-slot edges make
each tile's adjacency block diagonal, stored as a (T, 32, 128) strip
``strip[t, i, j] = w(32·(j // 32) + i → j)``; the product is
``out[:, tile t] = x[:, tile t] @ expand(strip[t])`` on (16, N) feature-major
state.  Both functions are the strip kernel of ``csrc/strip_matmul.cu`` at
slot 32 (``ops/strip.strip_matmul``); with a bf16 strip they take its
bf16-state instantiation, which rounds the state to bf16 before the product
as the scripts' kernels do (``x.astype(strip.dtype)``).  The scripts' K
tiles per grid step amortise the TPU's per-step overhead; a CUDA grid has
none to amortise, so ``blocked_aggregate`` keeps only the shape rule
``T % k_tiles == 0``.

The scripts read Mutagenicity; its data is not in the repository, so this
tool runs on ``data/synthetic.bench_graph()`` (the synthetic stand-in of
``bench.py``: 131,488 nodes, 4,337 graphs of about 30 nodes).  It checks the
kernel against the dense ``np.add.at`` reference, as the scripts do, and
times the f32 and bf16 strips with CUDA events around a CUDA graph of 10
calls.  Prints one JSON line per measurement.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Sequence

import numpy as np
import torch

from gnnkeras_tpu_torch.ops.strip import TILE, strip_matmul

SLOT = 32
D, D_SUB = 14, 16  # the state width and its padding to the kernel's 8-row chunks


def strip_aggregate(state_t: torch.Tensor, strip: torch.Tensor) -> torch.Tensor:
    """state_t (d_sub, N) f32 x strip (T, 32, 128) f32 or bf16 → (d_sub, N);
    a bf16 strip multiplies the state rounded to bf16."""
    d_sub, n = state_t.shape
    if n != strip.shape[0] * TILE:
        raise ValueError(f"state has {n} columns, the strip covers {strip.shape[0] * TILE}")
    return strip_matmul(state_t, strip, slot=SLOT, round_state=strip.dtype == torch.bfloat16)


def blocked_aggregate(state_t: torch.Tensor, strip: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """``strip_aggregate`` under the blocked script's shape rule: the tile
    count must be a multiple of ``k_tiles``."""
    t = strip.shape[0]
    if state_t.shape[1] != t * TILE or t % k_tiles:
        raise ValueError(f"{t} tiles and {state_t.shape[1]} columns: need N = 128·T and T % {k_tiles} == 0")
    return strip_aggregate(state_t, strip)


def build(seed: int = 0):
    """The slot-32 strip of the synthetic bench batch: (strip (T, 32, 128)
    f32, N, src, dst, w, in_slot) over packed node positions."""
    from gnnkeras_tpu_torch.data.synthetic import bench_graph
    from gnnkeras_tpu_torch.graph.packing import packed_node_positions

    merged = bench_graph(seed)
    pos, n_rows = packed_node_positions(merged.graph_of_node, tile=SLOT)
    n = -(-n_rows // TILE) * TILE
    src = pos[merged.arcs[:, 0].astype(np.int64)]
    dst = pos[merged.arcs[:, 1].astype(np.int64)]
    w = merged.arcnode_weight.astype(np.float64)
    in_slot = (src // SLOT) == (dst // SLOT)
    strip = np.zeros((n // TILE, SLOT, TILE), np.float32)
    s, d, ww = src[in_slot], dst[in_slot], w[in_slot]
    np.add.at(strip, (d // TILE, s % SLOT, d % TILE), ww)
    return strip, n, src, dst, w, in_slot


def dense_reference(state_t: np.ndarray, src, dst, w, in_slot) -> np.ndarray:
    """The within-slot aggregation by ``np.add.at`` (the scripts' check)."""
    ref = np.zeros_like(state_t)
    s, d, ww = src[in_slot], dst[in_slot], w[in_slot]
    np.add.at(ref.T, d, (state_t[:, s] * ww).T)
    return ref


def graph_ms(fns: Sequence[Callable], calls: int = 10, replays: int = 7) -> float:
    """Device ms of one call: ``calls`` calls (the callables of ``fns`` in
    turn) captured in a CUDA graph, replayed between CUDA events; median of
    ``replays``."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_strip_compact: needs an NVIDIA card")
    dev = torch.device("cuda")
    strip, n, src, dst, w, in_slot = build(args.seed)
    rng = np.random.default_rng(0)
    state_t = rng.standard_normal((D_SUB, n)).astype(np.float32)
    state_t[D:] = 0.0
    ref = dense_reference(state_t, src, dst, w, in_slot)
    print(json.dumps({"data": "synthetic bench_graph (Mutagenicity is not in the repository)", "N": n,
                      "T": n // TILE, "edges": int(len(src)), "in_slot": float(in_slot.mean())}))
    x = torch.from_numpy(state_t).to(dev)
    n_edges = int(in_slot.sum())
    k0 = 8  # the blocked script's check pads the tiles to a multiple of K = 8
    t_pad = -(-strip.shape[0] // k0) * k0
    for storage in (torch.float32, torch.bfloat16):
        sp = torch.from_numpy(strip).to(storage).to(dev)
        got = strip_aggregate(x, sp).cpu().numpy()
        sp_k = torch.nn.functional.pad(sp, (0, 0, 0, 0, 0, t_pad - sp.shape[0]))
        x_k = torch.nn.functional.pad(x, (0, (t_pad - sp.shape[0]) * TILE))
        got_k = blocked_aggregate(x_k, sp_k, k0)[:, :n].cpu().numpy()
        ms = graph_ms([lambda: strip_aggregate(x, sp)])
        print(json.dumps({"kernel": "strip_aggregate", "strip": str(storage).replace("torch.", ""), "ms": ms,
                          "M_edges_per_s": n_edges / ms / 1e3,
                          "max_abs_err_vs_dense": float(np.abs(got - ref).max()),
                          "blocked_k8_max_abs_err_vs_dense": float(np.abs(got_k - ref).max())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
