"""The flagship forward's throughput: transition edges per second on one card.

    [GNNK_BENCH_SCALE=1.0] python -m gnnkeras_tpu_torch.cli bench [--device cuda]

Workload (as the repository's ``bench.py``): the Mutagenicity dataset
merged into one disjoint-union batch when a ``MUTAG_raw`` dump is in the
working directory, else its synthetic stand-in (``data/synthetic.bench_graph``:
131,488 nodes, 4,337 graphs); ``GNNK_BENCH_SCALE`` < 1 takes the stand-in
at that share.  The batch is slot-packed with int8 strips
(bf16 where the weights do not factor), and the graph-focused GNN with the
starter architecture (``data/synthetic.flagship_gnn``, weights from seed 0,
threshold 0) runs its eval forward with the fixed-length loop, exactly 5
iterations.

Prints one JSON line: ``metric`` ``transition_edges_per_s`` (iterations ×
arcs / the forward's time, the median of the timed runs on the host clock,
synchronised), ``value``, ``unit``, the forward's ms, the workload, and the
card's name and power limit as ``nvidia-smi`` gives them (null on the
CPU).  It has no ``vs_baseline``: ``bench.py``'s denominator was measured on
another machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

TIMED_RUNS = 7


def card_line():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def build_workload(scale: float = 1.0, device="cuda"):
    """(model, batch, arcs, workload name) of the bench on ``device``."""
    from gnnkeras_tpu_torch.data.synthetic import bench_graph, flagship_gnn
    from gnnkeras_tpu_torch.graph.batch import from_graph_object
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    merged, workload = None, "synthetic"
    if scale >= 1.0:
        from gnnkeras_tpu_torch.data.mutag import load_mutag

        try:
            merged = GraphObject.merge(load_mutag(), focus="g", aggregation_mode="average")
            workload = "mutag"
        except FileNotFoundError:
            pass
    if merged is None:
        merged = bench_graph(seed=0, scale=scale)
    with warnings.catch_warnings():
        # parallel arcs make int8 storage inapplicable: bf16 (a RuntimeWarning)
        warnings.simplefilter("ignore", RuntimeWarning)
        batch = from_graph_object(merged, slot_pack=128, strip_dtype="int8", device=device)
    return flagship_gnn(device, seed=0), batch, int(merged.arcs.shape[0]), workload


def run(scale: float = 1.0, device="cuda", timed_runs: int = TIMED_RUNS) -> dict:
    """The bench's record (module docstring)."""
    from gnnkeras_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    model, batch, n_arcs, workload = build_workload(scale, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def forward():
        with torch.no_grad():
            return model.forward(batch, training=False, fixed_length=True)

    k = int(forward()[0])  # warm-up
    times = []
    for _ in range(timed_runs):
        sync()
        t0 = time.perf_counter()
        forward()
        sync()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {"metric": "transition_edges_per_s", "value": k * n_arcs / dt, "unit": "edges/s/card",
            "forward_ms": dt * 1e3, "iterations": k, "arcs": n_arcs, "workload": workload, "scale": scale,
            "device": device.type, "card": card_line() if device.type == "cuda" else None}


def main(device="cuda") -> None:
    """Print the bench's record at the scale ``GNNK_BENCH_SCALE`` sets (1.0
    when unset)."""
    print(json.dumps(run(float(os.environ.get("GNNK_BENCH_SCALE", "1.0")), device)), flush=True)
