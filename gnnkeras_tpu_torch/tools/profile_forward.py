"""Where the time goes in the port's flagship paths, on one NVIDIA card.

    python -m gnnkeras_tpu_torch.tools.profile_forward

For the bench-scale flagship forward (``GNNgraphBased.forward`` on the
slot-packed synthetic bench batch), the same forward fused into one launch
(``forward_fused``, bf16 blocks) and exported (``export_forward``, the
loaded program's ``call``), the bench-scale train step
(``training.trainer.train_step``, Adam, on the same batch), the arc-focused
forward and train step (``GNNarcBased`` on ``bench_arc_graph``, the same
graphs in arc focus), ``Predictor`` requests of 1, 16 and 64 molecules
(fused route), and the single large graph's forward and train step
(``large_graph_gnn`` on ``large_banded_graph``: 500,000 nodes, through the
banded int8 decomposition of ``agg_dtype='auto'`` at band 64 and through
quantised BCSR, ``agg_dtype='int8'``, at band 384; mse on its normal
targets), it prints one JSON line each with the
host-clock time (median of 7, synchronised), and, from one window of three
calls under ``torch.profiler``: the window's wall time per call, the
device-busy time per call (sum of kernel and memcpy time), the device's idle
share of that same window (1 - busy / wall, unclipped: a negative share
means the busy time is miscounted), and the device time by kernel name
(top 12).  Three host-side phases of a request (merge, batch
build, whole-unfold operator build) are timed separately.  The log also goes
to ``chiprun_out/profile_forward.jsonl``.  Needs a card.
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host_ms(fn, reps=7):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def _profile(fn, calls=3):
    """(wall ms per call, device-busy ms per call, {kernel: device ms per call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    by_name = {}
    for ev in prof.key_averages():
        if getattr(ev, "is_user_annotation", False):
            continue  # a named range (e.g. Optimizer.step) spans kernels counted on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3 / calls
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return wall, busy, top


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs an NVIDIA card")

    from gnnkeras_tpu_torch import Predictor, from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import arc_gnn, bench_arc_graph, bench_graph, flagship_gnn, random_molecules
    from gnnkeras_tpu_torch.ops.fused import build_fused_diag_t

    card = torch.cuda.get_device_name(0)
    lines = []

    def emit(obj):
        obj["card"] = card
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    model = flagship_gnn("cuda", seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # bench batch: bf16 strip fallback
        batch = from_graph_object(bench_graph(), slot_pack=128, strip_dtype="int8", device="cuda")
    fwd = lambda: model.forward(batch, training=False)
    host = _host_ms(fwd)
    wall, busy, top = _profile(fwd)
    emit({"path": "flagship_forward", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})

    import tempfile

    from gnnkeras_tpu_torch import export_forward, load_exported
    from gnnkeras_tpu_torch.ops.fused import build_fused_diag

    a = batch.num_arcs
    cpu = batch.to("cpu")
    op = build_fused_diag(cpu.arc_src.numpy()[:a], cpu.arc_dst.numpy()[:a], cpu.arcnode_weight.numpy()[:a],
                          batch.num_nodes, device="cuda")
    fused = lambda: model.forward_fused(batch, op)
    with tempfile.TemporaryDirectory() as path:
        export_forward(model, batch, path)
        exported = load_exported(path)
    for name, fn in (("flagship_forward_fused", fused), ("flagship_exported_call", lambda: exported.call(batch))):
        host = _host_ms(fn)
        wall, busy, top = _profile(fn)
        emit({"path": name, "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
              "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})

    from gnnkeras_tpu_torch.training.trainer import train_step

    trained = flagship_gnn("cuda", seed=0)
    trained.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    step = lambda: train_step(trained, batch)
    host = _host_ms(step)
    wall, busy, top = _profile(step)
    emit({"path": "train_step", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strip fallback
        arc_batch = from_graph_object(bench_arc_graph(), slot_pack=128, strip_dtype="int8", device="cuda")
    arc_model = arc_gnn("cuda", seed=0)
    fwd = lambda: arc_model.forward(arc_batch, training=False)
    host = _host_ms(fwd)
    wall, busy, top = _profile(fwd)
    emit({"path": "arc_forward", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})
    arc_model.compile(optimizer="adam:0.01", loss="categorical_crossentropy")
    step = lambda: train_step(arc_model, arc_batch)
    host = _host_ms(step)
    wall, busy, top = _profile(step)
    emit({"path": "arc_train_step", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})

    sample = random_molecules(64, seed=1)
    p = Predictor.for_graphs(model, sample, batch_size=64, headroom=1.25, device="cuda").warmup()
    for size in (1, 16, 64):
        req = sample[:size]
        host = _host_ms(lambda: p(req))
        wall, busy, top = _profile(lambda: p(req))
        # host phases of the fused route
        merged = p._merge(req)
        t = time.perf_counter()
        for _ in range(5):
            b = from_graph_object(merged, pad_nodes=p.max_nodes, pad_arcs=p.max_arcs, tile_pack=True,
                                  compact_gmax=p.max_graphs, compact_nspan=p.max_nodes // 128 + 1, device="cpu")
        build_ms = (time.perf_counter() - t) * 1e3 / 5
        a = merged.arcs.shape[0]
        t = time.perf_counter()
        for _ in range(5):
            build_fused_diag_t(b.arc_src.numpy()[:a], b.arc_dst.numpy()[:a], b.arcnode_weight.numpy()[:a],
                               b.num_nodes)
        op_ms = (time.perf_counter() - t) * 1e3 / 5
        t = time.perf_counter()
        for _ in range(5):
            p._merge(req)
        merge_ms = (time.perf_counter() - t) * 1e3 / 5
        emit({"path": f"predictor_fused_{size}", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
              "device_idle_share": 1.0 - busy / wall, "merge_ms": merge_ms, "batch_build_ms": build_ms,
              "fused_op_build_ms": op_ms, "device_ms_by_kernel": top})

    from gnnkeras_tpu_torch.data.synthetic import large_banded_graph, large_graph_gnn

    del model, batch, trained, arc_model, arc_batch, p, exported
    torch.cuda.empty_cache()
    for route, band, agg_dtype in (("large_banded_auto", 64, "auto"), ("large_quantised_int8", 384, "int8")):
        g = large_banded_graph(band=band)
        t = time.perf_counter()
        big = from_graph_object(g, agg_dtype=agg_dtype, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        large = large_graph_gnn("cuda", seed=0)
        fwd = lambda: large.forward(big, training=False)
        host = _host_ms(fwd)
        wall, busy, top = _profile(fwd)
        emit({"path": f"{route}_forward", "operator": type(big.bcsr).__name__, "nodes": int(g.nodes.shape[0]),
              "arcs": int(g.arcs.shape[0]), "host_build_s": build_s, "host_ms": host, "profiled_wall_ms": wall,
              "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall, "device_ms_by_kernel": top})
        large.compile(optimizer="adam:0.01", loss="mse")
        step = lambda: train_step(large, big)
        torch.cuda.reset_peak_memory_stats()
        host = _host_ms(step)
        wall, busy, top = _profile(step)
        emit({"path": f"{route}_train_step", "host_ms": host, "profiled_wall_ms": wall, "device_busy_ms": busy,
              "device_idle_share": 1.0 - busy / wall, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
              "device_ms_by_kernel": top})
        del big, large, g
        torch.cuda.empty_cache()

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_forward.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
