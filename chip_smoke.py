#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnnkeras_tpu_torch) on one NVIDIA card.

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels of ``gnnkeras_tpu_torch/csrc`` built with nvcc, all at once;
2. kernel checks: each kernel (the strip aggregation's forward and backward,
   the feature-major fused unfold, the row-major fused unfold with bf16 and
   f32 blocks, the arc readout's incidence select and scatter) against
   its plain PyTorch version on the card, on the bench-scale flagship batch
   (the synthetic Mutagenicity-shaped batch of ``bench.py``: ~131k nodes,
   ~267k arcs, 4,337 graphs), its arc-focused twin and on a small ragged
   batch; the incidence kernels also on a pair list of more than 10,240
   pairs.  Times from CUDA graphs replayed between CUDA events, both warm
   (the same operands call after call, resident in L2) and cold (calls
   rotating over copies of the operands that together exceed twice the L2
   cache, so each call reads its operands from device memory);
3. serving: a ``Predictor`` for the flagship graph-focused GNN (random
   weights from seed 0) serves requests of 1, 16 and 64 molecules through
   the fused kernel and one request holding a graph larger than a 128-node
   tile through the eval forward; outputs are checked against the same
   Predictor on the CPU;
4. flagship forward: ``GNNgraphBased.forward`` on the bench-scale
   slot-packed batch (as bench.py builds it, and a variant without parallel
   arcs so the int8 mask+scale storage applies): 5 iterations, 4 strip-kernel
   launches each, checked against the same forward on the CPU;
5. training: the flagship (random weights from seed 0, compiled with
   ``adam:0.01`` and categorical cross-entropy) takes one train step on the
   card and one on the CPU, on each bench-scale batch: loss, k, gradients,
   moving statistics and updated parameters must agree, and the step must
   launch the strip kernel 4 times forward and 4 times backward.  Then
   ``fit`` takes 10 more steps on the card (every loss finite),
   ``evaluate`` and ``predict`` run once, and 7 synchronised steps are
   timed on the host clock;
6. arc serving: a ``Predictor`` for the arc-focused GNN serves requests of
   1, 16 and 64 arc-focused molecules through the fused kernel and its
   readout's select kernel, and one request through the eval forward,
   checked against the CPU;
7. arc forward: ``GNNarcBased.forward`` on the bench-scale arc batch
   (``data/synthetic.bench_arc_graph``): 4 strip launches and 1 select
   launch, checked against the CPU;
8. arc training: one Adam step on the card against the CPU on that batch
   (4 + 4 strip launches, 1 select and 1 scatter launch), 10 ``fit`` steps,
   ``evaluate``, ``predict`` and timed steps;
9. dim_state 10 and per-iteration BatchNorm: one train step each of a
   graph-focused GNN on the bench batch, card against CPU (the dim_state 10
   model's random initial state drawn once on the host and fed to both);
10. fused forward: ``GNNgraphBased.forward_fused`` on the bench batch with
   bf16 and f32 blocks (``build_fused_diag``), one launch of the row-major
   ``fused_unfold`` kernel each, against ``model.forward`` on the card;
11. export: the flagship on the bench batch and the arc model on the bench
   arc batch, saved by ``export_forward``, loaded by ``load_exported`` in a
   subprocess that imports no model class and run there (the strip kernel
   4 times, the select once), against ``model.forward``; and the arc model
   traced on a request of 2 molecules, then run on one of 32 in the same
   template (more live incidence pairs than the template had);
12. micro-batching: 256 single-molecule requests from 32 client threads
   through ``MicroBatcher(max_delay_ms=5)``, each caller's rows against a
   request of its own, throughput against per-request dispatch;
13. HTTP: ``GraphServer`` on an ephemeral port of 127.0.0.1, ``/healthz``,
   ``/metadata`` and 8 concurrent ``/predict`` clients against the
   in-process ``Predictor``.

Then one JSON line listing the kernels, the card line again, and as the last
line ``{"ok": true, "device": {...}}``.  The full log also goes to
``chiprun_out/chip_smoke.jsonl``.  Exits non-zero without a card.
"""

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
LOG = []


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    LOG.append(line)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def graph_ms(fns, calls=10, replays=7):
    """Device time of one call: ``calls`` calls, taking the callables of
    ``fns`` in turn, captured in a CUDA graph and replayed between CUDA
    events; median over ``replays``."""
    import torch

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
    del g
    return float(np.median(times))


def cold_copies(n_bytes):
    """How many copies of a call's operands of ``n_bytes`` together exceed
    twice the L2 cache, so that calls taking them in turn find theirs evicted."""
    import torch

    return 2 * torch.cuda.get_device_properties(0).L2_cache_size // n_bytes + 2


def bound(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def expect_launches(**counts):
    """The launch counts of a run: the given ones, every other kernel 0."""
    from gnnkeras_tpu_torch import kernels

    want = {name: counts.get(name, 0) for name in kernels.LAUNCHES}
    assert dict(kernels.LAUNCHES) == want, (dict(kernels.LAUNCHES), want)
    return want


def without_parallel_arcs(g):
    """The same graphs keeping the first arc of every (src, dst) pair."""
    from gnnkeras_tpu_torch import GraphObject

    _, first = np.unique(g.arcs[:, :2], axis=0, return_index=True)
    return GraphObject(nodes=g.nodes, arcs=g.arcs[np.sort(first)], targets=g.targets, focus="g",
                       aggregation_mode=g.aggregation_mode, NodeGraph=(g.graph_of_node, g.nodegraph_weight))


def fused_inputs(model, batch):
    """Whole-unfold inputs of a tile-packed batch (host-built, as Predictor
    builds them): (state0_t, const_t, w_state, w_agg, op, activation)."""
    import torch
    import torch.nn.functional as F
    from gnnkeras_tpu_torch.ops.fused import build_fused_diag_t

    a = int(batch.arc_mask.sum())
    cpu = batch.to("cpu")
    op = build_fused_diag_t(cpu.arc_src.numpy()[:a], cpu.arc_dst.numpy()[:a], cpu.arcnode_weight.numpy()[:a],
                            cpu.num_nodes)
    assert op is not None, "every edge of a tile-packed molecule batch lies inside its tile"
    dev = batch.device
    with torch.no_grad():
        w_state, w_agg, w_arc, bias, act = model.fold_transition()
        h = bias.shape[0]
        state0 = torch.zeros((16, batch.num_nodes), device=dev)
        state0[:14] = batch.nodes.T
        const = F.pad(w_arc, (0, 16 - h)).T @ batch.agg_arc_labels.T + F.pad(bias, (0, 16 - h))[:, None]
    return state0, const.contiguous(), w_state.detach(), w_agg.detach(), op.to(dev), act


def check_strip(batch, label, timed, name="strip_matmul"):
    """``name`` is the forward kernel ``strip_matmul`` or its backward
    ``strip_matmul_t``; both move the same bytes."""
    import torch
    from gnnkeras_tpu_torch.ops import strip as S

    kernel, plain = getattr(S, name), getattr(S, f"_{name}_plain")
    op = batch.strip
    dev = batch.device
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((16, batch.num_nodes), generator=gen, device=dev)
    with torch.no_grad():
        got = kernel(x, op.strip, op.scale)
        want = plain(x, op.strip, op.scale)
    torch.cuda.synchronize()
    # f32 sums of the same few terms in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    res = {"phase": "kernel_check", "kernel": name, "batch": label,
           "storage": str(op.strip.dtype).replace("torch.", ""), "tiles": int(op.strip.shape[0]),
           "max_abs_diff": float((got - want).abs().max())}
    if timed:
        nnz = int(torch.count_nonzero(op.strip))
        n_bytes = op.strip.numel() * op.strip.element_size() + 2 * x.numel() * 4
        if op.scale is not None:
            n_bytes += op.scale.numel() * 4
        with torch.no_grad():
            res["kernel_ms"] = graph_ms([lambda: kernel(x, op.strip, op.scale)])
            copies = [(x.clone(), op.strip.clone(), None if op.scale is None else op.scale.clone())
                      for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: kernel(*o) for o in copies])
            res["cold_copies"] = len(copies)
            del copies
            res["plain_ms"] = graph_ms([lambda: plain(x, op.strip, op.scale)])
            # the dense f32 operator (transposed for the backward), a yardstick only
            dense = op.strip.float() if op.scale is None else op.strip.float() * op.scale[:, None, :]
            if name == "strip_matmul_t":
                dense = dense.transpose(1, 2).contiguous()
            tiles = x.reshape(16, -1, 128).permute(1, 0, 2).contiguous()
            res["library_ms"] = graph_ms([lambda: torch.bmm(tiles, dense)])
            del dense
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 2 * 16 * nnz)
        res["bytes"], res["nnz"] = n_bytes, nnz
    emit(res)
    return res


def check_fused(model, batch, label, timed):
    import torch
    from gnnkeras_tpu_torch.ops.fused import FusedDiagOperator, _fused_unfold_t_plain, fused_unfold_t

    s0, c, ws, wa, op, act = fused_inputs(model, batch)
    pad = lambda w: torch.nn.functional.pad(w.T, (0, 2, 0, 2)).contiguous()
    with torch.no_grad():
        got = fused_unfold_t(s0, c, ws, wa, op, 5, act)
        want = _fused_unfold_t_plain(s0, c, pad(ws), pad(wa), op.blocks, 5, act)
    torch.cuda.synchronize()
    # 5 chained iterations of f32 sums in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    res = {"phase": "kernel_check", "kernel": "fused_unfold_t", "batch": label, "tiles": int(op.blocks.shape[0]),
           "max_abs_diff": float((got - want).abs().max())}
    if timed:
        nnz = int(torch.count_nonzero(op.blocks))
        n = batch.num_nodes
        n_bytes = op.blocks.numel() * 2 + 3 * 16 * n * 4 + 2 * 16 * 16 * 4
        with torch.no_grad():
            res["kernel_ms"] = graph_ms([lambda: fused_unfold_t(s0, c, ws, wa, op, 5, act)])
            copies = [(s0.clone(), c.clone(), ws, wa, FusedDiagOperator(blocks=op.blocks.clone(), tile=op.tile))
                      for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: fused_unfold_t(*o, 5, act) for o in copies])
            res["cold_copies"] = len(copies)
            del copies
            res["plain_ms"] = graph_ms([lambda: _fused_unfold_t_plain(s0, c, pad(ws), pad(wa), op.blocks, 5, act)])
        n_ops = 5 * (2 * 16 * nnz + 4 * 16 * 16 * n)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, n_ops)
        res["library_ms"] = None
        res["bytes"], res["nnz"] = n_bytes, nnz
    emit(res)
    return res


def fused_rm_operator(batch, dtype):
    """The row-major whole-unfold operator of a tile-packed batch (built on
    the host, moved to the batch's device)."""
    from gnnkeras_tpu_torch.ops.fused import build_fused_diag

    a = int(batch.arc_mask.sum())
    cpu = batch.to("cpu")
    op = build_fused_diag(cpu.arc_src.numpy()[:a], cpu.arc_dst.numpy()[:a], cpu.arcnode_weight.numpy()[:a],
                          cpu.num_nodes, dtype=dtype, device=batch.device)
    assert op is not None, "every edge of a tile-packed molecule batch lies inside its tile"
    return op


# bf16 blocks, the rounding of the state, weights and aggregate every
# iteration: against the unrounded f32 forward every element stays within
# 2^-6 of the state's largest magnitude
BF16_REL = 2.0**-6


def check_fused_rm(model, batch, label, dtype, timed):
    """The row-major whole-unfold kernel against its plain version on the
    card, on the flagship's folded transition over ``batch``."""
    import torch
    from gnnkeras_tpu_torch.ops.fused import FusedDiagOperator, _fused_unfold_plain, fused_unfold

    op = fused_rm_operator(batch, dtype)
    with torch.no_grad():
        w_state, w_agg, w_arc, bias, act = model.fold_transition()
        ws, wa = w_state.detach().contiguous(), w_agg.detach().contiguous()
        c = (batch.agg_arc_labels @ w_arc + bias).contiguous()
        s0 = batch.nodes
        got = fused_unfold(s0, c, ws, wa, op, 5, act)
        want = _fused_unfold_plain(s0, c, ws, wa, op.blocks, 5, act)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    beyond = diff > 1e-5 + 1e-5 * want.abs()
    res = {"phase": "kernel_check", "kernel": "fused_unfold", "batch": label,
           "storage": str(dtype).replace("torch.", ""), "tiles": int(op.blocks.shape[0]), "d": int(s0.shape[1]),
           "max_abs_diff": float(diff.max()), "elements_beyond_f32_tolerance": int(beyond.sum()),
           "rows_beyond_f32_tolerance": int(beyond.any(dim=1).sum()), "rows": int(s0.shape[0])}
    # Both storages: 5 chained iterations of f32 sums in another order.  With
    # bf16 blocks the kernel and its plain version round at the same points;
    # a sum of another order could still land on the neighbouring bf16
    # value, but a molecule's block rows hold two or three nonzeros, and on
    # these batches none has (bit-equal on the bench batch on an H100):
    # such a flip fails the check.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if timed:
        nnz = int(torch.count_nonzero(op.blocks))
        n, d = s0.shape
        n_bytes = op.blocks.numel() * op.blocks.element_size() + 3 * n * d * 4 + 2 * d * d * 4
        with torch.no_grad():
            res["kernel_ms"] = graph_ms([lambda: fused_unfold(s0, c, ws, wa, op, 5, act)])
            copies = [(s0.clone(), c.clone(), ws, wa, FusedDiagOperator(blocks=op.blocks.clone(), tile=op.tile))
                      for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: fused_unfold(*o, 5, act) for o in copies])
            res["cold_copies"] = len(copies)
            del copies
            res["plain_ms"] = graph_ms([lambda: _fused_unfold_plain(s0, c, ws, wa, op.blocks, 5, act)])
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 5 * (2 * d * nnz + 4 * d * d * n))
        res["library_ms"] = None  # no one PyTorch call computes a whole unfold
        res["bytes"], res["nnz"] = n_bytes, nnz
    emit(res)
    return res


def forward_fused_phase(model, b_gpu, ref_batch, dtype, n_arcs, card):
    """``forward_fused`` on the bench batch against ``model.forward`` on
    ``ref_batch`` (the same batch with exact f32 aggregation weights), its
    one ``fused_unfold`` launch and its host time (median of 7,
    synchronised).  Returns the launches of the call."""
    import torch
    from gnnkeras_tpu_torch import kernels

    op = fused_rm_operator(b_gpu, dtype)
    kernels.reset_launches()
    state, out, mask = model.forward_fused(b_gpu, op)
    torch.cuda.synchronize()
    launches = expect_launches(fused_unfold=1)
    k, state_ref, out_ref, mask_ref, _ = model.forward(ref_batch)
    assert k == 5 and torch.equal(mask, mask_ref)
    real = b_gpu.node_mask
    s, s_ref, o, o_ref = state[real], state_ref[real], out[mask], out_ref[mask]
    assert torch.isfinite(o).all() and o.shape == (int(mask.sum()), 2)
    if dtype == torch.float32:
        # the JAX package's tolerance for the same check (tests/test_fused.py)
        torch.testing.assert_close(s, s_ref, rtol=2e-5, atol=2e-6)
        torch.testing.assert_close(o, o_ref, rtol=2e-5, atol=2e-6)
    else:
        # bf16 rounding of the state, the weights and the aggregate every
        # iteration against the unrounded f32 forward
        assert float((s - s_ref).abs().max()) <= BF16_REL * float(s_ref.abs().max())
        assert float((o - o_ref).abs().max()) <= BF16_REL
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward_fused(b_gpu, op)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    emit({"phase": "forward_fused", "storage": str(dtype).replace("torch.", ""), "launches": launches,
          "output_rows": int(mask.sum()), "forward_fused_ms": dt * 1e3, "forward_fused_ms_all": [t * 1e3 for t in ts],
          "transition_edges_per_s": 5 * n_arcs / dt, "arcs": n_arcs,
          "state_max_abs_diff": float((s - s_ref).abs().max()), "out_max_abs_diff": float((o - o_ref).abs().max()),
          "card": card})
    return launches


_LOADER = r"""
import json, sys, time
import numpy as np
import torch
from gnnkeras_tpu_torch import kernels
from gnnkeras_tpu_torch.serving import load_exported

for path in sys.argv[1:]:
    t = time.perf_counter()
    exported = load_exported(path)
    load_s = time.perf_counter() - t
    # the template batch first, then any other batch of its shapes
    pairs = torch.load(path + "/inputs.pt", weights_only=False)
    launches, diffs = [], []
    for batch, want in pairs:
        kernels.reset_launches()
        out, mask = exported.call(batch)
        torch.cuda.synchronize()
        launches.append({k: v for k, v in kernels.LAUNCHES.items() if v})
        rows = mask.bool()
        torch.testing.assert_close(out[rows], want[rows], rtol=1e-5, atol=1e-6)
        diffs.append(float((out[rows] - want[rows]).abs().max()))
    batch = pairs[0][0]
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        exported.call(batch)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    print(json.dumps({"artifact": path, "model_class": exported.meta["model_class"], "load_s": load_s,
                      "launches": launches, "max_abs_diff": diffs, "call_ms": float(np.median(ts)) * 1e3}))
print(json.dumps({"model_modules": sorted(m for m in sys.modules if m.startswith("gnnkeras_tpu_torch.models"))}))
"""


def export_phase(cases, card):
    """Each (label, model, batches, launches) exported on the card for its
    first batch, then loaded and run on every batch in one subprocess that
    imports no model class; its outputs against ``model.forward`` at rtol
    1e-5, its launches counted there, per call.  Returns the loaded
    programs' launches on the template batch by label."""
    import tempfile

    import torch
    from gnnkeras_tpu_torch import export_forward

    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    paths, export_s = {}, {}
    for label, model, batches, _ in cases:
        path = paths[label] = os.path.join(root, label)
        t = time.perf_counter()
        export_forward(model, batches[0], path)
        export_s[label] = time.perf_counter() - t
        torch.save([(b, model.forward(b)[2]) for b in batches], os.path.join(path, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO)
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _LOADER, *paths.values()], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    subprocess_s = time.perf_counter() - t
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert lines[-1] == {"model_modules": []}, lines[-1]
    got = {}
    for (label, model, batches, launches), line in zip(cases, lines):
        assert line["model_class"] == type(model).__name__, (label, line)
        assert line["launches"] == [launches] * len(batches), (label, line, launches)
        got[label] = line["launches"][0]
        emit({"phase": "export", "model": label, "batches": len(batches), "export_s": export_s[label],
              "load_s": line["load_s"], "call_ms": line["call_ms"], "launches": line["launches"],
              "max_abs_diff": line["max_abs_diff"], "subprocess_s": subprocess_s, "card": card})
    for path in paths.values():
        for name in os.listdir(path):
            os.remove(os.path.join(path, name))
        os.rmdir(path)
    os.rmdir(root)
    return got


def microbatch_phase(model, sample, card, n_requests=256, clients=32):
    """``n_requests`` single-molecule requests (cycling over ``sample``)
    from ``clients`` threads through ``MicroBatcher(max_delay_ms=5)``, after
    one untimed round: each caller's rows against a request of its own,
    every micro-batch on the fused route, fewer micro-batches than requests;
    throughput against per-request dispatch, client latencies.  Returns the
    Predictor."""
    import threading

    import torch
    from gnnkeras_tpu_torch import MicroBatcher, Predictor, kernels

    p = Predictor.for_graphs(model, sample, batch_size=32, headroom=1.25, device="cuda").warmup()
    want = [p([g]) for g in sample]
    reqs = [i % len(sample) for i in range(n_requests)]
    t0 = time.perf_counter()
    for i in reqs:
        p([sample[i]])
    t_serial = time.perf_counter() - t0

    mb = MicroBatcher(p, max_delay_ms=5.0)
    for fut in [mb.submit(sample[i]) for i in range(p.max_graphs)]:  # one untimed micro-batch round
        fut.result(timeout=60)
    kernels.reset_launches()
    mb.launches = 0
    lat, results, errors = [], {}, []
    lock = threading.Lock()

    def client(chunk):
        try:
            for j in chunk:
                t = time.perf_counter()
                out = mb(sample[reqs[j]])
                with lock:
                    lat.append(time.perf_counter() - t)
                    results[j] = out
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    per = n_requests // clients
    threads = [threading.Thread(target=client, args=(range(c * per, (c + 1) * per),)) for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    t_mb = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = mb.launches
    mb.close()
    assert not errors, errors
    assert len(results) == n_requests and launches < n_requests, (len(results), launches)
    expect_launches(fused_unfold_t=launches)  # every micro-batch on the fused route
    for j, out in results.items():
        np.testing.assert_allclose(out, want[reqs[j]], rtol=1e-5, atol=1e-6)
    lat_ms = np.asarray(lat) * 1e3
    emit({"phase": "microbatch", "requests": n_requests, "clients": clients, "max_delay_ms": 5.0,
          "micro_batches": launches, "requests_per_s": n_requests / t_mb,
          "per_request_dispatch_requests_per_s": n_requests / t_serial, "speedup": t_serial / t_mb,
          "latency_p50_ms": float(np.percentile(lat_ms, 50)), "latency_p99_ms": float(np.percentile(lat_ms, 99)),
          "template_nodes": p.max_nodes, "template_graphs": p.max_graphs, "card": card})
    return p


def http_phase(p, sample, card, clients=8):
    """``GraphServer`` over ``p`` on an ephemeral port of 127.0.0.1:
    ``/healthz``, ``/metadata`` and ``clients`` concurrent ``/predict``
    requests of 1-4 molecules each against ``p`` in process."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from gnnkeras_tpu_torch.serving_http import GraphServer

    server = GraphServer(p, host="127.0.0.1", port=0).start()
    try:
        host, port = server.address[:2]
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(base + "/metadata", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["focus"] == "g" and meta["fused"] and meta["micro_batched"], meta
        reqs = [sample[4 * i: 4 * i + 1 + i % 4] for i in range(clients)]

        def post(graphs):
            body = json.dumps({"graphs": [{"nodes": g.nodes.tolist(), "arcs": g.arcs.tolist()} for g in graphs]})
            req = urllib.request.Request(base + "/predict", data=body.encode(),
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())["outputs"], time.perf_counter() - t

        with ThreadPoolExecutor(clients) as pool:
            answers = list(pool.map(post, reqs))
        for graphs, (outputs, _) in zip(reqs, answers):
            assert len(outputs) == len(graphs)
            np.testing.assert_allclose(np.concatenate([np.asarray(o) for o in outputs]), p(graphs),
                                       rtol=1e-5, atol=1e-6)
        micro_batches = server.batcher.launches
    finally:
        server.close()
    emit({"phase": "http", "clients": clients, "metadata": meta, "micro_batches": micro_batches,
          "request_ms": [t * 1e3 for _, t in answers], "card": card})


class _Repeat:
    """A sequencer of one batch served ``n`` times (``len``, ``[i]``,
    ``on_epoch_end``, as ``fit`` takes it)."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.batch

    def on_epoch_end(self):
        pass


def train_phase(label, make_model, b_gpu, b_cpu, card, per_step, out_rows=None, n_arcs=None):
    """One Adam step of ``make_model(device)`` on the card against the same
    step on the CPU: loss, k, gradients, moving statistics and updated
    parameters, and the step's launches (``per_step``).  With ``out_rows``
    (the rows ``predict`` returns), then 10 steps through ``fit``,
    ``evaluate``, ``predict`` and 7 timed steps.  Returns the launches of
    one step."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.training.trainer import train_step

    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = make_model(dev)
        models[dev].compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    model, model_cpu = models["cuda"], models["cpu"]
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    logs, aux = train_step(model, b_gpu, model.next_rng())
    torch.cuda.synchronize()
    launches = expect_launches(**per_step)
    logs_cpu, aux_cpu = train_step(model_cpu, b_cpu, model_cpu.next_rng())

    # one step of f32 sums in other orders over ~139k nodes: the loss, the
    # statistics and the gradients agree to rtol 1e-4; entries of a gradient
    # below 1e-6 of its largest are held to 1e-6 of that largest
    loss, loss_cpu = float(logs["loss_sum"] / logs["count"]), float(logs_cpu["loss_sum"] / logs_cpu["count"])
    k, k_cpu = float(aux["k"]), float(aux_cpu["k"])
    assert k == k_cpu == 5.0, (k, k_cpu)
    np.testing.assert_allclose(loss, loss_cpu, rtol=1e-5)
    params_cpu = dict(model_cpu.named_parameters())
    excluded, worst = 0, {}
    for n, p in model.named_parameters():
        grad, grad_cpu = p.grad.cpu().numpy(), params_cpu[n].grad.numpy()
        gmax = float(np.abs(grad_cpu).max())
        np.testing.assert_allclose(grad, grad_cpu, rtol=1e-4, atol=1e-6 * gmax, err_msg=n)
        worst[n] = float(np.abs(grad - grad_cpu).max() / max(gmax, 1e-30))
        # Adam's first step is about lr·sign(g): compare the updated
        # parameters where |g| is not within reach of a sign flip
        live = np.abs(grad_cpu) >= 1e-6 * gmax
        excluded += int((~live).sum())
        np.testing.assert_allclose(p.detach().cpu().numpy()[live], params_cpu[n].detach().numpy()[live],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert not np.array_equal(p.detach().cpu().numpy(), before[n].numpy()), n
    buffers_cpu = dict(model_cpu.named_buffers())
    for n, b in model.named_buffers():
        np.testing.assert_allclose(b.cpu().numpy(), buffers_cpu[n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    res = {"phase": "training", "batch": label, "storage": str(b_gpu.strip.strip.dtype), "k": k,
           "first_step_loss": loss, "first_step_loss_cpu": loss_cpu, "launches_per_step": launches,
           "grad_max_rel_diff": worst, "adam_entries_excluded": excluded, "card": card}

    if out_rows is not None:
        # the user's entry points: 10 more steps through fit, then evaluate and predict
        kernels.reset_launches()
        history = model.fit(_Repeat(b_gpu, 1), epochs=10, verbose=0)
        torch.cuda.synchronize()
        res["fit_launches"] = expect_launches(**{name: 10 * n for name, n in per_step.items()})
        losses = history["loss"]
        assert len(losses) == 10 and np.isfinite(losses).all(), losses
        ev = model.evaluate(_Repeat(b_gpu, 1))
        assert np.isfinite(list(ev.values())).all(), ev
        pred = model.predict(_Repeat(b_gpu, 1))
        assert pred.shape == (out_rows, 2) and np.isfinite(pred).all()
        np.testing.assert_allclose(pred.sum(axis=1), 1.0, rtol=1e-5)
        ts = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(model, b_gpu, model.next_rng())
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        dt = float(np.median(ts))
        res.update({"fit_losses": losses, "evaluate": ev, "train_step_ms": dt * 1e3,
                    "train_step_ms_all": [t * 1e3 for t in ts],
                    "train_transition_edges_per_s": 5 * n_arcs / dt, "arcs": n_arcs})
    emit(res)
    return launches


def as_arc_focus(graphs, seed):
    """The same molecules in arc focus, with a one-hot 2-class target per arc."""
    from gnnkeras_tpu_torch import GraphObject

    rng = np.random.default_rng(seed)
    return [GraphObject(nodes=g.nodes, arcs=g.arcs, targets=np.eye(2, dtype=np.float32)[rng.integers(0, 2, len(g.arcs))],
                        focus="a", aggregation_mode=g.aggregation_mode, arcs_canonical=True) for g in graphs]


def spread_pairs(n_arcs, n_nodes, seed=0):
    """Arc endpoints on ``n_nodes`` nodes whose source lies in one of 3 node
    tiles after its arc tile's home tile and whose destination in one of the
    3 after those: about 6 pairs per arc tile, so more than 10,240 pairs at
    bench scale, where the JAX package leaves its fused pair kernel."""
    rng = np.random.default_rng(seed)
    n_tiles = n_nodes // 128
    home = (np.arange(n_arcs) // 128) * n_tiles // (-(-n_arcs // 128))
    src = ((home + rng.integers(0, 3, n_arcs)) % n_tiles) * 128 + rng.integers(0, 128, n_arcs)
    dst = ((home + 3 + rng.integers(0, 3, n_arcs)) % n_tiles) * 128 + rng.integers(0, 128, n_arcs)
    return src, dst


def check_incidence(inc, arc_src, arc_dst, label, timed, d=14):
    """Both incidence kernels on ``inc`` (on the card) at width ``d``: the
    select held exactly to its plain version, the scatter at f32 tolerance."""
    import dataclasses

    import torch
    from gnnkeras_tpu_torch.ops import incidence as I

    dev = inc.device
    n, a = inc.n_node_tiles * 128, len(arc_src)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = torch.randn((n, d), generator=gen, device=dev)
    state[0, 0] = -0.0
    ct_src = torch.randn((a, d), generator=gen, device=dev)
    ct_dst = torch.randn((a, d), generator=gen, device=dev)
    with torch.no_grad():
        got_sel, want_sel = I.incidence_select(state, inc), I._incidence_select_plain(state, inc)
        got_sc, want_sc = I.incidence_scatter(ct_src, ct_dst, inc), I._incidence_scatter_plain(ct_src, ct_dst, inc)
    torch.cuda.synchronize()
    # the select is a copy: bit for bit
    for got, want in zip(got_sel, want_sel):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), label
    # the scatter: f32 sums of a node's few incident cotangents in another order
    torch.testing.assert_close(got_sc, want_sc, rtol=1e-5, atol=1e-5)
    src_t, dst_t = torch.as_tensor(arc_src, device=dev).long(), torch.as_tensor(arc_dst, device=dev).long()
    assert torch.equal(got_sel[0][:a], state[src_t]) and torch.equal(got_sel[1][:a], state[dst_t])
    common = {"phase": "kernel_check", "batch": label, "d": d, "pairs": inc.n_pairs, "live_pairs": inc.n_live,
              "arc_tiles": inc.n_arc_tiles, "node_tiles": inc.n_node_tiles}
    sel = {**common, "kernel": "incidence_select", "max_abs_diff": 0.0}
    sc = {**common, "kernel": "incidence_scatter", "max_abs_diff": float((got_sc - want_sc).abs().max())}
    if timed:
        cols_bytes = inc.n_live * (2 * 128 + 1) * 4
        a_pad = inc.n_arc_tiles * 128
        sel_bytes = n * d * 4 + cols_bytes + (inc.n_arc_tiles + 1) * 4 + 2 * a_pad * d * 4
        sc_bytes = 2 * a * d * 4 + cols_bytes + (inc.n_node_tiles + 1) * 4 + n * d * 4

        def copy_pairs():
            return dataclasses.replace(inc, **{f.name: getattr(inc, f.name).clone() for f in dataclasses.fields(inc)
                                               if isinstance(getattr(inc, f.name), torch.Tensor)})

        with torch.no_grad():
            sel["kernel_ms"] = graph_ms([lambda: I.incidence_select(state, inc)])
            copies = [(state.clone(), copy_pairs()) for _ in range(cold_copies(sel_bytes))]
            sel["kernel_cold_ms"] = graph_ms([lambda o=o: I.incidence_select(*o) for o in copies])
            sel["cold_copies"] = len(copies)
            sel["plain_ms"] = graph_ms([lambda: I._incidence_select_plain(state, inc)])
            # two gathers, a yardstick only
            sel["library_ms"] = graph_ms([lambda: (torch.index_select(state, 0, src_t),
                                                   torch.index_select(state, 0, dst_t))])
            sc["kernel_ms"] = graph_ms([lambda: I.incidence_scatter(ct_src, ct_dst, inc)])
            copies = [(ct_src.clone(), ct_dst.clone(), c) for _, c in copies]
            sc["kernel_cold_ms"] = graph_ms([lambda o=o: I.incidence_scatter(*o) for o in copies])
            sc["cold_copies"] = len(copies)
            del copies
            sc["plain_ms"] = graph_ms([lambda: I._incidence_scatter_plain(ct_src, ct_dst, inc)])
            # two scatter-adds into a zeroed output, a yardstick only
            sc["library_ms"] = graph_ms([lambda: state.new_zeros((n, d)).index_add_(0, src_t, ct_src)
                                         .index_add_(0, dst_t, ct_dst)])
        sel["bound_ms"], sel["bound_by"] = bound(sel_bytes, 0)
        sc["bound_ms"], sc["bound_by"] = bound(sc_bytes, 2 * a * d)
        sel["bytes"], sc["bytes"] = sel_bytes, sc_bytes
    emit(sel)
    emit(sc)
    return sel, sc


def wide_gnn(device, ds=0, per_iteration_bn=False):
    """The flagship's architecture at dim_state ``ds``, optionally with
    per-iteration BatchNorm, random weights from seed 0."""
    from gnnkeras_tpu_torch import MLP, GNNgraphBased, get_inout_dims

    ins, ls = get_inout_dims("state", 14, 3, 2, "g", ds)
    ino, lo = get_inout_dims("output", 14, 3, 2, "g", ds)
    net_state = MLP(ins[0], ls, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    net_output = MLP(ino[0], lo, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return GNNgraphBased(net_state, net_output, ds, 5, 0.0, per_iteration_bn=per_iteration_bn).build(
        seed=0, device=device)


def serve_phase(model, model_cpu, sample, big, route_kernel, card):
    """Requests of 1, 16 and 64 molecules (and 16 reversed) through the
    fused route and one holding a graph larger than a tile through the eval
    route, against the same Predictor on the CPU.  ``route_kernel``: the
    kernels each request launches besides ``fused_unfold_t`` on the fused
    route.  Returns the launches of the requests."""
    from gnnkeras_tpu_torch import Predictor, kernels

    p = Predictor.for_graphs(model, sample + [big], batch_size=65, headroom=1.25, device="cuda")
    p_cpu = Predictor.for_graphs(model_cpu, sample + [big], batch_size=65, headroom=1.25, device="cpu")
    assert p.fused and p_cpu.fused
    p.warmup()
    requests = {"1": sample[:1], "16": sample[:16], "64": sample, "16_reversed": sample[:16][::-1],
                "big_plus_8": [big] + sample[:8]}
    fused_requests = {"1", "16", "64", "16_reversed"}
    kernels.reset_launches()
    outs, lat = {}, {}
    for name, req in requests.items():
        before = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        outs[name] = p(req)
        lat[name] = (time.perf_counter() - t) * 1e3
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}
        fused = name in fused_requests
        want = {**({"fused_unfold_t": 1} if fused else {}), **route_kernel}
        assert rose == want, (name, rose, want)
    serve_launches = dict(kernels.LAUNCHES)
    rows = {name: sum(len(g.targets) for g in req) for name, req in requests.items()}
    for name, out in outs.items():
        assert out.shape == (rows[name], 2) and np.isfinite(out).all(), name
        np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
        # same weights, same bf16 blocks on the CPU: f32 sums in another order
        np.testing.assert_allclose(out, p_cpu(requests[name]), rtol=1e-5, atol=1e-6)
    r16 = np.cumsum([0] + [len(g.targets) for g in sample[:16]])
    np.testing.assert_allclose(outs["16_reversed"], np.concatenate([outs["16"][r16[i]:r16[i + 1]]
                                                                    for i in range(15, -1, -1)]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["16"], outs["64"][:rows["16"]], rtol=1e-5, atol=1e-6)
    reps = {}
    for name in ("1", "16", "64", "big_plus_8"):
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            p(requests[name])
            ts.append((time.perf_counter() - t) * 1e3)
        reps[name] = float(np.median(ts))
    emit({"phase": "serving", "focus": p.focus, "template_nodes": p.max_nodes, "template_arcs": p.max_arcs,
          "first_call_ms": lat, "median_ms_of_5": reps, "launches": serve_launches,
          "routes": {n: "fused" if n in fused_requests else "eval" for n in requests}, "card": card})
    return serve_launches


def forward_phase(label, model, model_cpu, b_gpu, b_cpu, n_arcs, out_rows, card, per_forward):
    """The eval forward on the card against the CPU, its launches
    (``per_forward``), its ``out_rows`` output rows (graphs or arcs) and its
    host time (median of 7, synchronised)."""
    import torch
    from gnnkeras_tpu_torch import kernels

    kernels.reset_launches()
    k, state, out, mask, _ = model.forward(b_gpu, training=False)
    torch.cuda.synchronize()
    assert k == 5, k
    launches = expect_launches(**per_forward)
    k_cpu, state_cpu, out_cpu, mask_cpu, _ = model_cpu.forward(b_cpu, training=False)
    assert k_cpu == k
    m = mask.cpu().numpy()
    o = out.cpu().numpy()[m]
    assert np.isfinite(o).all() and o.shape == (out_rows, 2)
    # f32 throughout; only summation order differs from the CPU run
    np.testing.assert_allclose(o, out_cpu.numpy()[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.cpu().numpy(), state_cpu.numpy(), rtol=1e-5, atol=1e-6)
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward(b_gpu, training=False)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    emit({"phase": "forward", "model": model.name, "batch": label, "storage": str(b_gpu.strip.strip.dtype), "k": k,
          "launches": launches, "output_rows": int(m.sum()), "forward_ms": dt * 1e3,
          "transition_edges_per_s": 5 * n_arcs / dt, "arcs": n_arcs, "card": card})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import gnnkeras_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from gnnkeras_tpu_torch import from_graph_object, kernels
    from gnnkeras_tpu_torch.data.synthetic import arc_gnn, bench_arc_graph, bench_graph, flagship_gnn, random_molecules
    from gnnkeras_tpu_torch.ops.incidence import build_incidence_pairs

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build -------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    ptxas = {n: [ln.strip() for ln in kernels.build_log(n).splitlines() if "registers" in ln or "spill" in ln]
             for n in kernels.SOURCES}
    emit({"phase": "build", "card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})

    # -- 2. kernel checks ----------------------------------------------------
    t0 = time.perf_counter()
    bench = bench_graph()  # the bench.py flagship batch (synthetic, seed 0)
    with warnings.catch_warnings():
        # its parallel arcs make int8 storage inapplicable: bf16, as in JAX
        warnings.simplefilter("ignore", RuntimeWarning)
        b_bench_cpu = from_graph_object(bench, slot_pack=128, strip_dtype="int8", device="cpu")
    bench_u = without_parallel_arcs(bench)
    b_int8_cpu = from_graph_object(bench_u, slot_pack=128, strip_dtype="int8", device="cpu")
    assert b_int8_cpu.strip.scale is not None and b_bench_cpu.strip.scale is None
    b_bench, b_int8 = b_bench_cpu.to("cuda"), b_int8_cpu.to("cuda")
    emit({"phase": "bench_batch", "host_build_s": time.perf_counter() - t0,
          "nodes": int(bench.nodes.shape[0]), "arcs": int(bench.arcs.shape[0]), "graphs": int(bench.num_graphs),
          "arcs_without_parallel": int(bench_u.arcs.shape[0]), "padded_nodes": b_bench.num_nodes,
          "tiles": b_bench.num_nodes // 128, "strip_storage": str(b_bench.strip.strip.dtype),
          "residual": b_bench.strip.residual is not None})

    model = flagship_gnn("cuda", seed=0)
    model_cpu = flagship_gnn("cpu", seed=0)
    ragged = random_molecules(37, seed=5) + random_molecules(1, seed=6, min_nodes=150, max_nodes=151)
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    b_ragged = from_graph_object(GraphObject.merge(ragged, "g", "average"), slot_pack=128, strip_dtype="float32",
                                 device="cuda")
    assert b_ragged.strip.residual is not None
    b_ragged_fused = from_graph_object(GraphObject.merge(ragged[:-1], "g", "average"), tile_pack=True, device="cuda")

    strip_bf16 = check_strip(b_bench, "bench", timed=True)
    strip_int8 = check_strip(b_int8, "bench_without_parallel_arcs", timed=True)
    check_strip(b_ragged, "ragged_small", timed=False)
    strip_t_bf16 = check_strip(b_bench, "bench", timed=True, name="strip_matmul_t")
    strip_t_int8 = check_strip(b_int8, "bench_without_parallel_arcs", timed=True, name="strip_matmul_t")
    check_strip(b_ragged, "ragged_small", timed=False, name="strip_matmul_t")
    fused_res = check_fused(model, b_bench, "bench", timed=True)
    check_fused(model, b_ragged_fused, "ragged_small", timed=False)
    rm_res = {dtype: check_fused_rm(model, b_bench, "bench", dtype, timed=True)
              for dtype in (torch.bfloat16, torch.float32)}
    check_fused_rm(model, b_ragged_fused, "ragged_small", torch.bfloat16, timed=False)

    # the arc-focused twin of the bench batch and its pair lists
    t0 = time.perf_counter()
    bench_arc = bench_arc_graph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strip, as in JAX
        b_arc_cpu = from_graph_object(bench_arc, slot_pack=128, strip_dtype="int8", device="cpu")
    b_arc = b_arc_cpu.to("cuda")
    n_real_arcs = int(bench_arc.arcs.shape[0])
    spread_src, spread_dst = spread_pairs(b_arc.num_arcs, b_arc.num_nodes)
    spread_inc = build_incidence_pairs(spread_src, spread_dst, b_arc.num_nodes).to("cuda")
    assert spread_inc.n_live > 10_240, spread_inc.n_live
    emit({"phase": "bench_arc_batch", "host_build_s": time.perf_counter() - t0, "arcs": n_real_arcs,
          "padded_arcs": b_arc.num_arcs, "padded_nodes": b_arc.num_nodes, "pairs": b_arc.arc_inc.n_pairs,
          "live_pairs": b_arc.arc_inc.n_live, "arc_tiles": b_arc.arc_inc.n_arc_tiles,
          "node_tiles": b_arc.arc_inc.n_node_tiles, "strip_storage": str(b_arc.strip.strip.dtype),
          "above_budget_live_pairs": spread_inc.n_live})
    src_np, dst_np = b_arc_cpu.arc_src.numpy(), b_arc_cpu.arc_dst.numpy()
    sel_res, scatter_res = check_incidence(b_arc.arc_inc, src_np, dst_np, "bench_arc", timed=True)
    check_incidence(b_arc.arc_inc, src_np, dst_np, "bench_arc_d24", timed=False, d=24)
    sel_big, scatter_big = check_incidence(spread_inc, spread_src, spread_dst, "above_10240_pairs", timed=True)
    ragged_arc = as_arc_focus(ragged, seed=7)
    b_ragged_arc = from_graph_object(GraphObject.merge(ragged_arc, "a", "average"), slot_pack=128,
                                     strip_dtype="float32", device="cpu")
    check_incidence(b_ragged_arc.arc_inc.to("cuda"), b_ragged_arc.arc_src.numpy(), b_ragged_arc.arc_dst.numpy(),
                    "ragged_small", timed=False, d=3)

    # -- 3. serving ----------------------------------------------------------
    sample = random_molecules(64, seed=1)
    big = random_molecules(1, seed=2, min_nodes=150, max_nodes=151)[0]
    serve_launches = serve_phase(model, model_cpu, sample, big, {}, card)

    # -- 4. flagship forward -------------------------------------------------
    forward_launches = {}
    for label, b_gpu, b_cpu, g in (("bench", b_bench, b_bench_cpu, bench),
                                   ("bench_without_parallel_arcs", b_int8, b_int8_cpu, bench_u)):
        launches = forward_phase(label, model, model_cpu, b_gpu, b_cpu, int(g.arcs.shape[0]), g.num_graphs, card,
                                 dict(strip_matmul=4))
        forward_launches[label] = launches["strip_matmul"]

    # -- 5. training ---------------------------------------------------------
    train_launches = {}
    for label, b_gpu, b_cpu, g in (("bench", b_bench, b_bench_cpu, bench),
                                   ("bench_without_parallel_arcs", b_int8, b_int8_cpu, bench_u)):
        train_launches[label] = train_phase(label, lambda dev: flagship_gnn(dev, seed=0), b_gpu, b_cpu, card,
                                            dict(strip_matmul=4, strip_matmul_t=4), out_rows=g.num_graphs,
                                            n_arcs=int(g.arcs.shape[0]))["strip_matmul_t"]

    # -- 6. arc serving ------------------------------------------------------
    arc_model, arc_model_cpu = arc_gnn("cuda", seed=0), arc_gnn("cpu", seed=0)
    arc_serve_launches = serve_phase(arc_model, arc_model_cpu, as_arc_focus(sample, seed=3),
                                     as_arc_focus([big], seed=4)[0], {"incidence_select": 1}, card)

    # -- 7. arc forward ------------------------------------------------------
    arc_forward = forward_phase("bench_arc", arc_model, arc_model_cpu, b_arc, b_arc_cpu, n_real_arcs, n_real_arcs,
                                card, dict(strip_matmul=4, incidence_select=1))

    # -- 8. arc training -----------------------------------------------------
    arc_train = train_phase("bench_arc", lambda dev: arc_gnn(dev, seed=0), b_arc, b_arc_cpu, card,
                            dict(strip_matmul=4, strip_matmul_t=4, incidence_select=1, incidence_scatter=1),
                            out_rows=n_real_arcs, n_arcs=n_real_arcs)

    # -- 9. dim_state 10, per-iteration BatchNorm ----------------------------
    import gnnkeras_tpu_torch.models.gnn as G

    # one initial state for both devices: drawn once on the host
    draw = G.initial_state(b_bench.num_nodes, 10, torch.Generator().manual_seed(0), "cpu")
    real_initial_state = G.initial_state
    G.initial_state = lambda n, ds, generator, device: draw.to(device)
    try:
        # no iteration is peeled: 5 aggregations forward, the first of the
        # random state needs no gradient
        train_phase("bench_dim_state_10", lambda dev: wide_gnn(dev, ds=10), b_bench, b_bench_cpu, card,
                    dict(strip_matmul=5, strip_matmul_t=4))
    finally:
        G.initial_state = real_initial_state
    train_phase("bench_per_iteration_bn", lambda dev: wide_gnn(dev, per_iteration_bn=True), b_bench, b_bench_cpu,
                card, dict(strip_matmul=4, strip_matmul_t=4))

    # -- 10. fused forward ---------------------------------------------------
    from gnnkeras_tpu_torch.ops.strip import build_strip_operator

    a = int(bench.arcs.shape[0])
    # the eval forward's reference with the fused operator's exact f32
    # weights (the bench strip stores them in bf16)
    strip_f32 = build_strip_operator(b_bench_cpu.arc_src.numpy()[:a], b_bench_cpu.arc_dst.numpy()[:a],
                                     b_bench_cpu.arcnode_weight.numpy()[:a], b_bench_cpu.num_nodes,
                                     dtype="float32", device="cuda")
    b_ref = b_bench.replace(strip=strip_f32)
    ff_launches = {dtype: forward_fused_phase(model, b_bench, b_ref, dtype, a, card)["fused_unfold"]
                   for dtype in (torch.bfloat16, torch.float32)}
    del b_ref, strip_f32

    # -- 11. export ----------------------------------------------------------
    from gnnkeras_tpu_torch import graphs_to_batch
    from gnnkeras_tpu_torch.graph.batch import pad_operators_to_cap

    # arcs padded to the 32 molecules' own arc tiles, so every arc tile
    # holds real arcs
    pad_arcs = -(-sum(len(g.arcs) for g in sample[:32]) // 128) * 128

    def arc_request(graphs, seed):
        """A request-scale arc batch in one padded template, its pair list
        padded to the cap."""
        return pad_operators_to_cap(graphs_to_batch(as_arc_focus(graphs, seed), "a", "average", pad_nodes=2048,
                                                    pad_arcs=pad_arcs, pad_graphs=32, slot_pack=128,
                                                    strip_dtype="float32", device="cuda"))

    # the arc artifact traced on 2 molecules serves 32 in the same template:
    # the live pair count is an input of the program, not a constant; a
    # select that stopped at the template's count would leave the
    # supervised rows that the later pairs feed at zero
    arc_small, arc_full = arc_request(sample[:2], 5), arc_request(sample[:32], 6)
    inc, lo = arc_full.arc_inc, arc_small.arc_inc.n_live
    assert inc.n_live > lo
    past = (inc.f_arc_tile[lo:].long()[:, None] * 128 + torch.arange(128, device="cuda"))[inc.f_cols_src[lo:] >= 0]
    assert arc_full.output_row_mask[past].any()
    arc_launches = {"strip_matmul": 4, "incidence_select": 1}
    export_launches = export_phase([("flagship", model, [b_bench], {"strip_matmul": 4}),
                                    ("arc", arc_model, [b_arc], arc_launches),
                                    ("arc_request_more_live_pairs", arc_model, [arc_small, arc_full], arc_launches)],
                                   card)

    # -- 12. micro-batching, 13. HTTP ------------------------------------------
    mb_predictor = microbatch_phase(model, sample, card)
    http_phase(mb_predictor, sample, card)

    # -- kernels, card, verdict ----------------------------------------------
    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_diff"], "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"]}

    strip_src = "gnnkeras_tpu_torch/csrc/strip_matmul.cu"
    fused_src = "gnnkeras_tpu_torch/csrc/fused_unfold.cu"
    fused_rm_src = "gnnkeras_tpu_torch/csrc/fused_unfold_rm.cu"
    inc_src = "gnnkeras_tpu_torch/csrc/incidence.cu"
    assert arc_serve_launches["incidence_select"] == 5 and arc_serve_launches["fused_unfold_t"] == 4
    assert export_launches["flagship"]["strip_matmul"] == forward_launches["bench"]
    emit({"kernels": [
        entry("strip_matmul", strip_src, "gnnkeras_tpu/ops/strip.py:278", forward_launches["bench"], strip_bf16),
        entry("strip_matmul_int8", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              forward_launches["bench_without_parallel_arcs"], strip_int8),
        entry("strip_matmul_t", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              train_launches["bench"], strip_t_bf16),
        entry("strip_matmul_t_int8", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              train_launches["bench_without_parallel_arcs"], strip_t_int8),
        entry("fused_unfold_t", fused_src, "gnnkeras_tpu/ops/fused.py:241", serve_launches["fused_unfold_t"],
              fused_res),
        entry("fused_unfold", fused_rm_src, "gnnkeras_tpu/ops/fused.py:107", ff_launches[torch.bfloat16],
              rm_res[torch.bfloat16]),
        entry("fused_unfold_f32", fused_rm_src, "gnnkeras_tpu/ops/fused.py:107", ff_launches[torch.float32],
              rm_res[torch.float32]),
        entry("incidence_select", inc_src, "gnnkeras_tpu/ops/incidence.py:375", arc_forward["incidence_select"],
              sel_res),
        entry("incidence_scatter", inc_src, "gnnkeras_tpu/ops/incidence.py:375", arc_train["incidence_scatter"],
              scatter_res),
        # the same two kernels on the list above 10,240 pairs, where the JAX
        # package runs its XLA-assisted pair kernels instead of the fused one
        entry("incidence_select_above_10240_pairs", inc_src, "gnnkeras_tpu/ops/incidence.py:297",
              arc_forward["incidence_select"], sel_big),
        entry("incidence_scatter_above_10240_pairs", inc_src, "gnnkeras_tpu/ops/incidence.py:214",
              arc_train["incidence_scatter"], scatter_big),
    ]})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
