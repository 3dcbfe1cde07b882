#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnnkeras_tpu_torch) on one NVIDIA card.

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels of ``gnnkeras_tpu_torch/csrc`` built with nvcc, all at once;
2. kernel checks: each kernel (the strip aggregation's forward and backward,
   the fused unfold) against its plain PyTorch version on the card,
   on the bench-scale flagship batch (the synthetic Mutagenicity-shaped batch
   of ``bench.py``: ~131k nodes, ~267k arcs, 4,337 graphs) and on a small
   ragged batch, with times from CUDA graphs replayed between CUDA events,
   both warm (the same operands call after call, resident in L2) and cold
   (calls rotating over copies of the operands that together exceed twice
   the L2 cache, so each call reads its operands from device memory);
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
   timed on the host clock.

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


def train_phase(label, b_gpu, b_cpu, g, card):
    """Phase 5 on one batch; returns the backward kernel's launches per
    train step."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn
    from gnnkeras_tpu_torch.training.trainer import train_step

    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = flagship_gnn(dev, seed=0)
        models[dev].compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    model, model_cpu = models["cuda"], models["cpu"]
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    logs, aux = train_step(model, b_gpu)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert launches == {"strip_matmul": 4, "strip_matmul_t": 4, "fused_unfold_t": 0}, launches
    logs_cpu, aux_cpu = train_step(model_cpu, b_cpu)

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

    # the user's entry points: 10 more steps through fit, then evaluate and predict
    kernels.reset_launches()
    history = model.fit(_Repeat(b_gpu, 1), epochs=10, verbose=0)
    torch.cuda.synchronize()
    fit_launches = dict(kernels.LAUNCHES)
    assert fit_launches == {"strip_matmul": 40, "strip_matmul_t": 40, "fused_unfold_t": 0}, fit_launches
    losses = history["loss"]
    assert len(losses) == 10 and np.isfinite(losses).all(), losses
    ev = model.evaluate(_Repeat(b_gpu, 1))
    assert np.isfinite(list(ev.values())).all(), ev
    pred = model.predict(_Repeat(b_gpu, 1))
    assert pred.shape == (g.num_graphs, 2) and np.isfinite(pred).all()
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, rtol=1e-5)

    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(model, b_gpu, model.next_rng())
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    n_arcs = int(g.arcs.shape[0])
    emit({"phase": "training", "batch": label, "storage": str(b_gpu.strip.strip.dtype), "k": k,
          "first_step_loss": loss, "first_step_loss_cpu": loss_cpu, "launches_per_step": launches,
          "grad_max_rel_diff": worst, "adam_entries_excluded": excluded, "fit_losses": losses,
          "fit_launches": fit_launches, "evaluate": ev, "train_step_ms": dt * 1e3,
          "train_step_ms_all": [t * 1e3 for t in ts], "train_transition_edges_per_s": 5 * n_arcs / dt,
          "arcs": n_arcs, "card": card})
    return launches["strip_matmul_t"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import gnnkeras_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from gnnkeras_tpu_torch import Predictor, from_graph_object, kernels
    from gnnkeras_tpu_torch.data.synthetic import bench_graph, flagship_gnn, random_molecules

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

    # -- 3. serving ----------------------------------------------------------
    sample = random_molecules(64, seed=1)
    big = random_molecules(1, seed=2, min_nodes=150, max_nodes=151)[0]
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
        before = kernels.LAUNCHES["fused_unfold_t"]
        t = time.perf_counter()
        outs[name] = p(req)
        lat[name] = (time.perf_counter() - t) * 1e3
        rose = kernels.LAUNCHES["fused_unfold_t"] - before
        assert rose == (1 if name in fused_requests else 0), (name, rose)
    serve_launches = dict(kernels.LAUNCHES)
    for name, out in outs.items():
        assert out.shape == (len(requests[name]), 2) and np.isfinite(out).all(), name
        np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
        # same weights, same bf16 blocks on the CPU: f32 sums in another order
        np.testing.assert_allclose(out, p_cpu(requests[name]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["16_reversed"], outs["16"][::-1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["16"], outs["64"][:16], rtol=1e-5, atol=1e-6)
    reps = {}
    for name in ("1", "16", "64", "big_plus_8"):
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            p(requests[name])
            ts.append((time.perf_counter() - t) * 1e3)
        reps[name] = float(np.median(ts))
    emit({"phase": "serving", "template_nodes": p.max_nodes, "template_arcs": p.max_arcs,
          "first_call_ms": lat, "median_ms_of_5": reps, "launches": serve_launches,
          "routes": {n: "fused" if n in fused_requests else "eval" for n in requests}})

    # -- 4. flagship forward -------------------------------------------------
    forward_launches = {}
    for label, b_gpu, b_cpu, g in (("bench", b_bench, b_bench_cpu, bench),
                                   ("bench_without_parallel_arcs", b_int8, b_int8_cpu, bench_u)):
        kernels.reset_launches()
        k, state, out, mask, _ = model.forward(b_gpu, training=False)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        assert k == 5, k
        assert launches == {"strip_matmul": k - 1, "strip_matmul_t": 0, "fused_unfold_t": 0}, launches
        forward_launches[label] = launches["strip_matmul"]
        k_cpu, state_cpu, out_cpu, mask_cpu, _ = model_cpu.forward(b_cpu, training=False)
        assert k_cpu == k
        m = mask.cpu().numpy()
        o = out.cpu().numpy()[m]
        assert np.isfinite(o).all() and o.shape == (g.num_graphs, 2)
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
        n_arcs = int(g.arcs.shape[0])
        emit({"phase": "flagship_forward", "batch": label, "storage": str(b_gpu.strip.strip.dtype),
              "k": k, "strip_launches": launches["strip_matmul"], "forward_ms": dt * 1e3,
              "transition_edges_per_s": 5 * n_arcs / dt, "arcs": n_arcs, "card": card})

    # -- 5. training ---------------------------------------------------------
    train_launches = {}
    for label, b_gpu, b_cpu, g in (("bench", b_bench, b_bench_cpu, bench),
                                   ("bench_without_parallel_arcs", b_int8, b_int8_cpu, bench_u)):
        train_launches[label] = train_phase(label, b_gpu, b_cpu, g, card)

    # -- kernels, card, verdict ----------------------------------------------
    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_diff"], "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"]}

    strip_src = "gnnkeras_tpu_torch/csrc/strip_matmul.cu"
    emit({"kernels": [
        entry("strip_matmul", strip_src, "gnnkeras_tpu/ops/strip.py:278", forward_launches["bench"], strip_bf16),
        entry("strip_matmul_int8", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              forward_launches["bench_without_parallel_arcs"], strip_int8),
        entry("strip_matmul_t", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              train_launches["bench"], strip_t_bf16),
        entry("strip_matmul_t_int8", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              train_launches["bench_without_parallel_arcs"], strip_t_int8),
        entry("fused_unfold_t", "gnnkeras_tpu_torch/csrc/fused_unfold.cu", "gnnkeras_tpu/ops/fused.py:241",
              serve_launches["fused_unfold_t"], fused_res),
    ]})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
