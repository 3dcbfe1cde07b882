#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnnkeras_tpu_torch) on one NVIDIA card.

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels of ``gnnkeras_tpu_torch/csrc`` built with nvcc, all at once;
2. kernel checks: each kernel (the strip aggregation's forward and backward,
   each also against a second launch bit for bit,
   the feature-major fused unfold, the row-major fused unfold with bf16 and
   f32 blocks, the arc readout's incidence select and scatter; the select
   bit for bit against its arc-major copy, the pairs' select and the
   gather, the scatter also against the pairs' one-hot products, and
   against itself bit for bit) against its plain PyTorch version on the card, on the bench-scale
   flagship batch (the synthetic Mutagenicity-shaped batch of ``bench.py``:
   ~131k nodes, ~267k arcs, 4,337 graphs), its arc-focused twin and on a small ragged
   batch; the incidence kernels also on a pair list of more than 10,240
   pairs.  Times from CUDA graphs replayed between CUDA events, both warm
   (the same operands call after call, resident in L2) and cold (calls
   rotating over copies of the operands that together exceed twice the L2
   cache, so each call reads its operands from device memory);
3. serving: a ``Predictor`` for the flagship graph-focused GNN (random
   weights from seed 0) serves requests of 1, 16 and 64 molecules through
   the fused kernel and one request holding a graph larger than a 128-node
   tile through the eval forward; outputs are checked against the same
   Predictor on the CPU.  Then the two fused kernels at the shape a served
   request launches (the 64 molecules packed into the template's tiles),
   checked and timed as in phase 2;
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
   in-process ``Predictor``;
14. the single large graph (``data/synthetic.large_banded_graph``: 500,000
   nodes, 3,892,679 arcs within a band of 64, and its band-384 variant):
   the host build; the strip kernel on a diagonal of the banded
   decomposition and kernel row 8 (quantised block product, both
   directions, walking per-block nonzero lists) on the quantised operators
   of both graphs, int8 and bf16 storage, against their plain versions
   (the int8 forward also bit for bit against the sum order of a walk over
   the dense blocks), with ``torch.sparse.mm`` as the library yardstick; then the node-focused model's eval forward through
   ``agg_dtype='auto'`` (the banded int8 decomposition, 3 diagonals: 3
   strip launches per aggregation) and ``agg_dtype='int8'`` on the band-384
   graph (``QuantBcsr``: one row-8 launch per aggregation) and on the
   band-384 graph with parallel arcs (where ``agg_dtype='int8'`` falls back
   to bf16 blocks) against the plain f32 BCSR route of the same graph, and
   one Adam step each on the card against the CPU, with ``fit``,
   ``evaluate``, ``predict`` and timed steps;
15. slot-32/64 mixed strips (kernel row 3): the strip kernel at slot 32 and
   64 on a bench-scale batch of 4,337 ``random_molecules`` of 5-79 nodes
   (compact strips and full blocks both present) in int8 and bf16, and on
   the bench batch (every
   tile slot-pure), both directions; the flagship's forward and one Adam
   step on each of the mixed batches, and its forward on the bench batch at
   slot 32, card against CPU, with launches;
16. the experiment scripts' compact strips (kernel rows 10-12) through their
   port (``tools/bench_strip_compact.py``, ``tools/bench_strip64.py``) at
   bench scale, f32 and bf16 strips (the bf16-state instantiation of the
   strip kernels): against the dense aggregation and the plain versions,
   with the two transposes around row 12's kernel timed;
17. the edge-partitioned engine (``parallel/partition.py``) on phase 14's
   500k-node graph: one partition into 4 parts (``dense_blocks``, halo,
   ``agg_dtype='auto'``), 4 ranks on the one card (spawned processes, gloo;
   whether an MPS server can run is probed before this process takes the
   card), the ring kernels (row 9) bit for bit against their plain version
   at the halo's and the full state's shape, timed beside the plain version
   and gloo's ``all_gather``; the forward through both
   transports against the single-device forward, and one Adam step through
   ``collective`` against the single-device step, with launches per rank;
18. the model family: the strip kernel at the homogeneous LGNN's widths d
   32, 48, 64 and 80 (the last two its route past 48 feature rows) in both
   directions on the bench operator; then, on the
   bench molecules as 1-type composite graphs, the starter's CLGNN
   (``examples/starter_composite.py``: 5 composite graph-focused layers,
   dim_state 10, threshold 0.01) served by a ``Predictor`` for requests of
   1, 16 and 64 molecules, its eval forward (per-layer k, states and
   outputs, one strip launch per iteration) and one ``parallel`` Adam step
   (25 + 20 strip launches) card against CPU, 3 ``fit`` steps,
   ``evaluate``, ``predict`` and timed steps, and the same forward and step
   for the starter's single CGNN; the homogeneous LGNN of 5 flagship layers
   (dim_state 0, state widths 14-78, so d_pad 16-80) on the bench batch:
   forward (24 strip launches, tallied by width) and one ``residual`` step
   (24 + 24), and its export loaded and run in a subprocess; the 3-type arc
   CGNN on the bench arc twin typed by atom class: forward (4 strip, 1
   select) and one Adam step (4 + 4 strip, 1 select, 1 scatter).  The
   dim_state 10 models draw their initial states on the host
   (``host_initial_state``), so card and CPU draw the same;
19. the data pipeline and the fit loop, on 4,337 ``random_molecules`` of
   5-55 nodes split by ``dataset_splits(seed=0)`` into 2,837 / 750 / 750,
   in ``MultiGraphSequencer``s of 1,000 graphs (``slot_pack=128``,
   ``strip_dtype='int8'``: the latch settles on bf16, parallel arcs): (1)
   the flagship trains 3 epochs with validation, ``EarlyStopping``
   (restoring the best weights), ``ReduceLROnPlateau`` and a ``CSVLogger``
   under ``chiprun_out/``, then ``evaluate`` and ``predict``; the card's
   batches equal a CPU sequencer's, field for field, before and after the
   first background rebuild (its build and the fit's waits timed); (2) the
   same fit through ``PrefetchSequencer`` over a CPU sequencer that builds
   its batches pinned (the History equal to (1)'s at rtol 1e-5); (3) an LGNN of 3 flagship layers (d_pad
   16, 32, 48) in serial mode, 2 epochs a layer with validation,
   ``bake_batch_size=1000``, ``evaluate`` and ``predict``; layer 0's bake
   of the training set on the card against the CPU's from the same weights
   (rtol 1e-5, atol 1e-5, with the bf16 control); the strip kernel bit for bit against its plain
   version at d 16/32/48 on a sequencer batch's operator, both directions;
   (4) ``SingleGraphSequencer`` over phase 14's 500k-node graph (batches
   of 100,000 nodes, ``agg_dtype='auto'``) for one epoch of the node model
   (its first step's loss against the CPU's at rtol 1e-5), and
   ``TransductiveSingleGraphSequencer`` (rate 0.5) training a 2-type
   composite node model one epoch over the same graph.  Launches counted
   every leg.

Then the phase times, one JSON line listing the kernels, the card line
again, and as the last line ``{"ok": true, "device": {...}}``.  The full log also goes to
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


def as_layers(value, cast=lambda v: v):
    """An LGNN's per-layer values as a list, a single GNN's as a list of
    one; each through ``cast``."""
    return [cast(v) for v in (value if isinstance(value, (list, tuple)) else [value])]


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


def check_strip(op, label, timed, name="strip_matmul", d=16, round_state=False):
    """The strip kernel on ``op`` (a ``StripOperator``: slot-128 strips,
    compact slot-32/64 strips, or the mixed format) against its plain
    version, at ``d`` feature rows.  ``name`` is the forward kernel
    ``strip_matmul`` or its backward ``strip_matmul_t``; both move the same
    bytes.  ``round_state``: the bf16-state instantiation (bf16 strips)."""
    import torch
    from gnnkeras_tpu_torch.ops import strip as S

    kernel, plain = getattr(S, name), getattr(S, f"_{name}_plain")
    operands = S.diag_operands(op)
    tensors = [o for o in operands[:4] if o is not None]
    dev = op.strip.device
    n = (op.strip.shape[0] + (0 if op.blocks is None else op.blocks.shape[0])) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((d, n), generator=gen, device=dev)
    kw = {"round_state": True} if round_state else {}
    with torch.no_grad():
        got = kernel(x, *operands, **kw)
        again = kernel(x, *operands, **kw)
        want = plain(x, *operands, **kw)
    torch.cuda.synchronize()
    # f32 sums of the same few terms in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # a fixed sum order: a second launch gives the same bits
    assert torch.equal(got, again), f"{name} on {label}: two launches differ"
    res = {"phase": "kernel_check", "kernel": name + ("_bf16_state" if round_state else ""), "batch": label,
           "storage": str(op.strip.dtype).replace("torch.", ""), "slot": op.slot,
           "tiles": n // 128, "strip_tiles": int(op.strip.shape[0]),
           "block_tiles": 0 if op.blocks is None else int(op.blocks.shape[0]), "d": d,
           "max_abs_diff": float((got - want).abs().max())}
    if timed:
        mats = [t for t in (operands[0], operands[2]) if t is not None]
        nnz = sum(int(torch.count_nonzero(t)) for t in mats)
        n_bytes = sum(t.numel() * t.element_size() for t in tensors) + 2 * x.numel() * 4
        with torch.no_grad():
            res["kernel_ms"] = graph_ms([lambda: kernel(x, *operands, **kw)])
            clone = lambda o: o.clone() if isinstance(o, torch.Tensor) else o
            copies = [(x.clone(), *[clone(o) for o in operands]) for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: kernel(*o, **kw) for o in copies])
            res["cold_copies"] = len(copies)
            del copies
            res["plain_ms"] = graph_ms([lambda: plain(x, *operands, **kw)])
            # the expanded dense f32 operator (transposed for the backward), a yardstick only
            full, scale = S._full_operator(*operands[:4], operands[4])
            dense = full.float() if scale is None else full.float() * scale[:, None, :]
            if name == "strip_matmul_t":
                dense = dense.transpose(1, 2).contiguous()
            tiles = x.reshape(d, -1, 128).permute(1, 0, 2).contiguous()
            res["library_ms"] = graph_ms([lambda: torch.bmm(tiles, dense)])
            del dense, full
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 2 * d * nnz)
        res["bytes"], res["nnz"] = n_bytes, nnz
    emit(res)
    return res


def event_ms(fn, calls=5, reps=5):
    """Device time of one call of ``fn`` without a CUDA graph (for library
    calls that capture may refuse): ``calls`` calls between CUDA events,
    median over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def fma_f32(a, b, c):
    """``fmaf(a, b, c)`` on f32 tensors, rounded once: the exact product and
    sum in f64 rounded to odd, then to f32 (53 ≥ 24 + 2 bits, so the second
    rounding gives what one rounding of the exact value gives)."""
    import torch

    p, c = a.double() * b.double(), c.double()  # the product is exact
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # s + err == p + c exactly
    inf = torch.full_like(s, float("inf"))
    odd = torch.where(err > 0, torch.nextafter(s, inf), torch.nextafter(s, -inf))
    s = torch.where((err != 0) & ((s.view(torch.int64) & 1) == 0), odd, s)
    return s.float()


def qbcsr_dense_order(x, qm):
    """The forward of an int8 operator in the sum order of a walk over the
    dense blocks: per block and destination column, rows ascending, each
    ``x·m`` (m 0/1: the product is exact) added with one rounding, as
    ``fmaf(x, m, part)`` does; each block's partial joined to the column's
    accumulator by ``fmaf(part, scale, acc)``, a destination tile's blocks
    in ``row_ptr`` order."""
    import torch

    d, n_blocks = x.shape[0], qm.mask.shape[0]
    gathered = x.reshape(d, -1, 128)[:, qm.src_tile.long()]  # (d, B, rows)
    part = x.new_zeros((d, n_blocks, 128))
    for r in range(128):
        part = part + gathered[:, :, r:r + 1] * qm.mask[:, r, :].float()
    row_ptr = qm.row_ptr.long()
    runs = row_ptr[1:] - row_ptr[:-1]
    acc = x.new_zeros((d, qm.n_dst_tiles, 128))
    for k in range(int(runs.max())):
        tiles = torch.nonzero(runs > k).squeeze(1)
        blk = row_ptr[tiles] + k
        acc[:, tiles] = fma_f32(part[:, blk], qm.scale[blk][None], acc[:, tiles])
    return acc.reshape(d, -1)


def check_qbcsr(qm, label, timed, name="qbcsr_matmul", d=8):
    """Kernel row 8 (``qbcsr_matmul`` or its backward ``qbcsr_matmul_t``) on
    the quantised operator ``qm`` against its plain versions (the dense
    blocks' and the walk of the nonzero lists), at ``d`` feature rows; an
    int8 forward also bit for bit against the dense walk's sum order.
    Bound: the direction's nonzero lists, the scale and tile index read
    once, the input state read and the output written once, against
    2·d·nnz f32 FLOP (the dense-block design's bound, every block read
    once, beside it).  Library yardstick: one ``torch.sparse.mm`` with the
    operator (transposed for the forward) as a sparse f32 CSR tensor."""
    import dataclasses

    import torch
    from gnnkeras_tpu_torch.ops import bcsr as B

    forward = name == "qbcsr_matmul"
    kernel = B.qbcsr_matmul if forward else B.qbcsr_matmul_t
    n_in, n_out = (qm.n_src_tiles, qm.n_dst_tiles) if forward else (qm.n_dst_tiles, qm.n_src_tiles)
    dev = qm.mask.device
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((d, n_in * 128), generator=gen, device=dev)
    if forward:
        lists = (qm.nz_start, qm.col_start, qm.col_rows, qm.col_weights)
        index = (qm.src_tile, qm.row_ptr)
    else:
        lists = (qm.nz_start, qm.row_start, qm.row_cols, qm.row_weights)
        index = (qm.dst_tile, qm.src_order, qm.src_row_ptr)

    def dense(x_, q):
        if forward:
            return B._qbcsr_matmul_plain(x_, q.mask, q.scale, q.src_tile, q.dst_tile, q.n_dst_tiles)
        return B._qbcsr_matmul_t_plain(x_, q.mask, q.scale, q.src_tile, q.dst_tile, q.n_src_tiles)

    def plain(x_, q):
        if forward:
            return B._qbcsr_list_matmul_plain(x_, q.scale, q.col_weights, q.src_tile, q.dst_tile, q.nz_start,
                                              q.col_start, q.col_rows, q.n_dst_tiles)
        return B._qbcsr_list_matmul_t_plain(x_, q.scale, q.row_weights, q.src_tile, q.dst_tile, q.nz_start,
                                            q.row_start, q.row_cols, q.n_src_tiles)

    with torch.no_grad():
        got, want, walk = kernel(x, qm), dense(x, qm), plain(x, qm)
        again = kernel(x, qm)
    torch.cuda.synchronize()
    # f32 sums of a tile's block products in another order; a fixed order
    # and no atomics: the same bits from call to call
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, walk, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), label
    res = {"phase": "kernel_check", "kernel": name, "batch": label,
           "storage": str(qm.mask.dtype).replace("torch.", ""), "blocks": int(qm.mask.shape[0]),
           "src_tiles": qm.n_src_tiles, "dst_tiles": qm.n_dst_tiles, "d": d,
           "max_abs_diff": float((got - want).abs().max())}
    if forward and qm.scale is not None:
        with torch.no_grad():
            old_order = qbcsr_dense_order(x, qm)
        # finite inputs: the list walk skips only entries that add exactly 0
        assert torch.equal(got.view(torch.int32), old_order.view(torch.int32)), label
        res["bit_equal_to_dense_order"] = True
        del old_order
    if timed:
        nnz = int(qm.nz_start[-1])
        tensors = [t for t in (*lists, qm.scale, *index) if t is not None]
        n_bytes = sum(t.numel() * t.element_size() for t in tensors) + x.numel() * 4 + d * n_out * 128 * 4
        dense_bytes = (qm.mask.numel() * qm.mask.element_size() + (0 if qm.scale is None else qm.scale.numel() * 4)
                       + sum(t.numel() * 4 for t in index) + x.numel() * 4 + d * n_out * 128 * 4)
        with torch.no_grad():
            res["kernel_ms"] = graph_ms([lambda: kernel(x, qm)])
            copy = lambda: dataclasses.replace(qm, **{f.name: getattr(qm, f.name).clone()
                                                      for f in dataclasses.fields(qm)
                                                      if isinstance(getattr(qm, f.name), torch.Tensor)})
            copies = [(x.clone(), copy()) for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: kernel(*o) for o in copies])
            res["cold_copies"] = len(copies)
            del copies
            res["plain_ms"] = graph_ms([lambda: plain(x, qm)])
            # the operator as one sparse f32 matrix, a yardstick only
            b, r, c = torch.nonzero(qm.mask).unbind(1)
            src = qm.src_tile[b].long() * 128 + r
            dst = qm.dst_tile[b].long() * 128 + c
            vals = qm.scale[b, c] if qm.scale is not None else qm.mask[b, r, c].float()
            rows, cols, shape = (dst, src, (qm.n_dst_tiles * 128, qm.n_src_tiles * 128)) if forward else \
                (src, dst, (qm.n_src_tiles * 128, qm.n_dst_tiles * 128))
            mat = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce().to_sparse_csr()
            del b, r, c, src, dst, vals, rows, cols
            xt = x.T.contiguous()
            lib = torch.sparse.mm(mat, xt)
            torch.testing.assert_close(lib.T, want, rtol=1e-4, atol=1e-4)
            res["library_ms"] = event_ms(lambda: torch.sparse.mm(mat, xt))
            del mat, lib
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 2 * d * nnz)
        res["dense_block_bound_ms"], _ = bound(dense_bytes, 2 * d * nnz)
        res["bytes"], res["dense_block_bytes"], res["nnz"] = n_bytes, dense_bytes, nnz
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
            # the per-tile work without the iterations: staging, finding the
            # nonzeros, the state in and out
            res["kernel_ms_0_iterations"] = graph_ms([lambda: fused_unfold_t(s0, c, ws, wa, op, 0, act)])
            copies = [(s0.clone(), c.clone(), ws, wa, FusedDiagOperator(blocks=op.blocks.clone(), tile=op.tile))
                      for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: fused_unfold_t(*o, 5, act) for o in copies],
                                             calls=max(10, len(copies)))
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
            res["kernel_ms_0_iterations"] = graph_ms([lambda: fused_unfold(s0, c, ws, wa, op, 0, act)])
            copies = [(s0.clone(), c.clone(), ws, wa, FusedDiagOperator(blocks=op.blocks.clone(), tile=op.tile))
                      for _ in range(cold_copies(n_bytes))]
            res["kernel_cold_ms"] = graph_ms([lambda o=o: fused_unfold(*o, 5, act) for o in copies],
                                             calls=max(10, len(copies)))
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
        torch.save([(b, model.served_output(model.forward(b)[2])) for b in batches], os.path.join(path, "inputs.pt"))
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


def storage_of(batch):
    """The aggregation operator's storage: the strip's dtype, else the
    block operator's kind."""
    if batch.strip is not None:
        return str(batch.strip.strip.dtype)
    return type(batch.bcsr).__name__


def train_phase(label, make_model, b_gpu, b_cpu, card, per_step, out_rows=None, n_arcs=None,
                loss_fn="categorical_crossentropy", phase="training", grad_atol_rel=1e-6, compile_kw=None,
                fit_steps=10, expect_k=5.0, control=None, widths=None):
    """One Adam step of ``make_model(device)`` (compiled with ``loss_fn`` and
    ``compile_kw``) on the card against the same step on the CPU: loss, k
    (an LGNN's: one per layer; each ``expect_k`` unless None), gradients
    (rtol 1e-4, atol ``grad_atol_rel`` of each leaf's largest |g|), moving
    statistics and updated parameters, and the step's launches
    (``per_step``).  With ``out_rows`` (the rows ``predict`` returns), then
    ``fit_steps`` steps through ``fit``, ``evaluate``, ``predict`` and 7
    timed steps (Σk transitions of every arc a step).  With
    ``control`` (a context manager that plants a fault), the same step of a
    fresh card model under it must fail the gradient check.  ``widths``: a
    ``strip_widths`` entered around the checked step only.  Returns the
    launches of one step."""
    import contextlib

    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.training.trainer import train_step

    model, model_cpu = make_model("cuda"), make_model("cpu")
    for m in (model, model_cpu):
        m.compile(optimizer="adam:0.01", loss=loss_fn, metrics=["accuracy"], **(compile_kw or {}))
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    with widths or contextlib.nullcontext():
        logs, aux = train_step(model, b_gpu, model.next_rng())
        torch.cuda.synchronize()
    launches = expect_launches(**per_step)
    logs_cpu, aux_cpu = train_step(model_cpu, b_cpu, model_cpu.next_rng())

    # one step of f32 sums in other orders over ~139k nodes: the loss, the
    # statistics and the gradients agree to rtol 1e-4; entries of a gradient
    # below ``grad_atol_rel`` of its largest are held to that share of it
    loss, loss_cpu = float(logs["loss_sum"] / logs["count"]), float(logs_cpu["loss_sum"] / logs_cpu["count"])
    ks, ks_cpu = as_layers(aux["k"], float), as_layers(aux_cpu["k"], float)
    assert ks == ks_cpu and (expect_k is None or set(ks) == {expect_k}), (ks, ks_cpu)
    k = ks[0] if len(ks) == 1 else ks
    np.testing.assert_allclose(loss, loss_cpu, rtol=1e-5)
    params_cpu = dict(model_cpu.named_parameters())

    def grad_share(m):
        """The largest |g - g_cpu| / (1e-4 |g_cpu| + grad_atol_rel · the
        leaf's largest |g_cpu|) over ``m``'s gradients: at most 1 passes."""
        shares = {}
        for n, p in m.named_parameters():
            grad, grad_cpu = p.grad.cpu().numpy(), params_cpu[n].grad.numpy()
            tol = 1e-4 * np.abs(grad_cpu) + grad_atol_rel * float(np.abs(grad_cpu).max())
            shares[n] = float((np.abs(grad - grad_cpu) / np.maximum(tol, 1e-45)).max())
        return max(shares.values())

    excluded, worst = 0, {}
    for n, p in model.named_parameters():
        grad, grad_cpu = p.grad.cpu().numpy(), params_cpu[n].grad.numpy()
        gmax = float(np.abs(grad_cpu).max())
        np.testing.assert_allclose(grad, grad_cpu, rtol=1e-4, atol=grad_atol_rel * gmax, err_msg=n)
        worst[n] = float(np.abs(grad - grad_cpu).max() / max(gmax, 1e-30))
        # Adam's first step is lr·g/(|g| + eps) (lr 0.01, eps 1e-7), whose
        # slope in g is lr·eps/(|g| + eps)²: compare the updated parameters
        # where the gradient error the check above allows (a sign flip
        # included) moves the step by less than the parameters' atol
        g_abs = np.abs(grad_cpu)
        g_err = 1e-4 * g_abs + grad_atol_rel * gmax
        live = 0.01 * 1e-7 * g_err / (np.maximum(g_abs - g_err, 0.0) + 1e-7) ** 2 < 1e-6
        excluded += int((~live).sum())
        np.testing.assert_allclose(p.detach().cpu().numpy()[live], params_cpu[n].detach().numpy()[live],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert not np.array_equal(p.detach().cpu().numpy(), before[n].numpy()), n
    buffers_cpu = dict(model_cpu.named_buffers())
    for n, b in model.named_buffers():
        np.testing.assert_allclose(b.cpu().numpy(), buffers_cpu[n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    res = {"phase": phase, "batch": label, "storage": storage_of(b_gpu), "k": k, "loss_fn": loss_fn,
           "first_step_loss": loss, "first_step_loss_cpu": loss_cpu, "launches_per_step": launches,
           "grad_max_rel_diff": worst, "grad_atol_rel": grad_atol_rel, "grad_max_tolerance_share": grad_share(model),
           "adam_entries_excluded": excluded, "card": card}
    if control is not None:
        bad = make_model("cuda")
        bad.compile(optimizer="adam:0.01", loss=loss_fn, metrics=["accuracy"], **(compile_kw or {}))
        with control():
            train_step(bad, b_gpu, bad.next_rng())
        res["control_grad_max_tolerance_share"] = grad_share(bad)
        assert res["control_grad_max_tolerance_share"] > 1.0, res["control_grad_max_tolerance_share"]

    if out_rows is not None:
        # the user's entry points: more steps through fit, then evaluate and predict
        kernels.reset_launches()
        history = model.fit(_Repeat(b_gpu, 1), epochs=fit_steps, verbose=0)
        torch.cuda.synchronize()
        res["fit_launches"] = expect_launches(**{name: fit_steps * n for name, n in per_step.items()})
        losses = history["loss"]
        assert len(losses) == fit_steps and np.isfinite(losses).all(), losses
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
                    "train_transition_edges_per_s": sum(ks) * n_arcs / dt, "arcs": n_arcs})
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
    select held bit for bit to both its plain versions (the arc-major copy
    and the pairs' one) and to ``state[arc_src]`` / ``state[arc_dst]``, the
    scatter at f32 tolerance."""
    import dataclasses

    import torch
    from gnnkeras_tpu_torch.ops import incidence as I

    dev = inc.device
    n, a = inc.n_node_tiles * 128, len(arc_src)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = torch.randn((n, d), generator=gen, device=dev)
    state[0, 0] = -0.0
    state[1, -1] = 1e-40  # a subnormal
    ct_src = torch.randn((a, d), generator=gen, device=dev)
    ct_dst = torch.randn((a, d), generator=gen, device=dev)
    with torch.no_grad():
        got_sel = I.incidence_select(state, inc)
        rows_sel = I._incidence_select_rows(state, inc.arc_ends, inc.n_arc_tiles)
        pairs_sel = I._incidence_select_plain(state, inc)
        got_sc, want_sc = I.incidence_scatter(ct_src, ct_dst, inc), I._incidence_scatter_walk(ct_src, ct_dst, inc)
        again_sc, pairs_sc = I.incidence_scatter(ct_src, ct_dst, inc), I._incidence_scatter_plain(ct_src, ct_dst, inc)
    torch.cuda.synchronize()
    # the select is a copy: bit for bit, rows past the arcs zero
    src_t, dst_t = torch.as_tensor(arc_src, device=dev).long(), torch.as_tensor(arc_dst, device=dev).long()
    bits = lambda t: t.view(torch.int32)
    for got, rows, pairs, ends in zip(got_sel, rows_sel, pairs_sel, (src_t, dst_t)):
        assert torch.equal(bits(got), bits(rows)) and torch.equal(bits(got), bits(pairs)), label
        assert torch.equal(bits(got[:a]), bits(state[ends])) and not got[a:].any(), label
    # the scatter: f32 sums of a node's few incident cotangents in another
    # order than its plain walk and than the pairs' one-hot products; the
    # same bits from call to call
    torch.testing.assert_close(got_sc, want_sc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_sc, pairs_sc, rtol=1e-5, atol=1e-5)
    assert torch.equal(got_sc.view(torch.int32), again_sc.view(torch.int32)), label
    common = {"phase": "kernel_check", "batch": label, "d": d, "pairs": inc.n_pairs, "live_pairs": inc.n_live,
              "arc_tiles": inc.n_arc_tiles, "node_tiles": inc.n_node_tiles}
    sel = {**common, "kernel": "incidence_select", "max_abs_diff": 0.0}
    sc = {**common, "kernel": "incidence_scatter", "max_abs_diff": float((got_sc - want_sc).abs().max())}
    if timed:
        a_pad = inc.n_arc_tiles * 128
        # the select reads the state and the arc-major index, not the pairs
        sel_bytes = n * d * 4 + inc.arc_ends.numel() * 4 + 2 * a_pad * d * 4
        # the scatter reads the cotangents and the node index, not the pairs
        sc_bytes = 2 * a * d * 4 + (inc.node_start.numel() + inc.node_entry.numel()) * 4 + n * d * 4

        def copy_index():
            return dataclasses.replace(inc, arc_ends=inc.arc_ends.clone(), node_start=inc.node_start.clone(),
                                       node_entry=inc.node_entry.clone())

        with torch.no_grad():
            sel["kernel_ms"] = graph_ms([lambda: I.incidence_select(state, inc)])
            copies = [(state.clone(), copy_index()) for _ in range(cold_copies(sel_bytes))]
            sel["kernel_cold_ms"] = graph_ms([lambda o=o: I.incidence_select(*o) for o in copies])
            sel["cold_copies"] = len(copies)
            sel["plain_ms"] = graph_ms([lambda: I._incidence_select_rows(state, inc.arc_ends, inc.n_arc_tiles)])
            # two gathers, a yardstick only
            sel["library_ms"] = graph_ms([lambda: (torch.index_select(state, 0, src_t),
                                                   torch.index_select(state, 0, dst_t))])
            sc["kernel_ms"] = graph_ms([lambda: I.incidence_scatter(ct_src, ct_dst, inc)])
            copies = [(ct_src.clone(), ct_dst.clone(), c) for _, c in copies]
            sc["kernel_cold_ms"] = graph_ms([lambda o=o: I.incidence_scatter(*o) for o in copies])
            sc["cold_copies"] = len(copies)
            del copies
            sc["plain_ms"] = graph_ms([lambda: I._incidence_scatter_walk(ct_src, ct_dst, inc)])
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
    route.  Returns the launches of the requests and the card's Predictor."""
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
    return serve_launches, p


def served_kernel_checks(model, p, sample):
    """Rows 2 and 4 at the shape a served request launches: the 64-molecule
    request tile-packed into the Predictor's template (``p.max_nodes`` nodes,
    as ``Predictor._predict_fused`` packs it), checked against the plain
    versions and timed warm and cold beside the bound; the tile count is the
    lines' ``tiles``."""
    import torch
    from gnnkeras_tpu_torch import GraphObject, from_graph_object

    merged = GraphObject.merge(list(sample), focus=p.focus, aggregation_mode=p.aggregation_mode)
    batch = from_graph_object(merged, pad_nodes=p.max_nodes, pad_arcs=p.max_arcs, pad_graphs=None, tile_pack=True,
                              compact_gmax=p.max_graphs, compact_nspan=p.max_nodes // 128 + 1, device="cuda")
    assert batch.num_nodes == p.max_nodes
    check_fused(model, batch, "served_template", timed=True)
    for dtype in (torch.bfloat16, torch.float32):
        check_fused_rm(model, batch, "served_template", dtype, timed=True)


def forward_phase(label, model, model_cpu, b_gpu, b_cpu, n_arcs, out_rows, card, per_forward, phase="forward",
                  state_atol=1e-6):
    """The eval forward on the card against the CPU, its launches
    (``per_forward``), its ``out_rows`` output rows (graphs or arcs) and its
    host time (median of 7, synchronised); states held to rtol 1e-5 and
    ``state_atol``."""
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
    np.testing.assert_allclose(state.cpu().numpy(), state_cpu.numpy(), rtol=1e-5, atol=state_atol)
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward(b_gpu, training=False)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    emit({"phase": phase, "model": model.name, "batch": label, "storage": storage_of(b_gpu), "k": k,
          "launches": launches, "output_rows": int(m.sum()), "forward_ms": dt * 1e3,
          "transition_edges_per_s": 5 * n_arcs / dt, "arcs": n_arcs, "card": card})
    return launches


def large_graph_route(label, g, batch, ref_bcsr, card, per_forward, per_step):
    """The large graph through one operator route (``batch``, on the card):
    the eval forward against the plain f32 BCSR route of the same graph on
    the card (``ref_bcsr``, with the route's own weights): k equal, states
    and outputs within f32 tolerance (int8 mask times f32 scale is the exact
    weight; bf16 blocks hold the weights rounded to bf16), its launches
    (``per_forward``) and host time (median of 7, synchronised); then one
    Adam step against the same step on the CPU, ``fit``, ``evaluate``,
    ``predict`` and timed steps (``train_phase``, mse on the graph's normal
    targets).  Returns (forward launches, step launches)."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data.synthetic import large_graph_gnn

    model = large_graph_gnn("cuda", seed=0)
    n_nodes, n_arcs = int(g.nodes.shape[0]), int(g.arcs.shape[0])
    kernels.reset_launches()
    k, state, out, mask, _ = model.forward(batch, training=False)
    torch.cuda.synchronize()
    assert k == 5, k
    launches = expect_launches(**per_forward)
    k_ref, state_ref, out_ref, mask_ref, _ = model.forward(batch.replace(bcsr=ref_bcsr), training=False)
    assert k_ref == k and torch.equal(mask, mask_ref)
    o, o_ref = out[mask], out_ref[mask]
    assert torch.isfinite(o).all() and o.shape == (n_nodes, 2)
    # the same f32 weights, sums of a node's ~8 neighbours in another order,
    # over 5 iterations of states of magnitude ~1-4
    torch.testing.assert_close(state, state_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-6)
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward(batch, training=False)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    emit({"phase": "large_graph", "route": label, "operator": type(batch.bcsr).__name__, "k": k,
          "launches": launches, "nodes": n_nodes, "arcs": n_arcs, "forward_ms": dt * 1e3,
          "forward_ms_all": [t * 1e3 for t in ts], "transition_edges_per_s": 5 * n_arcs / dt,
          "state_max_abs_diff_vs_f32_bcsr": float((state - state_ref).abs().max()),
          "out_max_abs_diff_vs_f32_bcsr": float((o - o_ref).abs().max()), "card": card})
    del model, state, out, state_ref, out_ref
    # a bias gradient here is a sum of 500,000 per-node terms of both signs:
    # f32 sums of them in another order differ by up to 1.9e-5 of the leaf's
    # largest |g| (NVIDIA H100 80GB HBM3, 700 W), so small entries are held
    # to 1e-4 of it
    step = train_phase(label, lambda dev: large_graph_gnn(dev, seed=0), batch, batch.to("cpu"), card, per_step,
                       out_rows=n_nodes, n_arcs=n_arcs, loss_fn="mse", phase="large_graph_training",
                       grad_atol_rel=1e-4)
    return launches, step


def with_parallel_arcs(g):
    """``g`` with a second arc beside every 16th one, under a fresh label
    draw: parallel arcs, whose summed weights do not factor into an int8
    mask times a per-column scale."""
    from gnnkeras_tpu_torch import GraphObject

    extra = g.arcs[::16].copy()
    extra[:, 2:] = np.random.default_rng(1).normal(size=(len(extra), g.arcs.shape[1] - 2))
    arcs = np.concatenate([g.arcs, extra])
    arcs = arcs[np.lexsort(arcs.T[::-1])]  # the canonical row order, as GraphObject sorts
    return GraphObject(nodes=g.nodes, arcs=arcs, targets=g.targets, focus=g.focus,
                       aggregation_mode=g.aggregation_mode, arcs_canonical=True)


def large_graph_section(card):
    """Phase 14: the single large graph (``large_banded_graph``, band 64 and
    band 384, and the band-384 graph with parallel arcs) on the card: host
    build, kernel checks of the banded diagonal and of row 8, and the three
    operator routes (``large_graph_route``).  Returns what the kernels line
    reads."""
    import dataclasses

    import torch
    from gnnkeras_tpu_torch import from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import large_banded_graph
    from gnnkeras_tpu_torch.ops.banded import BandedOperator
    from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr, build_bcsr, quantize_bcsr

    t0 = time.perf_counter()
    g64 = large_banded_graph()  # band 64: the banded decomposition
    b64 = from_graph_object(g64, agg_dtype="auto", device="cuda")
    torch.cuda.synchronize()
    build64_s = time.perf_counter() - t0
    assert isinstance(b64.bcsr, BandedOperator) and b64.bcsr.offsets == (-1, 0, 1), b64.bcsr.offsets
    assert all(d.scale is not None for d in b64.bcsr.diags)
    t0 = time.perf_counter()
    g384 = large_banded_graph(band=384)  # 7 tile offsets: quantised BCSR
    b384 = from_graph_object(g384, agg_dtype="int8", device="cuda")
    torch.cuda.synchronize()
    build384_s = time.perf_counter() - t0
    assert isinstance(b384.bcsr, QuantBcsr) and b384.bcsr.scale is not None
    # parallel arcs: int8 does not factor, so agg_dtype='int8' stores bf16 blocks
    t0 = time.perf_counter()
    g384p = with_parallel_arcs(g384)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        b384p = from_graph_object(g384p, agg_dtype="int8", device="cuda")
    torch.cuda.synchronize()
    build384p_s = time.perf_counter() - t0
    assert isinstance(b384p.bcsr, QuantBcsr) and b384p.bcsr.scale is None
    assert b384p.bcsr.mask.dtype == torch.bfloat16 and any("bfloat16" in str(w.message) for w in caught)
    # the plain f32 BCSR operators of the graphs (the reference routes; for
    # the bf16 blocks, their weights rounded to bf16) and the quantised
    # operators of the kernel checks
    refs, quants = {}, {}
    for lbl, g, b in (("band64", g64, b64), ("band384", g384, b384), ("band384_parallel", g384p, b384p)):
        arcs = g.arcs
        m = build_bcsr(arcs[:, 0].astype(np.int64), arcs[:, 1].astype(np.int64), g.arcnode_weight, b.num_nodes)
        if lbl == "band384_parallel":
            m = dataclasses.replace(m, blocks=m.blocks.to(torch.bfloat16).float())
        refs[lbl] = m.to("cuda")
        if lbl == "band64":
            quants[(lbl, "int8")] = quantize_bcsr(m, "int8", device="cuda")
            quants[(lbl, "bfloat16")] = quantize_bcsr(m, "bfloat16", device="cuda")
        else:
            quants[("band384", str(b.bcsr.mask.dtype).replace("torch.", ""))] = b.bcsr
        del m
    bop = b64.bcsr
    emit({"phase": "large_graph_build", "host_build_s": build64_s, "host_build_band384_s": build384_s,
          "host_build_band384_parallel_s": build384p_s,
          "nodes": int(g64.nodes.shape[0]), "arcs": int(g64.arcs.shape[0]), "arcs_band384": int(g384.arcs.shape[0]),
          "arcs_band384_parallel": int(g384p.arcs.shape[0]),
          "padded_nodes": b64.num_nodes, "tiles": b64.num_nodes // 128, "offsets": list(bop.offsets),
          "residual_blocks": 0 if bop.residual is None else int(bop.residual.blocks.shape[0]),
          "f32_bcsr_blocks": {k: int(v.blocks.shape[0]) for k, v in refs.items()},
          "quantised_blocks": {f"{k[0]}_{k[1]}": int(v.mask.shape[0]) for k, v in quants.items()}})
    out = {"graph": g64, "batch": b64}
    diag0 = bop.diags[bop.offsets.index(0)]
    out["banded_strip"] = check_strip(diag0, "band64_diagonal_0", timed=True, d=8)
    out["banded_strip_t"] = check_strip(diag0, "band64_diagonal_0", timed=True, name="strip_matmul_t", d=8)
    out["qbcsr"] = {}
    for (lbl, storage), qm in quants.items():
        label = f"{lbl}_{storage}" if lbl == "band64" or storage == "int8" else "band384_parallel_arcs_bfloat16"
        for name in ("qbcsr_matmul", "qbcsr_matmul_t"):
            out["qbcsr"][(lbl, storage, name)] = check_qbcsr(qm, label, timed=True, name=name)
    del quants
    nd = len(bop.diags)
    out["banded_fwd"], out["banded_step"] = large_graph_route(
        "banded_auto", g64, b64, refs["band64"], card, dict(strip_matmul=4 * nd),
        dict(strip_matmul=4 * nd, strip_matmul_t=4 * nd))
    out["quant_fwd"], out["quant_step"] = large_graph_route(
        "quantised_int8", g384, b384, refs["band384"], card, dict(qbcsr_matmul=4),
        dict(qbcsr_matmul=4, qbcsr_matmul_t=4))
    out["quant_bf16_fwd"], out["quant_bf16_step"] = large_graph_route(
        "quantised_int8_fell_back_to_bf16", g384p, b384p, refs["band384_parallel"], card, dict(qbcsr_matmul=4),
        dict(qbcsr_matmul=4, qbcsr_matmul_t=4))
    return out


def mixed_strip_section(card, model, model_cpu, bench, bench_u):
    """Phase 15: slot-32/64 strips on the card: kernel checks on the
    straddling batch (both regions) and on the bench batch (slot-pure), the
    flagship's forward and one Adam step on each straddling batch, and its
    forward on the bench batch at slot 32.  Returns what the kernels line
    reads."""
    from gnnkeras_tpu_torch import GraphObject, from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import BENCH_GRAPHS, flagship_gnn, random_molecules

    t0 = time.perf_counter()
    # as many molecules as the bench batch, of 5-79 nodes drawn uniformly:
    # about 63% above slot 32 and 20% above slot 64, so both regions hold
    # tiles at either slot; without parallel arcs, so int8 storage factors
    straddle = without_parallel_arcs(GraphObject.merge(random_molecules(BENCH_GRAPHS, seed=8, min_nodes=5, max_nodes=80),
                                                       "g", "average"))
    mixed = {}
    for slot in (32, 64):
        for storage in ("int8", "bfloat16"):
            cpu_b = from_graph_object(straddle, slot_pack=slot, strip_dtype=storage, device="cpu")
            mixed[(slot, storage)] = (cpu_b, cpu_b.to("cuda"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16, as in JAX
        pure_cpu = {slot: from_graph_object(bench, slot_pack=slot, strip_dtype="int8", device="cpu") for slot in (32, 64)}
    pure = {slot: b.to("cuda") for slot, b in pure_cpu.items()}
    pure_int8 = {slot: from_graph_object(bench_u, slot_pack=slot, strip_dtype="int8", device="cuda")
                 for slot in (32, 64)}
    emit({"phase": "mixed_strip_batches", "host_build_s": time.perf_counter() - t0,
          "graphs": int(straddle.num_graphs), "nodes": int(straddle.nodes.shape[0]), "arcs": int(straddle.arcs.shape[0]),
          "layouts": {f"slot{slot}": {"padded_nodes": b.num_nodes, "strip_tiles": int(b.strip.strip.shape[0]),
                                      "block_tiles": int(b.strip.blocks.shape[0]),
                                      "residual_blocks": 0 if b.strip.residual is None else
                                      int(b.strip.residual.blocks.shape[0])}
                      for (slot, storage), (_, b) in mixed.items() if storage == "int8"},
          "bench_slot_pure": {f"slot{slot}": {"strip_tiles": int(b.strip.strip.shape[0]),
                                              "block_tiles": int(b.strip.blocks.shape[0]),
                                              "storage": str(b.strip.strip.dtype)} for slot, b in pure.items()}})
    out = {"checks": {}, "fwd": {}, "step": {}}
    for (slot, storage), (_, b) in mixed.items():
        assert b.strip.strip.shape[0] > 0 and b.strip.blocks.shape[0] > 0
        for name in ("strip_matmul", "strip_matmul_t"):
            out["checks"][(slot, storage, name)] = check_strip(b.strip, f"straddling_slot{slot}", timed=True,
                                                               name=name)
    for slot in (32, 64):
        for b, lbl in ((pure[slot], "bench"), (pure_int8[slot], "bench_without_parallel_arcs")):
            assert b.strip.blocks.shape[0] == 0  # ~30-node molecules: every tile slot-pure
            for name in ("strip_matmul", "strip_matmul_t"):
                out["checks"][(slot, lbl, name)] = check_strip(b.strip, f"{lbl}_slot{slot}", timed=lbl == "bench",
                                                               name=name)
    n_arcs = int(straddle.arcs.shape[0])
    # Molecules of up to 79 nodes: over 5 iterations the card's states have
    # parted from the CPU's by up to 1.24e-6, and a BatchNorm gamma gradient
    # by 1.5e-5 of its leaf's largest |g|, on such a batch (slot 64, bf16;
    # NVIDIA H100 80GB HBM3, 700 W), so states are held to 5e-6 and gradient
    # entries below 1e-4 of their leaf's largest |g| to 1e-4 of it.
    for (slot, storage), (b_cpu, b_dev) in mixed.items():
        lbl = f"straddling_slot{slot}_{storage}"
        out["fwd"][(slot, storage)] = forward_phase(lbl, model, model_cpu, b_dev, b_cpu, n_arcs, straddle.num_graphs,
                                                    card, dict(strip_matmul=4), phase="mixed_strip",
                                                    state_atol=5e-6)["strip_matmul"]
        out["step"][(slot, storage)] = train_phase(lbl, lambda dev: flagship_gnn(dev, seed=0), b_dev, b_cpu, card,
                                                   dict(strip_matmul=4, strip_matmul_t=4), phase="mixed_strip",
                                                   grad_atol_rel=1e-4)["strip_matmul_t"]
    out["pure_fwd"] = forward_phase("bench_slot32", model, model_cpu, pure[32], pure_cpu[32],
                                    int(bench.arcs.shape[0]), bench.num_graphs, card, dict(strip_matmul=4),
                                    phase="mixed_strip")["strip_matmul"]
    return out


def strip_scripts_section(card):
    """Phase 16: kernel rows 10-12, the experiment scripts' compact-strip
    products, through their port (``tools/bench_strip_compact.py``:
    ``strip_aggregate``, ``blocked_aggregate``; ``tools/bench_strip64.py``:
    ``strip64_aggregate``, ``packed_aggregate``) at bench scale (the slot-32
    and slot-64 packings of the synthetic bench batch), f32 and bf16 strips:
    each against the dense ``np.add.at`` aggregation (row 12 with its BCSR
    residual) and the kernel against its plain version (``check_strip``,
    with the bf16-state instantiation for bf16 strips).  Row 12 also times
    the two transposes around the kernel.  Returns what the kernels line
    reads."""
    import torch
    import torch.nn.functional as F
    from gnnkeras_tpu_torch import GraphObject, kernels
    from gnnkeras_tpu_torch.data.synthetic import BENCH_GRAPHS, random_molecules
    from gnnkeras_tpu_torch.ops.bcsr import bcsr_aggregate
    from gnnkeras_tpu_torch.ops.strip import StripOperator
    from gnnkeras_tpu_torch.tools import bench_strip64 as t64
    from gnnkeras_tpu_torch.tools import bench_strip_compact as tc

    t0 = time.perf_counter()
    strip32, n32, src32, dst32, w32, in32 = tc.build()
    strip64, residual, n64, src64, dst64, w64, in64 = t64.build()
    # molecules of 5-79 nodes: those of 65-79 own a tile, their cross-slot
    # arcs go to the BCSR residual (the bench batch's ~30-node graphs leave none)
    straddle = GraphObject.merge(random_molecules(BENCH_GRAPHS, seed=8, min_nodes=5, max_nodes=80), "g", "average")
    s_strip, s_residual, s_n, s_src, s_dst, s_w, s_in = t64.build(merged=straddle)
    assert residual is None and s_residual is not None
    rng = np.random.default_rng(0)
    state_t = rng.standard_normal((tc.D_SUB, n32)).astype(np.float32)
    state_t[tc.D:] = 0.0
    state = rng.standard_normal((n64, tc.D)).astype(np.float32)
    ref32 = tc.dense_reference(state_t, src32, dst32, w32, in32)
    ref64 = t64.dense_reference(state, src64, dst64, w64)
    emit({"phase": "strip_scripts_build", "host_build_s": time.perf_counter() - t0,
          "data": "synthetic bench_graph (Mutagenicity is not in the repository)",
          "slot32": {"tiles": n32 // 128, "in_slot": float(in32.mean())},
          "slot64": {"tiles": n64 // 128, "in_slot": float(in64.mean())},
          "slot64_straddling": {"tiles": s_n // 128, "in_slot": float(s_in.mean()),
                                "residual_blocks": int(s_residual.blocks.shape[0])}})
    x32, x64 = torch.from_numpy(state_t).cuda(), torch.from_numpy(state).cuda()
    s_state = rng.standard_normal((s_n, tc.D)).astype(np.float32)
    s_ref = t64.dense_reference(s_state, s_src, s_dst, s_w)
    s_x, s_res = torch.from_numpy(s_state).cuda(), s_residual.to("cuda")
    k0 = 8  # the blocked scripts' check pads the tiles to a multiple of K = 8
    t_pad = -(-strip32.shape[0] // k0) * k0
    out = {"checks": {}, "launches": {}}
    for storage in (torch.float32, torch.bfloat16):
        st = str(storage).replace("torch.", "")
        sp32, sp64 = torch.from_numpy(strip32).to(storage).cuda(), torch.from_numpy(strip64).to(storage).cuda()
        sp32_k = F.pad(sp32, (0, 0, 0, 0, 0, t_pad - sp32.shape[0]))
        x32_k = F.pad(x32, (0, (t_pad - sp32.shape[0]) * 128))
        packed = F.pad(x64, (0, tc.D_SUB - tc.D)).reshape(-1, 128)
        # the main path: the tools' four functions, each with its launches
        # counted from 0 (the residual's BCSR product launches nothing)
        suffix = "_bf16_state" if storage == torch.bfloat16 else ""
        calls = {"strip_aggregate": ("strip_matmul", lambda: tc.strip_aggregate(x32, sp32)),
                 "blocked_aggregate": ("strip_matmul", lambda: tc.blocked_aggregate(x32_k, sp32_k, k0)[:, :n32]),
                 "strip64_aggregate": ("strip_matmul_t", lambda: t64.strip64_aggregate(x64, sp64, 1)),
                 "packed_aggregate": ("strip_matmul_t", lambda: t64.packed_aggregate(
                     packed, sp64, 1, tc.D_SUB).reshape(-1, tc.D_SUB)[:, :tc.D])}
        got, out["launches"][st] = {}, {}
        for fn_name, (kern, fn) in calls.items():
            kernels.reset_launches()
            got[fn_name] = fn()
            torch.cuda.synchronize()
            out["launches"][st][fn_name] = expect_launches(**{kern + suffix: 1})[kern + suffix]
        got11, got10, got12, got12p = (got[k] for k in calls)
        got12r = t64.strip64_aggregate(s_x, torch.from_numpy(s_strip).to(storage).cuda(), 1)
        got12r = got12r + bcsr_aggregate(s_x, s_res)
        torch.cuda.synchronize()
        torch.testing.assert_close(got10, got11, rtol=0, atol=0)
        torch.testing.assert_close(got12p, got12, rtol=0, atol=0)
        # against the dense aggregation: f32 sums in another order; with bf16
        # strips the state and the weights are rounded to bf16 (relative
        # error 2^-9 each), so there within 2^-7 of the largest |aggregate|
        errs = {"row11": float(np.abs(got11.cpu().numpy() - ref32).max()),
                "row12": float(np.abs(got12.cpu().numpy() - ref64).max()),
                "row12_straddling_plus_residual": float(np.abs(got12r.cpu().numpy() - s_ref).max())}
        bound_abs = 1e-5 if storage == torch.float32 else 2.0**-7 * float(max(np.abs(r).max() for r in (ref32, ref64, s_ref)))
        assert max(errs.values()) <= bound_abs, (st, errs, bound_abs)
        rs = storage == torch.bfloat16
        out["checks"][("row11", st)] = check_strip(StripOperator(strip=sp32, residual=None, scale=None, slot=32),
                                                   "bench_slot32_script", timed=True, d=tc.D_SUB, round_state=rs)
        op64 = StripOperator(strip=sp64, residual=None, scale=None, slot=64)
        out["checks"][("row12", st)] = check_strip(op64, "bench_slot64_script", timed=True, name="strip_matmul_t",
                                                   d=tc.D_SUB, round_state=rs)
        x_t = F.pad(x64.T, (0, 0, 0, tc.D_SUB - tc.D)).contiguous()
        y_t = torch.empty_like(x_t)
        transposes = {"transpose_in_ms": graph_ms([lambda: F.pad(x64.T, (0, 0, 0, tc.D_SUB - tc.D)).contiguous()]),
                      "transpose_out_ms": graph_ms([lambda: y_t[:tc.D].T.contiguous()]),
                      "strip64_aggregate_ms": graph_ms([lambda: t64.strip64_aggregate(x64, sp64, 1)])}
        emit({"phase": "strip_scripts", "strip": st, "max_abs_err_vs_dense": errs, "bound_vs_dense": bound_abs,
              "launches": out["launches"][st], "row12": transposes, "card": card})
        out["checks"][("row12", st)].update(transposes)
        del x_t, y_t
    return out


PARTS = 4  # ranks of the partitioned engine, all on the one card


class bf16_aggregation:
    """A control's fault: within it, every feature-major aggregation
    (``models.gnn.aggregate_t``, which the GNNs and the composite GNNs
    call) reads the state rounded to bf16, as a one-pass bf16 product
    would.  A check that admits this fault is too wide to see a kernel
    that loses f32 accuracy."""

    def __enter__(self):
        import torch
        import gnnkeras_tpu_torch.models.composite as CM
        import gnnkeras_tpu_torch.models.gnn as G

        self._modules, self._real = (G, CM), G.aggregate_t
        real = self._real

        def rounded(state_t, batch, sd):
            return real(state_t.to(torch.bfloat16).to(state_t.dtype), batch, sd)

        for module in self._modules:
            module.aggregate_t = rounded
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.aggregate_t = self._real
        return False


class host_initial_state:
    """Within it, a dim_state > 0 model's random initial states are drawn on
    the host, from a CPU generator seeded as the generator the forward was
    given (one stream a generator: an LGNN's layers draw in turn), then
    moved to its device.  So the card and the CPU draw the same states for
    the same seeds, as phase 9's one host draw gives them."""

    def __enter__(self):
        import torch
        import gnnkeras_tpu_torch.models.gnn as G

        self._gnn, self._real = G, G.initial_state
        streams = {}

        def draw(n, ds, generator, device):
            # the generator is kept in the map, so its id stays its own
            if id(generator) not in streams:
                streams[id(generator)] = (generator, torch.Generator().manual_seed(generator.initial_seed()))
            return self._real(n, ds, streams[id(generator)][1], "cpu").to(device)

        G.initial_state = draw
        return self

    def __exit__(self, *exc):
        self._gnn.initial_state = self._real
        return False


class strip_widths:
    """Within it, the strip kernels' launches are also tallied by their
    feature rows, ``tally[(name, d)]``, read off the wrapper's arguments
    (``kernels.LAUNCHES`` stays the wrappers' own count)."""

    def __enter__(self):
        from gnnkeras_tpu_torch import kernels
        from gnnkeras_tpu_torch.ops import strip as S

        self._strip, self._real = S, S._launch_or_plain
        self.tally = getattr(self, "tally", {})

        def counted(name, x, *args, **kwargs):
            before = kernels.LAUNCHES[name]
            out = self._real(name, x, *args, **kwargs)
            if kernels.LAUNCHES[name] != before:
                key = (name, int(x.shape[0]))
                self.tally[key] = self.tally.get(key, 0) + 1
            return out

        S._launch_or_plain = counted
        return self

    def __exit__(self, *exc):
        self._strip._launch_or_plain = self._real
        return False


def family_forward(label, model, model_cpu, b_gpu, b_cpu, card, expect, n_arcs, seed=0, deep_tol=(1e-5, 1e-6),
                   control=None, widths=None):
    """The eval forward of a composite GNN or an LGNN on the card against
    the same forward on the CPU (initial states through
    ``host_initial_state``): per-layer k equal, the launches
    ``expect(ks)``, every output and layer 0's state at phase 4's tolerance
    (rtol 1e-5, atol 1e-6), the states of layers ≥ 1 at ``deep_tol``
    (rtol, atol); the host time (median of 7, synchronised).  The measured
    worst differences, and each check's share of its tolerance, are emitted
    before they are checked.  ``widths``: a ``strip_widths`` entered around
    the checked run only.  ``control`` (with ``deep_tol`` wider than phase
    4's): the forward under this context manager must fail the check of
    the states of layers ≥ 1 at ``deep_tol``, the widened check itself."""
    import contextlib

    import torch
    from gnnkeras_tpu_torch import kernels

    def run(m, b, dev):
        return m.forward(b, training=False, generator=torch.Generator(device=dev).manual_seed(seed))

    kernels.reset_launches()
    with widths or contextlib.nullcontext():
        ks, states, outs, mask, _ = run(model, b_gpu, "cuda")
        torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    ks = as_layers(ks, int)
    ks_cpu, states_cpu, outs_cpu, mask_cpu, _ = run(model_cpu, b_cpu, "cpu")
    m, real = mask.cpu().numpy(), b_cpu.node_mask.numpy()
    phase4 = (1e-5, 1e-6)

    def checks(states, outs):
        """(name, card, cpu, (rtol, atol)) of every compared array."""
        found = [(f"state layer {i}", s.cpu().numpy()[real], c.numpy()[real], phase4 if i == 0 else deep_tol)
                 for i, (s, c) in enumerate(zip(as_layers(states), as_layers(states_cpu)))]
        return found + [(f"out layer {i}", o.cpu().numpy()[m], c.numpy()[m], phase4)
                        for i, (o, c) in enumerate(zip(as_layers(outs), as_layers(outs_cpu)))]

    def share(a, b, tol):
        return float((np.abs(a - b) / (tol[1] + tol[0] * np.abs(b))).max())

    found = checks(states, outs)
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(model, b_gpu, "cuda")
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    dt = float(np.median(ts))
    res = {"phase": "model_family_forward", "model": label, "storage": storage_of(b_gpu), "k": ks,
           "k_cpu": as_layers(ks_cpu, int), "launches": launched, "output_rows": int(m.sum()),
           "max_abs_diff": {name: float(np.abs(a - b).max()) for name, a, b, _ in found},
           "tolerance": {name: tol for name, _, _, tol in found},
           "tolerance_share": {name: share(a, b, tol) for name, a, b, tol in found},
           "phase4_tolerance_share": {name: share(a, b, phase4) for name, a, b, _ in found},
           "forward_ms": dt * 1e3, "forward_ms_all": [t * 1e3 for t in ts],
           "transition_edges_per_s": sum(ks) * n_arcs / dt, "arcs": n_arcs, "card": card}
    if control is not None:
        assert deep_tol != phase4, "a control tests a widened check"
        with control():
            _, bad_states, bad_outs, _, _ = run(model, b_gpu, "cuda")
        # over the widened checks only: failing a check at phase 4's
        # tolerance would not show that the wider one sees the fault
        res["control_tolerance_share"] = max(share(a, b, tol) for name, a, b, tol in checks(bad_states, bad_outs)
                                             if name.startswith("state") and name != "state layer 0")
    emit(res)
    assert as_layers(ks_cpu, int) == ks, (ks, ks_cpu)
    assert launched == {name: expect(ks).get(name, 0) for name in kernels.LAUNCHES}, (launched, expect(ks))
    assert np.array_equal(m, mask_cpu.numpy())
    for name, a, b, tol in found:
        assert np.isfinite(a).all(), (label, name)
        np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1], err_msg=f"{label} {name}")
    if control is not None:
        assert res["control_tolerance_share"] > 1.0, res["control_tolerance_share"]
    return res


def family_serve(label, make_model, requests, card):
    """A ``Predictor`` of ``make_model(device)`` (random weights from seed
    0) for composite molecule requests of 1, 16 and 64 graphs on the card
    against the same Predictor on the CPU (rtol 1e-5, atol 1e-6), both
    warmed first so their random streams stay in step.  These models do not
    fold: every request takes the eval forward, whose block operator is the
    plain batched product (no strip operator is built for a request), so no
    kernel launches.  First-call and median-of-5 latency."""
    from gnnkeras_tpu_torch import Predictor, kernels

    p = Predictor.for_graphs(make_model("cuda"), requests, batch_size=len(requests), headroom=1.25, device="cuda")
    p_cpu = Predictor.for_graphs(make_model("cpu"), requests, batch_size=len(requests), headroom=1.25, device="cpu")
    assert not p.fused and p._warmup_graph is requests[0]
    p.warmup()
    p_cpu.warmup()
    sizes = {"1": requests[:1], "16": requests[:16], "64": requests[:64]}
    kernels.reset_launches()
    first, outs = {}, {}
    for name, req in sizes.items():
        t = time.perf_counter()
        outs[name] = p(req)
        first[name] = (time.perf_counter() - t) * 1e3
        want = p_cpu(req)
        assert outs[name].shape == (len(req), 2) and np.isfinite(outs[name]).all(), name
        np.testing.assert_allclose(outs[name], want, rtol=1e-5, atol=1e-6, err_msg=name)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launched == {}, launched
    med = {}
    for name, req in sizes.items():
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            p(req)
            ts.append((time.perf_counter() - t) * 1e3)
        med[name] = float(np.median(ts))
    emit({"phase": "model_family_serving", "model": label, "template_nodes": p.max_nodes,
          "template_arcs": p.max_arcs, "first_call_ms": first, "median_ms_of_5": med, "launches": launched,
          "card": card})


def model_family_section(card, sample, b_bench, b_bench_cpu):
    """Phase 18: the composite and layered models on the card (module
    docstring).  Returns the launches and kernel checks of the kernels
    line."""
    import torch
    from gnnkeras_tpu_torch import from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import (bench_composite_graph, bench_typed_arc_graph, composite_of,
                                                   flagship_lgnn, starter_cgnn, starter_clgnn, typed_arc_cgnn)

    out = {}
    # the strip kernel at the widths of the homogeneous LGNN's layers 1-4 on
    # the bench operator (layer 0's d 16 is phase 2's check): d 32 and 48,
    # and past 48 rows (chunks of 48, one grid row each) d 64 and 80
    out["wide"] = {(d, name): check_strip(b_bench.strip, "bench", timed=True, name=name, d=d)
                   for d in (32, 48, 64, 80) for name in ("strip_matmul", "strip_matmul_t")}

    # (a) the starter's CLGNN and CGNN on the bench molecules as 1-type composite graphs
    t0 = time.perf_counter()
    comp = bench_composite_graph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strip, as in JAX
        b_comp_cpu = from_graph_object(comp, slot_pack=128, strip_dtype="int8", device="cpu")
    b_comp = b_comp_cpu.to("cuda")
    n_arcs = int(comp.arcs.shape[0])
    emit({"phase": "model_family_batch", "batch": "bench_composite", "host_build_s": time.perf_counter() - t0,
          "nodes": int(comp.nodes.shape[0]), "arcs": n_arcs, "graphs": int(comp.num_graphs), "types": 1,
          "strip_storage": str(b_comp.strip.strip.dtype), "tiles": b_comp.num_nodes // 128})
    with host_initial_state():
        family_serve("starter_clgnn", lambda dev: starter_clgnn(dev, seed=0), [composite_of(g) for g in sample],
                     card)
        clgnn, clgnn_cpu = starter_clgnn("cuda", seed=0), starter_clgnn("cpu", seed=0)
        # no iteration is peeled at dim_state 10: one strip launch per iteration
        out["clgnn_fwd"] = family_forward("starter_clgnn", clgnn, clgnn_cpu, b_comp, b_comp_cpu, card,
                                          lambda ks: {"strip_matmul": sum(ks)}, n_arcs)
        # 5 layers × 5 aggregations; each layer's first reads its random state₀
        # gradients through 5 layers of 5 iterations: entries below 1e-4 of
        # their leaf's largest |g| are held to that share of it (PERF.md,
        # PR 11: phase 5's 1e-6 fails here), with the bf16 control
        out["clgnn_step"] = train_phase("starter_clgnn", lambda dev: starter_clgnn(dev, seed=0), b_comp, b_comp_cpu,
                                        card, dict(strip_matmul=25, strip_matmul_t=20), out_rows=comp.num_graphs,
                                        n_arcs=n_arcs, phase="model_family_training", fit_steps=3, expect_k=None,
                                        compile_kw=dict(training_mode="parallel", average_st_grads=True),
                                        grad_atol_rel=1e-4, control=bf16_aggregation)
        cgnn, cgnn_cpu = starter_cgnn("cuda", seed=0), starter_cgnn("cpu", seed=0)
        family_forward("starter_cgnn", cgnn, cgnn_cpu, b_comp, b_comp_cpu, card,
                       lambda ks: {"strip_matmul": sum(ks)}, n_arcs)
        train_phase("starter_cgnn", lambda dev: starter_cgnn(dev, seed=0), b_comp, b_comp_cpu, card,
                    dict(strip_matmul=5, strip_matmul_t=4), phase="model_family_training", expect_k=None)
    del b_comp, b_comp_cpu, clgnn, clgnn_cpu, cgnn, cgnn_cpu
    torch.cuda.empty_cache()

    # (b) the homogeneous LGNN (dim_state 0: state widths 14, 30, 46, 62, 78,
    # d_pad 16-80) on the bench batch, residual mode, and its export
    lgnn, lgnn_cpu = flagship_lgnn("cuda", seed=0), flagship_lgnn("cpu", seed=0)
    n_bench_arcs = int(b_bench_cpu.arc_mask.sum())
    per_width = {"strip_matmul": {16: 4, 32: 5, 48: 5, 64: 5, 80: 5}}
    per_width["strip_matmul_t"] = per_width["strip_matmul"]
    fwd_widths = strip_widths()
    # layer 0 peels iteration 0 from the host-built label sums; layers 1-4
    # read changed labels and aggregate every iteration.  The states of
    # layers 1-4 are held to rtol 1e-4 / atol 1e-5 (PERF.md, PR 11: phase
    # 4's tolerance fails past layer 0), with the bf16 control
    out["lgnn_fwd"] = family_forward("flagship_lgnn", lgnn, lgnn_cpu, b_bench, b_bench_cpu, card,
                                     lambda ks: {"strip_matmul": sum(ks) - 1}, n_bench_arcs, deep_tol=(1e-4, 1e-5),
                                     control=bf16_aggregation, widths=fwd_widths)
    assert out["lgnn_fwd"]["k"] == [5] * 5
    assert fwd_widths.tally == {("strip_matmul", d): n for d, n in per_width["strip_matmul"].items()}, \
        fwd_widths.tally
    step_widths = strip_widths()
    # layers 1-4's state₀ is their labels, which carry the layer below's
    # gradient.  Gradients through 25 iterations of states up to 78 wide:
    # entries below 1e-3 of their leaf's largest |g| are held to that share
    # of it (PERF.md, PR 11: phase 5's 1e-6 fails here), with the bf16 control
    out["lgnn_step"] = train_phase("flagship_lgnn", lambda dev: flagship_lgnn(dev, seed=0), b_bench, b_bench_cpu,
                                   card, dict(strip_matmul=24, strip_matmul_t=24),
                                   out_rows=int(b_bench.graph_mask.sum()), n_arcs=n_bench_arcs,
                                   phase="model_family_training", fit_steps=3,
                                   compile_kw=dict(training_mode="residual", average_st_grads=True),
                                   grad_atol_rel=1e-3, control=bf16_aggregation, widths=step_widths)
    assert step_widths.tally == {(name, d): n for name, widths in per_width.items() for d, n in widths.items()}, \
        step_widths.tally
    out["lgnn_widths"] = {"forward": fwd_widths.tally, "step": step_widths.tally}
    out["lgnn_export"] = export_phase([("flagship_lgnn", lgnn, [b_bench], {"strip_matmul": 24})], card)
    del lgnn, lgnn_cpu
    torch.cuda.empty_cache()

    # (c) the 3-type arc CGNN on the bench arc twin typed by atom class
    t0 = time.perf_counter()
    typed = bench_typed_arc_graph()
    with warnings.catch_warnings():
        # per-type weights within a destination column: int8 does not factor, bf16 strip
        warnings.simplefilter("ignore", RuntimeWarning)
        b_typed_cpu = from_graph_object(typed, slot_pack=128, strip_dtype="int8", device="cpu")
    b_typed = b_typed_cpu.to("cuda")
    n_typed_arcs = int(typed.arcs.shape[0])
    emit({"phase": "model_family_batch", "batch": "bench_typed_arc", "host_build_s": time.perf_counter() - t0,
          "arcs": n_typed_arcs, "types": 3, "type_counts": typed.type_mask.sum(axis=0).tolist(),
          "strip_storage": str(b_typed.strip.strip.dtype), "pairs": b_typed.arc_inc.n_pairs})
    out["typed_strip"] = {name: check_strip(b_typed.strip, "bench_typed_arc", timed=True, name=name)
                          for name in ("strip_matmul", "strip_matmul_t")}
    arc_model, arc_model_cpu = typed_arc_cgnn("cuda", seed=0), typed_arc_cgnn("cpu", seed=0)
    out["arc_fwd"] = family_forward("typed_arc_cgnn", arc_model, arc_model_cpu, b_typed, b_typed_cpu, card,
                                    lambda ks: {"strip_matmul": 4, "incidence_select": 1}, n_typed_arcs)
    out["arc_step"] = train_phase("typed_arc_cgnn", lambda dev: typed_arc_cgnn(dev, seed=0), b_typed, b_typed_cpu,
                                  card, dict(strip_matmul=4, strip_matmul_t=4, incidence_select=1,
                                             incidence_scatter=1), phase="model_family_training")
    return out


def same_batch(a, b, what):
    """Two batches equal field for field whatever their devices: the same
    tree structure and static fields, every tensor bit for bit, the same
    host-side rows."""
    import torch
    import torch.utils._pytree as pytree
    from gnnkeras_tpu_torch.utils.pytree import static_signature

    la, spec_a = pytree.tree_flatten(a)
    lb, spec_b = pytree.tree_flatten(b)
    assert static_signature(spec_a) == static_signature(spec_b), what
    assert np.array_equal(a.host_pred_rows, b.host_pred_rows), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu()), what


class timed_rebuilds:
    """Within it, a sequencer's background rebuilds are timed (``build_s``,
    in the thread) and so is each wait for one, by ``__getitem__`` or at the
    end of ``fit`` (``wait_s``: the host seconds the fit waited)."""

    def __init__(self, seq):
        self.seq, self.build_s, self.wait_s = seq, [], []

    def __enter__(self):
        seq, real_build, real_join = self.seq, self.seq.build_batches, self.seq.wait_for_rebuild

        def build():
            t = time.perf_counter()
            real_build()
            self.build_s.append(time.perf_counter() - t)

        def join():
            pending = seq._pending_build is not None
            t = time.perf_counter()
            real_join()
            if pending:
                self.wait_s.append(time.perf_counter() - t)

        seq.build_batches, seq.wait_for_rebuild = build, join
        return self

    def __exit__(self, *exc):
        del self.seq.build_batches, self.seq.wait_for_rebuild
        return False


class step_losses:
    """Within it, every train step's loss is recorded (``losses``), read
    off the step's log sums."""

    def __enter__(self):
        import gnnkeras_tpu_torch.training.trainer as T

        self._trainer, self._real, self.losses = T, T.train_step, []

        def step(model, batch, generator=None):
            logs, aux = self._real(model, batch, generator)
            self.losses.append(float(logs["loss_sum"] / logs["count"]))
            return logs, aux

        T.train_step = step
        return self

    def __exit__(self, *exc):
        self._trainer.train_step = self._real
        return False


def transductive_cgnn(device, seed=0):
    """A CompositeGNNnodeBased over a transduction of the large graph: 2
    node types (label widths 8 and 10, the target appended to the
    transductive nodes), dim_state 0 (the state is the 10-wide label), per
    type BatchNorm → Dense(d_t + 40 → 10, selu), BatchNorm → Dense(10 → 2,
    softmax), 5 iterations, threshold 0."""
    from gnnkeras_tpu_torch import MLP, CompositeGNNnodeBased

    dims, width, da = (8, 10), 10, 2
    nets = [MLP((d_t + 2 * width + sum(dims) + da,), [width], "selu", kernel_initializer="lecun_normal",
                bias_initializer="lecun_normal") for d_t in dims]
    out = MLP((width,), [2], "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return CompositeGNNnodeBased(nets, out, 0, 5, 0.0).build(seed=seed, device=device)


def pipeline_section(card, g_large):
    """Phase 19: the data pipeline and the fit loop on the card (module
    docstring).  ``g_large`` is phase 14's 500k-node graph.  Returns the
    launches and kernel checks of the kernels line."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data import (MultiGraphSequencer, PrefetchSequencer, SingleGraphSequencer,
                                         TransductiveSingleGraphSequencer, dataset_splits)
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, flagship_lgnn, large_graph_gnn, random_molecules
    from gnnkeras_tpu_torch.training.callbacks import CSVLogger, EarlyStopping, LambdaCallback, ReduceLROnPlateau
    from gnnkeras_tpu_torch.training.serial import _bake_graphs
    from gnnkeras_tpu_torch.training.trainer import train_step

    out, shares = {}, {}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)  # the CSV logs' directory

    def share(a, b, rtol, atol):
        return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())

    t0 = time.perf_counter()
    molecules = random_molecules(4337, seed=0, min_nodes=5, max_nodes=56)
    train_g, test_g, val_g = dataset_splits(molecules, seed=0)
    assert (len(train_g), len(test_g), len(val_g)) == (2837, 750, 750)
    kw = dict(batch_size=1000, slot_pack=128, strip_dtype="int8")

    def sequencers(device, graphs=train_g, shuffle=True, pin_memory=False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: the bf16 latch, as in JAX
            return MultiGraphSequencer(graphs, "g", "average", shuffle=shuffle, device=device,
                                       pin_memory=pin_memory, **kw)

    seq, twin = sequencers("cuda"), sequencers("cpu")
    val_seq, test_seq = sequencers("cuda", val_g, False), sequencers("cuda", test_g, False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for i in range(len(seq)):
        same_batch(seq[i], twin[i], f"epoch 0 batch {i}")
    storage = str(seq[0].strip.strip.dtype).replace("torch.", "")
    emit({"phase": "pipeline_data", "graphs": len(molecules), "train_val_test": [len(train_g), len(val_g),
          len(test_g)], "nodes": int(sum(g.nodes.shape[0] for g in molecules)), "batches": len(seq),
          "padded_nodes": seq._pad_nodes, "strip_storage_latch": storage,
          "int8_degraded": seq._strip_scale_degraded, "residual_blocks": seq._pad_strip_res,
          "host_build_s": build_s})

    # -- leg 1: the flagship through the sequencer, with validation and callbacks --
    def callbacks(csv_name, epoch_ends):
        return [EarlyStopping(patience=2, restore_best_weights=True), ReduceLROnPlateau(patience=1),
                CSVLogger(os.path.join(REPO, "chiprun_out", csv_name)),
                LambdaCallback(on_train_begin=lambda logs: epoch_ends.append(time.perf_counter()),
                               on_epoch_end=lambda e, logs: epoch_ends.append(time.perf_counter()))]

    def fit_leg(label, train_seq, seed_batches=None):
        model = flagship_gnn("cuda", seed=0)
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
        ends = []
        cbs = callbacks(f"pipeline_{label}.csv", ends)
        if seed_batches is not None:
            # the first epoch's rebuild, against the CPU twin shuffled from the same seed
            cbs.append(LambdaCallback(on_epoch_end=lambda e, logs: e == 0 and seed_batches()))
        np.random.seed(100)
        kernels.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the rebuilds' bf16 fallback, as above
            history = model.fit(train_seq, epochs=3, validation_data=val_seq, callbacks=cbs, verbose=0)
            torch.cuda.synchronize()
        launched = expect_launches(strip_matmul=9 * 4 + 3 * 4, strip_matmul_t=9 * 4)
        kernels.reset_launches()
        ev = model.evaluate(test_seq)
        pred = model.predict(test_seq)
        torch.cuda.synchronize()
        expect_launches(strip_matmul=8)
        assert pred.shape == (750, 2) and np.isfinite(pred).all() and np.isfinite(list(ev.values())).all()
        losses = history["loss"]
        assert len(losses) == 3 and np.isfinite(losses).all() and np.isfinite(history["val_loss"]).all()
        return {"history": history.history, "launches": launched, "evaluate": ev,
                "epoch_s": list(np.diff(ends)), "fit_s": ends[-1] - ends[0]}

    def compare_rebuild():
        for i in range(len(seq)):
            same_batch(seq[i], twin[i], f"epoch 1 batch {i}")
        out["rebuild_equal"] = True

    np.random.seed(100)
    twin.on_epoch_end()  # the twin's first shuffle, from the seed the card fit starts at
    twin.wait_for_rebuild()
    with timed_rebuilds(seq) as rebuilds:
        leg1 = fit_leg("sequencer", seq, compare_rebuild)
    assert out.get("rebuild_equal"), "the epoch-1 batches were not compared"
    leg1.update(rebuild_build_s=rebuilds.build_s, rebuild_wait_s=rebuilds.wait_s)
    emit({"phase": "pipeline_sequencer_fit", "model": "flagship", "storage": storage, **leg1,
          "launches_per_train_step": {"strip_matmul": 4, "strip_matmul_t": 4}, "card": card})

    # -- leg 2: the same fit through the CUDA-stream prefetcher, over batches
    # built pinned on the CPU ------------------------------------------------------
    prefetch = PrefetchSequencer(sequencers("cpu", pin_memory=True), lookahead=2)
    leg2 = fit_leg("prefetch", prefetch)
    for key in leg1["history"]:
        np.testing.assert_allclose(leg2["history"][key], leg1["history"][key], rtol=1e-5, err_msg=key)
    shares["prefetch_history"] = max(share(np.array(leg2["history"][k]), np.array(leg1["history"][k]), 1e-5, 0.0)
                                     for k in leg1["history"])
    emit({"phase": "pipeline_prefetch_fit", "model": "flagship", **leg2, "epoch_s_direct": leg1["epoch_s"],
          "history_share": shares["prefetch_history"], "card": card})

    # -- leg 3: the starter's LGNN in serial mode ----------------------------------
    for d in (16, 32, 48):
        for name in ("strip_matmul", "strip_matmul_t"):
            res = check_strip(seq[0].strip, "sequencer_batch", timed=True, name=name, d=d)
            assert res["max_abs_diff"] == 0.0, res  # bit-equal to the plain version
            out[("check", d, name)] = res
    lgnn = flagship_lgnn("cuda", seed=0, layers=3)
    lgnn.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"],
                 training_mode="serial", average_st_grads=True)
    serial_seq, serial_val = sequencers("cuda"), sequencers("cuda", val_g, False)
    widths = strip_widths()
    t = time.perf_counter()
    np.random.seed(200)
    with widths, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        histories = lgnn.fit(serial_seq, epochs=2, validation_data=serial_val, verbose=0, bake_batch_size=1000)
        torch.cuda.synchronize()
    serial_s = time.perf_counter() - t
    # each layer: 6 train steps (a peeled forward: the baked labels are host-summed), 2 validations
    want = {(name, d): n for d in (16, 32, 48) for name, n in (("strip_matmul", 32), ("strip_matmul_t", 24))}
    assert widths.tally == want, widths.tally
    out["serial_widths"] = widths.tally
    kernels.reset_launches()
    ev = lgnn.evaluate(test_seq)
    pred = lgnn.predict(test_seq)
    torch.cuda.synchronize()
    expect_launches(strip_matmul=2 * (4 + 5 + 5))  # layers 1-2 read the layer below: no peel
    assert pred.shape == (750, 2) and np.isfinite(pred).all() and np.isfinite(list(ev.values())).all()
    for h in histories:
        assert np.isfinite(h["loss"]).all() and np.isfinite(h["val_loss"]).all()
    # layer 0's bake of the training set, card against CPU from the same weights
    twin_lgnn = flagship_lgnn("cpu", seed=0, layers=3)
    twin_lgnn.load_state_dict({k: v.cpu() for k, v in lgnn.state_dict().items()})
    layer0 = {k: v.clone() for k, v in lgnn.gnns[0].state_dict().items()}
    t = time.perf_counter()
    baked = _bake_graphs(lgnn, lgnn.gnns[0], train_g, train_g, 1000)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t
    baked_cpu = _bake_graphs(twin_lgnn, twin_lgnn.gnns[0], train_g, train_g, 1000)
    a = np.concatenate([g.nodes for g in baked])
    b = np.concatenate([g.nodes for g in baked_cpu])
    # the bake runs the plain BCSR route (as the JAX package bakes), whose
    # block products (a batched matmul) sum in another order on the card
    # than on the CPU (taking the per-tile sums in the CPU's order leaves
    # the difference as it is, PERF.md §6); 5 training-mode iterations of
    # states of magnitude ~1-4: held at phase 14's state tolerance (rtol
    # 1e-5, atol 1e-5; phase 4's atol 1e-6 gives share 2.41), with the bf16
    # control that must fail it
    shares["serial_bake_phase4"] = share(a, b, 1e-5, 1e-6)
    shares["serial_bake"] = share(a, b, 1e-5, 1e-5)
    stats = {k: v.cpu().numpy() for k, v in lgnn.gnns[0].named_buffers()}
    stats_cpu = {k: v.numpy() for k, v in twin_lgnn.gnns[0].named_buffers()}
    shares["serial_bake_stats"] = max(share(stats[k], stats_cpu[k], 1e-5, 1e-6) for k in stats)
    lgnn.gnns[0].load_state_dict(layer0)
    with bf16_aggregation():
        bad = np.concatenate([g.nodes for g in _bake_graphs(lgnn, lgnn.gnns[0], train_g, train_g, 1000)])
    shares["serial_bake_control"] = share(bad, b, 1e-5, 1e-5)
    emit({"phase": "pipeline_serial_lgnn", "layers": 3, "d_pad": [16, 32, 48], "epochs_per_layer": 2,
          "histories": [h.history for h in histories], "evaluate": ev, "fit_s": serial_s,
          "launches_per_layer_step": {f"d{d}": {"strip_matmul": 4, "strip_matmul_t": 4} for d in (16, 32, 48)},
          "strip_tally": {f"{n}_d{d}": c for (n, d), c in widths.tally.items()}, "bake_s": bake_s,
          "bake_tolerance": [1e-5, 1e-5], "bake_share": shares["serial_bake"],
          "bake_phase4_share": shares["serial_bake_phase4"], "bake_control_share": shares["serial_bake_control"],
          "bake_stats_share": shares["serial_bake_stats"], "bake_max_abs_diff": float(np.abs(a - b).max()),
          "card": card})
    assert shares["serial_bake"] <= 1.0 and shares["serial_bake_stats"] <= 1.0, shares
    assert shares["serial_bake_control"] > 1.0, shares
    del lgnn, twin_lgnn, seq, twin, prefetch, serial_seq, serial_val
    torch.cuda.empty_cache()

    # -- leg 4: one large graph -------------------------------------------------------
    t = time.perf_counter()
    single = SingleGraphSequencer(g_large, "n", batch_size=100_000, agg_dtype="auto", device="cuda")
    torch.cuda.synchronize()
    single_build_s = time.perf_counter() - t
    assert len(single) == 5 and type(single[0].bcsr).__name__ == "BandedOperator"
    nd = len(single[0].bcsr.diags)
    diag0 = single[0].bcsr.diags[single[0].bcsr.offsets.index(0)]
    out["single_checks"] = {name: check_strip(diag0, "single_graph_sequencer_diagonal_0", timed=True, name=name, d=8)
                            for name in ("strip_matmul", "strip_matmul_t")}
    model = large_graph_gnn("cuda", seed=0)
    model.compile(optimizer="adam:0.01", loss="mse")
    first_cpu = single[0].to("cpu")
    np.random.seed(300)
    kernels.reset_launches()
    t = time.perf_counter()
    with step_losses() as steps:
        history = model.fit(single, epochs=1, verbose=0)
        torch.cuda.synchronize()
    single_fit_s = time.perf_counter() - t
    out["single_launches"] = expect_launches(strip_matmul=5 * 4 * nd, strip_matmul_t=5 * 4 * nd)
    model_cpu = large_graph_gnn("cpu", seed=0)
    model_cpu.compile(optimizer="adam:0.01", loss="mse")
    logs_cpu, _ = train_step(model_cpu, first_cpu, model_cpu.next_rng())
    loss_cpu = float(logs_cpu["loss_sum"] / logs_cpu["count"])
    np.testing.assert_allclose(steps.losses[0], loss_cpu, rtol=1e-5)
    shares["single_first_loss"] = share(np.array(steps.losses[0]), np.array(loss_cpu), 1e-5, 0.0)
    assert len(steps.losses) == 5 and np.isfinite(steps.losses).all()
    del single, first_cpu, model, model_cpu
    torch.cuda.empty_cache()

    t = time.perf_counter()
    np.random.seed(400)
    trans = TransductiveSingleGraphSequencer(g_large, "n", 0.5, batch_size=100_000, agg_dtype="auto",
                                             device="cuda")
    torch.cuda.synchronize()
    trans_build_s = time.perf_counter() - t
    cgnn = transductive_cgnn("cuda", seed=0)
    cgnn.compile(optimizer="adam:0.01", loss="mse")
    kernels.reset_launches()
    t = time.perf_counter()
    with step_losses() as trans_steps:
        trans_hist = cgnn.fit(trans, epochs=1, verbose=0)  # the epoch's end re-transduces and rebuilds
        torch.cuda.synchronize()
    trans_fit_s = time.perf_counter() - t
    out["transductive_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert out["transductive_launches"].get("strip_matmul", 0) > 0 and \
        out["transductive_launches"].get("strip_matmul_t", 0) > 0, out["transductive_launches"]
    assert len(trans_steps.losses) == len(trans) and np.isfinite(trans_hist["loss"]).all()
    emit({"phase": "pipeline_single_graph", "nodes": int(g_large.nodes.shape[0]), "batches": 5, "diagonals": nd,
          "host_build_s": single_build_s, "fit_s": single_fit_s, "step_losses": steps.losses,
          "first_step_loss_cpu": loss_cpu, "first_step_loss_share": shares["single_first_loss"],
          "launches": out["single_launches"], "history": history.history,
          "transductive": {"types": 2, "host_build_s": trans_build_s, "fit_s": trans_fit_s,
                           "batches": len(trans), "step_losses": trans_steps.losses,
                           "launches": out["transductive_launches"]},
          "card": card})
    del trans, cgnn
    torch.cuda.empty_cache()
    out["leg1"], out["shares"] = leg1, shares
    return out


def mps_probe():
    """Can an MPS server serve this card?  Starts the MPS control daemon (pipe
    and log directories under the checkout's ``gnnkeras_tpu_torch/_build/``),
    runs one CUDA client in a subprocess through it, and stops the daemon.
    Run before this process holds a CUDA context.  Without MPS the ranks of
    phase 17 share the card time-sliced."""
    base = os.path.join(REPO, "gnnkeras_tpu_torch", "_build", "mps")
    pipe, logs = os.path.join(base, "pipe"), os.path.join(base, "log")
    if len(pipe) > 90:  # the daemon's unix socket path must fit 108 bytes
        return {"mps": False, "reason": "checkout path too long for the daemon's socket"}
    os.makedirs(pipe, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, CUDA_MPS_PIPE_DIRECTORY=pipe, CUDA_MPS_LOG_DIRECTORY=logs)
    try:
        start = subprocess.run(["nvidia-cuda-mps-control", "-d"], env=env, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return {"mps": False, "reason": f"nvidia-cuda-mps-control -d: {err!r}"}
    if start.returncode != 0:
        return {"mps": False, "reason": f"nvidia-cuda-mps-control -d exit {start.returncode}: {start.stderr[-300:]}"}
    try:
        client = subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
                                 "torch.cuda.synchronize(); print('ok')"], env=env, capture_output=True, text=True,
                                timeout=120)
    finally:
        subprocess.run(["nvidia-cuda-mps-control"], input="quit\n", env=env, capture_output=True, text=True,
                       timeout=60)
    ok = client.returncode == 0 and client.stdout.strip().endswith("ok")
    log = ""
    if os.path.exists(os.path.join(logs, "control.log")):
        with open(os.path.join(logs, "control.log")) as f:
            log = " | ".join(ln.strip() for ln in f.read().splitlines() if "exception" in ln.lower())[-300:]
    return {"mps": ok, "reason": "a CUDA client ran through the MPS server" if ok else
            f"the daemon started, the client failed (exit {client.returncode}): {client.stderr.strip()[-200:]}; "
            f"daemon log: {log}"}


def _ring_times(x, reps=20):
    """Times of one gather of ``x`` on this rank, each after a barrier: the
    ring kernels (CUDA events around ``reps`` calls), the host clock of a
    call, its plain version (point-to-point sends through host memory, host
    clock) and gloo's ``all_gather`` of the same tensors through host memory
    (``parallel/collectives.all_gather``, host clock)."""
    import torch
    import torch.distributed as dist
    from gnnkeras_tpu_torch.ops import ring as R
    from gnnkeras_tpu_torch.parallel.collectives import all_gather

    def event_ms(fn):
        dist.barrier()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def host_ms(fn, calls=5):
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / calls

    return {"kernel_ms": event_ms(lambda: R.ring_all_gather(x)),
            "kernel_host_ms": host_ms(lambda: R.ring_all_gather(x), calls=reps),
            "plain_ms": host_ms(lambda: R._ring_all_gather_plain(x)),
            "library_ms": host_ms(lambda: all_gather(x))}


def _partition_rank(rank, world, shard, halo_rows):
    """Phase 17 on one rank (a spawned process on the card): the ring kernel
    against its plain version at the halo's and the full state's shape, the
    large-graph model's forward through both transports and one Adam step
    through ``collective``, each with its launches counted from 0 and host
    times.  Returns NumPy results for the parent to compare."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data.synthetic import large_graph_gnn
    from gnnkeras_tpu_torch.ops import ring as R
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    shard = shard.to(dev)
    torch.cuda.synchronize()
    res = {"rank": rank, "device": str(dev), "to_device_s": time.perf_counter() - t0, "ring": {}}
    size = int(shard.node_mask.sum())

    for label, rows in (("halo", halo_rows), ("full_state", shard.nodes_per_part)):
        x = torch.randn((rows, 8), generator=torch.Generator(device=dev).manual_seed(100 + rank), device=dev)
        kernels.reset_launches()
        got = R.ring_all_gather(x)
        assert kernels.LAUNCHES["ring_all_gather"] == 2  # the push and the copy-out
        want = R._ring_all_gather_plain(x)
        assert torch.equal(got, want), label  # a copy: bit for bit
        # bytes on the card for the whole group's gather: every rank's block
        # read once, every rank's output (all P blocks) written once
        n_bytes = world * (1 + world) * x.numel() * x.element_size()
        res["ring"][label] = {"rows": rows, "d": 8, "max_abs_diff": float((got - want).abs().max()),
                              **_ring_times(x), "bytes": n_bytes}

    model = large_graph_gnn(dev, seed=0)
    for transport in ("collective", "pallas_ring"):
        engine = PartitionedGNN(model, transport=transport)
        kernels.reset_launches()
        k, state, out, _ = engine.forward(shard)
        torch.cuda.synchronize()
        launches = {name: n for name, n in kernels.LAUNCHES.items() if n}
        ts = []
        for _ in range(5):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.forward(shard)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        res[transport] = {"k": float(k), "state": state[:size].cpu().numpy(), "out": out[:size].cpu().numpy(),
                          "launches": launches, "forward_ms": float(np.median(ts)), "forward_ms_all": ts}

    model.compile(optimizer="adam:0.01", loss="mse")
    engine = PartitionedGNN(model)
    kernels.reset_launches()
    logs = engine.train_step(shard)
    torch.cuda.synchronize()
    res["step"] = {"loss": float(logs["loss"]), "k": float(logs["k"]),
                   "launches": {name: n for name, n in kernels.LAUNCHES.items() if n},
                   "params": {n: p.detach().cpu().numpy() for n, p in model.named_parameters()},
                   "grads": {n: p.grad.cpu().numpy() for n, p in model.named_parameters()},
                   "buffers": {n: b.cpu().numpy() for n, b in model.named_buffers()}}
    ts = []
    for _ in range(5):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.train_step(shard)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    res["step"]["train_step_ms"], res["step"]["train_step_ms_all"] = float(np.median(ts)), ts
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def partitioned_section(card, g, batch, mps):
    """Phase 17: the edge-partitioned engine on the 500k-node banded graph of
    phase 14 (``g``; ``batch`` its single-device batch on the card, the
    banded int8 route of ``agg_dtype='auto'``).  One partition into 4 parts
    (``dense_blocks=True``, halo on, ``agg_dtype='auto'``: each part's local
    operator the banded int8 decomposition, kernel rows 1/1b) is built once
    and driven by 4 ranks sharing the card (``_partition_rank``): the ring
    kernel bit for bit against its plain version, the forward through both
    transports against the single-device forward, one Adam step through
    ``collective`` against the single-device step.  Returns what the kernels
    line reads."""
    import torch
    from gnnkeras_tpu_torch.data.synthetic import large_graph_gnn
    from gnnkeras_tpu_torch.ops.banded import BandedOperator
    from gnnkeras_tpu_torch.parallel.launch import spawn
    from gnnkeras_tpu_torch.parallel.partition import partition_graph
    from gnnkeras_tpu_torch.training.trainer import train_step

    t0 = time.perf_counter()
    pg = partition_graph(g, PARTS, dense_blocks=True, agg_dtype="auto")
    build_s = time.perf_counter() - t0
    assert pg.publish_local is not None and all(isinstance(op, BandedOperator) for op in pg.local_ops)
    halo_rows = int(pg.publish_local.shape[1])
    emit({"phase": "partition_build", "host_build_s": build_s, "parts": PARTS, "nodes_per_part": pg.nodes_per_part,
          "halo_rows": halo_rows, "published_rows": [int(m.sum()) for m in pg.publish_mask],
          "offsets": list(pg.local_ops[0].offsets),
          "halo_blocks": [int(op.blocks.shape[0]) for op in pg.halo_ops]})

    # the single-device reference on the card: forward, then one Adam step
    model = large_graph_gnn("cuda", seed=0)
    k_ref, state_ref, out_ref, mask_ref, _ = model.forward(batch, training=False)
    n = int(g.nodes.shape[0])
    state_ref, out_ref = state_ref[:n].cpu().numpy(), out_ref[mask_ref].cpu().numpy()
    model.compile(optimizer="adam:0.01", loss="mse")
    logs_ref, _ = train_step(model, batch, model.next_rng())
    loss_ref = float(logs_ref["loss_sum"] / logs_ref["count"])
    params_ref = {nm: p.detach().cpu().numpy() for nm, p in model.named_parameters()}
    grads_ref = {nm: p.grad.cpu().numpy() for nm, p in model.named_parameters()}
    buffers_ref = {nm: b.cpu().numpy() for nm, b in model.named_buffers()}
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(_partition_rank, PARTS, [(pg.shard(r, "cpu"), halo_rows) for r in range(PARTS)], threads=2,
                  timeout_s=600)
    ranks_s = time.perf_counter() - t0
    out = {"ring": ranks[0]["ring"], "ranks": ranks}
    for res in out["ring"].values():
        res["bound_ms"], res["bound_by"] = bound(res["bytes"], 0)
    for transport in ("collective", "pallas_ring"):
        assert all(r[transport]["k"] == k_ref == 5 for r in ranks), [r[transport]["k"] for r in ranks]
        state = np.concatenate([r[transport]["state"] for r in ranks])
        o = np.concatenate([r[transport]["out"] for r in ranks])
        # the same f32 weights, a node's ~8 neighbour terms summed in another
        # order (local diagonals, then the halo blocks), over 5 iterations
        np.testing.assert_allclose(state, state_ref, rtol=1e-5, atol=1e-5, err_msg=transport)
        np.testing.assert_allclose(o, out_ref, rtol=1e-5, atol=1e-6, err_msg=transport)
        out[transport] = {"state_max_abs_diff": float(np.abs(state - state_ref).max()),
                          "out_max_abs_diff": float(np.abs(o - out_ref).max())}
    for r in ranks:
        want = {"strip_matmul": 12}
        assert r["collective"]["launches"] == want, r["collective"]["launches"]
        # 4 ring calls a forward (the first of 5 iterations reads the peeled
        # aggregate), 2 kernels each
        assert r["pallas_ring"]["launches"] == {**want, "ring_all_gather": 8}, r["pallas_ring"]["launches"]
        assert r["step"]["launches"] == {"strip_matmul": 12, "strip_matmul_t": 12}, r["step"]["launches"]
    # one Adam step: the tolerances of phase 14 (a bias gradient sums 500,000
    # terms of both signs: entries below 1e-4 of the leaf's largest |g| are
    # held to that share of it; parameters where Adam's step is not steep)
    excluded, worst = 0, {}
    for r in ranks:
        step = r["step"]
        assert step["k"] == 5.0
        np.testing.assert_allclose(step["loss"], loss_ref, rtol=1e-5)
        for nm, grad in step["grads"].items():
            g_ref = grads_ref[nm]
            gmax = float(np.abs(g_ref).max())
            np.testing.assert_allclose(grad, g_ref, rtol=1e-4, atol=1e-4 * gmax, err_msg=nm)
            worst[nm] = max(worst.get(nm, 0.0), float(np.abs(grad - g_ref).max() / max(gmax, 1e-30)))
            g_abs = np.abs(g_ref)
            g_err = 1e-4 * g_abs + 1e-4 * gmax
            live = 0.01 * 1e-7 * g_err / (np.maximum(g_abs - g_err, 0.0) + 1e-7) ** 2 < 1e-6
            excluded += int((~live).sum())
            np.testing.assert_allclose(step["params"][nm][live], params_ref[nm][live], rtol=1e-5, atol=1e-6,
                                       err_msg=nm)
        for nm, b in step["buffers"].items():
            np.testing.assert_allclose(b, buffers_ref[nm], rtol=1e-5, atol=1e-6, err_msg=nm)
    emit({"phase": "partitioned", "parts": PARTS, "ranks_s": ranks_s,
          "ranks_share_the_card": "time-sliced (no MPS server running)", "mps_probe": mps,
          "ring": {r["rank"]: r["ring"] for r in ranks},
          "forward_ms": {t: [r[t]["forward_ms"] for r in ranks] for t in ("collective", "pallas_ring")},
          "train_step_ms": [r["step"]["train_step_ms"] for r in ranks],
          "to_device_s": [r["to_device_s"] for r in ranks], "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
          "launches": {"forward_collective": ranks[0]["collective"]["launches"],
                       "forward_pallas_ring": ranks[0]["pallas_ring"]["launches"],
                       "train_step": ranks[0]["step"]["launches"]},
          "vs_single_device": {t: out[t] for t in ("collective", "pallas_ring")},
          "step_loss": ranks[0]["step"]["loss"], "step_loss_single_device": loss_ref,
          "grad_max_rel_diff": worst, "adam_entries_excluded": excluded, "card": card})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import gnnkeras_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from gnnkeras_tpu_torch import from_graph_object, kernels
    from gnnkeras_tpu_torch.data.synthetic import arc_gnn, bench_arc_graph, bench_graph, flagship_gnn, random_molecules
    from gnnkeras_tpu_torch.ops.incidence import build_incidence_pairs, build_node_index

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    mps = mps_probe()  # before this process holds a context on the card
    mps["probe_s"] = time.perf_counter() - t0
    emit({"phase": "mps_probe", **mps})
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    times = {}

    # -- 1. device and build -------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    ptxas = {n: [ln.strip() for ln in kernels.build_log(n).splitlines() if "registers" in ln or "spill" in ln]
             for n in kernels.SOURCES}
    emit({"phase": "build", "card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})
    times["build"] = time.perf_counter() - t0

    # -- 2. kernel checks ----------------------------------------------------
    t_phase = t0 = time.perf_counter()
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

    strip_bf16 = check_strip(b_bench.strip, "bench", timed=True)
    strip_int8 = check_strip(b_int8.strip, "bench_without_parallel_arcs", timed=True)
    check_strip(b_ragged.strip, "ragged_small", timed=False)
    strip_t_bf16 = check_strip(b_bench.strip, "bench", timed=True, name="strip_matmul_t")
    strip_t_int8 = check_strip(b_int8.strip, "bench_without_parallel_arcs", timed=True, name="strip_matmul_t")
    check_strip(b_ragged.strip, "ragged_small", timed=False, name="strip_matmul_t")
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
    host_build_s = time.perf_counter() - t0
    # the scatter's node-major index alone (part of host_build_s)
    t0 = time.perf_counter()
    build_node_index(b_arc_cpu.arc_src.numpy(), b_arc_cpu.arc_dst.numpy(), b_arc.num_nodes)
    node_index_s = time.perf_counter() - t0
    spread_src, spread_dst = spread_pairs(b_arc.num_arcs, b_arc.num_nodes)
    spread_inc = build_incidence_pairs(spread_src, spread_dst, b_arc.num_nodes).to("cuda")
    assert spread_inc.n_live > 10_240, spread_inc.n_live
    emit({"phase": "bench_arc_batch", "host_build_s": host_build_s, "node_index_build_s": node_index_s,
          "arcs": n_real_arcs,
          "padded_arcs": b_arc.num_arcs, "padded_nodes": b_arc.num_nodes, "pairs": b_arc.arc_inc.n_pairs,
          "live_pairs": b_arc.arc_inc.n_live, "arc_tiles": b_arc.arc_inc.n_arc_tiles,
          "node_tiles": b_arc.arc_inc.n_node_tiles, "strip_storage": str(b_arc.strip.strip.dtype),
          "above_budget_live_pairs": spread_inc.n_live})
    src_np, dst_np = b_arc_cpu.arc_src.numpy(), b_arc_cpu.arc_dst.numpy()
    sel_res, scatter_res = check_incidence(b_arc.arc_inc, src_np, dst_np, "bench_arc", timed=True)
    check_incidence(b_arc.arc_inc, src_np, dst_np, "bench_arc_d24", timed=False, d=24)
    check_incidence(b_arc.arc_inc, src_np, dst_np, "bench_arc_d3", timed=False, d=3)
    sel_big, scatter_big = check_incidence(spread_inc, spread_src, spread_dst, "above_10240_pairs", timed=True)
    ragged_arc = as_arc_focus(ragged, seed=7)
    b_ragged_arc = from_graph_object(GraphObject.merge(ragged_arc, "a", "average"), slot_pack=128,
                                     strip_dtype="float32", device="cpu")
    check_incidence(b_ragged_arc.arc_inc.to("cuda"), b_ragged_arc.arc_src.numpy(), b_ragged_arc.arc_dst.numpy(),
                    "ragged_small", timed=False, d=3)

    times["kernel_checks"] = time.perf_counter() - t_phase

    # -- 3. serving ----------------------------------------------------------
    t_phase = time.perf_counter()
    sample = random_molecules(64, seed=1)
    big = random_molecules(1, seed=2, min_nodes=150, max_nodes=151)[0]
    serve_launches, predictor = serve_phase(model, model_cpu, sample, big, {}, card)
    served_kernel_checks(model, predictor, sample)

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
    arc_serve_launches, _ = serve_phase(arc_model, arc_model_cpu, as_arc_focus(sample, seed=3),
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
    # the select's arc-major index is an input of the program, not a
    # constant; a select that kept the template's index would leave the
    # supervised rows that the later (host-side) pairs feed wrong
    arc_small, arc_full = arc_request(sample[:2], 5), arc_request(sample[:32], 6)
    inc, lo = arc_full.arc_inc, arc_small.arc_inc.n_live
    assert inc.n_live > lo
    past = (inc.f_arc_tile[lo:].long()[:, None] * 128 + torch.arange(128))[inc.f_cols_src[lo:] >= 0]
    assert arc_full.output_row_mask[past.to("cuda")].any()
    arc_launches = {"strip_matmul": 4, "incidence_select": 1}
    export_launches = export_phase([("flagship", model, [b_bench], {"strip_matmul": 4}),
                                    ("arc", arc_model, [b_arc], arc_launches),
                                    ("arc_request_more_live_pairs", arc_model, [arc_small, arc_full], arc_launches)],
                                   card)

    # -- 12. micro-batching, 13. HTTP ------------------------------------------
    mb_predictor = microbatch_phase(model, sample, card)
    http_phase(mb_predictor, sample, card)

    times["serving_to_http"] = time.perf_counter() - t_phase

    # -- 14. the single large graph, 15. slot-32/64 mixed strips ----------------
    t_phase = time.perf_counter()
    large = large_graph_section(card)
    torch.cuda.empty_cache()
    times["large_graph"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    mixed = mixed_strip_section(card, model, model_cpu, bench, bench_u)
    times["mixed_strip"] = time.perf_counter() - t_phase

    # -- 16. the experiment scripts' strips, 17. the partitioned engine ---------
    t_phase = time.perf_counter()
    scripts = strip_scripts_section(card)
    times["strip_scripts"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    parted = partitioned_section(card, large["graph"], large["batch"], mps)
    times["partitioned"] = time.perf_counter() - t_phase

    # -- 18. the model family: composite and layered models -----------------------
    t_phase = time.perf_counter()
    family = model_family_section(card, sample, b_bench, b_bench_cpu)
    times["model_family"] = time.perf_counter() - t_phase

    # -- 19. the data pipeline and the fit loop --------------------------------------
    t_phase = time.perf_counter()
    pipeline = pipeline_section(card, large["graph"])
    times["pipeline"] = time.perf_counter() - t_phase
    emit({"phase": "timing", "phase_s": times, "total_s": time.perf_counter() - t_start})

    # -- kernels, card, verdict ----------------------------------------------
    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_diff"], "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"]}

    strip_src = "gnnkeras_tpu_torch/csrc/strip_matmul.cu"
    fused_src = "gnnkeras_tpu_torch/csrc/fused_unfold.cu"
    fused_rm_src = "gnnkeras_tpu_torch/csrc/fused_unfold_rm.cu"
    inc_src = "gnnkeras_tpu_torch/csrc/incidence.cu"
    qbcsr_src = "gnnkeras_tpu_torch/csrc/qbcsr.cu"
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
        # the banded decomposition's diagonal products: rows 1 and 1b at the
        # 500k-node graph's shapes, once per diagonal and iteration
        entry("strip_matmul_banded_diagonal", strip_src, "gnnkeras_tpu/ops/strip.py:278", large["banded_fwd"]["strip_matmul"],
              large["banded_strip"]),
        entry("strip_matmul_t_banded_diagonal", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              large["banded_step"]["strip_matmul_t"], large["banded_strip_t"]),
        # row 8 on the band-384 graph's operator (the agg_dtype='int8' route),
        # and its bf16 blocks on the same graph with parallel arcs, where
        # agg_dtype='int8' falls back to bf16 storage
        entry("qbcsr_matmul", qbcsr_src, "gnnkeras_tpu/ops/bcsr.py:378", large["quant_fwd"]["qbcsr_matmul"],
              large["qbcsr"][("band384", "int8", "qbcsr_matmul")]),
        entry("qbcsr_matmul_t", qbcsr_src, "gnnkeras_tpu/ops/bcsr.py:378", large["quant_step"]["qbcsr_matmul_t"],
              large["qbcsr"][("band384", "int8", "qbcsr_matmul_t")]),
        entry("qbcsr_matmul_bf16", qbcsr_src, "gnnkeras_tpu/ops/bcsr.py:378", large["quant_bf16_fwd"]["qbcsr_matmul"],
              large["qbcsr"][("band384", "bfloat16", "qbcsr_matmul")]),
        entry("qbcsr_matmul_t_bf16", qbcsr_src, "gnnkeras_tpu/ops/bcsr.py:378",
              large["quant_bf16_step"]["qbcsr_matmul_t"], large["qbcsr"][("band384", "bfloat16", "qbcsr_matmul_t")]),
        # row 1 on slot-32 compact strips (every bench tile slot-pure)
        entry("strip_matmul_slot32", strip_src, "gnnkeras_tpu/ops/strip.py:278", mixed["pure_fwd"],
              mixed["checks"][(32, "bench", "strip_matmul")]),
        # row 3: both regions in one launch, both directions, slot 32 and 64
        *[entry(f"strip_matmul_mixed_slot{slot}_{st}", strip_src, "gnnkeras_tpu/ops/strip.py:379",
                mixed["fwd"][(slot, st)], mixed["checks"][(slot, st, "strip_matmul")])
          for slot in (32, 64) for st in ("int8", "bfloat16")],
        *[entry(f"strip_matmul_t_mixed_slot{slot}_{st}", strip_src, "gnnkeras_tpu/ops/strip.py:379",
                mixed["step"][(slot, st)], mixed["checks"][(slot, st, "strip_matmul_t")])
          for slot in (32, 64) for st in ("int8", "bfloat16")],
        # row 9: the ring all-gather of the partitioned engine (rank 0 of 4 on
        # the card), at the halo's shape, the one its forward exchanges
        entry("ring_all_gather", "gnnkeras_tpu_torch/csrc/ring.cu", "gnnkeras_tpu/ops/ring.py:25",
              parted["ranks"][0]["pallas_ring"]["launches"]["ring_all_gather"], parted["ring"]["halo"]),
        entry("ring_all_gather_full_state", "gnnkeras_tpu_torch/csrc/ring.cu", "gnnkeras_tpu/ops/ring.py:25",
              parted["ranks"][0]["pallas_ring"]["launches"]["ring_all_gather"], parted["ring"]["full_state"]),
        # rows 10-12: the experiment scripts' strips through their tools (the
        # strip kernels; bf16 strips through the bf16-state instantiation)
        *[entry(f"{fn_name}_{st}", strip_src, replaces, scripts["launches"][st][fn_name],
                scripts["checks"][(key, st)])
          for st in ("float32", "bfloat16")
          for fn_name, key, replaces in (
              ("strip_aggregate", "row11", "scripts/bench_pallas_compact.py:38"),
              ("blocked_aggregate", "row11", "scripts/bench_strip_blocked.py:28"),
              ("strip64_aggregate", "row12", "scripts/bench_strip64.py:75"),
              ("packed_aggregate", "row12", "scripts/bench_strip64.py:187"))],
        # phase 18, rows 1/1b on the model family's paths: the starter CLGNN
        # (d_pad 16 on the bench operator, phase 2's checks), the homogeneous
        # LGNN's layers at every width (d 16: phase 2's checks; d 32-80:
        # phase 18's), and the 3-type arc CGNN (its own strip
        # operator) with its readout's select and scatter (phase 2's checks:
        # the same pairs and width)
        entry("strip_matmul_clgnn", strip_src, "gnnkeras_tpu/ops/strip.py:278", sum(family["clgnn_fwd"]["k"]),
              strip_bf16),
        entry("strip_matmul_t_clgnn", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              family["clgnn_step"]["strip_matmul_t"], strip_t_bf16),
        *[entry(f"{name}_lgnn_d{d}", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                family["lgnn_widths"]["forward" if name == "strip_matmul" else "step"][(name, d)], check)
          for (d, name), check in {(16, "strip_matmul"): strip_bf16, (16, "strip_matmul_t"): strip_t_bf16,
                                   **family["wide"]}.items()],
        entry("strip_matmul_typed_arc_cgnn", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              family["arc_fwd"]["launches"]["strip_matmul"], family["typed_strip"]["strip_matmul"]),
        entry("strip_matmul_t_typed_arc_cgnn", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              family["arc_step"]["strip_matmul_t"], family["typed_strip"]["strip_matmul_t"]),
        entry("incidence_select_typed_arc_cgnn", inc_src, "gnnkeras_tpu/ops/incidence.py:375",
              family["arc_fwd"]["launches"]["incidence_select"], sel_res),
        entry("incidence_scatter_typed_arc_cgnn", inc_src, "gnnkeras_tpu/ops/incidence.py:375",
              family["arc_step"]["incidence_scatter"], scatter_res),
        # phase 19, rows 1/1b on the data pipeline's paths: a sequencer batch's
        # own operator at the flagship's d 16 (launches: the sequencer fit of
        # leg 1) and the serial LGNN's d 32 and 48 (its widths' tallies); the
        # single graph's banded diagonal through SingleGraphSequencer
        *[entry(f"{name}_sequencer_d{d}", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                pipeline["leg1"]["launches"][name] if d == 16 else pipeline["serial_widths"][(name, d)],
                pipeline[("check", d, name)])
          for d in (16, 32, 48) for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_single_graph", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                pipeline["single_launches"][name], pipeline["single_checks"][name])
          for name in ("strip_matmul", "strip_matmul_t")],
    ]})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
