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
   (``examples/starter_composite.py``: composite graph-focused layers,
   dim_state 10, threshold 0.01; 3 of its 5 layers) served by
   a ``Predictor`` for requests of 1, 16 and 64 molecules, its eval
   forward (per-layer k, states and outputs, one strip launch per
   iteration) and one ``parallel`` Adam step (15 + 12 strip launches) card
   against CPU, 3 ``fit`` steps,
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

20. the scanned epoch (``fit(scan_batches=True)``: the epoch's train steps
   captured once into a CUDA graph and replayed once an epoch), for the
   flagship over phase 19's sequencer (3 batches of 1,000 molecules), the
   starter CLGNN (dim_state 10, ``parallel``, ``average_st_grads``; 3 of
   its 5 layers) and the arc GNN over 1,000 of those molecules (2 batches
   of 500; 1-type composite and arc-focused twins): 3 epochs captured, 3
   one step a batch on the card (twice: are they equal bit for bit?) and
   3 on the CPU, each validated on 2 batches (the captured evaluate),
   with ``ReduceLROnPlateau`` halving the rate after epochs 1 and 2 and
   ``EarlyStopping`` restoring the best validated weights; the captured
   fit's History and state against the per-step fit's (bit for bit where
   two per-step runs agree) and the CPU's (the flagship's and the arc
   GNN's losses at rtol 1e-5 and state at rtol 1e-5 / atol 1e-5, the
   CLGNN's at the wider bounds of ``scanned_epoch_section``, each with a
   bf16-aggregation control that must fail it); a resume from the captured
   fit's epoch-1 checkpoint; one profiler session over a replay and a
   per-step epoch of each model (the kernels each launched, the device-busy
   share); the epoch and capture times.  The partitioned fits run
   on phase 17's ranks (``_partitioned_fits``: validation, EarlyStopping,
   checkpoints and resume at ``steps_per_launch=2``);
21. distributed training on 4 ranks sharing the card (spawned once,
   gloo through host memory, launches counted per rank from 0, the strip
   kernel's also by width), each against the single card, after the strip
   kernel's checks on packed part 0 at d 16, 32 and 48 and on hybrid part
   0's local main diagonal at d 8: (a) the packed flagship
   (``partition_packed(bench, 4, slot_pack=128, strip_dtype='int8')``:
   whole molecules a rank, strips latched to bf16): the eval forward's
   states and outputs at phase 4's bounds, one Adam step at phase 5's, 4
   strip launches a forward and 4 + 4 a step, the ranks' host ms; (b) the
   packed 3-layer ``flagship_lgnn`` (``residual``): forward and step at
   phase 18's deep-stack bounds, each with the bf16-aggregation control
   that must fail it; (c) ``DataParallelTrainer`` over phase 19's sequencer (3
   batches of 1,000 molecules and a filler on 4 ranks): the first step
   against a single-card Adam step on the mean of the three batches'
   gradients (phase 5's bounds), then 2 epochs with validation and a
   checkpoint resume, every rank's weights and the resumed fit's bit for
   bit the whole fit's; (d) ``TensorParallelGNN`` of the flagship (14
   state features padded to 16, 4 a rank): forward and one Adam step, its
   gradients gathered from the shards; (e)
   the 500k-node graph partitioned in 2 (``agg_dtype='auto'``): the
   hybrid step on a data 2 × graph 2 mesh (replica 1 the same graph with a
   second draw of its targets) against a single-card step on the two
   replicas' averaged gradients and moving statistics, and on a data 1 ×
   graph 2 × model 2 mesh (``tp_shards=2``, 8 → 4 features a rank) against
   the single card's step (phase 17's bounds, the shards' gradients
   gathered); then
   ``make_multihost_mesh(2, 2)`` with each rank's environment set as 2
   hosts × 2, whose step equals the first hybrid step's bit for bit; the
   partition's ``comm_volume``;
22. expert-parallel, pipelined and composite-partitioned training on 4 ranks
   sharing the card (spawned once, as phase 21's), each against the single
   card from the same weights and draws (the ranks and the single card seed
   the same CUDA generators), after the strip kernel's checks at d 16 on the
   typed bench operator and on a microbatch's: (a) ``ExpertParallelCompositeGNN``
   of ``typed_cgnn(10)`` on the bench batch typed into 3 atom types (types
   padded to 4: rank 3's expert is zero): the eval forward (states at phase
   17's bound with a bf16-aggregation control that must fail it, outputs at
   phase 4's), one Adam step with ``average_st_grads`` (the experts'
   gradients gathered and unpadded; phase 17's step bounds), launches equal to
   the single card's, and a 2-epoch ``fit`` over phase 19's molecules typed
   the same way with validation and a checkpoint; (b) ``PipelineLGNN`` of
   ``pipeline_lgnn(4)``, one layer a rank: M = 1 on the bench batch against
   the single card's ``parallel`` step (the LGNN stack's bounds, with its
   control), the stages' launches summing to the single card's; M = 4 (250
   of phase 19's molecules a microbatch, one padded shape, no BatchNorm)
   against an Adam step on the mean of the four gradients; a 2-epoch ``fit``;
   (c) ``typed_cgnn(0)`` on the typed bench batch split into 4 parts by
   ``partition_graph``: forward and Adam step through the collective transport
   (no kernel: the edge path), the forward through the ring (row 9; training
   through it refuses), and forward and step through ``dense_blocks=True,
   agg_dtype='int8'`` on the typed graph without parallel arcs (banded
   diagonals in bf16, rows 1/1b; the reference holds the same bf16 weights
   inside a part), and the band-384 graph at 131,072 nodes as a 1-type
   composite graph (quantised int8 blocks: row 8), each against the single
   card on the whole graph; the ring, the diagonal and row 8 checked on every
   rank's own operator (each step's reference takes the ranks' selu branches,
   ``selu_branches``: a branch may differ only where the single card's
   pre-activation lies within the state bound, 1e-5, of the kink at 0);
   (d) ``tools/bench_packed.py`` on the packed bench batch.  Printed: every leg's forward and step ms a rank (host clock, after
   a barrier) beside the single card's;
23. the user surface and the native host tier, on phase 19's 4,337
   molecules written as a TU dump (and 1,000 of them in arc focus as a
   saved ``GraphObject`` dataset): (a) ``native.available()`` (built in
   phase 1), each of the seven C++ functions bit for bit against its NumPy
   path on full-size inputs (the bench batch's strip builds and label sums,
   the 500k graph's arcs, the dump's files), and the host build seconds of
   the native path beside the NumPy path's for the bench batch, the 500k
   banded and band-384 builds and a sequencer build and rebuild of 1,000
   molecules (recorded, not claimed); (b) ``python -m gnnkeras_tpu_torch.cli``
   in subprocesses on the card: ``train`` (the default config: the
   flagship through the strip kernel, 2 epochs, ``--save``), ``train`` with
   an arc-focus config, ``evaluate``, ``predict`` against ``predict --device
   cpu`` (phase 4's bounds), ``export`` (the artifact's call against the
   saved model's forward), each run through ``cli.main`` in a ``python -c``
   wrapper that writes the process's kernel launches to its standard error,
   and rows 1/1b and 5-7 checked on the CLI's own batches (train's first
   batch, predict's test batch, the arc train's first batch);
   (c) ``train --parallel packed --parallel-devices 4`` (4 ranks sharing the
   card) and ``evaluate`` of its saved weights; (d) ``bench`` at full scale,
   alone on the card (its JSON line printed); (e) ``tools/starter.py``
   (GNN; its History and test logs against the same starter fitted on the
   CPU from the same initial weights, rtol 1e-4: six Adam steps carry the
   f32 sums' order), ``tools/starter_composite.py`` (CLGNN: finite logs;
   its random initial state is drawn on the card, so it is held to the
   JAX example in the CPU tests only) and ``tools/serve.py`` (Predictor
   through row 2, the artifact, one HTTP request; the served rows against
   the same Predictor on the CPU at phase 3's bound), 2 epochs each; (f) ``utils/profiling.trace`` around one eval forward in a
   subprocess, whose trace must name ``annotate``'s span and hold device
   kernels.

Then the phase times, one JSON line listing the kernels, the card line
again, and as the last line ``{"ok": true, "device": {...}}``.  The full log also goes to
``chiprun_out/chip_smoke.jsonl``.  Exits non-zero without a card.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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


def compiled(model, loss="categorical_crossentropy", **kw):
    """``model`` compiled with Adam at 0.01, ``loss`` and accuracy."""
    model.compile(optimizer="adam:0.01", loss=loss, metrics=["accuracy"], **kw)
    return model


def step_arrays(model, loss, grads=None):
    """A finished step's loss, gradients, parameters and moving statistics
    as NumPy, keyed as ``model.named_parameters()`` / ``named_buffers()``.
    ``grads``: the gradients where the parameters do not carry them whole
    (a tensor-parallel step's, gathered from the shards)."""
    out = {"loss": float(loss), "params": {n: p.detach().cpu().numpy() for n, p in model.named_parameters()},
           "buffers": {n: b.cpu().numpy() for n, b in model.named_buffers()}}
    out["grads"] = grads if grads is not None else {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    return out


def grad_tolerance_share(got, ref, grad_atol_rel):
    """The largest |g - g_ref| / (1e-4 |g_ref| + ``grad_atol_rel`` · the
    leaf's largest |g_ref|) over the gradients ``ref`` names: at most 1
    passes the gradient check of ``check_step``."""
    return max(float((np.abs(got[n] - g) / np.maximum(1e-4 * np.abs(g) + grad_atol_rel * float(np.abs(g).max()),
                                                      1e-45)).max())
               for n, g in ref.items())


def check_step(label, got, ref, grad_atol_rel=1e-6):
    """Phase 5's bounds between two Adam steps' ``step_arrays`` (``got``
    against ``ref``).  One step of f32 sums in other orders: the loss at
    rtol 1e-5; the gradients at rtol 1e-4, entries below ``grad_atol_rel``
    of their leaf's largest |g| held to that share of it; the updated
    parameters at rtol 1e-5 / atol 1e-6 where Adam's first step is not
    steep in g under that gradient error; the moving statistics at rtol
    1e-5 / atol 1e-6.  Returns the readings."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, err_msg=label)
    excluded, worst = 0, {}
    for n, g_ref in ref["grads"].items():
        g_abs = np.abs(g_ref)
        gmax = float(g_abs.max())
        np.testing.assert_allclose(got["grads"][n], g_ref, rtol=1e-4, atol=grad_atol_rel * gmax,
                                   err_msg=f"{label} {n}")
        worst[n] = float(np.abs(got["grads"][n] - g_ref).max() / max(gmax, 1e-30))
        # Adam's first step is lr·g/(|g| + eps) (lr 0.01, eps 1e-7), whose
        # slope in g is lr·eps/(|g| + eps)²: compare the updated parameters
        # where the gradient error the check above allows (a sign flip
        # included) moves the step by less than the parameters' atol
        g_err = 1e-4 * g_abs + grad_atol_rel * gmax
        live = 0.01 * 1e-7 * g_err / (np.maximum(g_abs - g_err, 0.0) + 1e-7) ** 2 < 1e-6
        excluded += int((~live).sum())
        np.testing.assert_allclose(got["params"][n][live], ref["params"][n][live], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{label} {n}")
    for n, b in ref["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, rtol=1e-5, atol=1e-6, err_msg=f"{label} {n}")
    return {"loss": got["loss"], "loss_reference": ref["loss"], "grad_max_rel_diff": worst,
            "grad_max_tolerance_share": grad_tolerance_share(got["grads"], ref["grads"], grad_atol_rel),
            "grad_atol_rel": grad_atol_rel, "adam_entries_excluded": excluded}


@contextlib.contextmanager
def selu_branches(record=None, pin=None):
    """The state nets' selu with its branch recorded or pinned, so that a
    step can be held to another engine's at phase 5's bounds.  selu has no
    derivative at 0 (slope 1.758 from the left, 1.051 from the right): a
    pre-activation within rounding of 0 takes one branch in one engine and
    the other in the other, and that row's gradient then moves by a
    share of the leaf that no sum order explains.  ``record``: a list that
    gets each call's ``x > 0`` (rows × units, NumPy; row-major engines).
    ``pin``: one such array a call, in order; call i takes that branch on
    the array's rows (the first rows of ``x``, row- or feature-major) and
    its own on the others, with the arithmetic of ``models.mlp``'s selu.
    Yields a dict: ``calls``, ``flips`` (pinned entries whose own branch
    differs) and ``flip_max_abs_x`` (the largest |x| among them)."""
    import torch
    from gnnkeras_tpu_torch.models import mlp

    base = mlp.ACTIVATIONS["selu"]
    pinned = iter(pin) if pin is not None else None
    seen = {"calls": 0, "flips": 0, "flip_max_abs_x": 0.0}

    def selu(x):
        seen["calls"] += 1
        if record is not None:
            record.append((x > 0).cpu().numpy())
        if pinned is None:
            return base(x)
        want = next(pinned, None)
        assert want is not None, f"selu call {seen['calls']} has no pinned branch ({len(pin)} given)"
        want = torch.as_tensor(want, device=x.device)
        fm = x.shape[1] != want.shape[1]  # feature-major (units, N)
        rows = (x.T if fm else x)[:want.shape[0]]
        flip = (rows > 0) != want
        if bool(flip.any()):
            seen["flips"] += int(flip.sum())
            seen["flip_max_abs_x"] = max(seen["flip_max_abs_x"], float(rows.detach()[flip].abs().max()))
        positive = (x.T if fm else x) > 0
        positive[:want.shape[0]] = want
        return mlp._SELU_SCALE * torch.where(positive.T if fm else positive, x, mlp._SELU_ALPHA * torch.expm1(x))

    mlp.ACTIVATIONS["selu"] = selu
    try:
        yield seen
    finally:
        mlp.ACTIVATIONS["selu"] = base
    assert pin is None or seen["calls"] == len(pin), (seen["calls"], len(pin))


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

    model, model_cpu = (compiled(make_model(dev), loss_fn, **(compile_kw or {})) for dev in ("cuda", "cpu"))
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    with widths or contextlib.nullcontext():
        logs, aux = train_step(model, b_gpu, model.next_rng())
        torch.cuda.synchronize()
    launches = expect_launches(**per_step)
    logs_cpu, aux_cpu = train_step(model_cpu, b_cpu, model_cpu.next_rng())

    # over ~139k nodes, the statistics and the gradients agree to rtol 1e-4
    ks, ks_cpu = as_layers(aux["k"], float), as_layers(aux_cpu["k"], float)
    assert ks == ks_cpu and (expect_k is None or set(ks) == {expect_k}), (ks, ks_cpu)
    k = ks[0] if len(ks) == 1 else ks
    ref = step_arrays(model_cpu, logs_cpu["loss_sum"] / logs_cpu["count"])
    step = check_step(label, step_arrays(model, logs["loss_sum"] / logs["count"]), ref, grad_atol_rel)
    for n, p in model.named_parameters():
        assert not np.array_equal(p.detach().cpu().numpy(), before[n].numpy()), n
    res = {"phase": phase, "batch": label, "storage": storage_of(b_gpu), "k": k, "loss_fn": loss_fn,
           "first_step_loss": step["loss"], "first_step_loss_cpu": step["loss_reference"],
           "launches_per_step": launches, "grad_max_rel_diff": step["grad_max_rel_diff"],
           "grad_atol_rel": grad_atol_rel, "grad_max_tolerance_share": step["grad_max_tolerance_share"],
           "adam_entries_excluded": step["adam_entries_excluded"], "card": card}
    if control is not None:
        bad = compiled(make_model("cuda"), loss_fn, **(compile_kw or {}))
        with control():
            train_step(bad, b_gpu, bad.next_rng())
        res["control_grad_max_tolerance_share"] = grad_tolerance_share(
            {n: p.grad.cpu().numpy() for n, p in bad.named_parameters()}, ref["grads"], grad_atol_rel)
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
# phases 18 and 20's starter CLGNN: the starter's widths, 3 of its 5 layers
# (fewer layers keep the whole script's time down; the widths are all kept)
CLGNN_LAYERS = 3


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
        family_serve("starter_clgnn", lambda dev: starter_clgnn(dev, seed=0, layers=CLGNN_LAYERS),
                     [composite_of(g) for g in sample], card)
        clgnn = starter_clgnn("cuda", seed=0, layers=CLGNN_LAYERS)
        clgnn_cpu = starter_clgnn("cpu", seed=0, layers=CLGNN_LAYERS)
        # no iteration is peeled at dim_state 10: one strip launch per iteration
        out["clgnn_fwd"] = family_forward("starter_clgnn", clgnn, clgnn_cpu, b_comp, b_comp_cpu, card,
                                          lambda ks: {"strip_matmul": sum(ks)}, n_arcs)
        # 3 layers × 5 aggregations; each layer's first reads its random state₀
        # gradients through 3 layers of 5 iterations: entries below 1e-4 of
        # their leaf's largest |g| are held to that share of it (PERF.md,
        # PR 11: phase 5's 1e-6 fails here), with the bf16 control
        out["clgnn_step"] = train_phase("starter_clgnn", lambda dev: starter_clgnn(dev, seed=0, layers=CLGNN_LAYERS),
                                        b_comp, b_comp_cpu, card,
                                        dict(strip_matmul=5 * CLGNN_LAYERS, strip_matmul_t=4 * CLGNN_LAYERS),
                                        out_rows=comp.num_graphs,
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
            # one step a batch: phase 20 drives the captured epoch
            history = model.fit(train_seq, epochs=3, validation_data=val_seq, callbacks=cbs, verbose=0,
                                scan_batches=False)
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
        histories = lgnn.fit(serial_seq, epochs=2, validation_data=serial_val, verbose=0, bake_batch_size=1000,
                             scan_batches=False)
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
    out["splits"] = (train_g, val_g, test_g)
    return out


# -- phase 20: the scanned epoch (a captured CUDA graph) --------------------------

def _kernel_of(name):
    """The kernel row a profiler event's name belongs to (None for others):
    the strip kernel's last template argument is its direction."""
    if "strip_kernel<" in name:
        args = name.split("strip_kernel<", 1)[1].split(">", 1)[0]
        return "strip_matmul_t" if args.replace(" ", "").endswith("true") else "strip_matmul"
    for kernel in ("incidence_select", "incidence_scatter"):
        if f"{kernel}_kernel" in name:
            return kernel
    return None


def device_windows(fns):
    """One ``torch.profiler`` session (CPU and CUDA activity) over the
    callables ``fns`` ({label: fn}) in turn, each window ending in a
    synchronise and opened by a marker kernel (``torch.cuda._sleep``):
    per label the host seconds of its window, its device-busy seconds (the
    kernels and copies between its marker and the next, in device order)
    and the launches of the port's kernels by row.  One session for all: a
    CUDA graph replayed in a later session of the same process crashed the
    profiler (segmentation fault) on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls, labels = {}, list(fns)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label in labels:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[label]()
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.events() if "CUDA" in str(getattr(ev, "device_type", ""))
               and not getattr(ev, "is_user_annotation", False)]
    on_card.sort(key=lambda ev: ev.time_range.start)
    out = {label: {"wall_s": walls[label], "busy_s": 0.0, "launches": {}} for label in labels}
    window = -1
    for ev in on_card:
        if "spin_kernel" in ev.name:
            window += 1
            continue
        if not 0 <= window < len(labels):
            continue
        res = out[labels[window]]
        res["busy_s"] += ev.time_range.elapsed_us() / 1e6
        kernel = _kernel_of(ev.name)
        if kernel is not None:
            res["launches"][kernel] = res["launches"].get(kernel, 0) + 1
    assert window == len(labels), f"{window} of {len(labels)} window markers seen"
    for res in out.values():
        res["busy_share"] = res["busy_s"] / res["wall_s"]
    return out


class capture_times:
    """Within it, every capture of a scanned epoch is timed
    (``(kind, seconds)``: its warm-up, capture and synchronise)."""

    def __enter__(self):
        from gnnkeras_tpu_torch.training import trainer as T

        self.times, self._cls, real = [], T._ScannedEpoch, T._ScannedEpoch._capture

        def capture(entry, model):
            t = time.perf_counter()
            real(entry, model)
            self.times.append(("train" if entry.train else "eval", time.perf_counter() - t))

        self._real, T._ScannedEpoch._capture = real, capture
        return self

    def __exit__(self, *exc):
        self._cls._capture = self._real
        return False


def scanned_leg(label, make_model, make_seqs, card, compile_kw, per_epoch, failures, ck_root, cpu_tol):
    """One model's scanned fit on the card (phase 20): 3 epochs with
    ``scan_batches=True`` (a captured CUDA graph replayed once an epoch)
    against the same fit one step a batch on the card (twice: are two
    per-step runs equal bit for bit?) and on the CPU.  Each fit validates
    on a sequencer of two batches (the captured evaluate in the scanned
    fit), halves its rate with ``ReduceLROnPlateau`` after epochs 1 and 2,
    restores its best validated weights with ``EarlyStopping`` and, in the
    scanned fit, writes a checkpoint every epoch; a new model resumed from
    epoch 1's checkpoint trains epoch 2 captured again.  Then one replay
    under the profiler (the port's kernels launched by the replay) against
    one per-step epoch.  ``per_epoch``: the kernels' launches of one epoch
    (one replay).  ``cpu_tol``: the bounds against the CPU's fit (``loss``:
    rtol of the losses, ``accuracy``: atol of the accuracies, ``state``:
    (rtol, atol) of the parameters and statistics), which the bf16 control
    must fail.  Checks append to ``failures``; returns the leg's record, its
    training sequencer and what the section profiles."""
    import shutil

    import torch
    import gnnkeras_tpu_torch.models.gnn as G
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.training.callbacks import EarlyStopping, LambdaCallback, ReduceLROnPlateau
    from gnnkeras_tpu_torch.training.optimizers import current_learning_rate
    from gnnkeras_tpu_torch.training.trainer import train_step

    real_initial_state = G.initial_state
    card_streams = {}

    def card_draw(n, ds, generator, device):
        # the CPU fit draws its dim_state > 0 initial states as the card does
        # from the same seed (a CPU generator's draws differ from a card's):
        # a card generator of that seed for each CPU generator, whose stream
        # the layers of a stack continue
        key = id(generator)
        if key not in card_streams:
            card_streams[key] = (generator, torch.Generator(device="cuda").manual_seed(generator.initial_seed()))
        return real_initial_state(n, ds, card_streams[key][1], "cuda").to(device)

    def fit(device, scan, epochs=3, resume_from=None, control=None, checkpoint_dir=None):
        model = make_model(device)
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"], **compile_kw)
        train, valid = make_seqs(device)
        rec = {"ends": [], "snaps": []}
        cbs = [LambdaCallback(on_train_begin=lambda logs: rec["ends"].append(time.perf_counter()),
                              on_epoch_end=lambda e, logs: (rec["ends"].append(time.perf_counter()),
                                                            rec["snaps"].append({k: v.detach().cpu().clone() for k, v
                                                                                 in model.state_dict().items()})))]
        kw = dict(epochs=epochs, verbose=0, scan_batches=scan)
        np.random.seed(500)
        if resume_from is None:
            cbs += [ReduceLROnPlateau(monitor="loss", mode="max", patience=0, factor=0.5),
                    EarlyStopping(monitor="val_loss", patience=5, restore_best_weights=True)]
            kw.update(validation_data=valid, checkpoint_dir=checkpoint_dir)
        else:
            for _ in range(2):  # NumPy's shuffles of epochs 0 and 1: epoch 2's batches
                train.on_epoch_end()
            train.wait_for_rebuild()
            kw.update(checkpoint_dir=resume_from, resume=True)
        G.initial_state = card_draw if device == "cpu" else real_initial_state
        kernels.reset_launches()
        try:
            with warnings.catch_warnings(), control or contextlib.nullcontext():
                warnings.simplefilter("ignore", RuntimeWarning)  # the rebuilds' bf16 fallback (parallel arcs)
                history = model.fit(train, callbacks=cbs, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            G.initial_state = real_initial_state
        rec.update(model=model, history=history.history, epoch_s=list(np.diff(rec["ends"])), train=train,
                   launches={k: v for k, v in kernels.LAUNCHES.items() if v})
        return rec

    def share(a, b, rtol, atol):
        return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())

    def state_shares(a, b, rtol, atol):
        return max(share(x.cpu().numpy(), y.cpu().numpy(), rtol, atol)
                   for x, y in zip(a.state_dict().values(), b.state_dict().values()))

    def check(ok, what):
        if not ok:
            failures.append(f"{label}: {what}")

    t0 = time.perf_counter()
    with capture_times() as captures:
        cap = fit("cuda", True, checkpoint_dir=os.path.join(ck_root, label))
    cap_s = time.perf_counter() - t0
    entry = next(iter(cap["model"]._scan["train"].values()))
    # a capture for epoch 0 and again only where a rebuild grew the pads
    train_captures = [t for kind, t in captures.times if kind == "train"]
    check(entry.graph is not None and 1 <= len(train_captures) <= 3, f"training captures {train_captures}")
    step, step2 = fit("cuda", False), fit("cuda", False)
    deterministic = step["history"] == step2["history"] and all(
        torch.equal(a, b) for a, b in zip(step["model"].state_dict().values(), step2["model"].state_dict().values()))
    t0 = time.perf_counter()
    cpu = fit("cpu", False)
    cpu_s = time.perf_counter() - t0
    res = {"phase": "scanned_epoch", "model": label, "batches": len(cap["train"]),
           "graphs_per_batch": cap["train"].batch_size, "epochs": 3,
           "launches_at_capture": cap["launches"], "launches_per_step_fit": step["launches"],
           "captures_s": captures.times, "epoch_s_captured": cap["epoch_s"], "epoch_s_per_step": step["epoch_s"],
           "epoch_s_per_step_again": step2["epoch_s"], "fit_s_captured": cap_s, "fit_s_cpu": cpu_s,
           "per_step_runs_bit_equal": deterministic, "history_captured": cap["history"]}
    # the captured fit against the per-step fit on the card: bit for bit
    # where two per-step runs agree bit for bit
    hist_share = max(share(np.array(cap["history"][k]), np.array(step["history"][k]), 1e-5, 0.0)
                     for k in step["history"])
    res["vs_per_step"] = {"history_share": hist_share,
                          "state_share": state_shares(cap["model"], step["model"], 1e-5, 1e-6),
                          "state_max_abs_diff": max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(
                              cap["model"].state_dict().values(), step["model"].state_dict().values())),
                          "bit_equal": cap["history"] == step["history"] and all(
                              torch.equal(a, b) for a, b in zip(cap["model"].state_dict().values(),
                                                                step["model"].state_dict().values()))}
    if deterministic:
        check(res["vs_per_step"]["bit_equal"], "captured fit not bit for bit the per-step fit")
    check(hist_share <= 1.0 and res["vs_per_step"]["state_share"] <= 1.0, "captured fit vs per-step fit")
    # the captured fit against the CPU's per-step fit, and a control fit on
    # the card whose aggregations read bf16-rounded states
    bad = fit("cuda", True, control=bf16_aggregation())

    def worst(run):
        """The state entry farthest from the CPU's."""
        name, (a, b) = max(((k, (v.cpu().numpy(), cpu["model"].state_dict()[k].numpy()))
                            for k, v in run["model"].state_dict().items()),
                           key=lambda kv: float(np.abs(kv[1][0] - kv[1][1]).max()))
        i = int(np.argmax(np.abs(a - b)))
        return {"name": name, "card": float(a.flat[i]), "cpu": float(b.flat[i]), "leaf_max": float(np.abs(b).max())}

    def vs_cpu(run):
        losses = [k for k in cpu["history"] if k.endswith("loss")]
        accuracies = [k for k in cpu["history"] if k.endswith("accuracy")]
        return {"worst": worst(run),
                "loss_share": max(share(np.array(run["history"][k]), np.array(cpu["history"][k]), cpu_tol["loss"],
                                        0.0) for k in losses),
                "accuracy_max_abs_diff": max(float(np.abs(np.array(run["history"][k]) - cpu["history"][k]).max())
                                             for k in accuracies),
                "state_share": state_shares(run["model"], cpu["model"], *cpu_tol["state"]),
                "state_share_phase5": state_shares(run["model"], cpu["model"], 1e-5, 1e-6),
                "state_max_abs_diff": max(float((a.cpu() - b).abs().max()) for a, b in zip(
                    run["model"].state_dict().values(), cpu["model"].state_dict().values()))}

    res["vs_cpu"], res["control_vs_cpu"], res["cpu_tolerance"] = vs_cpu(cap), vs_cpu(bad), cpu_tol
    res["history_cpu"], res["history_control"] = cpu["history"], bad["history"]
    check(res["vs_cpu"]["loss_share"] <= 1.0, "losses against the CPU's")
    check(res["vs_cpu"]["accuracy_max_abs_diff"] <= cpu_tol["accuracy"], "accuracies against the CPU's")
    check(res["vs_cpu"]["state_share"] <= 1.0, "state against the CPU's")
    check(res["control_vs_cpu"]["state_share"] > 1.0, "the bf16 control passed the state bound")
    # ReduceLROnPlateau fired after epochs 1 and 2 (max mode: the loss falls)
    lrs = [current_learning_rate(r["model"]._opt) for r in (cap, step, cpu)]
    res["final_learning_rate"] = lrs
    check(all(abs(lr - 0.0025) < 1e-9 for lr in lrs), f"learning rates {lrs}")
    # EarlyStopping restored the best validated epoch's weights
    best = int(np.argmin(cap["history"]["val_loss"]))
    res["best_epoch"] = best
    check(all(torch.equal(v.cpu(), cap["snaps"][best][k]) for k, v in cap["model"].state_dict().items()),
          "EarlyStopping did not restore the best epoch's weights")
    # a resume from the captured fit's epoch-1 checkpoint: epoch 2 again
    resume_dir = os.path.join(ck_root, label + "_resume")
    shutil.copytree(os.path.join(ck_root, label), resume_dir)
    for name in ("ckpt_2.pt", "extra_2.json"):
        os.unlink(os.path.join(resume_dir, name))
    resumed = fit("cuda", True, resume_from=resume_dir)
    res["resume"] = {"loss": resumed["history"]["loss"], "loss_uninterrupted": cap["history"]["loss"][2:],
                     "state_share": max(share(v.cpu().numpy(), cap["snaps"][2][k].numpy(), 1e-5, 1e-6)
                                        for k, v in resumed["model"].state_dict().items()),
                     "bit_equal": all(torch.equal(v.cpu(), cap["snaps"][2][k])
                                      for k, v in resumed["model"].state_dict().items())}
    check(len(resumed["history"]["loss"]) == 1, "the resume ran one epoch")
    if deterministic:
        check(res["resume"]["bit_equal"] and resumed["history"]["loss"] == cap["history"]["loss"][2:],
              "resumed epoch 2 not bit for bit the uninterrupted one")
    check(res["resume"]["state_share"] <= 1.0, "resumed epoch 2 against the uninterrupted one")
    # what the section profiles: one replay against one per-step epoch
    model_s = step["model"]
    batches = [step["train"][i] for i in range(len(step["train"]))]

    def per_step_epoch():
        kernels.reset_launches()
        for b in batches:
            train_step(model_s, b, model_s.next_rng())
        res["per_step_launches_counted"] = {k: v for k, v in kernels.LAUNCHES.items() if v}

    res["per_epoch_expected"], res["card"] = per_epoch, card
    keep = (cap, step, step2, cpu, bad, resumed)  # alive until the section's profiler window
    return res, cap["train"], {"replay": entry.graph.replay, "per_step_epoch": per_step_epoch, "keep": keep}


def scanned_epoch_section(card, splits):
    """Phase 20 (module docstring).  ``splits``: phase 19's (train, val,
    test) molecules.  Returns the legs' records and the kernel checks of the
    kernels line; raises after its last line when a check failed."""
    import tempfile

    from gnnkeras_tpu_torch.data import CompositeMultiGraphSequencer, MultiGraphSequencer
    from gnnkeras_tpu_torch.data.synthetic import arc_gnn, composite_of, flagship_gnn, starter_clgnn

    train_g, val_g, _ = splits
    small = train_g[:1000]  # the CLGNN and the arc GNN: 2 batches of 500 an epoch
    ck_root = tempfile.mkdtemp(dir=os.path.join(REPO, "gnnkeras_tpu_torch", "_build"))

    def seqs(cls, train, valid, focus, batch_size):
        def make(device):
            kw = dict(slot_pack=128, strip_dtype="int8", device=device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: the bf16 latch
                return (cls(train, focus, "average", batch_size=batch_size, **kw),
                        cls(valid, focus, "average", batch_size=375, shuffle=False, **kw))
        return make

    failures, out, trains, probes = [], {"checks": {}}, {}, {}
    # against the CPU's fit after 9 (6) Adam steps: the flagship's and the arc
    # GNN's losses at phase 5's rtol 1e-5, their state at phase 14's rtol
    # 1e-5 / atol 1e-5 (phase 5's atol 1e-6 gives share 4.95: Adam's
    # lr·g/(|g| + eps) magnifies f32 noise in a small gradient); the CLGNN's
    # losses at rtol 5e-3, its accuracies within 2 of 500 graphs and its
    # state at atol 5e-3 (a layer-1 BatchNorm gamma with a near-zero
    # gradient ends 1.7e-3 from the CPU's, PERF.md PR 13); each with the
    # bf16-aggregation control that must fail it
    tight = dict(loss=1e-5, accuracy=0.0, state=(1e-5, 1e-5))
    out["flagship"], trains["flagship"], probes["flagship"] = scanned_leg(
        "flagship", lambda dev: flagship_gnn(dev, seed=0), seqs(MultiGraphSequencer, train_g, val_g, "g", 1000),
        card, {}, dict(strip_matmul=3 * 4, strip_matmul_t=3 * 4), failures, ck_root, tight)
    out["clgnn"], trains["clgnn"], probes["clgnn"] = scanned_leg(
        "starter_clgnn", lambda dev: starter_clgnn(dev, seed=0, layers=CLGNN_LAYERS),
        seqs(CompositeMultiGraphSequencer, [composite_of(g) for g in small], [composite_of(g) for g in val_g], "g",
             500),
        card, dict(training_mode="parallel", average_st_grads=True),
        dict(strip_matmul=2 * 5 * CLGNN_LAYERS, strip_matmul_t=2 * 4 * CLGNN_LAYERS), failures, ck_root,
        dict(loss=5e-3, accuracy=2 / 500, state=(0.0, 5e-3)))
    out["arc"], trains["arc"], probes["arc"] = scanned_leg(
        "arc", lambda dev: arc_gnn(dev, seed=0),
        seqs(MultiGraphSequencer, as_arc_focus(small, seed=21), as_arc_focus(val_g, seed=22), "a", 500),
        card, {}, dict(strip_matmul=2 * 4, strip_matmul_t=2 * 4, incidence_select=2, incidence_scatter=2),
        failures, ck_root, tight)
    # one profiler window a replay and a per-step epoch of each leg
    windows = device_windows({f"{leg}:{kind}": probe[kind] for leg, probe in probes.items()
                              for kind in ("replay", "per_step_epoch")})
    for leg, res in out.items():
        if leg == "checks":
            continue
        res["replay"], res["per_step_epoch"] = windows[f"{leg}:replay"], windows[f"{leg}:per_step_epoch"]
        want = res["per_epoch_expected"]
        for kind in ("replay", "per_step_epoch"):
            if res[kind]["launches"] != want:
                failures.append(f"{leg}: {kind} launches {res[kind]['launches']} != {want}")
        if res["per_step_launches_counted"] != want:
            failures.append(f"{leg}: per-step epoch counted {res['per_step_launches_counted']} != {want}")
        emit(res)
    del probes
    # the kernels at the legs' own operators and widths (a batch of each
    # leg's sequencer; d 16: the flagship's and the CLGNN's padded state)
    for leg, train in trains.items():
        for name in ("strip_matmul", "strip_matmul_t"):
            out["checks"][(leg, name)] = check_strip(train[0].strip, f"scanned_{leg}_batch", timed=True, name=name,
                                                     d=16)
    arc_batch = trains["arc"][0]
    out["checks"]["incidence_select"], out["checks"]["incidence_scatter"] = check_incidence(
        arc_batch.arc_inc, arc_batch.arc_src.cpu().numpy(), arc_batch.arc_dst.cpu().numpy(),
        "scanned_arc_batch", timed=True)
    del trains
    emit({"phase": "scanned_epoch_checks", "failures": failures, "card": card})
    assert not failures, failures
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


def _partition_rank(rank, world, shard, halo_rows, ck):
    """Phase 17 on one rank (a spawned process on the card): the ring kernel
    against its plain version at the halo's and the full state's shape, the
    large-graph model's forward through both transports and one Adam step
    through ``collective``, each with its launches counted from 0 and host
    times; then phase 20's partitioned fits (``_partitioned_fits``, their
    checkpoints under ``ck``).  Returns NumPy results for the parent to
    compare."""
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
    res["fit"] = _partitioned_fits(dev, shard, ck)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def _partitioned_fits(dev, shard, ck):
    """Phase 20's partitioned fits on one rank (``steps_per_launch=2``):
    3 epochs validated on the training shard with ``EarlyStopping``
    restoring the best validated epoch (validation forces chunks of one
    epoch); 3 epochs checkpointed every 2 (chunks of 2: the first chunk
    lands on the boundary, the last epoch saves); 2 epochs checkpointed,
    then resumed to 3.  Rank 0 writes the checkpoints into ``ck``."""
    import torch
    from gnnkeras_tpu_torch.data.synthetic import large_graph_gnn
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.training.callbacks import EarlyStopping, LambdaCallback
    from gnnkeras_tpu_torch.training.checkpoint import CheckpointManager

    def state(model):
        return {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()}

    def fit(callbacks=None, **kw):
        model = large_graph_gnn(dev, seed=0)
        model.compile(optimizer="adam:0.01", loss="mse", metrics=["mse"])
        t = time.perf_counter()
        history = PartitionedGNN(model).fit(shard, verbose=0, steps_per_launch=2,
                                            callbacks=callbacks(model) if callbacks else None, **kw)
        torch.cuda.synchronize()
        return model, history.history, time.perf_counter() - t

    snaps = []
    validated_model, validated, validated_s = fit(
        lambda m: [LambdaCallback(on_epoch_end=lambda e, logs: snaps.append(state(m))),
                   EarlyStopping(monitor="val_loss", patience=5, restore_best_weights=True)],
        epochs=3, validation_data=shard)
    best = int(np.argmin(validated["val_loss"]))
    whole, whole_h, whole_s = fit(epochs=3, checkpoint_dir=os.path.join(ck, "whole"), checkpoint_every=2)
    fit(epochs=2, checkpoint_dir=os.path.join(ck, "resume"))
    resumed, resumed_h, _ = fit(epochs=3, checkpoint_dir=os.path.join(ck, "resume"), resume=True)
    return {"validated": validated, "validated_s": validated_s, "best_epoch": best,
            "restored_best": all(np.array_equal(v, snaps[best][k]) for k, v in state(validated_model).items()),
            "validated_state": state(validated_model), "whole": whole_h, "whole_s": whole_s,
            "whole_steps": CheckpointManager(os.path.join(ck, "whole")).all_steps(),
            "resumed": resumed_h, "whole_state": state(whole), "resumed_state": state(resumed)}


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
    ref_step = step_arrays(model, logs_ref["loss_sum"] / logs_ref["count"])
    del model
    torch.cuda.empty_cache()

    ck = tempfile.mkdtemp(dir=os.path.join(REPO, "gnnkeras_tpu_torch", "_build"))
    t0 = time.perf_counter()
    ranks = spawn(_partition_rank, PARTS, [(pg.shard(r, "cpu"), halo_rows, ck) for r in range(PARTS)], threads=2,
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
    assert all(r["step"]["k"] == 5.0 for r in ranks)
    steps = [check_step(f"partitioned step rank {r['rank']}", r["step"], ref_step, grad_atol_rel=1e-4)
             for r in ranks]
    worst = {nm: max(st["grad_max_rel_diff"][nm] for st in steps) for nm in ref_step["grads"]}
    excluded = sum(st["adam_entries_excluded"] for st in steps)
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
          "step_loss": ranks[0]["step"]["loss"], "step_loss_single_device": ref_step["loss"],
          "grad_max_rel_diff": worst, "adam_entries_excluded": excluded, "card": card})
    out["fit"] = partitioned_fit_checks(ranks, card)
    return out


def partitioned_fit_checks(ranks, card):
    """Phase 20's partitioned fits (``_partitioned_fits``) across the ranks:
    every rank's logs and weights equal (every rank takes rank 0's logs and,
    after a restore or a callback's change, its weights); the validated fit
    ends on its best validated epoch's weights; the checkpoints land where
    the chunks cross the boundary and at the end; the resumed run ends where
    the uninterrupted one ends (bit for bit)."""
    fits = [r["fit"] for r in ranks]
    first = fits[0]
    for f in fits[1:]:
        for key in ("validated", "whole", "resumed", "whole_steps", "best_epoch"):
            assert f[key] == first[key], key
        for key in ("validated_state", "whole_state", "resumed_state"):
            for name, value in first[key].items():
                np.testing.assert_array_equal(f[key][name], value, err_msg=f"{key} {name}")
    assert all(f["restored_best"] for f in fits)
    assert len(first["validated"]["val_loss"]) == 3 and np.isfinite(first["validated"]["val_loss"]).all()
    assert first["whole_steps"] == [1, 2], first["whole_steps"]
    assert first["resumed"]["loss"] == first["whole"]["loss"][2:], (first["resumed"], first["whole"])
    for name, value in first["whole_state"].items():
        np.testing.assert_array_equal(first["resumed_state"][name], value, err_msg=name)
    res = {"phase": "partitioned_fit", "parts": PARTS, "steps_per_launch": 2, "validated": first["validated"],
           "best_epoch": first["best_epoch"], "validated_fit_s": [f["validated_s"] for f in fits],
           "checkpointed": first["whole"], "checkpointed_fit_s": [f["whole_s"] for f in fits],
           "checkpoint_steps": first["whole_steps"], "resumed": first["resumed"], "card": card}
    emit(res)
    return res


# -- phase 21: data-parallel, packed, tensor-parallel and hybrid training ----------------

DIST_RANKS = 4  # phase 21's ranks, all on the one card


def packed_positions(g):
    """The batch row of each node of the merged graph-focused ``g`` under
    slot-128 packing (as ``from_graph_object(slot_pack=128)`` places them)."""
    from gnnkeras_tpu_torch.graph.packing import pack_slots, positions_from_starts

    sizes = np.bincount(g.graph_of_node.astype(np.int64), minlength=max(g.num_graphs, 1))
    starts, _ = pack_slots(sizes, slot=128, tile=128)
    return positions_from_starts(g.graph_of_node, starts)


def tp_step_grads(tp, local, gnn):
    """A tensor-parallel step's gradients, keyed as ``gnn``'s parameters:
    the state net's gathered from the shards over ``tp``'s group
    (``gather_variables`` on each shard's gradients), the output net's as
    the step left them (summed over the group).  A collective."""
    import torch.distributed as tdist

    mine = {**{n: v.detach().cpu() for n, v in local.state_dict().items()},
            **{n: p.grad.cpu() for n, p in local.named_parameters()}}
    shards = [None] * tdist.get_world_size(tp.group)
    tdist.all_gather_object(shards, mine, group=tp.group)
    full = tp.gather_variables(shards)
    grads = {f"net_state.{n}": full[n].numpy() for n, _ in gnn.net_state.named_parameters()}
    grads.update({f"net_output.{n}": p.grad.cpu().numpy() for n, p in gnn.net_output.named_parameters()})
    return grads


def _timed(fn, reps=5):
    """Median host ms of ``fn`` (the ranks meet at a barrier first)."""
    import torch

    ts = []
    for _ in range(reps):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts)), ts


def _launched():
    from gnnkeras_tpu_torch import kernels

    return {name: n for name, n in kernels.LAUNCHES.items() if n}


def _dist_rank(rank, world, inp, ck):
    """Phase 21 on one rank (a spawned process on the card): a-e of
    ``distributed_section``, each with its launches counted from 0.  Returns
    NumPy results for the parent to compare."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data import MultiGraphSequencer
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, flagship_lgnn, large_graph_gnn
    from gnnkeras_tpu_torch.parallel.data_parallel import DataParallelTrainer, make_dp_train_step
    from gnnkeras_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh, rank_device, rank_generator
    from gnnkeras_tpu_torch.parallel.multihost import make_multihost_mesh
    from gnnkeras_tpu_torch.parallel.packed import PackedPartitionedGNN, PackedPartitionedLGNN
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.parallel.tensor_parallel import TensorParallelGNN

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    res = {"rank": rank, "leg_s": {}}
    t_leg = time.perf_counter()

    def leg_done(name):
        nonlocal t_leg
        res["leg_s"][name] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

    # -- a. the packed flagship ---------------------------------------------------
    batch = inp["packed"].to(dev)
    engine = PackedPartitionedGNN(compiled(flagship_gnn(dev, seed=0)))
    kernels.reset_launches()
    k, state, out, _, _ = engine.forward(batch)
    torch.cuda.synchronize()
    res["packed_fwd"] = {"k": float(k), "state": state.cpu().numpy(), "out": out.cpu().numpy(),
                         "launches": _launched()}
    kernels.reset_launches()
    logs = engine.train_step(batch)
    torch.cuda.synchronize()
    res["packed_step"] = {**step_arrays(engine.gnn, logs["loss"]), "k": float(logs["k"]), "launches": _launched()}
    res["packed_fwd"]["forward_ms"], res["packed_fwd"]["forward_ms_all"] = _timed(lambda: engine.forward(batch))
    res["packed_step"]["train_step_ms"], res["packed_step"]["train_step_ms_all"] = _timed(
        lambda: engine.train_step(batch))
    leg_done("packed")

    # -- b. the packed 3-layer LGNN (residual) -------------------------------------
    def lgnn():
        return compiled(flagship_lgnn(dev, seed=0, layers=3), training_mode="residual", average_st_grads=True)

    engine = PackedPartitionedLGNN(lgnn())
    kernels.reset_launches()
    with strip_widths() as widths:
        ks, states, outs, _, _ = engine.forward(batch)
        torch.cuda.synchronize()
    res["lgnn_fwd"] = {"k": [float(x) for x in ks], "states": [s.cpu().numpy() for s in states],
                       "outs": [o.cpu().numpy() for o in outs], "launches": _launched(), "widths": widths.tally}
    with bf16_aggregation():
        _, states, outs, _, _ = engine.forward(batch)
    res["lgnn_fwd"]["control"] = {"states": [s.cpu().numpy() for s in states], "outs": [o.cpu().numpy() for o in outs]}
    kernels.reset_launches()
    with strip_widths() as widths:
        logs = engine.train_step(batch)
        torch.cuda.synchronize()
    res["lgnn_step"] = {**step_arrays(engine.gnn, logs["loss"]), "launches": _launched(), "widths": widths.tally}
    res["lgnn_step"]["train_step_ms"], _ = _timed(lambda: engine.train_step(batch), reps=3)
    bad = PackedPartitionedLGNN(lgnn())
    with bf16_aggregation():
        bad.train_step(batch)
    res["lgnn_step"]["control_grads"] = {n: p.grad.cpu().numpy() for n, p in bad.gnn.named_parameters()}
    del engine, bad, batch
    leg_done("packed_lgnn")

    # -- c. data parallelism over phase 19's sequencer ------------------------------
    train_g, val_g = inp["dp_graphs"]
    seq_kw = dict(batch_size=1000, slot_pack=128, strip_dtype="int8", device=dev)

    def sequencer(graphs, shuffle=True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: the bf16 latch
            return MultiGraphSequencer(graphs, "g", "average", shuffle=shuffle, **seq_kw)

    model = compiled(flagship_gnn(dev, seed=0))
    trainer = DataParallelTrainer(model)
    seq, val = sequencer(train_g), sequencer(val_g, shuffle=False)
    batch, weight = trainer.rank_batches(seq)[0]
    kernels.reset_launches()
    logs = make_dp_train_step(model)(batch, weight, rank_generator(model, trainer.rank))
    torch.cuda.synchronize()
    res["dp_step"] = {**step_arrays(model, logs["loss_sum"] / logs["count"]), "weight": weight,
                      "launches": _launched()}

    def dp_fit(seq, **kw):
        m = compiled(flagship_gnn(dev, seed=0))
        t = time.perf_counter()
        history = DataParallelTrainer(m).fit(seq, verbose=0, **kw).history
        torch.cuda.synchronize()
        return {"history": history, "state": {n: v.cpu().numpy() for n, v in m.state_dict().items()},
                "s": time.perf_counter() - t}

    np.random.seed(0)
    kernels.reset_launches()
    # ``seq`` has served only its epoch-0 batches (no shuffle yet): the whole fit starts from them
    res["dp_fit"] = dp_fit(seq, epochs=2, validation_data=val, checkpoint_dir=os.path.join(ck, "dp_whole"))
    res["dp_fit"]["launches"] = _launched()
    np.random.seed(0)
    resumed = sequencer(train_g)  # one sequencer for both legs: its epoch-1 order is the whole fit's
    dp_fit(resumed, epochs=1, checkpoint_dir=os.path.join(ck, "dp_resume"))
    res["dp_resumed"] = dp_fit(resumed, epochs=2, checkpoint_dir=os.path.join(ck, "dp_resume"), resume=True)
    del seq, val, resumed, model, trainer
    leg_done("data_parallel")

    # -- d. tensor parallelism over the model's 14 state features ---------------------
    bench = inp["bench"].to(dev)
    engine = TensorParallelGNN(compiled(flagship_gnn(dev, seed=0)))
    kernels.reset_launches()
    k, _, out = engine.forward(bench)
    torch.cuda.synchronize()
    res["tp_fwd"] = {"k": float(k), "out": out.cpu().numpy(), "launches": _launched()}
    kernels.reset_launches()
    logs = engine.train_step(bench)
    torch.cuda.synchronize()
    launches = _launched()
    res["tp_local"] = {n: tuple(p.shape) for n, p in engine.local.named_parameters()}
    grads = tp_step_grads(engine.tp_state, engine.local, engine.gnn)
    engine.gather_into_model()
    res["tp_step"] = {**step_arrays(engine.gnn, logs["loss"], grads), "launches": launches}
    res["tp_fwd"]["forward_ms"], _ = _timed(lambda: engine.forward(bench))
    del engine, bench
    leg_done("tensor_parallel")

    # -- e. hybrid data × graph (× model), and the multi-host mesh ---------------------
    two = make_mesh(("data", "graph"), (2, 2))
    shard = inp["hybrid2"].to(dev)

    def hybrid(mesh, shard, **kw):
        model = compiled(large_graph_gnn(dev, seed=0), loss="mse")
        groups = {"model_group": mesh.group("model")} if kw else {}
        engine = PartitionedGNN(model, mesh.group("graph"), **kw, **groups)
        step = make_hybrid_train_step(engine, mesh)
        kernels.reset_launches()
        with strip_widths() as widths:
            logs = step(shard)
            torch.cuda.synchronize()
        launches = _launched()
        grads = None
        if kw:
            grads = tp_step_grads(engine.tp_state, engine.tp_local, model)
            engine.gather_tp_into_model()
        out = {**step_arrays(model, logs["loss"], grads), "launches": launches, "widths": widths.tally}
        out["train_step_ms"], _ = _timed(lambda: step(shard), reps=3)
        return out, engine

    res["hybrid2"], _ = hybrid(two, shard)
    three = make_mesh(("data", "graph", "model"), (1, 2, 2))
    res["hybrid3"], engine = hybrid(three, inp["hybrid3"].to(dev), tp_shards=2)
    res["hybrid3"]["local"] = {n: tuple(p.shape) for n, p in engine.tp_local.named_parameters()}
    os.environ.update(inp["host_env"])
    host_mesh = make_multihost_mesh(2, 2)
    res["multihost"] = {"shape": host_mesh.shape, "coords": host_mesh.coords}
    res["multihost"].update(hybrid(host_mesh, shard)[0])
    leg_done("hybrid")
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def distributed_section(card, bench, b_bench, b_bench_cpu, g_large, b_large):
    """Phase 21 (module docstring): the references on the single card, the
    4 ranks (``_dist_rank``) and every check against them.  Returns what
    the kernels line reads."""
    import dataclasses

    import torch
    from gnnkeras_tpu_torch.data import MultiGraphSequencer, dataset_splits
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, flagship_lgnn, large_graph_gnn, random_molecules
    from gnnkeras_tpu_torch.parallel.launch import spawn
    from gnnkeras_tpu_torch.parallel.multihost import comm_volume
    from gnnkeras_tpu_torch.parallel.packed import partition_packed, split_merged_by_graph
    from gnnkeras_tpu_torch.parallel.partition import partition_graph
    from gnnkeras_tpu_torch.tools.multihost_sim import host_env
    from gnnkeras_tpu_torch.training.trainer import _load_bn_state, _objective, _optimizer, train_step

    out, t0 = {}, time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strips, as in JAX
        parts, meta = partition_packed(bench, DIST_RANKS, slot_pack=128, strip_dtype="int8", device="cpu")
    packed_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = partition_graph(g_large, 2, dense_blocks=True, agg_dtype="auto")
    hybrid_build_s = time.perf_counter() - t0
    emit({"phase": "distributed_inputs", "packed_build_s": packed_build_s, "hybrid_partition_build_s": hybrid_build_s,
          "packed_tiles": parts[0].num_nodes // 128, "packed_graphs": [len(ids) for ids in meta.groups],
          "packed_strip_storage": str(parts[0].strip.strip.dtype).replace("torch.", ""),
          "hybrid_nodes_per_part": pg.nodes_per_part, "hybrid_offsets": list(pg.local_ops[0].offsets)})
    # rows 1/1b on the ranks' own operators at the widths the ranks launch
    # them: packed part 0 at the flagship's d 16 and the 3-layer LGNN's 32
    # and 48; hybrid part 0's local main diagonal at the large model's d 8
    part0 = parts[0].strip.to("cuda")
    out["checks"] = {(d, name): check_strip(part0, "packed_part_0", timed=True, name=name, d=d)
                     for d in (16, 32, 48) for name in ("strip_matmul", "strip_matmul_t")}
    local0 = pg.local_ops[0]
    diag0 = local0.diags[list(local0.offsets).index(0)].to("cuda")
    out["hybrid_checks"] = {name: check_strip(diag0, "hybrid_part_0_diagonal_0", timed=True, name=name, d=8)
                            for name in ("strip_matmul", "strip_matmul_t")}
    del part0, diag0

    # -- the single card's references ---------------------------------------------------
    model = flagship_gnn("cuda", seed=0)
    k, state, o, _, _ = model.forward(b_bench)
    ref_fwd = {"k": float(k), "state": state.cpu().numpy(), "out": o.cpu().numpy()[b_bench.host_pred_rows]}
    model = compiled(model)
    logs, _ = train_step(model, b_bench, model.next_rng())
    ref_step = step_arrays(model, logs["loss_sum"] / logs["count"])
    lgnn = flagship_lgnn("cuda", seed=0, layers=3)
    ks, states, outs, _, _ = lgnn.forward(b_bench)
    ref_lgnn = {"k": [float(x) for x in ks], "states": [s.cpu().numpy() for s in states],
                "outs": [o.cpu().numpy()[b_bench.host_pred_rows] for o in outs]}
    lgnn = compiled(lgnn, training_mode="residual", average_st_grads=True)
    logs, _ = train_step(lgnn, b_bench, lgnn.next_rng())
    ref_lgnn_step = step_arrays(lgnn, logs["loss_sum"] / logs["count"])
    del model, lgnn

    # data parallelism: one Adam step on the mean of phase 19's three batches
    train_g, _, val_g = dataset_splits(random_molecules(4337, seed=0, min_nodes=5, max_nodes=56), seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        seq = MultiGraphSequencer(train_g, "g", "average", batch_size=1000, slot_pack=128, strip_dtype="int8",
                                  device="cuda")
    assert len(seq) == 3

    def averaged_step(model, batches):
        """One optimizer step on the mean of ``batches``' gradients and new
        moving statistics, and the mean of their losses."""
        grads, stats, losses = [], [], []
        for b in batches:
            model.zero_grad(set_to_none=True)
            loss, aux = _objective(model, b, model.next_rng(), training=True)
            loss.backward()
            grads.append([p.grad.clone() for p in model.parameters()])
            stats.append(aux["new_state"])
            losses.append(loss.detach())
        for p, *gs in zip(model.parameters(), *grads):
            p.grad = sum(gs) / len(gs)
        _optimizer(model).step()
        _load_bn_state(model, {key: sum(s[key] for s in stats) / len(stats) for key in stats[0]})
        return step_arrays(model, sum(losses) / len(losses))

    ref_dp = averaged_step(compiled(flagship_gnn("cuda", seed=0)), [seq[i] for i in range(3)])
    del seq

    # hybrid: replica 1 is the large graph with a second draw of its targets
    n = int(g_large.nodes.shape[0])
    out_idx = np.flatnonzero(g_large.output_mask)
    assert np.array_equal(b_large.targets[:n].cpu().numpy()[out_idx], g_large.targets)
    t2 = np.random.default_rng(1).normal(size=g_large.targets.shape).astype(np.float32)
    full2 = np.zeros((len(g_large.output_mask), t2.shape[1]), np.float32)
    full2[out_idx] = t2
    chunk = -(-n // pg.n_parts)
    targets2 = np.zeros_like(pg.targets)
    for p in range(pg.n_parts):
        lo, hi = p * chunk, min((p + 1) * chunk, n)
        targets2[p, :hi - lo] = full2[lo:hi]
    pg2 = dataclasses.replace(pg, targets=targets2)
    b_large2 = b_large.replace(targets=b_large.targets.clone())
    b_large2.targets[torch.as_tensor(out_idx, device=b_large.targets.device)] = torch.as_tensor(t2, device="cuda")
    ref_h2 = averaged_step(compiled(large_graph_gnn("cuda", seed=0), loss="mse"), [b_large, b_large2])
    m3 = compiled(large_graph_gnn("cuda", seed=0), loss="mse")
    logs, _ = train_step(m3, b_large, m3.next_rng())
    ref_h3 = step_arrays(m3, logs["loss_sum"] / logs["count"])
    cv = comm_volume(pg, m3, state_width=8, n_iterations=5)
    del m3, b_large2
    torch.cuda.empty_cache()

    inputs = [{"packed": parts[r], "bench": b_bench_cpu, "hybrid2": (pg if r < 2 else pg2).shard(r % 2, "cpu"),
               "hybrid3": pg.shard(r // 2, "cpu"), "host_env": host_env(r, 2), "dp_graphs": (train_g, val_g)}
              for r in range(DIST_RANKS)]
    ck = tempfile.mkdtemp(dir=os.path.join(REPO, "gnnkeras_tpu_torch", "_build"))
    t0 = time.perf_counter()
    ranks = spawn(_dist_rank, DIST_RANKS, [(inp, ck) for inp in inputs], threads=2, timeout_s=900)
    out["ranks_s"] = time.perf_counter() - t0
    out["ranks"] = ranks

    # -- a. packed flagship: forward at phase 4's bounds, one step at phase 5's --------
    pos_m = packed_positions(bench)
    got_state = np.zeros_like(ref_fwd["state"])
    for p, r in enumerate(ranks):
        sub = split_merged_by_graph(bench, meta.groups[p])
        rows = pos_m[np.flatnonzero(np.isin(bench.graph_of_node, meta.groups[p]))]
        got_state[rows] = r["packed_fwd"]["state"][packed_positions(sub)]
        assert r["packed_fwd"]["k"] == ref_fwd["k"] == 5.0
        assert r["packed_fwd"]["launches"] == {"strip_matmul": 4}, r["packed_fwd"]["launches"]
        assert r["packed_step"]["launches"] == {"strip_matmul": 4, "strip_matmul_t": 4}, r["packed_step"]["launches"]
    real = b_bench_cpu.node_mask.numpy()
    np.testing.assert_allclose(got_state[real], ref_fwd["state"][real], rtol=1e-5, atol=1e-6, err_msg="packed state")
    got_out = meta.merge_outputs([r["packed_fwd"]["out"] for r in ranks])
    np.testing.assert_allclose(got_out, ref_fwd["out"], rtol=1e-5, atol=1e-6, err_msg="packed out")
    packed_step = [check_step("packed step", r["packed_step"], ref_step) for r in ranks]
    emit({"phase": "packed", "ranks": DIST_RANKS, "graphs_per_rank": [len(ids) for ids in meta.groups],
          "tiles_per_rank": parts[0].num_nodes // 128, "state_max_abs_diff": float(
              np.abs(got_state[real] - ref_fwd["state"][real]).max()),
          "out_max_abs_diff": float(np.abs(got_out - ref_fwd["out"]).max()), "step": packed_step[0],
          "launches": {"forward": ranks[0]["packed_fwd"]["launches"],
                       "train_step": ranks[0]["packed_step"]["launches"]},
          "forward_ms": [r["packed_fwd"]["forward_ms"] for r in ranks],
          "train_step_ms": [r["packed_step"]["train_step_ms"] for r in ranks], "card": card})

    # -- b. packed LGNN: phase 18's deep-stack bounds with the bf16 control ------------
    phase4, deep = (1e-5, 1e-6), (1e-4, 1e-5)

    def lgnn_checks(leg):
        """(name, got, want, tolerance) of every state (real nodes, merged
        order) and output (graph order) of the 3 layers."""
        found = []
        for i in range(3):
            s = np.zeros_like(ref_lgnn["states"][i])
            for p, r in enumerate(ranks):
                sub = split_merged_by_graph(bench, meta.groups[p])
                rows = pos_m[np.flatnonzero(np.isin(bench.graph_of_node, meta.groups[p]))]
                s[rows] = leg(r)["states"][i][packed_positions(sub)]
            found.append((f"state layer {i}", s[real], ref_lgnn["states"][i][real], phase4 if i == 0 else deep))
            o = meta.merge_outputs([leg(r)["outs"][i] for r in ranks])
            found.append((f"out layer {i}", o, ref_lgnn["outs"][i], phase4))
        return found

    def share(a, b, tol):
        return float((np.abs(a - b) / (tol[1] + tol[0] * np.abs(b))).max())

    found = lgnn_checks(lambda r: r["lgnn_fwd"])
    control = max(share(a, b, tol) for name, a, b, tol in lgnn_checks(lambda r: r["lgnn_fwd"]["control"])
                  if name.startswith("state") and name != "state layer 0")
    lgnn_step = [check_step("packed lgnn step", r["lgnn_step"], ref_lgnn_step, grad_atol_rel=1e-3) for r in ranks]
    step_control = max(grad_tolerance_share(r["lgnn_step"]["control_grads"], ref_lgnn_step["grads"], 1e-3)
                       for r in ranks)
    lgnn_res = {"phase": "packed_lgnn", "layers": 3, "mode": "residual", "k": ranks[0]["lgnn_fwd"]["k"],
                "tolerance": {name: tol for name, _, _, tol in found},
                "tolerance_share": {name: share(a, b, tol) for name, a, b, tol in found},
                "phase4_tolerance_share": {name: share(a, b, phase4) for name, a, b, _ in found},
                "control_tolerance_share": control, "step": lgnn_step[0], "step_control_grad_share": step_control,
                "launches": {"forward": ranks[0]["lgnn_fwd"]["launches"],
                             "train_step": ranks[0]["lgnn_step"]["launches"]},
                "train_step_ms": [r["lgnn_step"]["train_step_ms"] for r in ranks], "card": card}
    emit(lgnn_res)
    assert all(r["lgnn_fwd"]["k"] == ref_lgnn["k"] == [5.0] * 3 for r in ranks)
    for name, a, b, tol in found:
        np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1], err_msg=f"packed lgnn {name}")
    assert control > 1.0 and step_control > 1.0, (control, step_control)
    # layer 0 peels iteration 0: 4 + 5 + 5 aggregations at d 16, 32 and 48, and as many backward
    per_width = {16: 4, 32: 5, 48: 5}
    for r in ranks:
        assert r["lgnn_fwd"]["launches"] == {"strip_matmul": 14}, r["lgnn_fwd"]["launches"]
        assert r["lgnn_step"]["launches"] == {"strip_matmul": 14, "strip_matmul_t": 14}, r["lgnn_step"]["launches"]
        assert r["lgnn_fwd"]["widths"] == {("strip_matmul", d): n for d, n in per_width.items()}, r["lgnn_fwd"]
        assert r["lgnn_step"]["widths"] == {(name, d): n for name in ("strip_matmul", "strip_matmul_t")
                                            for d, n in per_width.items()}, r["lgnn_step"]["widths"]

    # -- c. data parallelism ------------------------------------------------------------
    assert [r["dp_step"]["weight"] for r in ranks] == [1.0, 1.0, 1.0, 0.0]
    dp_step = [check_step("data-parallel step", r["dp_step"], ref_dp) for r in ranks]
    first = ranks[0]
    for r in ranks:
        assert r["dp_step"]["launches"] == {"strip_matmul": 4, "strip_matmul_t": 4}, r["dp_step"]["launches"]
        assert r["dp_fit"]["history"] == first["dp_fit"]["history"]
        for key in ("dp_fit", "dp_resumed"):
            for name, value in first["dp_fit"]["state"].items():
                np.testing.assert_array_equal(r[key]["state"][name], value, err_msg=f"{key} rank {r['rank']} {name}")
    assert first["dp_resumed"]["history"]["loss"] == first["dp_fit"]["history"]["loss"][1:]
    assert len(first["dp_fit"]["history"]["val_loss"]) == 2
    emit({"phase": "data_parallel", "ranks": DIST_RANKS, "batches": 3, "filler_rank": 3, "step": dp_step[0],
          "fit": first["dp_fit"]["history"], "fit_s": [r["dp_fit"]["s"] for r in ranks],
          "resumed": first["dp_resumed"]["history"], "launches": {"train_step": first["dp_step"]["launches"],
                                                                 "fit_2_epochs": first["dp_fit"]["launches"]},
          "card": card})

    # -- d. tensor parallelism ------------------------------------------------------------
    rows = b_bench_cpu.host_pred_rows
    for r in ranks:
        assert r["tp_fwd"]["k"] == 5.0 and r["tp_fwd"]["launches"] == {"strip_matmul": 4}, r["tp_fwd"]
        assert r["tp_step"]["launches"] == {"strip_matmul": 4, "strip_matmul_t": 4}, r["tp_step"]["launches"]
        assert r["tp_local"]["layers.1.kernel"][1] == 4, r["tp_local"]  # 14 features padded to 16: 4 a rank
        np.testing.assert_allclose(r["tp_fwd"]["out"][rows], ref_fwd["out"], rtol=1e-5, atol=1e-6, err_msg="tp out")
    tp_step = [check_step("tensor-parallel step", r["tp_step"], ref_step) for r in ranks]
    emit({"phase": "tensor_parallel", "ranks": DIST_RANKS, "state_features": 14, "padded": 16, "per_rank": 4,
          "out_max_abs_diff": max(float(np.abs(r["tp_fwd"]["out"][rows] - ref_fwd["out"]).max()) for r in ranks),
          "step": tp_step[0], "launches": {"forward": ranks[0]["tp_fwd"]["launches"],
                                           "train_step": ranks[0]["tp_step"]["launches"]},
          "forward_ms": [r["tp_fwd"]["forward_ms"] for r in ranks], "card": card})

    # -- e. hybrid and multi-host ---------------------------------------------------------
    h2 = [check_step("hybrid data 2 x graph 2 step", r["hybrid2"], ref_h2, grad_atol_rel=1e-4) for r in ranks]
    h3 = [check_step("hybrid data 1 x graph 2 x model 2 step", r["hybrid3"], ref_h3, grad_atol_rel=1e-4)
          for r in ranks]
    for r in ranks:
        launches = r["hybrid2"]["launches"]
        assert launches.get("strip_matmul", 0) > 0 and launches.get("strip_matmul_t", 0) > 0, launches
        assert set(launches) == {"strip_matmul", "strip_matmul_t"} and r["hybrid3"]["launches"] == launches
        # every launch at the large model's 8 state rows, the width of the diagonal's check
        assert r["hybrid2"]["widths"] == r["hybrid3"]["widths"] == {(name, 8): n for name, n in launches.items()}, \
            r["hybrid2"]["widths"]
        assert r["hybrid3"]["local"]["layers.1.kernel"][1] == 4, r["hybrid3"]["local"]  # 8 features: 4 a rank
        assert r["multihost"]["shape"] == (2, 2) and r["multihost"]["coords"] == (r["rank"] // 2, r["rank"] % 2)
        # the same program on the same layout as the first hybrid step: bit for bit
        for key in ("params", "buffers"):
            for name, value in r["hybrid2"][key].items():
                np.testing.assert_array_equal(r["multihost"][key][name], value, err_msg=f"multihost {name}")
    emit({"phase": "hybrid", "ranks": DIST_RANKS, "two_axis": {"mesh": [2, 2], "step": h2[0]},
          "three_axis": {"mesh": [1, 2, 2], "state_features_per_rank": 4, "step": h3[0]},
          "multihost_mesh": {"hosts": 2, "per_host": 2, "equals_two_axis_bit_for_bit": True},
          "launches": {"two_axis": ranks[0]["hybrid2"]["launches"], "three_axis": ranks[0]["hybrid3"]["launches"]},
          "train_step_ms": {"two_axis": [r["hybrid2"]["train_step_ms"] for r in ranks],
                            "three_axis": [r["hybrid3"]["train_step_ms"] for r in ranks],
                            "multihost": [r["multihost"]["train_step_ms"] for r in ranks]},
          "comm_volume": dataclasses.asdict(cv), "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
          "ranks_s": out["ranks_s"], "rank_leg_s": {leg: [r["leg_s"][leg] for r in ranks] for leg in ranks[0]["leg_s"]},
          "card": card})
    out["packed_parts"] = parts
    return out


# -- phase 22: expert-parallel, pipelined and composite-partitioned training -----------

XP_RANKS = 4  # phase 22's ranks, all on the one card


def host_ms(fn, reps=5):
    """Median host ms of ``fn`` on this process alone (synchronised with the
    card around each call)."""
    import torch

    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def single_type_cgnn(device, seed=0):
    """Phase 14's node model as a composite GNN of one node type (dim_state
    0): BatchNorm → Dense(34→8, selu) over ``[label | state | Σstate |
    label sums | Σarcs]``, BatchNorm → Dense(8→2, softmax), max_iteration
    5, threshold 0."""
    from gnnkeras_tpu_torch.models.composite import CompositeGNNnodeBased
    from gnnkeras_tpu_torch.models.mlp import MLP

    net = MLP((8 + 2 * 8 + 8 + 2,), [8], "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    out = MLP((8,), [2], "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return CompositeGNNnodeBased([net], out, 0, 5, 0.0).build(seed=seed, device=device)


def local_weights_bf16(batch, n_nodes, parts):
    """``batch`` (a plain edge-list batch of a graph of ``n_nodes`` nodes)
    with the weights of the arcs inside one of ``parts`` node ranges rounded
    to bf16: the weights the partitioned engine's bf16 local operators hold
    (its halo blocks stay f32, its label sums are the host's f32 ones)."""
    import torch

    chunk = -(-n_nodes // parts)
    src, dst = batch.arc_src.long(), batch.arc_dst.long()
    local = torch.clamp(src // chunk, max=parts - 1) == torch.clamp(dst // chunk, max=parts - 1)
    w = batch.arcnode_weight
    return batch.replace(arcnode_weight=torch.where(local, w.to(torch.bfloat16).to(w.dtype), w))


def ep_step_grads(ep):
    """An expert-parallel step's gradients keyed as the wrapped model's
    parameters: the experts' gathered from every rank and their padding
    removed, the head's as the step left them (summed over the group).  A
    collective."""
    import torch
    import torch.distributed as tdist
    from gnnkeras_tpu_torch.parallel.expert import unstack_expert_params

    mine = [{n: p.grad.cpu() for n, p in e.named_parameters()} for e in ep.experts]
    everyone = [None] * ep.n_devices
    tdist.all_gather_object(everyone, mine, group=ep.group)
    flat = [sd for rank_sds in everyone for sd in rank_sds]
    per_type = unstack_expert_params(ep.cgnn.net_state, {k: torch.stack([sd[k] for sd in flat]) for k in flat[0]},
                                     ep._label_widths)
    grads = {f"net_state.{t}.{k}": v.numpy() for t, sd in enumerate(per_type) for k, v in sd.items()}
    grads.update({f"net_output.{n}": p.grad.cpu().numpy() for n, p in ep.cgnn.net_output.named_parameters()})
    return grads


def pipeline_step_grads(pp):
    """A pipelined step's gradients of every layer, gathered from the
    stages, keyed as the LGNN's parameters.  A collective."""
    import torch.distributed as tdist

    mine = {f"gnns.{pp.stage}.{n}": p.grad.cpu().numpy() for n, p in pp.lgnn.gnns[pp.stage].named_parameters()}
    everyone = [None] * pp.n_stages
    tdist.all_gather_object(everyone, mine, group=pp.group)
    return {k: v for d in everyone for k, v in d.items()}


def _xp_rank(rank, world, inp, ck):
    """Phase 22 on one rank (a spawned process on the card): a-d of
    ``expert_pipeline_section``, each with its launches counted from 0,
    then the kernels on this rank's own operators.  Returns NumPy results
    for the parent to compare."""
    import torch
    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.data import CompositeMultiGraphSequencer
    from gnnkeras_tpu_torch.data.synthetic import pipeline_lgnn, typed_cgnn
    from gnnkeras_tpu_torch.ops import ring as R
    from gnnkeras_tpu_torch.parallel.expert import ExpertParallelCompositeGNN
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.parallel.pipeline import PipelineLGNN
    from gnnkeras_tpu_torch.tools import bench_packed

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    res = {"rank": rank, "leg_s": {}}
    t_leg = time.perf_counter()

    def leg_done(name):
        nonlocal t_leg
        res["leg_s"][name] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

    # -- a. expert parallelism: typed_cgnn(10) on the typed bench batch ----------------
    typed = inp["typed"].to(dev)
    ep = ExpertParallelCompositeGNN(compiled(typed_cgnn(10, dev), average_st_grads=True))
    kernels.reset_launches()
    with strip_widths() as widths:
        k, state, out, _ = ep.forward(typed, generator=gen(11))
        torch.cuda.synchronize()
    res["ep_fwd"] = {"k": float(k), "state": state.cpu().numpy(), "out": out.cpu().numpy(), "launches": _launched(),
                     "widths": widths.tally, "padded": [t >= ep.n_types for t in ep.local_types]}
    with bf16_aggregation():
        res["ep_fwd"]["control_state"] = ep.forward(typed, generator=gen(11))[1].cpu().numpy()
    kernels.reset_launches()
    with strip_widths() as widths:
        logs = ep.train_step(typed, gen(12))
        torch.cuda.synchronize()
    launches = _launched()
    grads = ep_step_grads(ep)
    ep.sync_to_model()
    res["ep_step"] = {**step_arrays(ep.cgnn, logs["loss"], grads), "k": float(logs["k"]), "launches": launches,
                      "widths": widths.tally}
    res["ep_fwd"]["forward_ms"], _ = _timed(lambda: ep.forward(typed, generator=gen(11)))
    res["ep_step"]["train_step_ms"], _ = _timed(lambda: ep.train_step(typed, gen(12)), reps=3)
    del typed
    train_g, val_g = inp["ep_graphs"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: the bf16 latch
        seq = CompositeMultiGraphSequencer(train_g, "g", "composite_average", batch_size=1000, slot_pack=128,
                                           strip_dtype="int8", device=dev)
        val = CompositeMultiGraphSequencer(val_g, "g", "composite_average", batch_size=1000, slot_pack=128,
                                           strip_dtype="int8", shuffle=False, device=dev)
    model = compiled(typed_cgnn(10, dev), average_st_grads=True)
    fitted = ExpertParallelCompositeGNN(model)
    np.random.seed(0)
    kernels.reset_launches()
    t = time.perf_counter()
    history = fitted.fit(seq, epochs=2, verbose=0, validation_data=val, checkpoint_dir=os.path.join(ck, "expert"))
    torch.cuda.synchronize()
    res["ep_fit"] = {"history": history.history, "s": time.perf_counter() - t, "launches": _launched(),
                     "engine_out": fitted.forward(val[0], generator=gen(5))[2].cpu().numpy(),
                     "model_out": model.forward(val[0], generator=gen(5))[2].cpu().numpy()}
    del seq, val, ep, fitted
    leg_done("expert")

    # -- b. the pipelined LGNN: M = 1 on the bench batch, M = 4 microbatches, a fit ---------
    bench = inp["bench"].to(dev)
    lgnn = compiled(pipeline_lgnn(dev), training_mode="parallel")
    pp = PipelineLGNN(lgnn)
    kernels.reset_launches()
    with strip_widths() as widths:
        logs = pp.train_step([bench], gen(13))
        torch.cuda.synchronize()
    launches = _launched()
    grads = pipeline_step_grads(pp)
    pp.sync_to_model()
    res["pp_step"] = {**step_arrays(lgnn, logs["loss"], grads), "k": float(logs["k"]), "launches": launches,
                      "widths": widths.tally}
    res["pp_step"]["train_step_ms"], _ = _timed(lambda: pp.train_step([bench], gen(13)), reps=3)
    bad = PipelineLGNN(compiled(pipeline_lgnn(dev), training_mode="parallel"))
    with bf16_aggregation():
        bad.train_step([bench], gen(13))
    res["pp_step"]["control_grads"] = pipeline_step_grads(bad)
    del bench, pp, bad
    micro = [b.to(dev) for b in inp["micro"]]
    lgnn4 = compiled(pipeline_lgnn(dev, bn=False), training_mode="parallel")
    pp4 = PipelineLGNN(lgnn4)
    kernels.reset_launches()
    with strip_widths() as widths:
        logs = pp4.train_step(micro, gen(14))
        torch.cuda.synchronize()
    launches = _launched()
    grads = pipeline_step_grads(pp4)
    pp4.sync_to_model()
    res["pp_m4"] = {**step_arrays(lgnn4, logs["loss"], grads), "launches": launches, "widths": widths.tally}
    res["pp_m4"]["train_step_ms"], _ = _timed(lambda: pp4.train_step(micro, gen(14)), reps=3)
    fit_model = compiled(pipeline_lgnn(dev, bn=False), training_mode="parallel")
    kernels.reset_launches()
    t = time.perf_counter()
    history = PipelineLGNN(fit_model).fit([micro], epochs=2, verbose=0, validation_data=_Repeat(micro[0], 1),
                                          checkpoint_dir=os.path.join(ck, "pipeline"))
    torch.cuda.synchronize()
    res["pp_fit"] = {"history": history.history, "s": time.perf_counter() - t, "launches": _launched(),
                     "params": {n: p.detach().cpu().numpy() for n, p in fit_model.named_parameters()}}
    del micro, pp4
    leg_done("pipeline")

    # -- c. composite graphs on the partitioned engine -------------------------------------
    legs = {"typed": (lambda: typed_cgnn(0, dev), "categorical_crossentropy", ("collective", "pallas_ring")),
            "typed_int8": (lambda: typed_cgnn(0, dev), "categorical_crossentropy", ("collective",)),
            "band384_int8": (lambda: single_type_cgnn(dev), "mse", ("collective",))}
    res["partitioned"] = {}
    for key, (make, loss, transports) in legs.items():
        shard = inp["parts"][key].to(dev)
        size = int(shard.node_mask.sum())
        model = compiled(make(), loss)
        leg = {}
        for transport in transports:
            engine = PartitionedGNN(model, transport=transport)
            kernels.reset_launches()
            with strip_widths() as widths:
                k, state, out, _ = engine.forward(shard)
                torch.cuda.synchronize()
            leg[transport] = {"k": float(k), "state": state[:size].cpu().numpy(), "out": out.cpu().numpy(),
                              "launches": _launched(), "widths": widths.tally}
            leg[transport]["forward_ms"], _ = _timed(lambda: engine.forward(shard))
        if "pallas_ring" in transports:
            try:
                PartitionedGNN(model, transport="pallas_ring").train_step(shard)
                leg["ring_train"] = "trained"
            except NotImplementedError as err:
                leg["ring_train"] = str(err)
        engine = PartitionedGNN(model)
        kernels.reset_launches()
        branches = []
        with strip_widths() as widths, selu_branches(record=branches):
            logs = engine.train_step(shard)
            torch.cuda.synchronize()
        leg["step"] = {**step_arrays(model, logs["loss"]), "k": float(logs["k"]), "launches": _launched(),
                       "widths": widths.tally,
                       "selu_positive": [(np.packbits(m[:size]), m[:size].shape) for m in branches]}
        leg["step"]["train_step_ms"], _ = _timed(lambda: engine.train_step(shard), reps=3)
        res["partitioned"][key] = leg
    leg_done("composite_partitioned")

    # -- d. tools/bench_packed.py: the packed flagship forward against the plain engine -----
    res["bench_packed"] = bench_packed.run_rank(rank, world, inp["bench_packed"][0],
                                                inp["bench_packed"][1] if rank == 0 else None,
                                                inp["bench_packed"][2], repeats=5, device="cuda")
    leg_done("bench_packed")

    # -- the kernels on this rank's own operators (timed on rank 0) -------------------------
    timed = rank == 0
    x = torch.randn((int(inp["parts"]["typed"].publish_local.shape[0]), 14), generator=gen(100 + rank), device=dev)
    kernels.reset_launches()
    got = R.ring_all_gather(x)
    assert kernels.LAUNCHES["ring_all_gather"] == 2  # the push and the copy-out
    want = R._ring_all_gather_plain(x)
    assert torch.equal(got, want)  # a copy: bit for bit
    res["ring_check"] = {"rows": int(x.shape[0]), "d": 14, "max_abs_diff": float((got - want).abs().max()),
                         **_ring_times(x), "bytes": world * (1 + world) * x.numel() * x.element_size()}
    local = inp["parts"]["typed_int8"].local_op
    diag = local.diags[list(local.offsets).index(0)].to(dev)
    res["banded_checks"] = {name: check_strip(diag, f"typed_int8_part_{rank}_diagonal_0", timed=timed, name=name,
                                              d=16) for name in ("strip_matmul", "strip_matmul_t")}
    qm = inp["parts"]["band384_int8"].local_op.to(dev)
    res["qbcsr_checks"] = {name: check_qbcsr(qm, f"band384_part_{rank}", timed=timed, name=name, d=8)
                           for name in ("qbcsr_matmul", "qbcsr_matmul_t")}
    leg_done("kernel_checks")
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def expert_pipeline_section(card, bench, b_bench, b_bench_cpu, packed_parts):
    """Phase 22 (module docstring): the inputs, the references on the single
    card, the 4 ranks (``_xp_rank``) and every check against them.
    Returns what the kernels line reads."""
    import torch
    from gnnkeras_tpu_torch import from_graph_object, kernels
    from gnnkeras_tpu_torch.data import MultiGraphSequencer, dataset_splits
    from gnnkeras_tpu_torch.data.synthetic import (composite_of, large_banded_graph, pipeline_lgnn,
                                                   random_molecules, typed_cgnn)
    from gnnkeras_tpu_torch.ops.banded import BandedOperator
    from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr
    from gnnkeras_tpu_torch.parallel.launch import spawn
    from gnnkeras_tpu_torch.parallel.partition import partition_graph
    from gnnkeras_tpu_torch.training.trainer import _objective, _optimizer, train_step

    out, t0 = {}, time.perf_counter()
    cuda_gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    typed = composite_of(bench, 3, "composite_average")
    typed_u = composite_of(without_parallel_arcs(bench), 3, "composite_average")
    band = composite_of(large_banded_graph(131_072, band=384), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs, per-type weights: bf16 storage, as in JAX
        b_typed_cpu = from_graph_object(typed, slot_pack=128, strip_dtype="int8", device="cpu")
        parts = {"typed": partition_graph(typed, XP_RANKS),
                 "typed_int8": partition_graph(typed_u, XP_RANKS, dense_blocks=True, agg_dtype="int8"),
                 "band384_int8": partition_graph(band, XP_RANKS, dense_blocks=True, agg_dtype="int8")}
    b_typed = b_typed_cpu.to("cuda")
    assert parts["typed"].publish_local is not None  # the halo engages: the ring moves only the boundary rows
    # 'composite_average' weights differ by source type: the banded diagonals store them in bf16 (rows 1/1b);
    # the band-384 graph's 7 tile offsets exceed the banded form: quantised BCSR, int8 mask and scale (row 8)
    assert all(isinstance(op, BandedOperator) for op in parts["typed_int8"].local_ops)
    assert all(isinstance(op, QuantBcsr) and op.scale is not None for op in parts["band384_int8"].local_ops)
    train_g, _, val_g = dataset_splits(random_molecules(4337, seed=0, min_nodes=5, max_nodes=56), seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        seq4 = MultiGraphSequencer(train_g[:1000], "g", "average", batch_size=250, slot_pack=128,
                                   strip_dtype="int8", shuffle=False, device="cpu")
        micro_cpu = [seq4[i] for i in range(4)]
    assert len(seq4) == 4 and len({(b.num_nodes, b.num_arcs, b.num_graphs) for b in micro_cpu}) == 1
    micro = [b.to("cuda") for b in micro_cpu]
    ep_graphs = ([composite_of(g, 3, "composite_average") for g in train_g],
                 [composite_of(g, 3, "composite_average") for g in val_g])
    emit({"phase": "expert_pipeline_inputs", "host_build_s": time.perf_counter() - t0,
          "typed_nodes": int(typed.nodes.shape[0]), "typed_graphs": int(typed.num_graphs),
          "typed_tiles": b_typed.num_nodes // 128, "typed_strip_storage": str(b_typed.strip.strip.dtype),
          "typed_halo_rows": int(parts["typed"].publish_local.shape[1]),
          "typed_int8_offsets": list(parts["typed_int8"].local_ops[0].offsets),
          "typed_int8_diagonal_storage": str(parts["typed_int8"].local_ops[0].diags[0].strip.dtype),
          "band384_nodes": int(band.nodes.shape[0]), "band384_blocks": [int(op.mask.shape[0])
                                                                        for op in parts["band384_int8"].local_ops],
          "microbatch": {"graphs": 250, "padded_nodes": micro[0].num_nodes}})

    # rows 1/1b on the operators every rank holds whole: the typed batch (the
    # experts' width 10, d_pad 16) and a microbatch (the pipeline's d_pad 16);
    # the bench operator at d 16 is phase 2's check
    out["checks"] = {(label, name): check_strip(op, label, timed=True, name=name, d=16)
                     for label, op in (("typed_bench", b_typed.strip), ("pipeline_microbatch_0", micro[0].strip))
                     for name in ("strip_matmul", "strip_matmul_t")}

    # -- the single card's references ---------------------------------------------------
    refs = {}
    model = compiled(typed_cgnn(10, "cuda"), average_st_grads=True)
    kernels.reset_launches()
    k, state, o, mask, _ = model.forward(b_typed, generator=cuda_gen(11))
    refs["ep_fwd"] = {"k": float(k), "state": state.cpu().numpy(), "out": o.cpu().numpy(), "launches": _launched(),
                      "forward_ms": host_ms(lambda: model.forward(b_typed, generator=cuda_gen(11)))}
    kernels.reset_launches()
    logs, _ = train_step(model, b_typed, cuda_gen(12))
    refs["ep_step"] = {**step_arrays(model, logs["loss_sum"] / logs["count"]), "launches": _launched()}
    refs["ep_step"]["train_step_ms"] = host_ms(lambda: train_step(model, b_typed, cuda_gen(12)), reps=3)
    graph_rows = np.flatnonzero(mask.cpu().numpy())
    lgnn = compiled(pipeline_lgnn("cuda"), training_mode="parallel")
    kernels.reset_launches()
    logs, _ = train_step(lgnn, b_bench, cuda_gen(13))
    refs["pp_step"] = {**step_arrays(lgnn, logs["loss_sum"] / logs["count"]), "launches": _launched()}
    refs["pp_step"]["train_step_ms"] = host_ms(lambda: train_step(lgnn, b_bench, cuda_gen(13)), reps=3)
    # M = 4: Adam on the mean of the microbatches' gradients, one generator drawing in their order
    lgnn4 = compiled(pipeline_lgnn("cuda", bn=False), training_mode="parallel")
    g4, grads, losses = cuda_gen(14), [], []
    for b in micro:
        lgnn4.zero_grad(set_to_none=True)
        loss, _ = _objective(lgnn4, b, g4, training=True)
        loss.backward()
        grads.append([p.grad.clone() for p in lgnn4.parameters()])
        losses.append(loss.detach())
    for p, *gs in zip(lgnn4.parameters(), *grads):
        p.grad = sum(gs) / len(gs)
    _optimizer(lgnn4).step()
    refs["pp_m4"] = step_arrays(lgnn4, sum(losses) / len(losses))
    del model, lgnn, lgnn4, grads
    # the composite partitioned legs: the single card on each whole graph (the int8 leg's reference
    # holds the weights of its parts' bf16 diagonals: the arcs inside a part rounded to bf16); their
    # steps come after the ranks, on the ranks' selu branches
    part_legs = (("typed", typed, lambda d: typed_cgnn(0, d), "categorical_crossentropy"),
                 ("typed_int8", typed_u, lambda d: typed_cgnn(0, d), "categorical_crossentropy"),
                 ("band384_int8", band, single_type_cgnn, "mse"))
    ref_batches = {}
    for key, g, make, loss in part_legs:
        b = from_graph_object(g, device="cuda", dense_blocks=key != "typed_int8")
        if key == "typed_int8":
            b = local_weights_bf16(b, int(g.nodes.shape[0]), XP_RANKS)
        model = compiled(make("cuda"), loss)
        k, state, o, mask, _ = model.forward(b)
        n = int(g.nodes.shape[0])
        refs[key] = {"k": float(k), "state": state[:n].cpu().numpy(), "out": o[mask].cpu().numpy(),
                     "forward_ms": host_ms(lambda: model.forward(b))}
        ref_batches[key] = b
        del model
    torch.cuda.empty_cache()

    inputs = [{"typed": b_typed_cpu, "bench": b_bench_cpu, "micro": micro_cpu, "ep_graphs": ep_graphs,
               "parts": {key: pg.shard(r, "cpu") for key, pg in parts.items()},
               "bench_packed": (packed_parts[r], b_bench_cpu if r == 0 else None, int(bench.arcs.shape[0]))}
              for r in range(XP_RANKS)]
    ck = tempfile.mkdtemp(dir=os.path.join(REPO, "gnnkeras_tpu_torch", "_build"))
    t0 = time.perf_counter()
    ranks = spawn(_xp_rank, XP_RANKS, [(inp, ck) for inp in inputs], threads=2, timeout_s=900)
    out["ranks_s"] = time.perf_counter() - t0
    out["ranks"] = ranks
    phase4, deep = (1e-5, 1e-6), (1e-5, 1e-5)
    for key, g, make, loss in part_legs:
        # the single card's step on the branches the ranks' step took (``selu_branches``): the two
        # engines' pre-activations differ by f32 rounding, so a branch may differ only within the
        # state bound of the kink
        b = ref_batches.pop(key)
        branches = [np.concatenate([np.unpackbits(packed, count=int(np.prod(shape))).reshape(shape).astype(bool)
                                    for packed, shape in parts_of_call])
                    for parts_of_call in zip(*[r["partitioned"][key]["step"].pop("selu_positive") for r in ranks])]
        assert all(len(m) == g.nodes.shape[0] for m in branches), [m.shape for m in branches]
        model = compiled(make("cuda"), loss)
        logs, _ = train_step(model, b, model.next_rng())
        refs[key]["step_unpinned"] = step_arrays(model, logs["loss_sum"] / logs["count"])
        model = compiled(make("cuda"), loss)
        with selu_branches(pin=branches) as pinned:
            logs, _ = train_step(model, b, model.next_rng())
        assert pinned["flip_max_abs_x"] <= deep[1], (key, pinned)
        refs[key]["step"] = {**step_arrays(model, logs["loss_sum"] / logs["count"]), "selu": pinned}
        refs[key]["step"]["train_step_ms"] = host_ms(lambda: train_step(model, b, model.next_rng()), reps=3)
        del b, model
    torch.cuda.empty_cache()

    def share(a, b, tol):
        return float((np.abs(a - b) / (tol[1] + tol[0] * np.abs(b))).max())

    # -- a. expert parallelism -------------------------------------------------------------
    ref, real = refs["ep_fwd"], b_typed_cpu.node_mask.numpy()
    ep_steps = []
    for r in ranks:
        got = r["ep_fwd"]
        assert got["k"] == ref["k"] and got["launches"] == ref["launches"], (got["k"], got["launches"], ref)
        assert got["padded"] == [r["rank"] == XP_RANKS - 1], got["padded"]  # 3 types on 4 ranks: rank 3's is padded
        # 10 state features through 5 iterations, the experts' padded kernels summing in another order: phase 17's
        # state bound; the graph outputs at phase 4's
        np.testing.assert_allclose(got["state"][real], ref["state"][real], rtol=deep[0], atol=deep[1],
                                   err_msg="expert state")
        np.testing.assert_allclose(got["out"][graph_rows], ref["out"][graph_rows], rtol=phase4[0], atol=phase4[1],
                                   err_msg="expert out")
        assert r["ep_step"]["launches"] == refs["ep_step"]["launches"], (r["ep_step"]["launches"], refs["ep_step"])
        ep_steps.append(check_step(f"expert step rank {r['rank']}", r["ep_step"], refs["ep_step"],
                                   grad_atol_rel=1e-4))
    control = min(share(r["ep_fwd"]["control_state"][real], ref["state"][real], deep) for r in ranks)
    assert control > 1.0, control
    fit = ranks[0]["ep_fit"]
    for r in ranks:
        assert r["ep_fit"]["history"] == fit["history"]
        np.testing.assert_allclose(r["ep_fit"]["engine_out"], r["ep_fit"]["model_out"], rtol=phase4[0],
                                   atol=phase4[1], err_msg="the experts written back")
    assert len(fit["history"]["loss"]) == 2 and np.isfinite(fit["history"]["loss"]).all()
    assert len(fit["history"]["val_loss"]) == 2 and np.isfinite(fit["history"]["val_loss"]).all()
    emit({"phase": "expert_parallel", "ranks": XP_RANKS, "types": 3, "types_padded": XP_RANKS, "k": ref["k"],
          "state_tolerance": deep, "state_tolerance_share": max(share(r["ep_fwd"]["state"][real], ref["state"][real],
                                                                      deep) for r in ranks),
          "control_state_tolerance_share": control,
          "out_max_abs_diff": max(float(np.abs(r["ep_fwd"]["out"][graph_rows] - ref["out"][graph_rows]).max())
                                  for r in ranks), "step": ep_steps[0],
          "launches": {"forward": ranks[0]["ep_fwd"]["launches"], "train_step": ranks[0]["ep_step"]["launches"],
                       "fit_2_epochs": fit["launches"]},
          "widths": {"forward": {str(k): v for k, v in ranks[0]["ep_fwd"]["widths"].items()}},
          "fit": fit["history"], "fit_s": [r["ep_fit"]["s"] for r in ranks],
          "forward_ms": [r["ep_fwd"]["forward_ms"] for r in ranks], "forward_ms_single_card": ref["forward_ms"],
          "train_step_ms": [r["ep_step"]["train_step_ms"] for r in ranks],
          "train_step_ms_single_card": refs["ep_step"]["train_step_ms"], "card": card})

    # -- b. the pipelined LGNN -------------------------------------------------------------
    pp_steps, pp4_steps = [], []
    for name in ("strip_matmul", "strip_matmul_t"):  # the stages' launches add up to the single card's step
        total = sum(r["pp_step"]["launches"].get(name, 0) for r in ranks)
        assert total == refs["pp_step"]["launches"][name], (name, total, refs["pp_step"]["launches"])
        assert all(r["pp_step"]["launches"].get(name, 0) > 0 and r["pp_m4"]["launches"].get(name, 0) > 0
                   for r in ranks), name
    for r in ranks:
        # the LGNN stack's bound (phase 18): gradients to 1e-3 of each leaf's largest |g|
        pp_steps.append(check_step(f"pipeline M=1 rank {r['rank']}", r["pp_step"], refs["pp_step"],
                                   grad_atol_rel=1e-3))
        pp4_steps.append(check_step(f"pipeline M=4 rank {r['rank']}", r["pp_m4"], refs["pp_m4"], grad_atol_rel=1e-3))
        assert set(r["pp_step"]["widths"]) <= {("strip_matmul", 16), ("strip_matmul_t", 16)}, r["pp_step"]["widths"]
    pp_control = grad_tolerance_share(ranks[0]["pp_step"]["control_grads"], refs["pp_step"]["grads"], 1e-3)
    assert pp_control > 1.0, pp_control
    pfit = ranks[0]["pp_fit"]
    assert len(pfit["history"]["loss"]) == 2 and np.isfinite(pfit["history"]["loss"]).all()
    assert len(pfit["history"]["val_loss"]) == 2 and np.isfinite(pfit["history"]["val_loss"]).all()
    for r in ranks:
        assert r["pp_fit"]["history"] == pfit["history"]
        for name, value in pfit["params"].items():  # every rank holds every trained layer
            np.testing.assert_array_equal(r["pp_fit"]["params"][name], value, err_msg=name)
    emit({"phase": "pipeline_parallel", "stages": XP_RANKS, "layers": 4, "dim_state": 10,
          "m1": pp_steps[0], "m1_control_grad_share": pp_control, "m4": pp4_steps[0],
          "launches": {"m1": [r["pp_step"]["launches"] for r in ranks], "m4": [r["pp_m4"]["launches"] for r in ranks],
                       "m1_single_card": refs["pp_step"]["launches"]},
          "fit": pfit["history"], "fit_s": [r["pp_fit"]["s"] for r in ranks],
          "train_step_ms": {"m1": [r["pp_step"]["train_step_ms"] for r in ranks],
                            "m1_single_card": refs["pp_step"]["train_step_ms"],
                            "m4": [r["pp_m4"]["train_step_ms"] for r in ranks]}, "card": card})

    # -- c. composite graphs on the partitioned engine ---------------------------------------
    part_res = {}
    for key, pg in parts.items():
        ref = refs[key]
        legs = [r["partitioned"][key] for r in ranks]
        for transport in [t for t in ("collective", "pallas_ring") if t in legs[0]]:
            assert all(leg[transport]["k"] == ref["k"] for leg in legs), ([leg[transport]["k"] for leg in legs], ref)
            state = np.concatenate([leg[transport]["state"] for leg in legs])
            o = legs[0][transport]["out"][:len(ref["out"])] if pg.focus == "g" else \
                np.concatenate([leg[transport]["out"][:len(leg[transport]["state"])] for leg in legs])
            np.testing.assert_allclose(state, ref["state"], rtol=deep[0], atol=deep[1], err_msg=f"{key} {transport}")
            np.testing.assert_allclose(o, ref["out"], rtol=phase4[0], atol=phase4[1], err_msg=f"{key} {transport}")
            part_res[(key, transport)] = {"state_max_abs_diff": float(np.abs(state - ref["state"]).max()),
                                          "out_max_abs_diff": float(np.abs(o - ref["out"]).max()),
                                          "launches": legs[0][transport]["launches"],
                                          "forward_ms": [leg[transport]["forward_ms"] for leg in legs],
                                          "forward_ms_single_card": ref["forward_ms"]}
        steps = [check_step(f"{key} partitioned step rank {r}", leg["step"], ref["step"], grad_atol_rel=1e-4)
                 for r, leg in enumerate(legs)]
        part_res[(key, "step")] = {**steps[0], "selu_branches_pinned": ref["step"]["selu"],
                                   # a reading, no check: rank 0 against the single card on its own branches
                                   "grad_max_tolerance_share_unpinned": grad_tolerance_share(
                                       legs[0]["step"]["grads"], ref["step_unpinned"]["grads"], 1e-4),
                                   "launches": legs[0]["step"]["launches"],
                                   "train_step_ms": [leg["step"]["train_step_ms"] for leg in legs],
                                   "train_step_ms_single_card": ref["step"]["train_step_ms"]}
    for r in ranks:
        legs = r["partitioned"]
        assert legs["typed"]["collective"]["launches"] == {} and legs["typed"]["step"]["launches"] == {}
        assert set(legs["typed"]["pallas_ring"]["launches"]) == {"ring_all_gather"}, legs["typed"]["pallas_ring"]
        assert "no backward" in legs["typed"]["ring_train"]
        for name in ("strip_matmul", "strip_matmul_t"):
            assert legs["typed_int8"]["step"]["launches"].get(name, 0) > 0, legs["typed_int8"]["step"]
            assert set(legs["typed_int8"]["step"]["widths"]) <= {(n, 16) for n in ("strip_matmul", "strip_matmul_t")}
        assert set(legs["band384_int8"]["step"]["launches"]) == {"qbcsr_matmul", "qbcsr_matmul_t"}, legs["band384_int8"]
    emit({"phase": "composite_partitioned", "parts": XP_RANKS,
          "legs": {f"{k}/{t}": v for (k, t), v in part_res.items()}, "card": card})

    bp = ranks[0]["bench_packed"]
    emit({"phase": "bench_packed", "ranks": XP_RANKS, "line": bp["line"], "plain_ms": bp["plain_ms"],
          "packed_ms": bp["packed_ms"], "plain_edges_per_s": bp["plain_edges_per_s"],
          "packed_edges_per_s": bp["packed_edges_per_s"], "ratio": bp["ratio"], "card": card})
    ring = ranks[0]["ring_check"]
    ring["bound_ms"], ring["bound_by"] = bound(ring["bytes"], 0)
    emit({"phase": "expert_pipeline_ranks", "ranks_s": out["ranks_s"],
          "rank_leg_s": {leg: [r["leg_s"][leg] for r in ranks] for leg in ranks[0]["leg_s"]},
          "peak_memory_gb": [r["peak_memory_gb"] for r in ranks], "card": card})
    return out


# -- phase 23: the user surface and the native host tier ----------------------------------------------------------
# the CLI as ``python -m gnnkeras_tpu_torch.cli`` runs it, plus one line on
# standard error: the process's kernel launches
CLI = [sys.executable, "-c",
       "import json, sys; from gnnkeras_tpu_torch import cli, kernels; rc = cli.main(sys.argv[1:]); "
       "print(json.dumps({'kernel_launches': dict(kernels.LAUNCHES)}), file=sys.stderr); sys.exit(rc)"]


def same_bits(a, b):
    """Two results of a native function equal bit for bit: arrays (dtype,
    shape and bytes), tuples of them, or None."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@contextlib.contextmanager
def recorded_native_calls(names):
    """Within it, every call of the named ``native`` functions records a
    copy of its arguments ({name: [(args, kwargs), ...]})."""
    from gnnkeras_tpu_torch import native

    calls = {name: [] for name in names}
    real = {name: getattr(native, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append(([a.copy() if isinstance(a, np.ndarray) else a for a in args], dict(kwargs)))
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(native, name, recorder(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(native, name, real[name])


def native_vs_numpy(name, args, kwargs=None):
    """``native.<name>`` through the library and through its NumPy path on
    fresh copies of ``args``: asserts the same bits; returns (native s,
    NumPy s)."""
    from gnnkeras_tpu_torch import native

    fresh = lambda: [a.copy() if isinstance(a, np.ndarray) else a for a in args]
    fn = getattr(native, name)
    t0 = time.perf_counter()
    got = fn(*fresh(), **(kwargs or {}))
    t1 = time.perf_counter()
    with native.numpy_path():
        want = fn(*fresh(), **(kwargs or {}))
    t2 = time.perf_counter()
    assert same_bits(got, want), f"native {name} differs from its NumPy path"
    return t1 - t0, t2 - t1


def host_build_pair(label, build, turns=1):
    """``build()`` (synchronised) through the native tier, then through the
    NumPy paths (``turns`` 2: native, NumPy, NumPy, native), the results
    equal bit for bit (``same_batch``): the host seconds of each path."""
    import torch
    from gnnkeras_tpu_torch import native

    def timed(numpy_path):
        with native.numpy_path() if numpy_path else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = build()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    order = [False, True] if turns == 1 else [False, True, True, False]
    times = {"native_s": [], "numpy_s": []}
    first = None
    for numpy_path in order:
        got, s = timed(numpy_path)
        times["numpy_s" if numpy_path else "native_s"].append(s)
        if first is None:
            first = got
        else:
            same_batch(first, got, f"{label}: native against NumPy build")
        del got
    del first
    torch.cuda.empty_cache()
    return {**times, "ratio": float(np.median(times["numpy_s"]) / np.median(times["native_s"]))}


def native_section(card, bench, bench_u, g_large, molecules, dump):
    """Phase 23 (a): the native host tier on the card's host: every function
    against its NumPy path on full-size inputs, and the host build seconds
    of the native path beside the NumPy path's."""
    import torch
    from gnnkeras_tpu_torch import from_graph_object, native
    from gnnkeras_tpu_torch.data import MultiGraphSequencer
    from gnnkeras_tpu_torch.data.synthetic import ATOM_TYPE_BOUNDS, bench_graph, large_banded_graph

    assert native.available(), f"native host tier unavailable: {native.build_error()}"
    t_phase = time.perf_counter()
    seconds = {}
    # scatter_add_3d, factor_mask_scale and agg_label_sums: the calls of the
    # bench batch's build (bf16 strips: the factorisation fails) and of its
    # twin without parallel arcs (int8 strips: it succeeds)
    recorded = {}
    for label, g in (("bench", bench), ("bench_without_parallel_arcs", bench_u)):
        with recorded_native_calls(("scatter_add_3d", "factor_mask_scale", "agg_label_sums")) as calls:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                from_graph_object(g, slot_pack=128, strip_dtype="int8", device="cpu")
        for name, cs in calls.items():
            assert cs, (label, name)
            for i, (args, kwargs) in enumerate(cs):
                seconds[f"{name}:{label}:{i}"] = native_vs_numpy(name, args, kwargs)
        recorded[label] = {name: len(cs) for name, cs in calls.items()}
    # agg_component_sums: the bench batch's arcs and labels typed into 3 atom types
    src, dst = bench.arcs[:, 0].astype(np.int32), bench.arcs[:, 1].astype(np.int32)
    types = np.searchsorted(ATOM_TYPE_BOUNDS[:-1], np.argmax(bench.nodes, axis=1), side="right")
    seconds["agg_component_sums:bench_3_types"] = native_vs_numpy(
        "agg_component_sums", [src, dst, bench.arcnode_weight, bench.nodes, np.eye(3, dtype=bool)[types],
                               ATOM_TYPE_BOUNDS, bench.nodes.shape[0]])
    # canonical_arcs and unique_i64: the 500k graph's 3,892,679 arcs shuffled,
    # 100,000 of them twice
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(g_large.arcs))
    raw = np.concatenate([g_large.arcs[perm], g_large.arcs[perm[:100_000]]])
    seconds["canonical_arcs:500k"] = native_vs_numpy("canonical_arcs", [raw])
    assert same_bits(native.canonical_arcs(raw), g_large.arcs)
    keys = raw[:, 0].astype(np.int64) * g_large.nodes.shape[0] + raw[:, 1].astype(np.int64)
    seconds["unique_i64:500k"] = native_vs_numpy("unique_i64", [keys])
    seconds["unique_i64_inverse:500k"] = native_vs_numpy("unique_i64", [keys, True])
    del raw, keys
    # load_ints: the TU dump's files
    for name, cols in (("edges", 2), ("graph_indicator", 1), ("node_labels", 1)):
        path = os.path.join(dump, f"SYNTH_{name}.txt")
        seconds[f"load_ints:{name}"] = native_vs_numpy("load_ints", [path, cols])
    checks_s = time.perf_counter() - t_phase

    # host build seconds: the bench batch native, NumPy, NumPy, native; the 500k builds native then
    # NumPy, one of each (readings, not a comparison)
    builds = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the bench batch's bf16 degrade
        builds["bench_batch"] = host_build_pair(
            "bench", lambda: from_graph_object(bench_graph(), slot_pack=128, strip_dtype="int8", device="cuda"),
            turns=2)
    builds["large_500k_banded"] = host_build_pair(
        "500k banded", lambda: from_graph_object(large_banded_graph(), agg_dtype="auto", device="cuda"))
    builds["large_500k_band384_quantised"] = host_build_pair(
        "500k band 384", lambda: from_graph_object(large_banded_graph(band=384), agg_dtype="int8", device="cuda"))

    def sequencer_build_and_rebuild():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            t0 = time.perf_counter()
            seq = MultiGraphSequencer(molecules[:1000], "g", "average", batch_size=1000, slot_pack=128,
                                      strip_dtype="int8", device="cuda")
            first = seq[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            seq.on_epoch_end()
            seq.wait_for_rebuild()
            torch.cuda.synchronize()
            return first, t1 - t0, time.perf_counter() - t1

    seq_s = {k: {"native_s": [], "numpy_s": []} for k in ("sequencer_1000_build", "sequencer_1000_rebuild")}
    first = None
    for numpy_path in (False, True, True, False, False, True):  # three of each, alternating
        np.random.seed(3)
        with native.numpy_path() if numpy_path else contextlib.nullcontext():
            batch, build_s, rebuild_s = sequencer_build_and_rebuild()
        key = "numpy_s" if numpy_path else "native_s"
        seq_s["sequencer_1000_build"][key].append(build_s)
        seq_s["sequencer_1000_rebuild"][key].append(rebuild_s)
        if first is None:
            first = batch
        else:
            same_batch(first, batch, "sequencer batch: native against NumPy build")
    for key, t in seq_s.items():
        builds[key] = {**t, "ratio": float(np.median(t["numpy_s"]) / np.median(t["native_s"]))}
    res = {"phase": "native_host_tier", "available": True, "library": os.path.basename(native.library_path()),
           "bit_identical": sorted(seconds), "recorded_calls": recorded,
           "function_s_native_numpy": {k: list(v) for k, v in seconds.items()}, "checks_s": checks_s,
           "host_build_s": builds, "card": card}
    emit(res)
    return res


def start(name, cmd, procs):
    """Start ``cmd`` from the checkout's root with the checkout importable;
    registered in ``procs`` under ``name`` (the caller stops what is left)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs[name] = (time.perf_counter(), subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                                         stderr=subprocess.PIPE, text=True))


def cli_run(name, args, procs, device="cuda"):
    """Start the CLI (``CLI``) with ``<args> --device <device>``."""
    start(name, [*CLI, *args, "--device", device], procs)


def cli_wait(name, procs, timeout=600):
    """(stdout, the subprocess's kernel launches, seconds) of a CLI run
    started by ``cli_run``; raises with its standard error when it fails."""
    t0, proc = procs.pop(name)
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {name} exited {proc.returncode}:\n{err[-6000:]}")
    lines = [ln for ln in err.splitlines() if ln.startswith('{"kernel_launches"')]
    assert lines, f"CLI {name} printed no kernel launches:\n{err[-3000:]}"
    return out, json.loads(lines[-1])["kernel_launches"], time.perf_counter() - t0


PROFILE_SCRIPT = r"""
import json, sys
import torch
from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules
from gnnkeras_tpu_torch.graph.batch import graphs_to_batch
from gnnkeras_tpu_torch.utils.profiling import annotate, trace

model = flagship_gnn("cuda", seed=0)
batch = graphs_to_batch(random_molecules(256, seed=3), "g", "average", slot_pack=128, device="cuda")
with torch.no_grad():
    model.forward(batch, training=False)
    torch.cuda.synchronize()
    with trace(sys.argv[1]) as prof:
        with annotate("eval_forward"):
            model.forward(batch, training=False)
dev = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in prof.key_averages())
print(json.dumps({"device_us": dev}))
"""


def user_surface_section(card, bench, bench_u, g_large):
    """Phase 23 (module docstring): the native host tier, the CLI on the
    card (single card and 4 ranks), the bench subcommand, the starter and
    serving tools and a profiling trace.  The host builds, the timed kernel
    checks and the bench run with nothing else on the card or the host;
    the subprocesses of a stage run together.  Returns the launches and
    kernel checks of the kernels line."""
    import shutil

    import torch
    from gnnkeras_tpu_torch import (GNNConfig, GNNgraphBased, GraphObject, Predictor, from_graph_object, kernels,
                                    load_exported)
    from gnnkeras_tpu_torch.data.mutag import dataset_splits, load_tu_dataset
    from gnnkeras_tpu_torch.data.synthetic import composite_of, random_molecules, write_tu_dump
    from gnnkeras_tpu_torch.tools import serve, starter, starter_composite

    out, times, procs, cli_out = {}, {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="phase23_")
    try:
        # the pipeline's molecules (phase 19) as a TU dump, 1,000 of them in
        # arc focus as a saved GraphObject dataset
        t0 = time.perf_counter()
        molecules = random_molecules(4337, seed=0, min_nodes=5, max_nodes=56)
        dump = write_tu_dump(molecules, os.path.join(tmp, "tu"), "SYNTH")
        arcs_dir = os.path.join(tmp, "arcs")
        GraphObject.save_dataset(arcs_dir, as_arc_focus(molecules[:1000], seed=8))
        with open(os.path.join(tmp, "arc.json"), "w") as f:
            f.write(GNNConfig(focus="a").to_json())
        times["data"] = time.perf_counter() - t0

        # -- (a) the native host tier, alone ------------------------------------------------------
        t0 = time.perf_counter()
        out["native"] = native_section(card, bench, bench_u, g_large, molecules, dump)
        times["native"] = time.perf_counter() - t0

        # -- stage 1: the CLI's trains (single card, arc focus, 4 ranks) and (f) the profiling trace
        # in subprocesses; (e) the tools in this process meanwhile --------------------------------
        t0 = time.perf_counter()
        model_dir, packed_dir = os.path.join(tmp, "model"), os.path.join(tmp, "packed_model")
        tu = ["--dataset", f"tu:{dump}:SYNTH", "--verbose", "0"]
        cli_run("train", ["train", *tu, "--epochs", "2", "--save", model_dir], procs)
        cli_run("train_arc", ["train", "--config", os.path.join(tmp, "arc.json"), "--dataset", f"npz:{arcs_dir}",
                              "--verbose", "0", "--epochs", "2", "--save", os.path.join(tmp, "arc_model")], procs)
        cli_run("train_packed", ["train", *tu, "--epochs", "1", "--parallel", "packed", "--parallel-devices", "4",
                                 "--save", packed_dir], procs)
        trace_dir = os.path.join(tmp, "trace")
        start("profile", [sys.executable, "-c", PROFILE_SCRIPT, trace_dir], procs)

        tools = {}
        kernels.reset_launches()
        t1 = time.perf_counter()
        built = starter.build(list(molecules), device="cuda", seed=0)
        initial = {k: v.detach().cpu().clone() for k, v in built["gnn"].state_dict().items()}
        np.random.seed(5)  # the epoch-end reshuffle
        res = starter.train(built, fit="gnn", epochs=2, verbose=0)
        # the starters, as the repository's examples, build their sequencers
        # without slot packing: the BCSR block route, no kernel of ours
        tools["starter"] = {"test": res["test"], "history": res["history"].history, "s": time.perf_counter() - t1,
                            "launches": dict(kernels.LAUNCHES)}
        assert np.isfinite(list(res["test"].values())).all()
        # the same starter on the CPU from the same initial weights
        t1 = time.perf_counter()
        host = starter.build(list(molecules), device="cpu", seed=0)
        host["gnn"].load_state_dict(initial)
        np.random.seed(5)
        host = starter.train(host, fit="gnn", epochs=2, verbose=0)
        for key, values in host["history"].history.items():
            np.testing.assert_allclose(res["history"].history[key], values, rtol=1e-4, err_msg=key)
        for key, value in host["test"].items():
            np.testing.assert_allclose(res["test"][key], value, rtol=1e-4, err_msg=key)
        tools["starter"]["cpu_twin"] = {"test": host["test"], "s": time.perf_counter() - t1}
        kernels.reset_launches()
        t1 = time.perf_counter()
        res = starter_composite.run([composite_of(g) for g in molecules], device="cuda", epochs=2, fit="lgnn",
                                    seed=0, verbose=0)
        tools["starter_composite_clgnn"] = {"test": res["test"], "s": time.perf_counter() - t1,
                                            "launches": dict(kernels.LAUNCHES)}
        assert np.isfinite(list(res["test"].values())).all()
        kernels.reset_launches()
        t1 = time.perf_counter()
        served = serve.run(list(molecules), device="cuda", epochs=2, requests=20, verbose=0)
        out["serve_launches"] = dict(kernels.LAUNCHES)
        tools["serve"] = {"accuracy": served["accuracy"], "s": time.perf_counter() - t1,
                          "launches": out["serve_launches"], "request_s": served["request_s"]}
        assert kernels.LAUNCHES["fused_unfold_t"] >= 20, kernels.LAUNCHES
        # the served rows against the same Predictor on the CPU (phase 3's bound)
        model = served["model"]
        model_cpu = GNNgraphBased._from_json(model._json_config()).build(device="cpu")
        model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        p, gte = served["predictor"], served["test_graphs"]
        p_cpu = Predictor.for_graphs(model_cpu, gte, batch_size=8, fused="auto", device="cpu")
        assert p.fused and p_cpu.fused
        for take, got in zip(served["requests"], served["outputs"]):
            np.testing.assert_allclose(got, p_cpu([gte[i] for i in take]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(served["http"]["outputs"][0]), p([gte[0]]), rtol=1e-6, atol=1e-7)
        o, m = served["artifact"]
        _, _, want, want_m, _ = model.forward(served["template"], training=False)
        np.testing.assert_array_equal(m, want_m.cpu().numpy())
        np.testing.assert_allclose(o[m], want.cpu().numpy()[m], rtol=1e-5, atol=1e-6)
        emit({"phase": "tools", **tools, "card": card})

        def wait_train(name):
            stdout, launches, s = cli_wait(name, procs, timeout=900)
            cli_out[name] = {"result": json.loads(stdout.strip().splitlines()[-1]), "launches": launches, "s": s}
            r = cli_out[name]["result"]
            assert np.isfinite(r["test"]["loss"]) and np.isfinite(r["final_train"]["loss"]), (name, r)

        wait_train("train")
        wait_train("train_arc")
        assert cli_out["train"]["launches"]["strip_matmul"] > 0 and cli_out["train"]["launches"]["strip_matmul_t"] > 0
        arc_l = cli_out["train_arc"]["launches"]
        assert arc_l["incidence_select"] > 0 and arc_l["incidence_scatter"] > 0, arc_l
        _, prof = procs.pop("profile")
        pout, perr = prof.communicate(timeout=600)
        assert prof.returncode == 0, perr[-4000:]
        files = os.listdir(trace_dir)
        assert len(files) == 1, files
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
        assert "eval_forward" in names and kernel_events > 0, (len(events), kernel_events)
        emit({"phase": "profiling_trace", "events": len(events), "kernel_events": kernel_events,
              "annotated_span": "eval_forward", **json.loads(pout.strip().splitlines()[-1]), "card": card})

        # -- stage 2 (while the 4 ranks train): evaluate, predict (card and CPU) and export the saved
        # model; then evaluate the 4 ranks' weights ----------------------------------------------------
        ck = ["--model", model_dir, *tu]
        preds = {dev: os.path.join(tmp, f"preds_{dev}.npy") for dev in ("cuda", "cpu")}
        cli_run("evaluate", ["evaluate", *ck], procs)
        cli_run("predict", ["predict", *ck, "--out", preds["cuda"]], procs)
        cli_run("predict_cpu", ["predict", *ck, "--out", preds["cpu"]], procs, device="cpu")
        cli_run("export", ["export", *ck, "--out", os.path.join(tmp, "artifact")], procs)
        wait_train("train_packed")
        times["stage_1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_run("evaluate_packed", ["evaluate", "--model", packed_dir, *tu], procs)
        for name in ("evaluate", "predict", "predict_cpu", "export", "evaluate_packed"):
            stdout, launches, s = cli_wait(name, procs)
            cli_out[name] = {"launches": launches, "s": s, "stdout_tail": stdout.strip().splitlines()[-1:]}
        ev = json.loads(cli_out["evaluate"]["stdout_tail"][0])
        assert close(ev["loss"], cli_out["train"]["result"]["test"]["loss"]), (ev, cli_out["train"])
        ev_packed = json.loads(cli_out["evaluate_packed"]["stdout_tail"][0])
        assert close(ev_packed["loss"], cli_out["train_packed"]["result"]["test"]["loss"]), ev_packed
        # export traces the forward (its kernels' fake versions): no launch there
        for name in ("evaluate", "predict", "evaluate_packed"):
            assert cli_out[name]["launches"]["strip_matmul"] > 0, (name, cli_out[name]["launches"])
        assert not any(cli_out["predict_cpu"]["launches"].values())
        cfg = GNNConfig(epochs=2)
        graphs = load_tu_dataset(dump, "SYNTH")
        for g in graphs:
            g.setAggregation(cfg.aggregation_mode)
        tr, te, _ = dataset_splits(graphs, seed=42)  # the CLI's split
        p_card, p_host = np.load(preds["cuda"]), np.load(preds["cpu"])
        assert p_card.shape == (len(te), 2) and np.isfinite(p_card).all()
        np.testing.assert_allclose(p_card, p_host, rtol=1e-5, atol=1e-6)  # phase 4's bounds
        # the exported artifact against the saved model's forward, on the export's template
        saved = GNNgraphBased.load(model_dir, device="cuda")
        art = load_exported(os.path.join(tmp, "artifact"), device="cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            template = cfg.build_sequencer(tr[: cfg.batch_size], shuffle=False, device="cuda")[0]
        kernels.reset_launches()
        a_out, a_mask = art.call(template)
        torch.cuda.synchronize()
        artifact_launches = dict(kernels.LAUNCHES)
        assert artifact_launches["strip_matmul"] > 0, artifact_launches
        _, _, f_out, f_mask, _ = saved.forward(template, training=False)
        assert torch.equal(a_mask, f_mask)
        mk = f_mask.cpu().numpy()
        np.testing.assert_allclose(a_out.cpu().numpy()[mk], f_out.cpu().numpy()[mk], rtol=1e-5, atol=1e-6)
        times["stage_2"] = time.perf_counter() - t0

        # -- the kernels on the CLI's own batches and at a served request's template, then (d)
        # bench, each alone on the card -------------------------------------------------------------
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            cli_batch = cfg.build_sequencer(tr, shuffle=False, device="cuda")[0]  # its first training batch
        out["strip_check"] = check_strip(cli_batch.strip, "cli_train_batch", timed=True)
        out["strip_t_check"] = check_strip(cli_batch.strip, "cli_train_batch", timed=True, name="strip_matmul_t")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            predict_batch = cfg.build_sequencer(te, shuffle=False, device="cuda")[0]  # the batch predict sees
        out["strip_predict_check"] = check_strip(predict_batch.strip, "cli_predict_batch", timed=True)
        arc_graphs = GraphObject.load_dataset(arcs_dir, "a", "average")
        arc_batch = GNNConfig(focus="a").build_sequencer(dataset_splits(arc_graphs, seed=42)[0], shuffle=False,
                                                         device="cuda")[0]
        out["select_check"], out["scatter_check"] = check_incidence(
            arc_batch.arc_inc, arc_batch.arc_src.cpu().numpy(), arc_batch.arc_dst.cpu().numpy(), "cli_arc_batch",
            timed=True)
        req = GraphObject.merge([gte[i] for i in served["requests"][0]], focus="g", aggregation_mode="average")
        req_batch = from_graph_object(req, pad_nodes=p.max_nodes, pad_arcs=p.max_arcs, tile_pack=True,
                                      compact_gmax=p.max_graphs, compact_nspan=p.max_nodes // 128 + 1, device="cuda")
        out["fused_check"] = check_fused(model, req_batch, "serve_tool_request", timed=True)
        times["kernel_checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_run("bench", ["bench"], procs)
        stdout, launches, s = cli_wait("bench", procs)
        bench_line = json.loads(stdout.strip().splitlines()[-1])
        assert bench_line["metric"] == "transition_edges_per_s" and bench_line["value"] > 0, bench_line
        assert bench_line["device"] == "cuda" and bench_line["card"], bench_line
        assert launches["strip_matmul"] > 0, launches
        cli_out["bench"] = {"result": bench_line, "launches": launches, "s": s}
        times["bench"] = time.perf_counter() - t0
        for name, r in cli_out.items():
            emit({"phase": "cli", "command": name, **r, "card": card})
        out["cli"] = cli_out
        emit({"phase": "user_surface_timing", "phase_s": times, "artifact_call_launches": artifact_launches,
              "card": card})
        return out
    finally:
        for _, proc in procs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def close(a, b, rel=1e-6):
    """``a`` within ``rel`` of ``b``: the same model's loss on the same
    batches, computed by another process."""
    return abs(a - b) <= rel * abs(b)


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
    build_s = time.perf_counter() - t0
    # the native host tier (g++), before any host build uses it
    from gnnkeras_tpu_torch import native

    assert native.available(), f"native host tier unavailable: {native.build_error()}"
    emit({"phase": "build", "card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "native_build_s": time.perf_counter() - t0 - build_s, "ptxas": ptxas})
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

    # -- 20. the scanned epoch: a captured CUDA graph --------------------------------
    t_phase = time.perf_counter()
    scanned = scanned_epoch_section(card, pipeline["splits"])
    times["scanned_epoch"] = time.perf_counter() - t_phase

    # -- 21. data-parallel, packed, tensor-parallel and hybrid training ----------------
    t_phase = time.perf_counter()
    dist = distributed_section(card, bench, b_bench, b_bench_cpu, large["graph"], large["batch"])
    times["distributed"] = time.perf_counter() - t_phase

    # -- 22. expert-parallel, pipelined and composite-partitioned training -------------
    t_phase = time.perf_counter()
    xp = expert_pipeline_section(card, bench, b_bench, b_bench_cpu, dist.pop("packed_parts"))
    times["expert_pipeline"] = time.perf_counter() - t_phase

    # -- 23. the user surface and the native host tier -----------------------------------
    t_phase = time.perf_counter()
    user = user_surface_section(card, bench, bench_u, large["graph"])
    times["user_surface"] = time.perf_counter() - t_phase
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
        # phase 20, rows 1/1b and 5-7 in the captured epochs: launches per
        # replay (one replay an epoch) from the profiler's trace, each leg's
        # kernels checked on a batch of its own sequencer
        *[entry(f"{name}_scanned_epoch{suffix}", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                scanned[leg]["replay"]["launches"].get(name, 0), scanned["checks"][(leg, name)])
          for leg, suffix in (("flagship", ""), ("clgnn", "_clgnn"), ("arc", "_arc"))
          for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_scanned_epoch_arc", inc_src, "gnnkeras_tpu/ops/incidence.py:375",
                scanned["arc"]["replay"]["launches"].get(name, 0), scanned["checks"][name])
          for name in ("incidence_select", "incidence_scatter")],
        # phase 21, rows 1/1b on the distributed paths, launches per rank (rank
        # 0 of 4): the packed flagship and the packed 3-layer LGNN at each of
        # its widths (checked on packed part 0's own operator at that width),
        # one data-parallel step (a sequencer batch's operator, phase 19's
        # check), the tensor-parallel step (the bench operator, phase 2's
        # check) and the hybrid steps' banded diagonals (checked on hybrid
        # part 0's local main diagonal)
        *[entry(f"{name}_packed", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                dist["ranks"][0]["packed_step"]["launches"][name], dist["checks"][(16, name)])
          for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_packed_lgnn_d{d}", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                dist["ranks"][0]["lgnn_step"]["widths"][(name, d)], dist["checks"][(d, name)])
          for d in (16, 32, 48) for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_data_parallel", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                dist["ranks"][0]["dp_step"]["launches"][name], pipeline[("check", 16, name)])
          for name in ("strip_matmul", "strip_matmul_t")],
        entry("strip_matmul_tensor_parallel", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              dist["ranks"][0]["tp_step"]["launches"]["strip_matmul"], strip_bf16),
        entry("strip_matmul_t_tensor_parallel", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              dist["ranks"][0]["tp_step"]["launches"]["strip_matmul_t"], strip_t_bf16),
        *[entry(f"{name}_hybrid_banded_diagonal", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                dist["ranks"][0]["hybrid2"]["launches"][name], dist["hybrid_checks"][name])
          for name in ("strip_matmul", "strip_matmul_t")],
        # phase 22, launches per rank (rank 0 of 4): rows 1/1b in the expert-parallel step (the typed bench
        # operator, which every rank holds whole, at the experts' d 16), in the pipelined steps (rank 0's
        # layer: M = 1 on the bench operator, phase 2's check at the same d 16; M = 4 on a microbatch's own
        # operator), on the composite partitioned int8 leg's banded diagonals, and row 8 on the band-384
        # leg's quantised operators (each checked on rank 0's own local operator); row 9 on the typed
        # partition's halo, at its shape
        *[entry(f"{name}_expert_parallel", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                xp["ranks"][0]["ep_step"]["launches"][name], xp["checks"][("typed_bench", name)])
          for name in ("strip_matmul", "strip_matmul_t")],
        entry("strip_matmul_pipeline", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              xp["ranks"][0]["pp_step"]["launches"]["strip_matmul"], strip_bf16),
        entry("strip_matmul_t_pipeline", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              xp["ranks"][0]["pp_step"]["launches"]["strip_matmul_t"], strip_t_bf16),
        *[entry(f"{name}_pipeline_m4", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                xp["ranks"][0]["pp_m4"]["launches"][name], xp["checks"][("pipeline_microbatch_0", name)])
          for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_composite_partitioned_banded", strip_src, "gnnkeras_tpu/ops/strip.py:278",
                xp["ranks"][0]["partitioned"]["typed_int8"]["step"]["launches"][name],
                xp["ranks"][0]["banded_checks"][name])
          for name in ("strip_matmul", "strip_matmul_t")],
        *[entry(f"{name}_composite_partitioned", qbcsr_src, "gnnkeras_tpu/ops/bcsr.py:378",
                xp["ranks"][0]["partitioned"]["band384_int8"]["step"]["launches"][name],
                xp["ranks"][0]["qbcsr_checks"][name])
          for name in ("qbcsr_matmul", "qbcsr_matmul_t")],
        entry("ring_all_gather_composite_partitioned", "gnnkeras_tpu_torch/csrc/ring.cu", "gnnkeras_tpu/ops/ring.py:25",
              xp["ranks"][0]["partitioned"]["typed"]["pallas_ring"]["launches"]["ring_all_gather"],
              xp["ranks"][0]["ring_check"]),
        # phase 23, launches counted in the CLI's own processes: rows 1/1b in
        # the 2-epoch train (checked on its first training batch's operator),
        # row 1 in predict (checked on the test split's batch), rows 5-7 (at or below 10,240 pairs: the fused
        # kernel's pair list) in the arc-focus train (checked on its first
        # batch's pairs), and row 2 in the serving tool (in this process,
        # checked at a served request's template)
        entry("strip_matmul_cli_train", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              user["cli"]["train"]["launches"]["strip_matmul"], user["strip_check"]),
        entry("strip_matmul_t_cli_train", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              user["cli"]["train"]["launches"]["strip_matmul_t"], user["strip_t_check"]),
        entry("strip_matmul_cli_predict", strip_src, "gnnkeras_tpu/ops/strip.py:278",
              user["cli"]["predict"]["launches"]["strip_matmul"], user["strip_predict_check"]),
        entry("incidence_select_cli_arc_train", inc_src, "gnnkeras_tpu/ops/incidence.py:375",
              user["cli"]["train_arc"]["launches"]["incidence_select"], user["select_check"]),
        entry("incidence_scatter_cli_arc_train", inc_src, "gnnkeras_tpu/ops/incidence.py:375",
              user["cli"]["train_arc"]["launches"]["incidence_scatter"], user["scatter_check"]),
        entry("fused_unfold_t_serve_tool", fused_src, "gnnkeras_tpu/ops/fused.py:241",
              user["serve_launches"]["fused_unfold_t"], user["fused_check"]),
    ]})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
