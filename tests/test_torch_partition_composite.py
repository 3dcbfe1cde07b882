"""Composite graphs and models on the edge-partitioned engine
(``gnnkeras_tpu_torch/parallel/partition.py``) against the JAX package's
``gnnkeras_tpu.parallel.partition`` on the CPU.

- ``partition_graph`` on composite graphs, array for array against JAX's
  (``type_mask`` and the host's f64 per-type label sums ``agg_component``
  among the fields): node focus with halo, with ``reorder='rcm'``, a
  merged graph-focused batch on block operators, and a wide-band graph
  whose parts' local operators are quantised (``agg_dtype='int8'``, kernel
  row 8's operator).
- ``PartitionedGNN`` with a composite model on 2 gloo ranks spawned once
  for the module (``port_results``).  Against JAX's ``PartitionedGNN`` on
  a 2-device ``graph`` mesh: the graph-focused forward through the
  collective and the ring transport (rtol 1e-5 / atol 1e-6), and one Adam
  step (loss and moving statistics at rtol 1e-5; parameters at rtol 1e-5 /
  atol 1e-6 where Adam's first step is not steep in the gradient,
  ``torch_port_common.adam_live``).  Against JAX's single-device composite
  model (what JAX's own tests hold its engine to): the node-focused
  forward through both transports on the halo partition and through the
  quantised local operators (rtol 1e-5 / atol 1e-6 on the real rows).
- ``evaluate`` (the loss of JAX's forward output) and a 2-epoch ``fit``.
- ``tools/bench_packed.py`` at a tiny size on the 2 ranks prints its line.
- Tensor parallelism refuses a composite model.

The inputs are made with NumPy from seeds; the port's weights are the JAX
model's.  This module imports JAX only inside its fixtures and tests, so
the ranks, which import it to find ``_rank_cases``, import no JAX.
"""

import sys

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

PARTS = 2
DIMS = (2, 3, 4)  # per-type label widths; the labels are 4 wide
RTOL, ATOL = 1e-5, 1e-6


# -- graphs (NumPy specs, both packages) ---------------------------------------------------


def _banded_spec(seed, n=512, per_node=4, band=6, mode="composite_average"):
    """A node-focused composite graph: banded arcs (one per node pair), 3
    random node types."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    pairs = np.unique(np.stack([src, dst], 1)[src != dst], axis=0)  # no parallel arcs
    arcs = np.concatenate([pairs, rng.normal(size=(len(pairs), 2))], axis=1)
    tm = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    return dict(nodes=rng.normal(size=(n, max(DIMS))), arcs=arcs, targets=rng.normal(size=(n, 2)), type_mask=tm,
                dim_node_label=DIMS, focus="n", aggregation_mode=mode)


def _merged_specs(seed=33, n_graphs=24):
    """``tests/test_parallel.py``'s merged composite batch (graph focus)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n, a = int(rng.integers(6, 14)), int(rng.integers(12, 28))
        nodes = rng.normal(size=(n, max(DIMS)))
        arcs = np.concatenate([rng.integers(0, n, (a, 2)), rng.normal(size=(a, 2))], axis=1)
        tm = np.zeros((n, 3), dtype=bool)
        tm[np.arange(n), rng.integers(0, 3, n)] = True
        t = np.zeros((1, 2))
        t[0, rng.integers(2)] = 1
        out.append(dict(nodes=nodes, arcs=arcs, targets=t, type_mask=tm, dim_node_label=DIMS, focus="g",
                        aggregation_mode="composite_average"))
    return out


def _merged(module, specs):
    return module.CompositeGraphObject.merge([module.CompositeGraphObject(**s) for s in specs], focus="g",
                                             aggregation_mode="composite_average")


# -- models ---------------------------------------------------------------------------------


def _nets(module, focus="n"):
    width, comp = max(DIMS), sum(DIMS) + 2
    nets = [module.MLP(input_dim=(d_t + 2 * width + comp,), layers=[width], activations="selu",
                       kernel_initializer="lecun_normal", bias_initializer="lecun_normal") for d_t in DIMS]
    out = module.MLP(input_dim=(width,), layers=[2], activations="softmax", kernel_initializer="glorot_normal",
                     bias_initializer="glorot_normal")
    return nets, out


_CLASSES = {"n": "CompositeGNNnodeBased", "g": "CompositeGNNgraphBased"}
_LOSS = {"n": "mse", "g": "categorical_crossentropy"}


def _port_model(focus, state):
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = getattr(tcomp, _CLASSES[focus])(*_nets(tmlp, focus), 0, 4, 0.01).build(seed=0, device="cpu")
    m.load_state_dict(state)
    return m


# -- the port's ranks -------------------------------------------------------------------------


def _rank_cases(rank: int, world: int, cases: dict, bench: tuple) -> dict:
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.tools import bench_packed

    parts, whole, n_arcs = bench
    out = {"bench_packed": bench_packed.run_rank(rank, world, parts[rank], whole if rank == 0 else None, n_arcs,
                                                 repeats=2, device="cpu")}
    for name, case in cases.items():
        shard = case["pg"].shard(rank, "cpu")
        model = _port_model(case["focus"], case["state"])
        engine = PartitionedGNN(model, transport=case.get("transport", "collective"))
        if case["op"] == "forward":
            k, state, o, _ = engine.forward(shard)
            out[name] = (float(k), state.numpy(), o.numpy())
            continue
        model.compile(optimizer="adam:0.01", loss=_LOSS[case["focus"]], metrics=["accuracy"])
        logs = engine.train_step(shard)
        out[name] = {"loss": float(logs["loss"]), "k": float(logs["k"]),
                     "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                     "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                     "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()}}
        fresh = _port_model(case["focus"], case["state"])
        fresh.compile(optimizer="adam:0.01", loss=_LOSS[case["focus"]], metrics=["accuracy"])
        out["evaluate"] = PartitionedGNN(fresh).evaluate(shard)
        out["fit"] = PartitionedGNN(fresh).fit(shard, epochs=2, verbose=0).history
    out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "gnnkeras_tpu.")))
    return out


# -- fixtures -----------------------------------------------------------------------------------


def _jax_model(focus, seed):
    import jax

    import gnnkeras_tpu.models.composite as jcomp
    import gnnkeras_tpu.models.mlp as jmlp
    import torch_port_common as C
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = getattr(jcomp, _CLASSES[focus])(*_nets(jmlp, focus), 0, 4, 0.01)
    jm.build(seed=seed)
    jm.variables = C.perturb_bn_tree(jm.variables, seed)
    return jm, variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))


_PARTITIONS = {
    "node_halo": (lambda: _banded_spec(7), dict()),
    "node_rcm": (lambda: _banded_spec(7), dict(reorder="rcm")),
    "node_blocks_int8": (lambda: _banded_spec(5, n=1024, band=300, mode="average"),
                         dict(dense_blocks=True, agg_dtype="int8")),
    "merged_blocks": (_merged_specs, dict(dense_blocks=True)),
}


def _pair(key):
    """(JAX graph, port graph, partition keywords) of a case."""
    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu_torch.graph.graph as tgraph

    make, kw = _PARTITIONS[key]
    spec = make()
    if key == "merged_blocks":
        return _merged(jgraph, spec), _merged(tgraph, spec), kw
    return jgraph.CompositeGraphObject(**spec), tgraph.CompositeGraphObject(**spec), kw


@pytest.fixture(scope="module")
def setups():
    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.parallel.partition import partition_graph as tpartition

    parts = {}
    for key in ("node_halo", "node_blocks_int8", "merged_blocks"):
        jg, tg, kw = _pair(key)
        parts[key] = (jg, jpartition(jg, PARTS, **kw), tpartition(tg, PARTS, **kw))
    return parts, {"n": _jax_model("n", 3), "g": _jax_model("g", 9)}


_CASES = {
    "g_collective": ("merged_blocks", "collective", "forward"),
    "g_ring": ("merged_blocks", "pallas_ring", "forward"),
    "g_step": ("merged_blocks", "collective", "train_step"),
    "n_collective": ("node_halo", "collective", "forward"),
    "n_ring": ("node_halo", "pallas_ring", "forward"),
    "n_int8": ("node_blocks_int8", "collective", "forward"),
}


@pytest.fixture(scope="module")
def port_results(setups):
    parts, models = setups
    cases = {}
    for name, (key, transport, op) in _CASES.items():
        focus = "g" if key == "merged_blocks" else "n"
        cases[name] = {"pg": parts[key][2], "focus": focus, "state": models[focus][1], "transport": transport,
                       "op": op}
    from gnnkeras_tpu_torch.tools.bench_packed import build_graph, build_inputs

    bench = build_inputs(build_graph(12), PARTS)
    return spawn(_rank_cases, PARTS, [(cases, bench)] * PARTS)


@pytest.fixture(scope="module")
def mesh2():
    import jax

    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(("graph",), devices=jax.devices()[:PARTS])


# -- partition_graph ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(_PARTITIONS))
def test_partition_graph_composite_matches_jax(case):
    import jax

    import torch_port_common as C
    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.parallel.partition import partition_graph as tpartition

    jg, tg, kw = _pair(case)
    jp, tp = jpartition(jg, PARTS, **kw), tpartition(tg, PARTS, **kw)
    assert (tp.n_parts, tp.nodes_per_part, tp.n_graphs, tp.focus) == (jp.n_parts, jp.nodes_per_part, jp.n_graphs,
                                                                       jp.focus)
    assert tp.type_mask is not None and tp.agg_component is not None
    for name in ("nodes", "node_mask", "arc_src_global", "arc_dst_local", "arc_weight", "arc_label", "arc_mask",
                 "set_mask", "output_mask", "targets", "target_mask", "sample_weight", "publish_local",
                 "publish_mask", "arc_src_halo", "graph_of_node", "nodegraph_weight", "agg_arc_labels",
                 "agg_node_labels", "type_mask", "agg_component"):
        j, t = getattr(jp, name), getattr(tp, name)
        if j is None:
            assert t is None, name
            continue
        np.testing.assert_array_equal(t, C.np_of_jax(j), err_msg=name)
    if case == "node_blocks_int8":
        from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr

        assert all(isinstance(op, QuantBcsr) and op.scale is not None for op in tp.local_ops)
        for p in range(PARTS):
            jq = jax.tree_util.tree_map(lambda x: x[p], jp.local_bcsr)
            for f in ("blocks", "src_tile", "dst_tile", "scale", "mask"):
                if hasattr(jq, f):
                    np.testing.assert_array_equal(C.np_of(getattr(tp.local_ops[p], f)), C.np_of_jax(getattr(jq, f)),
                                                  err_msg=f"local_ops[{p}].{f}")


# -- the engine against JAX's engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_graph_forward(setups, mesh2):
    """JAX's engine's inference forward of the merged composite batch."""
    import torch_port_common as C
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN

    parts, models = setups
    with C.fast_jax_jit():
        k, state, out, _ = JPartitionedGNN(models["g"][0], mesh2).forward(parts["merged_blocks"][1], training=False)
    return float(k), np.asarray(state), np.asarray(out)


def test_graph_focus_forward_matches_jax_engine(port_results, jax_graph_forward):
    k, state, out = jax_graph_forward
    for r, res in enumerate(port_results):
        for name in ("g_collective", "g_ring"):
            tk, tstate, tout = res[name]
            assert tk == float(k), (name, r)
            np.testing.assert_allclose(tstate, state[r], rtol=RTOL, atol=ATOL, err_msg=f"{name} state, rank {r}")
            np.testing.assert_allclose(tout, out[r], rtol=RTOL, atol=ATOL, err_msg=f"{name} out, rank {r}")


def test_graph_focus_adam_step_matches_jax_engine(setups, port_results, mesh2):
    import jax
    import jax.numpy as jnp

    import torch_port_common as C
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN

    parts, models = setups
    jm = models["g"][0]
    jm.compile(optimizer="adam:0.01", loss="categorical_crossentropy")
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    params, mstate = copy(jm.variables["params"]), copy(jm.variables["state"])
    engine = JPartitionedGNN(jm, mesh2)
    with C.fast_jax_jit():
        new_params, new_mstate, _, logs = engine.make_train_step()(params, mstate, jm.optimizer.init(params),
                                                                   parts["merged_blocks"][1], jax.random.PRNGKey(0))
    want_params, want_stats = C.port_dict(new_params, "params"), C.port_dict(new_mstate, "state")
    for r, res in enumerate(port_results):
        got = res["g_step"]
        np.testing.assert_allclose(got["loss"], float(logs["loss"]), rtol=RTOL, err_msg=f"loss, rank {r}")
        assert got["k"] == float(logs["k"])
        for n, v in got["buffers"].items():
            np.testing.assert_allclose(v, want_stats[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)
        for n, v in got["params"].items():
            g = got["grads"][n]
            np.testing.assert_array_equal(g, port_results[0]["g_step"]["grads"][n], err_msg=n)  # one mean gradient
            keep = C.adam_live(g, g)
            np.testing.assert_allclose(v[keep], want_params[n].numpy()[keep], rtol=RTOL, atol=ATOL, err_msg=n)


def test_evaluate_and_fit(setups, port_results, jax_graph_forward):
    """``evaluate``: the loss of JAX's engine's forward output; ``fit``: two
    finite epochs every rank agrees on, the first the step's loss."""
    jpg = setups[0]["merged_blocks"][1]
    p, y, m = jax_graph_forward[2][0], np.asarray(jpg.targets)[0], np.asarray(jpg.target_mask)[0]
    want = float(np.sum(-np.sum(y * np.log(np.clip(p, 1e-7, 1 - 1e-7)), axis=1) * m) / m.sum())
    for res in port_results:
        np.testing.assert_allclose(res["evaluate"]["loss"], want, rtol=RTOL)
        assert res["fit"] == port_results[0]["fit"]
        assert len(res["fit"]["loss"]) == 2 and np.isfinite(res["fit"]["loss"]).all()
        np.testing.assert_allclose(res["fit"]["loss"][0], res["g_step"]["loss"], rtol=RTOL)


# -- the engine against JAX's single-device model --------------------------------------------------


@pytest.mark.parametrize("key,names", [("node_halo", ("n_collective", "n_ring")), ("node_blocks_int8", ("n_int8",))])
def test_node_focus_forward_matches_jax_single_device(setups, port_results, key, names):
    import gnnkeras_tpu.graph.batch as jbatch
    import torch_port_common as C

    parts, models = setups
    jg, jpg, tpg = parts[key]
    jm = models["n"][0]
    k, state, out = C.run_jitted(lambda v, b: jm.forward(v, b, training=False)[:3], jm.variables,
                                 jbatch.from_graph_object(jg, dense_blocks=False))
    n = jg.nodes.shape[0]
    state, out = np.asarray(state)[:n], np.asarray(out)[:n]
    mask = tpg.node_mask
    for name in names:
        got_state = np.concatenate([res[name][1] for res in port_results])[mask.reshape(-1)]
        got_out = np.concatenate([res[name][2] for res in port_results])[mask.reshape(-1)]
        for res in port_results:
            assert res[name][0] == float(k), name
        np.testing.assert_allclose(got_state, state, rtol=RTOL, atol=ATOL, err_msg=f"{name} state")
        np.testing.assert_allclose(got_out, out, rtol=RTOL, atol=ATOL, err_msg=f"{name} out")


def test_bench_packed_tool_prints_its_line(port_results):
    """``tools/bench_packed.py`` at a tiny size (12 molecules) on the 2
    ranks: rank 0 prints both engines' ms and edges/s and their ratio."""
    res = port_results[0]["bench_packed"]
    assert res["line"].startswith("ranks=2 plain ") and "packed-partitioned" in res["line"] and "ratio" in res["line"]
    assert all(np.isfinite(res[k]) and res[k] > 0 for k in ("plain_ms", "packed_ms", "ratio", "plain_edges_per_s"))
    assert port_results[1]["bench_packed"]["packed_ms"] == res["packed_ms"]  # the slowest rank's, on every rank


def test_tensor_parallel_refuses_composite_models():
    from gnnkeras_tpu_torch.data.synthetic import typed_cgnn
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

    with pytest.raises(NotImplementedError, match="homogeneous"):
        PartitionedGNN(typed_cgnn(0, device="cpu"), tp_shards=2)


def test_ranks_import_no_jax(port_results):
    """The spawned ranks ran the port alone: no JAX and nothing of the JAX
    package in their processes."""
    assert [res["jax_imported"] for res in port_results] == [[]] * len(port_results)
