"""The edge-partitioned engine (``gnnkeras_tpu_torch/parallel/partition.py``)
against the JAX package's ``gnnkeras_tpu.parallel.partition`` on the CPU.

- ``partition_graph``: array for array, on banded and merged graphs, with
  halo, ``dense_blocks``, ``reorder='rcm'`` and every ``agg_dtype``.
- ``PartitionedGNN``: the port runs on 4 gloo ranks (one set of ranks for
  every case, ``port_results``), the JAX package on a 4-device sub-mesh of
  the conftest's 8 CPU devices (its ring kernel in interpret mode).  The
  forward (node, arc and graph focus, both transports, inference and
  training-mode BatchNorm) is held to rtol 1e-5 / atol 1e-6, as
  ``tests/test_parallel.py`` holds the ring to the collective transport.
  One Adam step through ``collective``: loss and moving statistics at
  rtol 1e-5; parameters at rtol 1e-5 / atol 1e-6 where a leaf's gradient
  is at least 1e-6 of its largest |g| (Adam's first step is about
  lr·sign(g), so an entry of smaller |g| can move by 2·lr on a
  summation-order sign flip; such entries are counted, and there are none
  here); the gradients themselves at rtol 1e-4 / atol 1e-5 of the leaf's
  largest |g| (sums over ranks in another order).
- Training through ``pallas_ring`` raises ``NotImplementedError`` (the ring
  has no backward, in either package).

The inputs are made with NumPy from seeds; the port's weights are the JAX
model's (``convert.variables_from_jax``).  This module imports JAX only
inside its fixtures and tests, so the port's ranks, which import it to find
``_rank_cases``, import no JAX.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

PARTS = 4
DIMS = (3, 2, 2)  # node label, arc label, target widths
MAX_ITER, THRESHOLD = 5, 0.01
RTOL, ATOL = 1e-5, 1e-6


# -- graphs (NumPy, both packages) ---------------------------------------------


def _banded_raw(seed, n=512, per_node=4, band=6):
    """A banded graph (each partition's halo is a small boundary set)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    arcs = np.concatenate([np.stack([src, dst], 1), rng.normal(size=(len(src), 2))], axis=1)
    return rng.normal(size=(n, 3)), arcs, rng


def _graph_pair(focus, seed, **kw):
    """(JAX GraphObject, port GraphObject) of the same banded graph, focus
    'n' or 'a', average aggregation, normal targets."""
    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu_torch.graph.graph as tgraph

    nodes, arcs, rng = _banded_raw(seed, **kw)
    tmp = jgraph.GraphObject(nodes=nodes, arcs=arcs, targets=np.ones((len(nodes), 2)), focus="n")
    rows = len(nodes) if focus == "n" else tmp.arcs.shape[0]
    targets = rng.normal(size=(rows, 2))
    jg = jgraph.GraphObject(nodes=nodes, arcs=tmp.arcs, targets=targets, focus=focus, aggregation_mode="average")
    tg = tgraph.GraphObject(nodes=nodes, arcs=tmp.arcs, targets=targets, focus=focus, aggregation_mode="average")
    return jg, tg


def _merged_pair(seed=31):
    """A merged batch of molecules (graph focus), one-hot graph targets."""
    import torch_port_common as C

    raw = [(n[:, :3], np.concatenate([a[:, :2], a[:, 2:4]], 1), t)
           for n, a, t in C.raw_molecules(n_graphs=24, seed=seed, dn=3, da=2)]
    return C.merged_pair(raw, focus="g")


# -- models ---------------------------------------------------------------------

_CLASSES = {"n": "GNNnodeBased", "a": "GNNarcBased", "g": "GNNgraphBased"}


def _nets(module, focus):
    dn, da, dt = DIMS
    ins, ls = module.get_inout_dims("state", dn, da, dt, focus, 0)
    ino, lo = module.get_inout_dims("output", dn, da, dt, focus, 0)
    return (module.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                       bias_initializer="lecun_normal"),
            module.MLP(input_dim=ino[0], layers=lo, activations="softmax", kernel_initializer="glorot_normal",
                       bias_initializer="glorot_normal"))


def _jax_model(focus, seed):
    """The JAX model with non-trivial BatchNorm statistics, and the port's
    state dict of the same weights."""
    import jax

    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.mlp as jmlp
    import torch_port_common as C
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = getattr(jgnn, _CLASSES[focus])(*_nets(jmlp, focus), 0, MAX_ITER, THRESHOLD)
    jm.build(seed=seed)
    jm.variables = C.perturb_bn(jm.variables, seed)
    return jm, variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))


def _port_model(focus, state):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = getattr(tgnn, _CLASSES[focus])(*_nets(tmlp, focus), 0, MAX_ITER, THRESHOLD).build(seed=0, device="cpu")
    m.load_state_dict(state)
    return m


_LOSS = {"n": "mse", "a": "mse", "g": "categorical_crossentropy"}


# -- the port's ranks -------------------------------------------------------------


def _rank_cases(rank: int, world: int, cases: dict) -> dict:
    """Every case on this rank: forwards, train steps, evaluate, fit, and
    the ring's refusal to train."""
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

    out = {}
    for name, case in cases.items():
        shard = case["pg"].shard(rank, "cpu")
        model = _port_model(case["focus"], case["state"])
        engine = PartitionedGNN(model, transport=case["transport"])
        op = case["op"]
        if op == "forward":
            k, state, o, bn = engine.forward(shard, training=case["training"])
            out[name] = (float(k), state.numpy(), o.numpy(), {key: v.numpy() for key, v in bn.items()})
            continue
        model.compile(optimizer="adam:0.01", loss=_LOSS[case["focus"]], metrics=["mse"])
        if op == "train_step":
            logs = engine.train_step(shard)
            out[name] = {"loss": float(logs["loss"]), "k": float(logs["k"]),
                         "params": {n: p.detach().numpy() for n, p in model.named_parameters()},
                         "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
                         "buffers": {n: b.numpy() for n, b in model.named_buffers()}}
        elif op == "evaluate":
            out[name] = engine.evaluate(shard)
        elif op == "fit":
            out[name] = engine.fit(shard, epochs=3, steps_per_launch=2, verbose=0).history
        else:  # ring training must refuse
            try:
                engine.train_step(shard)
                out[name] = "trained"
            except NotImplementedError as err:
                out[name] = str(err)
    return out


# -- fixtures ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    """The graphs, partitions (both packages) and models of every case."""
    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.parallel.partition import partition_graph as tpartition

    out = {}
    jn, tn = _graph_pair("n", seed=7)
    jb, tb = _graph_pair("n", seed=7, n=2048)
    ja, ta = _graph_pair("a", seed=5)
    jgm, tgm = _merged_pair()
    for key, jg, tg, kw in (("n_halo", jn, tn, {}), ("n_blocks_auto", jb, tb, dict(dense_blocks=True, agg_dtype="auto")),
                            ("n_blocks", jb, tb, dict(dense_blocks=True)), ("a_halo", ja, ta, {}),
                            ("g_blocks", jgm, tgm, dict(dense_blocks=True))):
        out[key] = (jpartition(jg, PARTS, **kw), tpartition(tg, PARTS, **kw), jg.focus)
    models = {focus: _jax_model(focus, seed) for focus, seed in (("n", 5), ("a", 6), ("g", 7))}
    return out, models


# (partition, transport, op, training)
_CASES = {
    "n_collective": ("n_halo", "collective", "forward", False),
    "n_ring": ("n_halo", "pallas_ring", "forward", False),
    "n_collective_training_bn": ("n_halo", "collective", "forward", True),
    "n_blocks_auto_ring": ("n_blocks_auto", "pallas_ring", "forward", False),
    "a_collective": ("a_halo", "collective", "forward", False),
    "a_ring": ("a_halo", "pallas_ring", "forward", False),
    "g_blocks_collective": ("g_blocks", "collective", "forward", False),
    "g_blocks_ring": ("g_blocks", "pallas_ring", "forward", False),
    "n_blocks_step": ("n_blocks", "collective", "train_step", True),
    "g_blocks_step": ("g_blocks", "collective", "train_step", True),
    "n_evaluate": ("n_halo", "collective", "evaluate", False),
    "n_fit": ("n_blocks", "collective", "fit", True),
    "n_ring_train": ("n_halo", "pallas_ring", "ring_train", True),
}


@pytest.fixture(scope="module")
def port_results(setups):
    parts, models = setups
    cases = {name: {"pg": parts[p][1], "focus": parts[p][2], "state": models[parts[p][2]][1], "transport": tr,
                    "op": op, "training": training}
             for name, (p, tr, op, training) in _CASES.items()}
    return spawn(_rank_cases, PARTS, [(cases,)] * PARTS)


@pytest.fixture(scope="module")
def mesh4():
    import jax

    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(("graph",), devices=jax.devices()[:PARTS])


# -- partition_graph ------------------------------------------------------------------


def _assert_tree_equal(jx, tx, what):
    """A port operator (or array) equals the JAX one, leaf for leaf; bf16 by
    its bits."""
    import torch_port_common as C

    if tx is None or jx is None:
        assert tx is None and jx is None, what
        return
    if isinstance(tx, (int, float, str)):
        assert tx == jx, (what, tx, jx)
        return
    if isinstance(tx, (np.ndarray, torch.Tensor)):
        t, j = C.np_of(tx) if isinstance(tx, torch.Tensor) else tx, C.np_of_jax(jx)
        if ".diags[" in what and j.shape[0] > t.shape[0]:
            # the JAX diagonals are padded to 16 tiles with zero tiles (its Pallas
            # grid steps 16 tiles), the port's are not
            assert not j[t.shape[0]:].any(), what
            j = j[: t.shape[0]]
        np.testing.assert_array_equal(t, j, err_msg=what)
        return
    if isinstance(tx, (tuple, list)):
        assert len(tx) == len(jx), what
        for i, (a, b) in enumerate(zip(jx, tx)):
            _assert_tree_equal(a, b, f"{what}[{i}]")
        return
    import dataclasses

    for f in dataclasses.fields(tx):
        if hasattr(jx, f.name):  # the port's QuantBcsr adds its kernels' walk indices
            _assert_tree_equal(getattr(jx, f.name), getattr(tx, f.name), f"{what}.{f.name}")


_PARTITIONS = {
    "halo": ("n", dict()),
    "full_gather": ("n", dict(halo=False)),
    "rcm": ("n", dict(reorder="rcm")),
    "arc": ("a", dict()),
    "blocks": ("n", dict(dense_blocks=True, n=2048)),
    "blocks_no_halo": ("n", dict(dense_blocks=True, halo=False, n=2048)),
    "blocks_auto": ("n", dict(dense_blocks=True, agg_dtype="auto", n=2048)),
    "blocks_int8": ("n", dict(dense_blocks=True, agg_dtype="int8", n=2048)),
    "blocks_bfloat16": ("n", dict(dense_blocks=True, agg_dtype="bfloat16", n=2048)),
    "blocks_int8_band_wide": ("n", dict(dense_blocks=True, agg_dtype="int8", n=2048, band=600)),
    "merged_graphs_blocks": ("g", dict(dense_blocks=True)),
}


@pytest.mark.parametrize("case", list(_PARTITIONS))
def test_partition_graph_matches_jax(case):
    import jax

    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.parallel.partition import partition_graph as tpartition

    focus, kw = _PARTITIONS[case]
    size = {k: kw.pop(k) for k in ("n", "band") if k in kw}
    jg, tg = _merged_pair() if focus == "g" else _graph_pair(focus, seed=3, **size)
    jp, tp = jpartition(jg, PARTS, **kw), tpartition(tg, PARTS, **kw)
    assert (tp.n_parts, tp.nodes_per_part, tp.n_graphs, tp.focus) == (jp.n_parts, jp.nodes_per_part, jp.n_graphs,
                                                                       jp.focus)
    for name in ("nodes", "node_mask", "arc_src_global", "arc_dst_local", "arc_weight", "arc_label", "arc_mask",
                 "set_mask", "output_mask", "targets", "target_mask", "sample_weight", "publish_local",
                 "publish_mask", "arc_src_halo", "graph_of_node", "nodegraph_weight", "agg_arc_labels",
                 "agg_node_labels"):
        _assert_tree_equal(getattr(jp, name), getattr(tp, name), name)
    if case in ("halo", "arc", "blocks", "blocks_auto"):
        assert tp.publish_local is not None, "the banded graph's halo should engage"
    for name, jops in (("local_ops", jp.local_bcsr), ("halo_ops", jp.halo_bcsr)):
        tops = getattr(tp, name)
        if jops is None:
            assert tops is None, name
            continue
        for p in range(PARTS):
            _assert_tree_equal(jax.tree_util.tree_map(lambda x: x[p], jops), tops[p], f"{name}[{p}]")


def test_partition_graph_refuses_agg_dtype_without_blocks():
    from gnnkeras_tpu_torch.parallel.partition import partition_graph

    _, tg = _graph_pair("n", seed=3)
    with pytest.raises(ValueError, match="dense_blocks"):
        partition_graph(tg, PARTS, agg_dtype="int8")


# -- PartitionedGNN ---------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, c in _CASES.items() if c[2] == "forward"])
def test_partitioned_forward_matches_jax(setups, port_results, mesh4, name):
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN

    parts, models = setups
    key, transport, _, training = _CASES[name]
    jpg, _, focus = parts[key]
    jm = models[focus][0]
    k, state, out, mstate = JPartitionedGNN(jm, mesh4, transport=transport).forward(jpg, training=training)
    state, out = np.asarray(state), np.asarray(out)
    for r, res in enumerate(port_results):
        tk, tstate, tout, tbn = res[name]
        assert tk == float(k), (r, tk, float(k))
        np.testing.assert_allclose(tstate, state[r], rtol=RTOL, atol=ATOL, err_msg=f"state, rank {r}")
        np.testing.assert_allclose(tout, out[r], rtol=RTOL, atol=ATOL, err_msg=f"out, rank {r}")
        if training:  # moving statistics from the moments over every rank's rows
            for net in ("net_state", "net_output"):
                for i, leaves in enumerate(mstate[net]):
                    for leaf, value in leaves.items():
                        np.testing.assert_allclose(tbn[f"{net}.layers.{i}.{leaf}"], np.asarray(value), rtol=RTOL,
                                                   atol=ATOL, err_msg=f"{net}.{i}.{leaf}")


def _jax_step(setups, mesh4, key):
    """One Adam step of the JAX package's partitioned train step, and its
    gradients (the same step's objective under ``jax.grad``)."""
    import jax
    import jax.numpy as jnp

    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN

    parts, models = setups
    jpg, _, focus = parts[key]
    jm = models[focus][0]
    jm.compile(optimizer="adam:0.01", loss=_LOSS[focus], metrics=["mse"])
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    params, mstate = copy(jm.variables["params"]), copy(jm.variables["state"])
    engine = JPartitionedGNN(jm, mesh4)
    new_params, new_mstate, _, logs = engine.make_train_step()(params, mstate, jm.optimizer.init(params), jpg,
                                                               jax.random.PRNGKey(0))
    return jm, new_params, new_mstate, logs


@pytest.mark.parametrize("name", ["n_blocks_step", "g_blocks_step"])
def test_partitioned_adam_step_matches_jax(setups, port_results, mesh4, name):
    from gnnkeras_tpu_torch.convert import variables_from_jax

    key = _CASES[name][0]
    jm, new_params, new_mstate, logs = _jax_step(setups, mesh4, key)
    want_params = variables_from_jax({"params": new_params, "state": {}})
    want_stats = variables_from_jax({"params": {}, "state": new_mstate})
    res0 = port_results[0][name]
    for r, res in enumerate(rank[name] for rank in port_results):
        np.testing.assert_allclose(res["loss"], float(logs["loss"]), rtol=RTOL, err_msg=f"loss, rank {r}")
        assert res["k"] == float(logs["k"])
        for n, v in res["buffers"].items():
            np.testing.assert_allclose(v, want_stats[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)
        excluded = 0
        for n, got in res["params"].items():
            g = res["grads"][n]
            # every rank applies the same mean gradient
            np.testing.assert_array_equal(g, res0["grads"][n], err_msg=n)
            live = np.abs(g) >= 1e-6 * np.abs(g).max()
            excluded += int((~live).sum())
            np.testing.assert_allclose(got[live], want_params[n].numpy()[live], rtol=RTOL, atol=ATOL, err_msg=n)
        assert excluded == 0


def test_partitioned_gradients_match_jax(setups, port_results):
    """The port's mean gradient against ``jax.grad`` of the single-device
    objective on the whole graph (the partitioned engine's defining
    property), for the node model on the block path."""
    import jax
    import jax.numpy as jnp

    import gnnkeras_tpu.graph.batch as jbatch
    from gnnkeras_tpu.training.trainer import _objective
    from gnnkeras_tpu_torch.convert import variables_from_jax

    parts, models = setups
    jm = models["n"][0]
    jm.compile(optimizer="adam:0.01", loss="mse")
    jg, _ = _graph_pair("n", seed=7, n=2048)
    batch = jbatch.from_graph_object(jg)
    objective = lambda p: _objective(jm, p, jm.variables["state"], batch, jax.random.PRNGKey(0), True)[0]
    grads = jax.jit(jax.grad(objective))(jm.variables["params"])
    want = variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads), "state": {}})
    got = port_results[0]["n_blocks_step"]["grads"]
    for n, g in got.items():
        scale = np.abs(want[n].numpy()).max()
        np.testing.assert_allclose(g, want[n].numpy(), rtol=1e-4, atol=1e-5 * scale, err_msg=n)


def test_partitioned_evaluate_matches_jax(setups, port_results, mesh4):
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN

    parts, models = setups
    jpg, _, _ = parts["n_halo"]
    jm = models["n"][0]
    jm.compile(optimizer="adam:0.01", loss="mse", metrics=["mse"])
    want = JPartitionedGNN(jm, mesh4).evaluate(jpg)
    for res in port_results:
        for key, value in want.items():
            np.testing.assert_allclose(res["n_evaluate"][key], value, rtol=RTOL, err_msg=key)


def test_partitioned_fit_runs_on_every_rank(port_results):
    """Three full-batch epochs, two steps per host read: finite losses that
    every rank agrees on, the first equal to the single train step's."""
    first = port_results[0]["n_fit"]
    assert len(first["loss"]) == 3 and np.isfinite(first["loss"]).all()
    np.testing.assert_allclose(first["loss"][0], port_results[0]["n_blocks_step"]["loss"], rtol=RTOL)
    for res in port_results[1:]:
        assert res["n_fit"] == first


def test_ring_transport_refuses_to_train(port_results):
    for res in port_results:
        assert "no backward" in res["n_ring_train"] and "collective" in res["n_ring_train"]


def test_engine_refuses_what_is_not_ported():
    from gnnkeras_tpu_torch.data.synthetic import composite_of, large_banded_graph, large_graph_gnn, typed_cgnn
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN, partition_graph

    # composite graphs partition (tests/test_torch_partition_composite.py
    # holds them to JAX); tensor parallelism composes with homogeneous models only
    pg = partition_graph(composite_of(large_banded_graph(256, band=8)), 2)
    assert pg.type_mask.shape == (2, 128, 1) and pg.agg_component.shape == (2, 128, 10)
    with pytest.raises(NotImplementedError, match="homogeneous"):
        PartitionedGNN(typed_cgnn(0, device="cpu"), tp_shards=2)
    # a tensor-parallel engine (tp_shards > 1, ported) trains and infers only
    # through the hybrid step, as the JAX package's
    engine = PartitionedGNN(large_graph_gnn("cpu"), tp_shards=2)
    for call in (engine.forward, engine.train_step, engine.fit):
        with pytest.raises(ValueError, match="hybrid"):
            call(None)
    with pytest.raises(ValueError, match="transport"):
        PartitionedGNN(object(), transport="nccl")
    # fit's validation, callbacks, checkpoints and resume are ported
    # (tests/test_torch_partitioned_fit.py); through the ring it refuses
    with pytest.raises(NotImplementedError, match="no backward"):
        PartitionedGNN(object(), transport="pallas_ring").fit(None, checkpoint_dir="ckpt")
