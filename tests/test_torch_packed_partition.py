"""The packed (molecule-granular) partition (``parallel/packed.py``) against
the JAX package's, on the CPU.

``balance_graphs``, ``split_merged_by_graph`` and ``partition_packed`` are
held array for array (every batch field, the strip operator and its storage,
the compact readout, the meta).  The engine runs on 2 gloo ranks spawned once
for the module (``_rank_run``), the JAX package on a 2-device sub-mesh of the
conftest's 8 CPU devices, with the same weights (``convert.variables_from_jax``):

- ``PackedPartitionedGNN``: the eval and training forwards (shared and
  per-iteration BatchNorm; an eval forward at threshold 0.01 whose parts
  converge at different iterations, so the maximum of the flag over the
  ranks decides the trip count) and one SGD step (lr 0.1);
- ``PackedPartitionedLGNN`` (2 layers): the forwards and one SGD step in
  ``parallel`` and ``residual`` mode; ``serial`` raises with the JAX
  package's direction; each class refuses the other's model;
- the fit surface: 4 epochs with a packed validation batch, ``EarlyStopping``
  (restoring epoch 0's weights after epoch 2) and ``class_weight``; a fit
  checkpointed every 2 epochs, stopped after 2 and resumed to 4, ending bit
  for bit where the uninterrupted fit ends.

Outputs, moving statistics, losses and parameters at rtol 1e-5 / atol 1e-6
(the ranks' BatchNorm and loss sums are added in gloo's order, JAX's psum in
XLA's: f32 reassociation only).  SGD throughout: Adam magnifies such
differences in near-zero gradients.  This module imports JAX only inside its
fixtures and tests, so the ranks import none.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

PARTS = 2
DN, DA, T = 6, 2, 2
RTOL, ATOL = 1e-5, 1e-6


def _molecules(module, n_graphs=24, seed=0, composite=False):
    """A merged batch of 8-29-node molecules (random arcs, normal labels,
    one-hot graph targets) in ``module``'s classes."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n, a = int(rng.integers(8, 30)), int(rng.integers(12, 50))
        arcs = np.concatenate([rng.integers(0, n, (a, 2)), rng.normal(size=(a, DA))], axis=1)
        t = np.zeros((1, T))
        t[0, rng.integers(T)] = 1
        nodes = rng.normal(size=(n, DN))
        if composite:
            tm = np.zeros((n, 2), dtype=bool)
            tm[np.arange(n), rng.integers(0, 2, n)] = True
            graphs.append(module.CompositeGraphObject(nodes=nodes, arcs=arcs, targets=t, type_mask=tm,
                                                      dim_node_label=(DN, DN), focus="g", aggregation_mode="average"))
        else:
            graphs.append(module.GraphObject(nodes=nodes, arcs=arcs, targets=t, focus="g",
                                             aggregation_mode="average"))
    cls = module.CompositeGraphObject if composite else module.GraphObject
    return cls.merge(graphs, focus="g", aggregation_mode="average")


def _gnn(mlp, gnn_mod, layer=None, per_iteration_bn=False, threshold=0.0):
    kw = {} if layer is None else dict(layer=layer, get_state=True, get_output=True)
    ins, ls = mlp.get_inout_dims("state", DN, DA, T, "g", 0, **kw)
    ino, lo = mlp.get_inout_dims("output", DN, DA, T, "g", 0, **kw)
    return gnn_mod.GNNgraphBased(
        mlp.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                bias_initializer="lecun_normal"),
        mlp.MLP(input_dim=ino[0], layers=lo, activations="softmax", kernel_initializer="glorot_normal",
                bias_initializer="glorot_normal"),
        0, 5 if layer is None else 3, threshold, per_iteration_bn=per_iteration_bn)


def _lgnn(mlp, gnn_mod, lgnn_mod):
    return lgnn_mod.LGNN([_gnn(mlp, gnn_mod, layer=i) for i in range(2)], True, True)


def _port_gnn(state, per_iteration_bn=False, threshold=0.0):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = _gnn(tmlp, tgnn, per_iteration_bn=per_iteration_bn, threshold=threshold).build(device="cpu")
    m.load_state_dict(state)
    m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"])
    return m


def _port_lgnn(state, mode):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.lgnn as tlgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = _lgnn(tmlp, tgnn, tlgnn).build(device="cpu")
    m.load_state_dict(state)
    m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"], training_mode=mode)
    return m


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


# -- the port's ranks -----------------------------------------------------------------


def _rank_run(rank: int, world: int, batch, val_batch, states: dict, ck: str) -> dict:
    import os

    from gnnkeras_tpu_torch.parallel.packed import PackedPartitionedGNN, PackedPartitionedLGNN
    from gnnkeras_tpu_torch.training.callbacks import EarlyStopping

    out = {}
    for key in ("plain", "per_iteration_bn", "threshold"):
        model = _port_gnn(states[key], per_iteration_bn=key == "per_iteration_bn",
                          threshold=0.01 if key == "threshold" else 0.0)
        engine = PackedPartitionedGNN(model)
        for training in ((False,) if key == "threshold" else (False, True)):
            k, _, o, _, bn = engine.forward(batch, training=training)
            out[(key, training)] = {"k": float(k), "out": o.numpy(), "bn": _np(bn)}
    model = _port_gnn(states["plain"])
    logs = PackedPartitionedGNN(model).train_step(batch)
    out["step"] = {"loss": float(logs["loss"]), "k": float(logs["k"]), "acc": float(logs["accuracy_sum"]),
                   "acc_count": float(logs["accuracy_count"]), "state": _np(model.state_dict())}

    engine = PackedPartitionedLGNN(_port_lgnn(states["lgnn"], "parallel"))
    for training in (False, True):
        ks, _, outs, _, bn = engine.forward(batch, training=training)
        out[("lgnn", training)] = {"k": [float(k) for k in ks], "out": outs[-1].numpy(), "bn": _np(bn)}
    for mode in ("parallel", "residual"):
        model = _port_lgnn(states["lgnn"], mode)
        logs = PackedPartitionedLGNN(model).train_step(batch)
        out[("lgnn_step", mode)] = {"loss": float(logs["loss"]), "state": _np(model.state_dict())}
    serial = _port_lgnn(states["lgnn"], "serial")
    with pytest.raises(ValueError, match="fit_serial"):
        PackedPartitionedLGNN(serial).fit(batch, epochs=1)
    with pytest.raises(ValueError, match="PackedPartitionedLGNN"):
        PackedPartitionedGNN(serial)
    with pytest.raises(ValueError, match="PackedPartitionedGNN"):
        PackedPartitionedLGNN(_port_gnn(states["plain"]))
    out["refusals"] = True

    def fit(**kw):
        model = _port_gnn(states["plain"])
        history = PackedPartitionedGNN(model).fit(batch, verbose=0, **kw)
        return model, history.history

    early = EarlyStopping(monitor="loss", mode="max", patience=1, restore_best_weights=True)
    model, out["validated"] = fit(epochs=4, validation_data=val_batch, callbacks=[early],
                                  class_weight={0: 2.0, 1: 0.5})
    out["validated_state"] = _np(model.state_dict())
    whole, out["whole"] = fit(epochs=4, checkpoint_dir=os.path.join(ck, "whole"), checkpoint_every=2)
    fit(epochs=2, checkpoint_dir=os.path.join(ck, "resume"))
    resumed, out["resumed"] = fit(epochs=4, checkpoint_dir=os.path.join(ck, "resume"), resume=True)
    out["whole_state"], out["resumed_state"] = _np(whole.state_dict()), _np(resumed.state_dict())
    return out


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.lgnn as jlgnn
    import gnnkeras_tpu.models.mlp as jmlp
    import gnnkeras_tpu.parallel.packed as jpacked
    from gnnkeras_tpu.parallel.mesh import make_mesh

    return dict(jax=jax, graph=jgraph, gnn=jgnn, lgnn=jlgnn, mlp=jmlp, packed=jpacked,
                mesh=make_mesh(("graph",), devices=jax.devices()[:PARTS]))


@pytest.fixture(scope="module")
def setup(jx, tmp_path_factory):
    """Both packages' models and partitions, and the port's ranks' results."""
    import gnnkeras_tpu_torch.graph.graph as tgraph
    import torch_port_common as C
    from gnnkeras_tpu_torch.convert import variables_from_jax
    from gnnkeras_tpu_torch.parallel.packed import partition_packed

    jax = jx["jax"]
    models, states = {}, {}
    for key, kw in (("plain", {}), ("per_iteration_bn", dict(per_iteration_bn=True)),
                    ("threshold", dict(threshold=0.01))):
        jm = _gnn(jx["mlp"], jx["gnn"], **kw)
        jm.build(seed=3)
        jm.variables = C.perturb_bn(jm.variables, 3)
        if key == "threshold":  # small steps against the state's norm: converges before max_iteration
            dense = jm.variables["params"]["net_state"][-1]
            dense["kernel"], dense["bias"] = dense["kernel"] * 0.05, dense["bias"] + 1.0
        models[key] = jm
    jl = _lgnn(jx["mlp"], jx["gnn"], jx["lgnn"])
    jl.build(seed=4)
    jl.variables = C.perturb_bn_tree(jl.variables, 4)
    models["lgnn"] = jl
    for key, jm in models.items():
        states[key] = variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))

    tb, meta = partition_packed(_molecules(tgraph, seed=0), PARTS, strip_dtype="float32", device="cpu")
    tv, _ = partition_packed(_molecules(tgraph, n_graphs=16, seed=9), PARTS, strip_dtype="float32",
                             device="cpu")
    jb, jmeta = jx["packed"].partition_packed(_molecules(jx["graph"], seed=0), PARTS, strip_dtype="float32")
    jv, _ = jx["packed"].partition_packed(_molecules(jx["graph"], n_graphs=16, seed=9), PARTS, strip_dtype="float32")
    ck = str(tmp_path_factory.mktemp("packed_ck"))
    results = spawn(_rank_run, PARTS, [(tb[r], tv[r], states, ck) for r in range(PARTS)])
    return dict(models=models, j0={k: jax.tree_util.tree_map(np.asarray, m.variables) for k, m in models.items()},
                jb=jb, jv=jv, meta=meta, jmeta=jmeta, results=results)


def _reset(jx, setup, key, **compile_kw):
    import jax.numpy as jnp

    jm = setup["models"][key]
    jm.variables = jx["jax"].tree_util.tree_map(jnp.asarray, setup["j0"][key])
    jm._opt_state, jm._rng = None, jx["jax"].random.PRNGKey(0)
    jm.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"], **compile_kw)
    return jm


def _merged(setup, outs):
    return setup["meta"].merge_outputs(outs)


def _merge_jax(jmeta, out):
    merged = np.zeros((jmeta.n_graphs,) + out.shape[2:], out.dtype)
    for p in range(len(jmeta.groups)):
        merged[jmeta.groups[p]] = out[p][jmeta.pred_rows[p]]
    return merged


def _assert_state(got: dict, want_tree, section, err=""):
    from torch_port_common import port_dict

    want = port_dict(want_tree, section)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{err} {name}")


# -- host-side partition: array for array ----------------------------------------------


def test_balance_and_split_match_jax(jx):
    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu_torch.parallel.packed import balance_graphs, split_merged_by_graph

    sizes = np.random.default_rng(0).integers(5, 50, 37)
    got, want = balance_graphs(sizes, PARTS), jx["packed"].balance_graphs(sizes, PARTS)
    assert len(got) == len(want) == PARTS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(37))
    ids = np.array([1, 4, 7, 20])
    for composite in (False, True):
        sub = split_merged_by_graph(_molecules(tgraph, seed=3, composite=composite), ids)
        ref = jx["packed"].split_merged_by_graph(_molecules(jx["graph"], seed=3, composite=composite), ids)
        for field in ("nodes", "arcs", "targets", "set_mask", "output_mask", "sample_weight", "graph_of_node",
                      "nodegraph_weight", "arcnode_weight"):
            np.testing.assert_array_equal(getattr(sub, field), getattr(ref, field), err_msg=field)
        assert type(sub).__name__ == type(ref).__name__
        if composite:  # the type-mask rows travel with their nodes
            np.testing.assert_array_equal(sub.type_mask, ref.type_mask)
            assert tuple(sub.DIM_NODE_LABEL) == tuple(ref.DIM_NODE_LABEL)


@pytest.mark.parametrize("case", ["float32", "int8_downgraded", "int8"])
def test_partition_packed_matches_jax_array_for_array(jx, case):
    """Every part's batch bit for bit: the uniform caps, the strips (f32;
    int8 when every part factors; the collective downgrade to bf16 when
    the parallel arcs of some parts do not), the compact readout."""
    import warnings

    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu_torch.parallel.packed import partition_packed
    from torch_port_common import assert_batches_equal

    def graph(module):
        g = _molecules(module, seed=5)
        if case == "int8":  # no parallel arcs: every part's weights factor
            _, first = np.unique(g.arcs[:, :2], axis=0, return_index=True)
            g = module.GraphObject(nodes=g.nodes, arcs=g.arcs[np.sort(first)], targets=g.targets, focus="g",
                                   NodeGraph=(g.graph_of_node, g.nodegraph_weight), aggregation_mode="average")
        return g

    dtype = "float32" if case == "float32" else "int8"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, meta = partition_packed(graph(tgraph), PARTS, strip_dtype=dtype, device="cpu")
        want, jmeta = jx["packed"].partition_packed(graph(jx["graph"]), PARTS, strip_dtype=dtype)
    for p in range(PARTS):
        np.testing.assert_array_equal(meta.groups[p], jmeta.groups[p])
        np.testing.assert_array_equal(meta.pred_rows[p], jmeta.pred_rows[p])
        part = jx["jax"].tree_util.tree_map(lambda x: x[p], want)
        object.__setattr__(part, "host_pred_rows", jmeta.pred_rows[p])
        assert_batches_equal(got[p], part)
    scaled = [b.strip.scale is not None for b in got]
    assert scaled == [case == "int8"] * PARTS
    if case == "int8_downgraded":
        assert all(b.strip.strip.dtype == torch.bfloat16 for b in got)


# -- the engine on 4 ranks ---------------------------------------------------------------


@pytest.mark.parametrize("key,training", [("plain", False), ("plain", True), ("per_iteration_bn", False),
                                          ("per_iteration_bn", True), ("threshold", False)])
def test_packed_forward_matches_jax(jx, setup, key, training):
    from torch_port_common import fast_jax_jit

    jm = setup["models"][key]
    with fast_jax_jit():
        k, _, out, _, ms = jx["packed"].PackedPartitionedGNN(jm, jx["mesh"]).forward(
            setup["jb"], training=training, rng=jx["jax"].random.PRNGKey(0))
    res = [r[(key, training)] for r in setup["results"]]
    assert all(r["k"] == float(k) for r in res), ([r["k"] for r in res], float(k))
    if key == "threshold":  # the parts alone would stop at other iterations
        assert float(k) < 5
    np.testing.assert_allclose(_merged(setup, [r["out"] for r in res]), _merge_jax(setup["jmeta"], np.asarray(out)),
                               rtol=RTOL, atol=ATOL)
    if training:
        for r in res:
            _assert_state(r["bn"], ms, "state", key)


def test_packed_sgd_step_matches_jax(jx, setup):
    from torch_port_common import fast_jax_jit

    jm = _reset(jx, setup, "plain")
    engine = jx["packed"].PackedPartitionedGNN(jm, jx["mesh"])
    with fast_jax_jit():
        history = engine.fit(setup["jb"], epochs=1)
    for r in setup["results"]:
        step = r["step"]
        np.testing.assert_allclose(step["loss"], history["loss"][0], rtol=RTOL)
        np.testing.assert_allclose(step["acc"] / step["acc_count"], history["accuracy"][0], rtol=RTOL)
        assert step["k"] == history["k"][0] == 5.0
        _assert_state(step["state"], jm.variables["params"], "params")
        _assert_state(step["state"], jm.variables["state"], "state")


def test_packed_lgnn_forward_matches_jax(jx, setup):
    from torch_port_common import fast_jax_jit

    engine = jx["packed"].PackedPartitionedLGNN(_reset(jx, setup, "lgnn"), jx["mesh"])
    for training in (False, True):
        with fast_jax_jit():
            ks, _, out, _, ms = engine.forward(setup["jb"], training=training, rng=jx["jax"].random.PRNGKey(0))
        res = [r[("lgnn", training)] for r in setup["results"]]
        assert all(r["k"] == [float(k) for k in np.asarray(ks)] for r in res)
        np.testing.assert_allclose(_merged(setup, [r["out"] for r in res]),
                                   _merge_jax(setup["jmeta"], np.asarray(out)), rtol=RTOL, atol=ATOL)
        if training:
            for r in res:
                _assert_state(r["bn"], ms, "state", "forward")


@pytest.mark.parametrize("mode", ["parallel", "residual"])
def test_packed_lgnn_step_matches_jax(jx, setup, mode):
    from torch_port_common import fast_jax_jit

    jm = _reset(jx, setup, "lgnn", training_mode=mode)
    with fast_jax_jit():
        history = jx["packed"].PackedPartitionedLGNN(jm, jx["mesh"]).fit(setup["jb"], epochs=1)
    for r in setup["results"]:
        step = r[("lgnn_step", mode)]
        np.testing.assert_allclose(step["loss"], history["loss"][0], rtol=RTOL)
        _assert_state(step["state"], jm.variables["params"], "params", mode)
        _assert_state(step["state"], jm.variables["state"], "state", mode)


def test_serial_and_wrong_model_refused(setup):
    assert all(r["refusals"] for r in setup["results"])


def test_packed_fit_validation_early_stopping_class_weight_match_jax(jx, setup):
    import gnnkeras_tpu.training.callbacks as jcb
    from torch_port_common import fast_jax_jit

    jm = _reset(jx, setup, "plain")
    early = jcb.EarlyStopping(monitor="loss", mode="max", patience=1, restore_best_weights=True)
    with fast_jax_jit():
        want = jx["packed"].PackedPartitionedGNN(jm, jx["mesh"]).fit(
            setup["jb"], epochs=4, validation_data=setup["jv"], callbacks=[early], class_weight={0: 2.0, 1: 0.5}
        ).history
    for r in setup["results"]:
        got = r["validated"]
        assert set(got) == set(want) == {"loss", "k", "accuracy", "val_loss", "val_accuracy"}
        assert len(got["loss"]) == 3  # stopped after epoch 2
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
        _assert_state(r["validated_state"], jm.variables["params"], "params")
    for r in setup["results"][1:]:
        assert r["validated"] == setup["results"][0]["validated"]


def test_packed_resume_ends_where_the_uninterrupted_fit_ends(jx, setup):
    from torch_port_common import fast_jax_jit

    jm = _reset(jx, setup, "plain")
    with fast_jax_jit():
        want = jx["packed"].PackedPartitionedGNN(jm, jx["mesh"]).fit(setup["jb"], epochs=4).history
    first = setup["results"][0]
    np.testing.assert_allclose(first["whole"]["loss"], want["loss"], rtol=RTOL)
    for r in setup["results"]:
        assert r["resumed"]["loss"] == first["whole"]["loss"][2:]
        for name, value in first["whole_state"].items():
            np.testing.assert_array_equal(r["resumed_state"][name], value, err_msg=name)
            np.testing.assert_array_equal(r["whole_state"][name], value, err_msg=name)
