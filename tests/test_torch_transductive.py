"""Mixed inductive-transductive learning (``gnnkeras_tpu_torch.data.transductive``)
against the JAX package, mirroring its ``tests/test_models_io.py``
``TestTransductive``.

Both packages draw the transductions and shuffles from NumPy's global
stream, so after the same seed the transduced graphs and every batch are
equal field for field (``torch_port_common.assert_batches_equal``).  The
composite node model (dim_state 0, same weights) then runs its eval
forward on the slot-128 int8 transductive batch (outputs at rtol 1e-5 /
atol 1e-6, phase-4 style) and trains 2 epochs over the sequencer with SGD
(History at rtol 1e-5, as the trainer's fit parity).
"""

import warnings

import jax
import numpy as np
import pytest

import gnnkeras_tpu.data.transductive as jtrans
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.models.composite as jcomp
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu_torch.data.transductive as ttrans
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.models.composite as tcomp
import gnnkeras_tpu_torch.models.mlp as tmlp
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import assert_batches_equal, fast_jax_jit

RTOL, ATOL = 1e-5, 1e-6


def _toy(module, n_graphs=6, seed=0, focus="n", unique=False):
    """The JAX tests' toy graphs: 5-9 nodes, 3 normal label features, 2
    normal arc-label features, 2 normal targets a node; ``unique`` keeps one
    arc per (src, dst) pair (the int8 strip factors)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n, a = int(rng.integers(5, 10)), int(rng.integers(8, 16))
        nodes = rng.normal(size=(n, 3))
        pairs = rng.integers(0, n, (a, 2))
        if unique:
            pairs = np.unique(pairs, axis=0)
        arcs = np.concatenate([pairs, rng.normal(size=(len(pairs), 2))], axis=1)
        out.append(module.GraphObject(nodes=nodes, arcs=arcs, targets=rng.normal(size=(n, 2)), focus=focus,
                                      aggregation_mode="average"))
    return out


def _assert_graphs_equal(t, j):
    for name in ("nodes", "arcs", "targets", "type_mask", "set_mask", "output_mask", "arcnode_weight",
                 "sample_weight"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.DIM_NODE_LABEL, j.DIM_NODE_LABEL)


def test_get_transduction_matches_jax():
    g_t, g_j = _toy(tgraph, 1, seed=3)[0], _toy(jgraph, 1, seed=3)[0]
    np.random.seed(0)
    tj = jtrans.get_transduction(g_j, transductive_rate=0.5, focus="n")
    np.random.seed(0)
    tt = ttrans.get_transduction(g_t, transductive_rate=0.5, focus="n")
    _assert_graphs_equal(tt, tj)
    trans = tt.type_mask[:, 1]
    assert trans.sum() > 0 and not np.any(tt.output_mask[trans])
    assert tt.nodes.shape[1] == g_t.nodes.shape[1] + g_t.DIM_TARGET
    np.testing.assert_array_equal(tt.nodes[~trans, g_t.nodes.shape[1]:], 0.0)
    assert tt.targets.shape[0] == g_t.targets.shape[0] - int(trans.sum())


def test_arc_focus_quirk_and_composite_refusal_like_jax():
    """``focus='a'`` sizes the appended targets by the arc count and fails
    as the JAX package (and the reference) fails when arcs ≠ nodes; a
    composite graph is refused."""
    errors = []
    for module, trans in ((jgraph, jtrans), (tgraph, ttrans)):
        g = _toy(module, 1, seed=8)[0]
        assert g.arcs.shape[0] != g.nodes.shape[0]
        np.random.seed(1)
        with pytest.raises(Exception) as err:
            trans.get_transduction(g, 0.5, "a")
        errors.append(type(err.value))
        composite = module.CompositeGraphObject(nodes=g.nodes, arcs=g.arcs, targets=g.targets,
                                                type_mask=np.ones((g.nodes.shape[0], 1), bool), dim_node_label=(3,),
                                                focus="n")
        with pytest.raises(ValueError, match="homogeneous"):
            trans.get_transduction(composite, 0.5, "n")
    assert errors[0] is errors[1]


def _sequencer_pair(cls, make, *args, seed=3, **kwargs):
    out = []
    for trans, graph_mod, extra in ((jtrans, jgraph, {}), (ttrans, tgraph, {"device": "cpu"})):
        np.random.seed(seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out.append(getattr(trans, cls)(make(graph_mod), *args, **kwargs, **extra))
    return out


def test_multi_sequencer_resamples_like_jax():
    js, ts = _sequencer_pair("TransductiveMultiGraphSequencer", lambda m: _toy(m, 6, seed=4), "n", "average", 0.5,
                             batch_size=3, pad_multiple=16)
    assert ts[0].type_mask.shape[1] == 2
    first = ts.data[0].type_mask.copy()
    for epoch in range(2):
        for i in range(len(ts)):
            assert_batches_equal(ts[i], js[i])
        for s in (js, ts):
            np.random.seed(99 + epoch)
            s.on_epoch_end()
    assert any(not np.array_equal(g.type_mask, first) for g in ts.data if g.type_mask.shape == first.shape)
    assert repr(ts) == repr(js)


def test_single_sequencer_retransduction_reaches_the_batches():
    """The single-graph sequencer keeps its base batch across epochs; the
    transductive one drops it, so every epoch's batches carry the fresh
    transduction's features, targets and types."""
    js, ts = _sequencer_pair("TransductiveSingleGraphSequencer", lambda m: _toy(m, 1, seed=12)[0], "n", 0.5,
                             batch_size=4, shuffle=False, pad_multiple=16)
    n = ts.graph.nodes.shape[0]
    nodes_epoch0 = ts[0].nodes.numpy()[:n].copy()
    for epoch in range(2):
        for i in range(len(ts)):
            for name in ("nodes", "targets", "type_mask", "set_mask", "target_mask", "agg_component"):
                np.testing.assert_allclose(getattr(ts[i], name).numpy(), np.asarray(getattr(js[i], name)),
                                           rtol=1e-6, err_msg=name)
        for s in (js, ts):
            np.random.seed(4 + epoch)
            s.on_epoch_end()
    b1 = ts[0]
    np.testing.assert_array_equal(b1.nodes.numpy()[:n], ts.graph.nodes)
    np.testing.assert_array_equal(b1.targets.numpy()[np.flatnonzero(ts.graph.output_mask)], ts.graph.targets)
    np.testing.assert_array_equal(b1.type_mask.numpy()[:n], ts.graph.type_mask)
    assert not np.array_equal(b1.nodes.numpy()[:n], nodes_epoch0)
    assert repr(ts) == repr(js)


def _cgnn(mlp, comp):
    """A composite node GNN over the transduction's 2 types (label widths 3
    and 5), dim_state 0: the state is the 5-wide label."""
    dims, width = (3, 5), 5
    nets = [mlp.MLP(input_dim=(d_t + 2 * width + sum(dims) + 2,), layers=[width], activations="selu",
                    kernel_initializer="lecun_normal", bias_initializer="lecun_normal") for d_t in dims]
    out = mlp.MLP(input_dim=(width,), layers=[2], activations="softmax", kernel_initializer="glorot_normal",
                  bias_initializer="glorot_normal")
    return comp.CompositeGNNnodeBased(nets, out, 0, 3, 0.0)


def test_strip_engine_forward_and_training_match_jax():
    """slot-128 int8 transductive batches carry the strip operator; the
    forward and a 2-epoch fit across re-transductions match JAX's."""
    js, ts = _sequencer_pair("TransductiveMultiGraphSequencer", lambda m: _toy(m, 8, seed=11, unique=True), "n",
                             "average", 0.5, batch_size=4, slot_pack=128, strip_dtype="int8")
    b = ts[0]
    assert b.strip is not None and b.strip.scale is not None  # average aggregation factors into int8
    assert_batches_equal(b, js[0])
    with fast_jax_jit():
        jm = _cgnn(jmlp, jcomp)
        jm.build(seed=0)
        tm = _cgnn(tmlp, tcomp).build(seed=0, device="cpu")
        tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
        assert tm._use_transposed(b)
        _, _, out_j, mask_j, _ = jax.jit(lambda v, batch: jm.forward(v, batch, training=False))(jm.variables, js[0])
        _, _, out_t, mask_t, _ = tm.forward(b, training=False)
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        m = mask_t.numpy()
        np.testing.assert_allclose(out_t.numpy()[m], np.asarray(out_j)[m], rtol=RTOL, atol=ATOL)

        hists = []
        for model, seq in ((jm, js), (tm, ts)):
            model.compile(optimizer="sgd:0.1", loss="mse")
            np.random.seed(21)
            hists.append(model.fit(seq, epochs=2, verbose=0))
    np.testing.assert_allclose(hists[1]["loss"], hists[0]["loss"], rtol=RTOL)
    assert ts[0].strip is not None and ts._strip_scale_degraded is False
