"""The composite GNN models (``models/composite.py``) in the port against
the JAX package, on the same batches and weights (non-trivial BatchNorm
statistics): node, arc and graph focus, both engines (the slot-packed strip
batch runs the feature-major engine through the strip kernel's plain
version, the edge-list batch the row-major one), dim_state 0 and 10,
per-iteration BatchNorm, and a batch where one node type is absent.  Each
case holds the eval forward (k, state, outputs, moving statistics) and the
training objective (loss, k, new statistics, gradients); Adam steps go
through JAX's ``_train_step_body`` and the port's ``train_step``.

3 node types by atom class ('composite_average'), type t reading the first
(5, 10, 14)[t] label columns.  At dim_state 10 the random initial state is
JAX's draw for the rng its forward is given, fed to the port through
``models.gnn.initial_state``.

Tolerances, those of test_torch_dim_state.py: f32 in both, sums in other
orders (the JAX references are jitted, the train step eager): state,
outputs, loss and moving statistics rtol 1e-5 / atol 1e-6; gradients rtol
1e-4 and atol 1e-6 of the model's largest |g|; Adam's updated parameters
rtol 1e-5 / atol 1e-6.  Measured worst (this file's cases, one CPU core):
states 8.4e-7 absolute, gradients 5e-7 of the largest |g|.
"""

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.training.trainer as ttr
from torch_port_common import Batches, adam_live, arc_targets, assert_stats, cgnn_pair, composite_merged_pair, \
    feed_init_draw, jax_init_draw, jax_optimizer_step, merged_pair, node_targets, port_dict, raw_molecules, \
    run_jitted, unique_pairs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
DS = 10

_LAYOUTS = {
    "strip": dict(slot_pack=128, strip_dtype="float32"),  # feature-major engine
    "edge_list": dict(dense_blocks=False),  # row-major engine
}


def _raw(focus, seed):
    raw = unique_pairs(raw_molecules(n_graphs=8, seed=seed))
    if focus == "n":
        raw = node_targets(raw, seed=seed)
    elif focus == "a":
        raw = arc_targets(raw, seed=seed)
    return raw


def _batch_pair(layout, focus, seed=3, absent=None):
    jm, tm = composite_merged_pair(_raw(focus, seed), focus=focus, absent=absent)
    return jbatch.from_graph_object(jm, **_LAYOUTS[layout]), tbatch.from_graph_object(tm, device="cpu",
                                                                                       **_LAYOUTS[layout])


def _assert_grads(tm, grads):
    want = {name: w.numpy() for name, w in port_dict(grads, "params").items()}
    atol = GRAD_ATOL_REL * max(np.abs(w).max() for w in want.values())
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=GRAD_RTOL, atol=atol, err_msg=name)


def _eval_matches(jm, tm, jb, tb, rng):
    jk, jstate, jout, jmask, jst = run_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r),
                                              jm.variables, jb, rng)
    k, state, out, mask, st = tm.forward(tb, training=False, generator=torch.Generator())
    assert k == int(jk)
    node_mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(state.numpy()[node_mask], np.asarray(jstate)[node_mask], rtol=RTOL, atol=ATOL)
    m = np.asarray(jmask)
    np.testing.assert_array_equal(mask.numpy(), m)
    assert np.isfinite(out.numpy()[m]).all()
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)
    assert_stats(st, jst)
    return k


def _step_matches(jm, tm, jb, tb, rng):
    """One Adam step (``average_st_grads``): the port's ``train_step``
    against JAX's objective and gradient (jitted) and optax's Adam update
    of them, on the entries where Adam's step is not steep
    (``adam_live``)."""
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", average_st_grads=True)
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, aux), grads = run_jitted(jax.value_and_grad(
        lambda p, b, r: jtr._objective(jm, p, mstate, b, r, training=True), has_aux=True), params, jb, rng)
    grads, new_params = jax_optimizer_step(jm, params, grads, aux["k"])
    logs, taux = ttr.train_step(tm, tb, torch.Generator())
    assert float(taux["k"]) == float(aux["k"])
    np.testing.assert_allclose(float(logs["loss_sum"] / logs["count"]), float(jloss), rtol=RTOL)
    assert_stats(taux["new_state"], aux["new_state"])
    assert_stats(dict(tm.named_buffers()), aux["new_state"])
    _assert_grads(tm, grads)
    want, want_grads = port_dict(new_params, "params"), port_dict(grads, "params")
    excluded = total = 0
    for name, p in tm.named_parameters():
        live = adam_live(p.grad.numpy(), want_grads[name].numpy())
        excluded, total = excluded + int((~live).sum()), total + live.size
        np.testing.assert_allclose(p.detach().numpy()[live], want[name].numpy()[live], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # entries whose gradient is small enough that Adam's step is steep in it
    assert excluded <= 0.05 * total, (excluded, total)


# each focus on both engines and at both widths; each engine at both widths
_CASES = [("g", "strip", DS), ("g", "edge_list", 0), ("n", "strip", 0), ("n", "edge_list", DS),
          ("a", "strip", DS), ("a", "edge_list", 0)]


@pytest.mark.parametrize("focus,layout,ds", _CASES, ids=[f"{f}-{lay}-ds{ds}" for f, lay, ds in _CASES])
def test_forward_and_step_match_jax(focus, layout, ds, monkeypatch):
    jb, tb = _batch_pair(layout, focus)
    jm, tm = cgnn_pair(focus, ds=ds, seed=4)
    assert tm._use_transposed(tb) == jm._use_transposed(jb) == (layout == "strip")
    rng = jax.random.PRNGKey(11)
    if ds:
        feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, ds))
    assert _eval_matches(jm, tm, jb, tb, rng) == 5
    _step_matches(jm, tm, jb, tb, rng)


@pytest.mark.parametrize("ds", [0, DS])
def test_per_iteration_bn_matches_jax(ds, monkeypatch):
    jb, tb = _batch_pair("strip", "g", seed=5)
    jm, tm = cgnn_pair("g", ds=ds, seed=7, per_iteration_bn=True)
    shapes = {tuple(v.shape) for n, v in tm.named_buffers() if n.startswith("net_state.")}
    assert {s[0] for s in shapes} == {5} and all(len(s) == 2 for s in shapes)
    rng = jax.random.PRNGKey(2)
    if ds:
        feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, ds))
    assert _eval_matches(jm, tm, jb, tb, rng) == 5
    _step_matches(jm, tm, jb, tb, rng)


def test_batch_missing_a_type_matches_jax():
    """Type 1 has no node: its net's BatchNorm moments count max(0, 1) = 1
    row, finite, and its moving statistics decay as JAX's do; its net gets
    a zero gradient."""
    jb, tb = _batch_pair("strip", "g", seed=6, absent=1)
    assert not tb.type_mask[:, 1].any() and tb.type_mask[:, 0].any() and tb.type_mask[:, 2].any()
    jm, tm = cgnn_pair("g", ds=0, seed=8)
    rng = jax.random.PRNGKey(3)
    _eval_matches(jm, tm, jb, tb, rng)
    _step_matches(jm, tm, jb, tb, rng)
    for name, value in tm.named_buffers():
        assert torch.isfinite(value).all(), name
    for p in tm.net_state[1].parameters():
        assert p.grad is not None and not p.grad.any()


def test_surface_fit_evaluate_predict_and_refusals(monkeypatch):
    jb, tb = _batch_pair("strip", "g", seed=12)
    _, tm = cgnn_pair("g", ds=0, seed=13)
    assert tm.fold_transition() is None
    assert repr(tm).startswith("CompositeGNN(type=graph")
    tm.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    seq = Batches([tb])
    history = tm.fit(seq, epochs=2, verbose=0)
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    assert np.isfinite(list(tm.evaluate(seq).values())).all()
    pred = tm.predict(seq)
    assert pred.shape == (int(np.asarray(jb.target_mask).sum()), 2)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, rtol=1e-5)
    # a homogeneous batch, and a batch with another type count, are refused
    _, homogeneous = merged_pair(_raw("g", 12), focus="g")
    with pytest.raises(ValueError, match="composite batch"):
        tm.forward(tbatch.from_graph_object(homogeneous, device="cpu"))
    _, one_type = composite_merged_pair(_raw("g", 12), n_types=1)
    with pytest.raises(ValueError, match="node types"):
        tm.forward(tbatch.from_graph_object(one_type, device="cpu"))
    _, tm10 = cgnn_pair("g", ds=DS, seed=13)
    with pytest.raises(ValueError, match="generator"):
        tm10.forward(tb)
    # the regularization loss sums every per-type net and the output net
    total = tm.net_output.regularization_loss() + sum(net.regularization_loss() for net in tm.net_state)
    assert torch.equal(tm.regularization_loss(), total)


def test_model_family_builders_run_at_small_size():
    """``data/synthetic``'s model family (the card smoke's phase 18) at a
    small size on the CPU: the composite molecules, the starter's CLGNN and
    CGNN, the flagship LGNN (its state widening 14 + 16·l) and the 3-type
    arc CGNN, each through a forward and a train step."""
    from gnnkeras_tpu_torch.data import synthetic as S

    mols = S.random_molecules(12, seed=3)
    comp = tgraph.CompositeGraphObject.merge([S.composite_of(g) for g in mols], focus="g", aggregation_mode="average")
    assert comp.num_types == 1 and tuple(comp.DIM_NODE_LABEL) == (14,)
    arc = [tgraph.GraphObject(nodes=g.nodes, arcs=g.arcs, focus="a", aggregation_mode="average", arcs_canonical=True,
                              targets=np.eye(2, dtype=np.float32)[np.arange(len(g.arcs)) % 2]) for g in mols]
    typed = [S.composite_of(g, 3, "composite_average") for g in arc]
    assert all(t.aggregation_mode == "composite_average" for t in typed)
    for g in typed:  # each node's type holds its one-hot class in its label columns
        types = np.argmax(g.type_mask, axis=1)
        assert np.all(np.argmax(g.nodes, axis=1) < np.asarray(S.ATOM_TYPE_BOUNDS)[types])
    b_comp = tbatch.graphs_to_batch([S.composite_of(g) for g in mols], "g", "average", slot_pack=128, device="cpu")
    b_typed = tbatch.graphs_to_batch(typed, "a", "composite_average", slot_pack=128, device="cpu")
    b_flat = tbatch.graphs_to_batch(mols, "g", "average", slot_pack=128, device="cpu")
    lgnn = S.flagship_lgnn("cpu", layers=5)
    assert [g.net_state.input_dim[0] for g in lgnn.gnns] == [31, 63, 95, 127, 159]
    clgnn = S.starter_clgnn("cpu")
    assert [g.net_state[0].input_dim[0] for g in clgnn.gnns] == [51, 75, 75, 75, 75]
    for model, batch, kw in ((clgnn, b_comp, dict(training_mode="parallel", average_st_grads=True)),
                             (S.starter_cgnn("cpu"), b_comp, {}),
                             (lgnn, b_flat, dict(training_mode="residual", average_st_grads=True)),
                             (S.typed_arc_cgnn("cpu"), b_typed, {})):
        _, states, outs, mask, _ = model.forward(batch, generator=torch.Generator().manual_seed(0))
        out = outs[-1] if isinstance(outs, list) else outs
        assert np.isfinite(out.numpy()[mask.numpy()]).all()
        if model is lgnn:
            assert [s.shape[1] for s in states] == [14, 30, 46, 62, 78]
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", **kw)
        logs, _ = ttr.train_step(model, batch, torch.Generator().manual_seed(1))
        assert np.isfinite(float(logs["loss_sum"]))
