"""The layered models (``models/lgnn.py``: ``LGNN`` and ``CompositeLGNN``)
in the port against the JAX package, on the same batches and weights
(non-trivial BatchNorm statistics), 2-3 layers with get_state and
get_output:

- the starter's CLGNN (1-type composite molecules, dim_state 10) and the
  homogeneous LGNN of the flagship architecture (dim_state 0, the state
  widening 14, 30, 46), graph focus, 3 layers, on the slot-packed strip
  batch;
- a 3-type composite LGNN and a homogeneous LGNN in arc focus (the output
  propagated into the arc labels), 2 layers, on the strip and the
  edge-list batch;
- per-layer ks, states and outputs of the eval forward and its moving
  statistics; the ``parallel`` and ``residual`` objectives (loss, per-layer
  ks, new statistics, gradients) with ``average_st_grads`` (each layer's
  state nets over its own k) and an Adam step on them; one step through
  JAX's ``_train_step_body``; ``evaluate`` (scoring the last layer) and
  ``predict``; ``serial`` handing over to ``training.serial``; the ``convert``
  round trip of both nested trees.

At dim_state 10 each layer draws its own initial state: JAX's per-layer
draws for the rng its forward is given (``jax_lgnn_draws``) are fed to the
port in layer order.  Each case's batches, models (one seed) and compiled
JAX eval forward are built once for the module (``setups``); every test
starts from the models' first weights.

Tolerances, those of test_torch_composite.py (f32 in both, sums in other
orders; the JAX references jitted): states, outputs, loss and statistics
rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 and atol 1e-6 of the model's
largest |g|; Adam's parameters rtol 1e-5 / atol 1e-6 where the step is not
steep in the gradient (``adam_live``).  A layer reads the layer below's
state as labels through a BatchNorm, so the departure grows with depth:
the worst measured (one CPU core) is the flagship LGNN's layer-2 state,
2.15e-6 absolute, 0.97 of its tolerance (layers 0 and 1: 0.56 and 0.63).
The arc stacks run 2 layers to keep the file's compile time down; at 3
layers the arc LGNN's layer-2 state departed by 1.25e-6 on an entry of
3e-3, past atol 1e-6 (measured), so a third layer needs a stated wider
bound.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.training.losses import get_loss
from gnnkeras_tpu_torch.convert import variables_from_jax, variables_to_jax
from torch_port_common import Batches, adam_live, arc_targets, assert_stats, compile_jitted, composite_merged_pair, \
    feed_init_draw, jax_lgnn_draws, jax_optimizer_step, lgnn_pair, merged_pair, port_dict, raw_molecules, run_jitted, \
    unique_pairs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
LAYERS = 3

_LAYOUTS = {
    "strip": dict(slot_pack=128, strip_dtype="float32"),
    "edge_list": dict(dense_blocks=False),
}

# (name, composite, focus, dim_state, node types, layout, training mode, layers)
_CASES = [
    ("starter_clgnn", True, "g", 10, 1, "strip", "parallel", 3),
    ("flagship_lgnn", False, "g", 0, 1, "strip", "residual", 3),
    ("typed_arc_clgnn", True, "a", 0, 3, "strip", "residual", 2),
    ("arc_lgnn", False, "a", 0, 1, "edge_list", "parallel", 2),
]


def _batch_pair(composite, focus, n_types, layout, seed=3):
    raw = unique_pairs(raw_molecules(n_graphs=8, seed=seed))
    if focus == "a":
        raw = arc_targets(raw, seed=seed)
    if composite:
        jm, tm = composite_merged_pair(raw, focus=focus, n_types=n_types)
    else:
        jm, tm = merged_pair(raw, focus=focus)
    return jbatch.from_graph_object(jm, **_LAYOUTS[layout]), tbatch.from_graph_object(tm, device="cpu",
                                                                                       **_LAYOUTS[layout])


def _loss(tb, out):
    return get_loss("categorical_crossentropy")(tb.targets, out)


@pytest.fixture(scope="module")
def setups():
    """``get(case, monkeypatch)``: the case's batch pair, model pair, rng,
    training mode and JAX eval forward (compiled once for the case), built
    once for the module and shared by the tests; each call hands back both
    models with their first weights and statistics, and feeds JAX's
    per-layer draws to the port at dim_state > 0."""
    built = {}

    def get(case, monkeypatch):
        _, composite, focus, ds, n_types, layout, mode, layers = case
        if case not in built:
            jb, tb = _batch_pair(composite, focus, n_types, layout)
            jm, tm = lgnn_pair(composite, focus, ds, layers, seed=4, n_types=n_types)
            rng = jax.random.PRNGKey(11)
            forward = compile_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r), jm.variables, jb, rng)
            draws = jax_lgnn_draws(rng, tb.num_nodes, ds, layers) if ds else None
            built[case] = SimpleNamespace(jm=jm, tm=tm, jb=jb, tb=tb, rng=rng, mode=mode, forward=forward,
                                          draws=draws, variables=jm.variables,
                                          weights={n: t.clone() for n, t in tm.state_dict().items()})
        s = built[case]
        s.jm.variables = s.variables
        s.tm.load_state_dict(s.weights)
        for p in s.tm.parameters():
            p.grad = None
        if s.draws is not None:
            feed_init_draw(monkeypatch, s.draws)
        return s

    return get


def _assert_stats(got, want_tree):
    assert all(k.startswith("gnns.") for k in got)
    assert_stats(got, want_tree, RTOL, ATOL)


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_forward_matches_jax_layer_by_layer(case, setups, monkeypatch):
    s = setups(case, monkeypatch)
    jm, tm, jb, tb = s.jm, s.tm, s.jb, s.tb
    jks, jstates, jouts, jmask, jst = s.forward(jm.variables, jb, s.rng)
    ks, states, outs, mask, st = tm.forward(tb, training=False, generator=torch.Generator())
    assert ks == [int(k) for k in jks] and len(ks) == case[-1]
    node_mask = np.asarray(jb.node_mask)
    for layer, (state, js) in enumerate(zip(states, jstates)):
        np.testing.assert_allclose(state.numpy()[node_mask], np.asarray(js)[node_mask], rtol=RTOL, atol=ATOL,
                                   err_msg=f"state {layer}")
    m = np.asarray(jmask)
    np.testing.assert_array_equal(mask.numpy(), m)
    for layer, (o, jo) in enumerate(zip(outs, jouts)):
        # every layer's output is row-aligned with the focus entity
        np.testing.assert_allclose(o.numpy()[m], np.asarray(jo)[m], rtol=RTOL, atol=ATOL, err_msg=f"out {layer}")
    _assert_stats(st, jst)
    # the state widens layer by layer (dim_state 0) or stays (dim_state 10)
    assert [state.shape[1] for state in states] == [np.asarray(js).shape[1] for js in jstates]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_objective_and_adam_step_match_jax(case, setups, monkeypatch):
    s = setups(case, monkeypatch)
    jm, tm, jb, tb = s.jm, s.tm, s.jb, s.tb
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", training_mode=s.mode, average_st_grads=True)
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, aux), grads = run_jitted(jax.value_and_grad(
        lambda p, b, r: jtr._objective(jm, p, mstate, b, r, training=True), has_aux=True), params, jb, s.rng)
    grads, new_params = jax_optimizer_step(jm, params, grads, aux["k"])
    logs, taux = ttr.train_step(tm, tb, torch.Generator())
    assert [float(k) for k in taux["k"]] == [float(k) for k in aux["k"]]
    np.testing.assert_allclose(float(logs["loss_sum"] / logs["count"]), float(jloss), rtol=RTOL)
    _assert_stats(taux["new_state"], aux["new_state"])
    _assert_stats(dict(tm.named_buffers()), aux["new_state"])
    want_grads = port_dict(grads, "params")
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    atol = GRAD_ATOL_REL * max(float(np.abs(w.numpy()).max()) for w in want_grads.values())
    want = port_dict(new_params, "params")
    excluded = total = 0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=GRAD_RTOL, atol=atol,
                                   err_msg=name)
        live = adam_live(p.grad.numpy(), want_grads[name].numpy())
        excluded, total = excluded + int((~live).sum()), total + live.size
        np.testing.assert_allclose(p.detach().numpy()[live], want[name].numpy()[live], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert excluded <= 0.05 * total, (excluded, total)


def test_the_modes_take_their_losses():
    """``parallel``: the mean of the per-layer losses; ``residual``: the loss
    of the mean output; evaluation: the last layer's loss."""
    _, tm = lgnn_pair(False, "g", 0, LAYERS, seed=6)
    _, tb = _batch_pair(False, "g", 1, "strip", seed=6)
    _, _, outs, _, _ = tm.forward(tb, training=True, generator=torch.Generator())
    per_layer = [ttr.masked_mean(_loss(tb, o), tb.target_mask, tb.sample_weight) for o in outs]
    reg = tm.regularization_loss()
    for mode, want in (("parallel", sum(per_layer) / LAYERS),
                       ("residual", ttr.masked_mean(_loss(tb, sum(outs) / LAYERS), tb.target_mask,
                                                    tb.sample_weight))):
        tm.compile(optimizer="sgd", loss="categorical_crossentropy", training_mode=mode)
        loss, _ = ttr._objective(tm, tb, torch.Generator(), training=True)
        torch.testing.assert_close(loss, want + reg, rtol=1e-6, atol=0)
    with torch.no_grad():
        _, _, outs, _, _ = tm.forward(tb, training=False)
        loss, aux = ttr._objective(tm, tb, torch.Generator(), training=False)
    torch.testing.assert_close(loss, ttr.masked_mean(_loss(tb, outs[-1]), tb.target_mask, tb.sample_weight) + reg,
                               rtol=1e-6, atol=0)
    assert aux["y_pred"] is not None and len(aux["k"]) == LAYERS


def test_jax_train_step_body_evaluate_and_predict_match(setups, monkeypatch):
    s = setups(_CASES[0], monkeypatch)
    jm, tm, jb, tb, rng = s.jm, s.tm, s.jb, s.tb, s.rng
    for m in (jm, tm):
        m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"],
                  training_mode="parallel", average_st_grads=True)
    params, mstate = jm.variables["params"], jm.variables["state"]
    new_params, new_mstate, _, jlogs = run_jitted(jtr._train_step_body(jm), params, mstate,
                                                  jm.optimizer.init(params), jb, rng)
    logs, _ = ttr.train_step(tm, tb, torch.Generator())
    for key in ("loss_sum", "count", "accuracy_sum", "accuracy_count"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=RTOL, err_msg=key)
    _assert_stats(dict(tm.named_buffers()), new_mstate)
    want = port_dict(new_params, "params")
    for name, p in tm.named_parameters():  # SGD: the step is linear in the gradient
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=1e-7, err_msg=name)
    # evaluate scores the last layer, predict serves it, on the stepped weights
    jm.variables = {"params": new_params, "state": new_mstate}
    ev = tm.evaluate(Batches([tb]))
    with torch.no_grad():
        _, _, outs, mask, _ = tm.forward(tb, training=False, generator=torch.Generator())
    last = ttr.masked_mean(_loss(tb, outs[-1]), tb.target_mask, tb.sample_weight) + tm.regularization_loss()
    np.testing.assert_allclose(ev["loss"], float(last), rtol=1e-6)
    jouts = s.forward(jm.variables, jb, rng)[2]
    pred = tm.predict(Batches([tb]))
    rows = tb.host_pred_rows
    np.testing.assert_allclose(pred, np.asarray(jouts[-1])[rows], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pred, outs[-1].numpy()[rows], rtol=RTOL, atol=ATOL)


def test_serial_mode_is_not_ported(monkeypatch):
    """Serial mode is ported: ``fit`` hands the stack to
    ``training.serial.fit_serial`` (held to the JAX package in
    ``tests/test_torch_serial.py``); an unknown mode is refused."""
    import gnnkeras_tpu_torch.training.serial as tserial

    _, tm = lgnn_pair(False, "g", 0, 2, seed=8)
    tm.compile(optimizer="adam", loss="categorical_crossentropy", training_mode="serial")
    calls = []
    monkeypatch.setattr(tserial, "fit_serial", lambda model, seq, **kw: calls.append((model, seq, kw)) or "h")
    seq = Batches([])
    assert tm.fit(seq, epochs=3) == "h" and calls == [(tm, seq, {"epochs": 3})]
    with pytest.raises(AssertionError):
        tm.compile(training_mode="stacked")


def test_update_graph_grows_the_labels_and_drops_stale_sums():
    _, tm = lgnn_pair(True, "a", 0, 2, seed=9, n_types=3)
    _, tb = _batch_pair(True, "a", 3, "strip", seed=9)
    state = torch.randn(tb.num_nodes, 14, generator=torch.Generator().manual_seed(0))
    out = torch.rand(tb.num_arcs, 2, generator=torch.Generator().manual_seed(1))
    cur = tm.update_graph(tb, state, out, tb.output_row_mask)
    assert cur.dim_node_label == tuple(d + 14 for d in tb.dim_node_label)
    assert torch.equal(cur.nodes, torch.cat([state, tb.nodes], dim=1))
    # the arc focus propagates its output into the arc labels, after src/dst
    assert torch.equal(cur.arc_label[:, 2:], tb.arc_label)
    assert torch.equal(cur.arc_label[:, :2], torch.where(tb.output_row_mask[:, None], out, 0.0))
    assert cur.agg_node_labels is None and cur.agg_component is None and cur.agg_arc_labels is None
    assert cur.type_mask is tb.type_mask and cur.strip is tb.strip


@pytest.mark.parametrize("composite", [False, True])
def test_convert_round_trips_the_nested_trees(composite):
    jm, tm = lgnn_pair(composite, "g", 10 if composite else 0, LAYERS, seed=10, n_types=3 if composite else 1)
    tree = variables_to_jax(tm)
    want = jax.tree_util.tree_map(np.asarray, jm.variables)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for got, w in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        assert got.shape == w.shape and got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    names = set(variables_from_jax(tree))
    assert names == set(tm.state_dict())
    if composite:
        assert "gnns.2.net_state.2.layers.0.moving_mean" in names
    _, fresh = lgnn_pair(composite, "g", 10 if composite else 0, LAYERS, seed=11, n_types=3 if composite else 1)
    fresh.load_state_dict(variables_from_jax(tree))
    for (n, a), (_, b) in zip(tm.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
