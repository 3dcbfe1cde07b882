"""The port's arc-focused GNN (``GNNarcBased``) against the JAX package's,
with the same weights (non-trivial BatchNorm statistics) on the same arc
batches: about a dozen molecules of 5-40 nodes, average aggregation, a
2-class target per arc.

The readout's rows ``[src state | dst state | arc label]`` come through the
incidence select and, backward, the scatter (the port's plain versions
here, JAX's Pallas pair kernels in interpret mode), or through the plain
gather on an edge-list batch, which carries no incidence pairs.

Tolerances.  f32 in both, sums in other orders.  Eval forward, loss,
outputs and moving statistics: rtol 1e-5 / atol 1e-6.  Gradients: rtol 1e-4
and atol 1e-6 of the leaf's largest |g|.  Adam's first step is about
lr·sign(g): entries whose |g| is below 1e-6 of the leaf's largest are
excluded and counted, the rest held to rtol 1e-5 / atol 1e-6.
"""

import jax
import numpy as np
import pytest

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.ops.incidence as tinc
import gnnkeras_tpu_torch.serving as tserving
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import Batches, arc_targets, gnn_pair, graphs, merged_pair, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6

_LAYOUTS = {
    "slot128_int8": dict(slot_pack=128, strip_dtype="int8"),
    # parallel arcs: the strip falls back to bf16 weights (the bench's case)
    "slot128_bf16": dict(slot_pack=128, strip_dtype="int8"),
    "plain": dict(),
    # no dense blocks: no incidence pairs, the readout gathers
    "edge_list": dict(dense_blocks=False),
}

pytestmark = pytest.mark.filterwarnings("ignore:int8 mask\\+scale strip storage")


def _raw(seed, n_graphs=12, unique=True):
    raw = raw_molecules(n_graphs=n_graphs, seed=seed)
    return arc_targets(unique_pairs(raw) if unique else raw, seed=seed)


def _batch_pair(layout, seed=3, n_graphs=12):
    jm, tm = merged_pair(_raw(seed, n_graphs, unique=layout != "slot128_bf16"), focus="a")
    jb = jbatch.from_graph_object(jm, **_LAYOUTS[layout])
    tb = tbatch.from_graph_object(tm, device="cpu", **_LAYOUTS[layout])
    assert (tb.arc_inc is None) == (jb.arc_inc is None) == (layout == "edge_list")
    if layout.startswith("slot"):
        assert (tb.strip.scale is not None) == (layout == "slot128_int8")
    return jb, tb


def _compiled_pair(seed=2, optimizer="adam:0.01"):
    jm, tm = gnn_pair("a", seed=seed)
    for m in (jm, tm):
        m.compile(optimizer=optimizer, loss="categorical_crossentropy", metrics=["accuracy"])
    return jm, tm


def _port_dict(tree, section):
    other = "state" if section == "params" else "params"
    return variables_from_jax({section: jax.tree_util.tree_map(np.asarray, tree), other: {}})


def _count_selects(monkeypatch):
    calls = []
    real = tinc.incidence_select

    def counted(state, inc):
        assert state.is_contiguous()
        calls.append(state.shape)
        return real(state, inc)

    monkeypatch.setattr(tinc, "incidence_select", counted)
    return calls


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_eval_forward_matches_jax(layout, monkeypatch):
    jb, tb = _batch_pair(layout)
    jm, tm = gnn_pair("a", seed=6)
    assert tm._use_transposed(tb) == jm._use_transposed(jb)
    calls = _count_selects(monkeypatch)
    jk, jstate, jout, jmask, _ = jm.forward(jm.variables, jb, training=False)
    k, state, out, mask, _ = tm.forward(tb, training=False)
    assert k == int(jk) == 5
    assert len(calls) == (0 if layout == "edge_list" else 1)
    node_mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(state.numpy()[node_mask], np.asarray(jstate)[node_mask], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    m = np.asarray(jmask)
    assert out.shape == (tb.num_arcs, 2) and m.sum() == tb.host_pred_rows.size
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_objective_and_grads_match_jax(layout):
    jb, tb = _batch_pair(layout)
    jm, tm = _compiled_pair()
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, aux), grads = jax.value_and_grad(
        lambda p: jtr._objective(jm, p, mstate, jb, None, training=True), has_aux=True
    )(params)
    loss, taux = ttr._objective(tm, tb, None, training=True)
    loss.backward()
    assert float(taux["k"]) == float(aux["k"]) == 5.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    m = np.asarray(jb.target_mask)
    np.testing.assert_allclose(taux["y_pred"].detach().numpy()[m], np.asarray(aux["y_pred"])[m], rtol=RTOL,
                               atol=ATOL)
    want_stats = _port_dict(aux["new_state"], "state")
    assert set(taux["new_state"]) == set(want_stats)
    for name, w in want_stats.items():
        np.testing.assert_allclose(taux["new_state"][name].numpy(), w.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    want = _port_dict(grads, "params")
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=name)


def test_adam_step_matches_jax():
    jb, tb = _batch_pair("slot128_bf16", seed=4)
    jm, tm = _compiled_pair(seed=3)
    params, mstate = jm.variables["params"], jm.variables["state"]
    new_params, new_mstate, _, jlogs = jtr._train_step_body(jm)(
        params, mstate, jm.optimizer.init(params), jb, jax.random.PRNGKey(0)
    )
    logs, _ = ttr.train_step(tm, tb)
    for key in ("loss_sum", "count", "accuracy_sum", "accuracy_count"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=RTOL, err_msg=key)
    want_stats = _port_dict(new_mstate, "state")
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    want = _port_dict(new_params, "params")
    excluded = 0
    for name, p in tm.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), p.grad.numpy()
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        excluded += int((~live).sum())
        np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=ATOL, err_msg=name)
    # the arc model's 8 parameter tensors hold 544 entries; none has a gradient that small
    assert excluded == 0


def _two_batches():
    pairs = [_batch_pair("slot128_int8", seed=s, n_graphs=8) for s in (11, 12)]
    return Batches([j for j, _ in pairs]), Batches([t for _, t in pairs])


def test_fit_evaluate_predict_match_jax():
    jseq, tseq = _two_batches()
    jm, tm = _compiled_pair(seed=5)
    jh = jm.fit(jseq, epochs=2, verbose=0, scan_batches=False)
    th = tm.fit(tseq, epochs=2, verbose=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=RTOL, err_msg=key)
    want = _port_dict(jm.variables["params"], "params")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)

    ev, jev = tm.evaluate(tseq), jm.evaluate(jseq, scan_batches=False)
    assert set(ev) == set(jev) == {"loss", "accuracy"}
    for key in jev:
        np.testing.assert_allclose(ev[key], jev[key], rtol=RTOL, err_msg=key)

    got = tm.predict(tseq)
    np.testing.assert_allclose(got, jtr.predict(jm, jseq), rtol=RTOL, atol=ATOL)
    # rows in the caller's order: each molecule's arcs, molecule by molecule
    raw = _raw(11, n_graphs=8)
    sizes = [t.shape[0] for _, _, t in raw]
    for i in (0, 5):
        _, alone = merged_pair([raw[i]], focus="a")
        one = tm.predict(Batches([tbatch.from_graph_object(alone, device="cpu", **_LAYOUTS["slot128_int8"])]))
        start = sum(sizes[:i])
        np.testing.assert_allclose(got[start:start + sizes[i]], one, rtol=RTOL, atol=ATOL)


_REQ_RAW = arc_targets(raw_molecules(n_graphs=10, seed=31), seed=31)
_REQ_J, _REQ_T = graphs(jgraph, _REQ_RAW, focus="a"), graphs(tgraph, _REQ_RAW, focus="a")


@pytest.mark.parametrize("fused", ["auto", False])
def test_predictor_matches_jax(fused, monkeypatch):
    jmodel, tmodel = gnn_pair("a", seed=8)
    jp = jserving.Predictor.for_graphs(jmodel, _REQ_J, batch_size=len(_REQ_J), fused=fused)
    tp = tserving.Predictor.for_graphs(tmodel, _REQ_T, batch_size=len(_REQ_T), fused=fused, device="cpu")
    assert tp.fused == jp.fused == (fused == "auto")
    if fused:
        monkeypatch.setattr(tp, "_predict_eval", lambda merged: pytest.fail("eval route taken"))
    calls = _count_selects(monkeypatch)
    got = tp(_REQ_T)
    assert got.shape == (sum(t.shape[0] for _, _, t in _REQ_RAW), 2) and len(calls) == 1
    np.testing.assert_allclose(got, jp(_REQ_J), rtol=RTOL, atol=ATOL)
    order = [4, 0, 7]
    sub = tp([_REQ_T[i] for i in order])
    np.testing.assert_allclose(sub, jp([_REQ_J[i] for i in order]), rtol=RTOL, atol=ATOL)
    starts = np.cumsum([0] + [t.shape[0] for _, _, t in _REQ_RAW])
    np.testing.assert_allclose(sub, np.concatenate([got[starts[i]:starts[i + 1]] for i in order]), rtol=RTOL,
                               atol=ATOL)
