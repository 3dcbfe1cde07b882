"""dim_state > 0 and per-iteration BatchNorm in the port against the JAX
package, on the same batches and weights (non-trivial BatchNorm statistics).

dim_state 10 (the width of ``examples/starter_composite.py``), node and
graph focus, both engines: the strip batch runs the feature-major engine,
the edge-list batch the row-major one.  The random initial state is JAX's
draw for the rng the JAX forward is given, fed to the port through its
``initial_state``.  ``per_iteration_bn`` keeps one set of moving statistics
per iteration: training reads and writes set k at step k, inference reads
set min(k, K − 1).

Tolerances: f32 in both, sums in other orders; state, outputs, loss and
moving statistics rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 and atol 1e-6
of the model's largest |g|.  The atol is the model's, not each leaf's (as
in test_torch_training.py's converging case): the state net's BatchNorm
beta at dim_state 10 has entries a thousand times below that leaf's largest,
sums of a few hundred cancelling terms carried back through 5 iterations,
and such an entry departs by 2e-6 of the leaf's largest in f32.  The
conversion round trip is exact.
"""

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.convert import variables_from_jax, variables_to_jax
from torch_port_common import feed_init_draw, gnn_pair, jax_init_draw, merged_pair, node_targets, raw_molecules, \
    unique_pairs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
DS = 10

_LAYOUTS = {
    "strip": dict(slot_pack=128, strip_dtype="int8"),  # feature-major engine
    "edge_list": dict(dense_blocks=False),  # row-major engine
}


def _batch_pair(layout, focus, seed=3, n_graphs=10):
    raw = unique_pairs(raw_molecules(n_graphs=n_graphs, seed=seed))
    if focus == "n":
        raw = node_targets(raw, seed=seed)
    jm, tm = merged_pair(raw, focus=focus)
    return jbatch.from_graph_object(jm, **_LAYOUTS[layout]), tbatch.from_graph_object(tm, device="cpu",
                                                                                       **_LAYOUTS[layout])


def _port_dict(tree, section):
    other = "state" if section == "params" else "params"
    return variables_from_jax({section: jax.tree_util.tree_map(np.asarray, tree), other: {}})


def _assert_stats(got, want_tree):
    want = _port_dict(want_tree, "state")
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_grads(tm, grads):
    want = {name: w.numpy() for name, w in _port_dict(grads, "params").items()}
    atol = GRAD_ATOL_REL * max(np.abs(w).max() for w in want.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=GRAD_RTOL, atol=atol, err_msg=name)


def _eval_matches(jm, tm, jb, tb, rng):
    jk, jstate, jout, jmask, _ = jm.forward(jm.variables, jb, training=False, rng=rng)
    k, state, out, mask, _ = tm.forward(tb, training=False, generator=torch.Generator())
    assert k == int(jk)
    node_mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(state.numpy()[node_mask], np.asarray(jstate)[node_mask], rtol=RTOL, atol=ATOL)
    m = np.asarray(jmask)
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)
    return k


def _objective_matches(jm, tm, jb, tb, rng):
    jm.compile(optimizer="sgd", loss="categorical_crossentropy")
    tm.compile(optimizer="sgd", loss="categorical_crossentropy")
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, aux), grads = jax.value_and_grad(
        lambda p: jtr._objective(jm, p, mstate, jb, rng, training=True), has_aux=True
    )(params)
    loss, taux = ttr._objective(tm, tb, torch.Generator(), training=True)
    loss.backward()
    assert float(taux["k"]) == float(aux["k"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    _assert_stats(taux["new_state"], aux["new_state"])
    _assert_grads(tm, grads)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("focus", ["g", "n"])
def test_dim_state_forward_and_grads_match_jax(focus, layout, monkeypatch):
    jb, tb = _batch_pair(layout, focus)
    jm, tm = gnn_pair(focus, ds=DS, seed=4)
    assert tm._use_transposed(tb) == jm._use_transposed(jb) == (layout == "strip")
    rng = jax.random.PRNGKey(11)
    feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, DS))
    assert _eval_matches(jm, tm, jb, tb, rng) == 5
    _objective_matches(jm, tm, jb, tb, rng)


def test_dim_state_needs_a_generator_and_does_not_fold():
    _, tb = _batch_pair("strip", "g")
    _, tm = gnn_pair("g", ds=DS)
    with pytest.raises(ValueError, match="generator"):
        tm.forward(tb)
    assert tm.fold_transition() is None
    # the draw comes from the generator: N(0, 0.1²)
    import gnnkeras_tpu_torch.models.gnn as tgnn

    draw = tgnn.initial_state(4000, DS, torch.Generator().manual_seed(0), "cpu")
    assert draw.shape == (4000, DS) and abs(float(draw.std()) - 0.1) < 0.005
    assert torch.equal(draw, tgnn.initial_state(4000, DS, torch.Generator().manual_seed(0), "cpu"))


@pytest.mark.parametrize("ds", [0, DS])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_per_iteration_bn_matches_jax(layout, ds, monkeypatch):
    jb, tb = _batch_pair(layout, "g", seed=5)
    jm, tm = gnn_pair("g", ds=ds, seed=7, per_iteration_bn=True)
    stacked = dict(tm.net_state.named_buffers())
    assert {tuple(v.shape) for v in stacked.values()} == {(5, tm.net_state.input_dim[0])}
    assert tm.fold_transition() is None
    rng = jax.random.PRNGKey(2)
    if ds:
        feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, ds))
    # inference reads statistic min(k, K − 1): perturbed per iteration, so a
    # wrong slice shows
    assert _eval_matches(jm, tm, jb, tb, rng) == 5
    _objective_matches(jm, tm, jb, tb, rng)


def test_per_iteration_bn_train_step_writes_each_iteration():
    jb, tb = _batch_pair("strip", "g", seed=6)
    jm, tm = gnn_pair("g", seed=8, per_iteration_bn=True)
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy")
    params, mstate = jm.variables["params"], jm.variables["state"]
    _, new_mstate, _, _ = jtr._train_step_body(jm)(params, mstate, jm.optimizer.init(params), jb,
                                                     jax.random.PRNGKey(0))
    before = {n: b.clone() for n, b in tm.named_buffers()}
    ttr.train_step(tm, tb)
    _assert_stats(dict(tm.named_buffers()), new_mstate)
    for n, b in tm.named_buffers():
        # every iteration's statistics moved, each by its own batch moments
        assert not torch.equal(b, before[n]) and all(not torch.equal(b[i], before[n][i]) for i in range(5))


@pytest.mark.parametrize("per_iteration_bn", [False, True])
def test_convert_round_trips(per_iteration_bn):
    jm, tm = gnn_pair("g", ds=DS, seed=9, per_iteration_bn=per_iteration_bn)
    tree = variables_to_jax(tm)
    want = jax.tree_util.tree_map(np.asarray, jm.variables)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for got, w in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        assert got.shape == w.shape and got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    # and back into a fresh port model
    _, fresh = gnn_pair("g", ds=DS, seed=10, per_iteration_bn=per_iteration_bn)
    fresh.load_state_dict(variables_from_jax(tree))
    for (n, a), (_, b) in zip(tm.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
