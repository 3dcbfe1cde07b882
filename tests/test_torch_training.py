"""The port's training step against the JAX package's, on the same batches
and weights (non-trivial BatchNorm statistics), on the CPU.

- the objective (``trainer._objective``): loss, k, outputs, new moving
  statistics and gradients, for graph and node focus, strip int8, strip bf16
  (the int8 request falling back on parallel arcs) and edge-list batches, at
  threshold 0, at 0.01 (where the flagship's random weights still run all 5
  steps), and at 0.05 with a state net that moves the state little against
  its norm, where the training loop's running flag turns false at step 4;
  ``average_st_grads`` (the state net's gradients over max(k, 1)) on each;
- one SGD and one Adam step through JAX's ``_train_step_body``;
- Adam's and SGD's updates on fixed gradients against optax;
- ``fit`` (2 epochs × 2 batches), ``evaluate``, ``predict``;
- every loss and metric of the JAX package.

Tolerances.  f32 in both, sums in other orders.  Loss, outputs and moving
statistics: rtol 1e-5 / atol 1e-6.  Gradients: rtol 1e-4 and atol 1e-6 of
the leaf's largest |g| (5 chained iterations of backward sums).  In the
converging case the state net's BatchNorm divides by a spread of 0.1-0.9
around a state of norm ~10, and both packages' f32 gradients depart from a
float64 evaluation of the port by up to 4.5e-6 (largest |g| 0.49), and
the node outputs by up to 6e-6, as far as they depart from each other:
there the outputs are held to atol 1e-5 and the gradients to rtol 1e-4 and
atol 1e-5 of the model's largest |g|.  SGD step:
parameters rtol 1e-5 / atol 1e-7.  Adam's first step is about lr·sign(g),
so an entry whose |g| is below 1e-6 of its leaf's largest can move by up
to 2·lr on a summation-order sign flip: such entries are excluded and
counted (the test asserts how many), the rest held to rtol 1e-5 /
atol 1e-6.  Optimizers on fixed gradients: rtol 1e-6 / atol 2e-7; both
form Adam's bias correction 1 − 0.999ᵗ in f32, optax through XLA's
``pow`` and the port through PyTorch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu.training.losses as jlosses
import gnnkeras_tpu.training.metrics as jmetrics
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.models.mlp as tmlp
import gnnkeras_tpu_torch.training.losses as tlosses
import gnnkeras_tpu_torch.training.metrics as tmetrics
import gnnkeras_tpu_torch.training.optimizers as topt
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu.training.optimizers import get_optimizer as jax_optimizer
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import Batches, flagship_pair, merged_pair, node_targets, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6

_BATCHES = {
    "strip_int8": dict(slot_pack=128, strip_dtype="int8"),
    # parallel arcs: the int8 request falls back to bf16 weights (the bench's case)
    "strip_bf16": dict(slot_pack=128, strip_dtype="int8"),
    "edge_list": dict(dense_blocks=False),
}
# threshold, state net (kernel scale, bias shift)
_THRESHOLDS = {"0": (0.0, None), "0.01": (0.01, None), "0.05-converging": (0.05, (0.3, 10.0))}

pytestmark = pytest.mark.filterwarnings("ignore:int8 mask\\+scale strip storage")


def _batch_pair(layout, focus="g", seed=3, n_graphs=12):
    raw = raw_molecules(n_graphs=n_graphs, seed=seed)
    if layout != "strip_bf16":
        raw = unique_pairs(raw)
    if focus == "n":
        raw = node_targets(raw, seed=seed)
    jm, tm = merged_pair(raw, focus=focus)
    jb = jbatch.from_graph_object(jm, **_BATCHES[layout])
    tb = tbatch.from_graph_object(tm, device="cpu", **_BATCHES[layout])
    if layout.startswith("strip"):
        assert (tb.strip.scale is not None) == (layout == "strip_int8")
    return jb, tb


def _compiled_pair(focus="g", threshold="0", seed=2, optimizer="sgd", **compile_kw):
    thr, state_dense = _THRESHOLDS[threshold]
    jm, tm = flagship_pair(seed=seed, threshold=thr, node_focus=focus == "n", state_dense=state_dense)
    for m in (jm, tm):
        m.compile(optimizer=optimizer, loss="categorical_crossentropy", metrics=["accuracy"], **compile_kw)
    return jm, tm


def _port_dict(tree, section):
    """A JAX variables section as the port's state-dict keys."""
    other = "state" if section == "params" else "params"
    return variables_from_jax({section: jax.tree_util.tree_map(np.asarray, tree), other: {}})


def _assert_grads(got: dict, want_tree, model_atol_rel=None):
    """Per leaf: rtol 1e-4, atol 1e-6 of the leaf's largest |g|; or, with
    ``model_atol_rel``, atol that share of the whole model's largest |g|."""
    want = {name: w.numpy() for name, w in _port_dict(want_tree, "params").items()}
    assert set(got) == set(want)
    g_max = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        atol = GRAD_ATOL_REL * np.abs(w).max() if model_atol_rel is None else model_atol_rel * g_max
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def _assert_stats(got: dict, want_tree):
    want = _port_dict(want_tree, "state")
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("threshold", list(_THRESHOLDS))
@pytest.mark.parametrize("layout", list(_BATCHES))
@pytest.mark.parametrize("focus", ["g", "n"])
def test_objective_and_grads_match_jax(focus, layout, threshold):
    jb, tb = _batch_pair(layout, focus)
    jm, tm = _compiled_pair(focus, threshold)
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, aux), grads = jax.value_and_grad(
        lambda p: jtr._objective(jm, p, mstate, jb, None, training=True), has_aux=True
    )(params)
    loss, taux = ttr._objective(tm, tb, None, training=True)
    loss.backward()

    converging = threshold == "0.05-converging"
    k = float(taux["k"])
    assert k == float(aux["k"])
    assert k == (4.0 if converging else 5.0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    m = np.asarray(jb.target_mask)
    np.testing.assert_allclose(taux["y_pred"].detach().numpy()[m], np.asarray(aux["y_pred"])[m], rtol=RTOL,
                               atol=1e-5 if converging else ATOL)
    _assert_stats(taux["new_state"], aux["new_state"])
    atol_rel = 1e-5 if converging else None
    _assert_grads({n: p.grad for n, p in tm.named_parameters()}, grads, atol_rel)

    # average_st_grads: the state net's gradients over max(k, 1), the output net's kept
    tm.scale_state_grads(taux["k"])
    _assert_grads({n: p.grad for n, p in tm.named_parameters()}, jm.scale_state_grads(grads, aux["k"]), atol_rel)


@pytest.mark.parametrize("average_st_grads", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd:0.1", "adam:0.01"])
@pytest.mark.parametrize("layout", list(_BATCHES))
def test_train_step_matches_jax(layout, optimizer, average_st_grads):
    jb, tb = _batch_pair(layout)
    jm, tm = _compiled_pair(optimizer=optimizer, average_st_grads=average_st_grads)
    params, mstate = jm.variables["params"], jm.variables["state"]
    new_params, new_mstate, _, jlogs = jtr._train_step_body(jm)(
        params, mstate, jm.optimizer.init(params), jb, jax.random.PRNGKey(0)
    )
    logs, _ = ttr.train_step(tm, tb)

    for key in ("loss_sum", "count", "accuracy_sum", "accuracy_count"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=RTOL, err_msg=key)
    _assert_stats(dict(tm.named_buffers()), new_mstate)
    want = _port_dict(new_params, "params")
    excluded = 0
    for name, p in tm.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), p.grad.numpy()
        if optimizer.startswith("sgd"):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=1e-7, err_msg=name)
            continue
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        excluded += int((~live).sum())
        np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=ATOL, err_msg=name)
    # the flagship's 8 parameter tensors hold 493 entries; none has a gradient that small
    assert excluded == 0


@pytest.mark.parametrize("name", ["sgd:0.1", "adam:0.01", "adam"])
def test_optimizer_matches_optax_on_fixed_gradients(name):
    import optax

    rng = np.random.default_rng(8)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    # magnitudes from 1e-9 to 1: eps 1e-7 decides the smallest entries' steps
    grads = [(rng.normal(size=p0.shape) * 10.0 ** rng.uniform(-9, 0, p0.shape)).astype(np.float32)
             for _ in range(3)]
    jopt = jax_optimizer(name)
    params = jnp.asarray(p0)
    state = jopt.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = topt.get_optimizer(name)([p])
    for g in grads:
        updates, state = jopt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=2e-7)


def test_learning_rate_get_and_set():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = topt.get_optimizer("adam:0.02")([p])
    assert topt.current_learning_rate(opt) == pytest.approx(0.02)
    assert topt.set_learning_rate(opt, 0.005)
    assert topt.current_learning_rate(opt) == pytest.approx(0.005)
    assert topt.current_learning_rate(topt.get_optimizer("sgd")([p])) == pytest.approx(0.01)
    with pytest.raises(ValueError):
        topt.get_optimizer("lamb")


def _two_batch_pairs(focus="g"):
    pairs = [_batch_pair("strip_int8", focus, seed=s, n_graphs=8) for s in (11, 12)]
    return Batches([j for j, _ in pairs]), Batches([t for _, t in pairs])


@pytest.mark.parametrize("class_weight", [None, {0: 2.0, 1: 0.5}])
def test_fit_two_epochs_matches_jax(class_weight):
    jseq, tseq = _two_batch_pairs()
    jm, tm = _compiled_pair(optimizer="adam:0.01", seed=5)
    jh = jm.fit(jseq, epochs=2, verbose=0, scan_batches=False, class_weight=class_weight)
    th = tm.fit(tseq, epochs=2, verbose=0, class_weight=class_weight)
    assert th.epoch == [0, 1] and set(th.keys()) == set(jh.keys()) == {"loss", "accuracy"}
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=RTOL, err_msg=key)
    want = _port_dict(jm.variables["params"], "params")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    _assert_stats(dict(tm.named_buffers()), jm.variables["state"])


def test_evaluate_matches_jax():
    jseq, tseq = _two_batch_pairs()
    jm, tm = _compiled_pair(seed=4)
    want = jm.evaluate(jseq, scan_batches=False, prefix="val_")
    got = tm.evaluate(tseq, prefix="val_")
    assert set(got) == set(want) == {"val_loss", "val_accuracy"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("focus", ["g", "n"])
def test_predict_order_under_tile_packing(focus):
    jseq, tseq = _two_batch_pairs(focus)
    jm, tm = _compiled_pair(focus, seed=7)
    got = tm.predict(tseq)
    np.testing.assert_allclose(got, jtr.predict(jm, jseq), rtol=RTOL, atol=ATOL)
    # the caller's order: rows come back per graph (and node) as given, not as packed
    raw = unique_pairs(raw_molecules(n_graphs=8, seed=11))
    if focus == "n":
        raw = node_targets(raw, seed=11)
    sizes = [1 if focus == "g" else n.shape[0] for n, _, _ in raw]
    start = 0
    for i in (0, 3, 7):
        _, alone = merged_pair([raw[i]], focus=focus)
        one = tm.predict(Batches([tbatch.from_graph_object(alone, device="cpu", **_BATCHES["strip_int8"])]))
        start = sum(sizes[:i])
        np.testing.assert_allclose(got[start:start + sizes[i]], one, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(validation_data=Batches([])), dict(callbacks=[ttr.History()]), dict(checkpoint_dir="ckpt"),
    dict(resume=True), dict(scan_batches=True), dict(validation_freq=2),
])
def test_fit_surface_not_ported_yet(kwargs, tmp_path, monkeypatch):
    """Every option of the fit surface runs, the scanned epoch too (over
    no batch it falls back to the per-step loop, as the JAX package's);
    ``tests/test_torch_fit_surface.py`` and ``tests/test_torch_scanned_fit.py``
    hold them to the JAX package."""
    monkeypatch.chdir(tmp_path)  # a relative checkpoint_dir lands here
    _, tm = _compiled_pair()
    assert tm.fit(Batches([]), verbose=0, **kwargs).epoch == [0]


def test_fit_and_evaluate_need_compile():
    _, tm = flagship_pair(seed=1)
    with pytest.raises(RuntimeError):
        tm.fit(Batches([]))
    with pytest.raises(RuntimeError):
        tm.evaluate(Batches([]))


def test_regularized_objective_matches_jax():
    """l2 on every Dense kernel and l1 on every bias adds the penalty to the
    loss and its gradient to the parameters'."""
    jm, tm = _compiled_pair()
    for module, m in ((jmlp, jm), (tmlp, tm)):
        for net in (m.net_state, m.net_output):
            net.program = [l[:5] + ("l2", "l1") if l[0] == "dense" else l for l in net.program]
    jb, tb = _batch_pair("strip_int8")
    params, mstate = jm.variables["params"], jm.variables["state"]
    (jloss, _), grads = jax.value_and_grad(
        lambda p: jtr._objective(jm, p, mstate, jb, None, training=True), has_aux=True
    )(params)
    assert float(jm.regularization_loss(params)) > 0.0
    np.testing.assert_allclose(float(tm.regularization_loss().detach()), float(jm.regularization_loss(params)),
                               rtol=1e-6)
    loss, _ = ttr._objective(tm, tb, None, training=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    _assert_grads({n: p.grad for n, p in tm.named_parameters()}, grads)


def _loss_inputs(name):
    rng = np.random.default_rng(10)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    if name == "categorical_crossentropy_from_logits":
        p = rng.normal(size=(9, 3))
    elif name in ("binary_crossentropy", "categorical_crossentropy"):
        p = rng.dirichlet(np.ones(3), 9)
        p[0] = [1.0, 0.0, 0.0]  # on and past the clip boundaries
        p[1] = [0.0, 0.0, 1.0]
    else:
        p = rng.normal(size=(9, 3))
    return y, p.astype(np.float32)


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    y, p = _loss_inputs(name)
    jfn, tfn = jlosses.get_loss(name), tlosses.get_loss(name)
    sw = np.random.default_rng(11).uniform(0.5, 2.0, 9).astype(np.float32)
    mask = np.arange(9) < 7
    jl = lambda q: jlosses.masked_mean(jfn(jnp.asarray(y), q), jnp.asarray(mask), jnp.asarray(sw))
    want, want_grad = jax.value_and_grad(jl)(jnp.asarray(p))
    x = torch.from_numpy(p).requires_grad_(True)
    got = tlosses.masked_mean(tfn(torch.from_numpy(y), x), torch.from_numpy(mask), torch.from_numpy(sw))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tfn(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
                               np.asarray(jfn(jnp.asarray(y), jnp.asarray(p))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(jmetrics._METRICS))
def test_metric_matches_jax(name):
    rng = np.random.default_rng(12)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    p = rng.dirichlet(np.ones(3), 20).astype(np.float32)
    mask, sw = np.arange(20) < 15, rng.uniform(0.5, 2.0, 20).astype(np.float32)
    want = jmetrics.get_metric(name)[1](*(jnp.asarray(a) for a in (y, p, mask, sw)))
    got = tmetrics.get_metric(name)[1](*(torch.from_numpy(a) for a in (y, p, mask, sw)))
    assert tmetrics.get_metric(name)[0] == name
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
