"""The model's ``transposed`` override against the JAX package's
(``GNNnodeBased.transposed``, ``models/gnn.py``).

- ``transposed=False`` forces the row-major engine on a batch whose strip
  operator picks the feature-major one by default: the eval forward and
  one Adam step through JAX's ``_train_step_body`` match JAX's forced
  row-major run (the forward and moving statistics at rtol 1e-5 /
  atol 1e-6, the parameters at rtol 1e-5 / atol 1e-6 where the gradient
  is not below 1e-6 of its leaf's largest, as
  ``tests/test_torch_training.py`` holds a step), and the port's
  feature-major path is never entered; the composite GNN obeys it too.
- ``transposed=True`` requires a block operator: on an edge-list batch
  both packages raise the same ``ValueError``; on a plain-BCSR batch both
  packages run the feature-major engine under ``True`` and the row-major
  one under ``False``, each forward matching JAX's.
- ``None`` keeps the automatic choice.
"""

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def case():
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.graph.batch as jbatch
    import gnnkeras_tpu.training.trainer as jtr
    import gnnkeras_tpu_torch.graph.batch as tbatch
    from torch_port_common import flagship_pair, merged_pair, raw_molecules, run_jitted, unique_pairs

    raw = unique_pairs(raw_molecules(n_graphs=8, seed=31))
    jg, tg = merged_pair(raw)
    batches = {}
    for name, kw in (("strip", dict(slot_pack=128, strip_dtype="float32")), ("edge_list", dict(dense_blocks=False)),
                     ("bcsr", dict(dense_blocks=True))):
        batches[name] = (jbatch.from_graph_object(jg, **kw), tbatch.from_graph_object(tg, device="cpu", **kw))
    return dict(jax=jax, jtr=jtr, run_jitted=run_jitted, flagship_pair=flagship_pair, batches=batches)


def _pair(case, transposed):
    jm, tm = case["flagship_pair"](seed=9)
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
        m.transposed = transposed
    return jm, tm


def test_false_forces_the_row_major_engine_forward_and_step(case, monkeypatch):
    from torch_port_common import assert_stats, port_dict

    jm, tm = _pair(case, False)
    jb, tb = case["batches"]["strip"]
    assert jm._use_transposed(jb) is False and tm._use_transposed(tb) is False
    tm.transposed = None
    assert tm._use_transposed(tb) is True  # the automatic choice on a strip batch
    tm.transposed = False

    def refuse(*args, **kwargs):
        raise AssertionError("the feature-major engine ran")

    monkeypatch.setattr(tm, "_unfold_transposed", refuse)
    v, rng = jm.variables, case["jax"].random.PRNGKey(0)
    jk, _, jout, jmask, _ = case["run_jitted"](lambda v, b: jm.forward(v, b, training=False, rng=rng), v, jb)
    k, _, out, mask, _ = tm.forward(tb, training=False)
    assert k == int(jk)
    m = np.asarray(jmask)
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)

    params, mstate = v["params"], v["state"]
    new_params, new_mstate, _, jlogs = case["run_jitted"](
        lambda p, s, o, b, r: case["jtr"]._train_step_body(jm)(p, s, o, b, r),
        params, mstate, jm.optimizer.init(params), jb, rng)
    import gnnkeras_tpu_torch.training.trainer as ttr

    logs, _ = ttr.train_step(tm, tb)
    np.testing.assert_allclose(float(logs["loss_sum"]), float(jlogs["loss_sum"]), rtol=RTOL)
    assert_stats(dict(tm.named_buffers()), new_mstate, RTOL, ATOL)
    want = port_dict(new_params, "params")
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[live], want[name].numpy()[live], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_composite_model_obeys_the_override():
    from gnnkeras_tpu_torch.data.synthetic import starter_clgnn

    gnn = starter_clgnn("cpu", seed=0).gnns[0]
    batch = type("B", (), {"strip": object(), "bcsr": None, "nodes": torch.zeros(1, 14)})()
    assert gnn._use_transposed(batch) is True
    gnn.transposed = False
    assert gnn._use_transposed(batch) is False


def test_true_without_a_block_operator_raises_as_jax(case):
    jm, tm = _pair(case, True)
    jb, tb = case["batches"]["edge_list"]
    with pytest.raises(ValueError) as jerr:
        jm._use_transposed(jb)
    with pytest.raises(ValueError) as terr:
        tm.forward(tb)
    assert str(terr.value) == str(jerr.value)


def test_true_forces_the_feature_major_engine_on_bcsr(case):
    """``False`` and ``True`` on a plain-BCSR batch pick the row-major and
    the feature-major engine in both packages; each forward matches JAX's
    and the two engines agree."""
    jb, tb = case["batches"]["bcsr"]
    outs = {}
    for flag in (False, True):
        jm, tm = _pair(case, flag)
        assert jm._use_transposed(jb) is flag and tm._use_transposed(tb) is flag
        rng = case["jax"].random.PRNGKey(0)
        jk, _, jout, jmask, _ = case["run_jitted"](lambda v, b: jm.forward(v, b, training=False, rng=rng),
                                                   jm.variables, jb)
        k, _, out, _, _ = tm.forward(tb, training=False)
        m = np.asarray(jmask)
        assert k == int(jk)
        np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)
        outs[flag] = out.numpy()[m]
    np.testing.assert_allclose(outs[True], outs[False], rtol=RTOL, atol=ATOL)
