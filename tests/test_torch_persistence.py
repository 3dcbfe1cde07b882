"""Model persistence across the two packages: ``save`` / ``Class.load``,
``get_config`` / ``from_config``, ``copy``, ``summary`` and
``count_params``.

Both packages write one folder: ``config.json`` (the model's JSON config)
and ``variables.npz`` (``leaf_{i}`` in JAX's flatten order of the
variables tree).  For a GNN in node (per-iteration BatchNorm), arc and
graph focus, a composite GNN, an LGNN and a CLGNN at dim_state 10:

- a folder saved by the JAX package loads in the port: the state dict bit
  for bit the JAX variables, the forward against JAX's at rtol 1e-5 /
  atol 1e-6 (the forwards' parity tolerance, ``tests/test_torch_gnn.py``);
- a folder saved by the port (other weights) loads in the JAX package: the
  variables bit for bit the port's, the same forward check; both
  packages' ``config.json`` are equal;
- ``count_params`` and the ``summary()`` text equal JAX's;
- ``copy()`` keeps the weights in tensors of its own, ``copy(copy_weights=
  False)`` and ``from_config(get_config())`` build fresh ones.

The MLP: its config through JSON builds the same layer program in the
port, whose forward on JAX's weights matches JAX's; ``count_params`` and
``summary`` as JAX's.  A loaded model is uncompiled, as in the reference.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6

# (name, kind, focus, dim_state, per_iteration_bn)
_CASES = [
    ("gnn_node_per_iteration_bn", "gnn", "n", 0, True),
    ("gnn_arc", "gnn", "a", 0, False),
    ("gnn_graph", "gnn", "g", 0, False),
    ("cgnn_graph", "cgnn", "g", 0, False),
    ("lgnn_graph", "lgnn", "g", 0, False),
    ("clgnn_graph_ds10", "clgnn", "g", 10, False),
]


@pytest.fixture(scope="module")
def setups():
    """``get(case)``: the case's model pair (same weights), batch pair,
    JAX eval forward (compiled once) and the JAX draws of its initial
    states at dim_state 10."""
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.graph.batch as jbatch
    import gnnkeras_tpu_torch.graph.batch as tbatch
    from torch_port_common import (arc_targets, cgnn_pair, compile_jitted, composite_merged_pair, gnn_pair,
                                   jax_lgnn_draws, lgnn_pair, merged_pair, node_targets, raw_molecules, unique_pairs)

    built = {}

    def get(case):
        name, kind, focus, ds, per_iter = case
        if name not in built:
            raw = unique_pairs(raw_molecules(n_graphs=6, seed=21))
            raw = {"n": node_targets, "a": arc_targets}.get(focus, lambda r, seed: r)(raw, seed=21)
            if kind in ("cgnn", "clgnn"):
                jg, tg = composite_merged_pair(raw, focus=focus, n_types=3 if kind == "cgnn" else 1)
            else:
                jg, tg = merged_pair(raw, focus=focus)
            kw = dict(slot_pack=128, strip_dtype="float32")
            jb, tb = jbatch.from_graph_object(jg, **kw), tbatch.from_graph_object(tg, device="cpu", **kw)
            if kind == "gnn":
                jm, tm = gnn_pair(focus, ds, seed=5, per_iteration_bn=per_iter)
            elif kind == "cgnn":
                jm, tm = cgnn_pair(focus, ds, seed=5)
            else:
                jm, tm = lgnn_pair(composite=kind == "clgnn", focus=focus, ds=ds, layers=2, seed=5)
            rng = jax.random.PRNGKey(3)
            forward = compile_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r), jm.variables, jb, rng)
            draws = jax_lgnn_draws(rng, tb.num_nodes, ds, 2) if ds else None
            built[name] = SimpleNamespace(jm=jm, tm=tm, jb=jb, tb=tb, rng=rng, forward=forward, draws=draws,
                                          lgnn=kind in ("lgnn", "clgnn"))
        return built[name]

    return get


def _jax_out(s, variables):
    out = s.forward(variables, s.jb, s.rng)
    return np.asarray(out[2][-1] if s.lgnn else out[2]), np.asarray(out[3])


def _port_out(s, model, monkeypatch):
    from torch_port_common import feed_init_draw

    if s.draws is not None:
        feed_init_draw(monkeypatch, s.draws)
    _, _, out, mask, _ = model.forward(s.tb, training=False, generator=torch.Generator())
    return (out[-1] if s.lgnn else out).numpy(), mask.numpy()


def _assert_forward(s, model, variables, monkeypatch):
    got, got_mask = _port_out(s, model, monkeypatch)
    want, want_mask = _jax_out(s, variables)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got[want_mask], want[want_mask], rtol=RTOL, atol=ATOL)


def _jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_a_jax_folder_loads_in_the_port(case, setups, tmp_path, monkeypatch):
    from gnnkeras_tpu_torch.convert import variables_from_jax

    s = setups(case)
    s.jm.save(str(tmp_path / "jax"))
    loaded = type(s.tm).load(str(tmp_path / "jax"), device="cpu")
    assert loaded.optimizer is None and loaded.loss is None  # uncompiled, as in the reference
    want = variables_from_jax({k: _tree_np(v) for k, v in s.jm.variables.items()})
    got = loaded.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    _assert_forward(s, loaded, s.jm.variables, monkeypatch)


def _tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_a_port_folder_loads_in_jax(case, setups, tmp_path, monkeypatch):
    from gnnkeras_tpu_torch.convert import variables_to_jax

    s = setups(case)
    other = s.tm.copy()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in other.parameters():  # other weights than the JAX model's
            p.mul_(1.0 + 0.05 * torch.randn(p.shape, generator=gen))
    other.save(str(tmp_path / "port"))
    s.jm.save(str(tmp_path / "jax"))
    configs = [json.load(open(os.path.join(tmp_path, d, "config.json"))) for d in ("port", "jax")]
    assert configs[0] == configs[1]
    loaded = type(s.jm).load(str(tmp_path / "port"))
    for got, want in zip(_jax_leaves(loaded.variables), _jax_leaves(variables_to_jax(other)), strict=True):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    _assert_forward(s, other, loaded.variables, monkeypatch)


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_count_params_and_summary_equal_jax(case, setups, capsys):
    s = setups(case)
    assert s.tm.count_params() == s.jm.count_params()
    capsys.readouterr()
    s.jm.summary()
    want = capsys.readouterr().out
    s.tm.summary()
    assert capsys.readouterr().out == want and want.count("MLP") >= 2


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_copy_and_from_config(case, setups):
    s = setups(case)
    tm = s.tm
    clone = tm.copy()
    for (name, a), b in zip(tm.state_dict().items(), clone.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    fresh = tm.copy(copy_weights=False)
    assert not fresh.built
    fresh.build(seed=1, device="cpu")
    rebuilt = type(tm).from_config(tm.get_config()).build(seed=1, device="cpu")
    own = {p.data_ptr() for p in tm.parameters()}
    assert not own & {p.data_ptr() for p in rebuilt.parameters()}
    for (name, a), b, c in zip(tm.named_parameters(), fresh.parameters(), rebuilt.parameters()):
        assert a.shape == b.shape == c.shape and torch.equal(b, c), name
    assert any(not torch.equal(a, b) for a, b in zip(tm.parameters(), fresh.parameters()))
    assert repr(fresh) == repr(tm)


def test_mlp_config_count_summary_and_forward_match_jax(capsys):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import gnnkeras_tpu.models.mlp as jmlp
    import gnnkeras_tpu_torch.models.mlp as tmlp
    from gnnkeras_tpu_torch.convert import _mlp_from_jax

    jm = jmlp.MLP(input_dim=(9,), layers=[12, 4], activations=["selu", "softmax"], kernel_initializer="lecun_normal",
                  bias_initializer="zeros", kernel_regularizer="l2", dropout_rate=0.2, dropout_pos=1,
                  name="state")
    config = json.loads(json.dumps(jm.get_config()))
    tm = tmlp.MLP.from_config(config)
    assert json.loads(json.dumps(tm.get_config())) == config
    assert tm.program == jm.program
    variables = jm.init(jax.random.PRNGKey(0))
    weights = {}
    _mlp_from_jax("", _tree_np(variables["params"]), weights)
    _mlp_from_jax("", _tree_np(variables["state"]), weights)
    tm.load_state_dict({k[1:]: v for k, v in weights.items()})
    assert tm.count_params() == jm.count_params(variables)
    capsys.readouterr()
    jm.summary(variables)
    want = capsys.readouterr().out
    assert tm.summary(with_count=True) + "\n" == want
    assert capsys.readouterr().out == want
    x = np.random.default_rng(0).normal(size=(5, 9)).astype(np.float32)
    got = tm.apply(torch.from_numpy(x)).detach().numpy()
    want, _ = jm.apply(variables, jnp.asarray(x))  # (output, moving statistics)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
