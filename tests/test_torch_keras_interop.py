"""The port's import of reference-format Keras models
(``gnnkeras_tpu_torch.utils.keras_interop``) against the JAX package's.

The reference framework itself is absent, so the test builds its MLPs with
``tf.keras`` layers (a leading BatchNorm with non-trivial statistics, then
biased Dense layers: the reference MLP's layout) and saves them as
``.keras`` archives in the reference's folder layout: a GNN
(``net_state`` / ``net_output`` + ``config.json``), a composite GNN (one
``net_state_{i}`` a node type) and an LGNN (``GNN{i}/`` folders).  Both
packages import each folder: the same classes, the same weights bit for
bit, and the same eval forward at rtol 1e-5 / atol 1e-6 (f32 in both, only
the sum order differs).  TensorFlow is imported by this test and inside
the loaders only.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.utils.keras_interop as jki
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.utils.keras_interop as tki
from gnnkeras_tpu_torch.convert import variables_to_jax
from torch_port_common import (composite_merged_pair, feed_init_draw, jax_init_draw, jax_lgnn_draws, merged_pair,
                               raw_molecules, run_jitted, unique_pairs)

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _keras_mlp(tf, rng, inp, units, acts, bn=True):
    layers = [tf.keras.Input((inp,))] + ([tf.keras.layers.BatchNormalization()] if bn else [])
    m = tf.keras.Sequential(layers + [tf.keras.layers.Dense(u, activation=a) for u, a in zip(units, acts)])
    weights = [w + rng.normal(size=w.shape).astype(np.float32) * 0.2 for w in m.get_weights()]
    if bn:  # moving variance stays positive
        weights[3] = np.abs(weights[3]) + 0.5
    m.set_weights(weights)
    return m


def _gnn_folder(tf, rng, path, state_in, ds=0, composite_types=0, out_in=None):
    os.makedirs(path, exist_ok=True)
    width = ds or 14
    if composite_types:
        for t in range(composite_types):
            _keras_mlp(tf, rng, state_in, [width], ["selu"]).save(os.path.join(path, f"net_state_{t}.keras"))
    else:
        _keras_mlp(tf, rng, state_in, [width], ["selu"]).save(os.path.join(path, "net_state.keras"))
    _keras_mlp(tf, rng, out_in or width, [2], ["softmax"]).save(os.path.join(path, "net_output.keras"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"state_vect_dim": ds, "max_iteration": 5, "state_threshold": 0.0}, f)
    return path


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("keras")
    out = {
        # graph focus, dim_state 0: Dense(31 → 14) state, Dense(14 → 2) output
        "gnn": _gnn_folder(tf, rng, str(root / "gnn"), 31),
        # 1-type composite at dim_state 10: [label 14 | state 10 | Σstate 10 | Σlabel 14 | Σarc 3]
        "composite": _gnn_folder(tf, rng, str(root / "composite"), 51, ds=10, composite_types=1),
    }
    lgnn = root / "lgnn"
    # dim_state 10 (get_inout_dims): state nets over [label | state | Σstate | Σlabel | Σarc], 51 wide at layer
    # 0 and 75 at layer 1 (the label widened by layer 0's state and output); output nets over [label | state]
    _gnn_folder(tf, rng, str(lgnn / "GNN0"), 51, ds=10, out_in=24)
    _gnn_folder(tf, rng, str(lgnn / "GNN1"), 75, ds=10, out_in=36)
    with open(lgnn / "config.json", "w") as f:
        json.dump({"get_state": True, "get_output": True, "gnn_class": "graph"}, f)
    out["lgnn"] = str(lgnn)
    bad = root / "mid_bn.keras"
    tf.keras.Sequential([tf.keras.Input((4,)), tf.keras.layers.Dense(3), tf.keras.layers.BatchNormalization(),
                         tf.keras.layers.Dense(2)]).save(str(bad))
    out["mid_bn"] = str(bad)
    nobias = root / "nobias.keras"
    tf.keras.Sequential([tf.keras.Input((4,)), tf.keras.layers.Dense(3, use_bias=False)]).save(str(nobias))
    out["nobias"] = str(nobias)
    return out


def _same_variables(tm, jm):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jm.variables))
    got = jax.tree_util.tree_leaves(variables_to_jax(tm))
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def _forward_matches(tm, jm, tb, jb, rng):
    jout = run_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r)[2:4], jm.variables, jb, rng)
    _, _, out, mask, _ = tm.forward(tb, training=False, generator=torch.Generator().manual_seed(0))
    jo = jout[0][-1] if isinstance(jout[0], (list, tuple)) else jout[0]
    m = np.asarray(jout[1])
    np.testing.assert_array_equal(mask.numpy(), m)
    np.testing.assert_allclose(tm.served_output(out).numpy()[m], np.asarray(jo)[m], rtol=RTOL, atol=ATOL)


_RAW = unique_pairs(raw_molecules(n_graphs=10, seed=2))


def test_gnn(folders):
    tm = tki.load_reference_gnn(folders["gnn"], focus="g", device="cpu")
    jm = jki.load_reference_gnn(folders["gnn"], focus="g")
    assert type(tm).__name__ == type(jm).__name__ == "GNNgraphBased" and tm.device.type == "cpu"
    _same_variables(tm, jm)
    jg, tg = merged_pair(_RAW)
    _forward_matches(tm, jm, tbatch.from_graph_object(tg, slot_pack=128, device="cpu"),
                     jbatch.from_graph_object(jg, slot_pack=128), jax.random.PRNGKey(0))


def test_composite(folders, monkeypatch):
    tm = tki.load_reference_composite(folders["composite"], focus="g", device="cpu")
    jm = jki.load_reference_composite(folders["composite"], focus="g")
    assert type(tm).__name__ == type(jm).__name__ == "CompositeGNNgraphBased"
    _same_variables(tm, jm)
    jg, tg = composite_merged_pair(_RAW, n_types=1)
    tb, jb = tbatch.from_graph_object(tg, slot_pack=128, device="cpu"), jbatch.from_graph_object(jg, slot_pack=128)
    rng = jax.random.PRNGKey(1)
    feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, 10))
    _forward_matches(tm, jm, tb, jb, rng)


def test_lgnn(folders, monkeypatch):
    tm = tki.load_reference_lgnn(folders["lgnn"], device="cpu")
    jm = jki.load_reference_lgnn(folders["lgnn"])
    assert type(tm).__name__ == type(jm).__name__ == "LGNN" and tm.LAYERS == 2
    _same_variables(tm, jm)
    jg, tg = merged_pair(_RAW)
    tb, jb = tbatch.from_graph_object(tg, slot_pack=128, device="cpu"), jbatch.from_graph_object(jg, slot_pack=128)
    rng = jax.random.PRNGKey(2)
    feed_init_draw(monkeypatch, jax_lgnn_draws(rng, tb.num_nodes, 10, 2))
    _forward_matches(tm, jm, tb, jb, rng)


def test_mlp_spec_and_refusals(folders):
    import tensorflow as tf

    k = tf.keras.models.load_model(os.path.join(folders["gnn"], "net_state.keras"), compile=False)
    spec_t, spec_j = tki.mlp_spec_from_keras(k), jki.mlp_spec_from_keras(k)
    assert spec_t.get_config()["layers"] == [14] and spec_t.program == spec_j.program
    wt, wj = tki.weights_from_keras(k, spec_t), jki.weights_from_keras(k, spec_j)
    for section in ("params", "state"):
        for a, b in zip(wt[section], wj[section]):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    for name in ("mid_bn", "nobias"):
        bad = tf.keras.models.load_model(folders[name], compile=False)
        with pytest.raises(ValueError):
            tki.mlp_spec_from_keras(bad)
        with pytest.raises(ValueError):
            jki.mlp_spec_from_keras(bad)
    with pytest.raises(FileNotFoundError):
        tki.load_reference_gnn(os.path.dirname(folders["mid_bn"]) + "/absent", device="cpu")
