"""The port's MLP (eval mode) and the fused route's weight folding against
the JAX package, with copied weights and non-trivial BatchNorm statistics.

Both are f32 with the same operation order; matmul summation order may
differ between the two BLAS libraries, hence rtol 1e-6 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu_torch.models.mlp as tmlp
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import flagship_pair, perturb_bn

RTOL, ATOL = 1e-6, 1e-6


def _pair(activations, layers, seed):
    kw = dict(input_dim=(31,), layers=layers, activations=activations,
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              dropout_rate=0.2, dropout_pos=1)
    jnet, tnet = jmlp.MLP(**kw), tmlp.MLP(**kw)
    v = jnet.init(jax.random.PRNGKey(seed))
    tree = perturb_bn({"params": {"net_state": v["params"]}, "state": {"net_state": v["state"]}}, seed)
    sd = variables_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    tnet.load_state_dict({k[len("net_state."):]: t for k, t in sd.items()})
    return jnet, {"params": tree["params"]["net_state"], "state": tree["state"]["net_state"]}, tnet


@pytest.mark.parametrize("activations,layers", [("selu", [14]), (["relu", "softmax"], [20, 2]),
                                                 (["tanh", "sigmoid"], [9, 4])])
def test_apply_and_apply_t_match_jax(activations, layers):
    jnet, v, tnet = _pair(activations, layers, seed=len(layers))
    x = np.random.default_rng(0).normal(size=(50, 31)).astype(np.float32)
    want, _ = jnet.apply(v, jnp.asarray(x), training=False)
    got = tnet.apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_t, _ = jnet.apply_t(v, jnp.asarray(x.T), training=False)
    got_t = tnet.apply_t(torch.from_numpy(np.ascontiguousarray(x.T)))
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)


def test_fold_transition_matches_jax():
    jm, tm = flagship_pair(seed=4)
    want = jm.fold_transition(jm.variables)
    got = tm.fold_transition()
    assert got[4] == want[4] == "selu"
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_get_inout_dims_matches_jax():
    for args in [("state", 14, 3, 2, "g", 0), ("output", 14, 3, 2, "g", 0), ("state", [3, 4], 2, 5, "n", 7)]:
        for layer, gs, go in [(0, False, False), (2, True, True)]:
            kw = dict(layer=layer, get_state=gs, get_output=go)
            j = jmlp.get_inout_dims(*args, hidden_units=[8], **kw)
            t = tmlp.get_inout_dims(*args, hidden_units=[8], **kw)
            assert [list(map(int, x)) for x in t[0]] == [list(map(int, x)) for x in j[0]]
            assert [np.ravel(u).tolist() for u in t[1]] == [np.ravel(u).tolist() for u in j[1]]


def test_initialisers_draw_from_generator():
    """Same seed → same weights; the variance-scaling std is right."""
    net = lambda: tmlp.MLP((400,), [300], "linear", "glorot_normal", "zeros", batch_normalization=False)
    a, b = net(), net()
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.layers[0].kernel, b.layers[0].kernel, rtol=0, atol=0)
    std = float(a.layers[0].kernel.detach().std())
    assert abs(std - np.sqrt(1.0 / 350.0)) < 0.02 * np.sqrt(1.0 / 350.0)
    # no BatchNorm and no dropout: training mode computes what eval mode does
    x = torch.randn(2, 400, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a.apply(x, training=True), a.apply(x), rtol=0, atol=0)
