"""The port's MLP in training mode against the JAX package: masked
BatchNorm (both layouts), dropout and AlphaDropout, and the regularisation
loss.

BatchNorm's masked moments are f32 reductions in another order than JAX's:
rtol 1e-5 / atol 1e-6 on outputs and moving statistics.  Dropout is
checked at the keep mask the port drew, against a NumPy transcription of
the JAX package's formula (``mlp.py:225-233``), f32 both: rtol 1e-6 /
atol 1e-6.  The penalties are sums of |p| and p² over the same f32 values:
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu_torch.models.mlp as tmlp
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import perturb_bn

RTOL, ATOL = 1e-5, 1e-6


def _pair(seed, **kw):
    """The same MLP in both packages with the JAX weights (and non-trivial
    BatchNorm statistics) copied into the port."""
    jnet, tnet = jmlp.MLP(**kw), tmlp.MLP(**kw)
    v = jnet.init(jax.random.PRNGKey(seed))
    tree = perturb_bn({"params": {"net": v["params"]}, "state": {"net": v["state"]}}, seed)
    sd = variables_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    tnet.load_state_dict({k[len("net."):]: t for k, t in sd.items()})
    return jnet, {"params": tree["params"]["net"], "state": tree["state"]["net"]}, tnet


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("layout", ["rows", "feature_major"])
def test_batch_norm_training_matches_jax(layout, masked):
    jnet, v, tnet = _pair(3, input_dim=(9,), layers=[5], activations="selu",
                          kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, size=(40, 9)).astype(np.float32)
    mask = rng.random(40) < 0.7 if masked else None
    fm = layout == "feature_major"
    xin = np.ascontiguousarray(x.T) if fm else x
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    # the BatchNorm layer alone
    bn_apply = jmlp._batch_norm_apply_t if fm else jmlp._batch_norm_apply
    want_bn, want_stats = bn_apply(v["params"][0], v["state"][0], jnp.asarray(xin), True, jmask)
    mean, var = tmlp._masked_moments(torch.from_numpy(xin), tmask, fm)
    got_bn = tnet.layers[0].normalize(torch.from_numpy(xin), mean, var, fm)
    np.testing.assert_allclose(got_bn.detach().numpy(), np.asarray(want_bn), rtol=RTOL, atol=ATOL)

    # the whole MLP: output and the new moving statistics
    japply = jnet.apply_t if fm else jnet.apply
    want, want_state = japply(v, jnp.asarray(xin), training=True, mask=jmask)
    got, stats = tnet.run(torch.from_numpy(xin), feature_major=fm, training=True, mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for key in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(stats[f"layers.0.{key}"].numpy(), np.asarray(want_state[0][key]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(stats[f"layers.0.{key}"].numpy(), np.asarray(want_stats[key]),
                                   rtol=RTOL, atol=ATOL)
    # run() returns the statistics; the buffers keep theirs
    np.testing.assert_array_equal(tnet.layers[0].moving_mean.numpy(), np.asarray(v["state"][0]["moving_mean"]))


def test_batch_norm_count_floor():
    """An all-False mask: count = max(0, 1), so the moments are 0, not NaN."""
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    mean, var = tmlp._masked_moments(x, torch.zeros(6, dtype=torch.bool), False)
    want_mean, want_var = jmlp._masked_moments(jnp.asarray(x.numpy()), jnp.zeros(6, bool))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want_mean))
    np.testing.assert_array_equal(var.numpy(), np.asarray(want_var))


def _numpy_dropout(x, keep, rate, alpha):
    """``gnnkeras_tpu/models/mlp.py:225-233`` in NumPy, at a given keep mask."""
    if alpha:
        p = jmlp._ALPHA_P
        a = ((1.0 - rate) * (1.0 + rate * p**2)) ** -0.5
        b = -a * p * rate
        return a * (x * keep + p * (1.0 - keep)) + b
    return x * keep / (1.0 - rate)


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("layout", ["rows", "feature_major"])
def test_dropout_matches_numpy_at_fixed_keep_mask(layout, alpha):
    rate = 0.3
    net = tmlp.MLP((7,), [6, 4], "linear", "glorot_uniform", "glorot_uniform", dropout_rate=rate,
                   dropout_pos=1, alphadropout=alpha, batch_normalization=False)
    net.reset_parameters(torch.Generator().manual_seed(2))
    fm = layout == "feature_major"
    x = np.random.default_rng(3).normal(size=(25, 7)).astype(np.float32)
    xin = torch.from_numpy(np.ascontiguousarray(x.T) if fm else x)
    got = net.apply_t(xin, training=True, generator=torch.Generator().manual_seed(5)) if fm else \
        net.apply(xin, training=True, generator=torch.Generator().manual_seed(5))

    w1, b1 = net.layers[0].kernel.detach().numpy(), net.layers[0].bias.detach().numpy()
    w2, b2 = net.layers[2].kernel.detach().numpy(), net.layers[2].bias.detach().numpy()
    h = x @ w1 + b1
    hin = np.ascontiguousarray(h.T) if fm else h
    keep = tmlp._dropout_keep(torch.from_numpy(hin), rate, torch.Generator().manual_seed(5)).numpy()
    assert 0.5 < keep.mean() < 0.9
    d = _numpy_dropout(hin, keep, rate, alpha).astype(np.float32)
    want = (d.T if fm else d) @ w2 + b2
    np.testing.assert_allclose(got.detach().numpy(), want.T if fm else want, rtol=1e-6, atol=1e-6)
    # no generator, or eval mode: the identity
    same = net.apply(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(same.detach().numpy(), h @ w2 + b2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", ["l1", "l2", ("l1_l2", 0.003, 0.02)])
def test_regularization_loss_matches_jax(spec):
    jnet, v, tnet = _pair(4, input_dim=(11,), layers=[8, 3], activations=["relu", "softmax"],
                          kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                          kernel_regularizer=[spec, spec], bias_regularizer=[spec, spec])
    want = float(jnet.regularization_loss(v))
    got = tnet.regularization_loss()
    assert want > 0.0
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    # differentiable in the parameters
    got.backward()
    assert tnet.layers[1].kernel.grad is not None and float(tnet.layers[1].kernel.grad.abs().sum()) > 0


def test_no_regularizer_is_zero():
    net = tmlp.MLP((4,), [2], "linear")
    assert float(net.regularization_loss()) == 0.0
    with pytest.raises(ValueError):
        tmlp.get_regularizer("l3")
