"""The port's ``rmsprop`` and ``adamw`` (and ``adam`` / ``sgd``, now the
port's own capture-safe optimizers) against optax on fixed gradients.

Each optimizer takes 5 steps on gradients whose magnitudes span 1e-9 to 1
(eps 1e-7 decides the smallest entries' steps), then the learning rate is
changed mid-run through ``set_learning_rate`` (the JAX package writes its
``inject_hyperparams`` state; the port writes its 0-dim rate tensor in
place) and 2 more steps follow.  Parameters at rtol 1e-6 / atol 2e-7
after every step, the tolerance ``tests/test_torch_training.py`` holds
Adam and SGD to: both packages do the same f32 operations in the same
order, but optax's bias corrections 1 − bᵗ come from XLA's ``pow`` and the
port's from PyTorch's.  The optimizer's state (moments, step count, rate)
survives ``state_dict`` / ``load_state_dict`` into the live tensors.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import gnnkeras_tpu_torch.training.optimizers as topt

RTOL, ATOL = 1e-6, 2e-7
_NAMES = ["rmsprop", "adamw", "rmsprop:0.01", "adamw:0.02", "adam:0.01", "sgd:0.1"]


@pytest.fixture(scope="module")
def jopt():
    pytest.importorskip("jax")
    import gnnkeras_tpu.training.optimizers as jopt

    return jopt


def _draws(seed, shape=(7, 5), steps=7):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=shape).astype(np.float32)
    grads = [(rng.normal(size=shape) * 10.0 ** rng.uniform(-9, 0, shape)).astype(np.float32) for _ in range(steps)]
    return p0, grads


@pytest.mark.parametrize("name", _NAMES)
def test_steps_and_a_rate_change_match_optax(jopt, name):
    import jax.numpy as jnp
    import optax

    p0, grads = _draws(8)
    j = jopt.get_optimizer(name)
    params = jnp.asarray(p0)
    state = j.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = topt.get_optimizer(name)([p])
    for step, g in enumerate(grads):
        if step == 5:
            assert jopt.set_learning_rate(state, 0.003) and topt.set_learning_rate(opt, 0.003)
            assert topt.current_learning_rate(opt) == pytest.approx(jopt.current_learning_rate(state))
        updates, state = j.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} step {step}")


def test_rmsprop_puts_eps_inside_the_root():
    """One rmsprop step from ν = 0: ν = 0.1·g², the update
    −lr·g·rsqrt(0.1·g² + 1e-7); ``torch.optim.RMSprop`` (eps outside the
    root) moves a small entry by another amount."""
    g = torch.tensor([1e-4, 1.0])
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = g.clone()
    topt.get_optimizer("rmsprop:0.01")([p]).step()
    want = -0.01 * g * torch.rsqrt(0.1 * g * g + 1e-7)
    assert torch.equal(p.detach(), want)
    q = torch.nn.Parameter(torch.zeros(2))
    q.grad = g.clone()
    torch.optim.RMSprop([q], lr=0.01, alpha=0.9, eps=1e-7).step()
    assert abs(float(q[0].detach()) - float(p[0].detach())) > 1e-4


def test_adamw_decays_every_leaf():
    """With a zero gradient the Adam part is 0 and the step is −lr·0.004·p
    (optax: the decay joins the update before the learning rate)."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    p.grad = torch.zeros(2)
    topt.get_optimizer("adamw:0.5")([p]).step()
    want = torch.tensor([1.0, -2.0]) + (-torch.tensor(0.5)) * (0.004 * torch.tensor([1.0, -2.0]))
    assert torch.equal(p.detach(), want)


@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop", "sgd"])
def test_state_round_trips_into_the_live_tensors(name):
    p0, grads = _draws(9, steps=4)
    runs = []
    for restore in (False, True):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = topt.get_optimizer(name)([p])
        live = [t for s in opt.state.values() for t in s.values()] + [opt.param_groups[0]["lr"]]
        addresses = [t.data_ptr() for t in live]
        for i, g in enumerate(grads):
            if restore and i == 2:
                # a copy, as a checkpoint file holds it (state_dict() hands out the live tensors)
                saved = pytree.tree_map_only(torch.Tensor, torch.clone, opt.state_dict())
                topt.set_learning_rate(opt, 1.0)
                for s in opt.state.values():
                    for t in s.values():
                        t.fill_(7.0)
                opt.load_state_dict(saved)
                assert [t.data_ptr() for t in live] == addresses
            p.grad = torch.from_numpy(g)
            opt.step()
        runs.append(p.detach().clone())
    assert torch.equal(runs[0], runs[1])


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="rmsprop"):
        topt.get_optimizer("lamb")
