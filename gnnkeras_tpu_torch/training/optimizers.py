"""Optimizer resolution with the Keras defaults of the JAX package's optax
transformations (``gnnkeras_tpu.training.optimizers``), in optax's
arithmetic:

- ``adam``: lr 0.001, b1 0.9, b2 0.999, eps 1e-7 added outside the square
  root of the bias-corrected second moment;
- ``sgd``: lr 0.01, no momentum (``-lr·g``, as ``optax.sgd``);
- ``rmsprop``: lr 0.001, decay 0.9, eps 1e-7 added *inside* the root
  (``g·rsqrt(ν + eps)``, optax's ``eps_in_sqrt=True``; ``torch.optim.RMSprop``
  adds it outside), ν starting at 0, no bias correction;
- ``adamw``: ``adam`` plus decoupled weight decay 0.004 on every leaf
  (``optax.adamw``: the decay joins the update before the learning rate).

Every optimizer here is safe to capture in a CUDA graph
(``trainer.fit(scan_batches=...)`` on the card): its state (moments and a
step count, an f32 0-dim tensor) exists from construction, the learning
rate is a 0-dim f32 tensor on the parameters' device, and ``step`` reads
nothing on the host.  The same code runs on the CPU, so the per-step and
the scanned fit do the same arithmetic on either device.

``get_optimizer`` returns a factory ``params -> torch.optim.Optimizer``;
``current_learning_rate`` reads the rate and ``set_learning_rate`` writes
it into that tensor in place (the moments are kept, and a captured epoch
replays the new rate).  ``load_state_dict`` copies a saved state into the
live tensors, so a restore keeps the addresses a captured graph reads.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

_DEFAULT_LR = {"adam": 0.001, "sgd": 0.01, "rmsprop": 0.001, "adamw": 0.001}
_B1, _B2, _EPS = 0.9, 0.999, 1e-7
_RMS_DECAY = 0.9
_WEIGHT_DECAY = 0.004


class GraphSafeOptimizer(torch.optim.Optimizer):
    """Base of the port's optimizers: ``_moments`` names the per-parameter
    state tensors (zeros like the parameter), ``_update(p, g, state, group)``
    returns the update that ``step`` adds to ``p`` (learning rate
    included)."""

    _moments: tuple = ()
    _counted = False

    def __init__(self, params, lr: float, **hyper):
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        super().__init__(params, dict(lr=torch.tensor(float(lr), dtype=torch.float32, device=device), **hyper))
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                for name in self._moments:
                    state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if self._counted:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the port's optimizers take no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if self._counted:
                    state["step"].add_(1.0)
                p.add_(self._update(p, p.grad, state, group))
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """Copy a saved state (``state_dict()`` of an optimizer of this kind
        over the same parameters) into the live tensors."""
        params = [p for group in self.param_groups for p in group["params"]]
        saved, groups = state_dict["state"], state_dict["param_groups"]
        if len(groups) != len(self.param_groups) or sum(len(g["params"]) for g in groups) != len(params):
            raise ValueError("the saved optimizer state holds other parameter groups")
        with torch.no_grad():
            for index, p in enumerate(params):
                for name, value in saved.get(index, {}).items():
                    self.state[p][name].copy_(value)
            for group, saved_group in zip(self.param_groups, groups):
                for key, value in saved_group.items():
                    if key == "params":
                        continue
                    if isinstance(group.get(key), torch.Tensor):
                        group[key].copy_(torch.as_tensor(value))
                    else:
                        group[key] = value


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float) -> torch.Tensor:
    # optax's update_moment: (1 − decay)·g + decay·t
    return (1.0 - decay) * g + decay * t


class Adam(GraphSafeOptimizer):
    """optax's ``adam`` (``scale_by_adam`` then ``-lr``), and with
    ``weight_decay`` > 0 its ``adamw``."""

    _moments = ("mu", "nu")
    _counted = True

    def __init__(self, params, lr: float = 0.001, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay=float(weight_decay))

    def _update(self, p, g, state, group):
        mu = _moment(g, state["mu"], _B1)
        nu = _moment(g * g, state["nu"], _B2)
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        t = state["step"]
        mu_hat = mu / (1.0 - torch.pow(_B1, t))
        nu_hat = nu / (1.0 - torch.pow(_B2, t))
        u = mu_hat / (torch.sqrt(nu_hat) + _EPS)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return -group["lr"] * u


class SGD(GraphSafeOptimizer):
    """optax's ``sgd`` without momentum."""

    def _update(self, p, g, state, group):
        return -group["lr"] * g


class RMSprop(GraphSafeOptimizer):
    """optax's ``rmsprop`` (``scale_by_rms(eps_in_sqrt=True)`` then
    ``-lr``)."""

    _moments = ("nu",)

    def _update(self, p, g, state, group):
        nu = _moment(g * g, state["nu"], _RMS_DECAY)
        state["nu"].copy_(nu)
        return -group["lr"] * (torch.rsqrt(nu + _EPS) * g)


def _make(name: str, learning_rate: float, params) -> torch.optim.Optimizer:
    if name == "adam":
        return Adam(params, learning_rate)
    if name == "adamw":
        return Adam(params, learning_rate, weight_decay=_WEIGHT_DECAY)
    if name == "rmsprop":
        return RMSprop(params, learning_rate)
    return SGD(params, learning_rate)


def get_optimizer(spec):
    """A factory ``params -> torch.optim.Optimizer`` from a name ('adam',
    'adam:0.01', 'sgd', 'sgd:0.1', 'rmsprop', 'adamw', each with an optional
    ':lr'; None is 'adam'), or ``spec`` itself when it is already such a
    callable."""
    if spec is None:
        spec = "adam"
    if not isinstance(spec, str):
        return spec
    name, _, lr = spec.partition(":")
    if name not in _DEFAULT_LR:
        raise ValueError(f"Unknown optimizer {name!r}; the port has {sorted(_DEFAULT_LR)}")
    return functools.partial(_make, name, float(lr) if lr else _DEFAULT_LR[name])


def current_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    """The learning rate of the first param group."""
    groups = getattr(optimizer, "param_groups", None)
    return float(groups[0]["lr"]) if groups else None


def set_learning_rate(optimizer: torch.optim.Optimizer, learning_rate: float) -> bool:
    """Write a new learning rate into every param group, into the rate's
    tensor in place where it is one (the moments are kept).  Returns False
    when the optimizer has no param groups."""
    groups = getattr(optimizer, "param_groups", None)
    if not groups:
        return False
    for group in groups:
        if isinstance(group["lr"], torch.Tensor):
            with torch.no_grad():
                group["lr"].fill_(float(learning_rate))
        else:
            group["lr"] = float(learning_rate)
    return True
