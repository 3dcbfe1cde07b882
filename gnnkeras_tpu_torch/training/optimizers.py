"""Optimizer resolution with the Keras defaults of the JAX package's optax
transformations (``gnnkeras_tpu.training.optimizers``):

- ``adam``: lr 0.001, b1 0.9, b2 0.999, eps 1e-7 added outside the square
  root of the bias-corrected second moment, which is where optax and
  ``torch.optim.Adam`` both put it;
- ``sgd``: lr 0.01, no momentum (``-lr·g``, as ``optax.sgd``).

``get_optimizer`` returns a factory ``params -> torch.optim.Optimizer``; the
learning rate lives in the optimizer's param groups, where
``current_learning_rate`` / ``set_learning_rate`` read and write it without
touching the moments.  ``rmsprop`` (optax puts its eps inside the root) and
``adamw`` come with a later slice.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

_DEFAULT_LR = {"adam": 0.001, "sgd": 0.01}


def _make(name: str, learning_rate: float, params) -> torch.optim.Optimizer:
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)
    return torch.optim.SGD(params, lr=learning_rate)


def get_optimizer(spec):
    """A factory ``params -> torch.optim.Optimizer`` from a name ('adam',
    'adam:0.01', 'sgd', 'sgd:0.1'; None is 'adam'), or ``spec`` itself when
    it is already such a callable."""
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
    """Write a new learning rate into every param group (the moments are
    kept).  Returns False when the optimizer has no param groups."""
    groups = getattr(optimizer, "param_groups", None)
    if not groups:
        return False
    for group in groups:
        group["lr"] = float(learning_rate)
    return True
