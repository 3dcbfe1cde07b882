"""Loss functions with Keras-compatible semantics, counterpart of
``gnnkeras_tpu.training.losses``: per-row losses (probability
renormalisation and epsilon clipping included) and the masked, sample-
weighted mean the trainer reduces them with.

Clipping is spelled ``minimum(maximum(p, lo), hi)``, as ``jnp.clip`` is, so
the gradient at a clip boundary splits the same way in both packages.  The
bounds are 0-dim tensors filled on the loss's device (``new_full``): no
host-to-device copy, so a loss can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

_EPS = 1e-7  # keras.backend.epsilon()


def _clip(p: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(p, p.new_full((), lo)), p.new_full((), hi))


def categorical_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    p = y_pred / torch.maximum(torch.sum(y_pred, dim=-1, keepdim=True), y_pred.new_full((), _EPS))
    p = _clip(p, _EPS, 1.0 - _EPS)
    return -torch.sum(y_true * torch.log(p), dim=-1)


def categorical_crossentropy_from_logits(y_true: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return -torch.sum(y_true * torch.log_softmax(logits, dim=-1), dim=-1)


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    p = _clip(y_pred, _EPS, 1.0 - _EPS)
    per_elem = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    return torch.mean(per_elem, dim=-1)


def mean_squared_error(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(y_true - y_pred), dim=-1)


def mean_absolute_error(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(y_true - y_pred), dim=-1)


def hinge(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y = 2.0 * y_true - 1.0
    margin = 1.0 - y * y_pred
    return torch.mean(torch.maximum(margin, margin.new_full((), 0.0)), dim=-1)


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits": categorical_crossentropy_from_logits,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "hinge": hinge,
}


def get_loss(spec):
    """Resolve a loss by name or pass a callable ``fn(y, p) -> per-row loss``."""
    if spec is None:
        raise ValueError("a loss must be provided to compile()")
    if callable(spec):
        return spec
    try:
        return _LOSSES[str(spec)]
    except KeyError:
        raise ValueError(f"Unknown loss {spec!r}; known: {sorted(_LOSSES)}")


def masked_mean(per_row: torch.Tensor, mask: torch.Tensor, sample_weight: torch.Tensor) -> torch.Tensor:
    """Keras-style reduction over real rows: Σ(loss·sw·mask)/max(|mask|, 1);
    padded and unsupervised rows contribute nothing."""
    m = mask.to(per_row.dtype)
    count = torch.clamp_min(torch.sum(m), 1.0)
    return torch.sum(per_row * sample_weight * m) / count
