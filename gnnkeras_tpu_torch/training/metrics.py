"""Metrics with Keras-compatible resolution ('accuracy' → categorical
accuracy for one-hot targets), counterpart of
``gnnkeras_tpu.training.metrics``.  Each returns (weighted sum, weight count)
as 0-dim tensors, so the trainer accumulates running means across batches
the way Keras metric objects do."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _weighted(values: torch.Tensor, mask: torch.Tensor, sw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    w = mask.to(values.dtype) * sw
    return torch.sum(values * w), torch.sum(w)


def categorical_accuracy(y, p, mask, sw):
    hit = (torch.argmax(y, dim=-1) == torch.argmax(p, dim=-1)).to(torch.float32)
    return _weighted(hit, mask, sw)


def binary_accuracy(y, p, mask, sw):
    hit = torch.mean(((y > 0.5) == (p > 0.5)).to(torch.float32), dim=-1)
    return _weighted(hit, mask, sw)


def mse_metric(y, p, mask, sw):
    return _weighted(torch.mean(torch.square(y - p), dim=-1), mask, sw)


def mae_metric(y, p, mask, sw):
    return _weighted(torch.mean(torch.abs(y - p), dim=-1), mask, sw)


_METRICS = {
    "accuracy": categorical_accuracy,
    "categorical_accuracy": categorical_accuracy,
    "binary_accuracy": binary_accuracy,
    "mse": mse_metric,
    "mae": mae_metric,
}


def get_metric(spec) -> Tuple[str, Callable]:
    if callable(spec):
        return getattr(spec, "__name__", "metric"), spec
    name = str(spec)
    try:
        return name, _METRICS[name]
    except KeyError:
        raise ValueError(f"Unknown metric {spec!r}; known: {sorted(_METRICS)}")
