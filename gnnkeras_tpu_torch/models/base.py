"""Model shell shared by the GNN models: holds the nets' parameters and
BatchNorm buffers as an ``nn.Module``, places them on a device, and gives
the reference's Keras-style surface ``compile`` / ``fit`` / ``evaluate`` /
``predict`` over ``gnnkeras_tpu_torch.training``.  ``save``/``load`` come
with a later slice."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnnkeras_tpu_torch.utils.dtypes import resolve_device


class GraphModel(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.built = False
        self.device = None
        self.optimizer = None  # factory: parameters -> torch.optim.Optimizer
        self.loss = None
        self.metrics = ()
        self.average_st_grads = False
        self._opt = None
        self._rng: Optional[torch.Generator] = None

    def init_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def build(self, seed: int = 0, device=None) -> "GraphModel":
        """Initialise the parameters and the model's random stream from
        ``seed`` (once; drawn on the CPU, so the values do not depend on the
        device) and place the model on ``device``: by default where it
        already is, else ``"cuda"`` (raises when no card is present)."""
        dev = resolve_device(device if device is not None else (self.device or "cuda"))
        if not self.built:
            self.init_parameters(torch.Generator().manual_seed(int(seed)))
            self._rng = torch.Generator().manual_seed(int(seed))
            self.built = True
        self.to(dev)
        self.device = dev
        return self

    def next_rng(self) -> torch.Generator:
        """A fresh generator on the model's device, seeded from the model's
        stream (the counterpart of splitting the JAX package's key)."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._rng))
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- compile / fit / evaluate (delegated to the trainer) ------------------
    def compile(self, optimizer=None, loss=None, metrics=None, average_st_grads: bool = False) -> None:
        """Configure for learning.  ``optimizer`` is a name ('adam',
        'adam:0.01', 'sgd', 'sgd:<lr>') or a factory ``params -> optimizer``;
        ``loss`` a name or ``fn(y, p) -> per-row loss``.
        ``average_st_grads`` divides the state net's gradients by the
        iteration count, as the reference does."""
        from gnnkeras_tpu_torch.training import losses as L
        from gnnkeras_tpu_torch.training import optimizers as O

        self.optimizer = O.get_optimizer(optimizer)
        self.loss = L.get_loss(loss)
        self.metrics = tuple(metrics or ())
        self.average_st_grads = bool(average_st_grads)
        self._opt = None

    def fit(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import fit

        return fit(self, *args, **kwargs)

    def evaluate(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import evaluate

        return evaluate(self, *args, **kwargs)

    def predict(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import predict

        return predict(self, *args, **kwargs)
