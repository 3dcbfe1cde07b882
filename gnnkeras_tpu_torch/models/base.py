"""Model shell shared by the GNN models: holds the nets' parameters and
BatchNorm buffers as an ``nn.Module``, places them on a device, and gives
the reference's Keras-style surface ``compile`` / ``fit`` / ``evaluate`` /
``predict`` over ``gnnkeras_tpu_torch.training``, and ``save`` / ``load``
/ ``count_params``.

``save(path)`` writes the JAX package's folder: ``config.json`` (the
model's ``_json_config``) and ``variables.npz`` with one array
``leaf_{i}`` per leaf of the JAX variables tree (``convert.variables_to_jax``)
in JAX's flatten order (dict keys sorted, lists in order).  So a folder
saved by either package loads in the other; a loaded model is uncompiled,
as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
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
        self.training_mode: Optional[str] = None  # an LGNN's ('parallel', 'residual', 'serial')
        self._opt = None
        self._rng: Optional[torch.Generator] = None
        self._scan: dict = {}  # the trainer's scanned epochs (training/trainer.py)

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

    def served_output(self, out):
        """The output of ``forward`` that predictions read (an LGNN's is its
        last layer's)."""
        return out

    def next_seed(self, stream: Optional[torch.Generator] = None) -> int:
        """The next seed of the model's stream (or of ``stream``)."""
        return int(torch.randint(0, 2**62, (1,), generator=self._rng if stream is None else stream))

    def device_generator(self, seed: int) -> torch.Generator:
        """A fresh generator on the model's device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def next_rng(self) -> torch.Generator:
        """A fresh generator on the model's device, seeded from the model's
        stream (the counterpart of splitting the JAX package's key)."""
        return self.device_generator(self.next_seed())

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
        self._scan = {}

    def fit(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import fit

        return fit(self, *args, **kwargs)

    def evaluate(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import evaluate

        return evaluate(self, *args, **kwargs)

    def predict(self, *args, **kwargs):
        from gnnkeras_tpu_torch.training.trainer import predict

        return predict(self, *args, **kwargs)

    # -- persistence ---------------------------------------------------------------
    def _json_config(self) -> dict:
        raise NotImplementedError

    @classmethod
    def _from_json(cls, config: dict) -> "GraphModel":
        raise NotImplementedError

    def save(self, path: str) -> None:
        """Write ``config.json`` and ``variables.npz`` into the folder
        ``path`` (module docstring)."""
        from gnnkeras_tpu_torch.convert import variables_to_jax

        if not self.built:
            self.build(device=self.device or "cpu")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self._json_config(), f)
        leaves = _jax_leaves(variables_to_jax(self))
        np.savez(os.path.join(path, "variables.npz"), **{f"leaf_{i}": x for i, x in enumerate(leaves)})

    @classmethod
    def load(cls, path: str, device="cuda") -> "GraphModel":
        """A model from a folder written by ``save`` (either package's),
        built on ``device`` and uncompiled."""
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        config.pop("model_class", None)
        model = cls._from_json(config)
        model._load_variables(path, device)
        return model

    def _load_variables(self, path: str, device) -> None:
        from gnnkeras_tpu_torch.convert import variables_from_jax, variables_to_jax

        self.build(device=device)
        template = variables_to_jax(self)
        want = _jax_leaves(template)
        with np.load(os.path.join(path, "variables.npz")) as archive:
            if len(archive.files) != len(want):
                raise ValueError(f"{path}: {len(archive.files)} arrays for a model of {len(want)} leaves")
            got = [np.asarray(archive[f"leaf_{i}"], dtype=np.float32) for i in range(len(want))]
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape:
                raise ValueError(f"{path}: leaf_{i} has shape {g.shape}, the model's {w.shape}")
        self.load_state_dict(variables_from_jax(_jax_unflatten(template, iter(got))))

    def _copy_weights_into(self, clone: "GraphModel", copy_weights: bool) -> "GraphModel":
        if copy_weights and self.built:
            clone.build(device=self.device)
            clone.load_state_dict(self.state_dict())
        return clone

    def count_params(self) -> int:
        """Every parameter and moving statistic, as the JAX package counts
        its variables."""
        return sum(t.numel() for t in (*self.parameters(), *self.buffers()))


def _jax_leaves(tree) -> list:
    """The leaves of a variables tree in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _jax_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _jax_leaves(item)]
    return [tree]


def _jax_unflatten(template, leaves):
    """``template``'s tree with its leaves taken in JAX's order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        filled = {key: _jax_unflatten(template[key], leaves) for key in sorted(template)}
        return {key: filled[key] for key in template}
    if isinstance(template, (list, tuple)):
        return [_jax_unflatten(item, leaves) for item in template]
    return next(leaves)
