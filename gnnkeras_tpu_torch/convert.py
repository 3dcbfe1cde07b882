"""Parameters from and to the JAX package's model variables.

``variables_from_jax(tree)`` takes a model's ``variables`` as nested dicts
and lists of NumPy arrays and returns the port's state dict, so
``model.load_state_dict(...)`` gives the port the same weights and
BatchNorm statistics, per-iteration (K, f) statistics included.  The trees:

- a GNN: ``{'params': {'net_state': [...], 'net_output': [...]}, 'state':
  {...}}``, one list entry per MLP layer-program entry;
- a composite GNN: ``net_state`` a list of such lists, one per node type
  (``net_state.{t}.layers.{i}.kernel``);
- an LGNN: ``{'params': {'gnns': [gnn params, ...]}, 'state': {'gnns':
  [...]}}`` (``gnns.{l}.net_state.…``).

``variables_to_jax(model)`` is its inverse.  Neither needs JAX: the caller
converts the leaves with ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _mlp_from_jax(prefix: str, layers, out: Dict[str, torch.Tensor]) -> None:
    for i, leaves in enumerate(layers):
        for key, value in leaves.items():
            out[f"{prefix}.layers.{i}.{key}"] = torch.from_numpy(np.array(value, dtype=np.float32))


def _gnn_from_jax(prefix: str, nets: dict, out: Dict[str, torch.Tensor]) -> None:
    for net, value in nets.items():
        if value and isinstance(value[0], (list, tuple)):  # one MLP per node type
            for t, layers in enumerate(value):
                _mlp_from_jax(f"{prefix}{net}.{t}", layers, out)
        else:
            _mlp_from_jax(f"{prefix}{net}", value, out)


def variables_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's state dict (``net_state.layers.{i}.kernel``,
    ``net_state.{t}.layers.{i}.kernel``, ``gnns.{l}.…``) from the JAX
    variables tree."""
    out: Dict[str, torch.Tensor] = {}
    for section in ("params", "state"):
        nets = tree[section]
        if "gnns" in nets:
            for idx, layer in enumerate(nets["gnns"]):
                _gnn_from_jax(f"gnns.{idx}.", layer, out)
        else:
            _gnn_from_jax("", nets, out)
    return out


def _mlp_to_jax(mlp):
    """(params, state) lists of one MLP: one dict per layer-program entry,
    empty where the entry holds nothing."""
    params = [{k: v.detach().cpu().numpy() for k, v in mod.named_parameters()} for mod in mlp.layers]
    state = [{k: v.detach().cpu().numpy() for k, v in mod.named_buffers()} for mod in mlp.layers]
    return params, state


def _gnn_to_jax(gnn) -> dict:
    tree = {"params": {}, "state": {}}
    for net in ("net_state", "net_output"):
        mlp = getattr(gnn, net)
        if isinstance(mlp, nn.ModuleList):  # one MLP per node type
            pairs = [_mlp_to_jax(m) for m in mlp]
            tree["params"][net], tree["state"][net] = [p for p, _ in pairs], [s for _, s in pairs]
        else:
            tree["params"][net], tree["state"][net] = _mlp_to_jax(mlp)
    return tree


def variables_to_jax(model) -> dict:
    """The JAX variables tree (NumPy leaves) of a port GNN, composite GNN
    or LGNN stack."""
    if hasattr(model, "gnns"):
        trees = [_gnn_to_jax(g) for g in model.gnns]
        return {"params": {"gnns": [t["params"] for t in trees]}, "state": {"gnns": [t["state"] for t in trees]}}
    return _gnn_to_jax(model)
