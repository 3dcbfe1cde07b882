"""Parameters from and to the JAX package's model variables.

``variables_from_jax(tree)`` takes a GNN's ``variables`` as nested dicts and
lists of NumPy arrays (``{'params': {'net_state': [...], 'net_output':
[...]}, 'state': {...}}``, one list entry per MLP layer-program entry) and
returns the port's state dict, so ``model.load_state_dict(...)`` gives the
port the same weights and BatchNorm statistics, per-iteration (K, f)
statistics included.  ``variables_to_jax(model)`` is its inverse.  Neither
needs JAX: the caller converts the leaves with ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def variables_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's state dict (``net_state.layers.{i}.kernel``, ...) from the
    JAX variables tree."""
    out: Dict[str, torch.Tensor] = {}
    for section in ("params", "state"):
        for net, layers in tree[section].items():
            for i, leaves in enumerate(layers):
                for key, value in leaves.items():
                    out[f"{net}.layers.{i}.{key}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def variables_to_jax(model) -> dict:
    """The JAX variables tree (NumPy leaves) of a port GNN: per net, one
    dict per layer-program entry, empty where the entry holds nothing."""
    tree = {"params": {}, "state": {}}
    for net in ("net_state", "net_output"):
        mlp = getattr(model, net)
        params, state = [], []
        for mod in mlp.layers:
            params.append({k: v.detach().cpu().numpy() for k, v in mod.named_parameters()})
            state.append({k: v.detach().cpu().numpy() for k, v in mod.named_buffers()})
        tree["params"][net], tree["state"][net] = params, state
    return tree
