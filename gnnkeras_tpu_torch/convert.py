"""Parameters from the JAX package's model variables.

``variables_from_jax(tree)`` takes a GNN's ``variables`` as nested dicts and
lists of NumPy arrays (``{'params': {'net_state': [...], 'net_output':
[...]}, 'state': {...}}``, one list entry per MLP layer-program entry) and
returns the port's state dict, so ``model.load_state_dict(...)`` gives the
port the same weights and BatchNorm statistics.  It needs no JAX: the caller
converts the leaves with ``np.asarray``.
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
