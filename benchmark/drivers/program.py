"""What the drivers take from the program under test (``gnnkeras_tpu_torch``):
its graph objects, sequencers and models, built from the benchmark's own
arrays and weights.  Nothing here is imported before a run's set-up."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.weights import net_widths, shapes

# the reference's leaf names → the program's state-dict keys
_NETS = {"state": "net_state", "output": "net_output"}
_LAYERS = {"bn": 0, "dense": 1}


def program_key(name: str) -> str:
    net, kind, leaf = name.split(".")
    return f"{_NETS[net]}.layers.{_LAYERS[kind]}.{leaf}"


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The configuration's model, built on ``device`` with ``weights`` and
    compiled as the configuration says."""
    from gnnkeras_tpu_torch.models import gnn
    from gnnkeras_tpu_torch.models.mlp import MLP

    widths = net_widths(cfg)
    nets = {}
    for net in ("state", "output"):
        spec = cfg[f"{net}_net"]
        nets[net] = MLP(input_dim=(widths[net][0],), layers=spec["layers"], activations=spec["activation"],
                        kernel_initializer=spec["kernel_initializer"], bias_initializer=spec["bias_initializer"],
                        batch_normalization=spec["batch_normalization"])
    model = getattr(gnn, cfg["model"])(nets["state"], nets["output"], cfg["dim_state"], cfg["max_iter"],
                                       cfg["state_threshold"]).build(seed=0, device=device)
    model.load_state_dict({program_key(k): v.to(device) for k, v in weights.items()})
    model.compile(optimizer=f"{cfg['optimizer']}:{cfg['learning_rate']}", loss=cfg["loss"],
                  metrics=list(cfg["metrics"]), average_st_grads=cfg["average_st_grads"])
    return model


def trainable_leaves(model, cfg: dict) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference's names."""
    named = dict(model.named_parameters())
    return {name: named[program_key(name)] for name in shapes(cfg) if program_key(name) in named}


def banded_graph_object(data: dict, cfg: dict):
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    arcs = np.concatenate([np.stack([data["src"], data["dst"]], 1).astype(np.float32), data["arc_label"]], axis=1)
    return GraphObject(nodes=data["nodes"], arcs=arcs, targets=data["targets"], focus=cfg["focus"],
                       aggregation_mode=cfg["aggregation_mode"], arcs_canonical=True)


def molecule_graph_objects(mols: dict, cfg: dict) -> list:
    """One GraphObject a molecule, in order."""
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    ns, as_ = mols["node_start"], mols["arc_start"]
    out = []
    for i in range(len(ns) - 1):
        lo, hi = as_[i], as_[i + 1]
        arcs = np.concatenate([np.stack([mols["src"][lo:hi] - ns[i], mols["dst"][lo:hi] - ns[i]], 1)
                               .astype(np.float32), mols["arc_label"][lo:hi]], axis=1)
        out.append(GraphObject(nodes=mols["nodes"][ns[i]:ns[i + 1]], arcs=arcs, targets=mols["targets"][i:i + 1],
                               focus=cfg["focus"], aggregation_mode=cfg["aggregation_mode"], arcs_canonical=True))
    return out


def callback_base():
    from gnnkeras_tpu_torch.training.callbacks import Callback

    return Callback
