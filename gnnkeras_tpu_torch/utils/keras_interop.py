"""Import models saved by the reference's Keras framework into the port, the
counterpart of ``gnnkeras_tpu.utils.keras_interop``.

The reference saves a model as per-MLP Keras models plus a ``config.json``
of scalars (``<path>/net_state``, ``<path>/net_output``, ``config.json``;
an LGNN nests per-layer ``GNN{i}/`` folders; a composite GNN saves
``net_state_{i}`` per node type).  Folders are probed for both the legacy
SavedModel layout and ``.keras`` archives (``net_state.keras`` next to
``config.json``):

- ``weights_from_keras(keras_model, mlp)``: Keras layer weights → the
  ``{'params': [...], 'state': [...]}`` lists of an MLP's layer program
  (NumPy arrays);
- ``mlp_spec_from_keras(keras_model)``: an ``MLP`` of the same Dense stack;
- ``load_reference_gnn(path, focus, device)``,
  ``load_reference_composite(...)`` and ``load_reference_lgnn(path,
  device)``: a reference folder as the matching port model, built on
  ``device`` with the imported weights.

TensorFlow is imported inside the loaders only: importing this module
imports no TensorFlow, and nothing else of the port needs it.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from gnnkeras_tpu_torch.models.mlp import MLP


def weights_from_keras(keras_model, mlp: MLP) -> dict:
    """Extract Dense/BatchNorm weights from a Keras model, aligned with our
    ``MLP`` program order.  Returns ``{'params': [...], 'state': [...]}``.

    The alignment is STRICT: every weighted Keras layer must correspond to
    the program entry at the same position (dense → 2 weights,
    batch_norm → 4).  Reference-built MLPs always satisfy this (one optional
    LEADING BatchNorm, then biased Dense layers, MLP.py:59-70); anything
    else — a mid-stack BatchNorm the spec cannot represent, a bias-less
    Dense — raises instead of silently importing a model that computes a
    different function."""
    k_layers = [l for l in keras_model.layers if l.get_weights()]
    params: List[dict] = []
    state: List[dict] = []
    want = {"dense": 2, "batch_norm": 4}
    ki = 0
    for layer in mlp.program:
        if layer[0] not in want:  # dropout: no weights
            params.append({})
            state.append({})
            continue
        if ki >= len(k_layers) or len(k_layers[ki].get_weights()) != want[layer[0]]:
            got = (
                f"{type(k_layers[ki]).__name__} with {len(k_layers[ki].get_weights())} weights"
                if ki < len(k_layers) else "no layer"
            )
            raise ValueError(
                f"Keras model does not line up with the MLP spec at program entry "
                f"{layer[0]!r}: expected a layer with {want[layer[0]]} weights, got {got} "
                f"(mid-stack BatchNorm and use_bias=False Dense are not representable)"
            )
        if layer[0] == "dense":
            kernel, bias = k_layers[ki].get_weights()
            params.append({"kernel": np.asarray(kernel), "bias": np.asarray(bias)})
            state.append({})
        else:
            gamma, beta, mean, var = k_layers[ki].get_weights()
            params.append({"gamma": np.asarray(gamma), "beta": np.asarray(beta)})
            state.append({"moving_mean": np.asarray(mean), "moving_var": np.asarray(var)})
        ki += 1
    if ki != len(k_layers):
        extra = ", ".join(type(l).__name__ for l in k_layers[ki:])
        raise ValueError(
            f"Keras model has {len(k_layers) - ki} weighted layer(s) the MLP spec does "
            f"not model ({extra}) — refusing a partial import"
        )
    return {"params": params, "state": state}


def mlp_spec_from_keras(keras_model, batch_normalization=None) -> MLP:
    """Build an ``MLP`` spec mirroring a Keras Sequential's Dense stack
    (units + activations, leading BatchNorm detection)."""
    units, acts = [], []
    has_bn = False
    input_dim = None
    for l in keras_model.layers:
        cls = type(l).__name__
        if cls == "Dense":
            if len(l.get_weights()) != 2:
                raise ValueError("Dense(use_bias=False) is not representable by the MLP spec")
            if input_dim is None:
                input_dim = int(l.get_weights()[0].shape[0])
            units.append(int(l.units))
            act = getattr(l.activation, "__name__", "linear")
            acts.append(act if act != "linear" else "linear")
        elif "BatchNormalization" in cls:
            if units:  # reference MLPs only ever put BatchNorm FIRST (MLP.py:67-70)
                raise ValueError(
                    "mid-stack BatchNormalization is not representable by the "
                    "reference MLP spec (leading-only, MLP.py:67-70)"
                )
            has_bn = True
            if input_dim is None:
                input_dim = int(l.get_weights()[0].shape[0])
    if batch_normalization is None:
        batch_normalization = has_bn
    return MLP(input_dim=(input_dim,), layers=units, activations=acts,
               batch_normalization=batch_normalization)


def _load_keras_model(base: str, name: str):
    import tensorflow as tf

    for candidate in (f"{base}{name}.keras", os.path.join(base, name)):
        if os.path.exists(candidate):
            return tf.keras.models.load_model(candidate, compile=False)
    raise FileNotFoundError(f"no Keras model at {base}{name}(.keras)")


def _with_weights(model, tree: dict, device):
    """``model`` built on ``device`` with the variables ``tree`` (the JAX
    package's layout, NumPy leaves) as its weights."""
    from gnnkeras_tpu_torch.convert import variables_from_jax

    model.build(device=device)
    model.load_state_dict(variables_from_jax(tree))
    return model


def _reference_gnn(path: str, focus: str):
    """(unbuilt GNN, its variables tree) of a reference GNN folder."""
    from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased

    if path[-1] != "/":
        path += "/"
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)

    net_state_k = _load_keras_model(path, "net_state")
    net_output_k = _load_keras_model(path, "net_output")
    net_state = mlp_spec_from_keras(net_state_k)
    net_output = mlp_spec_from_keras(net_output_k)

    cls = {"n": GNNnodeBased, "a": GNNarcBased, "g": GNNgraphBased}[focus]
    # the reference's config.json stores the constructor scalars
    # (GNN.get_config, GNN.py:64-78)
    kwargs = dict(
        state_vect_dim=int(config.get("state_vect_dim", 0)),
        max_iteration=int(config.get("max_iteration", 10)),
        state_threshold=float(config.get("state_threshold", 0.01)),
    )
    model = cls(net_state, net_output, **kwargs)

    vs = weights_from_keras(net_state_k, net_state)
    vo = weights_from_keras(net_output_k, net_output)
    return model, {
        "params": {"net_state": vs["params"], "net_output": vo["params"]},
        "state": {"net_state": vs["state"], "net_output": vo["state"]},
    }


def load_reference_gnn(path: str, focus: str = "n", device="cuda"):
    """Load a reference-format GNN directory (config.json + net_state/
    net_output Keras models) into the matching GNN class with transplanted
    weights, built on ``device``.  As in the reference, the model class is
    the caller's choice, so ``focus`` picks node/arc/graph."""
    return _with_weights(*_reference_gnn(path, focus), device)


def _numbered_entries(path: str, pattern: str):
    """Directory entries matching ``pattern`` (a regex with one numeric
    group), returned as (index, stem) sorted NUMERICALLY — the reference's
    own ``listdir`` order is filesystem-dependent (LGNN.py:128,
    CompositeGNN.py:128) and would interleave e.g. GNN10 before GNN2."""
    import re

    found = {}
    for name in os.listdir(path):
        m = re.fullmatch(pattern, name)
        if m:
            # strip a .keras archive suffix back to the probe stem
            stem = name[: -len(".keras")] if name.endswith(".keras") else name
            found[int(m.group(1))] = stem
    idx = sorted(found)
    if idx != list(range(len(idx))):
        raise FileNotFoundError(
            f"non-contiguous numbered entries under {path}: indices {idx}"
        )
    return [(i, found[i]) for i in idx]


def _reference_composite(path: str, focus: str):
    """(unbuilt composite GNN, its variables tree) of a reference composite
    GNN folder."""
    from gnnkeras_tpu_torch.models.composite import (
        CompositeGNNarcBased,
        CompositeGNNgraphBased,
        CompositeGNNnodeBased,
    )

    if path[-1] != "/":
        path += "/"
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)

    entries = _numbered_entries(path, r"net_state_(\d+)(?:\.keras)?")
    if not entries:
        raise FileNotFoundError(f"no net_state_{{i}} models under {path}")
    nets_k = [_load_keras_model(path, stem) for _, stem in entries]
    net_output_k = _load_keras_model(path, "net_output")
    net_state = [mlp_spec_from_keras(k) for k in nets_k]
    net_output = mlp_spec_from_keras(net_output_k)

    cls = {"n": CompositeGNNnodeBased, "a": CompositeGNNarcBased, "g": CompositeGNNgraphBased}[focus]
    model = cls(
        net_state,
        net_output,
        state_vect_dim=int(config.get("state_vect_dim", 0)),
        max_iteration=int(config.get("max_iteration", 10)),
        state_threshold=float(config.get("state_threshold", 0.01)),
    )
    ws = [weights_from_keras(k, spec) for k, spec in zip(nets_k, net_state)]
    wo = weights_from_keras(net_output_k, net_output)
    return model, {
        "params": {"net_state": [w["params"] for w in ws], "net_output": wo["params"]},
        "state": {"net_state": [w["state"] for w in ws], "net_output": wo["state"]},
    }


def load_reference_composite(path: str, focus: str = "n", device="cuda"):
    """Load a reference-format CompositeGNN directory (config.json + one
    ``net_state_{i}`` Keras model per node type + ``net_output``) into the
    matching ``CompositeGNN*Based`` with transplanted weights, built on
    ``device``.  As in the reference, the class is the caller's choice via
    ``focus``."""
    return _with_weights(*_reference_composite(path, focus), device)


def load_reference_lgnn(path: str, device="cuda"):
    """Load a reference-format LGNN directory (config.json with get_state /
    get_output / gnn_class, per-layer ``GNN{i}/`` subfolders) into ``LGNN``
    (or ``CompositeLGNN`` when the layer folders carry the composite
    ``net_state_{i}`` layout; the reference's CompositeLGNN shares the
    node/arc/graph gnn_class names), built on ``device``."""
    from gnnkeras_tpu_torch.models.lgnn import LGNN, CompositeLGNN

    if path[-1] != "/":
        path += "/"
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    focus = {"node": "n", "arc": "a", "graph": "g"}[config.get("gnn_class", "node")]

    layers = [
        (i, os.path.join(path, stem) + "/")
        for i, stem in _numbered_entries(path, r"GNN(\d+)")
        if os.path.isdir(os.path.join(path, stem))
    ]
    if not layers:
        raise FileNotFoundError(f"no GNN{{i}}/ layer folders under {path}")
    composite = any(
        _numbered_entries(layers[0][1], r"net_state_(\d+)(?:\.keras)?")
    )
    loader = _reference_composite if composite else _reference_gnn
    parts = [loader(sub, focus=focus) for _, sub in layers]

    lgnn_cls = CompositeLGNN if composite else LGNN
    lgnn = lgnn_cls([g for g, _ in parts], bool(config.get("get_state", True)), bool(config.get("get_output", True)))
    return _with_weights(lgnn, {
        "params": {"gnns": [tree["params"] for _, tree in parts]},
        "state": {"gnns": [tree["state"] for _, tree in parts]},
    }, device)
