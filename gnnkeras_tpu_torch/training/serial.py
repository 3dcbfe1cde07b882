"""LGNN 'serial' training mode, counterpart of ``gnnkeras_tpu.training.serial``.

Each layer is trained alone, then its converged state and output are baked
into a rebuilt dataset that feeds the next layer, always prepended to the
original t=0 features.  The bake runs the trained layer over every graph
with ``training=True``, as the reference does, so the BatchNorm moving
statistics are committed as it goes: graph by graph (``bake_batch_size=1``)
or chunk by chunk of merged graphs (``bake_batch_size > 1``, one launch
sequence a chunk instead of a graph).

The layers are submodules of the stack: a layer's ``fit`` trains the
stack's own parameters, so nothing is copied between them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gnnkeras_tpu_torch.graph.batch import from_graph_object
from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.models.gnn import _prefixed


def _update_host_graph(model, g0: GraphObject, state: np.ndarray, out: np.ndarray,
                       mask_graph: Optional[GraphObject] = None) -> GraphObject:
    """Host-side ``LGNN.update_graph``: the state and/or the output (zero
    outside the set ∧ output mask) prepended to the t=0 node features (the
    output to the arc labels for the arc focus).

    ``mask_graph`` is the graph the layer processed; its set ∧ output mask
    gates the output.  A transductive bake processes a transduction whose
    transductive nodes have no output supervision, so their baked output
    rows stay zero.  Defaults to ``g0``."""
    nodeplus: List[np.ndarray] = []
    arcplus: List[np.ndarray] = []
    if model.get_state:
        nodeplus.append(state)
    if model.get_output:
        mg = g0 if mask_graph is None else mask_graph
        mask = np.logical_and(mg.set_mask, mg.output_mask)
        scattered = np.zeros((len(mask), out.shape[1]), dtype=g0.dtype)
        scattered[mask] = out[mask]
        (arcplus if model._is_arc else nodeplus).append(scattered)

    nodes_new = np.concatenate(nodeplus + [g0.nodes], axis=1) if nodeplus else g0.nodes.copy()
    if arcplus:
        arcs_new = np.concatenate([g0.arcs[:, :2]] + arcplus + [g0.arcs[:, 2:]], axis=1)
    else:
        arcs_new = g0.arcs.copy()
    grow = sum(p.shape[1] for p in nodeplus)

    common = dict(
        nodes=nodes_new, arcs=arcs_new, targets=g0.targets.copy(), focus=g0.focus, set_mask=g0.set_mask.copy(),
        output_mask=g0.output_mask.copy(), sample_weight=g0.sample_weight.copy(),
        NodeGraph=(g0.graph_of_node, g0.nodegraph_weight) if g0.focus == "g" else None,
        aggregation_mode=g0.aggregation_mode,
        # keep the t=0 arc-row order: arc-focus targets and masks are
        # arc-indexed, and a re-sort keyed on the inserted columns could
        # swap parallel arcs; the t=0 rows are unique, so is the result
        arcs_canonical=True,
    )
    if isinstance(g0, CompositeGraphObject):
        return CompositeGraphObject(type_mask=g0.getTypeMask(), dim_node_label=g0.DIM_NODE_LABEL + grow, **common)
    return GraphObject(**common)


def _bake_graphs(model, gnn, graphs, t0_graphs, chunk_size: int = 1):
    """Run the trained layer over every graph (``training=True``, no
    gradients) and return new host graphs: the t=0 features with the
    layer's state and output prepended.  The new moving statistics are
    committed after each chunk of ``chunk_size`` merged graphs."""
    from gnnkeras_tpu_torch.training.trainer import _load_bn_state

    chunk_size = max(int(chunk_size), 1)
    chunks = [graphs[i:i + chunk_size] for i in range(0, len(graphs), chunk_size)]
    pad_n = max(sum(g.nodes.shape[0] for g in ch) for ch in chunks)
    pad_a = max(sum(g.arcs.shape[0] for g in ch) for ch in chunks)
    pad_n = ((pad_n + 127) // 128) * 128
    pad_a = ((pad_a + 127) // 128) * 128
    pad_g = ((max(len(ch) for ch in chunks) + 7) // 8) * 8

    new_graphs = []
    t0_iter = iter(t0_graphs)
    for ch in chunks:
        if len(ch) > 1:
            g_dev = type(ch[0]).merge(list(ch), focus=ch[0].focus, aggregation_mode=ch[0].aggregation_mode)
        else:
            g_dev = ch[0]
        batch = from_graph_object(g_dev, pad_n, pad_a, pad_graphs=pad_g, device=gnn.device)
        generator = gnn.next_rng()
        with torch.no_grad():
            _, state, bn_state = gnn.unfold(batch, training=True, generator=generator)
            out, _, bn_out = gnn.node_level_output(state, batch, training=True, generator=generator)
            _load_bn_state(gnn, {**_prefixed("net_state", bn_state), **_prefixed("net_output", bn_out)})
        state_np = state.cpu().numpy()
        out_np = out.cpu().numpy()
        # the merge keeps every graph's nodes and arcs contiguous, in order
        off_n = off_r = 0
        for g in ch:
            n_i = g.nodes.shape[0]
            n_rows = g.arcs.shape[0] if model._is_arc else n_i
            row0 = off_r if model._is_arc else off_n
            new_graphs.append(_update_host_graph(model, next(t0_iter), state_np[off_n:off_n + n_i],
                                                 out_np[row0:row0 + n_rows], mask_graph=g))
            off_n += n_i
            off_r += g.arcs.shape[0]
    return new_graphs


def _bake_layer(model, gnn, sequence, t0_sequence, chunk_size: int = 1):
    """``sequence``'s dataset rebuilt with the trained layer's features.

    A transductive sequencer holds homogeneous graphs and transduces them
    anew every epoch: the bake runs the layer on one fresh transduction,
    prepends its state and output to the original homogeneous t=0
    features, and returns a new transductive sequencer over those graphs."""
    from gnnkeras_tpu_torch.data.transductive import (TransductiveMultiGraphSequencer,
                                                      TransductiveSingleGraphSequencer, get_transduction)

    if isinstance(sequence, TransductiveMultiGraphSequencer):
        transduced = [get_transduction(g, sequence.transductive_rate, sequence.focus) for g in sequence.graph_objects]
        cfg = sequence.get_config()
        cfg["graphs"] = _bake_graphs(model, gnn, transduced, t0_sequence.graph_objects, chunk_size)
        cfg["shuffle"] = t0_sequence.shuffle
        return type(sequence)(**cfg)
    if isinstance(sequence, TransductiveSingleGraphSequencer):
        transduced = [get_transduction(sequence.graph_object, sequence.transductive_rate, sequence.focus)]
        cfg = sequence.get_config()
        cfg["graph"] = _bake_graphs(model, gnn, transduced, [t0_sequence.graph_object], chunk_size)[0]
        cfg["shuffle"] = t0_sequence.shuffle
        return type(sequence)(**cfg)

    graphs = sequence.data if isinstance(sequence.data, list) else [sequence.data]
    t0_graphs = t0_sequence.data if isinstance(t0_sequence.data, list) else [t0_sequence.data]
    return t0_sequence.with_graphs(_bake_graphs(model, gnn, graphs, t0_graphs, chunk_size))


def fit_serial(model, sequencer, epochs: int = 1, validation_data=None, callbacks: Optional[list] = None,
               verbose: int = 1, seed: int = 0, bake_batch_size: int = 1):
    """Serial-mode LGNN fit: each layer's ``fit`` on the dataset baked by
    the layers below.  ``callbacks``, if given, is one list per layer.
    Returns the layers' Histories."""
    model.build(seed=seed)
    if callbacks is not None:
        if len(callbacks) != model.LAYERS:
            raise ValueError("serial mode needs one callback list per layer")
    else:
        callbacks = [[] for _ in range(model.LAYERS)]

    training_sequence = sequencer.copy()
    valid_sequence = validation_data.copy() if validation_data is not None else None
    histories = []
    for idx, gnn in enumerate(model.gnns):
        if verbose:
            print(f"\n--- GNN {idx + 1}/{model.LAYERS} ---")
        histories.append(gnn.fit(
            training_sequence.copy(), epochs=epochs,
            validation_data=valid_sequence.copy() if valid_sequence is not None else None,
            callbacks=callbacks[idx], verbose=verbose,
        ))
        if idx == model.LAYERS - 1:
            break
        training_sequence = _bake_layer(model, gnn, training_sequence, sequencer, bake_batch_size)
        if valid_sequence is not None:
            valid_sequence = _bake_layer(model, gnn, valid_sequence, validation_data, bake_batch_size)
    return histories
