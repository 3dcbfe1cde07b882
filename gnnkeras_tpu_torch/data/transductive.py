"""Mixed inductive-transductive learning sequencers, counterpart of
``gnnkeras_tpu.data.transductive``.

Each epoch a random ``transductive_rate`` share of the supervised nodes
gets its target appended to its node features and moves to a second
("transductive") node type with its supervision removed; the rest stays
inductive.  The draws come from NumPy's global stream, as in the JAX
package, so a test that seeds NumPy gets the same transductions from both.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from gnnkeras_tpu_torch.data.sequencers import _PROBLEM, CompositeMultiGraphSequencer, CompositeSingleGraphSequencer
from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.utils.dtypes import floatx


def get_transduction(g: GraphObject, transductive_rate: float, focus: str) -> CompositeGraphObject:
    """Homogeneous graph → 2-type composite graph with [non-transductive,
    transductive] node types.

    ``focus='a'`` keeps the reference's quirk, as the JAX package does: the
    appended target block is sized by the arc count yet concatenated onto
    the node matrix, so it fails whenever the arc and node counts differ."""
    if isinstance(g, CompositeGraphObject):
        raise ValueError(
            "get_transduction takes a homogeneous GraphObject — it builds its own "
            "2-type composite and would silently discard an existing type structure"
        )
    transductive_node_mask = np.logical_and(g.set_mask, g.output_mask)

    indices = np.flatnonzero(transductive_node_mask)
    np.random.shuffle(indices)
    non_transductive_number = int(np.ceil(np.sum(transductive_node_mask) * (1 - transductive_rate)))
    transductive_node_mask[indices[:non_transductive_number]] = False

    transductive_target_mask = transductive_node_mask[g.output_mask]

    length = g.arcs.shape[0] if focus == "a" else g.nodes.shape[0]
    labelplus = np.zeros((length, g.DIM_TARGET), dtype=floatx())
    labelplus[transductive_node_mask] = g.targets[transductive_target_mask]

    nodes_new = np.concatenate([g.nodes, labelplus], axis=1)
    target_new = g.targets[np.logical_not(transductive_target_mask)]

    dim0 = int(np.sum(g.DIM_NODE_LABEL))
    type_mask = np.zeros((g.nodes.shape[0], 2), dtype=bool)
    type_mask[transductive_node_mask, 1] = True
    type_mask[:, 0] = np.logical_not(type_mask[:, 1])

    output_mask_new = g.output_mask.copy()
    output_mask_new[transductive_node_mask] = False

    return CompositeGraphObject(
        arcs=g.arcs.copy(), nodes=nodes_new, targets=target_new, type_mask=type_mask,
        dim_node_label=(dim0, dim0 + g.DIM_TARGET), focus=focus, set_mask=g.set_mask.copy(),
        output_mask=output_mask_new,
    )


class TransductiveMultiGraphSequencer(CompositeMultiGraphSequencer):
    """Multi-graph transductive sequencer: every epoch the graphs are
    transduced anew (and shuffled), then merged into batches."""

    def __init__(self, graphs: Sequence[GraphObject], focus: str, aggregation_mode: str,
                 transductive_rate: float = 0.5, batch_size: int = 32, shuffle: bool = True, **kwargs):
        self.graph_objects: List[GraphObject] = list(graphs)
        self.transductive_rate = float(transductive_rate)
        transduced = [get_transduction(g, self.transductive_rate, focus) for g in self.graph_objects]
        super().__init__(transduced, focus, aggregation_mode, batch_size, shuffle, **kwargs)

    def on_epoch_end(self) -> None:
        self.data = [get_transduction(g, self.transductive_rate, self.focus) for g in self.graph_objects]
        if self.shuffle:
            order = np.random.permutation(len(self.data))
            self.data = [self.data[i] for i in order]
            self.graph_objects = [self.graph_objects[i] for i in order]
        self.build_batches()

    def get_config(self) -> dict:
        config = super().get_config()
        config["graphs"] = self.graph_objects
        config["transductive_rate"] = self.transductive_rate
        return config

    def __repr__(self):
        return (
            f"transductive_graph_sequencer(multiple {_PROBLEM[self.focus]}-focused, len={len(self)}, "
            f"transductive_rate={self.transductive_rate}, aggregation='{self.aggregation_mode}', "
            f"batch_size={self.batch_size}, shuffle={self.shuffle})"
        )

    __str__ = __repr__


class TransductiveSingleGraphSequencer(CompositeSingleGraphSequencer):
    """Single-graph transductive sequencer: the one graph is transduced
    anew every epoch, and its cached base batch is dropped (the node
    features change; the shapes do not)."""

    def __init__(self, graph: GraphObject, focus: str, transductive_rate: float = 0.5, batch_size: int = 32,
                 shuffle: bool = True, **kwargs):
        self.graph_object = graph
        self.transductive_rate = float(transductive_rate)
        transduced = get_transduction(graph, self.transductive_rate, focus)
        super().__init__(transduced, focus, batch_size, shuffle, **kwargs)

    def on_epoch_end(self) -> None:
        self.graph = get_transduction(self.graph_object, self.transductive_rate, self.focus)
        self._base_batch = None
        self.set_mask_idx = np.flatnonzero(self.graph.set_mask)
        if self.shuffle:
            np.random.shuffle(self.set_mask_idx)
        self.build_batches()

    def get_config(self) -> dict:
        config = super().get_config()
        config["graph"] = self.graph_object
        config["transductive_rate"] = self.transductive_rate
        return config

    def __repr__(self):
        return (
            f"transductive_graph_sequencer(type=single {_PROBLEM[self.focus]}-focused, len={len(self)}, "
            f"transductive_rate={self.transductive_rate}, batch_size={self.batch_size}, shuffle={self.shuffle})"
        )

    __str__ = __repr__
