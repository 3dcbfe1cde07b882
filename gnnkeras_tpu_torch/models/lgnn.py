"""Layered GNN (LGNN) and its composite variant, counterpart of
``gnnkeras_tpu.models.lgnn``: a stack of GNNs of one class where each layer
re-reads the original (t=0) graph with the previous layer's converged state
and/or output prepended to its labels (``update_graph``).

Training modes (``compile(training_mode=...)``):

- ``parallel``: one step; the loss is the mean of the per-layer losses;
- ``residual``: one step; the loss is the loss of the mean of the layers'
  outputs (the mean, as the reference's code computes, not a sum);
- ``serial``: each layer fitted alone, its state and output baked into a
  rebuilt dataset for the next (``training/serial.py``).

Intermediate layers run the node-level output (``node_level_output``); the
graph readout applies to their recorded outputs and to the last layer only.
Evaluation, ``predict`` and serving read the last layer's output.

For arc-focused stacks the propagated output is concatenated to the arc
labels (after the src/dst columns), as the JAX package does; the
reference's prepending ahead of the index columns (its LGNN.py:211) is not
reproduced.

Each layer with dim_state > 0 draws its own random initial state from the
caller's generator, in layer order (``models.gnn.initial_state``).  The
layers' moving statistics are keyed ``gnns.{l}.net_state.…`` as in the
state dict.  ``save`` / ``load`` / ``copy`` / ``summary`` wait for ROADMAP
queue 5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnnkeras_tpu_torch.graph.batch import GraphBatch
from gnnkeras_tpu_torch.models.base import GraphModel
from gnnkeras_tpu_torch.models.gnn import _prefixed

TRAINING_MODES = ("serial", "parallel", "residual")


class LGNN(GraphModel):
    """Layered GNN over homogeneous graphs: ``gnns`` (an ``nn.ModuleList``
    of GNNs of one class), ``get_state`` / ``get_output`` pick what each
    layer hands to the next."""

    def __init__(self, gnns: Sequence[nn.Module], get_state: bool, get_output: bool) -> None:
        assert get_state or get_output
        assert len({type(g) for g in gnns}) == 1
        super().__init__()
        self.GNN_CLASS = type(gnns[0])
        self.gnns = nn.ModuleList(gnns)
        self.LAYERS = len(gnns)
        self.get_state = bool(get_state)
        self.get_output = bool(get_output)

    @property
    def _is_arc(self) -> bool:
        return self.gnns[0].name == "arc"

    @property
    def _is_graph(self) -> bool:
        return self.gnns[0].name == "graph"

    def init_parameters(self, generator: torch.Generator) -> None:
        """Initialise every layer and mark it built: a layer's own ``build``
        (serial training calls it) keeps the stack's weights.  Each layer
        gets a random stream of its own seeded 0, as the JAX package's
        layers keep the key ``PRNGKey(0)``."""
        for gnn in self.gnns:
            gnn.init_parameters(generator)
            gnn.built, gnn._rng = True, torch.Generator().manual_seed(0)

    def build(self, seed: int = 0, device=None) -> "LGNN":
        """As ``GraphModel.build``; the layers take the stack's device."""
        super().build(seed=seed, device=device)
        for gnn in self.gnns:
            gnn.device = self.device
        return self

    def scale_state_grads(self, ks) -> None:
        """``average_st_grads``: each layer's state nets' gradients divided
        by that layer's max(k, 1)."""
        for gnn, k in zip(self.gnns, ks):
            gnn.scale_state_grads(k)

    def regularization_loss(self) -> torch.Tensor:
        total = self.gnns[0].regularization_loss()
        for gnn in self.gnns[1:]:
            total = total + gnn.regularization_loss()
        return total

    # -- graph feature propagation ----------------------------------------------
    def update_graph(self, batch0: GraphBatch, state: torch.Tensor, out: torch.Tensor,
                     out_row_mask: torch.Tensor) -> GraphBatch:
        """``batch0`` with the layer's converged state and/or its output
        (zero outside ``out_row_mask``) prepended to the node labels (the
        output to the arc labels for the arc focus); every type's label
        width grows by the same amount.  The batch-constant neighbour sums
        of the changed labels are dropped, so the next layer sums them on
        the device."""
        nodeplus, arcplus = [], []
        if self.get_state:
            nodeplus.append(state)
        if self.get_output:
            scattered = torch.where(out_row_mask[:, None], out, 0.0)
            (arcplus if self._is_arc else nodeplus).append(scattered)
        nodes, arc_label, grow = batch0.nodes, batch0.arc_label, 0
        if nodeplus:
            grow = sum(p.shape[1] for p in nodeplus)
            nodes = torch.cat(nodeplus + [nodes], dim=1)
        if arcplus:
            arc_label = torch.cat(arcplus + [arc_label], dim=1)
        return batch0.replace(
            nodes=nodes, arc_label=arc_label, dim_node_label=tuple(int(d) + grow for d in batch0.dim_node_label),
            agg_arc_labels=None if arcplus else batch0.agg_arc_labels, agg_node_labels=None, agg_component=None,
        )

    # -- forward -----------------------------------------------------------------
    def served_output(self, outs):
        return outs[-1]

    def forward(self, batch: GraphBatch, *, training: bool = False, generator: Optional[torch.Generator] = None,
                fixed_length: bool = False):
        """Run every layer.  Returns (ks, states, outs, out_mask, new moving
        statistics): one k, state and output per layer (graph-level outputs
        for the graph focus), the output row mask of the last layer, and the
        statistics keyed as in the state dict (``gnns.{l}.net_state.…``).
        ``fixed_length`` selects every layer's exportable inference loop."""
        cur = batch
        ks, states, outs, new_state = [], [], [], {}
        out_mask = None
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            for idx, gnn in enumerate(self.gnns):
                if idx == self.LAYERS - 1:
                    k, state, out, out_mask, stats = gnn.forward(cur, training=training, generator=generator,
                                                                 fixed_length=fixed_length)
                    outs.append(out)
                else:
                    k, state, bn_state = gnn.unfold(cur, training=training, generator=generator,
                                                    fixed_length=fixed_length)
                    out, row_mask, bn_out = gnn.node_level_output(state, cur, training=training, generator=generator)
                    stats = {**_prefixed("net_state", bn_state), **_prefixed("net_output", bn_out)}
                    outs.append(cur.readout(out) if self._is_graph else out)
                    cur = self.update_graph(batch, state, out, row_mask)
                ks.append(k)
                states.append(state)
                new_state.update(_prefixed(f"gnns.{idx}", stats))
        return ks, states, outs, out_mask, new_state

    # -- compile / fit -------------------------------------------------------------
    def compile(self, optimizer=None, loss=None, metrics=None, average_st_grads: bool = False,
                training_mode: str = "parallel") -> None:
        """As ``GraphModel.compile``, plus ``training_mode`` ∈ {'serial',
        'parallel', 'residual'}; the layers are compiled too."""
        assert training_mode in TRAINING_MODES
        super().compile(optimizer=optimizer, loss=loss, metrics=metrics, average_st_grads=average_st_grads)
        for gnn in self.gnns:
            gnn.compile(optimizer=optimizer, loss=loss, metrics=metrics, average_st_grads=average_st_grads)
        self.training_mode = training_mode

    def fit(self, *args, **kwargs):
        if self.training_mode == "serial":
            from gnnkeras_tpu_torch.training.serial import fit_serial

            return fit_serial(self, *args, **kwargs)
        return super().fit(*args, **kwargs)

    def __repr__(self):
        return (
            f"LGNN(type={self.gnns[0].name}, layers={self.LAYERS}, get_state={self.get_state}, "
            f"get_output={self.get_output}, mode={self.training_mode}, avg={self.average_st_grads})"
        )


class CompositeLGNN(LGNN):
    """Layered composite GNN: a stack of composite GNNs of one class."""

    def __repr__(self):
        return f"Composite{super().__repr__()}"
