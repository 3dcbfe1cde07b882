"""Composite (heterogeneous) GNN models, counterpart of
``gnnkeras_tpu.models.composite``: one state-transition MLP per node type,
one shared output MLP.

The type dispatch runs every type's MLP over all (padded) node rows, with
its BatchNorm moments restricted to the type's real rows (``type ∧
node_mask``), and combines the per-type results through the type mask.  A
type with no real row in a batch normalises with count max(0, 1) = 1, as
in the JAX package, so it gives finite values (that the mask then drops).
The per-type adjacencies are never materialised: the neighbour-state sum is
the shared, un-gated aggregation (``Adjᵀ·state``, the strip kernel on a
slot-packed batch), and the per-type neighbour-label sums gate the shared
arc weights by the source node's type, host-built per batch
(``GraphBatch.agg_component``) or, on a batch whose labels changed (an LGNN
layer ≥ 1), summed on the device in plain PyTorch.

Transition input per type t: ``[nodes[:, :d_t] | state | Σ_neigh state |
per-type label sums | Σ_in arc labels]``; the readout reads the state only,
also at dim_state 0.  The arc focus reads both endpoints' rows through the
incidence select and, backward, scatter kernels (``ops/incidence.py``).

The state nets' moving statistics travel as one flat dict keyed
``{t}.layers.{i}.moving_mean`` (the ``nn.ModuleList`` names), so the
unfolding loop of ``models/gnn.py`` carries them unchanged.  ``save`` /
``load`` / ``copy`` / ``summary`` wait for ROADMAP queue 5.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gnnkeras_tpu_torch.graph.batch import GraphBatch
from gnnkeras_tpu_torch.models.gnn import GNNnodeBased, aggregate_t, run_unfold_loops
from gnnkeras_tpu_torch.models.mlp import MLP
from gnnkeras_tpu_torch.ops.segment import segment_sum_ordered


class CompositeGNNnodeBased(GNNnodeBased):
    """Node-focused composite GNN; ``net_state`` holds one MLP per node
    type (an ``nn.ModuleList``)."""

    name = "node"

    def __init__(
        self,
        net_state: Sequence[MLP],
        net_output: MLP,
        state_vect_dim: int,
        max_iteration: int,
        state_threshold: float,
        *,
        per_iteration_bn: bool = False,
    ) -> None:
        assert max_iteration > 0
        super().__init__(nn.ModuleList(net_state), net_output, state_vect_dim, max_iteration, state_threshold)
        self.per_iteration_bn = bool(per_iteration_bn)
        if self.per_iteration_bn:
            for net in self.net_state:
                net.stack_bn_state(self.max_iteration)

    def init_parameters(self, generator: torch.Generator) -> None:
        for net in self.net_state:
            net.reset_parameters(generator)
        self.net_output.reset_parameters(generator)

    def regularization_loss(self) -> torch.Tensor:
        total = self.net_output.regularization_loss()
        for net in self.net_state:
            total = total + net.regularization_loss()
        return total

    # -- per-type moving statistics ----------------------------------------------
    def _bn_state(self) -> Dict[str, torch.Tensor]:
        return {f"{t}.{key}": value for t, net in enumerate(self.net_state) for key, value in net.bn_state().items()}

    @staticmethod
    def _of_type(bn: Dict[str, torch.Tensor], t: int) -> Dict[str, torch.Tensor]:
        prefix = f"{t}."
        return {key[len(prefix):]: value for key, value in bn.items() if key.startswith(prefix)}

    # -- unfolding ---------------------------------------------------------------
    def _check_batch(self, batch: GraphBatch) -> None:
        if batch.type_mask is None:
            raise ValueError("a composite GNN needs a composite batch (type_mask set)")
        if batch.num_types != len(self.net_state):
            raise ValueError(f"batch has {batch.num_types} node types but the model has "
                             f"{len(self.net_state)} per-type state nets")

    def _aggregated_component(self, batch: GraphBatch) -> torch.Tensor:
        """``[Σ_{type-0 sources} w·nodes[:, :d_0] | ... | Σ_in w·arc labels]``
        (N, Σd_t + da): the batch's host-built sums when present, else the
        per-type gated segment sums on the device, added in arc order (the
        same sums on the card as on the CPU)."""
        if batch.agg_component is not None:
            return batch.agg_component
        n = batch.num_nodes
        src = batch.arc_src.long()
        src_type = batch.type_mask[src]
        parts = []
        for t, d_t in enumerate(batch.dim_node_label):
            w_t = batch.arcnode_weight * src_type[:, t].to(batch.arcnode_weight.dtype)
            parts.append(segment_sum_ordered(batch.nodes[src, :d_t] * w_t[:, None], batch.arc_dst, n))
        parts.append(self._agg_arcs(batch))
        return torch.cat(parts, dim=1)

    def _type_masks(self, batch: GraphBatch):
        return [batch.type_mask[:, t] & batch.node_mask for t in range(len(self.net_state))]

    def unfold(self, batch: GraphBatch, *, training: bool = False, generator: Optional[torch.Generator] = None,
               fixed_length: bool = False):
        """Run the unfolding.  Returns (k, state (N, d), the state nets' new
        moving statistics keyed ``{t}.layers.{i}.…``)."""
        self._check_batch(batch)
        if self._use_transposed(batch):
            return self._unfold_transposed(batch, training, generator, fixed_length)
        n = batch.num_nodes
        component = self._aggregated_component(batch)
        state0 = self._initial_state(batch, generator) if self.state_vect_dim > 0 else batch.nodes
        width = state0.shape[1]
        masks = self._type_masks(batch)

        def transition(state, bn, aggregated=None):
            if aggregated is None:
                aggregated = batch.aggregate(state)
            new_state = torch.zeros((n, width), dtype=state.dtype, device=state.device)
            new_bn = {}
            for t, (net, d_t) in enumerate(zip(self.net_state, batch.dim_node_label)):
                inp = torch.cat([batch.nodes[:, :d_t], state, aggregated, component], dim=1)
                out_t, bn_t = net.run(inp, feature_major=False, training=training, mask=masks[t],
                                      generator=generator, bn_state=self._of_type(bn, t))
                new_state = new_state + torch.where(masks[t][:, None], out_t, 0.0)
                new_bn.update({f"{t}.{key}": value for key, value in bn_t.items()})
            return new_state, new_bn

        peel = batch.agg_node_labels if self.state_vect_dim == 0 else None
        return run_unfold_loops(self, batch, state0, torch.ones_like(state0), self._bn_state(), transition,
                                training, peel_agg=peel, fixed_length=fixed_length)

    def _unfold_transposed(self, batch: GraphBatch, training: bool, generator: Optional[torch.Generator],
                           fixed_length: bool = False):
        """The unfolding on feature-major (d_pad, N) state: the per-type MLPs
        run feature-major, the shared aggregation through ``aggregate_t``
        (the strip kernel on a slot-packed batch)."""
        n = batch.num_nodes
        ds = self.state_vect_dim
        sd = ds or batch.nodes.shape[1]
        sd_pad = -(-sd // 8) * 8
        component_t = self._aggregated_component(batch).T
        labels_t = batch.nodes.T
        # the row-major engine's draw, transposed once at entry
        first = self._initial_state(batch, generator).T if ds > 0 else labels_t
        state0 = F.pad(first, (0, 0, 0, sd_pad - sd)).contiguous()
        # pad rows of the old state are zero, so threshold > 0 norms see the
        # row-major engine's sums
        state_old0 = torch.zeros_like(state0)
        state_old0[:sd] = 1.0
        masks = self._type_masks(batch)

        def transition(state_t, bn, aggregated=None):
            if aggregated is None:
                aggregated = aggregate_t(state_t, batch, sd)
            new_state = torch.zeros((sd, n), dtype=state_t.dtype, device=state_t.device)
            new_bn = {}
            for t, (net, d_t) in enumerate(zip(self.net_state, batch.dim_node_label)):
                inp = torch.cat([labels_t[:d_t], state_t[:sd], aggregated, component_t], dim=0)
                out_t, bn_t = net.run(inp, feature_major=True, training=training, mask=masks[t],
                                      generator=generator, bn_state=self._of_type(bn, t))
                new_state = new_state + torch.where(masks[t][None, :], out_t, 0.0)
                new_bn.update({f"{t}.{key}": value for key, value in bn_t.items()})
            return F.pad(new_state, (0, 0, 0, sd_pad - sd)), new_bn

        peel = None if ds > 0 or batch.agg_node_labels is None else batch.agg_node_labels.T
        k, state_t, bn = run_unfold_loops(self, batch, state0, state_old0, self._bn_state(), transition, training,
                                          peel_agg=peel, feature_axis=0, fixed_length=fixed_length)
        return k, state_t[:sd].T, bn

    def fold_transition(self):
        """Per-type state nets do not fold into the single-Dense whole-unfold
        kernel: always None."""
        return None

    def readout_input(self, state: torch.Tensor, batch: GraphBatch):
        """The converged state only, also at dim_state 0 (the composite
        readout reads no node label)."""
        return state, batch.output_row_mask

    def __repr__(self):
        return f"Composite{super().__repr__()}"


class CompositeGNNarcBased(CompositeGNNnodeBased):
    """Arc-focused composite GNN: readout rows ``[src state | dst state |
    arc label]``, through the incidence select and scatter kernels with the
    batch's incidence pairs and an f32 state, else a plain gather."""

    name = "arc"

    def readout_input(self, state: torch.Tensor, batch: GraphBatch):
        if batch.arc_inc is not None and state.dtype == torch.float32:
            from gnnkeras_tpu_torch.ops.incidence import incidence_gather

            s_rows, d_rows = incidence_gather(state.contiguous(), batch.num_arcs, batch.arc_inc)
        else:
            s_rows, d_rows = state[batch.arc_src.long()], state[batch.arc_dst.long()]
        return torch.cat([s_rows, d_rows, batch.arc_label], dim=1), batch.output_row_mask


class CompositeGNNgraphBased(CompositeGNNnodeBased):
    """Graph-focused composite GNN: node outputs averaged per graph."""

    name = "graph"

    def apply_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        out_nodes, _, new_bn = self.node_level_output(state, batch, training=training, generator=generator)
        return batch.readout(out_nodes), batch.graph_mask, new_bn
