"""Homogeneous GNN models: the iterate-to-convergence unfolding engine,
inference direction, counterpart of ``gnnkeras_tpu.models.gnn``.

The unfolding is a Python ``while`` loop with the reference's early exit:
run while some real node's state moved more than ``threshold·‖old‖₂`` and
``k < max_iteration``.  Iteration 0 is peeled from the batch's
host-precomputed ``Adjᵀ·labels`` when the state is the node label
(``dim_state == 0``), so a forward of k iterations aggregates k − 1 times.

Two engines, picked per batch as in the JAX package (``_use_transposed``):
row-major (N, d) state through ``GraphBatch.aggregate``, and feature-major
(d_pad, N) state through the slot-128 strip kernel (``ops/strip.py``) or the
dense-block BCSR.  ``dim_state > 0``, training-mode loops, per-iteration
BatchNorm and the LGNN/composite models come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch.graph.batch import GraphBatch
from gnnkeras_tpu_torch.models.base import GraphModel
from gnnkeras_tpu_torch.models.mlp import MLP
from gnnkeras_tpu_torch.ops.segment import aggregate_edges

# plain-BCSR batches run feature-major while the padded state width is at
# most this (the JAX package's measured boundary, kept so both packages pick
# the same engine for the same batch)
_TRANSPOSED_BCSR_MAX_STATE_DIM = 32


def unconverged(state, state_old, node_mask, threshold: float, feature_axis: int = 1) -> bool:
    """True while any real node moved more than ``threshold·‖old‖₂``.
    ``feature_axis=0`` is feature-major (d_pad, N) state."""
    if threshold == 0.0:
        # ‖s − s_old‖₂ > 0 ⟺ some element changed
        changed = torch.any(state != state_old, dim=feature_axis)
    else:
        distance = torch.sqrt(torch.sum(torch.square(state - state_old), dim=feature_axis))
        norm = torch.sqrt(torch.sum(torch.square(state_old), dim=feature_axis))
        changed = distance > threshold * norm
    return bool(torch.any(changed & node_mask))


def aggregate_t(state_t: torch.Tensor, batch: GraphBatch, sd: int) -> torch.Tensor:
    """Feature-major ``Adjᵀ·state`` through the strip operator when present,
    else the dense-block BCSR, sliced to the real feature rows."""
    if batch.strip is not None:
        from gnnkeras_tpu_torch.ops.strip import strip_aggregate_t

        agg = strip_aggregate_t(state_t, batch.strip)
    else:
        from gnnkeras_tpu_torch.ops.bcsr import bcsr_aggregate_t

        agg = bcsr_aggregate_t(state_t, batch.bcsr)
    return agg[:sd]


def run_unfold_loops(model, batch: GraphBatch, state0, state_old0, transition, peel_agg=None, feature_axis: int = 1):
    """Inference unfolding with the early exit.  ``transition(state,
    aggregated=None)`` is one step; ``peel_agg`` (``Adjᵀ·labels``) replaces
    the aggregation of iteration 0.  Returns (k, state)."""
    K = model.max_iteration
    threshold = model.state_threshold
    state = state0
    changed = unconverged(state0, state_old0, batch.node_mask, threshold, feature_axis)
    k = 0
    while changed and k < K:
        new_state = transition(state, peel_agg if k == 0 else None)
        changed = unconverged(new_state, state, batch.node_mask, threshold, feature_axis)
        state, k = new_state, k + 1
    return k, state


class GNNnodeBased(GraphModel):
    """Node-focused GNN (inference)."""

    name = "node"

    def __init__(
        self,
        net_state: MLP,
        net_output: MLP,
        state_vect_dim: int,
        max_iteration: int,
        state_threshold: float,
    ) -> None:
        assert max_iteration >= 0
        assert state_threshold >= 0
        if state_vect_dim != 0:
            raise NotImplementedError("state_vect_dim > 0 is not ported yet; the port runs dim_state == 0")
        super().__init__()
        self.net_state = net_state
        self.net_output = net_output
        self.state_vect_dim = 0
        self.max_iteration = int(max_iteration)
        self.state_threshold = float(state_threshold)

    def init_parameters(self, generator: torch.Generator) -> None:
        self.net_state.reset_parameters(generator)
        self.net_output.reset_parameters(generator)

    # -- unfolding -------------------------------------------------------------
    def _use_transposed(self, batch: GraphBatch) -> bool:
        """The feature-major engine for strip batches, and for plain-BCSR
        batches of narrow state, as the JAX package picks it by default."""
        if batch.strip is not None:
            return True
        if batch.bcsr is None:
            return False
        sd_pad = -(-batch.nodes.shape[1] // 8) * 8
        return sd_pad <= _TRANSPOSED_BCSR_MAX_STATE_DIM

    def _agg_arcs(self, batch: GraphBatch) -> torch.Tensor:
        if batch.agg_arc_labels is not None:
            return batch.agg_arc_labels
        return aggregate_edges(batch.arc_label, batch.arc_dst, batch.arcnode_weight, batch.num_nodes)

    def unfold(self, batch: GraphBatch, *, training: bool = False) -> Tuple[int, torch.Tensor]:
        """Run the unfolding to convergence.  Returns (k, state (N, d))."""
        if training:
            raise NotImplementedError("the training-mode unfolding is not ported yet")
        if self._use_transposed(batch):
            return self._unfold_transposed(batch)
        aggregated_arcs = self._agg_arcs(batch)
        state0 = batch.nodes

        def transition(state, aggregated=None):
            if aggregated is None:
                aggregated = batch.aggregate(state)
            inp = torch.cat([state, aggregated, aggregated_arcs], dim=1)
            return self.net_state.apply(inp, mask=batch.node_mask)

        return run_unfold_loops(self, batch, state0, torch.ones_like(state0), transition,
                                peel_agg=batch.agg_node_labels)

    def _unfold_transposed(self, batch: GraphBatch) -> Tuple[int, torch.Tensor]:
        """The unfolding on feature-major (d_pad, N) state: one transpose at
        entry and one at exit, none at the aggregation kernel."""
        n = batch.num_nodes
        sd = batch.nodes.shape[1]
        sd_pad = -(-sd // 8) * 8
        agg_arcs_t = self._agg_arcs(batch).T
        state0 = torch.zeros((sd_pad, n), dtype=batch.nodes.dtype, device=batch.device)
        state0[:sd] = batch.nodes.T
        # pad rows of the old state are zero, so threshold > 0 norms see the
        # row-major engine's sums
        state_old0 = torch.zeros_like(state0)
        state_old0[:sd] = 1.0

        def transition(state_t, aggregated=None):
            if aggregated is None:
                aggregated = aggregate_t(state_t, batch, sd)
            inp = torch.cat([state_t[:sd], aggregated, agg_arcs_t], dim=0)
            new_state = self.net_state.apply_t(inp, mask=batch.node_mask)
            if sd_pad != sd:
                new_state = F.pad(new_state, (0, 0, 0, sd_pad - sd))
            return new_state

        peel = None if batch.agg_node_labels is None else batch.agg_node_labels.T
        k, state_t = run_unfold_loops(self, batch, state0, state_old0, transition, peel_agg=peel, feature_axis=0)
        return k, state_t[:sd].T

    # -- fused whole-unfold route (ops/fused.py) --------------------------------
    def fold_transition(self):
        """Fold the state net's inference BatchNorm into its Dense layer and
        split the weight rows by the transition-input layout
        ``[state | Σ_neigh state | Σ_in arc labels]``.  Returns
        ``(w_state, w_agg, w_arc, bias, activation)``, or None when the net
        is not one Dense layer behind an optional BatchNorm and dropout."""
        from gnnkeras_tpu_torch.models.mlp import _BN_EPS
        from gnnkeras_tpu_torch.ops.fused import _ACTIVATIONS

        program = self.net_state.program
        dense_idx = [i for i, l in enumerate(program) if l[0] == "dense"]
        if len(dense_idx) != 1 or dense_idx[0] != len(program) - 1:
            return None
        if any(l[0] not in ("batch_norm", "dropout") for l in program[:-1]):
            return None
        bn_idx = [i for i, l in enumerate(program) if l[0] == "batch_norm"]
        if len(bn_idx) > 1:
            return None
        act = program[-1][2]
        if act is None:
            act = "linear"
        if not isinstance(act, str) or act not in _ACTIVATIONS:
            return None
        layers = self.net_state.layers
        w = layers[-1].kernel
        b = layers[-1].bias
        if bn_idx:
            bn = layers[bn_idx[0]]
            scale = bn.gamma * torch.rsqrt(bn.moving_var + _BN_EPS)
            shift = bn.beta - bn.moving_mean * scale
            b = b + shift @ w
            w = scale[:, None] * w
        d = w.shape[1]
        if w.shape[0] - 2 * d < 0:
            return None
        return w[:d], w[d : 2 * d], w[2 * d :], b, act

    # -- output ----------------------------------------------------------------
    def readout_input(self, state: torch.Tensor, batch: GraphBatch):
        """(net_output input rows, row mask): the converged state, one row
        per node."""
        return state, batch.output_row_mask

    def node_level_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False):
        x, row_mask = self.readout_input(state, batch)
        return self.net_output.apply(x, training=training, mask=row_mask), row_mask

    def apply_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False):
        """Focus-specific output: (out, out_mask)."""
        return self.node_level_output(state, batch, training=training)

    def forward(self, batch: GraphBatch, *, training: bool = False):
        """Full forward: (k, state, out, out_mask); ``out`` is row-aligned with
        the focus entity and gated by ``out_mask``."""
        if training:
            raise NotImplementedError("the training forward is not ported yet")
        with torch.no_grad():
            k, state = self.unfold(batch)
            out, out_mask = self.apply_output(state, batch)
        return k, state, out, out_mask

    def __repr__(self):
        return (
            f"GNN(type={self.name}, state_dim={self.state_vect_dim}, "
            f"threshold={self.state_threshold}, max_iter={self.max_iteration})"
        )


class GNNgraphBased(GNNnodeBased):
    """Graph-focused GNN: node outputs averaged per graph through the
    NodeGraph weights."""

    name = "graph"

    def apply_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False):
        out_nodes, _ = self.node_level_output(state, batch, training=training)
        return batch.readout(out_nodes), batch.graph_mask
