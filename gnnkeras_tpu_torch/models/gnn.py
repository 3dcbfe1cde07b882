"""Homogeneous GNN models: the iterate-to-convergence unfolding engine,
counterpart of ``gnnkeras_tpu.models.gnn``.

One unfolding loop, two modes (``run_unfold_loops``):

- inference: a Python ``while`` loop with the reference's early exit, run
  while some real node's state moved more than ``threshold·‖old‖₂`` and
  ``k < max_iteration`` (one host read of the flag per iteration);
- training: exactly ``max_iteration`` steps with a device-side ``running``
  flag, ``state ← where(running, new, state)``, the state net's moving
  BatchNorm statistics carried step to step and kept only while running,
  and ``k`` (a device float) counting the running steps.  The flag is never
  read on the host inside the loop; autograd differentiates through the
  steps (activations are stored, no rematerialisation).

``fixed_length=True`` runs inference in the training loop's shape (no host
read of the flag, BatchNorm on its moving statistics, ``k`` a device
scalar), with the same state as the ``while`` loop at every threshold: the
form ``torch.export`` can trace (``serving.export_forward``).

With ``per_iteration_bn`` the state net keeps one set of moving statistics
per iteration ((K, f) buffers): training reads and writes set k at step k,
inference reads set min(k, K − 1).

``dim_state == 0``: the state is the node label, and iteration 0 is peeled
from the batch's host-precomputed ``Adjᵀ·labels``, so a forward of k
iterations aggregates k − 1 times.  ``dim_state > 0``: the state starts as
N(0, 0.1²) noise drawn by ``initial_state`` from the caller's generator,
the transition input is ``[state | labels | Σstate | Σlabels | Σarcs]`` and
the readout input ``[state | labels]``; nothing is peeled.

Two engines, picked per batch as in the JAX package (``_use_transposed``):
row-major (N, d) state through ``GraphBatch.aggregate``, and feature-major
(d_pad, N) state through the strip kernel (``ops/strip.py``, slot 128 or
the slot-32/64 mixed format), the banded decomposition (``ops/banded.py``),
quantised BCSR (``ops/bcsr.py``, kernel row 8) or the dense-block BCSR.
Batches carrying a banded or quantised operator always run feature-major.  The arc-focused readout reads both endpoints' rows
through the incidence select and, backward, scatter kernels
(``ops/incidence.py``).  The LGNN and composite models come with later
slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch.graph.batch import GraphBatch
from gnnkeras_tpu_torch.models.base import GraphModel
from gnnkeras_tpu_torch.models.mlp import MLP
from gnnkeras_tpu_torch.ops.segment import aggregate_edges

STATE_INIT_STDDEV = 0.1  # the reference's random state init, N(0, 0.1²)

# plain-BCSR batches run feature-major while the padded state width is at
# most this (the JAX package's measured boundary, kept so both packages pick
# the same engine for the same batch)
_TRANSPOSED_BCSR_MAX_STATE_DIM = 32


def initial_state(n: int, ds: int, generator: torch.Generator, device) -> torch.Tensor:
    """The dim_state > 0 initial state: N(0, 0.1²) drawn in (n, ds) row
    order from ``generator``, on ``device`` (the generator's)."""
    return STATE_INIT_STDDEV * torch.randn((n, ds), generator=generator, device=device, dtype=torch.float32)


def unconverged_flag(state, state_old, node_mask, threshold: float, feature_axis: int = 1) -> torch.Tensor:
    """0-dim bool tensor: does any real node move more than
    ``threshold·‖old‖₂``?  ``feature_axis=0`` is feature-major (d_pad, N)
    state.  Stays on the device; carries no gradient."""
    state, state_old = state.detach(), state_old.detach()
    if threshold == 0.0:
        # ‖s − s_old‖₂ > 0 ⟺ some element changed
        changed = torch.any(state != state_old, dim=feature_axis)
    else:
        distance = torch.sqrt(torch.sum(torch.square(state - state_old), dim=feature_axis))
        norm = torch.sqrt(torch.sum(torch.square(state_old), dim=feature_axis))
        changed = distance > threshold * norm
    return torch.any(changed & node_mask)


def unconverged(state, state_old, node_mask, threshold: float, feature_axis: int = 1) -> bool:
    """``unconverged_flag`` read on the host."""
    return bool(unconverged_flag(state, state_old, node_mask, threshold, feature_axis))


def aggregate_t(state_t: torch.Tensor, batch: GraphBatch, sd: int) -> torch.Tensor:
    """Feature-major ``Adjᵀ·state`` through the strip operator when present,
    else the batch's block operator (banded decomposition, quantised BCSR or
    dense-block BCSR), sliced to the real feature rows."""
    if batch.strip is not None:
        from gnnkeras_tpu_torch.ops.strip import strip_aggregate_t

        agg = strip_aggregate_t(state_t, batch.strip)
    else:
        from gnnkeras_tpu_torch.ops.banded import BandedOperator, banded_aggregate_t
        from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr, bcsr_aggregate_t, qbcsr_aggregate_t

        if isinstance(batch.bcsr, BandedOperator):
            agg = banded_aggregate_t(state_t, batch.bcsr)
        elif isinstance(batch.bcsr, QuantBcsr):
            agg = qbcsr_aggregate_t(state_t, batch.bcsr)
        else:
            agg = bcsr_aggregate_t(state_t, batch.bcsr)
    return agg[:sd]


def run_unfold_loops(model, batch: GraphBatch, state0, state_old0, bn0, transition, training: bool,
                     peel_agg=None, feature_axis: int = 1, fixed_length: bool = False):
    """The one unfolding loop.  ``transition(state, bn_state, aggregated=None)``
    is one step returning (new state, new moving statistics); ``peel_agg``
    (``Adjᵀ·labels``) replaces the aggregation of iteration 0.  With
    ``model.per_iteration_bn`` the statistics in ``bn0`` are (K, f) stacks
    and step k takes slice k.  Returns (k, state, moving statistics): ``k``
    an int in inference, a 0-dim float tensor on the device in training and
    with ``fixed_length``."""
    K = model.max_iteration
    threshold = model.state_threshold
    mask = batch.node_mask
    per_iter = model.per_iteration_bn and K >= 1

    def take(i):
        return {key: value[i] for key, value in bn0.items()}

    if not training and not fixed_length:
        state, bn = state0, bn0
        changed = unconverged(state0, state_old0, mask, threshold, feature_axis)
        k = 0
        while changed and k < K:
            new_state, new_bn = transition(state, take(min(k, K - 1)) if per_iter else bn,
                                           peel_agg if k == 0 else None)
            if not per_iter:
                bn = new_bn
            changed = unconverged(new_state, state, mask, threshold, feature_axis)
            state, k = new_state, k + 1
        return k, state, bn

    running = unconverged_flag(state0, state_old0, mask, threshold, feature_axis)
    k = torch.zeros((), dtype=state0.dtype, device=state0.device)
    state, bn = state0, bn0
    per_step = []
    for step in range(K):
        bn_in = take(step) if per_iter else bn
        new_state, new_bn = transition(state, bn_in, peel_agg if step == 0 else None)
        changed = unconverged_flag(new_state, state, mask, threshold, feature_axis)
        state = torch.where(running, new_state, state)
        kept = {key: torch.where(running, new_bn[key], bn_in[key]) for key in bn_in}
        if per_iter:
            per_step.append(kept)
        else:
            bn = kept
        k = k + running.to(k.dtype)
        running = running & changed
    if per_iter:
        bn = {key: torch.stack([s[key] for s in per_step]) for key in bn0}
    return k, state, bn


def _prefixed(prefix: str, stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{key}": value for key, value in stats.items()}


class GNNnodeBased(GraphModel):
    """Node-focused GNN.  ``per_iteration_bn`` gives every unfolding
    iteration its own BatchNorm moving statistics (the JAX package's
    option; off is the reference's shared statistics)."""

    name = "node"

    def __init__(
        self,
        net_state: MLP,
        net_output: MLP,
        state_vect_dim: int,
        max_iteration: int,
        state_threshold: float,
        *,
        per_iteration_bn: bool = False,
    ) -> None:
        assert state_vect_dim >= 0
        assert max_iteration >= 0
        assert state_threshold >= 0
        super().__init__()
        self.net_state = net_state
        self.net_output = net_output
        self.state_vect_dim = int(state_vect_dim)
        self.max_iteration = int(max_iteration)
        self.state_threshold = float(state_threshold)
        self.per_iteration_bn = bool(per_iteration_bn)
        if self.per_iteration_bn:
            self.net_state.stack_bn_state(max(self.max_iteration, 1))

    def init_parameters(self, generator: torch.Generator) -> None:
        self.net_state.reset_parameters(generator)
        self.net_output.reset_parameters(generator)

    def scale_state_grads(self, k: torch.Tensor) -> None:
        """The reference's ``average_st_grads``: divide the state net's
        gradients, in place, by max(k, 1) (``k`` may stay on the device)."""
        denom = torch.clamp_min(torch.as_tensor(k, dtype=torch.float32), 1.0)
        for p in self.net_state.parameters():
            if p.grad is not None:
                p.grad.div_(denom)

    def regularization_loss(self) -> torch.Tensor:
        return self.net_state.regularization_loss() + self.net_output.regularization_loss()

    # -- unfolding -------------------------------------------------------------
    def _use_transposed(self, batch: GraphBatch) -> bool:
        """The feature-major engine for strip batches and for batches with a
        banded or quantised operator (built for it), and for plain-BCSR
        batches of narrow state, as the JAX package picks it by default."""
        from gnnkeras_tpu_torch.ops.banded import BandedOperator
        from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr

        if batch.strip is not None or isinstance(batch.bcsr, (BandedOperator, QuantBcsr)):
            return True
        if batch.bcsr is None:
            return False
        sd = self.state_vect_dim or batch.nodes.shape[1]
        return -(-sd // 8) * 8 <= _TRANSPOSED_BCSR_MAX_STATE_DIM

    def _agg_arcs(self, batch: GraphBatch) -> torch.Tensor:
        if batch.agg_arc_labels is not None:
            return batch.agg_arc_labels
        return aggregate_edges(batch.arc_label, batch.arc_dst, batch.arcnode_weight, batch.num_nodes)

    def _agg_nodes(self, batch: GraphBatch) -> torch.Tensor:
        if batch.agg_node_labels is not None:
            return batch.agg_node_labels
        return batch.aggregate(batch.nodes)

    def _initial_state(self, batch: GraphBatch, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The dim_state > 0 random state₀ (n, ds), row-major."""
        if generator is None:
            raise ValueError("state_vect_dim > 0 requires a generator for the random state init")
        return initial_state(batch.num_nodes, self.state_vect_dim, generator, batch.device)

    def unfold(self, batch: GraphBatch, *, training: bool = False, generator: Optional[torch.Generator] = None,
               fixed_length: bool = False):
        """Run the unfolding.  Returns (k, state (N, d), the state net's new
        moving statistics); see ``run_unfold_loops`` for ``k`` and
        ``fixed_length``."""
        if self._use_transposed(batch):
            return self._unfold_transposed(batch, training, generator, fixed_length)
        aggregated_arcs = self._agg_arcs(batch)
        if self.state_vect_dim > 0:
            state0 = self._initial_state(batch, generator)
            constants = [batch.nodes]  # [state | labels | Σstate | Σlabels | Σarcs]
            tail = [self._agg_nodes(batch), aggregated_arcs]
            peel = None
        else:
            state0 = batch.nodes
            constants, tail = [], [aggregated_arcs]
            peel = batch.agg_node_labels

        def transition(state, bn, aggregated=None):
            if aggregated is None:
                aggregated = batch.aggregate(state)
            inp = torch.cat([state, *constants, aggregated, *tail], dim=1)
            return self.net_state.run(inp, feature_major=False, training=training, mask=batch.node_mask,
                                      generator=generator, bn_state=bn)

        return run_unfold_loops(self, batch, state0, torch.ones_like(state0), self.net_state.bn_state(),
                                transition, training, peel_agg=peel, fixed_length=fixed_length)

    def _unfold_transposed(self, batch: GraphBatch, training: bool, generator: Optional[torch.Generator],
                           fixed_length: bool = False):
        """The unfolding on feature-major (d_pad, N) state: one transpose at
        entry and one at exit, none at the aggregation kernel."""
        n = batch.num_nodes
        ds = self.state_vect_dim
        sd = ds or batch.nodes.shape[1]
        sd_pad = -(-sd // 8) * 8
        agg_arcs_t = self._agg_arcs(batch).T
        state0 = torch.zeros((sd_pad, n), dtype=batch.nodes.dtype, device=batch.device)
        if ds > 0:
            # the row-major engine's draw, transposed once at entry
            state0[:sd] = self._initial_state(batch, generator).T
            constants, tail = [batch.nodes.T], [self._agg_nodes(batch).T, agg_arcs_t]
            peel = None
        else:
            state0[:sd] = batch.nodes.T
            constants, tail = [], [agg_arcs_t]
            peel = None if batch.agg_node_labels is None else batch.agg_node_labels.T
        # pad rows of the old state are zero, so threshold > 0 norms see the
        # row-major engine's sums
        state_old0 = torch.zeros_like(state0)
        state_old0[:sd] = 1.0

        def transition(state_t, bn, aggregated=None):
            if aggregated is None:
                aggregated = aggregate_t(state_t, batch, sd)
            inp = torch.cat([state_t[:sd], *constants, aggregated, *tail], dim=0)
            new_state, new_bn = self.net_state.run(inp, feature_major=True, training=training,
                                                   mask=batch.node_mask, generator=generator, bn_state=bn)
            if sd_pad != sd:
                new_state = F.pad(new_state, (0, 0, 0, sd_pad - sd))
            return new_state, new_bn

        k, state_t, bn = run_unfold_loops(self, batch, state0, state_old0, self.net_state.bn_state(), transition,
                                          training, peel_agg=peel, feature_axis=0, fixed_length=fixed_length)
        return k, state_t[:sd].T, bn

    # -- fused whole-unfold route (ops/fused.py) --------------------------------
    def fold_transition(self):
        """Fold the state net's inference BatchNorm into its Dense layer and
        split the weight rows by the transition-input layout
        ``[state | Σ_neigh state | Σ_in arc labels]``.  Returns
        ``(w_state, w_agg, w_arc, bias, activation)``, or None when the net
        is not one Dense layer behind an optional BatchNorm and dropout, or
        at dim_state > 0 or with per-iteration statistics (one folded weight
        set cannot carry K moment sets)."""
        from gnnkeras_tpu_torch.models.mlp import _BN_EPS
        from gnnkeras_tpu_torch.ops.fused import _ACTIVATIONS

        if self.state_vect_dim != 0 or self.per_iteration_bn:
            return None
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

    def forward_fused(self, batch: GraphBatch, op, n_iter: Optional[int] = None):
        """Inference forward with the whole unfolding in one launch of the
        row-major ``fused_unfold`` kernel (``ops/fused.py``): for tile-packed
        batches whose every edge lies in its tile (``op`` from
        ``build_fused_diag``), dim_state 0 and the single-Dense state net.
        ``n_iter`` (default ``max_iteration``) steps run whatever the
        threshold.  Returns (state, out, out_mask)."""
        from gnnkeras_tpu_torch.ops.fused import fused_unfold

        folded = self.fold_transition()
        if folded is None:
            raise ValueError("state net / model config is not fusable (see fold_transition)")
        if batch.agg_arc_labels is None:
            raise ValueError("fused forward needs the precomputed agg_arc_labels")
        w_state, w_agg, w_arc, bias, act = folded
        with torch.no_grad():
            const = batch.agg_arc_labels @ w_arc + bias
            state = fused_unfold(batch.nodes, const, w_state, w_agg, op,
                                 self.max_iteration if n_iter is None else n_iter, act)
            out, out_mask, _ = self.apply_output(state, batch)
        return state, out, out_mask

    # -- output ----------------------------------------------------------------
    def readout_input(self, state: torch.Tensor, batch: GraphBatch):
        """(net_output input rows, row mask): the converged state (| labels
        at dim_state > 0), one row per node."""
        if self.state_vect_dim:
            state = torch.cat([state, batch.nodes], dim=1)
        return state, batch.output_row_mask

    def node_level_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False,
                          generator: Optional[torch.Generator] = None):
        """(net_output over the readout rows, row mask, net_output's new
        moving statistics)."""
        x, row_mask = self.readout_input(state, batch)
        out, new_bn = self.net_output.run(x, feature_major=False, training=training, mask=row_mask,
                                          generator=generator)
        return out, row_mask, new_bn

    def apply_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        """Focus-specific output: (out, out_mask, net_output's new moving
        statistics)."""
        return self.node_level_output(state, batch, training=training, generator=generator)

    def forward(self, batch: GraphBatch, *, training: bool = False, generator: Optional[torch.Generator] = None,
                fixed_length: bool = False):
        """Full forward: (k, state, out, out_mask, new moving statistics).
        ``out`` is row-aligned with the focus entity and gated by
        ``out_mask``; the statistics are keyed as in the state dict
        (``net_state.layers.0.moving_mean``, ...).  Inference runs without
        autograd and returns the current statistics; training
        differentiates and returns the updated ones (the buffers are not
        written).  ``generator`` draws the dropout masks in training.
        ``fixed_length`` selects the exportable inference loop
        (``run_unfold_loops``)."""
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            k, state, bn_state = self.unfold(batch, training=training, generator=generator,
                                             fixed_length=fixed_length)
            out, out_mask, bn_out = self.apply_output(state, batch, training=training, generator=generator)
        return k, state, out, out_mask, {**_prefixed("net_state", bn_state), **_prefixed("net_output", bn_out)}

    def __repr__(self):
        return (
            f"GNN(type={self.name}, state_dim={self.state_vect_dim}, "
            f"threshold={self.state_threshold}, max_iter={self.max_iteration})"
        )


class GNNarcBased(GNNnodeBased):
    """Arc-focused GNN: readout rows are ``[src state | dst state | arc
    label]``.  With the batch's incidence pairs and an f32 state, both
    endpoints' rows come from the select kernel and their gradient from the
    scatter kernel (``ops/incidence.py``); otherwise from a plain gather."""

    name = "arc"

    def readout_input(self, state: torch.Tensor, batch: GraphBatch):
        if self.state_vect_dim:
            state = torch.cat([state, batch.nodes], dim=1)
        if batch.arc_inc is not None and state.dtype == torch.float32:
            from gnnkeras_tpu_torch.ops.incidence import incidence_gather

            # the transposed engine hands back a view of its feature-major state
            s_rows, d_rows = incidence_gather(state.contiguous(), batch.num_arcs, batch.arc_inc)
        else:
            s_rows, d_rows = state[batch.arc_src.long()], state[batch.arc_dst.long()]
        return torch.cat([s_rows, d_rows, batch.arc_label], dim=1), batch.output_row_mask


class GNNgraphBased(GNNnodeBased):
    """Graph-focused GNN: node outputs averaged per graph through the
    NodeGraph weights."""

    name = "graph"

    def apply_output(self, state: torch.Tensor, batch: GraphBatch, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        out_nodes, _, new_bn = self.node_level_output(state, batch, training=training, generator=generator)
        return batch.readout(out_nodes), batch.graph_mask, new_bn
