"""Expert parallelism over a composite GNN's per-node-type state nets, the
counterpart of ``gnnkeras_tpu.parallel.expert``.

The per-type state nets of a composite GNN are experts routed by node type.
This module shards them over the ranks of an ``expert`` process group:

- every type's net is padded to one input width and stacked
  (``stack_expert_params``): its first Dense kernel and first BatchNorm get
  zero rows inserted after the type's label width, so every expert reads
  ``[label (zero-padded to the widest) | state | Σstate | per-type label
  sums | Σarcs]``; the padded rows read zero features and add nothing, and
  their gradient is zero;
- the expert axis is padded to a multiple of the group size with experts of
  zero parameters (and a zero type mask), so 3 types on 4 ranks give rank 3
  an expert that adds nothing and learns nothing;
- rank r holds the experts ``[r·t_local, (r+1)·t_local)`` as padded MLPs,
  builds only their label slices, runs them over all node rows with their
  BatchNorm moments over their type's rows, and sums their masked outputs;
  ``collectives.psum`` completes the new state on every rank.  The loop is
  the shared ``models.gnn.run_unfold_loops``, in the engine the wrapped model
  picks for the batch (feature-major on a strip batch, so the strip kernel
  aggregates);
- the output head and the graph data are replicated.

Gradients: the collectives transpose as the JAX package's do (the backward
of ``psum`` sums the ranks' cotangents), so each rank's autograd of its own
objective computes the gradient of the sum of the D ranks' objectives.  With
the objective ``data_loss/D + reg(local experts) + reg(out)/D`` the expert
gradients come out exact as they are (divided by max(k, 1) under
``average_st_grads``) and the output head's are summed over the group; each
rank keeps the optimizer state of its own experts and of the head.

Randomness: the wrapped model draws its initial state, then per iteration
every type's dropout masks in type order, then the head's, from one
generator.  A rank draws the same sequence: it runs its experts at their
place in the order and draws, and drops, the masks of the types it does not
hold (the same shapes), so a dropout step matches the single device.
Padded experts draw nothing.  (An expert whose dropout precedes its first
Dense draws at the padded width, and then does not match.)

``fit`` runs the single-device fit surface through
``training/fit_loop.run_fit_loop``: validation (scored by ``evaluate`` with
the sharded experts), callbacks, ``class_weight``, ``validation_freq`` and
checkpoints.  Every rank writes its own checkpoint (the wrapped model,
synchronised every epoch, and the rank's optimizer state) under
``checkpoint_dir/expert_rank{r}_of_{D}`` and resumes from it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gnnkeras_tpu_torch.models.mlp import MLP, skip_dropout_draws
from gnnkeras_tpu_torch.parallel.pipeline import _insert_rows, _strip_rows


def _check_same_program(mlps) -> None:
    """Refuse per-type nets that differ in their layer program (units,
    activations, regularizers: named ones by value, callables by
    presence)."""

    def reg_key(r):
        return r if isinstance(r, (str, type(None))) else "<callable>"

    progs = [[(l[0],) + ((l[1], l[2], reg_key(l[5]), reg_key(l[6])) if l[0] == "dense" else ()) for l in m.program]
             for m in mlps]
    if any(p != progs[0] for p in progs[1:]):
        raise ValueError("expert parallelism requires all per-type MLPs to share the same layer program "
                         "(units, activations, regularizers)")


def _width_keys(mlp) -> set:
    """The state-dict keys whose leading axis is the input width: the first
    BatchNorm's leaves when it precedes the first Dense, and the first Dense
    kernel."""
    keys = set()
    for i, layer in enumerate(mlp.program):
        if layer[0] == "batch_norm":
            keys.update(f"layers.{i}.{leaf}" for leaf in ("gamma", "beta", "moving_mean", "moving_var"))
        elif layer[0] == "dense":
            keys.add(f"layers.{i}.kernel")
            break
    return keys


def stack_expert_params(mlps, state_dicts: List[Dict[str, torch.Tensor]], n_pad_types: int,
                        label_widths: Optional[List[int]] = None):
    """The per-type nets' state dicts (``layers.{i}.kernel``, ...) stacked
    along a new leading expert axis of ``n_pad_types`` entries: the
    width-dependent leaves (first Dense kernel, first BatchNorm) zero-padded
    to the widest type, the padding inserted after the type's label width
    (``label_widths``, the per-type ``dim_node_label``) or, without it,
    appended; the entries past the types all zero.  Returns (stacked, w_max)."""
    _check_same_program(mlps)
    widths = [m.input_dim[0] for m in mlps]
    w_max = max(widths)
    wide = _width_keys(mlps[0])
    padded = []
    for t, sd in enumerate(state_dicts):
        at = label_widths[t] if label_widths is not None else widths[t]
        padded.append({k: _insert_rows(v, at, w_max - widths[t], 0) if k in wide else v for k, v in sd.items()})
    while len(padded) < n_pad_types:
        padded.append({k: torch.zeros_like(v) for k, v in padded[0].items()})
    return {k: torch.stack([p[k] for p in padded]) for k in padded[0]}, w_max


def unstack_expert_params(mlps, stacked: Dict[str, torch.Tensor],
                          label_widths: Optional[List[int]] = None) -> List[Dict[str, torch.Tensor]]:
    """The inverse of ``stack_expert_params``: each real type's state dict,
    its padding rows removed (the padded experts dropped)."""
    widths = [m.input_dim[0] for m in mlps]
    w_max = max(widths)
    wide = _width_keys(mlps[0])
    out = []
    for t in range(len(mlps)):
        at = label_widths[t] if label_widths is not None else widths[t]
        out.append({k: _strip_rows(v[t], at, w_max - widths[t], 0) if k in wide else v[t] for k, v in stacked.items()})
    return out


class ExpertParallelCompositeGNN:
    """The expert-parallel engine around a built composite GNN
    (``models/composite.py``), run by every rank of the ``axis`` group of
    ``mesh`` (default: the world) with the same model weights, the same
    batches and the same generators."""

    def __init__(self, cgnn, mesh=None, axis: str = "expert"):
        from gnnkeras_tpu_torch.parallel.mesh import axis_group

        if getattr(cgnn, "per_iteration_bn", False):
            raise ValueError("per_iteration_bn models are not supported by ExpertParallelCompositeGNN "
                             "(the wrapper re-implements the unfold with shared BatchNorm moments)")
        if not isinstance(getattr(cgnn, "net_state", None), nn.ModuleList):
            raise ValueError("ExpertParallelCompositeGNN shards the per-type state nets of a composite GNN")
        _check_same_program(cgnn.net_state)
        self.cgnn = cgnn
        self.axis = axis
        self.group = axis_group(mesh, axis)
        self.n_devices = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.n_types = len(cgnn.net_state)
        self.types_pad = -(-self.n_types // self.n_devices) * self.n_devices
        self.t_local = self.types_pad // self.n_devices
        self.local_types = list(range(self.rank * self.t_local, (self.rank + 1) * self.t_local))
        self.w_max = max(m.input_dim[0] for m in cgnn.net_state)
        self.experts: Optional[nn.ModuleList] = None  # this rank's padded experts, built at the first batch
        self._label_widths: Optional[List[int]] = None
        self._opt = None

    # -- the experts ------------------------------------------------------------
    def _ensure_stacked(self, batch) -> None:
        if self.experts is None:
            self.cgnn.build()
            self._label_widths = [int(d) for d in batch.dim_node_label]
            config = {**self.cgnn.net_state[0].get_config(), "input_dim": (self.w_max,)}
            self.experts = nn.ModuleList([MLP.from_config(config) for _ in self.local_types]).to(self.cgnn.device)
            self.restack()

    def restack(self) -> None:
        """Load this rank's experts from the wrapped model's per-type nets
        (in place: the optimizer keeps its parameters)."""
        stacked, _ = stack_expert_params(self.cgnn.net_state, [net.state_dict() for net in self.cgnn.net_state],
                                         self.types_pad, self._label_widths)
        with torch.no_grad():
            for j, t in enumerate(self.local_types):
                self.experts[j].load_state_dict({k: v[t] for k, v in stacked.items()})

    def sync_to_model(self) -> None:
        """Write every rank's trained experts (weights and moving
        statistics) into the wrapped model's per-type nets on every rank (a
        collective), so its ``save`` / ``predict`` / ``evaluate`` and further
        single-device training see the expert-parallel training."""
        if self.experts is None:
            return
        mine = [{k: v.detach().cpu() for k, v in e.state_dict().items()} for e in self.experts]
        everyone = [None] * self.n_devices
        dist.all_gather_object(everyone, mine, group=self.group)
        flat = [sd for rank_sds in everyone for sd in rank_sds]
        stacked = {k: torch.stack([sd[k] for sd in flat]) for k in flat[0]}
        with torch.no_grad():
            for net, sd in zip(self.cgnn.net_state,
                               unstack_expert_params(self.cgnn.net_state, stacked, self._label_widths)):
                net.load_state_dict(sd)

    def _nodes_by_type(self, batch) -> List[torch.Tensor]:
        """This rank's experts' label slices (N, d_max): type t's label
        columns zero-padded to the widest label (zeros for a padded
        expert)."""
        d_max = max(self._label_widths)
        out = []
        for t in self.local_types:
            if t < self.n_types:
                d_t = self._label_widths[t]
                out.append(F.pad(batch.nodes[:, :d_t], (0, d_max - d_t)))
            else:
                out.append(batch.nodes.new_zeros((batch.num_nodes, d_max)))
        return out

    def _type_masks(self, batch) -> List[torch.Tensor]:
        return [batch.type_mask[:, t] & batch.node_mask if t < self.n_types else torch.zeros_like(batch.node_mask)
                for t in self.local_types]

    # -- the forward --------------------------------------------------------------
    def _local_forward(self, batch, training: bool, generator: Optional[torch.Generator]):
        """(k, state (N, d), out, out_mask, the experts' new moving
        statistics keyed ``{t}.layers.{i}.…``, the head's) on this rank; the
        state and output are the same on every rank."""
        from gnnkeras_tpu_torch.models.gnn import aggregate_t, group_predicate, run_unfold_loops
        from gnnkeras_tpu_torch.parallel.collectives import psum

        gnn, group = self.cgnn, self.group
        gnn._check_batch(batch)
        feature_major = gnn._use_transposed(batch)
        n = batch.num_nodes
        ds = gnn.state_vect_dim
        sd = ds or batch.nodes.shape[1]
        sd_pad = -(-sd // 8) * 8 if feature_major else sd
        component = gnn._aggregated_component(batch)
        labels, masks = self._nodes_by_type(batch), self._type_masks(batch)
        if feature_major:
            component, labels = component.T, [x.T for x in labels]
        first = gnn._initial_state(batch, generator) if ds > 0 else batch.nodes
        lo = self.local_types[0]

        def transition(state, bn, aggregated=None):
            if feature_major:
                if aggregated is None:
                    aggregated = aggregate_t(state, batch, sd)
                tail = torch.cat([state[:sd], aggregated, component], dim=0)
            else:
                if aggregated is None:
                    aggregated = batch.aggregate(state)
                tail = torch.cat([state, aggregated, component], dim=1)
            partial = tail.new_zeros((sd, n) if feature_major else (n, sd))
            new_bn = {}
            for t in range(self.types_pad):
                if t not in self.local_types:
                    if t < self.n_types and training and generator is not None:
                        skip_dropout_draws(gnn.net_state[t], n, feature_major, generator)
                    continue
                j = t - lo
                inp = torch.cat([labels[j], tail], dim=0 if feature_major else 1)
                out_t, bn_t = self.experts[j].run(inp, feature_major=feature_major, training=training, mask=masks[j],
                                                  generator=generator if t < self.n_types else None,
                                                  bn_state=gnn._of_type(bn, t))
                gate = masks[j][None, :] if feature_major else masks[j][:, None]
                partial = partial + torch.where(gate, out_t, 0.0)
                new_bn.update({f"{t}.{key}": value for key, value in bn_t.items()})
            new_state = psum(partial, group)
            if feature_major and sd_pad != sd:
                new_state = F.pad(new_state, (0, 0, 0, sd_pad - sd))
            return new_state, new_bn

        bn0 = {f"{t}.{key}": value for j, t in enumerate(self.local_types)
               for key, value in self.experts[j].bn_state().items()}
        if feature_major:
            state0 = F.pad(first.T, (0, 0, 0, sd_pad - sd)).contiguous()
            state_old0 = torch.zeros_like(state0)
            state_old0[:sd] = 1.0  # the padded rows' zeros keep the row-major norms
            peel = None if ds > 0 or batch.agg_node_labels is None else batch.agg_node_labels.T
        else:
            state0, state_old0 = first, torch.ones_like(first)
            peel = batch.agg_node_labels if ds == 0 else None
        # the state is the same on every rank; the flag's maximum keeps their trip counts equal
        k, state, bn = run_unfold_loops(gnn, batch, state0, state_old0, bn0, transition, training, peel_agg=peel,
                                        feature_axis=0 if feature_major else 1, predicate=group_predicate(group))
        if feature_major:
            state = state[:sd].T
        out, out_mask, bn_out = gnn.apply_output(state, batch, training=training, generator=generator)
        return k, state, out, out_mask, bn, bn_out

    def forward(self, batch, training: bool = False, generator: Optional[torch.Generator] = None):
        """(k, state, out, out_mask) without gradients: the wrapped model's
        forward, the same on every rank; the moving statistics are not
        written."""
        self._ensure_stacked(batch)
        if generator is None and (training or self.cgnn.state_vect_dim > 0):
            generator = self.cgnn.next_rng()
        with torch.no_grad():
            k, state, out, out_mask, _, _ = self._local_forward(batch, training, generator)
        return k, state, out, out_mask

    # -- training ----------------------------------------------------------------
    def _optimizer(self):
        if self._opt is None:
            self._opt = self.cgnn.optimizer([*self.experts.parameters(), *self.cgnn.net_output.parameters()])
        return self._opt

    def train_step(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step on this rank's experts and the replicated head
        (module docstring).  Returns the loss (data plus every expert's and
        the head's regularisation, equal on every rank), ``k`` and the
        metrics' sums and counts, as 0-dim device tensors."""
        from gnnkeras_tpu_torch.parallel.collectives import psum, psum_grads
        from gnnkeras_tpu_torch.training.losses import masked_mean
        from gnnkeras_tpu_torch.training.metrics import get_metric

        gnn, D = self.cgnn, self.n_devices
        if gnn.loss is None or gnn.optimizer is None:
            raise RuntimeError("compile() the wrapped composite model before training")
        self._ensure_stacked(batch)
        opt = self._optimizer()
        if generator is None:
            generator = gnn.next_rng()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            k, _, out, _, bn_e, bn_o = self._local_forward(batch, True, generator)
            data_loss = masked_mean(gnn.loss(batch.targets, out), batch.target_mask, batch.sample_weight)
            reg_e = sum(e.regularization_loss() for e in self.experts)
            reg_o = gnn.net_output.regularization_loss()
            (data_loss / D + reg_e + reg_o / D).backward()
        psum_grads(list(gnn.net_output.parameters()), self.group)  # the tied head: its whole gradient
        if gnn.average_st_grads:
            denom = torch.clamp_min(torch.as_tensor(k, dtype=torch.float32), 1.0)
            for p in self.experts.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
        opt.step()
        with torch.no_grad():
            for j, t in enumerate(self.local_types):
                buffers = dict(self.experts[j].named_buffers())
                for key, value in gnn._of_type(bn_e, t).items():
                    buffers[key].copy_(value)
            buffers = dict(gnn.net_output.named_buffers())
            for key, value in bn_o.items():
                buffers[key].copy_(value)
            loss = data_loss.detach() + psum(reg_e.detach().reshape(1), self.group)[0] + reg_o.detach()
            logs = {"loss": loss, "k": k}
            for spec in gnn.metrics:
                name, fn = get_metric(spec)
                logs[f"{name}_sum"], logs[f"{name}_count"] = fn(batch.targets, out.detach(), batch.target_mask,
                                                                batch.sample_weight)
        return logs

    def evaluate(self, sequencer, verbose: int = 0) -> dict:
        """Loss and metrics over a sequencer with the sharded experts
        (inference mode, moving statistics), equal on every rank."""
        from gnnkeras_tpu_torch.training.metrics import get_metric

        gnn = self.cgnn
        if gnn.loss is None:
            raise RuntimeError("compile() the wrapped composite model before evaluate()")
        loss_sum = count = 0.0
        sums = {get_metric(spec)[0]: [0.0, 0.0] for spec in gnn.metrics}
        for i in range(len(sequencer)):
            batch = sequencer[i]
            _, _, out, _ = self.forward(batch, training=False)
            with torch.no_grad():
                m = batch.target_mask.to(out.dtype)
                loss_sum += float(torch.sum(gnn.loss(batch.targets, out) * batch.sample_weight * m))
                count += float(torch.sum(m))
                for spec in gnn.metrics:
                    name, fn = get_metric(spec)
                    s, c = fn(batch.targets, out, batch.target_mask, batch.sample_weight)
                    sums[name][0] += float(s)
                    sums[name][1] += float(c)
        logs = {"loss": loss_sum / max(count, 1.0)}
        for name, (s, c) in sums.items():
            logs[name] = s / max(c, 1.0)
        if verbose and self.rank == 0:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
        return logs

    def fit(self, sequencer, epochs: int = 1, verbose: int = 1, seed: int = 0, *, validation_data=None,
            callbacks: Optional[list] = None, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False, class_weight: Optional[dict] = None, validation_freq: int = 1):
        """Expert-parallel training over a composite sequencer with the
        single-device fit surface (module docstring).  The experts are
        written into the wrapped model after every epoch
        (``sync_to_model``).  Returns a ``History``; rank 0 prints with
        ``verbose``."""
        from gnnkeras_tpu_torch.parallel.collectives import agree_logs
        from gnnkeras_tpu_torch.parallel.data_parallel import sync_numpy_stream
        from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop
        from gnnkeras_tpu_torch.training.metrics import get_metric
        from gnnkeras_tpu_torch.training.trainer import _apply_class_weight, _class_weight_vector

        gnn = self.cgnn
        if gnn.optimizer is None:
            raise RuntimeError("compile() the wrapped composite model before fit()")
        gnn.build(seed=seed)
        sync_numpy_stream(self.group)  # every rank shuffles as rank 0
        self._ensure_stacked(sequencer[0])
        cw_vec = _class_weight_vector(class_weight, gnn.device) if class_weight else None
        metric_names = [get_metric(spec)[0] for spec in gnn.metrics]

        def run_epoch(epoch, n):
            losses, sums = [], {name: [0.0, 0.0] for name in metric_names}
            for i in range(len(sequencer)):
                batch = sequencer[i]
                if cw_vec is not None:
                    batch = _apply_class_weight(batch, cw_vec)
                logs = self.train_step(batch, gnn.next_rng())
                losses.append(float(logs["loss"]))
                for name in metric_names:
                    sums[name][0] += float(logs[f"{name}_sum"])
                    sums[name][1] += float(logs[f"{name}_count"])
            sequencer.on_epoch_end()
            self.sync_to_model()
            ep_logs = {"loss": sum(losses) / max(len(losses), 1)}
            ep_logs.update({name: s / max(c, 1.0) for name, (s, c) in sums.items()})
            return [agree_logs(ep_logs, self.group)]

        validate = None
        if validation_data is not None:
            validate = lambda: agree_logs({f"val_{k}": v for k, v in self.evaluate(validation_data).items()},
                                          self.group)
        if checkpoint_dir is not None:
            checkpoint_dir = os.path.join(checkpoint_dir, f"expert_rank{self.rank}_of_{self.n_devices}")
        # the checkpoints carry this rank's optimizer (its experts' and the head's state)
        saved_opt, gnn._opt = gnn._opt, self._optimizer()
        try:
            return run_fit_loop(
                gnn, epochs=epochs, run_chunk=run_epoch, validate=validate, callbacks=callbacks,
                verbose=verbose if self.rank == 0 else 0, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume, validation_freq=validation_freq,
                on_resume=self.restack, on_weights_mutated=self.restack,
            )
        finally:
            gnn._opt = saved_opt
            wait = getattr(sequencer, "wait_for_rebuild", None)
            if wait is not None:
                wait()
