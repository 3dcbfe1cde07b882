"""Pipeline parallelism: GPipe over an LGNN's layers, one rank of a
``stage`` process group per layer, the counterpart of
``gnnkeras_tpu.parallel.pipeline``.

Rank s holds layer s and its optimizer.  A step takes M microbatches:

- forward, for each microbatch in order: receive the previous stage's
  propagated features (its converged state and masked output: node rows,
  and arc rows for the arc focus), rebuild the layer input with the
  model's own ``LGNN.update_graph``, run the layer's unfolding and
  readout, and send the new features on;
- backward, for each microbatch in reverse order: receive the cotangent of
  the features sent on, backpropagate the stage's loss and that cotangent
  through the microbatch, and send the gradient of the features received
  back to the previous stage.  Stage 0 runs its layer on the batch itself
  and sends nothing back; the last stage receives no cotangent.

The JAX package runs ``M + S − 1`` ticks of one scan in which a stage
computes every tick and discards the inactive ones; those compute nothing
that counts, so here they are not run.  The point-to-point messages go
through host memory (gloo moves CPU tensors only; NCCL refuses two ranks
on one card) and are posted in one fixed order, receive before send in the
forward and send after backward in the reverse walk, so the stages cannot
deadlock: a stage waits on the host, never in a kernel.

The loss: each stage sums its layer's masked loss over the microbatches and
divides once by the total mask count (the full-batch masked mean, not a
mean of means).  The stage objective is ``layer_loss/S + reg(layer)``; the
sum over the stages is the single device's ``parallel`` loss, so each
stage's gradient, with the cotangents from the stages above, is that
loss's.  The logged loss is the group's sum.  Under ``average_st_grads``
the state net's gradient is divided by the stage's mean k over the
microbatches (exact at M = 1).  BatchNorm's moving statistics run through
the microbatches in order.

Randomness: the single-device LGNN forward draws, layer by layer, each
layer's initial state and dropout masks from one generator.  For each
microbatch a stage draws, and drops, the draws of the layers below it
(the same shapes), makes its own layer's, then drops those of the layers
above: with M = 1 its draws are the single device's step's.

Scope (as the JAX package): a homogeneous LGNN with dim_state > 0 (at
dim_state 0 the input widens layer by layer), one stage a layer.  Layer 0
reads narrower inputs than the layers above; ``stack_variables`` pads its
width-dependent leaves with zero rows at the propagated features'
positions, the JAX package's stacked layout.  Rank 0 runs layer 0 at its
own widths: that is exact, as the padded rows read zero features and get
zero gradient.  Arc-focused stacks need ``node_label_dim`` to locate them.

``fit`` runs the single-device fit surface through
``training/fit_loop.run_fit_loop``: each element of ``microbatch_lists``
is one step's microbatches; validation (a sequencer scored on the single
LGNN with the weights synchronised every epoch), callbacks,
``class_weight`` and checkpoints (every rank writes its own, the model and
its stage's optimizer state, under ``checkpoint_dir/stage{s}_of_{S}``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def _insert_rows(v: torch.Tensor, at: int, n: int, axis: int) -> torch.Tensor:
    if n == 0:
        return v
    shape = list(v.shape)
    shape[axis] = n
    return torch.cat([v.narrow(axis, 0, at), v.new_zeros(shape), v.narrow(axis, at, v.shape[axis] - at)], dim=axis)


def _strip_rows(v: torch.Tensor, at: int, n: int, axis: int) -> torch.Tensor:
    if n == 0:
        return v
    return torch.cat([v.narrow(axis, 0, at), v.narrow(axis, at + n, v.shape[axis] - at - n)], dim=axis)


class _Layer0Padding:
    """Row positions, in the coordinates of the layers above layer 0, where
    layer 0's width-dependent leaves lack the propagated features' rows.

    The state net reads ``[state | labels | Σstate | Σlabels | Σarcs]``;
    the node and graph focus prepend the propagated state and output to the
    labels (so to Σlabels too), the arc focus the state to the labels and
    the output to the arc labels.  The output net reads ``[state |
    labels]``, or ``[src state | src labels | dst state | dst labels | arc
    label]`` in the arc focus."""

    def __init__(self, lgnn, prop_node: int, prop_arc: int, node_label_dim: Optional[int] = None):
        ds = lgnn.gnns[0].state_vect_dim
        top = lgnn.gnns[-1]
        s1, s0 = top.net_state.input_dim[0], lgnn.gnns[0].net_state.input_dim[0]
        if s1 - s0 != 2 * prop_node + prop_arc:
            raise ValueError(f"layer-0/layers>=1 input widths do not line up with the propagated features: s0={s0}, "
                             f"s1={s1}, expected s1-s0 = 2*{prop_node}+{prop_arc} (wrong MLP dims or node_label_dim?)")
        if not lgnn._is_arc:
            wn = top.net_output.input_dim[0] - ds
            self.state_ins = [(ds, prop_node), (2 * ds + wn, prop_node)]
            self.output_ins = [(ds, prop_node)]
        else:
            if node_label_dim is None:
                raise ValueError("arc-focused pipeline stacks need node_label_dim (the raw t=0 node-label width) "
                                 "to locate layer-0's padding rows")
            wn = int(node_label_dim) + prop_node
            ext = ds + wn
            self.state_ins = [(ds, prop_node), (2 * ds + wn, prop_node), (2 * ds + 2 * wn, prop_arc)]
            self.output_ins = [(ds, prop_node), (ext + ds, prop_node), (2 * ext, prop_arc)]
        self.state_ins = [(at, w) for at, w in self.state_ins if w > 0]
        self.output_ins = [(at, w) for at, w in self.output_ins if w > 0]

    @staticmethod
    def _width_axis(shape, target_shape) -> int:
        axes = [i for i, (a, b) in enumerate(zip(shape, target_shape)) if a != b]
        if len(shape) != len(target_shape) or len(axes) != 1:
            raise ValueError(f"expected one width axis padding {tuple(shape)} to {tuple(target_shape)}")
        return axes[0]

    def pad(self, leaf: torch.Tensor, net: str, target_shape) -> torch.Tensor:
        axis = self._width_axis(leaf.shape, target_shape)
        v = leaf
        for at, w in (self.state_ins if net == "net_state" else self.output_ins):
            if v.shape[axis] == target_shape[axis]:
                break
            v = _insert_rows(v, at, w, axis)
        if v.shape[axis] != target_shape[axis]:
            raise ValueError(f"pad failed: {tuple(leaf.shape)} -> {tuple(target_shape)}")
        return v

    def strip(self, leaf: torch.Tensor, net: str, target_shape) -> torch.Tensor:
        axis = self._width_axis(leaf.shape, target_shape)
        v = leaf
        for at, w in reversed(self.state_ins if net == "net_state" else self.output_ins):
            if v.shape[axis] == target_shape[axis]:
                break
            v = _strip_rows(v, at, w, axis)
        if v.shape[axis] != target_shape[axis]:
            raise ValueError(f"strip failed: {tuple(leaf.shape)} -> {tuple(target_shape)}")
        return v


def _skip_layer_draws(gnn, batch, generator: torch.Generator) -> None:
    """Draw, and drop, what ``gnn`` draws in a training forward on
    ``batch`` (its initial state, then every iteration's state-net dropout
    masks, then the output net's), the same shapes from the same generator."""
    from gnnkeras_tpu_torch.models.mlp import skip_dropout_draws

    if gnn.state_vect_dim > 0:
        gnn._initial_state(batch, generator)
    for _ in range(gnn.max_iteration):
        skip_dropout_draws(gnn.net_state, batch.num_nodes, gnn._use_transposed(batch), generator)
    skip_dropout_draws(gnn.net_output, batch.num_arcs if gnn.name == "arc" else batch.num_nodes, False, generator)


class PipelineLGNN:
    """The GPipe engine around a built, compiled homogeneous ``LGNN``, one
    layer a rank of the ``axis`` group of ``mesh`` (default: the world).
    Every rank holds the whole model (equal weights), the same microbatches
    and the same generators; rank s trains layer s."""

    def __init__(self, lgnn, mesh=None, axis: str = "stage", node_label_dim: Optional[int] = None):
        from gnnkeras_tpu_torch.parallel.mesh import axis_group

        if not hasattr(lgnn, "gnns") or any(isinstance(g.net_state, nn.ModuleList) for g in lgnn.gnns):
            raise ValueError("PipelineLGNN pipelines the layers of a homogeneous LGNN")
        if lgnn.gnns[0].state_vect_dim <= 0:
            raise ValueError("pipeline parallelism needs dim_state > 0 (dim_state==0 grows the input width per "
                             "layer, so stages cannot share shapes)")
        self.lgnn = lgnn
        self.axis = axis
        self.group = axis_group(mesh, axis)
        self.n_stages = dist.get_world_size(self.group)
        if self.n_stages != lgnn.LAYERS:
            raise ValueError(f"axis '{axis}' has {self.n_stages} ranks but the LGNN has {lgnn.LAYERS} layers: "
                             "one stage a layer")
        self.stage = dist.get_rank(self.group)
        self.ds = lgnn.gnns[0].state_vect_dim
        go = lgnn.gnns[0].net_output.output_dim * lgnn.get_output
        # state → node labels; output → node labels (node, graph focus) or arc labels (arc focus)
        self.prop_node = self.ds * lgnn.get_state + (0 if lgnn._is_arc else go)
        self.prop_arc = go if lgnn._is_arc else 0
        self._padding = _Layer0Padding(lgnn, self.prop_node, self.prop_arc, node_label_dim)
        self._opt = None

    # -- variables ------------------------------------------------------------------
    def stack_variables(self) -> Dict[str, torch.Tensor]:
        """The layers' state dicts (``net_state.layers.{i}.kernel``, ...)
        stacked along a leading stage axis, layer 0's width-dependent leaves
        zero-padded to the shapes of the layers above."""
        layers = [g.state_dict() for g in self.lgnn.gnns]
        if len(layers) > 1:
            ref = layers[1]
            layers[0] = {k: v if v.shape == ref[k].shape else self._padding.pad(v, k.split(".")[0], ref[k].shape)
                         for k, v in layers[0].items()}
        return {k: torch.stack([sd[k] for sd in layers]) for k in layers[0]}

    def unstack_variables(self, stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of ``stack_variables``: the LGNN's state dict
        (``gnns.{l}.…``), layer 0's padding removed."""
        shapes0 = {k: v.shape for k, v in self.lgnn.gnns[0].state_dict().items()}
        out = {}
        for layer in range(self.lgnn.LAYERS):
            for k, v in stacked.items():
                leaf = v[layer]
                if layer == 0 and leaf.shape != shapes0[k]:
                    leaf = self._padding.strip(leaf, k.split(".")[0], shapes0[k])
                out[f"gnns.{layer}.{k}"] = leaf
        return out

    def sync_to_model(self) -> None:
        """Every stage's trained layer (weights and moving statistics) into
        the model on every rank: one broadcast from each layer's owner (a
        collective)."""
        for layer, gnn in enumerate(self.lgnn.gnns):
            tensors = [*gnn.parameters(), *gnn.buffers()]
            flat = torch.cat([t.detach().reshape(-1).cpu() for t in tensors])
            dist.broadcast(flat, src=dist.get_global_rank(self.group, layer), group=self.group)
            offset = 0
            with torch.no_grad():
                for t in tensors:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()

    # -- point to point ----------------------------------------------------------------
    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def _send(self, pieces: List[torch.Tensor], stage: int) -> None:
        flat = torch.cat([p.detach().reshape(-1).to("cpu", torch.float32) for p in pieces])
        dist.send(flat, dst=self._peer(stage), group=self.group)

    def _recv(self, shapes, stage: int, device) -> List[torch.Tensor]:
        flat = torch.empty(sum(int(torch.Size(s).numel()) for s in shapes), dtype=torch.float32)
        dist.recv(flat, src=self._peer(stage), group=self.group)
        out, offset = [], 0
        for s in shapes:
            n = int(torch.Size(s).numel())
            out.append(flat[offset:offset + n].view(s).to(device, copy=True))
            offset += n
        return out

    def _prop_shapes(self, batch) -> list:
        shapes = [(batch.num_nodes, self.prop_node)]
        if self.prop_arc:
            shapes.append((batch.num_arcs, self.prop_arc))
        return shapes

    def _layer_input(self, batch, prop: List[torch.Tensor]):
        """Layer s's batch from the features received: the model's
        ``update_graph`` with the previous layer's state and (already
        masked) output."""
        lgnn, ds = self.lgnn, self.ds
        node = prop[0]
        state = node[:, :ds] if lgnn.get_state else None
        if lgnn._is_arc:
            out = prop[1] if lgnn.get_output else None
        else:
            out = node[:, ds * lgnn.get_state:] if lgnn.get_output else None
        return lgnn.update_graph(batch, state, out, batch.output_row_mask)

    # -- the step ---------------------------------------------------------------------
    def _optimizer(self):
        if self._opt is None:
            self._opt = self.lgnn.optimizer(self.lgnn.gnns[self.stage].parameters())
        return self._opt

    def train_step(self, microbatches: Sequence, generator: Optional[torch.Generator] = None) -> dict:
        """One pipelined optimizer step over ``microbatches`` (module
        docstring); rank s updates layer s.  Returns {"loss", "k"} (the
        parallel-mode loss with every layer's regularisation, and the mean
        k over layers and microbatches), equal on every rank."""
        lgnn, S, s = self.lgnn, self.n_stages, self.stage
        if lgnn.optimizer is None or lgnn.loss is None:
            raise RuntimeError("compile() the LGNN before building the pipeline step")
        gnn = lgnn.gnns[s]
        opt = self._optimizer()
        if generator is None:
            generator = lgnn.next_rng()
        opt.zero_grad(set_to_none=True)
        records, num_total, den_total = [], [], []
        k_sum = torch.zeros((), dtype=torch.float32, device=gnn.device)
        microbatches = list(microbatches)
        for batch in microbatches:
            for below in lgnn.gnns[:s]:
                _skip_layer_draws(below, batch, generator)
            prop_in = None
            if s == 0:
                cur = batch
            else:
                prop_in = [p.requires_grad_() for p in self._recv(self._prop_shapes(batch), s - 1, batch.device)]
                cur = self._layer_input(batch, prop_in)
            with torch.enable_grad():
                k, state, bn_state = gnn.unfold(cur, training=True, generator=generator)
                out, row_mask, bn_out = gnn.node_level_output(state, cur, training=True, generator=generator)
                out_loss = cur.readout(out) if lgnn._is_graph else out
                m = batch.target_mask.to(out_loss.dtype)
                num = torch.sum(lgnn.loss(batch.targets, out_loss) * batch.sample_weight * m)
            for above in lgnn.gnns[s + 1:]:
                _skip_layer_draws(above, batch, generator)
            with torch.no_grad():  # the moving statistics run through the microbatches in order
                buffers = dict(gnn.named_buffers())
                for key, value in {**{f"net_state.{k_}": v for k_, v in bn_state.items()},
                                   **{f"net_output.{k_}": v for k_, v in bn_out.items()}}.items():
                    buffers[key].copy_(value)
            prop_out = []
            if s < S - 1:
                if lgnn.get_state:
                    prop_out.append(state)
                if lgnn.get_output:
                    prop_out.append(torch.where(row_mask[:, None], out, 0.0))
                if lgnn._is_arc and lgnn.get_output:
                    node_out = [torch.cat(prop_out[:-1], dim=1)] if lgnn.get_state else \
                        [state.new_zeros((batch.num_nodes, 0))]
                    prop_out = node_out + [prop_out[-1]]
                else:
                    prop_out = [torch.cat(prop_out, dim=1)]
                self._send(prop_out, s + 1)
            records.append((num, prop_in, prop_out))
            num_total.append(num.detach())
            den_total.append(torch.sum(m))
            k_sum = k_sum + k
        count = torch.clamp_min(sum(den_total), 1.0)
        scale = 1.0 / (count * S)
        for num, prop_in, prop_out in reversed(records):
            tensors, grads = [num * scale], [torch.ones_like(num)]
            if prop_out:
                received = self._recv([tuple(t.shape) for t in prop_out], s + 1, num.device)
                for t, g in zip(prop_out, received):
                    if t.requires_grad:
                        tensors.append(t)
                        grads.append(g)
            torch.autograd.backward(tensors, grads)
            if prop_in is not None:
                self._send([p.grad if p.grad is not None else torch.zeros_like(p) for p in prop_in], s - 1)
        reg = gnn.regularization_loss()
        if reg.requires_grad:
            reg.backward()
        if lgnn.average_st_grads:
            gnn.scale_state_grads(k_sum / len(microbatches))
        opt.step()
        layer_loss = sum(num_total) / count
        totals = torch.stack([layer_loss.detach(), reg.detach(), k_sum.detach()]).cpu()
        dist.all_reduce(totals, group=self.group)
        return {"loss": totals[0] / S + totals[1], "k": totals[2] / (S * len(microbatches))}

    def fit(self, microbatch_lists, epochs: int = 1, verbose: int = 1, seed: int = 0, *, validation_data=None,
            callbacks: Optional[list] = None, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False, class_weight: Optional[dict] = None, validation_freq: int = 1):
        """Pipelined training: each element of ``microbatch_lists`` is one
        step's microbatches, and every epoch takes each once (module
        docstring).  Returns a ``History``; rank 0 prints with ``verbose``."""
        from gnnkeras_tpu_torch.parallel.collectives import agree_logs
        from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop
        from gnnkeras_tpu_torch.training.trainer import _apply_class_weight, _class_weight_vector
        from gnnkeras_tpu_torch.training.trainer import evaluate as seq_evaluate

        lgnn = self.lgnn
        if lgnn.optimizer is None:
            raise RuntimeError("compile() before fit()")
        lgnn.build(seed=seed)
        if class_weight:
            cw = _class_weight_vector(class_weight, lgnn.device)
            microbatch_lists = [[_apply_class_weight(mb, cw) for mb in mbs] for mbs in microbatch_lists]

        def run_epoch(epoch, n):
            losses = [float(self.train_step(mbs, lgnn.next_rng())["loss"]) for mbs in microbatch_lists]
            self.sync_to_model()
            return [agree_logs({"loss": sum(losses) / max(len(losses), 1)}, self.group)]

        validate = None
        if validation_data is not None:
            validate = lambda: agree_logs(seq_evaluate(lgnn, validation_data, verbose=0, prefix="val_"), self.group)
        if checkpoint_dir is not None:
            checkpoint_dir = os.path.join(checkpoint_dir, f"stage{self.stage}_of_{self.n_stages}")
        # the checkpoints carry this stage's optimizer; the model holds every layer (synchronised)
        saved_opt, lgnn._opt = lgnn._opt, self._optimizer()
        try:
            return run_fit_loop(
                lgnn, epochs=epochs, run_chunk=run_epoch, validate=validate, callbacks=callbacks,
                verbose=verbose if self.stage == 0 else 0, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume, validation_freq=validation_freq,
            )
        finally:
            lgnn._opt = saved_opt
