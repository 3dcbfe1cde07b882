"""Data parallelism over merged graph batches, the counterpart of
``gnnkeras_tpu.parallel.data_parallel``.

Every rank of the ``data`` group holds the whole model and trains on its own
padded disjoint-union batch.  The sequencer's batches are taken in groups of
D (the group's size): rank r takes batch ``i·D + r`` of group i.  A partial
last group is filled by repeating the last batch with its ``target_mask``
and ``sample_weight`` zeroed and weight 0 (``_rank_batch``).  The JAX
package stacks a group along a device axis and places it on the mesh
(``stack_batches`` / ``shard_batches``); the port's counterpart is this
pick: each rank reads only its own batch of every group.

The step (``make_dp_train_step``, JAX ``data_parallel.py:38-86``): each
rank's gradient of its batch's objective (``average_st_grads`` applied), then
the gradients, the new BatchNorm moving statistics and the loss averaged over
the REAL batches only, ``psum(w·x) / max(psum(w), 1)`` with w = 1 for a real
batch and 0 for the filler (``collectives.weighted_mean``; a plain mean over
D would weight the filler as a group member), and the optimizer step, the
same on every rank.  The log sums (the loss times the rank's count, the
metrics' sums and counts, each times w) are summed over the group.

The JAX package's scanned epoch (``make_dp_epoch_step``: a ``lax.scan`` of
the step over the epoch's groups) has no counterpart: a CUDA graph cannot
hold gloo's all-reduce, which goes through host memory, so ``fit`` runs
one step a group.  The trajectory is the same; ``fit(scan_batches=...)``
is accepted for the JAX package's signature.

The sequencers shuffle from NumPy's global stream, which each spawned rank
seeds on its own: ``fit`` gives every rank rank 0's stream first, so every
rank draws the same epoch order.  Checkpoints are written by rank 0 and read
by every rank after a barrier; after a restore or a callback's change of the
weights every rank takes rank 0's (``collectives.rank0_fit_hooks``, as
``PartitionedGNN.fit`` uses them).  ``evaluate`` and ``predict`` run the
model's single-device path on the synchronised weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def sync_numpy_stream(group=None) -> None:
    """Give every rank of ``group`` rank 0's NumPy global stream (the
    sequencers' shuffles draw from it)."""
    group = dist.group.WORLD if group is None else group
    state = [np.random.get_state()]
    dist.broadcast_object_list(state, src=dist.get_global_rank(group, 0), group=group)
    np.random.set_state(state[0])


def _rank_batch(sequencer, group_index: int, n_ranks: int, rank: int):
    """(batch, weight) of this rank in group ``group_index``: its own batch
    with weight 1, or the filler (the group's last batch, masks zeroed)
    with weight 0."""
    index = group_index * n_ranks + rank
    if index < len(sequencer):
        return sequencer[index], 1.0
    last = sequencer[len(sequencer) - 1]
    return last.replace(target_mask=torch.zeros_like(last.target_mask),
                        sample_weight=torch.zeros_like(last.sample_weight)), 0.0


def make_dp_train_step(model, mesh=None, axis: str = "data"):
    """The data-parallel step on this rank: ``step(batch, weight, generator)
    -> logs`` (module docstring) on a compiled, built model, its parameters
    and optimizer state equal on every rank, over the ``axis`` group of
    ``mesh`` (default: the world).  Returns the log sums as 0-dim tensors
    on the model's device, summed over the group."""
    from gnnkeras_tpu_torch.parallel.collectives import psum, weighted_mean
    from gnnkeras_tpu_torch.parallel.mesh import axis_group
    from gnnkeras_tpu_torch.training.trainer import _load_bn_state, _metric_sums, _objective, _optimizer

    group = axis_group(mesh, axis)

    def step(batch, weight: float = 1.0, generator: Optional[torch.Generator] = None) -> dict:
        opt = _optimizer(model)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, aux = _objective(model, batch, generator, training=True)
            loss.backward()
        if model.average_st_grads:
            model.scale_state_grads(aux["k"])
        params = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        keys = list(aux["new_state"])
        averaged = weighted_mean(grads + [aux["new_state"][k] for k in keys] + [loss.detach()], weight, group)
        for p, g in zip(params, averaged[:len(params)]):
            p.grad = g
        opt.step()
        _load_bn_state(model, dict(zip(keys, averaged[len(params):-1])))
        loss = averaged[-1]
        w = torch.tensor(float(weight), dtype=torch.float32, device=loss.device)
        count = torch.clamp_min(torch.sum(batch.target_mask.to(torch.float32)), 1.0) * w
        logs = {"loss_sum": loss * count, "count": count}
        with torch.no_grad():
            for name, (s, c) in _metric_sums(model, aux["y_pred"].detach(), batch).items():
                logs[f"{name}_sum"], logs[f"{name}_count"] = s * w, c * w
        names = list(logs)
        total = psum(torch.stack([logs[k].to(torch.float32) for k in names]), group)
        return dict(zip(names, total))

    return step


class DataParallelTrainer:
    """``fit`` / ``evaluate`` / ``predict`` of ``model`` over the ``axis``
    group of ``mesh`` (a ``parallel.mesh.Mesh``; default: every rank of the
    world).  Build the model from one seed on every rank (or load one state
    dict), then call ``fit`` on every rank with the same sequencer."""

    def __init__(self, model, mesh=None, axis: str = "data"):
        from gnnkeras_tpu_torch.parallel.mesh import axis_group

        self.model = model
        self.mesh, self.axis = mesh, axis
        self.group = axis_group(mesh, axis)
        self.n_devices = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._step = None

    def rank_batches(self, sequencer) -> list:
        """This rank's (batch, weight) of every group of the epoch."""
        n_groups = -(-len(sequencer) // self.n_devices)
        return [_rank_batch(sequencer, i, self.n_devices, self.rank) for i in range(n_groups)]

    def fit(self, sequencer, epochs: int = 1, validation_data=None, callbacks: Optional[list] = None,
            verbose: int = 1, seed: int = 0, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False, scan_batches: Optional[bool] = None, class_weight: Optional[dict] = None,
            validation_freq: int = 1):
        """Data-parallel fit with the single-device surface: validation
        every ``validation_freq`` epochs (the single-device ``evaluate`` on
        the synchronised weights, rank 0's logs on every rank), callbacks,
        ``class_weight`` and resumable checkpoints.  ``scan_batches`` is
        accepted and the epoch runs one step a group (module docstring).
        Returns a ``History``; rank 0 prints with ``verbose``."""
        from gnnkeras_tpu_torch.parallel.collectives import agree_logs, rank0_fit_hooks
        from gnnkeras_tpu_torch.parallel.mesh import rank_generator
        from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop
        from gnnkeras_tpu_torch.training.trainer import _apply_class_weight, _class_weight_vector, _reduce_logs
        from gnnkeras_tpu_torch.training.trainer import evaluate as seq_evaluate

        del scan_batches
        model = self.model
        if model.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        model.build(seed=seed)
        if self._step is None:
            self._step = make_dp_train_step(model, self.mesh, self.axis)
        cw_vec = _class_weight_vector(class_weight, model.device) if class_weight else None
        sync_numpy_stream(self.group)

        def run_epoch(epoch, n):
            accum = []
            for batch, weight in self.rank_batches(sequencer):
                if cw_vec is not None:
                    batch = _apply_class_weight(batch, cw_vec)
                accum.append(self._step(batch, weight, rank_generator(model, self.rank)))
            sequencer.on_epoch_end()
            return [agree_logs(_reduce_logs(accum), self.group)]

        validate = None
        if validation_data is not None:
            validate = lambda: agree_logs(seq_evaluate(model, validation_data, verbose=0, prefix="val_"),
                                          self.group)
        try:
            return run_fit_loop(
                model, epochs=epochs, run_chunk=run_epoch, validate=validate, callbacks=callbacks,
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
                validation_freq=validation_freq, **rank0_fit_hooks(model, self.group, verbose),
            )
        finally:
            wait = getattr(sequencer, "wait_for_rebuild", None)
            if wait is not None:
                wait()

    def evaluate(self, sequencer, **kwargs):
        """The model's single-device evaluation on the synchronised weights."""
        return self.model.evaluate(sequencer, **kwargs)

    def predict(self, sequencer, **kwargs):
        """The model's single-device predictions on the synchronised weights."""
        return self.model.predict(sequencer, **kwargs)
