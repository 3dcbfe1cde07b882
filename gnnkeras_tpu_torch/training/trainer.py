"""Training runtime, counterpart of ``gnnkeras_tpu.training.trainer``.

``train_step`` is the one training-step body: the training forward (the
fixed-length unfolding with its device-side running flag), the masked,
sample-weighted loss plus the regularisation loss, the backward through the
unfolding (the strip aggregation's backward is the ``strip_matmul_t``
kernel on the card), the optional ``average_st_grads`` division of the
state net's gradients by max(k, 1), the optimizer step, the new BatchNorm
moving statistics and the step's log sums.  Nothing in it reads a device
value on the host; the logs stay on the device until ``_reduce_logs``.

``fit`` runs the per-batch path over any object with ``len``, ``[i]`` and
``on_epoch_end`` that yields ``GraphBatch``es on the model's device.
Validation, callbacks other than ``History``, checkpoints and resume, and
the scanned-epoch path are ROADMAP queue 5 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gnnkeras_tpu_torch.training.callbacks import History
from gnnkeras_tpu_torch.training.losses import masked_mean
from gnnkeras_tpu_torch.training.metrics import get_metric


def _objective(model, batch, generator: Optional[torch.Generator], training: bool):
    """(loss, aux) for one batch of a single GNN: the masked mean of the
    per-row loss plus the regularisation loss; aux holds ``y_pred``, ``k``
    and ``new_state`` (the new moving statistics)."""
    y, mask, sw = batch.targets, batch.target_mask, batch.sample_weight
    k, _, out, _, new_state = model.forward(batch, training=training, generator=generator)
    loss = masked_mean(model.loss(y, out), mask, sw) + model.regularization_loss()
    return loss, {"y_pred": out, "k": k, "new_state": new_state}


def _metric_sums(model, y_pred, batch) -> dict:
    sums = {}
    for spec in model.metrics:
        name, fn = get_metric(spec)
        sums[name] = fn(batch.targets, y_pred, batch.target_mask, batch.sample_weight)
    return sums


def _step_logs(model, loss, y_pred, batch) -> dict:
    count = torch.clamp_min(torch.sum(batch.target_mask.to(torch.float32)), 1.0)
    logs = {"loss_sum": loss.detach() * count, "count": count}
    with torch.no_grad():
        for name, (s, c) in _metric_sums(model, y_pred.detach(), batch).items():
            logs[f"{name}_sum"] = s
            logs[f"{name}_count"] = c
    return logs


def _load_bn_state(model, new_state: dict) -> None:
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for key, value in new_state.items():
            buffers[key].copy_(value)


def _optimizer(model) -> torch.optim.Optimizer:
    if model._opt is None:
        model._opt = model.optimizer(model.parameters())
    return model._opt


def train_step(model, batch, generator: Optional[torch.Generator] = None):
    """One training step on a compiled, built model.  Returns (logs, aux):
    the log sums (0-dim device tensors) and the objective's aux.  The
    parameters' ``.grad`` hold the step's (scaled) gradients afterwards."""
    opt = _optimizer(model)
    opt.zero_grad(set_to_none=True)
    loss, aux = _objective(model, batch, generator, training=True)
    loss.backward()
    if model.average_st_grads:
        model.scale_state_grads(aux["k"])
    opt.step()
    _load_bn_state(model, aux["new_state"])
    return _step_logs(model, loss, aux["y_pred"], batch), aux


def eval_step(model, batch) -> dict:
    # the generator draws a dim_state > 0 model's random initial state
    with torch.no_grad():
        loss, aux = _objective(model, batch, model.next_rng(), training=False)
    return _step_logs(model, loss, aux["y_pred"], batch)


def _reduce_logs(accum: list, prefix: str = "") -> dict:
    total = {}
    for logs in accum:
        for key, value in logs.items():
            total[key] = total.get(key, 0.0) + float(value)
    out = {prefix + "loss": total.get("loss_sum", 0.0) / max(total.get("count", 1.0), 1.0)}
    for key in list(total):
        if key.endswith("_sum") and key != "loss_sum":
            name = key[:-4]
            out[prefix + name] = total[key] / max(total.get(f"{name}_count", 1.0), 1e-9)
    return out


def _class_weight_vector(class_weight: dict, device) -> torch.Tensor:
    """{class index: weight} → dense lookup vector (missing classes weigh 1)."""
    n = max(int(k) for k in class_weight) + 1
    vec = torch.ones(n, dtype=torch.float32)
    for k, v in class_weight.items():
        vec[int(k)] = float(v)
    return vec.to(device)


def _apply_class_weight(batch, cw_vec: torch.Tensor):
    """Scale each row's sample weight by the weight of its true class
    (argmax of the one-hot target row)."""
    cls = torch.clamp(torch.argmax(batch.targets, dim=-1), 0, cw_vec.shape[0] - 1)
    return batch.replace(sample_weight=batch.sample_weight * cw_vec[cls])


def _not_ported(**given) -> None:
    for name, used in given.items():
        if used:
            raise NotImplementedError(
                f"fit({name}=...) is not ported yet (ROADMAP queue 5: the fit surface)"
            )


def fit(
    model,
    sequencer,
    epochs: int = 1,
    validation_data=None,
    callbacks: Optional[list] = None,
    verbose: int = 1,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    scan_batches: Optional[bool] = None,
    class_weight: Optional[dict] = None,
    validation_freq: int = 1,
) -> History:
    """Keras-like fit loop over a sequencer of ``GraphBatch``es, one
    ``train_step`` per batch.  ``class_weight`` ({class index: weight})
    scales each supervised row's training loss by the weight of its true
    class.  Returns a ``History`` of the per-epoch mean logs."""
    _not_ported(validation_data=validation_data is not None, callbacks=bool(callbacks),
                checkpoint_dir=checkpoint_dir is not None, resume=resume, scan_batches=scan_batches is True,
                validation_freq=validation_freq != 1)
    if model.optimizer is None:
        raise RuntimeError("call compile() before fit()")
    model.build(seed=seed)
    cw_vec = _class_weight_vector(class_weight, model.device) if class_weight else None
    history = History()
    for epoch in range(epochs):
        t0 = time.perf_counter()
        accum = []
        for i in range(len(sequencer)):
            batch = sequencer[i]
            if cw_vec is not None:
                batch = _apply_class_weight(batch, cw_vec)
            logs, _ = train_step(model, batch, model.next_rng())
            accum.append(logs)
        sequencer.on_epoch_end()
        logs = _reduce_logs(accum)
        if verbose:
            msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
            print(f"Epoch {epoch + 1}/{epochs} [{time.perf_counter() - t0:.2f}s] {msg}")
        history.on_epoch_end(epoch, logs)
    return history


def evaluate(model, sequencer, verbose: int = 0, prefix: str = "") -> dict:
    """Loss and metrics over a sequencer (the reference's ``evaluate``)."""
    if model.loss is None:
        raise RuntimeError("call compile() before evaluate()")
    model.build()
    logs = _reduce_logs([eval_step(model, sequencer[i]) for i in range(len(sequencer))], prefix=prefix)
    if verbose:
        print(" - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
    return logs


def predict(model, sequencer) -> np.ndarray:
    """Model outputs for every supervised row, concatenated over batches in
    the caller's (graph, entity) order (``host_pred_rows`` undoes tile
    packing; arc rows keep the merged graph's arc order)."""
    model.build()
    outs = []
    for i in range(len(sequencer)):
        batch = sequencer[i]
        _, _, out, _, _ = model.forward(batch, training=False, generator=model.next_rng())
        out = out.cpu().numpy()
        rows = batch.host_pred_rows
        outs.append(out[rows] if rows is not None else out[batch.target_mask.cpu().numpy()])
    return np.concatenate(outs, axis=0)
