"""The one fit loop, counterpart of ``gnnkeras_tpu.training.fit_loop``.

An engine supplies closures:

- ``run_epoch(epoch)`` trains one epoch, leaves the new weights in the
  model and returns the epoch's log dict;
- ``validate()`` (optional) returns ``{"val_...": float}`` logs.

The weights live in the model, so a callback that loads weights
(``EarlyStopping(restore_best_weights=True)``) or a checkpoint restore
changes what the next epoch trains, with nothing to re-derive.

Checkpoints: an epoch that ends on a ``checkpoint_every`` boundary saves,
and the final or stopped epoch always saves.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from gnnkeras_tpu_torch.training.callbacks import History


def run_fit_loop(
    model,
    *,
    epochs: int,
    run_epoch: Callable[[int], dict],
    validate: Optional[Callable[[], dict]] = None,
    callbacks: Optional[list] = None,
    verbose: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    validation_freq: int = 1,
) -> History:
    """Drive a training run.  Returns the History callback."""
    manager = None
    start_epoch = 0
    if checkpoint_dir is not None:
        from gnnkeras_tpu_torch.training.checkpoint import CheckpointManager

        manager = CheckpointManager(checkpoint_dir)
        if resume and manager.latest_step() is not None:
            extra = manager.restore(model)
            start_epoch = int(extra.get("epoch", -1)) + 1
            if verbose:
                print(f"resumed from {checkpoint_dir} at epoch {start_epoch}")

    history = History()
    cbs = [history] + list(callbacks or [])
    for cb in cbs:
        cb.set_model(model)
        cb.on_train_begin()

    stop = False
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        logs = dict(run_epoch(epoch))
        dt = time.perf_counter() - t0
        if validate is not None and (epoch + 1) % max(validation_freq, 1) == 0:
            logs.update(validate())
        if verbose:
            msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
            print(f"Epoch {epoch + 1}/{epochs} [{dt:.2f}s] {msg}")
        for cb in cbs:
            cb.on_epoch_end(epoch, logs)
            stop = stop or cb.stop_training
        if manager is not None and ((epoch + 1) % checkpoint_every == 0 or epoch + 1 >= epochs or stop):
            manager.save(epoch, model, extra={"epoch": epoch, **{k: float(v) for k, v in logs.items()}})
        if stop:
            break

    for cb in cbs:
        cb.on_train_end()
    return history
