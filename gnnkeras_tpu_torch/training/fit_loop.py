"""The one fit loop, counterpart of ``gnnkeras_tpu.training.fit_loop``.

An engine supplies closures:

- ``run_chunk(epoch, n)`` trains ``n`` consecutive epochs in one engine
  call (n > 1 only for ``PartitionedGNN.fit``'s ``steps_per_launch``),
  leaves the new weights in the model and returns the per-epoch log dicts.
  When validation or callbacks are requested the driver forces ``n == 1``:
  per-epoch weights only exist at chunk boundaries.
- ``validate()`` (optional) returns ``{"val_...": float}`` logs.
- ``on_resume()`` (optional) re-derives engine state after a checkpoint
  restore (the trainer drops a captured epoch whose tensors the restore
  replaced; the partitioned engine re-synchronises its ranks).
- ``on_weights_mutated()`` (optional) picks up weights a callback changed
  (``EarlyStopping(restore_best_weights=True)``); called after every
  chunk's callbacks and once after ``on_train_end``.

Checkpoints use the boundary-crossing rule: a chunk that crosses (or lands
on) a ``checkpoint_every`` boundary saves, and the final or stopped epoch
always saves, whatever ``epochs % checkpoint_every`` or the chunk size.
With ranks in separate processes, ``writer`` says whether this process
writes the files and ``barrier`` (called after every save) keeps a reader
from seeing a file half written; every rank restores.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from gnnkeras_tpu_torch.training.callbacks import History


def run_fit_loop(
    model,
    *,
    epochs: int,
    run_chunk: Callable[[int, int], List[dict]],
    chunk_size: int = 1,
    validate: Optional[Callable[[], dict]] = None,
    callbacks: Optional[list] = None,
    verbose: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    validation_freq: int = 1,
    on_resume: Optional[Callable[[], None]] = None,
    on_weights_mutated: Optional[Callable[[], None]] = None,
    writer: bool = True,
    barrier: Optional[Callable[[], None]] = None,
) -> History:
    """Drive a training run.  Returns the History callback."""
    user_cbs = list(callbacks or [])
    if validate is not None or user_cbs:
        # validation and callbacks need the weights of every epoch
        chunk_size = 1
    chunk_size = max(int(chunk_size), 1)

    manager = None
    start_epoch = 0
    if checkpoint_dir is not None:
        from gnnkeras_tpu_torch.training.checkpoint import CheckpointManager

        manager = CheckpointManager(checkpoint_dir, writer=writer, barrier=barrier)
        if resume and manager.latest_step() is not None:
            extra = manager.restore(model)
            start_epoch = int(extra.get("epoch", -1)) + 1
            if on_resume is not None:
                on_resume()
            if verbose:
                print(f"resumed from {checkpoint_dir} at epoch {start_epoch}")

    history = History()
    cbs = [history] + user_cbs
    for cb in cbs:
        cb.set_model(model)
        cb.on_train_begin()

    epoch = start_epoch
    stop = False
    last_logs: dict = {}
    while epoch < epochs and not stop:
        t0 = time.perf_counter()
        n = min(chunk_size, epochs - epoch)
        chunk_logs = run_chunk(epoch, n)
        dt = time.perf_counter() - t0
        done = epoch
        for j, logs in enumerate(chunk_logs):
            e = epoch + j
            logs = dict(logs)
            if validate is not None and (e + 1) % max(validation_freq, 1) == 0:
                logs.update(validate())
            if verbose:
                msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                print(f"Epoch {e + 1}/{epochs} [{dt / n:.2f}s] {msg}")
            for cb in cbs:
                cb.on_epoch_end(e, logs)
                stop = stop or cb.stop_training
            last_logs = logs
            done = e + 1
            if stop:
                break
        if on_weights_mutated is not None:
            on_weights_mutated()
        if manager is not None and done > epoch and (
            epoch // checkpoint_every != done // checkpoint_every or done >= epochs or stop
        ):
            manager.save(done - 1, model, extra={"epoch": done - 1, **{k: float(v) for k, v in last_logs.items()}})
        epoch += n

    for cb in cbs:
        cb.on_train_end()
    if on_weights_mutated is not None:
        # EarlyStopping(restore_best_weights) restores at on_train_end
        on_weights_mutated()
    return history
