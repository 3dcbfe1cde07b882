"""Keras-style callbacks of the fit loop, counterpart of
``gnnkeras_tpu.training.callbacks``: ``History`` (what ``fit`` returns),
``EarlyStopping``, ``ReduceLROnPlateau``, ``TerminateOnNaN``, ``CSVLogger``
and ``LambdaCallback``.

A callback sees the model through ``set_model``.  ``EarlyStopping`` with
``restore_best_weights`` keeps a detached copy of the best epoch's
``state_dict`` (parameters and BatchNorm buffers; the optimizer state is
left alone, as the JAX package leaves it) and loads it at ``on_train_end``.
``ReduceLROnPlateau`` reads and writes the live rate of ``model._opt`` (the
moments are kept).
"""

from __future__ import annotations

import math
import os
from typing import Optional


class Callback:
    def set_model(self, model) -> None:
        self.model = model

    def on_train_begin(self, logs=None) -> None:
        pass

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        pass

    def on_train_end(self, logs=None) -> None:
        pass

    @property
    def stop_training(self) -> bool:
        return getattr(self, "_stop", False)


class History(Callback):
    """Collects per-epoch logs; ``history[key]`` lists one value per epoch."""

    def __init__(self):
        self.history: dict = {}
        self.epoch: list = []

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        self.epoch.append(epoch)
        for key, value in (logs or {}).items():
            self.history.setdefault(key, []).append(value)

    def __getitem__(self, key):
        return self.history[key]

    def __contains__(self, key):
        return key in self.history

    def items(self):
        return self.history.items()

    def keys(self):
        return self.history.keys()


def _improved(best: Optional[float], current: float, mode: str, min_delta: float) -> bool:
    if best is None:
        return True
    if mode == "max":
        return current > best + min_delta
    return current < best - min_delta


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0, patience: int = 0, mode: str = "min",
                 restore_best_weights: bool = False):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.restore_best_weights = restore_best_weights
        self.best: Optional[float] = None
        self.wait = 0
        self._stop = False
        self._best_state = None

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if _improved(self.best, float(current), self.mode, self.min_delta):
            self.best = float(current)
            self.wait = 0
            if self.restore_best_weights and getattr(self, "model", None) is not None:
                self._best_state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        else:
            self.wait += 1
            if self.wait > self.patience:
                self._stop = True

    def on_train_end(self, logs=None):
        if self.restore_best_weights and self._best_state is not None:
            self.model.load_state_dict(self._best_state)


class ReduceLROnPlateau(Callback):
    """Multiply the live learning rate by ``factor`` (not below ``min_lr``)
    when ``monitor`` has not improved for more than ``patience`` epochs."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.5, patience: int = 10, min_delta: float = 1e-4,
                 min_lr: float = 0.0, mode: str = "min", verbose: int = 0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor {factor} must lie in (0, 1)")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.min_lr = min_lr
        self.mode = mode
        self.verbose = verbose
        self.best: Optional[float] = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        from gnnkeras_tpu_torch.training.optimizers import current_learning_rate, set_learning_rate

        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if _improved(self.best, float(current), self.mode, self.min_delta):
            self.best = float(current)
            self.wait = 0
            return
        self.wait += 1
        if self.wait <= self.patience:
            return
        self.wait = 0
        opt = getattr(self.model, "_opt", None)
        lr = current_learning_rate(opt) if opt is not None else None
        if lr is None:
            if not getattr(self, "_warned", False):
                self._warned = True
                print("ReduceLROnPlateau: the model has no optimizer with a learning rate yet; no-op")
            return
        new_lr = max(lr * self.factor, self.min_lr)
        if new_lr < lr:
            set_learning_rate(opt, new_lr)
            if self.verbose:
                print(f"ReduceLROnPlateau: lr {lr:.2e} -> {new_lr:.2e}")


class TerminateOnNaN(Callback):
    """Stop training when the epoch loss is NaN or infinite."""

    def on_epoch_end(self, epoch, logs=None):
        loss = (logs or {}).get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            print(f"TerminateOnNaN: non-finite loss {loss} at epoch {epoch + 1}")
            self._stop = True


class CSVLogger(Callback):
    """Per-epoch logs as CSV rows.  ``append=False`` truncates the file at
    ``on_train_begin``; pass ``append=True`` with ``fit(resume=True)`` to
    keep the earlier epochs' rows."""

    def __init__(self, filename: str, append: bool = False):
        self.filename = filename
        self.append = append
        self._file = None
        self._keys = None

    def on_train_begin(self, logs=None):
        self._write_header = not (self.append and os.path.exists(self.filename)
                                  and os.path.getsize(self.filename) > 0)
        self._file = open(self.filename, "a" if self.append else "w")
        self._keys = None

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self._keys is None:
            self._keys = sorted(logs)
            if self._write_header:
                self._file.write(",".join(["epoch"] + self._keys) + "\n")
        row = [str(epoch)] + [f"{float(logs.get(k, float('nan'))):.6g}" for k in self._keys]
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def on_train_end(self, logs=None):
        if self._file is not None:
            self._file.close()
            self._file = None


class LambdaCallback(Callback):
    """Ad-hoc hooks."""

    def __init__(self, on_train_begin=None, on_epoch_end=None, on_train_end=None):
        self._on_train_begin = on_train_begin
        self._on_epoch_end = on_epoch_end
        self._on_train_end = on_train_end

    def on_train_begin(self, logs=None):
        if self._on_train_begin:
            self._on_train_begin(logs)

    def on_epoch_end(self, epoch, logs=None):
        if self._on_epoch_end:
            self._on_epoch_end(epoch, logs)

    def on_train_end(self, logs=None):
        if self._on_train_end:
            self._on_train_end(logs)
