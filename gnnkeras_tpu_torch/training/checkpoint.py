"""Checkpoint and resume, counterpart of ``gnnkeras_tpu.training.checkpoint``.

One ``torch.save`` file a step, ``ckpt_{step}.pt``, holds everything a
resumed run needs to continue as the uninterrupted one would: the model's
``state_dict`` (parameters and BatchNorm buffers), the optimizer's
``state_dict`` and the state of the model's random stream.  The epoch and
the logs ride in a JSON sidecar, ``extra_{step}.json``, written atomically
(temporary file and rename): a torn sidecar must not pass for a missing
one.  Both files are written before the older steps past ``max_to_keep``
are removed.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Callable, Dict, Optional

import torch

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def _replace_atomically(path: str, write) -> None:
    tmp = path + f".tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, writer: bool = True,
                 barrier: Optional[Callable[[], None]] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.writer = bool(writer)
        self.barrier = barrier
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _sidecar(self, step: int) -> str:
        return os.path.join(self.directory, f"extra_{step}.json")

    def all_steps(self) -> list:
        steps = []
        for path in glob.glob(os.path.join(self.directory, "ckpt_*.pt")):
            m = _CKPT.match(os.path.basename(path))
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, extra: Optional[Dict[str, Any]] = None) -> None:
        if self.writer:
            self._write(step, model, extra)
        if self.barrier is not None:
            self.barrier()

    def _write(self, step: int, model, extra: Optional[Dict[str, Any]]) -> None:
        from gnnkeras_tpu_torch.training.trainer import _optimizer

        payload = {
            "model": model.state_dict(),
            "optimizer": _optimizer(model).state_dict(),
            "rng": model._rng.get_state(),
        }
        _replace_atomically(self._path(step), lambda p: torch.save(payload, p))

        def write_json(p):
            with open(p, "w") as f:
                json.dump(dict(extra or {}), f)

        _replace_atomically(self._sidecar(step), write_json)
        for old in self.all_steps()[:-self.max_to_keep]:
            for path in (self._path(old), self._sidecar(old)):
                if os.path.exists(path):
                    os.unlink(path)

    def restore(self, model, step: Optional[int] = None) -> Dict[str, Any]:
        """Restore into ``model`` (compiled; built here if it is not).
        Returns the ``extra`` dict (epoch and logs)."""
        from gnnkeras_tpu_torch.training.trainer import _optimizer

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if model.optimizer is None:
            raise RuntimeError("compile() the model before restoring (the optimizer state needs it)")
        model.build()
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        _optimizer(model).load_state_dict(payload["optimizer"])
        model._rng.set_state(payload["rng"])
        sidecar = self._sidecar(step)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                return json.load(f)
        # the weights are back but the epoch is not: resuming "from epoch 0"
        # would train the trained weights again
        raise RuntimeError(
            f"checkpoint step {step} restored but its metadata sidecar (extra_{step}.json) is missing: cannot "
            "determine the resume epoch; pass the epoch explicitly or delete the checkpoint"
        )


class CheckpointCallback:
    """Per-epoch checkpointing callback for ``fit``."""

    def __init__(self, directory: str, every_epochs: int = 1, max_to_keep: int = 3):
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep)
        self.every = int(every_epochs)

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.every == 0:
            self.manager.save(epoch, self.model,
                              extra={"epoch": epoch, **{k: float(v) for k, v in (logs or {}).items()}})

    def on_train_end(self, logs=None):
        pass

    @property
    def stop_training(self):
        return False
