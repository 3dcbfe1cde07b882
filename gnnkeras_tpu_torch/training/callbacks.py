"""``History``, the per-epoch log record ``fit`` returns (counterpart of
``gnnkeras_tpu.training.callbacks.History``).  The other callbacks come with
a later slice."""

from __future__ import annotations


class History:
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

    def keys(self):
        return self.history.keys()
