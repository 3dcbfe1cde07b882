"""Training runtime of the port: losses, metrics, optimizers, the train and
eval steps, the ``fit`` / ``evaluate`` / ``predict`` loops and the fit
loop's callbacks (checkpoints: ``training.checkpoint``; serial LGNN
training: ``training.serial``; BatchNorm recalibration:
``training.calibrate``)."""

from gnnkeras_tpu_torch.training import losses, metrics, optimizers
from gnnkeras_tpu_torch.training.callbacks import (
    Callback,
    CSVLogger,
    EarlyStopping,
    History,
    LambdaCallback,
    ReduceLROnPlateau,
    TerminateOnNaN,
)
from gnnkeras_tpu_torch.training.trainer import evaluate, fit, predict

__all__ = [
    "losses",
    "metrics",
    "optimizers",
    "fit",
    "evaluate",
    "predict",
    "Callback",
    "CSVLogger",
    "EarlyStopping",
    "History",
    "LambdaCallback",
    "ReduceLROnPlateau",
    "TerminateOnNaN",
]
