"""Global float dtype and device resolution.

``floatx`` mirrors ``gnnkeras_tpu.utils.dtypes.floatx`` (float32 unless
``set_floatx`` changes it); ``torch_floatx`` is the same type as a torch
dtype.
``resolve_device`` is the port's one gate onto the card: every entry point
(``from_graph_object``, ``GraphModel.build``, ``Predictor``) passes its
``device=`` argument through it, so asking for CUDA on a machine without a
card raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

_FLOATX = np.float32


def floatx():
    return _FLOATX


def set_floatx(dtype) -> None:
    """Set the host float type of graphs built from now on (and with it
    ``torch_floatx``)."""
    global _FLOATX
    _FLOATX = np.dtype(dtype).type


def torch_floatx() -> torch.dtype:
    return torch.from_numpy(np.zeros(0, _FLOATX)).dtype


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when a
    CUDA device is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
