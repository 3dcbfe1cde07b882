"""Model shell shared by the GNN models: holds the nets' parameters and
BatchNorm buffers as an ``nn.Module`` and places them on a device.
``compile``/``fit``/``evaluate`` come with the training slice."""

from __future__ import annotations

import torch
from torch import nn

from gnnkeras_tpu_torch.utils.dtypes import resolve_device


class GraphModel(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.built = False
        self.device = None

    def init_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def build(self, seed: int = 0, device="cuda") -> "GraphModel":
        """Initialise the parameters from ``torch.Generator`` seeded with
        ``seed`` (once; drawn on the CPU, so the values do not depend on the
        device) and place the model on ``device`` (default ``"cuda"``; raises
        when no card is present)."""
        dev = resolve_device(device)
        if not self.built:
            self.init_parameters(torch.Generator().manual_seed(int(seed)))
            self.built = True
        self.to(dev)
        self.device = dev
        return self
