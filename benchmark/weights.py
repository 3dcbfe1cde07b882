"""The initial weights of a configuration, drawn from the seed on the device.

Names are the reference's (``state.bn.gamma``, ``state.dense.kernel``,
``output.bn.moving_var``, ...).  One ``torch.randn`` call on a generator of
the device draws every number; each leaf takes its slice: Dense kernels at
the scale of their Keras initialiser (lecun_normal: 1 / fan_in,
glorot_normal: 2 / (fan_in + fan_out)), cut at two standard deviations,
biases the same for their shape, BatchNorm gamma 1 + 0.1·z, beta 0.1·z,
moving mean 0.1·z and moving variance 1 + 0.1·|z|.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_SCALE = {"lecun_normal": lambda fan_in, fan_out: 1.0 / fan_in,
          "glorot_normal": lambda fan_in, fan_out: 2.0 / (fan_in + fan_out)}


def net_widths(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """(input, output) width of the state and output nets at dim_state 0:
    the state net reads ``[state | Σ state | Σ arc labels]``, the output net
    the state."""
    if cfg["dim_state"] != 0:
        raise ValueError("the benchmark's reference covers dim_state 0")
    d, da = cfg["dim_node_label"], cfg["dim_arc_label"]
    return {"state": (2 * d + da, cfg["state_net"]["layers"][-1]),
            "output": (d, cfg["output_net"]["layers"][-1])}


def shapes(cfg: dict) -> Dict[str, tuple]:
    out = {}
    for net, (fan_in, fan_out) in net_widths(cfg).items():
        for leaf in ("gamma", "beta", "moving_mean", "moving_var"):
            out[f"{net}.bn.{leaf}"] = (fan_in,)
        out[f"{net}.dense.kernel"] = (fan_in, fan_out)
        out[f"{net}.dense.bias"] = (fan_out,)
    return out


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    leaves = shapes(cfg)
    total = sum(math.prod(s) for s in leaves.values())
    generator = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in leaves.items():
        n = math.prod(shape)
        x = z[at:at + n].reshape(shape)
        at += n
        net, kind, leaf = name.split(".")
        if kind == "dense":
            init = cfg[f"{net}_net"]["kernel_initializer" if leaf == "kernel" else "bias_initializer"]
            fan_in, fan_out = shape if leaf == "kernel" else (shape[0], shape[0])
            x = torch.clamp(x, -2.0, 2.0) * math.sqrt(_SCALE[init](fan_in, fan_out))
        elif leaf == "gamma":
            x = 1.0 + 0.1 * x
        elif leaf == "moving_var":
            x = 1.0 + 0.1 * torch.abs(x)
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out
