"""MLP blocks: an optional leading BatchNorm, a Dense stack with per-layer
activations and initialisers, and (Alpha)Dropout at caller-chosen
positions — the layer program of ``gnnkeras_tpu.models.mlp``.

``MLP`` is an ``nn.Module``: Dense layers hold ``kernel`` (in, out) and
``bias`` parameters, BatchNorm holds ``gamma``/``beta`` parameters and
``moving_mean``/``moving_var`` buffers, so the JAX package's variables copy
over leaf for leaf (``convert.variables_from_jax``).  ``apply`` is row-major
(rows, features), ``apply_t`` feature-major (features, rows).  This slice
serves only: BatchNorm uses its moving statistics and dropout is the
identity; training-mode masked moments and dropout come with the training
slice.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from gnnkeras_tpu_torch.utils.dtypes import torch_floatx

# --------------------------------------------------------------------------
# Initialisers (Keras fan computation, incl. rank-1 bias shapes), drawing
# from a torch.Generator
# --------------------------------------------------------------------------

_TRUNC_STD_CORRECTION = 0.87962566103423978  # std of N(0,1) truncated to ±2


def _compute_fans(shape: Sequence[int]) -> Tuple[float, float]:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        fan_in, fan_out = _compute_fans(t.shape)
        fan = max({"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2.0}[mode], 1.0)
        if distribution == "truncated_normal":
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            return t.mul_(math.sqrt(scale / fan) / _TRUNC_STD_CORRECTION)
        if distribution == "normal":
            return nn.init.normal_(t, 0.0, math.sqrt(scale / fan), generator=generator)
        limit = math.sqrt(3.0 * scale / fan)
        return nn.init.uniform_(t, -limit, limit, generator=generator)

    return init


INITIALIZERS = {
    "zeros": lambda t, generator: nn.init.zeros_(t),
    "ones": lambda t, generator: nn.init.ones_(t),
    "lecun_normal": _variance_scaling(1.0, "fan_in", "truncated_normal"),
    "lecun_uniform": _variance_scaling(1.0, "fan_in", "uniform"),
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "random_normal": lambda t, generator: nn.init.normal_(t, 0.0, 0.05, generator=generator),
    "random_uniform": lambda t, generator: nn.init.uniform_(t, -0.05, 0.05, generator=generator),
}


def get_initializer(name_or_fn):
    """An initialiser ``fn(tensor, generator)`` that fills ``tensor`` in place."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return INITIALIZERS[str(name_or_fn)]
    except KeyError:
        raise ValueError(f"Unknown initializer {name_or_fn!r}; known: {sorted(INITIALIZERS)}")


# --------------------------------------------------------------------------
# Activations (the JAX package's definitions)
# --------------------------------------------------------------------------

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772

ACTIVATIONS = {
    "linear": lambda x: x,
    None: lambda x: x,
    "relu": torch.relu,
    "selu": lambda x: _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x)),
    "elu": lambda x: torch.where(x > 0, x, torch.expm1(x)),
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": torch.nn.functional.softplus,
    "leaky_relu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return ACTIVATIONS[name_or_fn if name_or_fn is None else str(name_or_fn)]
    except KeyError:
        raise ValueError(f"Unknown activation {name_or_fn!r}; known: {sorted(k for k in ACTIVATIONS if k)}")


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

_BN_EPS = 1e-3


class _Dense(nn.Module):
    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_units, out_units, dtype=torch_floatx()))
        self.bias = nn.Parameter(torch.zeros(out_units, dtype=torch_floatx()))


class _BatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features, dtype=torch_floatx()))
        self.beta = nn.Parameter(torch.zeros(features, dtype=torch_floatx()))
        self.register_buffer("moving_mean", torch.zeros(features, dtype=torch_floatx()))
        self.register_buffer("moving_var", torch.ones(features, dtype=torch_floatx()))

    def apply_rows(self, x):
        return (x - self.moving_mean) * torch.rsqrt(self.moving_var + _BN_EPS) * self.gamma + self.beta

    def apply_cols(self, x):
        scale = torch.rsqrt(self.moving_var + _BN_EPS) * self.gamma
        return (x - self.moving_mean[:, None]) * scale[:, None] + self.beta[:, None]


def _broadcast(value, n: int, name: str) -> list:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"MLP: {name} must have length {n}, got {len(value)}")
        return list(value)
    return [value for _ in range(n)]


class MLP(nn.Module):
    """Dense stack with an optional leading BatchNorm and dropout spliced at
    ``dropout_pos``; ``layers`` counts units from the first hidden layer to
    the output layer."""

    def __init__(
        self,
        input_dim: Tuple[int, ...],
        layers: Sequence[int],
        activations: Any,
        kernel_initializer: Any = "glorot_uniform",
        bias_initializer: Any = "zeros",
        dropout_rate: Union[List[float], float, None] = None,
        dropout_pos: Optional[Union[List[int], int]] = None,
        alphadropout: bool = False,
        batch_normalization: bool = True,
        *,
        name: Optional[str] = None,
    ):
        super().__init__()
        if isinstance(input_dim, (int, np.integer)):
            input_dim = (int(input_dim),)
        self.input_dim = tuple(int(i) for i in input_dim)
        units = [int(u) for x in list(layers) for u in np.ravel(x)]
        n = len(units)
        acts = _broadcast(activations, n, "activations")
        k_inits = _broadcast(kernel_initializer, n, "kernel_initializer")
        b_inits = _broadcast(bias_initializer, n, "bias_initializer")

        if isinstance(dropout_pos, int):
            dropout_pos = [dropout_pos]
        if isinstance(dropout_rate, float):
            dropout_rate = [dropout_rate for _ in (dropout_pos or [])]
        if dropout_rate is None or dropout_pos is None:
            dropout_rate, dropout_pos = [], []
        if len(dropout_rate) != len(dropout_pos):
            raise ValueError("Dropout parameters must have the same length")

        program: List[tuple] = [("dense", u, a, ki, bi) for u, a, ki, bi in zip(units, acts, k_inits, b_inits)]
        adjusted = np.array(dropout_pos, dtype=int) + np.arange(len(dropout_pos))
        for rate, pos in zip(dropout_rate, adjusted):
            program.insert(int(pos), ("dropout", float(rate), bool(alphadropout)))
        if batch_normalization:
            program.insert(0, ("batch_norm",))
        self.program = program
        self.name = name
        self.batch_normalization = bool(batch_normalization)
        self.units = units

        modules, feat = [], self.input_dim[0]
        for layer in program:
            if layer[0] == "dense":
                modules.append(_Dense(feat, layer[1]))
                feat = layer[1]
            elif layer[0] == "batch_norm":
                modules.append(_BatchNorm(feat))
            else:
                modules.append(nn.Identity())
        self.layers = nn.ModuleList(modules)

    @property
    def output_dim(self) -> int:
        return self.units[-1]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every Dense kernel then bias, layer by layer, from
        ``generator``; BatchNorm starts at gamma 1, beta 0, mean 0, var 1."""
        with torch.no_grad():
            for layer, mod in zip(self.program, self.layers):
                if layer[0] == "dense":
                    get_initializer(layer[3])(mod.kernel, generator)
                    get_initializer(layer[4])(mod.bias, generator)
                elif layer[0] == "batch_norm":
                    mod.gamma.fill_(1.0)
                    mod.beta.zero_()
                    mod.moving_mean.zero_()
                    mod.moving_var.fill_(1.0)

    def _run(self, x: torch.Tensor, training: bool, feature_major: bool) -> torch.Tensor:
        if training:
            raise NotImplementedError("training-mode BatchNorm and dropout are not ported yet")
        for layer, mod in zip(self.program, self.layers):
            if layer[0] == "dense":
                act = layer[2]
                if feature_major:
                    x = mod.kernel.T @ x + mod.bias[:, None]
                    x = torch.softmax(x, dim=0) if act == "softmax" else get_activation(act)(x)
                else:
                    x = get_activation(act)(x @ mod.kernel + mod.bias)
            elif layer[0] == "batch_norm":
                x = mod.apply_cols(x) if feature_major else mod.apply_rows(x)
            # dropout: identity outside training
        return x

    # named after the JAX package's ``MLP.apply``; it shadows
    # ``nn.Module.apply(fn)``, which this module does not use
    def apply(self, x: torch.Tensor, *, training: bool = False, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Row-major forward on (rows, features).  ``mask`` selects the real
        rows for training-mode BatchNorm statistics."""
        return self._run(x, training, feature_major=False)

    def apply_t(self, x: torch.Tensor, *, training: bool = False, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Feature-major forward on (features, rows); softmax normalises over
        the feature axis."""
        return self._run(x, training, feature_major=True)

    def __repr__(self):
        return f"MLP(name={self.name}, in={self.input_dim}, units={self.units}, bn={self.batch_normalization})"


# --------------------------------------------------------------------------
# Shape algebra (the reference's, as in gnnkeras_tpu.models.mlp)
# --------------------------------------------------------------------------


def get_inout_dims(
    net_name: str,
    dim_node_label,
    dim_arc_label: int,
    dim_target: int,
    focus: str,
    dim_state: int,
    hidden_units: Optional[Union[int, List[int]]] = None,
    *,
    layer: int = 0,
    get_state: bool = False,
    get_output: bool = False,
) -> Tuple[List[Tuple[int]], list]:
    """Input/output dims for the state and output MLPs, including the LGNN
    layer≥1 input growth.  Returns (per-type input shapes, layer units)."""
    assert layer >= 0
    assert focus in ("a", "n", "g")
    assert dim_state >= 0

    NL = np.array(dim_node_label, ndmin=1)
    AL, T = dim_arc_label, dim_target
    DS, GS, GO = dim_state, get_state, get_output

    if layer > 0:
        if DS != 0:
            NL = NL + DS * GS + T * (focus != "a") * GO
            AL = AL + T * (focus == "a") * GO
        else:
            NL = NL + layer * NL * GS + ((layer - 1) * GS + 1) * T * (focus != "a") * GO
            AL = AL + T * (focus == "a") * GO

    if net_name == "state":
        NL_general = np.sum(NL)
        input_shape = list(NL + NL_general + AL + 2 * DS)
        output_shape = DS if DS else NL
    elif net_name == "output":
        if len(NL) > 1:
            NL = np.array([0])
        input_shape = list((focus == "a") * (NL + AL + DS) + NL + DS)
        output_shape = T
    else:
        raise ValueError("net_name not in ['state', 'output']")

    input_shape = [(int(i),) for i in input_shape]
    if not hidden_units:
        hidden_units = []
    if isinstance(hidden_units, int):
        hidden_units = [hidden_units]
    return input_shape, list(hidden_units) + [output_shape]
