"""MLP blocks: an optional leading BatchNorm, a Dense stack with per-layer
activations and initialisers, and (Alpha)Dropout at caller-chosen
positions — the layer program of ``gnnkeras_tpu.models.mlp``.

``MLP`` is an ``nn.Module``: Dense layers hold ``kernel`` (in, out) and
``bias`` parameters, BatchNorm holds ``gamma``/``beta`` parameters and
``moving_mean``/``moving_var`` buffers ((f,), or (K, f) after
``stack_bn_state``), so the JAX package's variables copy
over leaf for leaf (``convert.variables_from_jax``).  ``apply`` is row-major
(rows, features), ``apply_t`` feature-major (features, rows).

In training mode BatchNorm normalises with masked batch moments (real rows
only, biased variance, count = max(Σmask, 1)) and ``run`` returns the
updated moving statistics (Keras momentum 0.99) as a new dict instead of
writing the buffers, so a loop can carry them; dropout draws its keep mask
from the ``torch.Generator`` the caller passes (none: identity).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
# Regularizers
# --------------------------------------------------------------------------


def get_regularizer(spec):
    """'l1' / 'l2' / ('l1_l2', a, b) / callable / None → fn(param) -> scalar."""
    if spec is None:
        return None
    if callable(spec):
        return spec
    if spec == "l1":
        return lambda p: 0.01 * torch.sum(torch.abs(p))
    if spec == "l2":
        return lambda p: 0.01 * torch.sum(torch.square(p))
    if isinstance(spec, (tuple, list)) and spec and spec[0] == "l1_l2":
        l1, l2 = float(spec[1]), float(spec[2])
        return lambda p: l1 * torch.sum(torch.abs(p)) + l2 * torch.sum(torch.square(p))
    raise ValueError(f"Unknown regularizer {spec!r}")


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

_BN_MOMENTUM = 0.99  # Keras BatchNormalization default
_BN_EPS = 1e-3

# Keras AlphaDropout constant: -selu_alpha * selu_scale.
_ALPHA_P = -1.7580993408473766


def _masked_moments(x: torch.Tensor, mask: Optional[torch.Tensor], feature_major: bool):
    """Per-feature mean and biased variance over the rows (row-major) or
    lanes (feature-major) that ``mask`` selects, count = max(Σmask, 1)."""
    axis = 1 if feature_major else 0
    if mask is None:
        m = torch.ones((1, x.shape[1]) if feature_major else (x.shape[0], 1), dtype=x.dtype, device=x.device)
    else:
        m = mask.to(x.dtype)[None, :] if feature_major else mask.to(x.dtype)[:, None]
    count = torch.clamp_min(torch.sum(m), 1.0)
    mean = torch.sum(x * m, dim=axis) / count
    centred = x - (mean[:, None] if feature_major else mean)
    var = torch.sum(torch.square(centred) * m, dim=axis) / count
    return mean, var


def _dropout_keep(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """The keep mask (1 with probability 1 − rate), drawn from ``generator``."""
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return (u < 1.0 - rate).to(x.dtype)


def _dropout_apply(x: torch.Tensor, rate: float, alpha: bool, keep: torch.Tensor) -> torch.Tensor:
    """Dropout (inverted scaling) or AlphaDropout (Keras' affine
    correction) at a given keep mask."""
    if alpha:
        a = ((1.0 - rate) * (1.0 + rate * _ALPHA_P**2)) ** -0.5
        b = -a * _ALPHA_P * rate
        return a * (x * keep + _ALPHA_P * (1.0 - keep)) + b
    return x * keep / (1.0 - rate)


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

    def normalize(self, x, mean, var, feature_major: bool):
        if feature_major:
            scale = torch.rsqrt(var + _BN_EPS) * self.gamma
            return (x - mean[:, None]) * scale[:, None] + self.beta[:, None]
        return (x - mean) * torch.rsqrt(var + _BN_EPS) * self.gamma + self.beta


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
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
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
        k_regs = _broadcast(kernel_regularizer, n, "kernel_regularizer")
        b_regs = _broadcast(bias_regularizer, n, "bias_regularizer")

        if isinstance(dropout_pos, int):
            dropout_pos = [dropout_pos]
        if isinstance(dropout_rate, float):
            dropout_rate = [dropout_rate for _ in (dropout_pos or [])]
        if dropout_rate is None or dropout_pos is None:
            dropout_rate, dropout_pos = [], []
        if len(dropout_rate) != len(dropout_pos):
            raise ValueError("Dropout parameters must have the same length")

        program: List[tuple] = [
            ("dense", u, a, ki, bi, kr, br) for u, a, ki, bi, kr, br in zip(units, acts, k_inits, b_inits, k_regs, b_regs)
        ]
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

    def stack_bn_state(self, iterations: int) -> None:
        """One set of moving statistics per unfolding iteration: every
        BatchNorm's buffers become (iterations, f), mean 0 and var 1 (the
        JAX package's ``per_iteration_bn`` stack).  ``run`` then takes one
        iteration's (f,) slice as ``bn_state``."""
        for layer, mod in zip(self.program, self.layers):
            if layer[0] == "batch_norm":
                like = mod.moving_mean
                mod.moving_mean = like.new_zeros((iterations, like.shape[-1]))
                mod.moving_var = like.new_ones((iterations, like.shape[-1]))

    def bn_state(self) -> Dict[str, torch.Tensor]:
        """The moving statistics, ``{"layers.{i}.moving_mean": ..., ...}``
        (the buffers themselves, keyed as in the state dict)."""
        return {
            f"layers.{i}.{key}": getattr(mod, key)
            for i, (layer, mod) in enumerate(zip(self.program, self.layers))
            if layer[0] == "batch_norm"
            for key in ("moving_mean", "moving_var")
        }

    def run(
        self,
        x: torch.Tensor,
        *,
        feature_major: bool,
        training: bool = False,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        bn_state: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The layer program on (rows, features), or (features, rows) when
        ``feature_major``.  ``bn_state`` (default: the buffers) holds the
        moving statistics that eval mode normalises with and training mode
        updates.  Returns (output, new moving statistics); the buffers are
        not written."""
        stats = self.bn_state() if bn_state is None else bn_state
        new_stats: Dict[str, torch.Tensor] = {}
        for i, (layer, mod) in enumerate(zip(self.program, self.layers)):
            if layer[0] == "dense":
                act = layer[2]
                if feature_major:
                    x = mod.kernel.T @ x + mod.bias[:, None]
                    x = torch.softmax(x, dim=0) if act == "softmax" else get_activation(act)(x)
                else:
                    x = get_activation(act)(x @ mod.kernel + mod.bias)
            elif layer[0] == "batch_norm":
                mean_key, var_key = f"layers.{i}.moving_mean", f"layers.{i}.moving_var"
                if training:
                    mean, var = _masked_moments(x, mask, feature_major)
                    new_stats[mean_key] = _BN_MOMENTUM * stats[mean_key] + (1.0 - _BN_MOMENTUM) * mean.detach()
                    new_stats[var_key] = _BN_MOMENTUM * stats[var_key] + (1.0 - _BN_MOMENTUM) * var.detach()
                else:
                    mean, var = stats[mean_key], stats[var_key]
                    new_stats[mean_key], new_stats[var_key] = mean, var
                x = mod.normalize(x, mean, var, feature_major)
            elif training and layer[1] > 0.0 and generator is not None:
                x = _dropout_apply(x, layer[1], layer[2], _dropout_keep(x, layer[1], generator))
        return x, new_stats

    # named after the JAX package's ``MLP.apply``; it shadows
    # ``nn.Module.apply(fn)``, which this module does not use
    def apply(self, x: torch.Tensor, *, training: bool = False, mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Row-major forward on (rows, features).  ``mask`` selects the real
        rows for training-mode BatchNorm statistics."""
        return self.run(x, feature_major=False, training=training, mask=mask, generator=generator)[0]

    def apply_t(self, x: torch.Tensor, *, training: bool = False, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Feature-major forward on (features, rows); softmax normalises over
        the feature axis and ``mask`` selects lanes."""
        return self.run(x, feature_major=True, training=training, mask=mask, generator=generator)[0]

    def regularization_loss(self) -> torch.Tensor:
        """Sum of the Dense layers' kernel and bias regularizer penalties."""
        total = torch.zeros((), dtype=torch_floatx(), device=next(self.parameters()).device)
        for layer, mod in zip(self.program, self.layers):
            if layer[0] != "dense":
                continue
            kr_fn, br_fn = get_regularizer(layer[5]), get_regularizer(layer[6])
            if kr_fn is not None:
                total = total + kr_fn(mod.kernel)
            if br_fn is not None:
                total = total + br_fn(mod.bias)
        return total

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
