"""Tensor parallelism: the state MLP's features sharded over a ``model``
process group, the counterpart of ``gnnkeras_tpu.parallel.tensor_parallel``.

Megatron-style alternating splits over the Dense stack (``plan``):

- even Dense layers are split by column (output features sharded; the
  BatchNorm, bias and activation after them act per feature and stay local);
- odd Dense layers are split by row (the contraction over the sharded
  features; the partial products are summed over the group, the bias added
  once);
- a trailing column split is gathered along the feature dimension
  (``collectives.all_gather(dim=...)``), so the unfolding's state stays
  replicated.

Features that do not divide the shard count are padded with zeros: the
padded features have zero kernel columns, bias and gamma, so they stay zero
through Dense, BatchNorm and an activation that maps 0 to 0, and add
nothing through the next layer's zero kernel rows; the gather drops them.

The variables are state dicts (``layers.{i}.kernel``, ...): ``shard_variables``
cuts an MLP's into one dict a shard, ``gather_variables`` joins them, and
``ShardedMLP`` is one rank's shard as a module whose ``run`` and
``bn_state`` stand in for the MLP's (the GNN's ``unfold(state_net=...)``).

Gradients: the port's collectives transpose as the JAX package's do (the
backward of a sum over the group is a sum of the cotangents, of the
all-gather an all-reduce and the rank's slice), so each rank's autograd of
its own loss computes what ``jax.grad`` inside ``shard_map`` computes: the
gradient of the sum of the D ranks' losses.  Every rank computes the same
loss L, so the JAX package's recipe carries over unchanged: an objective of
L/D, then the gradients of the tied (replicated) leaves and of the output
net summed over the group, the sharded leaves left as they are
(``tied_mask``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gnnkeras_tpu_torch.models.mlp import (_BN_EPS, _BN_MOMENTUM, _dropout_apply, _dropout_keep, _masked_moments,
                                           get_activation)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _Leaves(nn.Module):
    """A program entry's local parameters and buffers, shaped as given."""

    def __init__(self, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            setattr(self, name, nn.Parameter(value.detach().clone()))
        for name, value in buffers.items():
            self.register_buffer(name, value.detach().clone())


class ShardedMLP(nn.Module):
    """One rank's shard of a ``TensorParallelMLP``: ``layers.{i}.kernel``
    and the rest in their local shapes, with the MLP's ``run`` /
    ``bn_state`` surface (``group`` there spans BatchNorm's row moments)."""

    def __init__(self, tp: "TensorParallelMLP", variables: Dict[str, torch.Tensor]):
        super().__init__()
        self.tp = tp
        modules = []
        for i, layer in enumerate(tp.mlp.program):
            names = {"dense": ("kernel", "bias"), "batch_norm": ("gamma", "beta")}.get(layer[0], ())
            bufs = ("moving_mean", "moving_var") if layer[0] == "batch_norm" else ()
            modules.append(_Leaves({n: variables[f"layers.{i}.{n}"] for n in names},
                                   {n: variables[f"layers.{i}.{n}"] for n in bufs}))
        self.layers = nn.ModuleList(modules)

    def bn_state(self) -> Dict[str, torch.Tensor]:
        return {f"layers.{i}.{key}": getattr(mod, key)
                for i, (layer, mod) in enumerate(zip(self.tp.mlp.program, self.layers))
                if layer[0] == "batch_norm" for key in ("moving_mean", "moving_var")}

    def run(self, x, *, feature_major: bool, training: bool = False, mask=None, generator=None, bn_state=None,
            group=None):
        return self.tp.apply(self, x, feature_major=feature_major, training=training, mask=mask,
                             generator=generator, bn_state=bn_state, bn_group=group)


class TensorParallelMLP:
    """The sharded view of an ``MLP`` over ``n_shards`` ranks of the
    ``model`` process ``group`` (default: the world).  ``plan`` marks each
    program entry 'col' (a column-split Dense and the BatchNorm / dropout
    up to the next Dense), 'row' (a row-split Dense) or 'rep'
    (replicated)."""

    def __init__(self, mlp, n_shards: int, group=None):
        self.mlp = mlp
        self.n_shards = int(n_shards)
        self.group = group
        plan: List[str] = []
        dense_parity, current = 0, "rep"
        for layer in mlp.program:
            if layer[0] == "dense":
                current = "col" if dense_parity % 2 == 0 else "row"
                plan.append(current)
                if current == "row":
                    current = "rep"
                dense_parity += 1
            else:
                plan.append(current)
        self.plan = plan
        self.gather_output = current == "col"
        for layer, tag in zip(mlp.program, plan):
            if layer[0] == "dense" and tag == "col" and layer[2] == "softmax":
                if not self.gather_output or layer is not mlp.program[-1]:
                    raise ValueError("softmax on a column-split layer requires gathering first")

    def _padded_units(self, units: int) -> int:
        return _round_up(units, self.n_shards)

    # -- variables ------------------------------------------------------------
    def shard_variables(self, variables: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """An MLP's state dict (``layers.{i}.kernel``, ...) → one dict a
        shard, column-split features zero-padded to a multiple of D."""
        D = self.n_shards
        shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(D)]

        def put(key, parts):
            for d in range(D):
                shards[d][key] = parts[d].contiguous()

        for i, (layer, tag) in enumerate(zip(self.mlp.program, self.plan)):
            key = f"layers.{i}."
            if layer[0] == "dense":
                kernel, bias = variables[key + "kernel"], variables[key + "bias"]
                if tag == "col":
                    pad = self._padded_units(kernel.shape[1]) - kernel.shape[1]
                    put(key + "kernel", torch.chunk(F.pad(kernel, (0, pad)), D, dim=1))
                    put(key + "bias", torch.chunk(F.pad(bias, (0, pad)), D))
                else:
                    pad = self._padded_units(kernel.shape[0]) - kernel.shape[0]
                    put(key + "kernel", torch.chunk(F.pad(kernel, (0, 0, 0, pad)), D, dim=0))
                    put(key + "bias", [bias] * D)
            elif layer[0] == "batch_norm":
                for name in ("gamma", "beta", "moving_mean", "moving_var"):
                    v = variables[key + name]
                    if tag == "col":
                        pad = self._padded_units(v.shape[-1]) - v.shape[-1]
                        put(key + name, torch.chunk(F.pad(v, (0, pad)), D, dim=-1))
                    else:
                        put(key + name, [v] * D)
        return shards

    def gather_variables(self, shards: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """The inverse of ``shard_variables`` (the padding dropped)."""
        out: Dict[str, torch.Tensor] = {}
        feat = self.mlp.input_dim[0]
        for i, (layer, tag) in enumerate(zip(self.mlp.program, self.plan)):
            key = f"layers.{i}."
            if layer[0] == "dense":
                if tag == "col":
                    out[key + "kernel"] = torch.cat([s[key + "kernel"] for s in shards], dim=1)[:, :layer[1]]
                    out[key + "bias"] = torch.cat([s[key + "bias"] for s in shards])[:layer[1]]
                else:
                    out[key + "kernel"] = torch.cat([s[key + "kernel"] for s in shards], dim=0)[:feat]
                    out[key + "bias"] = shards[0][key + "bias"]
                feat = layer[1]
            elif layer[0] == "batch_norm":
                for name in ("gamma", "beta", "moving_mean", "moving_var"):
                    if tag == "col":
                        out[key + name] = torch.cat([s[key + name] for s in shards], dim=-1)[..., :feat]
                    else:
                        out[key + name] = shards[0][key + name]
        return out

    def tied_mask(self) -> Dict[str, bool]:
        """Each local parameter's name → True where it is tied (replicated
        on every shard: its gradient is summed over the group), False where
        it is sharded (its gradient is complete as it is)."""
        out = {}
        for i, (layer, tag) in enumerate(zip(self.mlp.program, self.plan)):
            if layer[0] == "dense":
                out[f"layers.{i}.kernel"] = False
                out[f"layers.{i}.bias"] = tag == "row"
            elif layer[0] == "batch_norm":
                out[f"layers.{i}.gamma"] = out[f"layers.{i}.beta"] = tag != "col"
        return out

    def local_module(self, variables: Dict[str, torch.Tensor]) -> ShardedMLP:
        """One shard's variables (an entry of ``shard_variables``) as a
        module."""
        return ShardedMLP(self, variables)

    # -- the sharded forward ---------------------------------------------------
    def apply(self, local: ShardedMLP, x: torch.Tensor, *, feature_major: bool = False, training: bool = False,
              mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
              bn_state: Optional[Dict[str, torch.Tensor]] = None, bn_group=None):
        """The MLP's program on this rank's shard: (output, new moving
        statistics of the local BatchNorms).  ``bn_group`` spans BatchNorm's
        row moments (the ``graph`` group when rows are partitioned); the
        feature split never needs a moment collective."""
        from gnnkeras_tpu_torch.parallel.collectives import all_gather, psum

        stats = local.bn_state() if bn_state is None else bn_state
        new_stats: Dict[str, torch.Tensor] = {}
        deferred = None
        softmax = lambda t: torch.softmax(t, dim=0 if feature_major else -1)
        for i, (layer, tag, mod) in enumerate(zip(self.mlp.program, self.plan, local.layers)):
            if layer[0] == "dense":
                act = softmax if layer[2] == "softmax" else get_activation(layer[2])
                bias = mod.bias[:, None] if feature_major else mod.bias
                prod = mod.kernel.T @ x if feature_major else x @ mod.kernel
                if tag == "col":
                    x = prod + bias
                    if layer[2] == "softmax":
                        deferred = act
                    else:
                        x = act(x)
                else:
                    x = act(psum(prod, self.group) + bias)
            elif layer[0] == "batch_norm":
                mean_key, var_key = f"layers.{i}.moving_mean", f"layers.{i}.moving_var"
                if training:
                    mean, var = _masked_moments(x, mask, feature_major, bn_group)
                    new_stats[mean_key] = _BN_MOMENTUM * stats[mean_key] + (1.0 - _BN_MOMENTUM) * mean.detach()
                    new_stats[var_key] = _BN_MOMENTUM * stats[var_key] + (1.0 - _BN_MOMENTUM) * var.detach()
                else:
                    mean, var = stats[mean_key], stats[var_key]
                    new_stats[mean_key], new_stats[var_key] = mean, var
                if feature_major:
                    x = (x - mean[:, None]) * (torch.rsqrt(var + _BN_EPS) * mod.gamma)[:, None] + mod.beta[:, None]
                else:
                    x = (x - mean) * torch.rsqrt(var + _BN_EPS) * mod.gamma + mod.beta
            elif training and layer[1] > 0.0 and generator is not None:
                gen = generator
                if tag == "col":  # a mask of its own on every feature shard
                    from gnnkeras_tpu_torch.parallel.mesh import fold_in

                    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
                    gen = torch.Generator(device=generator.device).manual_seed(
                        fold_in(seed, dist.get_rank(self.group)))
                x = _dropout_apply(x, layer[1], layer[2], _dropout_keep(x, layer[1], gen))
        if self.gather_output:
            x = all_gather(x, self.group, dim=0 if feature_major else 1)
            x = x[:self.mlp.output_dim] if feature_major else x[:, :self.mlp.output_dim]
            if deferred is not None:
                x = deferred(x)
        return x, new_stats


def shard_model_variables(tp: TensorParallelMLP, state_dict: dict) -> List[Dict[str, torch.Tensor]]:
    """A GNN's state dict → one dict a model shard: ``net_state.*`` cut by
    ``tp``, the rest replicated."""
    shards = tp.shard_variables(_net_state_dict(state_dict, "net_state."))
    rest = {k: v for k, v in state_dict.items() if not k.startswith("net_state.")}
    return [{**{f"net_state.{k}": v for k, v in s.items()}, **rest} for s in shards]


def gather_model_variables(tp: TensorParallelMLP, shards: List[dict]) -> dict:
    """The inverse of ``shard_model_variables``."""
    net = tp.gather_variables([_net_state_dict(s, "net_state.") for s in shards])
    rest = {k: v for k, v in shards[0].items() if not k.startswith("net_state.")}
    return {**{f"net_state.{k}": v for k, v in net.items()}, **rest}


def _net_state_dict(state_dict: dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _gather_shards(local: ShardedMLP, group) -> List[Dict[str, torch.Tensor]]:
    """Every rank's shard variables, in rank order (an all-gather of the
    local state dicts through host memory)."""
    mine = {k: v.detach().cpu() for k, v in local.state_dict().items()}
    shards = [None] * dist.get_world_size(group)
    dist.all_gather_object(shards, mine, group=group)
    return shards


class TensorParallelGNN:
    """The replicated-data, model-sharded engine around a homogeneous
    ``GNNnodeBased`` / ``GNNarcBased`` / ``GNNgraphBased``: the state net's
    features are sharded over the ``axis`` group of ``mesh`` (default: the
    world), the aggregation and the output net run replicated on every
    rank.  The unfolding is the model's own (``unfold(state_net=...)``):
    the feature-major engine on a strip batch, so the strip kernel
    aggregates, with the shard's net feature-major."""

    def __init__(self, gnn, mesh=None, axis: str = "model"):
        from gnnkeras_tpu_torch.parallel.mesh import axis_group

        if getattr(gnn, "per_iteration_bn", False):
            raise ValueError("per_iteration_bn models are not supported by TensorParallelGNN (the wrapper "
                             "re-implements the unfold with shared BatchNorm moments)")
        if isinstance(gnn.net_state, nn.ModuleList) or hasattr(gnn, "gnns"):
            raise ValueError("TensorParallelGNN shards the state net of a homogeneous single GNN")
        self.gnn = gnn
        self.group = axis_group(mesh, axis)
        self.n_devices = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.tp_state = TensorParallelMLP(gnn.net_state, self.n_devices, self.group)
        self.local: Optional[ShardedMLP] = None
        self._opt = None

    def shard_variables(self, state_dict: Optional[dict] = None) -> List[Dict[str, torch.Tensor]]:
        """The model's state dict (default: its own) → one dict a shard:
        ``net_state.*`` sharded, ``net_output.*`` replicated."""
        return shard_model_variables(self.tp_state, self.gnn.state_dict() if state_dict is None else state_dict)

    def gather_variables(self, shards: List[dict]) -> dict:
        """The inverse of ``shard_variables``: the model's full state dict."""
        return gather_model_variables(self.tp_state, shards)

    def _fresh_local(self) -> ShardedMLP:
        self.gnn.build()
        shard = self.tp_state.shard_variables(_net_state_dict(self.gnn.state_dict(), "net_state."))[self.rank]
        return self.tp_state.local_module(shard).to(self.gnn.device)

    def forward(self, batch, training: bool = False, generator: Optional[torch.Generator] = None):
        """(k, state, out) on the model's current weights, sharded afresh;
        the same on every rank."""
        local = self._fresh_local()
        if generator is None and (self.gnn.state_vect_dim > 0 or training):
            generator = self.gnn.next_rng()
        with torch.no_grad():
            k, state, out, _, _ = self.gnn.forward(batch, training=training, generator=generator, state_net=local)
        return k, state, out

    def train_step(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        """One step on this rank's shard (module docstring); the shard and
        its optimizer persist from step to step (``gather_into_model``
        writes the trained weights back).  Returns {"loss", "k"}."""
        from gnnkeras_tpu_torch.parallel.collectives import psum_grads
        from gnnkeras_tpu_torch.training.losses import masked_mean

        gnn = self.gnn
        if gnn.loss is None or gnn.optimizer is None:
            raise RuntimeError("call gnn.compile() before training the tensor-parallel model")
        if self.local is None:
            self.local = self._fresh_local()
            self._opt = gnn.optimizer([*self.local.parameters(), *gnn.net_output.parameters()])
        if generator is None:
            generator = gnn.next_rng()
        self._opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            k, _, out, _, new_bn = gnn.forward(batch, training=True, generator=generator, state_net=self.local)
            loss = masked_mean(gnn.loss(batch.targets, out), batch.target_mask, batch.sample_weight)
            (loss / self.n_devices).backward()
        tied = self.tp_state.tied_mask()
        psum_grads([p for n, p in self.local.named_parameters() if tied[n]] + list(gnn.net_output.parameters()),
                   self.group)
        if gnn.average_st_grads:
            scale_shard_grads(self.local, k)
        self._opt.step()
        load_split_bn_state(gnn, self.local, new_bn)
        return {"loss": loss.detach(), "k": k}

    def gather_into_model(self) -> None:
        """Write the trained shards, gathered from every rank, back into the
        model's state net (a collective)."""
        if self.local is not None:
            gather_into(self.tp_state, self.local, self.gnn.net_state)

    def fit(self, batch, epochs: int = 1, verbose: int = 1, seed: int = 0) -> dict:
        """Full-batch tensor-parallel training; the model's weights are
        written back gathered.  Returns {"loss": [per epoch]}."""
        gnn = self.gnn
        if gnn.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        gnn.build(seed=seed)
        self.local = None
        history = {"loss": []}
        for epoch in range(epochs):
            logs = self.train_step(batch, gnn.next_rng())
            history["loss"].append(float(logs["loss"]))
            if verbose and self.rank == 0:
                print(f"Epoch {epoch + 1}/{epochs} loss: {history['loss'][-1]:.4f}")
        self.gather_into_model()
        return history


def gather_into(tp: TensorParallelMLP, local: ShardedMLP, mlp) -> None:
    """Gather every rank's shard over ``tp``'s group and write the whole
    variables into ``mlp`` in place (a collective)."""
    full = tp.gather_variables(_gather_shards(local, tp.group))
    with torch.no_grad():
        for name, t in {**dict(mlp.named_parameters()), **dict(mlp.named_buffers())}.items():
            t.copy_(full[name].to(t.device))


def scale_shard_grads(local: ShardedMLP, k) -> None:
    """``average_st_grads`` on a state-net shard: its gradients divided, in
    place, by max(k, 1)."""
    denom = torch.clamp_min(torch.as_tensor(k, dtype=torch.float32), 1.0)
    for p in local.parameters():
        if p.grad is not None:
            p.grad.div_(denom)


def load_split_bn_state(gnn, local: Optional[ShardedMLP], new_bn: dict) -> None:
    """New moving statistics keyed as the model's state dict: the state
    net's into ``local`` (a tensor-parallel shard) when given, the rest into
    the model."""
    targets = {**dict(gnn.named_buffers())}
    if local is not None:
        targets.update({f"net_state.{k}": v for k, v in local.named_buffers()})
    with torch.no_grad():
        for key, value in new_bn.items():
            targets[key].copy_(value)
