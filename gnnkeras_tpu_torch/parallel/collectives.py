"""Collectives over a process group with the gradients of the JAX package's
``psum``, ``pmax`` and ``all_gather(tiled=True)`` inside ``shard_map``.

- ``psum(x)``: the sum over the group; its gradient is the sum of the
  ranks' cotangents (psum transposes to psum).
- ``pmax(x)``: the elementwise maximum, not differentiable (the engine's
  convergence flag).
- ``all_gather(x, dim=0)``: the ranks' ``x`` concatenated along ``dim`` in
  rank order (dim 0: rows, the partitioned engine's state exchange; dim 1:
  features, tensor parallelism's gather after a column split); its gradient
  is each rank's slice of the summed cotangents (an all-reduce, then the
  rank's own slice: gloo has no reduce-scatter, so
  ``torch.distributed.nn``'s all-gather cannot run backward there).
- ``weighted_mean(tensors, w)``: ``psum(w·x) / max(psum(w), 1)`` for every
  tensor, through one flat buffer (data parallelism's average over the real
  batches of a group, where a filler rank has w = 0).

Every rank calls each of these, forward and backward, in the same order.

The gloo backend moves only CPU tensors (on the card it aborts the process
on a CUDA tensor's device pointer), and NCCL refuses two ranks on one card,
so CUDA tensors are staged through host memory: copied to the CPU, reduced
or gathered there, copied back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the group (through host memory)."""
    y = x.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.rank, ctx.size, ctx.dim = group, dist.get_rank(group), x.shape[dim], dim
        x_host = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(x_host) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x_host, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, dist.ReduceOp.SUM, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, differentiable."""
    return _Psum.apply(x, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the group's ranks (no gradient)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order,
    differentiable."""
    return _AllGather.apply(x, group, dim)


def weighted_mean(tensors, weight: float, group=None) -> list:
    """``psum(weight·x) / max(psum(weight), 1)`` over the group for each of
    ``tensors`` (new tensors, no gradient), through one all-reduce of a flat
    buffer that carries the weight in its last entry.  Not divided by the
    world size: a rank of weight 0 (a data-parallel group's filler batch)
    adds nothing to the sums nor to the count."""
    if not tensors:
        return []
    device = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) * weight for t in tensors] +
                     [torch.full((1,), float(weight), dtype=torch.float32, device=device)])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, group)
    denom = torch.clamp_min(flat[-1], 1.0)
    out, offset = [], 0
    for t in tensors:
        out.append((flat[offset:offset + t.numel()] / denom).view_as(t).to(t.dtype))
        offset += t.numel()
    return out


def pmean_grads(params, group=None) -> None:
    """Replace every parameter's ``.grad`` by its mean over the group, in
    place (the engine's pmean of the gradients): one all-reduce of all the
    gradients, flattened."""
    _reduce_grads(params, group, mean=True)


def psum_grads(params, group=None) -> None:
    """Replace every parameter's ``.grad`` by its sum over the group, in
    place (tensor parallelism's tied leaves): one all-reduce, flattened."""
    _reduce_grads(params, group, mean=False)


def _reduce_grads(params, group, mean: bool) -> None:
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), dist.ReduceOp.SUM, group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def pmean(tensors, group=None) -> list:
    """The mean over the group's ranks of each of ``tensors`` (new tensors,
    no gradient): ``weighted_mean`` with every rank's weight 1."""
    return weighted_mean(tensors, 1.0, group)


def agree_logs(logs: dict, group=None) -> dict:
    """Rank 0's logs on every rank (float64 through a broadcast), so the
    callbacks of every rank take the same decisions."""
    group = dist.group.WORLD if group is None else group
    keys = list(logs)
    values = torch.tensor([float(logs[k]) for k in keys], dtype=torch.float64)
    dist.broadcast(values, src=dist.get_global_rank(group, 0), group=group)
    return dict(zip(keys, values.tolist()))


def take_rank0_tensors(tensors, group=None) -> None:
    """Every rank's ``tensors`` set to rank 0's, in place (one broadcast
    through host memory): parameters and moving statistics after a restore
    or a callback's change."""
    group = dist.group.WORLD if group is None else group
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).cpu() for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def rank0_fit_hooks(model, group=None, verbose: int = 1) -> dict:
    """``run_fit_loop``'s keyword arguments for a fit that every rank of
    ``group`` runs on its own copy of ``model``: rank 0 prints and writes
    the checkpoints, the ranks meet at a barrier around a write, and after
    a restore or a callback's change of the weights every rank takes rank
    0's (a captured evaluation whose tensors a restore replaced is dropped,
    as the single-device fit drops it)."""
    from gnnkeras_tpu_torch.training.trainer import drop_stale_captures

    group = dist.group.WORLD if group is None else group

    def take_rank0_weights():
        take_rank0_tensors([*model.parameters(), *model.buffers()], group)
        drop_stale_captures(model)

    rank0 = dist.get_rank(group) == 0
    return dict(verbose=verbose if rank0 else 0, writer=rank0, barrier=lambda: dist.barrier(group=group),
                on_resume=take_rank0_weights, on_weights_mutated=take_rank0_weights)
