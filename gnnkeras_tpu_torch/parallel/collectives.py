"""Collectives over a process group with the gradients of the JAX package's
``psum``, ``pmax`` and ``all_gather(tiled=True)`` inside ``shard_map``.

- ``psum(x)``: the sum over the group; its gradient is the sum of the
  ranks' cotangents (psum transposes to psum).
- ``pmax(x)``: the elementwise maximum, not differentiable (the engine's
  convergence flag).
- ``all_gather(x)``: the ranks' ``x`` concatenated along dim 0 in rank
  order; its gradient is each rank's slice of the summed cotangents (an
  all-reduce, then the rank's own rows: gloo has no reduce-scatter, so
  ``torch.distributed.nn``'s all-gather cannot run backward there).

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
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        x_host = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(x_host) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x_host, group=group)
        return torch.cat(parts, dim=0).to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, dist.ReduceOp.SUM, ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, differentiable."""
    return _Psum.apply(x, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the group's ranks (no gradient)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` stacked along dim 0 in rank order, differentiable."""
    return _AllGather.apply(x, group)


def pmean_grads(params, group=None) -> None:
    """Replace every parameter's ``.grad`` by its mean over the group, in
    place (the engine's pmean of the gradients): one all-reduce of all the
    gradients, flattened."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), dist.ReduceOp.SUM, group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
