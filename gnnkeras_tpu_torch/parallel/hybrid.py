"""Hybrid data-parallel × graph-partitioned (× tensor-parallel) training,
the counterpart of ``gnnkeras_tpu.parallel.hybrid``.

A ``("data", "graph")`` or ``("data", "graph", "model")`` mesh
(``parallel.mesh.make_mesh``): each data replica trains on its own large
graph, whose node rows are partitioned over its ``graph`` group
(``PartitionedGNN``); with ``PartitionedGNN(tp_shards > 1)`` the state net's
features are also sharded over the ``model`` group.  ``stack_partitioned``
is the counterpart of the JAX package's stacking of the replicas' graphs:
it gives this rank its shard of its own replica's graph.

The gradients follow the JAX package's recipes (``jax.grad`` inside
``shard_map`` differentiates the sum of the per-device losses; each rank's
autograd of its own loss computes the same here, since the collectives'
backward sums the ranks' cotangents):

- two axes (JAX ``hybrid.py:52-77``): the mean of the gradients over
  ``graph`` (every rank of a graph group computes the group's loss), the
  ``average_st_grads`` scaling, then the mean over ``data`` of the
  gradients, the new moving statistics and the loss;
- three axes (JAX ``hybrid.py:104-135``): an objective of L / (Dg·Dm), the
  scaling, the sum of every gradient over ``graph``, the sum over ``model``
  of the tied leaves and of the output net (the sharded leaves are complete
  as they are), then the mean over ``data``.

Each rank holds only the optimizer state of what it holds: with the model
axis, its shard of the state net and the replicated output net.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def stack_partitioned(pgs: Sequence, mesh, device="cuda", data_axis: str = "data", graph_axis: str = "graph"):
    """This rank's ``GraphShard``: part ``mesh.index(graph_axis)`` of the
    data replica ``mesh.index(data_axis)``'s ``PartitionedGraph``."""
    return pgs[mesh.index(data_axis)].shard(mesh.index(graph_axis), device)


def make_hybrid_train_step(pgnn, mesh, data_axis: str = "data", graph_axis: str = "graph",
                           model_axis: str = "model"):
    """The hybrid step on this rank: ``step(shard, generator=None) ->
    {"loss", "k"}`` (module docstring).  ``pgnn`` is a compiled
    ``PartitionedGNN`` over ``mesh.group(graph_axis)`` (with ``tp_shards >
    1`` and ``model_group=mesh.group(model_axis)`` for three axes).  The
    step trains the model in place (and, with the model axis, the engine's
    shard of the state net, ``pgnn.tp_local_module()``; gather it back with
    ``pgnn.gather_tp_variables``).  Without a generator each step draws
    the model stream's next seed folded with the data index."""
    from gnnkeras_tpu_torch.parallel.collectives import pmean, pmean_grads, psum_grads
    from gnnkeras_tpu_torch.parallel.mesh import rank_generator
    from gnnkeras_tpu_torch.parallel.tensor_parallel import load_split_bn_state, scale_shard_grads
    from gnnkeras_tpu_torch.training.trainer import _optimizer

    gnn = pgnn.gnn
    if gnn.loss is None or gnn.optimizer is None:
        raise RuntimeError("call gnn.compile() before building the hybrid train step")
    pgnn._require_collective("training")
    data_group, data_index = mesh.group(data_axis), mesh.index(data_axis)
    graph_group = pgnn.group
    tp = pgnn.tp_state
    if tp is None:
        local = None
        params = list(gnn.parameters())
        opt = _optimizer(gnn)
    else:
        local = pgnn.tp_local_module()
        params = [*local.parameters(), *gnn.net_output.parameters()]
        opt = gnn.optimizer(params)
        tied = tp.tied_mask()
        tied_params = [p for n, p in local.named_parameters() if tied[n]] + list(gnn.net_output.parameters())
        scale = mesh.shape[mesh.axis_names.index(graph_axis)] * mesh.shape[mesh.axis_names.index(model_axis)]

    def scale_state_grads(k):
        if local is None:
            gnn.scale_state_grads(k)
        else:
            scale_shard_grads(local, k)

    def step(shard, generator: Optional[torch.Generator] = None) -> dict:
        if generator is None:
            generator = rank_generator(gnn, data_index)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, k, new_bn = pgnn._local_loss(shard, generator)
            (loss if tp is None else loss / scale).backward()
        if tp is None:
            pmean_grads(params, graph_group)
            if gnn.average_st_grads:
                scale_state_grads(k)
        else:
            if gnn.average_st_grads:
                scale_state_grads(k)
            psum_grads(params, graph_group)
            psum_grads(tied_params, pgnn.model_group)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        keys = list(new_bn)
        averaged = pmean(grads + [new_bn[key] for key in keys] + [loss.detach()], data_group)
        for p, g in zip(params, averaged):
            p.grad = g
        opt.step()
        load_split_bn_state(gnn, local, dict(zip(keys, averaged[len(params):-1])))
        return {"loss": averaged[-1], "k": k}

    return step
