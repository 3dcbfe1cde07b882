"""Edge-partitioned training of one large graph over P ranks.

    python -m gnnkeras_tpu_torch.tools.partitioned_large_graph [--nodes N] [--parts P]
        [--epochs E] [--steps-per-launch K] [--transport collective|pallas_ring] [--device cuda|cpu]
    torchrun --nproc-per-node P -m gnnkeras_tpu_torch.tools.partitioned_large_graph ...

The port of the JAX package's ``examples/partitioned_large_graph.py``: the
same banded graph (each node's 8 arcs within ±64 of it, wrapping; meshes and
road networks have that locality), the same node-focused model (a 22→8 selu
state net and an 8→2 linear output net behind BatchNorm, dim_state 0,
5 iterations, Adam at 0.001, mse), partitioned with ``dense_blocks=True``
and trained full batch through ``PartitionedGNN.fit``.  The tool starts
``--parts`` ranks itself (``parallel/launch.spawn``; the partition is built
once, here, and each rank receives its own part), or, under ``torchrun``,
joins the group ``torchrun`` made and builds the partition in every rank.
All ranks share the card(s) present (rank r on card r mod the count); gloo
is the backend.  ``--transport pallas_ring`` exchanges the halo through the
ring kernel: it has no backward, so the tool then skips ``fit`` and runs
``evaluate`` only.  Prints from rank 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gnnkeras_tpu_torch.graph.graph import GraphObject


def build_graph(n_nodes: int, per_node: int = 8, band: int = 64, seed: int = 0) -> GraphObject:
    """The example's graph: ``per_node`` arcs from every node to one at most
    ``band`` away (wrapping), 2 normal arc-label features, 8 normal node
    labels and 2 normal targets per node, average aggregation."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_nodes), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n_nodes
    arcs = np.concatenate(
        [np.stack([src, dst], 1).astype(np.float32), rng.normal(size=(len(src), 2)).astype(np.float32)], axis=1
    )
    nodes = rng.normal(size=(n_nodes, 8)).astype(np.float32)
    canon = GraphObject(nodes=nodes, arcs=arcs, targets=np.ones((n_nodes, 2), np.float32), focus="n")
    return GraphObject(nodes=nodes, arcs=canon.arcs, targets=rng.normal(size=(n_nodes, 2)).astype(np.float32),
                       focus="n", aggregation_mode="average", arcs_canonical=True)


def build_model(device, seed: int = 0):
    from gnnkeras_tpu_torch.models.gnn import GNNnodeBased
    from gnnkeras_tpu_torch.models.mlp import MLP, get_inout_dims

    inp_s, layers_s = get_inout_dims("state", 8, 2, 2, "n", 0)
    inp_o, layers_o = get_inout_dims("output", 8, 2, 2, "n", 0)
    gnn = GNNnodeBased(
        MLP(inp_s[0], layers_s, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal"),
        MLP(inp_o[0], layers_o, "linear", kernel_initializer="glorot_normal", bias_initializer="glorot_normal"),
        0, 5, 0.0,
    ).build(seed=seed, device=device)
    gnn.compile(optimizer="adam:0.001", loss="mse")
    return gnn


def run_rank(rank: int, world: int, shard, args) -> dict:
    """One rank: its part on its device, ``fit`` (collective transport) and
    ``evaluate`` through ``args.transport``.  Returns the history and logs."""
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shard = shard.to(device)
    gnn = build_model(device)
    history = {}
    if args.transport == "collective":
        t0 = time.perf_counter()
        history = PartitionedGNN(gnn).fit(shard, epochs=args.epochs, verbose=1,
                                          steps_per_launch=args.steps_per_launch).history
        if rank == 0:
            dt = time.perf_counter() - t0
            print(f"{args.epochs} epochs in {dt:.1f}s ({dt / args.epochs * 1000:.1f} ms/epoch, "
                  f"loss {history['loss'][0]:.4f} -> {history['loss'][-1]:.4f})", flush=True)
    elif rank == 0:
        print("transport pallas_ring: no training (the ring has no backward); evaluate only", flush=True)
    logs = PartitionedGNN(gnn, transport=args.transport).evaluate(shard, verbose=1)
    return {"history": history, "evaluate": logs}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=500_000)
    p.add_argument("--parts", type=int, default=4, help="ranks to start (ignored under torchrun)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-launch", type=int, default=10)
    p.add_argument("--transport", choices=("collective", "pallas_ring"), default="collective")
    p.add_argument("--device", default="cuda")
    return p


def main() -> int:
    from gnnkeras_tpu_torch.parallel.partition import partition_graph

    args = _parser().parse_args()
    if "RANK" in os.environ:  # under torchrun: join its group, build the partition here
        from gnnkeras_tpu_torch.parallel.mesh import init_process_group

        import torch.distributed as dist

        rank, world = init_process_group()
        g = build_graph(args.nodes)
        run_rank(rank, world, partition_graph(g, world, dense_blocks=True).shard(rank, "cpu"), args)
        dist.destroy_process_group()
        return 0
    from gnnkeras_tpu_torch.parallel.launch import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("partitioned_large_graph: no NVIDIA card; pass --device cpu")
    g = build_graph(args.nodes)
    print(f"graph: {g.nodes.shape[0]:,} nodes / {g.arcs.shape[0]:,} arcs, {args.parts} ranks on {args.device}")
    pg = partition_graph(g, args.parts, dense_blocks=True)
    threads = max(1, (os.cpu_count() or 1) // args.parts)
    spawn(run_rank, args.parts, [(pg.shard(r, "cpu"), args) for r in range(args.parts)], threads=threads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
