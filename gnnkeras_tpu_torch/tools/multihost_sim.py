"""Simulated multi-host run of the hybrid data × graph step, the port of the
JAX package's ``scripts/multihost_sim.py``.

``launch`` starts ``n_hosts × per_host`` ranks on this machine
(``parallel/launch.spawn``, gloo) and gives each the environment torchrun
gives a rank on a real cluster: ``GROUP_RANK`` (its host), ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``.  Each rank builds the mesh through
``make_multihost_mesh`` (rows are hosts, so the graph axis stays inside a
host and only the data axis's gradient mean crosses hosts) and runs
``run_steps``: a node-focused GNN trained by SGD on two 32-node graphs, one
a data replica, each partitioned over a host's ranks.  Every rank must
report the same losses, and the losses equal those of the same steps on a
plain ``make_mesh`` of the same shape.

Run:

    python -m gnnkeras_tpu_torch.tools.multihost_sim [--hosts 2] [--per-host 4] [--steps 3] [--device cpu]

It prints one JSON line a rank and exits non-zero when the ranks disagree.
The ranks share the card; ``--device cpu`` runs the simulation on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

DEVICES_PER_HOST = 4
N_HOSTS = 2
STEPS = 3


def build_problem(per_host: int = DEVICES_PER_HOST, n_hosts: int = N_HOSTS, device="cuda"):
    """The model (built from seed 1, compiled with SGD 0.1 and mse) and one
    ``PartitionedGraph`` of a 32-node graph a data replica, each cut into
    ``per_host`` parts."""
    from gnnkeras_tpu_torch.graph.graph import GraphObject
    from gnnkeras_tpu_torch.models.gnn import GNNnodeBased
    from gnnkeras_tpu_torch.models.mlp import MLP, get_inout_dims
    from gnnkeras_tpu_torch.parallel.partition import partition_graph

    def one_graph(seed):
        r = np.random.default_rng(seed)
        n = 32
        src = np.repeat(np.arange(n), 2)
        dst = (src + np.tile([1, 2], n)) % n
        arcs = np.concatenate([np.stack([src, dst], 1), r.normal(size=(len(src), 2))], axis=1)
        return GraphObject(nodes=r.normal(size=(n, 3)), arcs=arcs, targets=r.normal(size=(n, 2)), focus="n",
                           aggregation_mode="average")

    inp_s, layers_s = get_inout_dims("state", 3, 2, 2, "n", 0)
    inp_o, layers_o = get_inout_dims("output", 3, 2, 2, "n", 0)
    gnn = GNNnodeBased(
        MLP(input_dim=inp_s[0], layers=layers_s, activations="tanh", kernel_initializer="lecun_normal",
            bias_initializer="lecun_normal"),
        MLP(input_dim=inp_o[0], layers=layers_o, activations="linear", kernel_initializer="glorot_normal",
            bias_initializer="zeros"),
        0, 6, 0.01,
    )
    gnn.compile(optimizer="sgd:0.1", loss="mse")
    gnn.build(seed=1, device=device)
    return gnn, [partition_graph(one_graph(s), per_host) for s in range(n_hosts)]


def run_steps(mesh, steps: int = STEPS, state: dict = None, device="cuda"):
    """``steps`` hybrid steps on this rank (``mesh`` a ``("data", "graph")``
    mesh of this rank's view); ``state`` replaces the model's weights.
    Returns (losses, the sum of |parameter| over the model)."""
    import torch

    from gnnkeras_tpu_torch.parallel.hybrid import make_hybrid_train_step, stack_partitioned
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

    gnn, pgs = build_problem(mesh.shape[1], mesh.shape[0], device)
    if state is not None:
        gnn.load_state_dict(state)
    step = make_hybrid_train_step(PartitionedGNN(gnn, mesh.group("graph")), mesh)
    shard = stack_partitioned(pgs, mesh, gnn.device)
    losses = [float(step(shard)["loss"]) for _ in range(steps)]
    with torch.no_grad():
        checksum = float(sum(float(p.abs().sum()) for p in gnn.parameters()))
    return losses, checksum


def _worker(rank: int, world: int, env: dict, per_host: int, n_hosts: int, steps: int, state, device):
    os.environ.update(env)
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.multihost import make_multihost_mesh

    mesh = make_multihost_mesh(n_hosts, per_host)
    losses, checksum = run_steps(mesh, steps, state, rank_device(device))
    return {"rank": rank, "host": int(env["GROUP_RANK"]), "losses": losses, "checksum": checksum}


def host_env(rank: int, per_host: int) -> dict:
    """The environment torchrun gives rank ``rank`` of ``per_host`` ranks a
    host."""
    return {"GROUP_RANK": str(rank // per_host), "LOCAL_RANK": str(rank % per_host),
            "LOCAL_WORLD_SIZE": str(per_host)}


def launch(n_hosts: int = N_HOSTS, per_host: int = DEVICES_PER_HOST, steps: int = STEPS, state: dict = None,
           device="cuda", timeout_s: float = 600.0) -> list:
    """Start the simulated hosts' ranks and return their reports in rank
    order."""
    from gnnkeras_tpu_torch.parallel.launch import spawn

    world = n_hosts * per_host
    return spawn(_worker, world, [(host_env(r, per_host), per_host, n_hosts, steps, state, device)
                                  for r in range(world)], timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=N_HOSTS)
    ap.add_argument("--per-host", type=int, default=DEVICES_PER_HOST)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reports = launch(args.hosts, args.per_host, args.steps, device=args.device)
    for r in reports:
        print(json.dumps(r))
    agree = all(r["losses"] == reports[0]["losses"] for r in reports)
    print(json.dumps({"hosts": args.hosts, "per_host": args.per_host, "ranks_agree": agree}))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
