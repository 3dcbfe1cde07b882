"""Synthetic molecule-shaped workloads, made from a seed with NumPy.

- ``bench_graph``: the flagship batch of the repository's ``bench.py``
  (its synthetic stand-in for the merged Mutagenicity dataset): 131,488
  nodes with one-hot labels over 14 atom types, 266,894 random arcs with
  one-hot labels over 3 bond types (deduplicated by ``GraphObject``), 4,337
  graphs of about 30 nodes, average aggregation.
- ``random_molecules``: separate molecules of 5-39 nodes (by default) with
  random arcs over 3 bond types and no self loops, 14 atom types and a
  2-class graph target, for serving requests.
- ``flagship_gnn``: the model ``bench.py`` runs on that batch, with random
  weights from a seed.
- ``bench_arc_graph`` and ``arc_gnn``: the arc-focused workload of the
  repository's ``scripts/bench_arc_step.py`` on the same synthetic graphs: a
  2-class target per arc, and the arc-focused model with the starter
  architecture.
- ``large_banded_graph`` and ``large_graph_gnn``: the single-large-graph
  workload of the repository's ``scripts/bench_large_graph.py``: one
  node-focused banded graph (500,000 nodes, 8 arcs drawn per node within a
  band of 64, deduplicated: 3,892,679 arcs), average aggregation, and the
  node-focused model it runs; ``band=384`` gives a graph whose 7 tile
  offsets are more than the banded decomposition takes.
"""

from __future__ import annotations

import numpy as np

from gnnkeras_tpu_torch.graph.graph import GraphObject
from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased
from gnnkeras_tpu_torch.models.mlp import MLP, get_inout_dims


def flagship_gnn(device="cuda", seed: int = 0) -> GNNgraphBased:
    """Graph-focused GNN with the starter architecture: dim_state 0 (the
    state is the 14-wide node label), BatchNorm → Dense(31→14, selu) state
    net, BatchNorm → Dense(14→2, softmax) output net, max_iteration 5,
    threshold 0."""
    ins, ls = get_inout_dims("state", 14, 3, 2, "g", 0)
    ino, lo = get_inout_dims("output", 14, 3, 2, "g", 0)
    net_state = MLP(ins[0], ls, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    net_output = MLP(ino[0], lo, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return GNNgraphBased(net_state, net_output, 0, 5, 0.0).build(seed=seed, device=device)


BENCH_NODES, BENCH_ARCS, BENCH_GRAPHS = 131_488, 266_894, 4_337


def bench_graph(seed: int = 0) -> GraphObject:
    rng = np.random.default_rng(seed)
    n, a, G = BENCH_NODES, BENCH_ARCS, BENCH_GRAPHS
    nodes = np.eye(14, dtype=np.float32)[rng.integers(0, 14, n)]
    graph_of_node = (np.arange(n, dtype=np.int64) * G) // n  # contiguous even split
    counts = np.bincount(graph_of_node, minlength=G)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    g_arc = rng.integers(0, G, a)
    src = starts[g_arc] + rng.integers(0, counts[g_arc])
    dst = starts[g_arc] + rng.integers(0, counts[g_arc])
    arcs = np.concatenate([np.stack([src, dst], 1), np.eye(3, dtype=np.float32)[rng.integers(0, 3, a)]], axis=1)
    targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, G)]
    return GraphObject(
        nodes=nodes, arcs=arcs, targets=targets, focus="g", aggregation_mode="average",
        NodeGraph=(graph_of_node, (1.0 / counts[graph_of_node]).astype(np.float32)),
    )


def arc_gnn(device="cuda", seed: int = 0) -> GNNarcBased:
    """Arc-focused GNN: dim_state 0, BatchNorm → Dense(31→14, selu) state
    net, BatchNorm → Dense(31→2, softmax) output net over ``[src state |
    dst state | arc label]``, max_iteration 5, threshold 0."""
    ins, ls = get_inout_dims("state", 14, 3, 2, "a", 0)
    ino, lo = get_inout_dims("output", 14, 3, 2, "a", 0)
    net_state = MLP(ins[0], ls, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    net_output = MLP(ino[0], lo, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return GNNarcBased(net_state, net_output, 0, 5, 0.0).build(seed=seed, device=device)


def bench_arc_graph(seed: int = 0) -> GraphObject:
    """``bench_graph(seed)``'s nodes, arcs and graph partition (so slot
    packing acts per graph) in arc focus, with a one-hot 2-class target per
    arc drawn from the seed."""
    g = bench_graph(seed)
    rng = np.random.default_rng([seed, 1])
    targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, g.arcs.shape[0])]
    return GraphObject(
        nodes=g.nodes, arcs=g.arcs, targets=targets, focus="a", aggregation_mode="average",
        NodeGraph=(g.graph_of_node, g.nodegraph_weight), arcs_canonical=True,
    )


def random_molecules(n_graphs: int = 25, seed: int = 0, min_nodes: int = 5, max_nodes: int = 40):
    """``n_graphs`` graph-focused graphs of ``min_nodes``..``max_nodes - 1``
    nodes, n..3n arcs without self loops, average aggregation."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(min_nodes, max_nodes))
        nodes = np.eye(14, dtype=np.float32)[rng.integers(0, 14, n)]
        a = int(rng.integers(n, 3 * n))
        src, dst = rng.integers(0, n, a), rng.integers(0, n, a)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            src, dst = np.array([0]), np.array([1 % n])
        arcs = np.concatenate(
            [np.stack([src, dst], 1), np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(src))]], 1
        )
        targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 1)]
        graphs.append(GraphObject(nodes=nodes, arcs=arcs, targets=targets, focus="g", aggregation_mode="average"))
    return graphs


LARGE_NODES, LARGE_PER_NODE, LARGE_BAND = 500_000, 8, 64


def large_banded_graph(n_nodes: int = LARGE_NODES, band: int = LARGE_BAND) -> GraphObject:
    """8 arcs from every node to a node at most ``band`` away (wrapping
    around), duplicates removed; 8 normal node-label features, 2 normal
    arc-label features and 2 normal targets per node, node focus, average
    aggregation.  The draws follow ``scripts/bench_large_graph.py`` in
    order, from its seed 0, so the same sizes give the same graph."""
    rng = np.random.default_rng(0)
    src = np.repeat(np.arange(n_nodes), LARGE_PER_NODE)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n_nodes
    # unique (src, dst) pairs, sorted: parallel arcs would defeat the int8 factorisation
    key = np.unique(src.astype(np.int64) * n_nodes + dst.astype(np.int64))
    src, dst = key // n_nodes, key % n_nodes
    arcs = np.concatenate(
        [np.stack([src, dst], 1).astype(np.float32), rng.normal(size=(len(src), 2)).astype(np.float32)], axis=1
    )
    nodes = rng.normal(size=(n_nodes, 8)).astype(np.float32)
    targets = rng.normal(size=(n_nodes, 2)).astype(np.float32)
    return GraphObject(nodes=nodes, arcs=arcs, targets=targets, focus="n", aggregation_mode="average",
                       arcs_canonical=True)


def large_graph_gnn(device="cuda", seed: int = 0) -> GNNnodeBased:
    """Node-focused GNN of the large-graph workload: dim_state 0 (the state
    is the 8-wide node label), BatchNorm → Dense(→8, selu) state net,
    BatchNorm → Dense(8→2, softmax) output net, max_iteration 5,
    threshold 0."""
    ins, ls = get_inout_dims("state", 8, 2, 2, "n", 0)
    ino, lo = get_inout_dims("output", 8, 2, 2, "n", 0)
    net_state = MLP(ins[0], ls, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    net_output = MLP(ino[0], lo, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return GNNnodeBased(net_state, net_output, 0, 5, 0.0).build(seed=seed, device=device)

