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
- ``composite_of``: a graph as a ``CompositeGraphObject``, as the
  repository's ``load_tu_dataset(composite=True)`` builds molecules (one
  type: every node, the whole label), or typed into 3 node types by atom
  class (``ATOM_TYPE_BOUNDS``); ``bench_composite_graph`` and
  ``bench_typed_arc_graph`` are the bench batch and its arc twin so.
- ``starter_clgnn`` and ``starter_cgnn``: the models of the repository's
  ``examples/starter_composite.py`` (a CompositeLGNN of 5 graph-focused
  composite GNNs at dim_state 10, and its single composite GNN);
  ``flagship_lgnn``: an LGNN of 5 layers of the flagship architecture
  (dim_state 0, so the state widens layer by layer: 14, 30, 46, 62, 78);
  ``typed_arc_cgnn``: the arc-focused composite GNN over the 3 types.
- ``typed_cgnn`` and ``pipeline_lgnn``: the models of the distributed
  paths, with the starter's settings (selu state nets, softmax output net,
  max_iteration 5, threshold 0.01): the graph-focused composite GNN over
  the 3 atom types that expert parallelism shards by type
  (``parallel/expert.py``) and the partitioned engine runs at dim_state 0,
  and the homogeneous graph-focused LGNN at dim_state 10 that pipeline
  parallelism runs one layer a rank (``parallel/pipeline.py``).
"""

from __future__ import annotations

import numpy as np

from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.models.composite import CompositeGNNarcBased, CompositeGNNgraphBased
from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased
from gnnkeras_tpu_torch.models.lgnn import LGNN, CompositeLGNN
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


def bench_graph(seed: int = 0, scale: float = 1.0) -> GraphObject:
    """The bench batch; ``scale`` < 1 draws the same stand-in at that share
    of its nodes, arcs and graphs (``bench.py``'s ``GNNK_BENCH_SCALE``)."""
    rng = np.random.default_rng(seed)
    n, a, G = BENCH_NODES, BENCH_ARCS, BENCH_GRAPHS
    if scale < 1.0:
        n, a, G = max(int(n * scale), 64), max(int(a * scale), 128), max(int(G * scale), 2)
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



# 3 node types by atom class: type t holds the classes below
# ATOM_TYPE_BOUNDS[t] (and not below the type before) and reads the first
# ATOM_TYPE_BOUNDS[t] label columns, which hold its one-hot class
ATOM_TYPE_BOUNDS = (5, 10, 14)


def composite_of(g: GraphObject, n_types: int = 1, aggregation_mode=None) -> CompositeGraphObject:
    """``g`` as a composite graph of 1 node type (every node, the whole
    label) or of 3 types by the argmax of its one-hot atom label
    (``ATOM_TYPE_BOUNDS``); same arcs, targets, masks and graph partition.
    ``aggregation_mode`` defaults to ``g``'s."""
    n = g.nodes.shape[0]
    if n_types == 1:
        type_mask, dims = np.ones((n, 1), dtype=bool), (g.nodes.shape[1],)
    elif n_types == 3:
        types = np.searchsorted(ATOM_TYPE_BOUNDS[:-1], np.argmax(g.nodes, axis=1), side="right")
        type_mask, dims = np.eye(3, dtype=bool)[types], ATOM_TYPE_BOUNDS
    else:
        raise ValueError(f"n_types {n_types} must be 1 or 3")
    return CompositeGraphObject(
        nodes=g.nodes, arcs=g.arcs, targets=g.targets, type_mask=type_mask, dim_node_label=dims, focus=g.focus,
        set_mask=g.set_mask, output_mask=g.output_mask, sample_weight=g.sample_weight,
        NodeGraph=(g.graph_of_node, g.nodegraph_weight), aggregation_mode=aggregation_mode or g.aggregation_mode,
        arcs_canonical=True,
    )


def bench_composite_graph(seed: int = 0) -> CompositeGraphObject:
    """``bench_graph(seed)`` as 1-type composite molecules."""
    return composite_of(bench_graph(seed))


def bench_typed_arc_graph(seed: int = 0) -> CompositeGraphObject:
    """``bench_arc_graph(seed)`` typed into 3 node types by atom class,
    'composite_average' aggregation."""
    return composite_of(bench_arc_graph(seed), 3, "composite_average")


def _state_net(input_dim, units):
    return MLP(input_dim, units, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal")


def _output_net(input_dim, units):
    return MLP(input_dim, units, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal")


STARTER_DIM_STATE, STARTER_MAX_ITER, STARTER_THRESHOLD = 10, 5, 0.01


def _starter_layer(layer: int) -> CompositeGNNgraphBased:
    """Layer ``layer`` of the starter's CLGNN: BatchNorm → Dense(51→10,
    selu) state net at layer 0, BatchNorm → Dense(75→10, selu) above (the
    state and output of the layer below prepended to the 14-wide label),
    BatchNorm → Dense(10→2, softmax) output net."""
    ins, ls = get_inout_dims("state", [14], 3, 2, "g", STARTER_DIM_STATE, layer=layer, get_state=True,
                             get_output=True)
    return CompositeGNNgraphBased([_state_net(shape, ls) for shape in ins],
                                  _output_net((STARTER_DIM_STATE,), [2]),
                                  STARTER_DIM_STATE, STARTER_MAX_ITER, STARTER_THRESHOLD)


def starter_clgnn(device="cuda", seed: int = 0, layers: int = 5) -> CompositeLGNN:
    """``examples/starter_composite.py``'s CompositeLGNN (get_state and
    get_output), random weights from ``seed``."""
    return CompositeLGNN([_starter_layer(i) for i in range(layers)], True, True).build(seed=seed, device=device)


def starter_cgnn(device="cuda", seed: int = 0) -> CompositeGNNgraphBased:
    """``examples/starter_composite.py``'s single CompositeGNNgraphBased
    (its ``--fit gnn`` model), random weights from ``seed``."""
    return _starter_layer(0).build(seed=seed, device=device)


def flagship_lgnn(device="cuda", seed: int = 0, layers: int = 5) -> LGNN:
    """An LGNN of ``layers`` graph-focused GNNs of the flagship
    architecture at dim_state 0 (get_state and get_output): layer l's state
    is 14 + 16·l wide, max_iteration 5, threshold 0."""
    gnns = []
    for i in range(layers):
        kw = dict(layer=i, get_state=True, get_output=True)
        ins, ls = get_inout_dims("state", 14, 3, 2, "g", 0, **kw)
        ino, lo = get_inout_dims("output", 14, 3, 2, "g", 0, **kw)
        gnns.append(GNNgraphBased(_state_net(ins[0], ls), _output_net(ino[0], lo), 0, 5, 0.0))
    return LGNN(gnns, True, True).build(seed=seed, device=device)


def typed_arc_cgnn(device="cuda", seed: int = 0) -> CompositeGNNarcBased:
    """Arc-focused composite GNN over the 3 atom types at dim_state 0: per
    type a BatchNorm → Dense(d_t + 60 → 14, selu) state net over
    ``[label[:d_t] | state | Σstate | per-type label sums | Σarcs]`` (the
    model's own widths: the shape algebra of ``get_inout_dims`` leaves the
    state out at dim_state 0), BatchNorm → Dense(31→2, softmax) output net
    over ``[src state | dst state | arc label]``, max_iteration 5,
    threshold 0."""
    width, comp = 14, sum(ATOM_TYPE_BOUNDS) + 3
    nets = [_state_net((d_t + 2 * width + comp,), [width]) for d_t in ATOM_TYPE_BOUNDS]
    return CompositeGNNarcBased(nets, _output_net((2 * width + 3,), [2]), 0, 5, 0.0).build(seed=seed, device=device)


def typed_cgnn(dim_state: int = 10, device="cuda", seed: int = 0) -> CompositeGNNgraphBased:
    """Graph-focused composite GNN over the 3 atom types of
    ``composite_of(g, 3, "composite_average")``: per type a BatchNorm →
    Dense(→ width, selu) state net, BatchNorm → Dense(width → 2, softmax)
    output net, max_iteration 5, threshold 0.01.  At ``dim_state`` > 0 the
    state nets' inputs are ``get_inout_dims``' for label widths (5, 10, 14)
    and the width is ``dim_state``; at 0 the state is the 14-wide label and
    the inputs are the model's own (``d_t + 2·14 + Σd + 3``, as
    ``typed_arc_cgnn``)."""
    if dim_state:
        ins, ls = get_inout_dims("state", list(ATOM_TYPE_BOUNDS), 3, 2, "g", dim_state)
        nets, width = [_state_net(shape, ls) for shape in ins], dim_state
    else:
        width, comp = 14, sum(ATOM_TYPE_BOUNDS) + 3
        nets = [_state_net((d_t + 2 * width + comp,), [width]) for d_t in ATOM_TYPE_BOUNDS]
    return CompositeGNNgraphBased(nets, _output_net((width,), [2]), dim_state, STARTER_MAX_ITER,
                                  STARTER_THRESHOLD).build(seed=seed, device=device)


def pipeline_lgnn(device="cuda", seed: int = 0, layers: int = 4, bn: bool = True) -> LGNN:
    """A homogeneous graph-focused LGNN of ``layers`` layers at dim_state 10
    (get_state and get_output): per layer a (BatchNorm →) Dense(→ 10, selu)
    state net and a (BatchNorm →) Dense(→ 2, softmax) output net sized by
    ``get_inout_dims``, max_iteration 5, threshold 0.01; ``bn=False`` drops
    the BatchNorms."""
    gnns = []
    for i in range(layers):
        kw = dict(layer=i, get_state=True, get_output=True)
        ins, ls = get_inout_dims("state", 14, 3, 2, "g", STARTER_DIM_STATE, **kw)
        ino, lo = get_inout_dims("output", 14, 3, 2, "g", STARTER_DIM_STATE, **kw)
        net_state = MLP(ins[0], ls, "selu", kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                        batch_normalization=bn)
        net_output = MLP(ino[0], lo, "softmax", kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
                         batch_normalization=bn)
        gnns.append(GNNgraphBased(net_state, net_output, STARTER_DIM_STATE, STARTER_MAX_ITER, STARTER_THRESHOLD))
    return LGNN(gnns, True, True).build(seed=seed, device=device)


def write_tu_dump(graphs, folder: str, prefix: str = "SYNTH") -> str:
    """Write graph-focused one-hot-labelled ``graphs`` (``random_molecules``)
    as a TU-format dump in ``folder``: ``{prefix}_edges.txt`` (1-based
    ``src, dst`` rows), ``_edge_labels``, ``_node_labels``,
    ``_graph_indicator`` and ``_graph_labels`` (the argmax of each one-hot
    label), which ``data/mutag.load_tu_dataset(folder, prefix)`` reads
    back.  Returns ``folder``."""
    import os

    os.makedirs(folder, exist_ok=True)
    edges, edge_labels, node_labels, indicator, graph_labels = [], [], [], [], []
    offset = 0
    for gid, g in enumerate(graphs, start=1):
        n = g.nodes.shape[0]
        edges.append(g.arcs[:, :2].astype(np.int64) + offset + 1)
        edge_labels.append(np.argmax(g.arcs[:, 2:], axis=1))
        node_labels.append(np.argmax(g.nodes, axis=1))
        indicator.append(np.full(n, gid))
        graph_labels.append(np.argmax(g.targets, axis=1))
        offset += n
    path = os.path.join(folder, prefix)
    np.savetxt(f"{path}_edges.txt", np.concatenate(edges), fmt="%d", delimiter=", ")
    for name, parts in (("edge_labels", edge_labels), ("node_labels", node_labels),
                        ("graph_indicator", indicator), ("graph_labels", graph_labels)):
        np.savetxt(f"{path}_{name}.txt", np.concatenate(parts), fmt="%d")
    return folder
