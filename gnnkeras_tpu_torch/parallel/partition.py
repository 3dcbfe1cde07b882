"""Edge-partitioned training and inference of one large graph, the counterpart
of ``gnnkeras_tpu.parallel.partition``.

One graph's node rows are split into P contiguous, equally padded ranges,
one per rank of a process group (the ``graph`` axis); every edge lives on the
rank that owns its destination, so aggregation is local once the source
states have arrived.  Each unfolding iteration exchanges state between the
ranks: the rows some other rank reads (the halo, ``halo=True``) or the
whole state, through ``all_gather`` (``transport="collective"``) or the ring
kernel (``transport="pallas_ring"``, kernel row 9, ``ops/ring.py``; halo
only, inference only: the JAX package's ring has no backward either).
BatchNorm moments, the convergence flag, the loss and the graph readout span
the group (``parallel/collectives.py``), so the partitioned run computes
what one device computes on the whole graph.

``partition_graph`` builds every part on the host (``PartitionedGraph``,
NumPy and CPU tensors with a leading part axis, as the JAX package stacks
them); ``PartitionedGraph.shard(rank, device)`` is one rank's view, which
``PartitionedGNN`` runs.  ``dense_blocks=True`` aggregates on block
operators: a local one (plain BCSR; with ``agg_dtype`` the banded int8
decomposition, quantised BCSR or a cast copy, as the single-graph routes
choose) and a float BCSR over the exchanged rows.

``PartitionedGNN.fit`` runs the single-device fit surface through
``training/fit_loop.run_fit_loop``: chunks of ``steps_per_launch`` epochs,
validation (a ``GraphShard`` scored by ``evaluate`` or a plain sequencer
scored on one device with the synchronised weights), callbacks,
checkpoints (rank 0 writes, a barrier follows, every rank restores) and
resume, with the hooks of ``collectives.rank0_fit_hooks``.  Every rank takes the same decisions: the logs the callbacks see
are rank 0's, and after a restore or a callback's weight change every rank
takes rank 0's weights.  The step goes through gloo in host memory, so the
chunks run eagerly (no captured CUDA graph).

``tp_shards > 1`` shards the state net's features over a ``model`` group
beside the graph partition (``parallel/tensor_parallel.py``); such an engine
trains only through the hybrid step (``parallel/hybrid.py``), which holds
each rank's shard of the state net and its optimizer state.  BatchNorm's
row moments then span the graph group.

Composite graphs and models: each part carries its rows' node types
(``type_mask``) and their per-type neighbour-label sums (``agg_component``),
summed on the host in f64 and cast once, as the JAX package builds them
(never on the device, where another summation order would move the last
bit).  The transition runs
one state net per type over the part's rows, its BatchNorm moments over
that type's real rows of every rank, and sums the outputs gated by the type
masks; the readouts read the state only.  Tensor parallelism does not
compose with a composite model (expert parallelism, ``parallel/expert.py``,
shards its per-type nets instead).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.ops.segment import segment_sum
from gnnkeras_tpu_torch.utils.dtypes import floatx

TRANSPORTS = ("collective", "pallas_ring")


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


def locality_order(g: GraphObject) -> np.ndarray:
    """Reverse Cuthill–McKee order of the symmetrised adjacency: position i
    holds old node ``perm[i]``.  Range partitions of this order keep
    neighbours on one rank, which shrinks the halo."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = g.nodes.shape[0]
    src = g.arcs[:, 0].astype(np.int64)
    dst = g.arcs[:, 1].astype(np.int64)
    a = coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee((a + a.T).tocsr(), symmetric_mode=True), dtype=np.int64)


def permute_graph_nodes(g: GraphObject, perm: np.ndarray) -> GraphObject:
    """Copy of ``g`` with its node rows in the order ``perm`` (arc rows keep
    their order, endpoints relabelled).  Node and graph focus only."""
    if g.focus == "a":
        raise ValueError("permute_graph_nodes supports focus 'n'/'g' only")
    n = g.nodes.shape[0]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    g2 = g.copy()
    g2.nodes = np.ascontiguousarray(g.nodes[perm])
    arcs = g.arcs.copy()
    arcs[:, 0] = inv[g.arcs[:, 0].astype(np.int64)]
    arcs[:, 1] = inv[g.arcs[:, 1].astype(np.int64)]
    g2.arcs = arcs  # the same rows, relabelled: arcnode_weight stays aligned
    g2.set_mask = g.set_mask[perm]
    g2.output_mask = g.output_mask[perm]
    if g.focus == "n":
        # target row j belongs to the j-th output node: re-sort by new position
        out_idx = np.flatnonzero(g.output_mask)
        order = np.argsort(inv[out_idx], kind="stable")
        g2.targets = g.targets[order]
        g2.sample_weight = g.sample_weight[order]
    g2.graph_of_node = g.graph_of_node[perm]
    g2.nodegraph_weight = g.nodegraph_weight[perm]
    if isinstance(g, CompositeGraphObject):
        g2.type_mask = g.type_mask[perm]
    return g2


def _move(x, device):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device)


@dataclasses.dataclass(frozen=True)
class GraphShard:
    """One rank's part of a ``PartitionedGraph``: the same fields without
    the part axis, as tensors on the rank's device, and its two operators."""

    nodes: torch.Tensor  # (Np, dn)
    node_mask: torch.Tensor  # (Np,)
    arc_src_global: torch.Tensor  # (Ap,) into the concatenated global state
    arc_dst_local: torch.Tensor  # (Ap,)
    arc_weight: torch.Tensor
    arc_label: torch.Tensor  # (Ap, da)
    arc_mask: torch.Tensor
    set_mask: torch.Tensor  # (R,) R = Np ('n', 'g') or Ap ('a')
    output_mask: torch.Tensor
    targets: torch.Tensor  # (Rt, T), Rt = graph rows for 'g'
    target_mask: torch.Tensor
    sample_weight: torch.Tensor
    publish_local: Optional[torch.Tensor]  # (H,) local rows this rank publishes
    publish_mask: Optional[torch.Tensor]
    arc_src_halo: Optional[torch.Tensor]  # (Ap,) into [local | exchanged rows]
    graph_of_node: Optional[torch.Tensor]
    nodegraph_weight: Optional[torch.Tensor]
    local_op: Optional[object]  # BcsrMatrix, BandedOperator or QuantBcsr
    halo_op: Optional[object]  # BcsrMatrix over the exchanged rows
    agg_arc_labels: torch.Tensor  # (Np, da)
    agg_node_labels: torch.Tensor  # (Np, dn)
    type_mask: Optional[torch.Tensor]  # (Np, T) node types, composite graphs only
    agg_component: Optional[torch.Tensor]  # (Np, Σd_t + da) per-type label sums, composite only
    focus: str
    rank: int
    n_parts: int
    nodes_per_part: int
    n_graphs: int
    dim_node_label: Tuple[int, ...]

    def to(self, device) -> "GraphShard":
        static = ("focus", "rank", "n_parts", "nodes_per_part", "n_graphs", "dim_node_label")
        return dataclasses.replace(self, **{f.name: _move(getattr(self, f.name), device)
                                            for f in dataclasses.fields(self) if f.name not in static})


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """One large graph split into ``n_parts`` equal padded node ranges.
    Array fields carry a leading part axis (NumPy, the JAX package's layout
    and dtypes); ``local_ops`` / ``halo_ops`` hold each part's operator on
    the CPU.  ``arc_src_global`` indexes the concatenated global state
    (n_parts·nodes_per_part rows), ``arc_dst_local`` the owning part's rows;
    padded slots carry zero weight and masks."""

    nodes: np.ndarray
    node_mask: np.ndarray
    arc_src_global: np.ndarray
    arc_dst_local: np.ndarray
    arc_weight: np.ndarray
    arc_label: np.ndarray
    arc_mask: np.ndarray
    set_mask: np.ndarray
    output_mask: np.ndarray
    targets: np.ndarray
    target_mask: np.ndarray
    sample_weight: np.ndarray
    publish_local: Optional[np.ndarray]
    publish_mask: Optional[np.ndarray]
    arc_src_halo: Optional[np.ndarray]
    graph_of_node: Optional[np.ndarray]
    nodegraph_weight: Optional[np.ndarray]
    local_ops: Optional[List[object]]
    halo_ops: Optional[List[object]]
    agg_arc_labels: np.ndarray
    agg_node_labels: np.ndarray
    type_mask: Optional[np.ndarray]
    agg_component: Optional[np.ndarray]
    focus: str
    dim_node_label: Tuple[int, ...]
    n_parts: int
    nodes_per_part: int
    n_graphs: int

    def shard(self, rank: int, device="cuda") -> GraphShard:
        """Part ``rank`` as tensors on ``device`` (``"cpu"`` for a part to
        hand to a rank's process)."""
        from gnnkeras_tpu_torch.utils.dtypes import resolve_device

        device = resolve_device(device)
        if not 0 <= rank < self.n_parts:
            raise ValueError(f"rank {rank} outside 0..{self.n_parts - 1}")
        part = lambda a: None if a is None else a[rank]
        kw = {name: part(getattr(self, name)) for name in _PART_FIELDS}
        kw.update(local_op=part(self.local_ops), halo_op=part(self.halo_ops), focus=self.focus, rank=rank,
                  n_parts=self.n_parts, nodes_per_part=self.nodes_per_part, n_graphs=self.n_graphs,
                  dim_node_label=self.dim_node_label)
        return GraphShard(**kw).to(device)


# the per-part array fields, shared by PartitionedGraph and GraphShard
_PART_FIELDS = ("nodes", "node_mask", "arc_src_global", "arc_dst_local", "arc_weight", "arc_label", "arc_mask",
                "set_mask", "output_mask", "targets", "target_mask", "sample_weight", "publish_local", "publish_mask",
                "arc_src_halo", "graph_of_node", "nodegraph_weight", "agg_arc_labels", "agg_node_labels",
                "type_mask", "agg_component")


def _pad_blocks(mats):
    """Each part's ``BcsrMatrix`` zero-block padded to the largest block
    count, the padding at tile (0, 0) (zero blocks add nothing): the JAX
    package's stacking, part by part."""
    b_max = max(int(m.blocks.shape[0]) for m in mats)

    def pad(m):
        extra = b_max - int(m.blocks.shape[0])
        if extra == 0:
            return m
        z = lambda t: torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])
        return dataclasses.replace(m, blocks=z(m.blocks), src_tile=z(m.src_tile), dst_tile=z(m.dst_tile))

    return [pad(m) for m in mats]


def _local_operators(local_edges, np_pad: int, agg_dtype: Optional[str]):
    """Each part's local operator under ``agg_dtype``, with one structure
    across parts: the banded int8 decomposition with offsets forced to the
    parts' union (bf16 diagonals in every part when one part does not
    factor, explicit 'int8' only), quantised BCSR otherwise (bf16 blocks in
    every part when one does not factor), or for 'auto' the plain float
    BCSR when some part has no exact banded form; a cast BCSR for
    'float32' / 'bfloat16'; the plain float BCSR for None."""
    from gnnkeras_tpu_torch.ops.bcsr import build_bcsr, cast_bcsr

    plain = lambda: _pad_blocks([build_bcsr(s, d, w, np_pad, np_pad, max_band_factor=10**9)
                                 for s, d, w in local_edges])
    if agg_dtype not in ("int8", "auto"):
        ops = plain()
        return ops if agg_dtype is None else [cast_bcsr(m, agg_dtype) for m in ops]
    from gnnkeras_tpu_torch.ops.banded import build_banded_operator, dense_offsets, uniformize_residuals
    from gnnkeras_tpu_torch.ops.bcsr import pad_qbcsr, quantize_bcsr

    strict = agg_dtype == "auto"
    union = sorted(set().union(*(dense_offsets(s, d, w, np_pad) for s, d, w in local_edges)))
    if union and len(union) <= 6:
        def build_all(dtype):
            return [build_banded_operator(s, d, w, np_pad, dtype=dtype, force_offsets=tuple(union),
                                          strict_int8=strict) for s, d, w in local_edges]

        bops = build_all("int8")
        if not any(b is None for b in bops):
            unscaled = [dg.scale is None for b in bops for dg in b.diags]
            if not strict and any(unscaled) and not all(unscaled):
                bops = build_all("bfloat16")
            return uniformize_residuals(bops)
    if strict:
        return plain()

    def quant_all(dtype):
        return [quantize_bcsr(build_bcsr(s, d, w, np_pad, np_pad, max_band_factor=10**9), dtype)
                for s, d, w in local_edges]

    qs = quant_all("int8")
    if any(q.scale is None for q in qs) and not all(q.scale is None for q in qs):
        qs = quant_all("bfloat16")
    need = max(int(q.mask.shape[0]) for q in qs)
    return [pad_qbcsr(q, need) for q in qs]


def partition_graph(g: GraphObject, n_parts: int, pad_multiple: int = 8, halo: bool = True,
                    dense_blocks: bool = False, reorder: str = "none",
                    agg_dtype: Optional[str] = None) -> PartitionedGraph:
    """Contiguous node-range partition of ``g`` into ``n_parts`` parts, each
    edge on its destination's part (the JAX package's ``partition_graph``,
    array for array).

    ``halo=True``: each part publishes only the rows other parts read, when
    that is fewer than its whole range.  Graph focus partitions a merged
    batch: each part reads out its nodes into global graph rows, the sum
    over parts is the readout, and the graph-level targets are replicated.
    ``dense_blocks=True`` builds each part's local and halo block operators;
    ``agg_dtype`` (needs ``dense_blocks``) stores the local one quantised or
    cast (``_local_operators``).  ``reorder='rcm'`` relabels the nodes by
    ``locality_order`` first.  A ``CompositeGraphObject`` also gives each
    part its rows' ``type_mask`` and their per-type neighbour-label sums
    ``agg_component``, summed in f64 and cast once."""
    if reorder not in ("none", "rcm"):
        raise ValueError(f"unknown reorder {reorder!r} (none | rcm)")
    if agg_dtype is not None and not dense_blocks:
        raise ValueError(f"agg_dtype={agg_dtype!r} requires dense_blocks=True (the operator storage it selects "
                         "only exists on the block path)")
    if reorder == "rcm":
        g = permute_graph_nodes(g, locality_order(g))
    if dense_blocks:
        pad_multiple = max(pad_multiple, 128)  # block tiles are 128-aligned
    n = g.nodes.shape[0]
    chunk = -(-n // n_parts)
    np_pad = _round_up(chunk, pad_multiple)

    src = g.arcs[:, 0].astype(np.int64)
    dst = g.arcs[:, 1].astype(np.int64)
    part_of = np.minimum(dst // chunk, n_parts - 1)
    src_part = np.minimum(src // chunk, n_parts - 1)
    src_global_new = src_part * np_pad + (src - src_part * chunk)
    edges_per_part = [np.flatnonzero(part_of == p) for p in range(n_parts)]
    ap_pad = _round_up(max((len(e) for e in edges_per_part), default=1), pad_multiple)

    dtype = floatx()
    dn, da, t_dim = g.nodes.shape[1], g.DIM_ARC_LABEL, g.DIM_TARGET
    composite = isinstance(g, CompositeGraphObject)
    type_mask = np.zeros((n_parts, np_pad, g.num_types), bool) if composite else None
    nodes = np.zeros((n_parts, np_pad, dn), dtype)
    node_mask = np.zeros((n_parts, np_pad), bool)
    a_srcg = np.zeros((n_parts, ap_pad), np.int32)
    a_dstl = np.zeros((n_parts, ap_pad), np.int32)
    a_w = np.zeros((n_parts, ap_pad), dtype)
    a_lab = np.zeros((n_parts, ap_pad, da), dtype)
    a_mask = np.zeros((n_parts, ap_pad), bool)

    m_rows = ap_pad if g.focus == "a" else np_pad
    n_graphs = max(g.num_graphs, 1) if g.focus == "g" else 0
    g_pad = _round_up(n_graphs, pad_multiple) if g.focus == "g" else 0
    r_rows = g_pad if g.focus == "g" else m_rows
    set_mask = np.zeros((n_parts, m_rows), bool)
    output_mask = np.zeros((n_parts, m_rows), bool)
    targets = np.zeros((n_parts, r_rows, t_dim), dtype)
    target_mask = np.zeros((n_parts, r_rows), bool)
    sample_weight = np.zeros((n_parts, r_rows), dtype)
    graph_of_node = np.zeros((n_parts, np_pad), np.int32) if g.focus == "g" else None
    nodegraph_weight = np.zeros((n_parts, np_pad), dtype) if g.focus == "g" else None

    if g.focus == "g":
        targets[:, :n_graphs] = g.targets
        target_mask[:, :n_graphs] = True
        sample_weight[:, :n_graphs] = g.sample_weight
    else:
        full_targets = np.zeros((len(g.output_mask), t_dim), dtype)
        full_sw = np.zeros(len(g.output_mask), dtype)
        out_idx = np.flatnonzero(g.output_mask)
        full_targets[out_idx] = g.targets
        full_sw[out_idx] = g.sample_weight

    for p in range(n_parts):
        lo, hi = p * chunk, min((p + 1) * chunk, n)
        size = hi - lo
        nodes[p, :size] = g.nodes[lo:hi]
        node_mask[p, :size] = True
        e = edges_per_part[p]
        if composite:
            type_mask[p, :size] = g.type_mask[lo:hi]
        a_srcg[p, : len(e)] = src_global_new[e]
        a_dstl[p, : len(e)] = dst[e] - lo
        a_w[p, : len(e)] = g.arcnode_weight[e]
        a_lab[p, : len(e)] = g.arcs[e, 2:]
        a_mask[p, : len(e)] = True
        if g.focus == "g":
            set_mask[p, :size] = g.set_mask[lo:hi]
            output_mask[p, :size] = g.output_mask[lo:hi]
            graph_of_node[p, :size] = g.graph_of_node[lo:hi]
            nodegraph_weight[p, :size] = g.nodegraph_weight[lo:hi]
        elif g.focus == "n":
            set_mask[p, :size] = g.set_mask[lo:hi]
            output_mask[p, :size] = g.output_mask[lo:hi]
            targets[p, :size] = full_targets[lo:hi]
            sample_weight[p, :size] = full_sw[lo:hi]
            target_mask[p, :size] = np.logical_and(g.set_mask[lo:hi], g.output_mask[lo:hi])
        else:  # arc focus: rows follow the part's edge layout
            set_mask[p, : len(e)] = g.set_mask[e]
            output_mask[p, : len(e)] = g.output_mask[e]
            targets[p, : len(e)] = full_targets[e]
            sample_weight[p, : len(e)] = full_sw[e]
            target_mask[p, : len(e)] = np.logical_and(g.set_mask[e], g.output_mask[e])

    publish_local = publish_mask = arc_src_halo = None
    slot_map = None
    if halo:
        # per owner q: the q-owned source rows that other parts read
        needed_by_owner = [set() for _ in range(n_parts)]
        for p in range(n_parts):
            e = edges_per_part[p]
            remote = e[src_part[e] != p]
            for s_orig in np.unique(src[remote]):
                needed_by_owner[int(min(s_orig // chunk, n_parts - 1))].add(int(s_orig))
        h = max((len(x) for x in needed_by_owner), default=0)
        h_pad = _round_up(max(h, 1), pad_multiple)
        if h_pad < np_pad:  # otherwise the full all-gather is cheaper
            publish_local = np.zeros((n_parts, h_pad), np.int32)
            publish_mask = np.zeros((n_parts, h_pad), bool)
            slot_map = {}
            for q in range(n_parts):
                for j, s_orig in enumerate(sorted(needed_by_owner[q])):
                    publish_local[q, j] = s_orig - q * chunk
                    publish_mask[q, j] = True
                    slot_map[s_orig] = q * h_pad + j
            arc_src_halo = np.zeros((n_parts, ap_pad), np.int32)
            for p in range(n_parts):
                e = edges_per_part[p]
                local = src_part[e] == p
                idx = np.zeros(len(e), np.int64)
                idx[local] = src[e][local] - p * chunk
                idx[~local] = np_pad + np.array([slot_map[int(x)] for x in src[e][~local]], dtype=np.int64)
                arc_src_halo[p, : len(e)] = idx

    # batch-constant per-part neighbour-label sums, accumulated in f64
    agg_arc_pre = np.zeros((n_parts, np_pad, da), np.float64)
    agg_node_pre = np.zeros((n_parts, np_pad, dn), np.float64)
    dims = [int(d) for d in g.DIM_NODE_LABEL]
    agg_comp_pre = np.zeros((n_parts, np_pad, sum(dims) + da), np.float64) if composite else None
    for p in range(n_parts):
        e = edges_per_part[p]
        d_local = dst[e] - p * chunk
        w64 = g.arcnode_weight[e].astype(np.float64)
        np.add.at(agg_arc_pre[p], d_local, g.arcs[e, 2:].astype(np.float64) * w64[:, None])
        np.add.at(agg_node_pre[p], d_local, g.nodes[src[e]].astype(np.float64) * w64[:, None])
        if composite:
            # type t's columns: Σ over the arcs from type-t sources of w·nodes[src, :d_t]; then Σ w·arc labels
            off = 0
            for t, d_t in enumerate(dims):
                gate = g.type_mask[src[e], t].astype(np.float64)
                np.add.at(agg_comp_pre[p][:, off:off + d_t], d_local,
                          g.nodes[src[e], :d_t].astype(np.float64) * (w64 * gate)[:, None])
                off += d_t
            agg_comp_pre[p][:, off:] = agg_arc_pre[p]

    local_ops = halo_ops = None
    if dense_blocks:
        from gnnkeras_tpu_torch.ops.bcsr import build_bcsr

        gathered_rows = n_parts * (publish_local.shape[1] if publish_local is not None else np_pad)
        halos, local_edges = [], []
        for p in range(n_parts):
            e = edges_per_part[p]
            local_sel = src_part[e] == p
            el, er = e[local_sel], e[~local_sel]
            local_edges.append((src[el] - p * chunk, dst[el] - p * chunk, g.arcnode_weight[el]))
            if slot_map is not None:
                remote_rows = np.array([slot_map[int(x)] for x in src[er]], dtype=np.int64)
            else:
                remote_rows = src_global_new[er]
            halos.append(build_bcsr(remote_rows, dst[er] - p * chunk, g.arcnode_weight[er], gathered_rows, np_pad,
                                    max_band_factor=10**9))
        local_ops = _local_operators(local_edges, np_pad, agg_dtype)
        halo_ops = _pad_blocks(halos)

    return PartitionedGraph(
        nodes=nodes, node_mask=node_mask, arc_src_global=a_srcg, arc_dst_local=a_dstl, arc_weight=a_w,
        arc_label=a_lab, arc_mask=a_mask, set_mask=set_mask, output_mask=output_mask, targets=targets,
        target_mask=target_mask, sample_weight=sample_weight, publish_local=publish_local,
        publish_mask=publish_mask, arc_src_halo=arc_src_halo, graph_of_node=graph_of_node,
        nodegraph_weight=nodegraph_weight, local_ops=local_ops, halo_ops=halo_ops,
        agg_arc_labels=agg_arc_pre.astype(dtype), agg_node_labels=agg_node_pre.astype(dtype), type_mask=type_mask,
        agg_component=None if agg_comp_pre is None else agg_comp_pre.astype(dtype), focus=g.focus,
        dim_node_label=tuple(int(d) for d in g.DIM_NODE_LABEL), n_parts=n_parts, nodes_per_part=np_pad,
        n_graphs=g_pad,
    )


class PartitionedGNN:
    """The sharded unfolding engine around a ``GNNnodeBased`` /
    ``GNNarcBased`` / ``GNNgraphBased`` model or a composite one
    (``models/composite.py``, on the parts of a composite graph), run by
    every rank of ``group`` (default: the world) on its own ``GraphShard``.
    The model's parameters must be equal on every rank (build it from one
    seed, or load one state dict)."""

    def __init__(self, gnn, group=None, transport: str = "collective", tp_shards: int = 1, model_group=None):
        """``tp_shards > 1`` shards the state net's features over
        ``model_group`` (default: the world) beside the graph partition over
        ``group`` (module docstring)."""
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} must be one of {TRANSPORTS}")
        import torch.distributed as dist
        from torch import nn

        self.gnn = gnn
        self.composite = isinstance(getattr(gnn, "net_state", None), nn.ModuleList)
        self.group = dist.group.WORLD if group is None else group
        self.transport = transport
        self.tp_state = self.tp_local = None
        self.model_group = None
        if tp_shards > 1:
            from gnnkeras_tpu_torch.parallel.tensor_parallel import TensorParallelMLP

            if self.composite:
                raise NotImplementedError("tensor parallelism composes with homogeneous models (expert parallelism, "
                                          "parallel/expert.py, shards a composite model's per-type nets)")
            self.model_group = dist.group.WORLD if model_group is None else model_group
            self.tp_state = TensorParallelMLP(gnn.net_state, tp_shards, self.model_group)

    # -- the model-sharded state net ----------------------------------------------
    def shard_tp_variables(self, state_dict: Optional[dict] = None) -> list:
        """The model's state dict (default: its own) → one dict a model
        shard: ``net_state.*`` sharded, ``net_output.*`` replicated."""
        from gnnkeras_tpu_torch.parallel.tensor_parallel import shard_model_variables

        assert self.tp_state is not None, "tp_shards == 1: nothing to shard"
        return shard_model_variables(self.tp_state, self.gnn.state_dict() if state_dict is None else state_dict)

    def gather_tp_variables(self, shards: list) -> dict:
        """The inverse of ``shard_tp_variables``."""
        from gnnkeras_tpu_torch.parallel.tensor_parallel import gather_model_variables

        assert self.tp_state is not None, "tp_shards == 1: nothing to gather"
        return gather_model_variables(self.tp_state, shards)

    def tp_local_module(self):
        """This rank's shard of the state net (made from the model's current
        weights at the first call, then kept: the hybrid step trains it)."""
        import torch.distributed as dist

        if self.tp_local is None:
            self.gnn.build()
            if dist.get_world_size(self.model_group) != self.tp_state.n_shards:
                raise ValueError(f"tp_shards={self.tp_state.n_shards} but the model group has "
                                 f"{dist.get_world_size(self.model_group)} ranks")
            shard = self.shard_tp_variables()[dist.get_rank(self.model_group)]
            local = {k[10:]: v for k, v in shard.items() if k.startswith("net_state.")}
            self.tp_local = self.tp_state.local_module(local).to(self.gnn.device)
        return self.tp_local

    def gather_tp_into_model(self) -> None:
        """Write the trained state-net shards, gathered over the model
        group, back into the model (a collective of the model group)."""
        from gnnkeras_tpu_torch.parallel.tensor_parallel import gather_into

        if self.tp_local is not None:
            gather_into(self.tp_state, self.tp_local, self.gnn.net_state)

    def _require_plain_params(self) -> None:
        """forward / train_step / fit keep the state net whole on every
        rank; a tensor-parallel engine trains through the hybrid step."""
        if self.tp_state is not None:
            raise ValueError("tp_shards > 1 requires the hybrid entry point (parallel.hybrid.make_hybrid_train_step "
                             "with shard_tp_variables); fit/forward/train_step keep the parameters whole")

    # -- rank-local compute ------------------------------------------------------
    def _local_forward(self, shard: GraphShard, training: bool, generator: Optional[torch.Generator]):
        """(k, state (Np, d), out, new moving statistics keyed as in the state
        dict) on this rank's part."""
        from gnnkeras_tpu_torch.models.gnn import _prefixed, initial_state, run_unfold_loops, unconverged_flag
        from gnnkeras_tpu_torch.parallel.collectives import all_gather, pmax, psum

        gnn, group = self.gnn, self.group
        np_local = shard.nodes.shape[0]
        use_halo = shard.publish_local is not None
        use_blocks = shard.local_op is not None

        def gather_remote(x):
            """The exchanged rows: every rank's published halo rows (H·d per
            rank), or its whole state (Np·d), in rank order."""
            if use_halo:
                published = x[shard.publish_local.long()] * shard.publish_mask[:, None].to(x.dtype)
                if self.transport == "pallas_ring":
                    from gnnkeras_tpu_torch.ops.ring import ring_all_gather

                    gathered = ring_all_gather(published.contiguous(), group)
                    if training:  # BatchNorm's batch moments synchronise with the card next
                        settle_ring()
                    return gathered
                return all_gather(published, group)
            return all_gather(x, group)

        def settle_ring():
            """Bound the ring's wait for the peers' pushes (``ring_wait``)
            before a host sync could hang on it: once an iteration, before
            the convergence test, and once at the end of the forward."""
            if use_halo and self.transport == "pallas_ring":
                from gnnkeras_tpu_torch.ops.ring import ring_wait

                ring_wait(group)

        def exchange(x):
            """Local rows, then the exchanged rows (the row space of
            ``arc_src_halo``), or the whole gathered state without halo."""
            return torch.cat([x, gather_remote(x)], dim=0) if use_halo else gather_remote(x)

        src_ext = (shard.arc_src_halo if use_halo else shard.arc_src_global).long()

        def aggregate(x):
            """``Adjᵀ·x`` on this rank's destination rows: the exchange is
            issued first, then the local block product, then the halo
            blocks on the exchanged rows; or gather + edge-list segment sum."""
            if use_blocks:
                from gnnkeras_tpu_torch.ops.banded import BandedOperator, banded_aggregate
                from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr, bcsr_aggregate, qbcsr_aggregate

                remote = gather_remote(x)
                op = shard.local_op
                if isinstance(op, BandedOperator):
                    agg = banded_aggregate(x, op)
                elif isinstance(op, QuantBcsr):
                    agg = qbcsr_aggregate(x, op)
                else:
                    agg = bcsr_aggregate(x, op)
                return agg + bcsr_aggregate(remote, shard.halo_op)
            ext = exchange(x)
            return segment_sum(ext[src_ext] * shard.arc_weight[:, None], shard.arc_dst_local, np_local)

        composite = self.composite
        if composite and shard.type_mask is None:
            raise ValueError("a composite model needs the parts of a composite graph (type_mask set)")
        net = gnn.net_state if self.tp_state is None else self.tp_local_module()
        ds = gnn.state_vect_dim
        if ds > 0:
            if generator is None:
                raise ValueError("state_vect_dim > 0 requires a generator for the random state init")
            state0 = initial_state(np_local, ds, generator, shard.nodes.device)
            agg_nodes = shard.agg_node_labels
        else:
            state0 = shard.nodes
            agg_nodes = shard.nodes.new_zeros((np_local, 0))

        def predicate(state, state_old, node_mask, threshold, feature_axis=1):
            """The single-device test, its flag maximised over the group: one
            rank still moving keeps every rank iterating."""
            local = unconverged_flag(state, state_old, node_mask, threshold, feature_axis)
            settle_ring()  # pmax synchronises with the card
            return pmax(local.to(torch.int32).reshape(1), group)[0] > 0

        if not composite:
            def transition(state, bn, aggregated=None):
                if aggregated is None:
                    aggregated = aggregate(state)
                parts = [state, shard.nodes] if ds > 0 else [state]
                inp = torch.cat(parts + [aggregated, agg_nodes, shard.agg_arc_labels], dim=1)
                return net.run(inp, feature_major=False, training=training, mask=shard.node_mask,
                               generator=generator, bn_state=bn, group=group)
        else:
            masks = [shard.type_mask[:, t] & shard.node_mask for t in range(len(gnn.net_state))]

            def transition(state, bn, aggregated=None):
                """One state net per type over the part's rows (``[label[:,
                :d_t] | state | Σstate | per-type label sums | Σarcs]``),
                BatchNorm over the type's rows of every rank, the outputs
                summed through the type masks."""
                if aggregated is None:
                    aggregated = aggregate(state)
                new_state, new_bn = torch.zeros_like(state), {}
                for t, (net_t, d_t) in enumerate(zip(gnn.net_state, shard.dim_node_label)):
                    inp = torch.cat([shard.nodes[:, :d_t], state, aggregated, shard.agg_component], dim=1)
                    out_t, bn_t = net_t.run(inp, feature_major=False, training=training, mask=masks[t],
                                            generator=generator, bn_state=gnn._of_type(bn, t), group=group)
                    new_state = new_state + torch.where(masks[t][:, None], out_t, 0.0)
                    new_bn.update({f"{t}.{key}": value for key, value in bn_t.items()})
                return new_state, new_bn

        peel = shard.agg_node_labels if ds == 0 and gnn.max_iteration >= 1 else None
        bn0 = gnn._bn_state() if composite else net.bn_state()
        k, state, bn_state = run_unfold_loops(gnn, shard, state0, torch.ones_like(state0), bn0,
                                              transition, training, peel_agg=peel, predicate=predicate)

        valid = shard.arc_mask if shard.focus == "a" else shard.node_mask
        row_mask = shard.set_mask & shard.output_mask & valid
        # the composite readouts read the state only
        state_c = torch.cat([state, shard.nodes], dim=1) if ds and not composite else state
        if shard.focus == "a":
            x = torch.cat([exchange(state_c)[src_ext], state_c[shard.arc_dst_local.long()], shard.arc_label], dim=1)
        else:
            x = state_c
        out, bn_out = gnn.net_output.run(x, feature_major=False, training=training, mask=row_mask,
                                         generator=generator, group=group)
        if shard.focus == "g":
            # per-rank partial readout over global graph rows; their sum is the readout
            out = psum(segment_sum(out * shard.nodegraph_weight[:, None], shard.graph_of_node, shard.n_graphs),
                       group)
        settle_ring()
        return k, state, out, {**_prefixed("net_state", bn_state), **_prefixed("net_output", bn_out)}

    def _local_loss(self, shard: GraphShard, generator):
        """(loss, k, new moving statistics): the masked, sample-weighted
        mean over the whole graph plus the regularisation loss, equal on
        every rank."""
        from gnnkeras_tpu_torch.parallel.collectives import psum

        k, _, out, new_bn = self._local_forward(shard, True, generator)
        per_row = self.gnn.loss(shard.targets, out)
        m = shard.target_mask.to(per_row.dtype)
        loss_sum, count = torch.sum(per_row * shard.sample_weight * m), torch.sum(m)
        if shard.focus != "g":  # 'g' targets and readout are replicated: the local mean is the global one
            loss_sum, count = psum(loss_sum, self.group), psum(count, self.group)
        loss = loss_sum / torch.clamp_min(count, 1.0) + self.gnn.regularization_loss()
        return loss, k, new_bn

    # -- entry points ----------------------------------------------------------
    def _require_collective(self, what: str) -> None:
        if self.transport == "pallas_ring":
            raise NotImplementedError(
                f"{what} through transport='pallas_ring': the ring all-gather has no backward (nor has the JAX "
                "package's Pallas ring kernel); train with transport='collective'")

    def train_step(self, shard: GraphShard, generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step on every rank: the loss's gradient (the
        collectives' backward sums the ranks' contributions), the mean of
        the gradients over the group, ``average_st_grads`` scaling, the
        optimizer, the new moving statistics.  Returns {"loss", "k"} as
        0-dim device tensors."""
        from gnnkeras_tpu_torch.parallel.collectives import pmean_grads
        from gnnkeras_tpu_torch.training.trainer import _load_bn_state, _optimizer

        self._require_collective("training")
        self._require_plain_params()
        gnn = self.gnn
        if gnn.optimizer is None or gnn.loss is None:
            raise RuntimeError("call gnn.compile() before training the partitioned model")
        opt = _optimizer(gnn)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, k, new_bn = self._local_loss(shard, generator)
            loss.backward()
        pmean_grads(gnn.parameters(), self.group)
        if gnn.average_st_grads:
            gnn.scale_state_grads(k)
        opt.step()
        _load_bn_state(gnn, new_bn)
        return {"loss": loss.detach(), "k": k}

    def forward(self, shard: GraphShard, training: bool = False, generator: Optional[torch.Generator] = None):
        """(k, state (Np, d), out, new moving statistics) of this rank's part,
        without gradients; rows follow the partition layout."""
        self._require_plain_params()
        self.gnn.build()
        if generator is None and self.gnn.state_vect_dim > 0:
            generator = self.gnn.next_rng()
        with torch.no_grad():
            return self._local_forward(shard, training, generator)

    def evaluate(self, shard: GraphShard, verbose: int = 0) -> dict:
        """Loss and metrics over the whole partitioned graph (inference mode),
        equal on every rank."""
        from gnnkeras_tpu_torch.parallel.collectives import psum
        from gnnkeras_tpu_torch.training.metrics import get_metric

        gnn = self.gnn
        if gnn.loss is None:
            raise RuntimeError("call compile() before evaluate()")
        _, _, out, _ = self.forward(shard, training=False)
        y, mask, sw = shard.targets, shard.target_mask, shard.sample_weight
        reduce = (lambda t: t) if shard.focus == "g" else (lambda t: psum(t, self.group))
        with torch.no_grad():
            per = gnn.loss(y, out)
            m = mask.to(per.dtype)
            total = reduce(torch.stack([torch.sum(per * sw * m), torch.sum(m)]))
            logs = {"loss": float(total[0]) / max(float(total[1]), 1.0)}
            for spec in gnn.metrics:
                name, fn = get_metric(spec)
                s, c = reduce(torch.stack(fn(y, out, mask, sw)))
                logs[name] = float(s) / max(float(c), 1.0)
        if verbose and self._rank() == 0:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
        return logs

    def _rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def _agree(self, logs: dict) -> dict:
        from gnnkeras_tpu_torch.parallel.collectives import agree_logs

        return agree_logs(logs, self.group)

    def fit(self, shard: GraphShard, epochs: int = 1, verbose: int = 1, seed: int = 0,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1, resume: bool = False,
            steps_per_launch: int = 1, validation_data=None, callbacks: Optional[list] = None,
            class_weight: Optional[dict] = None, validation_freq: int = 1):
        """Full-batch training of the partitioned graph, one step per epoch
        on every rank, with the single-device fit surface (module
        docstring).  ``steps_per_launch`` epochs run between two reads of
        the logs on the host, and a checkpoint lands where a chunk crosses
        a ``checkpoint_every`` boundary; validation or callbacks force
        chunks of one epoch.  ``class_weight`` ({class: weight}) scales each
        row's sample weight by its true class's.  Returns a ``History``;
        rank 0 of the group prints with ``verbose``."""
        from gnnkeras_tpu_torch.parallel.collectives import rank0_fit_hooks
        from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop
        from gnnkeras_tpu_torch.training.trainer import _class_weight_vector
        from gnnkeras_tpu_torch.training.trainer import evaluate as seq_evaluate

        self._require_collective("fit")
        self._require_plain_params()
        gnn = self.gnn
        if gnn.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        gnn.build(seed=seed)
        if class_weight:
            cw = _class_weight_vector(class_weight, shard.targets.device)
            cls = torch.clamp(torch.argmax(shard.targets, dim=-1), 0, cw.shape[0] - 1)
            shard = dataclasses.replace(shard, sample_weight=shard.sample_weight * cw[cls])

        def run_chunk(epoch, n):
            steps = [self.train_step(shard, gnn.next_rng()) for _ in range(n)]
            host = torch.stack([torch.stack([s["loss"], s["k"].to(s["loss"].dtype)]) for s in steps]).cpu()
            return [self._agree({"loss": float(loss), "k": float(k)}) for loss, k in host.tolist()]

        validate = None
        if isinstance(validation_data, GraphShard):
            validate = lambda: self._agree({f"val_{k}": v for k, v in self.evaluate(validation_data).items()})
        elif validation_data is not None:
            validate = lambda: self._agree(seq_evaluate(gnn, validation_data, verbose=0, prefix="val_"))

        return run_fit_loop(
            gnn, epochs=epochs, run_chunk=run_chunk, chunk_size=steps_per_launch, validate=validate,
            callbacks=callbacks, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            validation_freq=validation_freq, **rank0_fit_hooks(gnn, self.group, verbose),
        )
