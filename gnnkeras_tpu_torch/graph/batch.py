"""Device-side graph batch: a frozen dataclass of tensors with padded shapes.

Counterpart of ``gnnkeras_tpu.graph.batch``.  Nodes, arcs and graphs are
padded; padded arcs carry weight 0 and padded nodes are masked everywhere, so
they are inert in aggregation, BatchNorm, convergence checks and readout.
Operators travel as (src, dst, weight) arrays plus, for 128-aligned batches,
the aggregation operator (dense-block BCSR, or with ``agg_dtype`` its
banded int8 decomposition, its quantised form or a cast copy), the strip
operator of slot-packed batches (slot 128, or the slot-32/64 mixed format)
and the compact tile-wise readout, and for the arc focus the incidence pairs
of the arc readout.  A composite graph (``CompositeGraphObject``) also gives
its node-type mask and the batch-constant per-type neighbour-label sums.
Everything is built on the host in NumPy and moved to ``device`` once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gnnkeras_tpu_torch import native
from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.ops.segment import segment_sum
from gnnkeras_tpu_torch.utils.dtypes import floatx, resolve_device
from gnnkeras_tpu_torch.utils.pytree import register_tensor_dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _move(x, device, non_blocking=False):
    return x.to(device, non_blocking=non_blocking) if hasattr(x, "to") else x


@dataclasses.dataclass(frozen=True)
class CompactReadout:
    """Tile-wise graph readout for tile-packed batches: per-tile selection
    weights (T, Gmax, 128), so the readout is one batched product and graph
    rows are the slot rows ``tile·Gmax + rank``.  Graphs spanning several
    tiles land in slot 0 of each of their tiles; their partials are summed
    per spanning graph and written to its first-tile row."""

    sel: torch.Tensor  # (T, Gmax, 128) readout weights
    span_tile_sel: torch.Tensor  # (T,) 1.0 where the tile belongs to a spanning graph
    span_group: torch.Tensor  # (T,) i32 spanning-graph segment id (dummy = n_span_pad-1)
    span_rows: torch.Tensor  # (n_span_pad,) i32 slot row of each spanning graph (dummy = T·Gmax)
    n_span_pad: int

    def apply(self, node_out: torch.Tensor) -> torch.Tensor:
        t, g_max, tile = self.sel.shape
        c = node_out.shape[1]
        slots = torch.einsum("tgn,tnc->tgc", self.sel, node_out.reshape(t, tile, c))
        flat = slots.reshape(t * g_max, c)
        if self.n_span_pad > 1:  # slot-0 partials of spanning tiles → first-tile row
            tile0 = slots[:, 0, :] * self.span_tile_sel[:, None]
            totals = segment_sum(tile0, self.span_group, self.n_span_pad)
            # dummy rows point one past the end: write into a spare row, drop it
            flat = torch.cat([flat, flat.new_zeros(1, c)])
            flat[self.span_rows.long()] = totals
            flat = flat[:-1]
        return flat

    def to(self, device, non_blocking: bool = False) -> "CompactReadout":
        return dataclasses.replace(
            self, **{f.name: _move(getattr(self, f.name), device, non_blocking) for f in dataclasses.fields(self)}
        )


register_tensor_dataclass(CompactReadout, static=("n_span_pad",))


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """One padded (possibly merged) graph batch.

    Shapes (N padded nodes, A padded arcs, G padded graphs, M = N or A by
    focus, R = M or G for targets): nodes (N, dn) · arc_src/arc_dst (A,) i32
    · arc_label (A, da) · arcnode_weight (A,) · node_mask (N,) · arc_mask (A,)
    · set_mask/output_mask (M,) · graph_of_node (N,) i32 · nodegraph_weight
    (N,) · graph_mask (G,) · targets (R, T) · target_mask (R,) ·
    sample_weight (R,) · composite batches: type_mask (N, T_types) bool and
    agg_component (N, Σd_t + da).  ``host_pred_rows`` (NumPy, host only)
    lists the rows of the supervised entities in the caller's order."""

    nodes: torch.Tensor
    arc_src: torch.Tensor
    arc_dst: torch.Tensor
    arc_label: torch.Tensor
    arcnode_weight: torch.Tensor
    node_mask: torch.Tensor
    arc_mask: torch.Tensor
    set_mask: torch.Tensor
    output_mask: torch.Tensor
    graph_of_node: torch.Tensor
    nodegraph_weight: torch.Tensor
    graph_mask: torch.Tensor
    targets: torch.Tensor
    target_mask: torch.Tensor
    sample_weight: torch.Tensor
    bcsr: Optional[object]  # BcsrMatrix, BandedOperator or QuantBcsr
    strip: Optional[object]  # StripOperator (slot-packed batches)
    nodegraph_bcsr: Optional[object]  # BcsrMatrix (N × G) graph readout
    compact_readout: Optional[CompactReadout]
    # batch-constant neighbour sums, accumulated on the host in f64:
    # ``ArcNodeᵀ·arc_labels`` and ``Adjᵀ·node_labels``
    agg_arc_labels: Optional[torch.Tensor]  # (N, da)
    agg_node_labels: Optional[torch.Tensor]  # (N, dn)
    # arc focus: the union incidence pairs (arc row → src/dst endpoint) of
    # the arc readout's select and scatter (ops/incidence.py); None elsewhere
    # or when the structure declined
    arc_inc: Optional[object] = None  # IncidencePairs
    # composite batches: the node types, and the per-type neighbour-label
    # sums gated by the source's type, concatenated with ``agg_arc_labels``
    # (host-built in f64, batch-constant); None for homogeneous batches
    type_mask: Optional[torch.Tensor] = None  # (N, T_types) bool
    agg_component: Optional[torch.Tensor] = None  # (N, Σd_t + da)
    focus: str = "n"
    dim_node_label: Tuple[int, ...] = ()
    host_pred_rows: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.arc_src.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def dim_arc_label(self) -> int:
        return self.arc_label.shape[1]

    @property
    def num_types(self) -> int:
        return 1 if self.type_mask is None else self.type_mask.shape[1]

    @property
    def dim_target(self) -> int:
        return self.targets.shape[1]

    @property
    def output_row_mask(self) -> torch.Tensor:
        """set ∧ output ∧ valid: the rows whose state feeds net_output."""
        valid = self.arc_mask if self.focus == "a" else self.node_mask
        return self.set_mask & self.output_mask & valid

    def replace(self, **kwargs) -> "GraphBatch":
        return dataclasses.replace(self, **kwargs)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """The same batch with every tensor and operator on ``device``
        (``non_blocking``: copies from pinned memory run asynchronously)."""
        device = resolve_device(device)
        moved = {
            f.name: _move(getattr(self, f.name), device, non_blocking)
            for f in dataclasses.fields(self)
            if f.name not in ("focus", "dim_node_label", "host_pred_rows")
        }
        return dataclasses.replace(self, **moved)

    def aggregate(self, state: torch.Tensor) -> torch.Tensor:
        """``Adjacencyᵀ·state``: the block operator when present (banded
        decomposition, quantised BCSR or BCSR), else the edge-list segment
        sum."""
        if self.bcsr is not None:
            from gnnkeras_tpu_torch.ops.banded import BandedOperator, banded_aggregate
            from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr, bcsr_aggregate, qbcsr_aggregate

            if isinstance(self.bcsr, BandedOperator):
                return banded_aggregate(state, self.bcsr)
            if isinstance(self.bcsr, QuantBcsr):
                return qbcsr_aggregate(state, self.bcsr)
            return bcsr_aggregate(state, self.bcsr)
        from gnnkeras_tpu_torch.ops.segment import aggregate_neighbors

        return aggregate_neighbors(state, self.arc_src, self.arc_dst, self.arcnode_weight, self.num_nodes)

    def readout(self, node_out: torch.Tensor) -> torch.Tensor:
        """``NodeGraphᵀ·out``: compact tile-wise readout, rectangular BCSR,
        or the segment fallback."""
        if self.compact_readout is not None:
            return self.compact_readout.apply(node_out)
        if self.nodegraph_bcsr is not None:
            from gnnkeras_tpu_torch.ops.bcsr import bcsr_aggregate

            return bcsr_aggregate(node_out, self.nodegraph_bcsr)[: self.num_graphs]
        from gnnkeras_tpu_torch.ops.segment import graph_readout

        return graph_readout(node_out, self.graph_of_node, self.nodegraph_weight, self.num_graphs)


register_tensor_dataclass(GraphBatch, static=("focus", "dim_node_label", "host_pred_rows"), host=("host_pred_rows",))


def _scatter_targets(g, focus, n_rows, n_graphs_pad, pos=None, graph_rows=None):
    """Targets and sample weights row-aligned with their focus entity, and
    the set∧output target mask."""
    t_dim = g.DIM_TARGET
    dtype = floatx()
    if focus == "g":
        targets = np.zeros((n_graphs_pad, t_dim), dtype=dtype)
        sw = np.zeros(n_graphs_pad, dtype=dtype)
        mask = np.zeros(n_graphs_pad, dtype=bool)
        where = graph_rows if graph_rows is not None else np.arange(g.targets.shape[0])
        targets[where] = g.targets
        sw[where] = g.sample_weight
        mask[where] = True
        return targets, mask, sw
    targets = np.zeros((n_rows, t_dim), dtype=dtype)
    sw = np.zeros(n_rows, dtype=dtype)
    out_idx = np.flatnonzero(g.output_mask)
    if len(out_idx) != g.targets.shape[0]:
        raise ValueError(
            f"targets rows ({g.targets.shape[0]}) must match output_mask-true entities ({len(out_idx)})"
        )
    rows = out_idx if (focus == "a" or pos is None) else pos[out_idx]
    targets[rows] = g.targets
    sw[rows] = g.sample_weight
    mask = np.zeros(n_rows, dtype=bool)
    mask[rows] = g.set_mask[out_idx]
    return targets, mask, sw


def from_graph_object(
    g: GraphObject,
    pad_nodes: Optional[int] = None,
    pad_arcs: Optional[int] = None,
    pad_graphs: Optional[int] = None,
    set_mask_override: Optional[np.ndarray] = None,
    dense_blocks: bool = True,
    agg_dtype: Optional[str] = None,
    tile_pack: bool = False,
    slot_pack: Optional[int] = None,
    strip_dtype: str = "float32",
    compact_gmax: Optional[int] = None,
    compact_nspan: Optional[int] = None,
    device="cuda",
) -> GraphBatch:
    """Convert a (possibly merged) host graph into a padded batch on
    ``device`` (default ``"cuda"``; raises when no card is present).

    ``set_mask_override`` makes a view of one graph with its own set mask
    (single-graph mini-batching, ``single_graph_batch``).

    ``tile_pack`` re-positions whole graphs into 128-node tiles (per-node
    output rows are then permuted with gaps; ``host_pred_rows`` restores the
    caller's order).  ``slot_pack`` (32, 64 or 128) packs at slot
    granularity and also builds the strip operator in ``strip_dtype`` (int8
    mask+scale, falling back to bf16 with a warning when the weights do not
    factor; float32; bfloat16), which selects the transposed unfold engine:
    at 128 it positions as ``tile_pack`` does (dense diagonal blocks); at
    32/64 slot-pure tiles come first as compact strips and tiles holding
    larger graphs follow as full blocks (``order_tiles_by_format``).

    ``agg_dtype`` picks the aggregation operator: ``'auto'`` the banded
    int8 decomposition (``ops/banded.py``) when it is exact, else the plain
    float BCSR; ``'int8'`` the banded decomposition (bf16 where int8 does
    not factor), else quantised BCSR (``QuantBcsr``); a float name
    (``'float32'``, ``'bfloat16'``) casts the aggregation and readout BCSR
    operators; None keeps the f32 BCSR."""
    device = resolve_device(device)
    if agg_dtype not in (None, "auto", "int8", "float32", "bfloat16"):
        raise ValueError(f"unsupported agg_dtype {agg_dtype!r}")
    if slot_pack is not None and slot_pack not in (32, 64, 128):
        raise ValueError(f"slot_pack {slot_pack} must be 32, 64 or 128")
    n, a = g.nodes.shape[0], g.arcs.shape[0]
    n_graphs = max(g.num_graphs, 1)

    pack_width = slot_pack if slot_pack is not None else (128 if tile_pack else None)
    n_strip_tiles = None
    if pack_width is not None and dense_blocks and n > 0:
        from gnnkeras_tpu_torch.graph.packing import order_tiles_by_format, pack_slots, positions_from_starts

        pack_sizes = np.bincount(g.graph_of_node.astype(np.int64), minlength=n_graphs)
        pack_starts, n_rows_needed = pack_slots(pack_sizes, slot=pack_width, tile=128)
        if slot_pack is not None and slot_pack < 128:
            # mixed format: slot-pure tiles first (compact strips), tiles
            # holding larger graphs after (full diagonal blocks)
            from gnnkeras_tpu_torch.ops.strip import K_TILES

            pack_starts, n_strip_tiles, n_rows_needed = order_tiles_by_format(
                pack_starts, pack_sizes, slot_pack, 128, align=K_TILES
            )
        pos = positions_from_starts(g.graph_of_node, pack_starts)
    else:
        pack_width = None
        pos = np.arange(n, dtype=np.int64)
        n_rows_needed = n

    N = pad_nodes if pad_nodes is not None else _round_up(max(n_rows_needed, 1), 128 if dense_blocks else 8)
    A = pad_arcs if pad_arcs is not None else _round_up(max(a, 1), 8)

    compact_info = None
    if pack_width is not None and g.focus == "g" and pad_graphs is None and N % 128 == 0:
        from gnnkeras_tpu_torch.graph.packing import graph_slots_from_starts

        tile0, rank, _, g_max, spanning = graph_slots_from_starts(pack_starts, pack_sizes, 128)
        if compact_gmax is not None:
            g_max = max(g_max, int(compact_gmax))
        T_n = N // 128
        graph_rows = tile0 * g_max + rank
        compact_info = (tile0, rank, g_max, spanning, T_n, graph_rows)
        G = T_n * g_max
    else:
        graph_rows = None
        G = pad_graphs if pad_graphs is not None else _round_up(n_graphs, 8)
    G_blocks = _round_up(G, 128)
    if N < n_rows_needed or A < a or G < n_graphs:
        raise ValueError(f"padding ({N},{A},{G}) smaller than graph ({n_rows_needed},{a},{n_graphs})")

    dtype = floatx()
    nodes = np.zeros((N, g.nodes.shape[1]), dtype=dtype)
    nodes[pos] = g.nodes
    src = np.zeros(A, dtype=np.int32)
    dst = np.zeros(A, dtype=np.int32)
    src[:a] = pos[g.arcs[:, 0].astype(np.int64)].astype(np.int32)
    dst[:a] = pos[g.arcs[:, 1].astype(np.int64)].astype(np.int32)
    arc_label = np.zeros((A, g.DIM_ARC_LABEL), dtype=dtype)
    arc_label[:a] = g.arcs[:, 2:]
    w = np.zeros(A, dtype=dtype)
    w[:a] = g.arcnode_weight

    node_mask = np.zeros(N, dtype=bool)
    node_mask[pos] = True
    arc_mask = np.zeros(A, dtype=bool)
    arc_mask[:a] = True

    sm = g.set_mask if set_mask_override is None else np.asarray(set_mask_override, dtype=bool)
    m_rows = A if g.focus == "a" else N
    set_mask = np.zeros(m_rows, dtype=bool)
    output_mask = np.zeros(m_rows, dtype=bool)
    if g.focus == "a":
        set_mask[: len(sm)] = sm
        output_mask[: len(g.output_mask)] = g.output_mask
    else:
        set_mask[pos] = sm
        output_mask[pos] = g.output_mask

    graph_of_node = np.zeros(N, dtype=np.int32)
    ngw = np.zeros(N, dtype=dtype)
    ngw[pos] = g.nodegraph_weight
    graph_mask = np.zeros(G, dtype=bool)
    if compact_info is not None:
        graph_of_node[pos] = graph_rows[g.graph_of_node.astype(np.int64)].astype(np.int32)
        graph_mask[graph_rows] = True
    else:
        graph_of_node[pos] = g.graph_of_node.astype(np.int32)
        graph_mask[:n_graphs] = True

    r_rows = G if g.focus == "g" else m_rows
    targets, target_mask, sample_weight = _scatter_targets(g, g.focus, r_rows, G, pos, graph_rows)
    if g.focus != "g" and set_mask_override is not None:
        full = np.zeros(r_rows, dtype=bool)
        idx = np.flatnonzero(g.output_mask)
        if g.focus == "a":
            full[idx] = sm[idx]
        else:
            full[pos[idx]] = sm[idx]
        target_mask = full

    if g.focus == "g":
        pred_rows = np.asarray(graph_rows if graph_rows is not None else np.arange(g.targets.shape[0]), dtype=np.int64)
    else:
        idx = np.flatnonzero(g.output_mask)
        rows_entity = idx if g.focus == "a" else pos[idx]
        pred_rows = rows_entity[sm[idx].astype(bool)]

    bcsr = strip_op = nodegraph_bcsr = compact_readout = None
    if dense_blocks and N % 128 == 0:
        from gnnkeras_tpu_torch.ops.bcsr import build_bcsr

        # on the host first: a quantised form may replace it
        bcsr = build_bcsr(src[:a], dst[:a], w[:a], N)
        if slot_pack is not None and pack_width is not None:
            from gnnkeras_tpu_torch.ops.strip import build_strip_or_bf16

            strip_op = build_strip_or_bf16(src[:a], dst[:a], w[:a], N, strip_dtype, device, slot=slot_pack,
                                           n_strip_tiles=n_strip_tiles)
        if compact_info is not None:
            tile0, rank, g_max, spanning, T_n, graph_rows_np = compact_info
            sel = np.zeros((T_n, g_max, 128), dtype=dtype)
            g_of_n = g.graph_of_node.astype(np.int64)
            sel[pos // 128, rank[g_of_n], pos % 128] = g.nodegraph_weight
            span_ids = np.flatnonzero(spanning)
            n_span_pad = max(len(span_ids) + 1, int(compact_nspan or 0))
            span_tile_sel = np.zeros(T_n, dtype=dtype)
            span_group = np.full(T_n, n_span_pad - 1, np.int32)
            span_rows = np.full(n_span_pad, G, np.int32)  # dummy → dropped
            sizes = np.bincount(g_of_n, minlength=n_graphs)
            for s_idx, g_id in enumerate(span_ids):
                run = -(-int(sizes[g_id]) // 128)
                t_start = int(tile0[g_id])
                span_tile_sel[t_start : t_start + run] = 1.0
                span_group[t_start : t_start + run] = s_idx
                span_rows[s_idx] = graph_rows_np[g_id]
            compact_readout = CompactReadout(
                sel=torch.from_numpy(sel).to(device),
                span_tile_sel=torch.from_numpy(span_tile_sel).to(device),
                span_group=torch.from_numpy(span_group).to(device),
                span_rows=torch.from_numpy(span_rows).to(device),
                n_span_pad=n_span_pad,
            )
        elif g.focus == "g" and n > 0:
            nodegraph_bcsr = build_bcsr(pos, g.graph_of_node, g.nodegraph_weight, N, G_blocks, device=device)
        if agg_dtype in ("int8", "auto"):
            # the banded int8 decomposition when the graph is banded; 'auto'
            # takes it only when the mask+scale factorisation is exact and
            # otherwise keeps the plain float operator (never the bf16
            # degrade, never quantised BCSR); 'int8' falls back to QuantBcsr.
            # The readout operator stays float (read once per forward).
            from gnnkeras_tpu_torch.ops.banded import build_banded_operator
            from gnnkeras_tpu_torch.ops.bcsr import quantize_bcsr

            bop = build_banded_operator(src[:a], dst[:a], w[:a], N, dtype="int8", strict_int8=agg_dtype == "auto",
                                        device=device)
            if bop is not None:
                bcsr = bop
            elif agg_dtype == "int8":
                bcsr = quantize_bcsr(bcsr, "int8", device=device)
        elif agg_dtype is not None:
            from gnnkeras_tpu_torch.ops.bcsr import cast_bcsr

            bcsr = cast_bcsr(bcsr, agg_dtype)
            nodegraph_bcsr = cast_bcsr(nodegraph_bcsr, agg_dtype)
        if bcsr is not None:
            bcsr = bcsr.to(device)

    agg_arc, agg_node = native.agg_label_sums(src[:a], dst[:a], w[:a], arc_label[:a], nodes, N)
    type_mask = agg_component = None
    if isinstance(g, CompositeGraphObject):
        type_mask = np.zeros((N, g.num_types), dtype=bool)
        type_mask[pos] = g.type_mask
        per_type = native.agg_component_sums(src[:a], dst[:a], w[:a], nodes, type_mask,
                                             [int(d) for d in g.DIM_NODE_LABEL], N)
        agg_component = np.concatenate([per_type, agg_arc], axis=1)

    arc_inc = None
    if g.focus == "a" and dense_blocks:
        from gnnkeras_tpu_torch.ops.incidence import build_incidence_pairs

        arc_inc = build_incidence_pairs(src, dst, N)
        if arc_inc is not None:
            arc_inc = arc_inc.to(device)

    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return GraphBatch(
        nodes=T(nodes),
        arc_src=T(src),
        arc_dst=T(dst),
        arc_label=T(arc_label),
        arcnode_weight=T(w),
        node_mask=T(node_mask),
        arc_mask=T(arc_mask),
        set_mask=T(set_mask),
        output_mask=T(output_mask),
        graph_of_node=T(graph_of_node),
        nodegraph_weight=T(ngw),
        graph_mask=T(graph_mask),
        targets=T(targets),
        target_mask=T(target_mask),
        sample_weight=T(sample_weight),
        bcsr=bcsr,
        strip=strip_op,
        nodegraph_bcsr=nodegraph_bcsr,
        compact_readout=compact_readout,
        agg_arc_labels=T(agg_arc.astype(dtype)),
        agg_node_labels=T(agg_node.astype(dtype)),
        arc_inc=arc_inc,
        type_mask=None if type_mask is None else T(type_mask),
        agg_component=None if agg_component is None else T(agg_component.astype(dtype)),
        focus=g.focus,
        dim_node_label=tuple(int(d) for d in g.DIM_NODE_LABEL),
        host_pred_rows=pred_rows,
    )


def pad_operators_to_cap(batch: GraphBatch) -> GraphBatch:
    """Pad the data-dependent BCSR block counts and incidence pair count to
    their caps (``_MAX_BAND_FACTOR × tiles``, ``_MAX_PAIRS_PER_ARC_TILE ×
    arc tiles``), so every batch of one padded shape has the same operator
    shapes whatever its topology."""
    from gnnkeras_tpu_torch.ops.bcsr import _MAX_BAND_FACTOR, BcsrMatrix, QuantBcsr, pad_bcsr, pad_qbcsr
    from gnnkeras_tpu_torch.ops.incidence import _MAX_PAIRS_PER_ARC_TILE, pad_incidence_pairs

    kwargs = {}
    for name in ("bcsr", "nodegraph_bcsr"):
        m = getattr(batch, name)
        pad = {BcsrMatrix: pad_bcsr, QuantBcsr: pad_qbcsr}.get(type(m))
        if pad is not None:  # a banded decomposition has no data-dependent block count
            kwargs[name] = pad(m, _MAX_BAND_FACTOR * max(m.n_src_tiles, m.n_dst_tiles))
    if batch.arc_inc is not None:
        kwargs["arc_inc"] = pad_incidence_pairs(batch.arc_inc, _MAX_PAIRS_PER_ARC_TILE * batch.arc_inc.n_arc_tiles)
    return batch.replace(**kwargs) if kwargs else batch


def graphs_to_batch(
    graphs: Sequence[GraphObject],
    focus: str,
    aggregation_mode: str,
    pad_nodes: Optional[int] = None,
    pad_arcs: Optional[int] = None,
    pad_graphs: Optional[int] = None,
    *,
    dense_blocks: bool = True,
    agg_dtype: Optional[str] = None,
    tile_pack: bool = False,
    slot_pack: Optional[int] = None,
    strip_dtype: str = "float32",
    device="cuda",
) -> GraphBatch:
    """Merge host graphs (disjoint union; composite graphs keep their type
    masks) and pad them into one batch; the operator options pass through
    to ``from_graph_object``."""
    cls = CompositeGraphObject if isinstance(graphs[0], CompositeGraphObject) else GraphObject
    merged = cls.merge(list(graphs), focus=focus, aggregation_mode=aggregation_mode)
    return from_graph_object(
        merged, pad_nodes, pad_arcs, pad_graphs, dense_blocks=dense_blocks, agg_dtype=agg_dtype,
        tile_pack=tile_pack, slot_pack=slot_pack, strip_dtype=strip_dtype, device=device,
    )


def single_graph_batch(
    g: GraphObject,
    batch_set_mask: Optional[np.ndarray] = None,
    pad_nodes: Optional[int] = None,
    pad_arcs: Optional[int] = None,
    *,
    agg_dtype: Optional[str] = None,
    device="cuda",
) -> GraphBatch:
    """Batch view over one large graph: the full topology with a per-batch
    set mask (single-graph mini-batching)."""
    return from_graph_object(g, pad_nodes, pad_arcs, pad_graphs=None, set_mask_override=batch_set_mask,
                             agg_dtype=agg_dtype, device=device)
