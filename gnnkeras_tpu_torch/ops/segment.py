"""Edge-wise aggregation primitives (gather + ``index_add_``, or an ordered
segment sum).

- ``ArcNodeᵀ·L``   == segment_sum(w[e]·arc_label[e]  → dst[e])
- ``Adjacencyᵀ·S`` == segment_sum(w[e]·state[src[e]] → dst[e])
- ``NodeGraphᵀ·O`` == segment_sum(out[n]·w[n]        → graph_of_node[n])

Padded arcs carry weight 0, so they contribute nothing whatever their
filler indices.  Counterpart of ``gnnkeras_tpu.ops.segment``.

``index_add_`` on the card adds with atomics, in an order that changes from
run to run.  ``segment_sum_ordered`` adds each segment's rows one after
another in their order, as ``index_add_`` does on the CPU, so it gives the
same sums on every device and in every run.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows by segment id along dim 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_sum_ordered(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum`` with each segment's rows added in their order (a
    stable sort by segment, then a sequential sum per segment)."""
    ids = segment_ids.long()
    order = torch.sort(ids, stable=True).indices
    lengths = torch.zeros(num_segments, dtype=torch.long, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))
    return torch.segment_reduce(data[order], "sum", lengths=lengths, unsafe=True)


def aggregate_neighbors(state, src, dst, weight, num_nodes: int) -> torch.Tensor:
    """``out[d] = Σ_{e: dst[e]=d} w[e]·state[src[e]]``."""
    return segment_sum(state[src.long()] * weight[:, None], dst, num_nodes)


def aggregate_edges(arc_label, dst, weight, num_nodes: int) -> torch.Tensor:
    """``ArcNodeᵀ·arc_label``: weighted incoming arc-label sums, in arc
    order."""
    return segment_sum_ordered(arc_label * weight[:, None], dst, num_nodes)


def graph_readout(node_out, graph_of_node, node_weight, num_graphs: int) -> torch.Tensor:
    """``NodeGraphᵀ·out`` with the ``1/N_g`` factor in ``node_weight``."""
    return segment_sum(node_out * node_weight[:, None], graph_of_node, num_graphs)
