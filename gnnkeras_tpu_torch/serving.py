"""In-process serving endpoint, counterpart of ``gnnkeras_tpu.serving``'s
``Predictor``.

Requests (lists of ``GraphObject``) are merged into a padded template batch
and served through one of two routes, chosen per request exactly as in the
JAX package:

- the fused route: when the model folds (``fold_transition``; dim_state 0,
  threshold 0, one Dense state layer), a request whose graphs pack into the
  template with every edge inside its 128-node tile runs its whole unfolding
  in one launch of the ``fused_unfold_t`` kernel, then the model's readout
  (for the arc focus, through the ``incidence_select`` kernel);
- the eval-forward route: every other request (a packing overflow, an edge
  that crosses tiles, or a model that does not fold) runs ``model.forward``.

The route is a choice by request shape, never by kernel health: a kernel
that fails to build or launch raises.  Outputs come back in the caller's
(graph, entity) order.  ``MicroBatcher``, export and HTTP serving come with
later slices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnnkeras_tpu_torch.graph.batch import from_graph_object, pad_operators_to_cap
from gnnkeras_tpu_torch.graph.graph import GraphObject
from gnnkeras_tpu_torch.utils.dtypes import resolve_device


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


_FOCUS_OF_NAME = {"node": "n", "arc": "a", "graph": "g"}


class Predictor:
    """Fixed-template inference endpoint around a model.

    ``max_nodes`` / ``max_arcs`` / ``max_graphs`` define the padded request
    template; requests that overflow it raise.  ``fused='auto'`` serves
    through the whole-unfold kernel whenever the model folds, ``True``
    requires that it folds, ``False`` always takes the eval forward.  The
    model is built (seed 0 unless already built) and placed on ``device``
    (default ``"cuda"``; raises when no card is present)."""

    def __init__(
        self,
        model,
        max_nodes: int,
        max_arcs: int,
        max_graphs: int,
        aggregation_mode: str = "average",
        fused: object = "auto",
        dims: Optional[Tuple[int, int, int]] = None,
        warmup_graph: Optional[GraphObject] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        model.build(device=self.device)
        self.model = model
        self.focus = _FOCUS_OF_NAME.get(getattr(model, "name", "node"), "n")
        self.aggregation_mode = aggregation_mode
        self.max_nodes = _round_up(int(max_nodes), 128)
        self.max_arcs = _round_up(int(max_arcs), 8)
        self.max_graphs = int(max_graphs)
        self.dims = dims  # (dim_node_label, dim_arc_label, dim_target), for warmup
        self._warmup_graph = warmup_graph

        self._act = None
        if fused:
            folded = getattr(model, "fold_transition", lambda: None)()
            ok = folded is not None and float(model.state_threshold) == 0.0
            if not ok and fused is True:
                raise ValueError("fused=True requires dim_state==0, threshold==0 and a single-Dense state net")
            self._act = folded[4] if ok else None
        self.fused = self._act is not None

    @classmethod
    def for_graphs(cls, model, sample_graphs: Sequence[GraphObject], batch_size: int,
                   headroom: float = 1.0, **kwargs) -> "Predictor":
        """Size the template from representative graphs: the ``batch_size``
        largest sample graphs define the node/arc budget (× ``headroom``)."""
        nodes = sorted((g.nodes.shape[0] for g in sample_graphs), reverse=True)
        arcs = sorted((g.arcs.shape[0] for g in sample_graphs), reverse=True)
        n = int(sum(nodes[:batch_size]) * headroom)
        a = int(sum(arcs[:batch_size]) * headroom)
        agg = kwargs.pop("aggregation_mode", sample_graphs[0].aggregation_mode)
        g0 = sample_graphs[0]
        dims = kwargs.pop("dims", (g0.nodes.shape[1], g0.DIM_ARC_LABEL, g0.DIM_TARGET))
        kwargs.setdefault("warmup_graph", g0)
        return cls(model, n, a, batch_size, aggregation_mode=agg, dims=dims, **kwargs)

    def _merge(self, graphs: Sequence[GraphObject]) -> GraphObject:
        if len(graphs) > self.max_graphs:
            raise ValueError(f"request has {len(graphs)} graphs > template {self.max_graphs}")
        merged = GraphObject.merge(list(graphs), focus=self.focus, aggregation_mode=self.aggregation_mode)
        n, a = merged.nodes.shape[0], merged.arcs.shape[0]
        if n > self.max_nodes or a > self.max_arcs:
            raise ValueError(f"request ({n} nodes, {a} arcs) overflows template ({self.max_nodes}, {self.max_arcs})")
        return merged

    def __call__(self, graphs) -> np.ndarray:
        """Outputs for every supervised (set∧output) entity, rows in the
        caller's (graph, entity) order."""
        if isinstance(graphs, GraphObject):
            graphs = [graphs]
        merged = self._merge(graphs)
        if self.fused:
            res = self._predict_fused(merged)
            if res is not None:
                return res
        return self._predict_eval(merged)

    def _predict_eval(self, merged: GraphObject) -> np.ndarray:
        batch = pad_operators_to_cap(from_graph_object(
            merged, pad_nodes=self.max_nodes, pad_arcs=self.max_arcs, pad_graphs=self.max_graphs,
            device=self.device,
        ))
        # the generator draws a dim_state > 0 model's random initial state
        _, _, out, _, _ = self.model.forward(batch, training=False, generator=self.model.next_rng())
        return out.cpu().numpy()[batch.host_pred_rows]

    def _predict_fused(self, merged: GraphObject) -> Optional[np.ndarray]:
        """The fused route, or None when the request does not qualify
        (packing gaps overflow the template, or an edge crosses tiles)."""
        from gnnkeras_tpu_torch.ops.fused import D_SUB, build_fused_diag_t, fused_unfold_t

        try:
            batch = from_graph_object(
                merged, pad_nodes=self.max_nodes, pad_arcs=self.max_arcs,
                pad_graphs=None if self.focus == "g" else self.max_graphs,
                tile_pack=True, compact_gmax=self.max_graphs, compact_nspan=self.max_nodes // 128 + 1,
                device="cpu",
            )
        except ValueError:  # packing gaps overflow the template
            return None
        a = merged.arcs.shape[0]
        op = build_fused_diag_t(
            batch.arc_src.numpy()[:a], batch.arc_dst.numpy()[:a], batch.arcnode_weight.numpy()[:a],
            batch.num_nodes, dtype=torch.bfloat16,
        )
        if op is None:  # an edge crosses tiles
            return None
        # host-side feature-major inputs, built before the one move to the card
        d = batch.nodes.shape[1]
        dn = self.model.net_state.output_dim
        d_pad = -(-max(d, dn) // D_SUB) * D_SUB
        nodes_t = torch.zeros((d_pad, batch.num_nodes), dtype=batch.nodes.dtype)
        nodes_t[:d] = batch.nodes.T
        agg_arcs_t = batch.agg_arc_labels.T.contiguous()
        # this route reads no BCSR operator: leave it on the host (an arc
        # model's incidence pairs go to the card with the batch)
        batch, op = batch.replace(bcsr=None).to(self.device), op.to(self.device)
        nodes_t, agg_arcs_t = nodes_t.to(self.device), agg_arcs_t.to(self.device)

        model = self.model
        with torch.no_grad():
            # fold the live weights per request, so weight updates after
            # construction are served as on the eval route
            w_state, w_agg, w_arc, bias, _ = model.fold_transition()
            h = bias.shape[0]
            const_t = F.pad(w_arc, (0, d_pad - h)).T @ agg_arcs_t + F.pad(bias, (0, d_pad - h))[:, None]
            state_t = fused_unfold_t(nodes_t, const_t, w_state, w_agg, op, model.max_iteration, self._act)
            out, _, _ = model.apply_output(state_t.T[:, :h], batch)
        # host_pred_rows undoes the tile-pack permutation
        return out.cpu().numpy()[batch.host_pred_rows]

    # -- warmup ----------------------------------------------------------------
    def _synthetic_graph(self, dn: int, da: int, dt: int) -> GraphObject:
        """A 2-node, 2-arc tile-local graph with the template's feature dims,
        valid on both routes."""
        nodes = np.zeros((2, dn), dtype=np.float32)
        nodes[:, 0] = 1.0
        arcs = np.zeros((2, 2 + da), dtype=np.float32)
        arcs[0, :2] = [0, 1]
        arcs[1, :2] = [1, 0]
        n_t = 1 if self.focus == "g" else 2
        return GraphObject(nodes=nodes, arcs=arcs, targets=np.zeros((n_t, dt), dtype=np.float32),
                           focus=self.focus, aggregation_mode=self.aggregation_mode)

    def _warm_with(self, g: GraphObject) -> None:
        merged = self._merge([g])
        fused_ran = self.fused and self._predict_fused(merged) is not None
        self._predict_eval(merged)
        if self.fused and not fused_ran:
            dn = g.nodes.shape[1]
            tiny = self._synthetic_graph(dn, int(g.DIM_ARC_LABEL), int(g.DIM_TARGET))
            self._predict_fused(self._merge([tiny]))

    def warmup(self) -> "Predictor":
        """Run both routes once (this builds the CUDA kernels on first use),
        so the first real request pays no set-up."""
        if self._warmup_graph is not None:
            self._warm_with(self._warmup_graph)
            return self
        if self.dims is None:
            raise ValueError("warmup needs dims=(dn, da, dt) — or build via for_graphs")
        self._warm_with(self._synthetic_graph(*self.dims))
        return self
