"""Serving and export, counterpart of ``gnnkeras_tpu.serving``.

- :class:`Predictor`: the in-process endpoint.  Requests (lists of
  ``GraphObject``) are merged into a padded template batch and served
  through one of two routes, chosen per request exactly as in the JAX
  package:

  - the fused route: when the model folds (``fold_transition``; dim_state 0,
    threshold 0, one Dense state layer), a request whose graphs pack into the
    template with every edge inside its 128-node tile runs its whole
    unfolding in one launch of the ``fused_unfold_t`` kernel, then the
    model's readout (for the arc focus, through the ``incidence_select``
    kernel);
  - the eval-forward route: every other request (a packing overflow, an
    edge that crosses tiles, or a model that does not fold) runs
    ``model.forward``.

  The route is a choice by request shape, never by kernel health: a kernel
  that fails to build or launch raises.  Outputs come back in the caller's
  (graph, entity) order.  Composite models (which never fold) and LGNN
  stacks (focus from their first layer, the last layer's output served)
  always take the eval forward; a composite request is merged by its own
  class, so it keeps its type masks.
- :func:`export_forward` / :func:`load_exported`: a portable artifact, the
  eval forward for one template batch shape saved by ``torch.export`` with
  the weights inside (``forward.pt2``) beside the serving metadata
  (``serving.json``).  The program calls the kernels as the custom
  operators that ``ops/strip.py`` and ``ops/incidence.py`` register, so it
  loads and runs in a process that never imports the model classes.
- :class:`MicroBatcher`: coalesces concurrent requests in front of a
  ``Predictor`` into one served batch.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from gnnkeras_tpu_torch.graph.batch import GraphBatch, from_graph_object, pad_operators_to_cap
from gnnkeras_tpu_torch.graph.graph import GraphObject
from gnnkeras_tpu_torch.utils.dtypes import resolve_device
from gnnkeras_tpu_torch.utils.pytree import static_signature


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


_FOCUS_OF_NAME = {"node": "n", "arc": "a", "graph": "g"}


def _first_layer(model):
    """The model, or an LGNN stack's first layer (its focus and its kind of
    state net)."""
    return model.gnns[0] if hasattr(model, "gnns") else model


def _focus_of(model) -> str:
    return _FOCUS_OF_NAME.get(getattr(_first_layer(model), "name", "node"), "n")


class Predictor:
    """Fixed-template inference endpoint around a model.

    ``max_nodes`` / ``max_arcs`` / ``max_graphs`` define the padded request
    template; requests that overflow it raise.  ``fused='auto'`` serves
    through the whole-unfold kernel whenever the model folds, ``True``
    requires that it folds, ``False`` always takes the eval forward.
    ``tiles_per_step`` is the JAX package's knob of its row-major fused
    kernel, kept for call compatibility; it changes no route and no result.
    The model is built (seed 0 unless already built) and placed on
    ``device`` (default ``"cuda"``; raises when no card is present).  Calls
    are serialised by a lock: the model's random stream and the kernels'
    launch counters are shared by every caller thread."""

    def __init__(
        self,
        model,
        max_nodes: int,
        max_arcs: int,
        max_graphs: int,
        aggregation_mode: str = "average",
        fused: object = "auto",
        tiles_per_step: int = 8,
        dims: Optional[Tuple[int, int, int]] = None,
        warmup_graph: Optional[GraphObject] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        model.build(device=self.device)
        self.model = model
        self.focus = _focus_of(model)
        self.aggregation_mode = aggregation_mode
        self.max_nodes = _round_up(int(max_nodes), 128)
        self.max_arcs = _round_up(int(max_arcs), 8)
        self.max_graphs = int(max_graphs)
        self.tiles_per_step = int(tiles_per_step)
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
        self._lock = threading.Lock()

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
        # by the request's class: a composite merge keeps the type masks
        merged = type(graphs[0]).merge(list(graphs), focus=self.focus, aggregation_mode=self.aggregation_mode)
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
        with self._lock:
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
        return self.model.served_output(out).cpu().numpy()[batch.host_pred_rows]

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
        so the first real request pays no set-up.  A composite model needs
        a ``warmup_graph`` (``for_graphs`` sets one) for its type layout."""
        if self._warmup_graph is None and isinstance(_first_layer(self.model).net_state, torch.nn.ModuleList):
            raise ValueError("composite Predictor warmup needs warmup_graph (use for_graphs)")
        if self._warmup_graph is None and self.dims is None:
            raise ValueError("warmup needs dims=(dn, da, dt) — or build via for_graphs")
        with self._lock:
            g = self._warmup_graph if self._warmup_graph is not None else self._synthetic_graph(*self.dims)
            self._warm_with(g)
        return self


# --------------------------------------------------------------------------
# Portable export (torch.export)
# --------------------------------------------------------------------------


class _EvalForward(torch.nn.Module):
    """``model.forward(training=False)`` in its exportable fixed-length
    form, on a batch given as its flat tensors (``spec``, the template's
    pytree structure, rebuilds it); returns (out, out_mask), an LGNN's last
    layer's output."""

    def __init__(self, model, spec):
        super().__init__()
        self.model = model
        self.spec = spec

    def forward(self, *flat):
        batch = pytree.tree_unflatten(list(flat), self.spec)
        _, _, out, out_mask, _ = self.model.forward(batch, training=False, fixed_length=True)
        return self.model.served_output(out), out_mask


def export_forward(model, template_batch: GraphBatch, path: str) -> None:
    """Save the eval forward for ``template_batch``'s shapes, with the
    model's weights, as ``path/forward.pt2`` (``torch.export``) and the
    serving metadata as ``path/serving.json``.  The model and the batch must
    be on one device; the program runs there.  Load with
    :func:`load_exported`; call it with any batch of the same shapes."""
    model.build()
    device = next(model.parameters()).device
    if device != template_batch.device:
        raise ValueError(f"export_forward: model on device {device}, template batch on {template_batch.device}")
    flat, spec = pytree.tree_flatten(template_batch)
    with torch.no_grad():
        program = torch.export.export(_EvalForward(model, spec), tuple(flat))
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, "forward.pt2"))
    meta = {
        "n_params": len(program.state_dict),
        "model_class": type(model).__name__,
        "focus": _focus_of(model),
        "batch_shapes": [list(x.shape) for x in flat],
        # the ints and layout the program was traced with
        "batch_static": static_signature(spec),
    }
    with open(os.path.join(path, "serving.json"), "w") as f:
        json.dump(meta, f)


class ExportedForward:
    """A loaded forward: ``call(batch)`` → (out, out_mask) for any batch of
    the template's shapes and static structure, on the device the batch is
    on, with the weights saved in the artifact.  A batch that differs from
    the template in either raises, as the JAX artifact's treedef check
    does."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self._device = next(iter(program.state_dict.values())).device
        self._modules = {}

    def _module(self, device: torch.device):
        """The program as a callable module on ``device`` (moved there once,
        weights and all)."""
        device = resolve_device(device)
        module = self._modules.get(device)
        if module is None:
            program = self.program
            if device != self._device:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, device)
            module = self._modules[device] = program.module()
        return module

    def call(self, batch: GraphBatch):
        flat, spec = pytree.tree_flatten(batch)
        shapes = [list(x.shape) for x in flat]
        if shapes != self.meta["batch_shapes"]:
            raise ValueError(f"batch shapes {shapes} differ from the template's {self.meta['batch_shapes']}")
        # through JSON, as the template's signature was saved
        static = json.loads(json.dumps(static_signature(spec)))
        if static != self.meta["batch_static"]:
            raise ValueError(f"batch static structure {static} differs from the template's {self.meta['batch_static']}")
        with torch.no_grad():
            return self._module(flat[0].device)(*flat)


def load_exported(path: str, device="cuda") -> ExportedForward:
    """Load an artifact of :func:`export_forward` and place its program on
    ``device`` (default ``"cuda"``; raises when no card is present).  It
    imports the operator modules, which register the kernels' custom
    operators, and no model class."""
    from gnnkeras_tpu_torch.ops import bcsr, incidence, strip  # noqa: F401  (register the custom operators)

    device = resolve_device(device)
    program = torch.export.load(os.path.join(path, "forward.pt2"))
    with open(os.path.join(path, "serving.json")) as f:
        meta = json.load(f)
    exported = ExportedForward(program, meta)
    exported._module(device)
    return exported


# --------------------------------------------------------------------------
# Request coalescing (micro-batching)
# --------------------------------------------------------------------------


class MicroBatcher:
    """Coalesces concurrent requests in front of a :class:`Predictor`.

    A background worker drains the request queue, merges up to
    ``max_graphs`` graphs (never splitting a request) or waits at most
    ``max_delay_ms`` after the first queued request, and serves the whole
    micro-batch in one ``Predictor`` call; each caller gets back exactly its
    own rows.

    Thread-safe: call :meth:`submit` (returns a ``Future``) or ``__call__``
    (blocks) from any number of client threads.  A request that overflows
    the predictor's template fails with its own exception without failing
    the rest of its micro-batch.  ``launches`` counts the served
    micro-batches.
    """

    def __init__(self, predictor: Predictor, max_delay_ms: float = 2.0, max_graphs: Optional[int] = None):
        self.predictor = predictor
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_graphs = int(max_graphs or predictor.max_graphs)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        # serialises submit()'s closed-check-then-put against close()'s
        # closed-set-then-sentinel: every accepted request is queued ahead of
        # the shutdown sentinel, so the worker or close()'s drain resolves it
        self._submit_lock = threading.Lock()
        self.launches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------------
    def submit(self, graphs) -> Future:
        """Queue a request (one GraphObject or a list); returns a Future
        resolving to the per-entity output rows in the request's order."""
        if isinstance(graphs, GraphObject):
            graphs = [graphs]
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put((list(graphs), fut))
        return fut

    def __call__(self, graphs):
        return self.submit(graphs).result()

    def close(self) -> None:
        with self._submit_lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=10)
        # what the exiting worker left behind is failed here
        self._fail_queued()

    # -- worker side -----------------------------------------------------------
    def _fail_queued(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._deliver(item[1], exc=RuntimeError("MicroBatcher is closed"))

    def _collect(self):
        """One micro-batch: [(graphs, future), ...] within the size budget,
        or None at shutdown."""
        item = self._queue.get()
        if item is None:
            return None
        batch = [item]
        total = len(item[0])
        deadline = time.monotonic() + self.max_delay
        while total < self.max_graphs:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # keep the shutdown signal
                break
            if total + len(item[0]) > self.max_graphs:
                self._queue.put(item)  # does not fit: next micro-batch
                break
            batch.append(item)
            total += len(item[0])
        return batch

    def _rows_per_request(self, batch):
        focus = self.predictor.focus
        counts = []
        for graphs, _ in batch:
            if focus == "g":
                counts.append(sum(g.targets.shape[0] for g in graphs))
            else:
                counts.append(int(sum(np.logical_and(g.set_mask, g.output_mask).sum() for g in graphs)))
        return counts

    @staticmethod
    def _deliver(fut, result=None, exc=None) -> None:
        """Resolve a future unless its client cancelled it (``set_result``
        on a cancelled future raises, which would end the worker)."""
        if not fut.set_running_or_notify_cancel():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                break
            # drop requests the client already cancelled (this also claims
            # each future, so a late cancel cannot race the delivery below)
            batch = [(g, f) for g, f in batch if f.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                out = self.predictor([g for graphs, _ in batch for g in graphs])
                self.launches += 1
                off = 0
                for (_, fut), n in zip(batch, self._rows_per_request(batch)):
                    fut.set_result(out[off: off + n])
                    off += n
            except Exception:
                # one oversized or bad request must not fail the others:
                # serve each request alone, failing only its own future
                for graphs, fut in batch:
                    try:
                        fut.set_result(self.predictor(graphs))
                        self.launches += 1
                    except Exception as exc:  # noqa: BLE001
                        fut.set_exception(exc)
        # requests queued behind the shutdown sentinel (a submit racing
        # close()) are failed, so no caller waits on them forever
        self._fail_queued()
