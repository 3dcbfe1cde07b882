"""Molecule-granular ('packed') partitioning of merged graph-focused batches,
the counterpart of ``gnnkeras_tpu.parallel.packed``.

A merged molecule batch is a disjoint union: no arc joins two member graphs.
Split at graph granularity it has no halo: each rank holds whole molecules
and runs the unmodified single-device engine (slot packing, the strip
kernel, the transposed unfold, the compact readout) on its own batch.  The
ranks exchange only sums: BatchNorm's masked moments (the models'
``group``), the convergence flag (maximised over the group, so every rank
runs the trip count of the merged batch) and the loss and metric sums.  So
training here is single-device training on the merged batch, up to the f32
order of the sums.

``partition_packed`` balances the graphs over the parts (``balance_graphs``,
largest first to the least loaded part), cuts each part out of the merged
graph (``split_merged_by_graph``) and builds every part's batch with the
JAX package's uniform caps: one node pad (the largest part's tiles), one
arc pad, one compact-readout ``g_max`` and spanning-graph count, so every
rank runs one padded shape.  With ``strip_dtype='int8'`` a part whose
weights do not factor as mask × scale stores its strips densely (bf16); the
parts that do factor are then downgraded to dense storage too, as the JAX
package keeps one structure for its stacked batch.

``PackedPartitionedGNN`` wraps a single GNN (homogeneous or composite, any
focus the batch was built for); ``PackedPartitionedLGNN`` an LGNN stack in
``parallel`` or ``residual`` mode.  Each rank's dropout masks and initial
states come from a generator of its own, the model's stream's seed folded
with the rank (``mesh.rank_generator``), as the JAX package folds in the device
index.  The training step: the gradient of the psummed loss (the
collectives' backward sums the ranks' cotangents, so each rank holds D
times its share, as ``jax.grad`` inside ``shard_map`` gives it), the mean of
the gradients over the group, ``average_st_grads`` scaling and the
optimizer step, the same on every rank.  ``fit`` runs the single-device fit
surface through ``training/fit_loop.run_fit_loop`` as ``PartitionedGNN.fit``
does: the step goes through gloo in host memory, so epochs run eagerly.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.parallel.mesh import axis_group, rank_generator


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def balance_graphs(sizes: np.ndarray, n_parts: int) -> List[np.ndarray]:
    """Greedy LPT: graphs (largest first) each to the least loaded part.
    Returns each part's graph ids in ascending order."""
    sizes = np.asarray(sizes, dtype=np.int64)
    order = np.argsort(-sizes, kind="stable")
    loads = np.zeros(n_parts, dtype=np.int64)
    groups: List[list] = [[] for _ in range(n_parts)]
    for g in order:
        p = int(np.argmin(loads))
        groups[p].append(int(g))
        loads[p] += sizes[g]
    return [np.array(sorted(grp), dtype=np.int64) for grp in groups]


def split_merged_by_graph(g: GraphObject, graph_ids: np.ndarray) -> GraphObject:
    """The graph holding exactly ``graph_ids``'s molecules (nodes, arcs,
    per-graph targets), graph ids relabelled 0..len(ids)-1, nodes in their
    relative order.  Arc weights are functions of a graph's own structure,
    so they are those of the merged graph.  A composite graph stays
    composite (its type-mask rows travel with their nodes)."""
    if g.focus != "g":
        raise ValueError("split_merged_by_graph is for merged graph-focused batches")
    graph_ids = np.asarray(graph_ids, dtype=np.int64)
    gid_new = np.full(int(g.graph_of_node.max()) + 1, -1, dtype=np.int64)
    gid_new[graph_ids] = np.arange(len(graph_ids))
    node_sel = gid_new[g.graph_of_node] >= 0
    node_new = np.cumsum(node_sel) - 1

    src = g.arcs[:, 0].astype(np.int64)
    arc_sel = node_sel[src]  # a disjoint union: the source kept <=> the destination kept
    arcs = g.arcs[arc_sel].copy()
    arcs[:, 0] = node_new[arcs[:, 0].astype(np.int64)]
    arcs[:, 1] = node_new[arcs[:, 1].astype(np.int64)]
    kwargs = dict(nodes=g.nodes[node_sel], arcs=arcs, targets=g.targets[graph_ids], focus="g",
                  set_mask=g.set_mask[node_sel], output_mask=g.output_mask[node_sel],
                  sample_weight=g.sample_weight[graph_ids],
                  NodeGraph=(gid_new[g.graph_of_node[node_sel]], g.nodegraph_weight[node_sel]),
                  aggregation_mode=g.aggregation_mode)
    if isinstance(g, CompositeGraphObject):
        return CompositeGraphObject(type_mask=g.type_mask[node_sel],
                                    dim_node_label=tuple(int(d) for d in g.DIM_NODE_LABEL), **kwargs)
    return GraphObject(**kwargs)


@dataclasses.dataclass(frozen=True)
class PackedPartitionMeta:
    """Host bookkeeping that maps the ranks' outputs back to the caller's
    graph order: part p's output row ``pred_rows[p][j]`` is graph
    ``groups[p][j]``."""

    groups: List[np.ndarray]
    pred_rows: List[np.ndarray]
    n_graphs: int

    def merge_outputs(self, outs) -> np.ndarray:
        """The parts' graph outputs (one (R, T) array a part) in the merged
        graph's order."""
        first = np.asarray(outs[0])
        merged = np.zeros((self.n_graphs,) + first.shape[1:], first.dtype)
        for ids, rows, out in zip(self.groups, self.pred_rows, outs):
            merged[ids] = np.asarray(out)[rows]
        return merged


def partition_packed(g: GraphObject, n_parts: int, slot_pack: int = 128, strip_dtype: str = "int8",
                     device="cuda") -> Tuple[list, PackedPartitionMeta]:
    """Split a merged graph-focused graph into ``n_parts`` balanced groups of
    whole graphs and build each part's single-device batch (slot packing,
    strip operator, compact readout) on ``device`` (``"cpu"`` for batches
    to hand to the ranks' processes), all of one padded shape (module
    docstring).
    Returns (the parts' batches in rank order, the meta)."""
    from gnnkeras_tpu_torch.graph.batch import from_graph_object
    from gnnkeras_tpu_torch.graph.packing import graph_slots_from_starts, pack_slots

    if g.focus != "g":
        raise ValueError("partition_packed is for merged graph-focused batches")
    n_graphs = max(g.num_graphs, 1)
    if n_graphs < n_parts:
        raise ValueError(f"{n_graphs} graphs cannot fill {n_parts} parts")
    sizes = np.bincount(g.graph_of_node.astype(np.int64), minlength=n_graphs)
    groups = balance_graphs(sizes, n_parts)
    subs = [split_merged_by_graph(g, ids) for ids in groups]

    tiles, arcs, gmaxes = [], [], []
    for sub in subs:
        s_sizes = np.bincount(sub.graph_of_node.astype(np.int64), minlength=sub.num_graphs)
        starts, rows = pack_slots(s_sizes, slot=slot_pack, tile=128)
        tiles.append(_round_up(max(rows, 128), 128) // 128)
        arcs.append(sub.arcs.shape[0])
        _, _, _, g_max, spanning = graph_slots_from_starts(starts, s_sizes, 128)
        gmaxes.append((g_max, int(np.sum(spanning)) if spanning is not None else 0))
    t_uniform = max(tiles)
    a_uniform = _round_up(max(arcs), 8)
    gmax_uniform = max(gm for gm, _ in gmaxes)
    nspan_uniform = max(sp for _, sp in gmaxes) + 1

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        batches = [from_graph_object(sub, pad_nodes=t_uniform * 128, pad_arcs=a_uniform, slot_pack=slot_pack,
                                     strip_dtype=strip_dtype, compact_gmax=gmax_uniform,
                                     compact_nspan=nspan_uniform, device=device)
                   for sub in subs]
    for w in {str(w.message): w for w in caught}.values():  # one warning a cause, not one a part
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    for b in batches:
        if b.strip is None or b.compact_readout is None:
            raise ValueError("packed partition requires the strip + compact-readout path")
    r0 = batches[0].strip.residual
    if any((b.strip.residual is None) != (r0 is None) for b in batches):
        raise ValueError("inconsistent cross-tile residual structure across parts: use partition_graph "
                         "(range sharding) for this workload")
    if any(b.strip.scale is None for b in batches) and any(b.strip.scale is not None for b in batches):
        from gnnkeras_tpu_torch.ops.strip import strip_to_dense

        batches = [b if b.strip.scale is None else b.replace(strip=strip_to_dense(b.strip)) for b in batches]
    meta = PackedPartitionMeta(groups=groups, pred_rows=[np.asarray(b.host_pred_rows) for b in batches],
                               n_graphs=n_graphs)
    return batches, meta


class PackedPartitionedGNN:
    """A single GNN (node, arc or graph focus; homogeneous or composite) over
    ``partition_packed`` batches, one a rank of the ``axis`` group of
    ``mesh`` (default: the world).  The model must be built from one seed on
    every rank (or load one state dict)."""

    def __init__(self, gnn, mesh=None, axis: str = "graph"):
        if hasattr(gnn, "gnns"):
            raise ValueError("PackedPartitionedGNN wraps single GNN models: use PackedPartitionedLGNN for layered "
                             "stacks")
        self._setup(gnn, mesh, axis)

    def _setup(self, gnn, mesh, axis: str) -> None:
        self.gnn, self.group = gnn, axis_group(mesh, axis)
        self.n_devices = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    # -- rank-local compute ------------------------------------------------------
    def _local_forward(self, batch, training: bool, generator):
        return self.gnn.forward(batch, training=training, generator=generator, group=self.group)

    def _masked_loss(self, batch, out, count):
        from gnnkeras_tpu_torch.parallel.collectives import psum

        per_row = self.gnn.loss(batch.targets, out)
        m = batch.target_mask.to(per_row.dtype)
        return psum(torch.sum(per_row * batch.sample_weight * m), self.group) / torch.clamp_min(count, 1.0)

    def _data_loss(self, outs, batch, count, training: bool):
        return self._masked_loss(batch, outs, count)

    def _local_loss(self, batch, generator, training: bool = True):
        """(loss, k, the output scored by the metrics, new moving
        statistics): the psummed masked loss over the union batch plus the
        regularisation loss, equal on every rank."""
        from gnnkeras_tpu_torch.parallel.collectives import psum

        k, _, outs, _, new_bn = self._local_forward(batch, training, generator)
        count = psum(torch.sum(batch.target_mask.to(torch.float32)), self.group)
        loss = self._data_loss(outs, batch, count, training) + self.gnn.regularization_loss()
        return loss, k, self.gnn.served_output(outs), new_bn

    def _metric_sums(self, batch, out) -> dict:
        """Each metric's (sum, count) summed over the group."""
        from gnnkeras_tpu_torch.parallel.collectives import psum
        from gnnkeras_tpu_torch.training.metrics import get_metric

        sums = {}
        for spec in self.gnn.metrics:
            name, fn = get_metric(spec)
            sums[name] = psum(torch.stack(fn(batch.targets, out, batch.target_mask, batch.sample_weight)),
                              self.group)
        return sums

    # -- entry points ----------------------------------------------------------
    def forward(self, batch, training: bool = False, generator: Optional[torch.Generator] = None):
        """(k, state, out, out_mask, new moving statistics) of this rank's
        batch, without gradients: the model's ``forward`` with the group."""
        self.gnn.build()
        if generator is None:
            generator = rank_generator(self.gnn, self.rank)
        with torch.no_grad():
            return self._local_forward(batch, training, generator)

    def train_step(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step on every rank (module docstring).  Returns
        {"loss", "k", and each metric's "_sum" / "_count"} as 0-dim device
        tensors, equal on every rank."""
        from gnnkeras_tpu_torch.parallel.collectives import pmean_grads
        from gnnkeras_tpu_torch.training.trainer import _load_bn_state, _optimizer

        gnn = self.gnn
        if gnn.optimizer is None or gnn.loss is None:
            raise RuntimeError("call gnn.compile() before training the packed model")
        if generator is None:
            generator = rank_generator(self.gnn, self.rank)
        opt = _optimizer(gnn)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, k, out, new_bn = self._local_loss(batch, generator, training=True)
            loss.backward()
        pmean_grads(gnn.parameters(), self.group)
        if gnn.average_st_grads:
            gnn.scale_state_grads(k)
        opt.step()
        _load_bn_state(gnn, new_bn)
        logs = {"loss": loss.detach(), "k": torch.mean(torch.stack([torch.as_tensor(x, dtype=torch.float32)
                                                                    for x in (k if isinstance(k, list) else [k])]))}
        with torch.no_grad():
            for name, sc in self._metric_sums(batch, out.detach()).items():
                logs[f"{name}_sum"], logs[f"{name}_count"] = sc[0], sc[1]
        return logs

    def evaluate(self, batch, verbose: int = 0) -> dict:
        """Loss and metrics over the union batch (inference mode), equal on
        every rank; an LGNN scores its last layer."""
        from gnnkeras_tpu_torch.parallel.collectives import psum

        gnn = self.gnn
        if gnn.loss is None:
            raise RuntimeError("call compile() before evaluate()")
        _, _, outs, _, _ = self.forward(batch, training=False)
        out = gnn.served_output(outs)
        with torch.no_grad():
            per = gnn.loss(batch.targets, out)
            m = batch.target_mask.to(per.dtype)
            total = psum(torch.stack([torch.sum(per * batch.sample_weight * m), torch.sum(m)]), self.group)
            logs = {"loss": float(total[0]) / max(float(total[1]), 1.0) + float(gnn.regularization_loss())}
            for name, (s, c) in self._metric_sums(batch, out).items():
                logs[name] = float(s) / max(float(c), 1.0)
        if verbose and self.rank == 0:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
        return logs

    @staticmethod
    def _epoch_logs(step: dict) -> dict:
        logs = {"loss": float(step["loss"]), "k": float(step["k"])}
        for key in step:
            if key.endswith("_sum"):
                name = key[:-4]
                logs[name] = float(step[key]) / max(float(step.get(f"{name}_count", 1.0)), 1e-9)
        return logs

    def fit(self, batch, epochs: int = 1, steps_per_launch: int = 1, verbose: int = 0, *, validation_data=None,
            callbacks: Optional[list] = None, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False, class_weight: Optional[dict] = None, validation_freq: int = 1, seed: int = 0):
        """Full-batch training of the packed partition, one step an epoch,
        with the single-device fit surface: validation (this engine's
        ``evaluate`` of a packed batch, or the single-device ``evaluate`` of
        a sequencer on the synchronised weights), callbacks, checkpoints
        (rank 0 writes, a barrier follows, every rank restores and takes
        rank 0's weights) and ``class_weight``.  ``steps_per_launch`` epochs
        run between two reads of the logs.  Returns a ``History``; rank 0
        prints with ``verbose``."""
        from gnnkeras_tpu_torch.parallel.collectives import agree_logs, rank0_fit_hooks
        from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop
        from gnnkeras_tpu_torch.training.trainer import _apply_class_weight, _class_weight_vector
        from gnnkeras_tpu_torch.training.trainer import evaluate as seq_evaluate

        gnn = self.gnn
        if gnn.loss is None or gnn.optimizer is None:
            raise RuntimeError("call gnn.compile() before fit()")
        gnn.build(seed=seed)
        if class_weight:
            batch = _apply_class_weight(batch, _class_weight_vector(class_weight, batch.targets.device))

        def run_chunk(epoch, n):
            steps = [self.train_step(batch) for _ in range(n)]
            return [agree_logs(self._epoch_logs(s), self.group) for s in steps]

        validate = None
        if validation_data is not None:
            from gnnkeras_tpu_torch.graph.batch import GraphBatch

            if isinstance(validation_data, GraphBatch):
                score = lambda: self.evaluate(validation_data)
            else:
                score = lambda: seq_evaluate(gnn, validation_data, verbose=0)
            validate = lambda: agree_logs({f"val_{k}": v for k, v in score().items()}, self.group)

        return run_fit_loop(
            gnn, epochs=epochs, run_chunk=run_chunk, chunk_size=steps_per_launch, validate=validate,
            callbacks=callbacks, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            validation_freq=validation_freq, **rank0_fit_hooks(gnn, self.group, verbose),
        )


class PackedPartitionedLGNN(PackedPartitionedGNN):
    """An LGNN / CompositeLGNN stack over ``partition_packed`` batches.  Each
    rank runs the unmodified layered forward on its whole molecules (the
    feature propagation between layers is node-local), every layer's
    moments and flag spanning the group.  ``parallel`` trains on the mean of
    the per-layer masked losses, ``residual`` on the loss of the layers'
    mean output, each masked mean formed from summed sums; ``serial`` is the
    per-layer outer loop (``training/serial.py``), not one program, and
    raises.  Evaluation scores the last layer."""

    def __init__(self, lgnn, mesh=None, axis: str = "graph"):
        if not hasattr(lgnn, "gnns"):
            raise ValueError("PackedPartitionedLGNN wraps LGNN stacks: use PackedPartitionedGNN for single models")
        self._setup(lgnn, mesh, axis)

    def _check_mode(self) -> str:
        mode = self.gnn.training_mode or "parallel"
        if mode == "serial":
            raise ValueError("serial training is the reference's outer per-layer loop (LGNN.py:290-359), not one "
                             "sharded program: run fit_serial and wrap each layer's fit in its own packed engine")
        return mode

    def _data_loss(self, outs, batch, count, training: bool):
        mode = self._check_mode()
        if training and mode == "parallel":
            return sum(self._masked_loss(batch, out, count) for out in outs) / len(outs)
        if training and mode == "residual":
            return self._masked_loss(batch, sum(outs) / len(outs), count)
        return self._masked_loss(batch, outs[-1], count)
