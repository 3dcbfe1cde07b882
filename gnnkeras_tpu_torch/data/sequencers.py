"""Host-side batchers ("sequencers") feeding padded batches to the card,
counterpart of ``gnnkeras_tpu.data.sequencers``.

- multi-graph: each batch is the disjoint-union merge of a slice of graphs,
  shuffled and re-merged every epoch;
- single-graph: one big graph whose supervised nodes are mini-batched
  through set masks; its topology is built once and only the masks change.

Every batch is padded to sequencer-wide sizes that only grow across epochs,
and its data-dependent operator structure is made uniform across batches
(``_uniform_block_counts``, ``_uniform_strip``), latched across epoch
rebuilds, exactly as the JAX package does it: the same NumPy shuffles give
the same batches, field for field.  Batches are built on ``device``
(default ``"cuda"``; raises when no card is present), or on the CPU in
pinned memory (``device="cpu", pin_memory=True``) for
``data.prefetch.PrefetchSequencer`` to copy to the card.  After a shuffle
the next epoch's batches are built in a background thread, which
``__getitem__`` and ``wait_for_rebuild`` join (re-raising its exception);
``trainer.fit`` joins it before it returns, so none outlives a fit.
Composite variants only change the graph class.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from gnnkeras_tpu_torch.graph.batch import GraphBatch, from_graph_object
from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject
from gnnkeras_tpu_torch.utils.dtypes import resolve_device

_PROBLEM = {"a": "edge", "n": "node", "g": "graph"}


def _round_up(x: int, m: int) -> int:
    # at least one multiple: a sequencer's pads are never zero
    return max(((x + m - 1) // m) * m, m)


def _pinned_device(device, pin_memory: bool):
    if pin_memory and torch.device(device).type != "cpu":
        raise ValueError("pin_memory=True builds the batches on the CPU: pass device='cpu'")
    return resolve_device(device)


def _pin(batch: GraphBatch) -> GraphBatch:
    return pytree.tree_map(lambda t: t.pin_memory(), batch)


def _n_blocks(op) -> int:
    # IncidencePairs counts pairs; the block operators count blocks
    return op.n_pairs if hasattr(op, "n_pairs") else int(op.blocks.shape[0])


class MultiGraphSequencer:
    """Batches a list of GraphObjects by merging each slice into one
    disjoint-union graph."""

    graph_class = GraphObject

    def __init__(
        self,
        graphs: Sequence[GraphObject],
        focus: str,
        aggregation_mode: str,
        batch_size: int = 32,
        shuffle: bool = True,
        *,
        pad_multiple: int = 128,
        agg_dtype: str = None,
        shuffle_mode: str = "graphs",
        tile_pack: Optional[bool] = None,
        slot_pack: Optional[int] = None,
        strip_dtype: str = "int8",
        device="cuda",
        pin_memory: bool = False,
    ):
        """``shuffle_mode='graphs'`` re-shuffles the graphs into new merged
        batches every epoch (the reference's behaviour); ``'batches'``
        shuffles the order of the built batches only (no rebuild).

        ``tile_pack`` (default on) places whole graphs into 128-node tiles;
        ``slot_pack=128`` also builds each batch's strip operator in
        ``strip_dtype`` (int8 mask+scale, bf16 where the weights do not
        factor), which routes training through the strip kernels.  Slot
        widths below 128 give batch-dependent layouts: build those with
        ``graph.batch.from_graph_object``.  ``pin_memory`` (with
        ``device="cpu"``) builds every batch in pinned host memory."""
        if shuffle_mode not in ("graphs", "batches"):
            raise ValueError(f"shuffle_mode {shuffle_mode!r} must be 'graphs' or 'batches'")
        if slot_pack is not None and slot_pack != 128:
            raise ValueError("sequencers support slot_pack=128 (a uniform per-batch layout); "
                             "use from_graph_object for 32/64-slot mixed formats")
        self.device = _pinned_device(device, pin_memory)
        self.pin_memory = bool(pin_memory)
        self.tile_pack = True if (tile_pack is None or slot_pack is not None) else bool(tile_pack)
        self.slot_pack = slot_pack
        self.strip_dtype = strip_dtype
        self.data: List[GraphObject] = list(graphs) if isinstance(graphs, (list, tuple)) else [graphs]
        self.focus = focus
        self.aggregation_mode = aggregation_mode
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.pad_multiple = int(pad_multiple)
        self.agg_dtype = agg_dtype
        self.shuffle_mode = shuffle_mode
        self._pad_nodes = self._pad_arcs = self._pad_graphs = 0
        self._compact_gmax = self._compact_nspan = 0
        self._pad_blocks = self._pad_ng_blocks = self._pad_inc_pairs = self._pad_strip_res = 0
        self._bcsr_degraded = set()
        self._strip_scale_degraded = False
        self._pending_build = None
        self._pending_exc = None
        self.build_batches()

    # -- batching -------------------------------------------------------------
    def build_batches(self) -> None:
        from gnnkeras_tpu_torch.graph.packing import (graph_slots_from_starts, pack_slots, packed_graph_slots,
                                                      packed_node_positions)

        merged = [
            self.graph_class.merge(self.data[i * self.batch_size:(i + 1) * self.batch_size], focus=self.focus,
                                   aggregation_mode=self.aggregation_mode)
            for i in range(len(self))
        ]
        # the compact readout needs 128-aligned node pads; otherwise the
        # uniform graph pad keeps the batch shapes fixed
        compact = self.tile_pack and self.focus == "g" and self.pad_multiple % 128 == 0
        if self.tile_pack:
            slot = self.slot_pack
            sizes = [np.bincount(g.graph_of_node.astype(np.int64), minlength=g.num_graphs) for g in merged]
            if slot is not None:
                # the pad must cover the slot-packed layout's rows
                needed = max(pack_slots(s, slot=slot, tile=128)[1] for s in sizes)
            else:
                needed = max(packed_node_positions(g.graph_of_node)[1] for g in merged)
            if compact:
                # uniform compact-readout slot width and span-slot count
                g_max, n_span = 0, 1
                for s in sizes:
                    if slot is not None:
                        slots = graph_slots_from_starts(pack_slots(s, slot=slot, tile=128)[0], s, 128)
                    else:
                        slots = packed_graph_slots(s)
                    g_max = max(g_max, slots[3])
                    n_span = max(n_span, int(np.sum(slots[4])) + 1)
                self._compact_gmax = max(self._compact_gmax, g_max)
                self._compact_nspan = max(self._compact_nspan, n_span)
        else:
            needed = max(g.nodes.shape[0] for g in merged)
        self._pad_nodes = max(self._pad_nodes, _round_up(needed, self.pad_multiple))
        self._pad_arcs = max(self._pad_arcs, _round_up(max(g.arcs.shape[0] for g in merged), self.pad_multiple))
        self._pad_graphs = max(self._pad_graphs, _round_up(max(g.num_graphs for g in merged), 8))
        self.batches: List[GraphBatch] = [
            from_graph_object(
                g, self._pad_nodes, self._pad_arcs, None if compact else self._pad_graphs,
                agg_dtype=self.agg_dtype, tile_pack=self.tile_pack, slot_pack=self.slot_pack,
                strip_dtype=self.strip_dtype, compact_gmax=self._compact_gmax if compact else None,
                compact_nspan=self._compact_nspan if compact else None, device=self.device,
            )
            for g in merged
        ]
        self._uniform_block_counts()
        if self.slot_pack is not None:
            self._uniform_strip()
        if self.pin_memory:
            self.batches = [_pin(b) for b in self.batches]

    def _uniform_block_counts(self) -> None:
        """Pad the data-dependent block and pair counts to a sequencer-wide
        maximum that only grows, so every batch has one structure.  A batch
        whose operator declined degrades every batch to the edge-list path,
        latched across epoch rebuilds.  Banded and quantised operators are
        shaped per merge: they are rebuilt as float blocks (with a warning)
        and ``agg_dtype`` is latched off."""
        from gnnkeras_tpu_torch.ops.banded import BandedOperator
        from gnnkeras_tpu_torch.ops.bcsr import QuantBcsr, build_bcsr, pad_bcsr
        from gnnkeras_tpu_torch.ops.incidence import pad_incidence_pairs

        def rebuild_float(b):
            # the edge lists live on the batch's device: read them back
            m = build_bcsr(b.arc_src.cpu().numpy(), b.arc_dst.cpu().numpy(), b.arcnode_weight.cpu().numpy(),
                           b.num_nodes, max_band_factor=10**9, device=b.device)
            return b.replace(bcsr=m)

        degraded = self._bcsr_degraded
        for name, attr in (("bcsr", "_pad_blocks"), ("nodegraph_bcsr", "_pad_ng_blocks"),
                           ("arc_inc", "_pad_inc_pairs")):
            ops = [getattr(b, name) for b in self.batches]
            if name in degraded or any(op is None for op in ops):
                degraded.add(name)
                if any(op is not None for op in ops):
                    self.batches = [b.replace(**{name: None}) for b in self.batches]
                continue
            if name == "bcsr" and any(isinstance(op, (BandedOperator, QuantBcsr)) for op in ops):
                if self.agg_dtype is not None:
                    warnings.warn(
                        f"quantized aggregation operators (agg_dtype={self.agg_dtype!r}) are per-merge shaped and "
                        "not usable across a multi-graph sequencer's batches; rebuilding float block operators "
                        "(use slot_pack strips for the quantized multi-graph engine)",
                        RuntimeWarning, stacklevel=2,
                    )
                    self.agg_dtype = None
                self.batches = [rebuild_float(b) if isinstance(b.bcsr, (BandedOperator, QuantBcsr)) else b
                                for b in self.batches]
                ops = [b.bcsr for b in self.batches]
                if any(op is None for op in ops):
                    degraded.add(name)
                    self.batches = [b.replace(bcsr=None) for b in self.batches]
                    continue
            need = max(max(_n_blocks(op) for op in ops), getattr(self, attr))
            setattr(self, attr, need)
            if all(_n_blocks(op) == need for op in ops):
                continue
            pad = pad_incidence_pairs if name == "arc_inc" else pad_bcsr
            self.batches = [b.replace(**{name: pad(getattr(b, name), need)}) for b in self.batches]

    def _uniform_strip(self) -> None:
        """One strip structure across batches: int8 storage degrades to bf16
        for every batch once any merge did not factor (latched), and the
        cross-tile residual is padded to the block maximum that only grows
        (an absent residual becomes the all-zero operator)."""
        import dataclasses

        from gnnkeras_tpu_torch.ops.bcsr import empty_bcsr, pad_bcsr
        from gnnkeras_tpu_torch.ops.strip import strip_to_dense

        ops = [b.strip for b in self.batches]
        if any(op is None for op in ops):
            if any(op is not None for op in ops):
                raise ValueError("mixed strip presence across batches")
            return
        if any(op.scale is None for op in ops):
            self._strip_scale_degraded = True
        if self._strip_scale_degraded:
            self.batches = [b if b.strip.scale is None else b.replace(strip=strip_to_dense(b.strip))
                            for b in self.batches]

        need = max([int(b.strip.residual.blocks.shape[0]) for b in self.batches if b.strip.residual is not None],
                   default=0)
        self._pad_strip_res = need = max(need, self._pad_strip_res)
        if need == 0:
            return  # no batch has ever had cross-tile arcs
        n_tiles = self._pad_nodes // 128
        new = []
        for b in self.batches:
            res = b.strip.residual
            padded = empty_bcsr(n_tiles, n_tiles, need, device=b.device) if res is None else pad_bcsr(res, need)
            new.append(b if padded is res else b.replace(strip=dataclasses.replace(b.strip, residual=padded)))
        self.batches = new

    def __len__(self) -> int:
        return int(np.ceil(len(self.data) / self.batch_size))

    def wait_for_rebuild(self) -> None:
        """Join the epoch's background rebuild, if one runs; its exception
        is re-raised here."""
        if self._pending_build is not None:
            self._pending_build.join()
            self._pending_build = None
            exc, self._pending_exc = self._pending_exc, None
            if exc is not None:
                raise RuntimeError("background batch rebuild failed") from exc

    def _spawn_build(self) -> None:
        """``build_batches`` in a background thread; an exception is kept
        and re-raised at the join instead of serving the previous epoch's
        batches."""
        self._pending_exc = None

        def run():
            try:
                self.build_batches()
            except BaseException as exc:  # noqa: BLE001 -- re-raised at the join
                self._pending_exc = exc

        self._pending_build = threading.Thread(target=run, daemon=True)
        self._pending_build.start()

    def __getitem__(self, index: int) -> GraphBatch:
        self.wait_for_rebuild()
        return self.batches[index]

    def on_epoch_end(self) -> None:
        """Shuffle, then rebuild the batches in a background thread."""
        if not self.shuffle:
            return
        self.wait_for_rebuild()  # never two rebuilds over the shared pads
        if self.shuffle_mode == "batches":
            order = np.random.permutation(len(self.batches))
            self.batches = [self.batches[i] for i in order]
            return
        np.random.shuffle(self.data)
        self._spawn_build()

    # -- config / copy ---------------------------------------------------------
    def set_batch_size(self, new_batch_size: int) -> None:
        self.wait_for_rebuild()
        self.batch_size = int(new_batch_size)
        self.build_batches()

    def get_config(self) -> dict:
        return {
            "graphs": self.data, "focus": self.focus, "aggregation_mode": self.aggregation_mode,
            "batch_size": self.batch_size, "shuffle": self.shuffle, "pad_multiple": self.pad_multiple,
            "agg_dtype": self.agg_dtype, "shuffle_mode": self.shuffle_mode, "tile_pack": self.tile_pack,
            "slot_pack": self.slot_pack, "strip_dtype": self.strip_dtype, "device": self.device,
            "pin_memory": self.pin_memory,
        }

    @classmethod
    def from_config(cls, config: dict):
        return cls(**config)

    def copy(self):
        config = self.get_config()
        config["graphs"] = [g.copy() for g in config["graphs"]]
        return self.from_config(config)

    def with_graphs(self, graphs: Sequence[GraphObject]):
        """The same settings over a new graph list (serial LGNN training
        re-bakes the features between layers)."""
        config = self.get_config()
        config["graphs"] = list(graphs)
        return self.from_config(config)

    def __repr__(self):
        return (
            f"graph_sequencer(type=multiple {_PROBLEM[self.focus]}-focused, len={len(self)}, "
            f"aggregation='{self.aggregation_mode}', batch_size={self.batch_size}, shuffle={self.shuffle})"
        )

    __str__ = __repr__


class SingleGraphSequencer(MultiGraphSequencer):
    """Mini-batches one big graph through set masks over its supervised
    nodes.  The topology (and its operators) is built once, on ``device``;
    each batch is that base batch with its own ``set_mask`` and
    ``target_mask``."""

    # every batch shares the one graph's topology: a scanned epoch's static
    # copies would duplicate the whole padded graph (and its operators) per
    # batch on the card, so the trainer steps a batch at a time
    scan_stack_ok = False

    def __init__(
        self,
        graph: GraphObject,
        focus: str,
        batch_size: int = 32,
        shuffle: bool = True,
        *,
        pad_multiple: int = 128,
        agg_dtype: str = None,
        device="cuda",
        pin_memory: bool = False,
    ):
        self.device = _pinned_device(device, pin_memory)
        self.pin_memory = bool(pin_memory)
        self.graph = graph
        self.focus = focus
        self.aggregation_mode = graph.aggregation_mode
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.pad_multiple = int(pad_multiple)
        self.agg_dtype = agg_dtype
        self.set_mask_idx = np.flatnonzero(graph.set_mask)
        self._pad_nodes = _round_up(graph.nodes.shape[0], pad_multiple)
        self._pad_arcs = _round_up(graph.arcs.shape[0], pad_multiple)
        self._base_batch = None
        self._pending_build = None
        self._pending_exc = None
        self.build_batches()

    @property
    def data(self):
        return self.graph

    def build_batches(self) -> None:
        n_batches = len(self)
        self.batch_masks = np.zeros((n_batches, len(self.graph.set_mask)), dtype=bool)
        for i in range(n_batches):
            self.batch_masks[i, self.set_mask_idx[i * self.batch_size:(i + 1) * self.batch_size]] = True
        base = self._base_batch
        if base is None:
            self._base_batch = base = from_graph_object(
                self.graph, self._pad_nodes, self._pad_arcs,
                set_mask_override=self.batch_masks[0] if n_batches else None, agg_dtype=self.agg_dtype,
                device=self.device,
            )
            if self.pin_memory:
                self._base_batch = base = _pin(base)
        m_rows = base.set_mask.shape[0]
        out_idx = np.flatnonzero(self.graph.output_mask)
        self.batches = []
        for bm in self.batch_masks:
            sm = np.zeros(m_rows, dtype=bool)
            sm[:len(bm)] = bm
            tm = np.zeros(base.target_mask.shape[0], dtype=bool)
            tm[out_idx] = bm[out_idx]
            # no packing here: the supervised rows in the caller's order are
            # the target mask's rows in ascending order
            masks = [torch.from_numpy(m).to(base.device) for m in (sm, tm)]
            if self.pin_memory:
                masks = [m.pin_memory() for m in masks]
            self.batches.append(base.replace(set_mask=masks[0], target_mask=masks[1],
                                             host_pred_rows=np.flatnonzero(tm)))

    def __len__(self) -> int:
        return int(np.ceil(np.sum(self.graph.set_mask) / self.batch_size))

    def on_epoch_end(self) -> None:
        if self.shuffle:
            self.wait_for_rebuild()
            np.random.shuffle(self.set_mask_idx)
            self._spawn_build()

    def get_config(self) -> dict:
        return {"graph": self.graph, "focus": self.focus, "batch_size": self.batch_size, "shuffle": self.shuffle,
                "pad_multiple": self.pad_multiple, "agg_dtype": self.agg_dtype, "device": self.device,
                "pin_memory": self.pin_memory}

    def copy(self):
        config = self.get_config()
        config["graph"] = config["graph"].copy()
        return self.from_config(config)

    def with_graphs(self, graphs):
        config = self.get_config()
        config["graph"] = graphs[0] if isinstance(graphs, (list, tuple)) else graphs
        return self.from_config(config)

    def __repr__(self):
        return (
            f"graph_sequencer(type=single {_PROBLEM[self.focus]}-focused, len={len(self)}, "
            f"batch_size={self.batch_size}, shuffle={self.shuffle})"
        )

    __str__ = __repr__


class CompositeMultiGraphSequencer(MultiGraphSequencer):
    """Multi-graph sequencer over heterogeneous graphs."""

    graph_class = CompositeGraphObject

    def __repr__(self):
        return f"composite_{super().__repr__()}"

    __str__ = __repr__


class CompositeSingleGraphSequencer(SingleGraphSequencer):
    """Single heterogeneous graph sequencer."""

    graph_class = CompositeGraphObject

    def __repr__(self):
        return f"composite_{super().__repr__()}"

    __str__ = __repr__
