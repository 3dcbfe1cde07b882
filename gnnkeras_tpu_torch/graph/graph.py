"""Host-side graph data model (NumPy), the port's copy of
``gnnkeras_tpu.graph.graph``: ``GraphObject``, the per-arc aggregation
weights and the disjoint-union ``merge``.

Operators travel as index + per-arc weight arrays (ArcNode/Adjacency) and
``(graph_of_node, nodegraph_weight)`` (NodeGraph); nothing sparse is
materialised on the way to the card.  ``CompositeGraphObject`` adds a
node-type mask and per-type label widths; its per-type adjacencies are
never materialised there (the composite models gate the shared arc weights
by the source node's type).  The ``*_coo`` accessors build the scipy
matrices for interop (scipy is imported inside them only).

Persistence writes and reads the reference's formats, key for key, as the
JAX package does: one ``.npz`` a graph (``save`` / ``load``), a folder of
``.txt`` files a graph (``savetxt`` / ``load_txt``), and folders of either
a dataset (``save_dataset(_txt)`` / ``load_dataset(_txt)``), so a file
saved by either package loads in the other.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import numpy as np

from gnnkeras_tpu_torch.utils.dtypes import floatx

_HOMOGENEOUS_MODES = ("sum", "normalized", "average")
_COMPOSITE_MODES = _HOMOGENEOUS_MODES + ("composite_average",)


def arcnode_weights(arcs: np.ndarray, aggregation_mode: str, type_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-arc aggregation weights (the data vector of ArcNode/Adjacency):
    'sum' → 1, 'normalized' → 1/num_arcs, 'average' → 1/indegree(dst),
    'composite_average' → 1/(arcs into dst whose source has this arc's
    source type), which needs the (N, T) ``type_mask``."""
    n_arcs = arcs.shape[0]
    dst = arcs[:, 1].astype(np.int64)
    w = np.ones(n_arcs, dtype=np.float64)
    if aggregation_mode == "sum":
        pass
    elif aggregation_mode == "normalized":
        w *= 1.0 / n_arcs
    elif aggregation_mode == "average":
        if n_arcs:
            counts = np.bincount(dst)
            w /= counts[dst]
    elif aggregation_mode == "composite_average":
        if type_mask is None:
            raise ValueError("'composite_average' requires a type_mask")
        src = arcs[:, 0].astype(np.int64)
        for t in type_mask.T:
            sel = t[src] if n_arcs else np.zeros(0, dtype=bool)
            if not np.any(sel):
                continue
            sel_dst = dst[sel]
            counts = np.bincount(sel_dst)
            w[sel] /= counts[sel_dst]
    else:
        raise ValueError(f"Unknown aggregation mode: {aggregation_mode!r}")
    return w.astype(floatx())


class GraphObject:
    """Homogeneous graph: node labels, arcs ``[src, dst, label...]``,
    targets, set/output masks and sample weights.

    Derived: ``arcnode_weight`` (A,), and ``graph_of_node`` (N,) with
    ``nodegraph_weight`` (N,) as the row/value view of the NodeGraph readout.
    """

    def __init__(
        self,
        nodes: np.ndarray,
        arcs: np.ndarray,
        targets: np.ndarray,
        focus: str = "n",
        set_mask: Optional[np.ndarray] = None,
        output_mask: Optional[np.ndarray] = None,
        sample_weight=1,
        NodeGraph=None,
        aggregation_mode: str = "sum",
        arcs_canonical: bool = False,
    ):
        self.dtype = floatx()
        self.focus = str(focus)
        self.nodes = np.asarray(nodes).astype(self.dtype)
        # dedup + lexicographic sort of the arc rows; ``arcs_canonical`` skips
        # it when the caller guarantees unique sorted rows (merge)
        if arcs_canonical:
            self.arcs = np.array(arcs, dtype=self.dtype)
        else:
            from gnnkeras_tpu_torch import native

            self.arcs = native.canonical_arcs(np.asarray(arcs)).astype(self.dtype)
        self.targets = np.atleast_2d(np.asarray(targets)).astype(self.dtype)
        self.sample_weight = (np.asarray(sample_weight) * np.ones(self.targets.shape[0])).astype(self.dtype)

        self.DIM_NODE_LABEL = np.array(self.nodes.shape[1], ndmin=1, dtype=int)
        self.DIM_ARC_LABEL = self.arcs.shape[1] - 2
        self.DIM_TARGET = self.targets.shape[1]

        len_mask = {"n": self.nodes.shape[0], "a": self.arcs.shape[0], "g": self.nodes.shape[0]}[focus]
        self.set_mask = (
            np.ones(len_mask, dtype=bool) if set_mask is None else np.asarray(set_mask).astype(bool).reshape(-1)
        )
        self.output_mask = (
            np.ones(len(self.set_mask), dtype=bool)
            if output_mask is None
            else np.asarray(output_mask).astype(bool).reshape(-1)
        )
        if len(self.set_mask) != len(self.output_mask):
            raise ValueError("len(set_mask) != len(output_mask)")
        if len(self.set_mask) != len_mask:
            raise ValueError(
                f"set_mask length {len(self.set_mask)} != "
                f"{'arc' if focus == 'a' else 'node'} count {len_mask}"
            )

        self.aggregation_mode = str(aggregation_mode)
        self._check_mode(self.aggregation_mode)
        self.arcnode_weight = self._build_weights(self.aggregation_mode)

        if NodeGraph is not None:
            self.graph_of_node, self.nodegraph_weight = self._nodegraph_from_coo(NodeGraph)
        elif focus == "g":
            n = self.nodes.shape[0]
            self.graph_of_node = np.zeros(n, dtype=np.int64)
            self.nodegraph_weight = np.full(n, 1.0 / n, dtype=self.dtype)
        else:
            self.graph_of_node = np.zeros(self.nodes.shape[0], dtype=np.int64)
            self.nodegraph_weight = np.zeros(self.nodes.shape[0], dtype=self.dtype)

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in _HOMOGENEOUS_MODES:
            raise ValueError(f"Unknown aggregation mode: {mode!r}")

    def _build_weights(self, mode: str) -> np.ndarray:
        return arcnode_weights(self.arcs, mode)

    def _nodegraph_from_coo(self, NodeGraph):
        """A ``(graph_of_node, weight)`` array pair, or anything with
        ``.tocoo()`` / accepted by scipy's ``coo_matrix`` of shape (N, G)."""
        if (
            isinstance(NodeGraph, tuple)
            and len(NodeGraph) == 2
            and isinstance(NodeGraph[1], np.ndarray)
            and NodeGraph[1].ndim == 1
        ):
            return (
                np.asarray(NodeGraph[0], dtype=np.int64).copy(),
                np.asarray(NodeGraph[1], dtype=self.dtype).copy(),
            )
        try:
            ng = NodeGraph.tocoo()
        except AttributeError:
            from scipy.sparse import coo_matrix

            ng = coo_matrix(NodeGraph, dtype=self.dtype)
        n = self.nodes.shape[0]
        graph_of_node = np.zeros(n, dtype=np.int64)
        weight = np.zeros(n, dtype=self.dtype)
        graph_of_node[ng.row] = ng.col
        weight[ng.row] = ng.data.astype(self.dtype)
        return graph_of_node, weight

    @property
    def num_graphs(self) -> int:
        return int(self.graph_of_node.max()) + 1 if self.nodes.shape[0] else 0

    # -- scipy views of the operators ----------------------------------------------
    def ArcNode_coo(self):
        """(A, N): arc e → its destination node, valued ``arcnode_weight``."""
        from scipy.sparse import coo_matrix

        a = self.arcs.shape[0]
        col = self.arcs[:, 1].astype(np.int64)
        return coo_matrix((self.arcnode_weight, (np.arange(a), col)), shape=(a, self.nodes.shape[0]),
                          dtype=self.dtype)

    def Adjacency_coo(self):
        """(N, N): source → destination, valued ``arcnode_weight``."""
        from scipy.sparse import coo_matrix

        row = self.arcs[:, 0].astype(np.int64)
        col = self.arcs[:, 1].astype(np.int64)
        n = self.nodes.shape[0]
        return coo_matrix((self.arcnode_weight, (row, col)), shape=(n, n), dtype=self.dtype)

    def NodeGraph_coo(self):
        """(N, G): node → its graph, valued ``nodegraph_weight``; an empty
        matrix for a node or arc focus graph without a readout."""
        from scipy.sparse import coo_matrix

        if self.focus != "g" and not np.any(self.nodegraph_weight):
            return coo_matrix(np.zeros((0, 0), dtype=self.dtype))
        row = np.arange(self.nodes.shape[0])
        return coo_matrix((self.nodegraph_weight, (row, self.graph_of_node)),
                          shape=(self.nodes.shape[0], self.num_graphs), dtype=self.dtype)

    def setAggregation(self, aggregation_mode: str) -> None:
        """Recompute the arc weights for ``aggregation_mode``."""
        self._check_mode(aggregation_mode)
        self.aggregation_mode = aggregation_mode
        self.arcnode_weight = self._build_weights(aggregation_mode)

    def copy(self) -> "GraphObject":
        return GraphObject(
            nodes=self.nodes.copy(),
            arcs=self.arcs.copy(),
            targets=self.targets.copy(),
            focus=self.focus,
            set_mask=self.set_mask.copy(),
            output_mask=self.output_mask.copy(),
            sample_weight=self.sample_weight.copy(),
            NodeGraph=(self.graph_of_node.copy(), self.nodegraph_weight.copy()),
            aggregation_mode=self.aggregation_mode,
        )

    def __repr__(self):
        set_mask_type = "all" if np.all(self.set_mask) else "mixed"
        return (
            f"graph(n={self.nodes.shape[0]}, a={self.arcs.shape[0]}, "
            f"ndim={self.DIM_NODE_LABEL}, adim={self.DIM_ARC_LABEL}, tdim={self.DIM_TARGET}, "
            f"set={set_mask_type}, mode={self.aggregation_mode})"
        )

    __str__ = __repr__

    # -- persistence (the reference's formats) --------------------------------------
    def get_dict_data(self) -> dict:
        """The ``.npz`` payload: nodes, arcs, targets, and the masks, sample
        weights and NodeGraph triples ``[value, row, col]`` where they are
        not the defaults."""
        data = {"nodes": self.nodes, "arcs": self.arcs, "targets": self.targets}
        if not np.all(self.set_mask):
            data["set_mask"] = self.set_mask
        if not np.all(self.output_mask):
            data["output_mask"] = self.output_mask
        if np.any(self.sample_weight != 1):
            data["sample_weight"] = self.sample_weight
        ng = self.NodeGraph_coo()
        if ng.size > 0 and ng.shape[1] > 1:
            data["NodeGraph"] = np.stack([ng.data, ng.row, ng.col]).transpose()
        return data

    def save(self, graph_npz_path: str, **kwargs) -> None:
        self.save_graph(graph_npz_path, self, False, **kwargs)

    def save_compressed(self, graph_npz_path: str, **kwargs) -> None:
        self.save_graph(graph_npz_path, self, True, **kwargs)

    def savetxt(self, graph_folder_path: str, format: str = "%.10g", **kwargs) -> None:
        self.save_txt(graph_folder_path, self, format, **kwargs)

    @staticmethod
    def save_graph(graph_npz_path: str, g, compressed: bool = False, **kwargs) -> None:
        (np.savez_compressed if compressed else np.savez)(graph_npz_path, **g.get_dict_data(), **kwargs)

    @staticmethod
    def save_txt(graph_folder_path: str, g, fmt: str = "%.10g", **kwargs) -> None:
        """One ``<key>.txt`` a payload key in ``graph_folder_path`` (replaced
        if it exists)."""
        folder = _fresh_folder(graph_folder_path)
        for key, value in g.get_dict_data().items():
            np.savetxt(f"{folder}{key}.txt", value, fmt=fmt, **kwargs)

    @staticmethod
    def save_dataset(folder: str, glist: Sequence["GraphObject"], compressed=False, **kwargs) -> None:
        """``g{i}.npz`` for each graph of ``glist`` in ``folder`` (replaced)."""
        folder = _fresh_folder(folder)
        for idx, g in enumerate(glist):
            GraphObject.save_graph(f"{folder}g{idx}", g, compressed, **kwargs)

    @staticmethod
    def save_dataset_txt(folder: str, glist: Sequence["GraphObject"], **kwargs) -> None:
        """A ``g{i}/`` text folder for each graph of ``glist`` in ``folder``."""
        folder = _fresh_folder(folder)
        for idx, g in enumerate(glist):
            GraphObject.save_txt(f"{folder}g{idx}", g, **kwargs)

    @classmethod
    def load(cls, graph_npz_path: str, focus: str, aggregation_mode: str, **kwargs):
        if not graph_npz_path.endswith(".npz"):
            graph_npz_path += ".npz"
        data = dict(np.load(graph_npz_path, **kwargs))
        _nodegraph_from_triples(data)
        return cls(focus=focus, aggregation_mode=aggregation_mode, **data)

    @classmethod
    def load_txt(cls, graph_folder_path: str, focus: str, aggregation_mode: str, **kwargs):
        if graph_folder_path[-1] != "/":
            graph_folder_path += "/"
        files = os.listdir(graph_folder_path)
        data = {f.rsplit(".")[0]: np.loadtxt(graph_folder_path + f, ndmin=2, **kwargs) for f in files}
        _nodegraph_from_triples(data)
        for key in ("set_mask", "output_mask", "sample_weight"):
            if key in data:
                data[key] = data[key].reshape(-1)
        return cls(focus=focus, aggregation_mode=aggregation_mode, **data)

    @classmethod
    def load_dataset(cls, folder: str, focus: str, aggregation_mode: str, **kwargs):
        return [cls.load(f"{folder}/{g}", focus, aggregation_mode, **kwargs) for g in sorted(os.listdir(folder))]

    @classmethod
    def load_dataset_txt(cls, folder: str, focus: str, aggregation_mode: str, **kwargs):
        return [cls.load_txt(f"{folder}/{g}", focus, aggregation_mode, **kwargs) for g in sorted(os.listdir(folder))]

    @classmethod
    def merge(cls, glist: Sequence["GraphObject"], focus: str, aggregation_mode: str, dtype="float32"):
        """Disjoint-union merge with arc index offsetting; NodeGraph becomes
        the block diagonal of the per-graph readout columns.  ``dtype`` is
        accepted for the reference's signature; the arrays keep ``floatx``."""
        nodes_list, arcs_list, targets_list = [], [], []
        set_list, out_list, sw_list = [], [], []
        graph_of_node, nodegraph_weight = [], []
        offset, graph_offset = 0, 0
        for g in glist:
            arcs = g.arcs.copy()
            arcs[:, :2] += offset
            arcs_list.append(arcs)
            nodes_list.append(g.nodes)
            targets_list.append(g.targets)
            set_list.append(g.set_mask)
            out_list.append(g.output_mask)
            sw_list.append(g.sample_weight)
            graph_of_node.append(g.graph_of_node + graph_offset)
            nodegraph_weight.append(g.nodegraph_weight)
            offset += g.nodes.shape[0]
            graph_offset += max(g.num_graphs, 1)

        merged = cls.__new__(cls)
        GraphObject.__init__(
            merged,
            nodes=np.concatenate(nodes_list, axis=0),
            arcs=np.concatenate(arcs_list, axis=0),
            targets=np.concatenate(targets_list, axis=0),
            focus=focus,
            set_mask=np.concatenate(set_list, axis=0),
            output_mask=np.concatenate(out_list, axis=0),
            sample_weight=np.concatenate(sw_list, axis=0),
            aggregation_mode=aggregation_mode,
            # per-graph arcs are unique + sorted and the node offsets increase,
            # so the concatenation is already canonical
            arcs_canonical=True,
        )
        merged.graph_of_node = np.concatenate(graph_of_node, axis=0)
        merged.nodegraph_weight = np.concatenate(nodegraph_weight, axis=0).astype(merged.dtype)
        return merged


class CompositeGraphObject(GraphObject):
    """Heterogeneous graph: a ``GraphObject`` with a (N, T) node-type mask
    and per-type node-label widths ``dim_node_label`` (type t reads the
    first d_t label columns)."""

    def __init__(self, nodes, arcs, targets, type_mask, dim_node_label, *args, **kwargs):
        self.type_mask = np.asarray(type_mask).astype(bool)
        super().__init__(nodes, arcs, targets, *args, **kwargs)
        self.DIM_NODE_LABEL = np.array(dim_node_label, ndmin=1, dtype=int)

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in _COMPOSITE_MODES:
            raise ValueError(f"Unknown aggregation mode: {mode!r}")

    def _build_weights(self, mode: str) -> np.ndarray:
        return arcnode_weights(self.arcs, mode, type_mask=self.type_mask)

    @property
    def num_types(self) -> int:
        return self.type_mask.shape[1]

    def getTypeMask(self) -> np.ndarray:
        return self.type_mask.copy()

    def CompositeAdjacencies_coo(self):
        """One (N, N) scipy matrix a type: the Adjacency restricted to arcs
        whose source node has the type (the per-type weights are already in
        ``arcnode_weight``)."""
        from scipy.sparse import coo_matrix

        n = self.nodes.shape[0]
        src = self.arcs[:, 0].astype(int)
        dst = self.arcs[:, 1].astype(int)
        mats = []
        for t in range(self.num_types):
            sel = self.type_mask[src, t]
            mats.append(coo_matrix((self.arcnode_weight[sel], (src[sel], dst[sel])), shape=(n, n), dtype=self.dtype))
        return mats

    def copy(self) -> "CompositeGraphObject":
        return CompositeGraphObject(
            nodes=self.nodes.copy(),
            arcs=self.arcs.copy(),
            targets=self.targets.copy(),
            type_mask=self.type_mask.copy(),
            dim_node_label=self.DIM_NODE_LABEL.copy(),
            focus=self.focus,
            set_mask=self.set_mask.copy(),
            output_mask=self.output_mask.copy(),
            sample_weight=self.sample_weight.copy(),
            NodeGraph=(self.graph_of_node.copy(), self.nodegraph_weight.copy()),
            aggregation_mode=self.aggregation_mode,
        )

    def __repr__(self):
        return f"composite_{super().__repr__()}"

    __str__ = __repr__

    def get_dict_data(self) -> dict:
        data = super().get_dict_data()
        data["type_mask"] = self.type_mask
        data["dim_node_label"] = self.DIM_NODE_LABEL
        return data

    @classmethod
    def merge(cls, glist: Sequence["CompositeGraphObject"], focus: str, aggregation_mode: str, dtype="float32"):
        """The homogeneous merge plus the concatenated type masks; every
        graph must have the same per-type label widths.  The weights are
        rebuilt from the merged type mask (``composite_average`` counts per
        type)."""
        dims = {tuple(g.DIM_NODE_LABEL) for g in glist}
        if len(dims) != 1:
            raise AssertionError("DIM_NODE_LABEL not unique among graphs in glist")
        base = GraphObject.merge(glist, focus, "sum")
        merged = cls.__new__(cls)
        merged.type_mask = np.concatenate([g.type_mask for g in glist], axis=0)
        GraphObject.__init__(
            merged,
            nodes=base.nodes,
            arcs=base.arcs,
            targets=base.targets,
            focus=focus,
            set_mask=base.set_mask,
            output_mask=base.output_mask,
            sample_weight=base.sample_weight,
            aggregation_mode=aggregation_mode,
        )
        merged.DIM_NODE_LABEL = np.array(dims.pop(), ndmin=1, dtype=int)
        merged.graph_of_node = base.graph_of_node
        merged.nodegraph_weight = base.nodegraph_weight
        return merged


def _fresh_folder(folder: str) -> str:
    """``folder`` with a trailing slash, emptied and created anew."""
    if folder[-1] != "/":
        folder += "/"
    if os.path.exists(folder):
        shutil.rmtree(folder)
    os.makedirs(folder)
    return folder


def _nodegraph_from_triples(data: dict) -> None:
    """Replace a ``NodeGraph`` ``[value, row, col]`` triple array in
    ``data`` by its scipy matrix, in place."""
    triples = data.pop("NodeGraph", None)
    if triples is not None:
        from scipy.sparse import coo_matrix

        data["NodeGraph"] = coo_matrix((triples[:, 0], (triples[:, 1].astype(int), triples[:, 2].astype(int))))
