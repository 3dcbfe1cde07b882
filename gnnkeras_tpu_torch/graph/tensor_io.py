"""Device-form ("GraphTensor") npz persistence in the reference's key
layout, the port's copy of ``gnnkeras_tpu.graph.tensor_io``.

The reference persists the device form of a graph: the dense arrays plus
the three sparse operators flattened to ``[value, row, col]`` triples
(``Adjacency``, ``ArcNode``, ``NodeGraph``, each with its ``_shape``), the
aggregation mode, and for composite graphs the transposed ``type_mask`` and
one ``CompositeAdjacencies_{i}`` triple array a type.  ``save_graph_tensor``
writes that layout and ``load_graph_tensor`` reads it back into a host
graph, rebuilding the operators from (arcs, aggregation_mode) and, with
``verify``, checking the archived Adjacency against them.  Archives written
by the JAX package load here and the other way round.
"""

from __future__ import annotations

import numpy as np

from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject


def _triple(coo, dtype):
    """tf.sparse.reorder ordering: row-major sorted [value,row,col] rows.

    Indices ride in the FLOAT triple (the reference's on-disk layout); float32
    represents integers exactly only up to 2^24, so larger graphs promote the
    triple to float64 (loaders on both sides ``.astype(int)`` the index
    columns, which is dtype-agnostic)."""
    coo = coo.tocoo()
    order = np.lexsort((coo.col, coo.row))
    if np.dtype(dtype).itemsize < 8 and max(coo.shape, default=0) >= (1 << 24):
        dtype = np.float64
    return np.stack(
        [coo.data[order].astype(dtype), coo.row[order].astype(dtype), coo.col[order].astype(dtype)]
    ).transpose()


def save_graph_tensor(graph_npz_path: str, g: GraphObject, compressed: bool = False, **kwargs) -> None:
    """Write ``g``'s device form with the reference ``GraphTensor.save_graph``
    key layout (graph_class.py:507-521)."""
    dtype = g.dtype
    sparse_data = {"aggregation_mode": np.array(g.aggregation_mode)}
    mats = {
        "Adjacency": g.Adjacency_coo(),
        "ArcNode": g.ArcNode_coo(),
        "NodeGraph": g.NodeGraph_coo(),
    }
    for name, mat in mats.items():
        sparse_data[name] = _triple(mat, dtype)
        sparse_data[name + "_shape"] = np.array(mat.shape, dtype=np.int64)

    if isinstance(g, CompositeGraphObject):
        # reference stores type_mask transposed (T, N) and one triple per
        # type's masked adjacency (composite_graph_class.py:226-232, 262)
        sparse_data["type_mask"] = g.type_mask.transpose()
        for idx, mat in enumerate(g.CompositeAdjacencies_coo()):
            sparse_data[f"CompositeAdjacencies_{idx}"] = _triple(mat, dtype)

    saving_function = np.savez_compressed if compressed else np.savez
    saving_function(
        graph_npz_path,
        dim_node_label=np.array(g.DIM_NODE_LABEL),
        nodes=g.nodes,
        arcs=g.arcs,
        targets=g.targets,
        sample_weight=g.sample_weight,
        set_mask=g.set_mask,
        output_mask=g.output_mask,
        **sparse_data,
        **kwargs,
    )


def load_graph_tensor(graph_npz_path: str, focus: str, verify: bool = True, **kwargs) -> GraphObject:
    """Read a (possibly reference-written) GraphTensor npz back into a host
    graph — the ``GraphObject.fromGraphTensor`` equivalent
    (graph_class.py:416-427).

    ``verify=True`` cross-checks the archived Adjacency triples against the
    operators rebuilt from (arcs, aggregation_mode)."""
    if not graph_npz_path.endswith(".npz"):
        graph_npz_path += ".npz"
    data = dict(np.load(graph_npz_path, **kwargs))
    aggregation_mode = str(data["aggregation_mode"])

    nodegraph = None
    if focus == "g" and data["NodeGraph"].shape[0] > 0:
        from scipy.sparse import coo_matrix

        t = data["NodeGraph"]
        shape = tuple(int(s) for s in data["NodeGraph_shape"])
        nodegraph = coo_matrix((t[:, 0], (t[:, 1].astype(int), t[:, 2].astype(int))), shape=shape)

    common = dict(
        arcs=data["arcs"],
        nodes=data["nodes"],
        targets=data["targets"],
        set_mask=data["set_mask"].astype(bool),
        output_mask=data["output_mask"].astype(bool),
        sample_weight=data["sample_weight"],
        NodeGraph=nodegraph,
        aggregation_mode=aggregation_mode,
        focus=focus,
    )
    if "type_mask" in data:
        # the GraphTensor form ALWAYS stores type_mask transposed (T, N):
        # fromGraphObject transposes it in and fromGraphTensor back out
        # (composite_graph_class.py:210,263) — so transpose unconditionally
        # (a shape heuristic would misfire when T == N)
        tm = data["type_mask"].astype(bool).transpose()
        g = CompositeGraphObject(
            type_mask=tm,
            dim_node_label=tuple(int(d) for d in np.ravel(data["dim_node_label"])),
            **common,
        )
    else:
        g = GraphObject(**common)

    if verify and data["Adjacency"].shape[0] > 0:
        got = _triple(g.Adjacency_coo(), g.dtype)
        want = data["Adjacency"]
        if got.shape != want.shape or not np.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise ValueError(
                "archived Adjacency does not match the operators rebuilt from "
                "(arcs, aggregation_mode) — corrupt archive or mode mismatch"
            )
    return g
