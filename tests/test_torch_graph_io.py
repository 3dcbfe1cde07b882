"""Graph persistence of the port (``graph/graph.py``'s save / load methods,
``graph/tensor_io.py``) against the JAX package's: files saved by either
package load in the other, as ``.npz`` and as text folders, plain and
composite graphs, datasets included; the device-form (GraphTensor)
archives round-trip both ways; ``merge(dtype=)``; the scipy views of the
operators equal.  Every comparison is exact.
"""

import os

import numpy as np
import pytest

import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.graph.tensor_io as jtio
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.graph.tensor_io as ttio

FIELDS = ("nodes", "arcs", "targets", "set_mask", "output_mask", "sample_weight", "arcnode_weight", "graph_of_node",
          "nodegraph_weight", "DIM_NODE_LABEL")


def assert_same_graph(a, b):
    assert type(a).__name__ == type(b).__name__
    assert (a.focus, a.aggregation_mode, a.DIM_ARC_LABEL, a.DIM_TARGET) == (b.focus, b.aggregation_mode,
                                                                            b.DIM_ARC_LABEL, b.DIM_TARGET)
    for name in FIELDS + (("type_mask",) if hasattr(b, "type_mask") else ()):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def make(module, kind, seed=0):
    """A graph of ``kind``: node focus with masks and sample weights, a
    merged graph-focused batch (NodeGraph), or composite (2 types)."""
    rng = np.random.default_rng(seed)
    n = 9
    nodes = rng.normal(size=(n, 3))
    arcs = np.concatenate([rng.integers(0, n, (20, 2)), rng.normal(size=(20, 2))], 1)
    if kind == "node":
        return module.GraphObject(nodes, arcs, rng.normal(size=(n, 2)), focus="n", set_mask=rng.random(n) < 0.7,
                                  output_mask=rng.random(n) < 0.8, sample_weight=rng.random(n) + 0.5,
                                  aggregation_mode="average")
    if kind == "graph":
        parts = [module.GraphObject(nodes[: 4 + i], arcs[arcs[:, :2].max(1) < 4 + i], np.eye(2)[[i % 2]], focus="g",
                                    aggregation_mode="average") for i in range(3)]
        return module.GraphObject.merge(parts, "g", "average")
    type_mask = np.zeros((n, 2), bool)
    type_mask[np.arange(n), rng.integers(0, 2, n)] = True
    return module.CompositeGraphObject(nodes, arcs, np.eye(2)[[1]], type_mask, (3, 2), focus="g",
                                       aggregation_mode="composite_average")


PAIRS = [(jgraph, tgraph), (tgraph, jgraph), (tgraph, tgraph)]
KINDS = ["node", "graph", "composite"]


def cls_of(module, g):
    return module.CompositeGraphObject if hasattr(g, "type_mask") else module.GraphObject


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", PAIRS, ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_npz_and_txt_round_trip(tmp_path, kind, writer, reader):
    g = make(writer, kind)
    focus, mode = g.focus, g.aggregation_mode
    g.save(str(tmp_path / "g"))
    g.save_compressed(str(tmp_path / "gz"))
    assert_same_graph(cls_of(reader, g).load(str(tmp_path / "g"), focus, mode), make(reader, kind))
    assert_same_graph(cls_of(reader, g).load(str(tmp_path / "gz.npz"), focus, mode), make(reader, kind))
    if kind != "composite":  # composite text folders: as in the JAX package, their label widths come back 2-D
        g.savetxt(str(tmp_path / "t"))
        assert_same_graph(cls_of(reader, g).load_txt(str(tmp_path / "t"), focus, mode), make(reader, kind))


def test_composite_text_folders_read_alike(tmp_path):
    """A composite text folder loads the same through either package
    (widths as a (T, 1) column, as the JAX package reads them back)."""
    for writer in (jgraph, tgraph):
        make(writer, "composite").savetxt(str(tmp_path / writer.__name__))
        a = tgraph.CompositeGraphObject.load_txt(str(tmp_path / writer.__name__), "g", "composite_average")
        b = jgraph.CompositeGraphObject.load_txt(str(tmp_path / writer.__name__), "g", "composite_average")
        assert_same_graph(a, b)


@pytest.mark.parametrize("writer,reader", PAIRS, ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_datasets_round_trip(tmp_path, writer, reader):
    glist = [make(writer, "node", seed=s) for s in range(3)]
    writer.GraphObject.save_dataset(str(tmp_path / "npz"), glist)
    writer.GraphObject.save_dataset(str(tmp_path / "npzc"), glist, compressed=True)
    writer.GraphObject.save_dataset_txt(str(tmp_path / "txt"), glist)
    want = [make(reader, "node", seed=s) for s in range(3)]
    for got in (reader.GraphObject.load_dataset(str(tmp_path / "npz"), "n", "average"),
                reader.GraphObject.load_dataset(str(tmp_path / "npzc"), "n", "average"),
                reader.GraphObject.load_dataset_txt(str(tmp_path / "txt"), "n", "average")):
        assert len(got) == 3
        for a, b in zip(got, want):
            assert_same_graph(a, b)
    assert sorted(os.listdir(tmp_path / "npz")) == ["g0.npz", "g1.npz", "g2.npz"]


@pytest.mark.parametrize("kind", KINDS)
def test_dict_data_and_coo_views_equal(kind):
    t, j = make(tgraph, kind), make(jgraph, kind)
    td, jd = t.get_dict_data(), j.get_dict_data()
    assert sorted(td) == sorted(jd)
    for key in td:
        np.testing.assert_array_equal(td[key], jd[key], err_msg=key)
    for name in ("ArcNode_coo", "Adjacency_coo", "NodeGraph_coo"):
        a, b = getattr(t, name)(), getattr(j, name)()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.toarray(), b.toarray(), err_msg=name)
    if kind == "composite":
        for a, b in zip(t.CompositeAdjacencies_coo(), j.CompositeAdjacencies_coo()):
            np.testing.assert_array_equal(a.toarray(), b.toarray())


@pytest.mark.parametrize("mode", ["sum", "normalized", "average"])
def test_set_aggregation(mode):
    t, j = make(tgraph, "node"), make(jgraph, "node")
    t.setAggregation(mode)
    j.setAggregation(mode)
    assert_same_graph(t, j)
    with pytest.raises(ValueError):
        t.setAggregation("composite_average")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [(jtio, ttio), (ttio, jtio), (ttio, ttio)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_graph_tensor_round_trip(tmp_path, kind, writer, reader):
    src_mod = jgraph if writer is jtio else tgraph
    dst_mod = jgraph if reader is jtio else tgraph
    g = make(src_mod, kind)
    writer.save_graph_tensor(str(tmp_path / "gt"), g, compressed=kind == "graph")
    got = reader.load_graph_tensor(str(tmp_path / "gt"), g.focus)
    assert_same_graph(got, make(dst_mod, kind))
    # the key layout is the reference's, whichever package wrote it
    keys = sorted(np.load(str(tmp_path / "gt.npz")).files)
    writer_other = ttio if writer is jtio else jtio
    writer_other.save_graph_tensor(str(tmp_path / "other"), make(jgraph if writer_other is jtio else tgraph, kind))
    assert keys == sorted(np.load(str(tmp_path / "other.npz")).files)


def test_graph_tensor_refuses_a_mode_mismatch(tmp_path):
    g = make(tgraph, "node")
    ttio.save_graph_tensor(str(tmp_path / "gt"), g)
    data = dict(np.load(str(tmp_path / "gt.npz")))
    data["aggregation_mode"] = np.array("sum")
    np.savez(str(tmp_path / "bad"), **data)
    for reader in (ttio, jtio):
        with pytest.raises(ValueError, match="Adjacency"):
            reader.load_graph_tensor(str(tmp_path / "bad"), "n")
        assert reader.load_graph_tensor(str(tmp_path / "bad"), "n", verify=False).aggregation_mode == "sum"


@pytest.mark.parametrize("composite", [False, True])
def test_merge_dtype(composite):
    kind = "composite" if composite else "node"
    tl = [make(tgraph, kind, seed=s) for s in range(3)]
    jl = [make(jgraph, kind, seed=s) for s in range(3)]
    focus = "g" if composite else "n"
    mode = "composite_average" if composite else "average"
    for dtype in ("float32", "float64"):
        t = cls_of(tgraph, tl[0]).merge(tl, focus, mode, dtype=dtype)
        j = cls_of(jgraph, jl[0]).merge(jl, focus, mode, dtype=dtype)
        assert_same_graph(t, j)
        assert t.nodes.dtype == np.float32
