"""Composite graphs in the port against the JAX package: the
'composite_average' weights, ``CompositeGraphObject`` (constructor, merge,
copy), the per-type neighbour-label sums ``agg_component_sums`` and the
composite fields of a batch, on the same NumPy inputs.

Tolerances: the host graph's arrays are computed by the same NumPy
operations in the same order in both packages, so weights, merges and type
masks are held bit for bit.  ``agg_component_sums`` accumulates in f64 in
arc order in both (the JAX package's one-hot masks may take its C++ tier,
pinned to the same order): bit for bit, and to a brute-force loop at rtol
1e-12 (another order of f64 sums).  The batch's ``agg_component`` is that
f64 sum cast to f32, held to rtol 1e-6.
"""

import numpy as np
import pytest

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.native as jnative
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
from gnnkeras_tpu_torch import native as tnative
from torch_port_common import TYPE_BOUNDS, arc_targets, composite_graphs, composite_merged_pair, node_targets, \
    raw_molecules, type_mask_of

_LAYOUTS = {
    "edge_list": dict(dense_blocks=False),
    "tile_pack": dict(tile_pack=True),
    "slot_pack": dict(slot_pack=128, strip_dtype="float32"),
}


def _raw(focus, seed=1, n_graphs=9):
    raw = raw_molecules(n_graphs=n_graphs, seed=seed)
    if focus == "n":
        raw = node_targets(raw, seed=seed)
    elif focus == "a":
        raw = arc_targets(raw, seed=seed)
    return raw


def _random_arcs(rng, n, a):
    return np.concatenate([rng.integers(0, n, (a, 2)), rng.normal(size=(a, 2))], axis=1)


@pytest.mark.parametrize("multi_hot", [False, True])
def test_composite_average_weights_are_bit_equal(multi_hot):
    rng = np.random.default_rng(3)
    n = 60
    arcs = _random_arcs(rng, n, 240)
    tm = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    if multi_hot:
        tm |= rng.random((n, 3)) < 0.3
    for mode in ("sum", "normalized", "average", "composite_average"):
        want = jgraph.arcnode_weights(arcs, mode, type_mask=tm)
        got = tgraph.arcnode_weights(arcs, mode, type_mask=tm)
        assert got.dtype == want.dtype and np.array_equal(got, want), mode
    with pytest.raises(ValueError, match="type_mask"):
        tgraph.arcnode_weights(arcs, "composite_average")


def test_composite_graph_object_and_merge_are_bit_equal():
    raw = _raw("g")
    jg, tg = composite_graphs(jgraph, raw), composite_graphs(tgraph, raw)
    for j, t in zip(jg, tg):
        assert np.array_equal(j.arcnode_weight, t.arcnode_weight)
        assert np.array_equal(j.getTypeMask(), t.getTypeMask()) and t.num_types == 3
        assert np.array_equal(j.DIM_NODE_LABEL, t.DIM_NODE_LABEL)
        assert repr(t).startswith("composite_graph(")
    jm, tm = composite_merged_pair(raw)
    assert isinstance(tm, tgraph.CompositeGraphObject)
    for field in ("nodes", "arcs", "targets", "type_mask", "arcnode_weight", "graph_of_node", "nodegraph_weight",
                  "set_mask", "output_mask", "sample_weight", "DIM_NODE_LABEL"):
        a, b = getattr(jm, field), getattr(tm, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # per-type counts of disjoint graphs: the union's weights are the graphs'
    assert np.array_equal(tm.arcnode_weight, np.concatenate([g.arcnode_weight for g in tg]))
    clone = tm.copy()
    assert isinstance(clone, tgraph.CompositeGraphObject)
    for field in ("nodes", "arcs", "type_mask", "arcnode_weight", "graph_of_node", "DIM_NODE_LABEL"):
        assert np.array_equal(getattr(clone, field), getattr(tm, field)), field
    other = composite_graphs(tgraph, raw[:1], n_types=1)
    with pytest.raises(AssertionError, match="DIM_NODE_LABEL"):
        tgraph.CompositeGraphObject.merge(tg[:1] + other, focus="g", aggregation_mode="average")
    with pytest.raises(ValueError, match="aggregation mode"):
        tgraph.GraphObject(nodes=raw[0][0], arcs=raw[0][1], targets=raw[0][2], aggregation_mode="composite_average")


@pytest.mark.parametrize("multi_hot", [False, True])
def test_agg_component_sums_match_jax(multi_hot):
    rng = np.random.default_rng(7)
    n, a = 90, 400
    nodes = rng.normal(size=(n, 14)).astype(np.float32)
    src, dst = rng.integers(0, n, a), rng.integers(0, n, a)
    w = rng.random(a).astype(np.float32)
    tm = type_mask_of(np.eye(14, dtype=np.float32)[rng.integers(0, 14, n)])
    if multi_hot:
        tm = tm | (rng.random((n, 3)) < 0.4)
        assert (tm.sum(axis=1) > 1).any()
    tm[:5] = False  # nodes of no type contribute nothing
    got = tnative.agg_component_sums(src, dst, w, nodes, tm, TYPE_BOUNDS, n + 6)
    want = jnative.agg_component_sums(src, dst, w, nodes, tm, TYPE_BOUNDS, n + 6)
    assert got.dtype == want.dtype == np.float64 and got.shape == (n + 6, sum(TYPE_BOUNDS))
    np.testing.assert_array_equal(got, want)
    # per type: the gated sums by brute force
    off = 0
    for t, d_t in enumerate(TYPE_BOUNDS):
        brute = np.zeros((n + 6, d_t))
        for e in range(a):
            if tm[src[e], t]:
                brute[dst[e]] += float(w[e]) * nodes[src[e], :d_t].astype(np.float64)
        np.testing.assert_allclose(got[:, off:off + d_t], brute, rtol=1e-12, atol=1e-12)
        off += d_t


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("focus", ["g", "n", "a"])
def test_composite_batch_fields_match_jax(focus, layout):
    jm, tm = composite_merged_pair(_raw(focus, seed=2), focus=focus)
    jb = jbatch.from_graph_object(jm, **_LAYOUTS[layout])
    tb = tbatch.from_graph_object(tm, device="cpu", **_LAYOUTS[layout])
    assert tb.num_types == jb.num_types == 3 and tb.dim_node_label == tuple(jb.dim_node_label)
    assert tb.type_mask.dtype.is_floating_point is False
    np.testing.assert_array_equal(tb.type_mask.numpy(), np.asarray(jb.type_mask))
    np.testing.assert_allclose(tb.agg_component.numpy(), np.asarray(jb.agg_component), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    np.testing.assert_array_equal(tb.arcnode_weight.numpy(), np.asarray(jb.arcnode_weight))
    # the tail of the component is the arc-label sum
    np.testing.assert_array_equal(tb.agg_component.numpy()[:, sum(TYPE_BOUNDS):], tb.agg_arc_labels.numpy())


def test_graphs_to_batch_dispatches_on_the_class():
    raw = _raw("g", seed=4)
    tg = composite_graphs(tgraph, raw)
    jg = composite_graphs(jgraph, raw)
    tb = tbatch.graphs_to_batch(tg, "g", "composite_average", slot_pack=128, device="cpu")
    jb = jbatch.graphs_to_batch(jg, "g", "composite_average", slot_pack=128)
    np.testing.assert_array_equal(tb.type_mask.numpy(), np.asarray(jb.type_mask))
    np.testing.assert_allclose(tb.agg_component.numpy(), np.asarray(jb.agg_component), rtol=1e-6, atol=0)
    homogeneous = tbatch.graphs_to_batch([tgraph.GraphObject(nodes=n, arcs=a, targets=t, focus="g") for n, a, t in raw],
                                         "g", "average", device="cpu")
    assert homogeneous.type_mask is None and homogeneous.agg_component is None and homogeneous.num_types == 1


def test_composite_fields_travel_with_the_batch():
    import torch.utils._pytree as pytree

    _, tm = composite_merged_pair(_raw("g", seed=5))
    tb = tbatch.from_graph_object(tm, slot_pack=128, device="cpu")
    flat, spec = pytree.tree_flatten(tb)
    rebuilt = pytree.tree_unflatten(flat, spec)
    assert rebuilt.type_mask is tb.type_mask and rebuilt.agg_component is tb.agg_component
    assert any(x is tb.type_mask for x in flat) and any(x is tb.agg_component for x in flat)
    moved = tb.to("cpu")
    assert moved.type_mask.dtype == tb.type_mask.dtype and moved.agg_component.shape == tb.agg_component.shape
