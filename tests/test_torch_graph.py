"""Host-built batches of the PyTorch port against the JAX package.

Every array here is built on the host from the same NumPy inputs, so the bar
is exact equality (values and dtypes).  Where the JAX package pre-pads an
operator to its TPU grid blocking (K_TILES tiles), the first T tiles must be
equal and its extra tiles all zero.
"""

import warnings

import numpy as np
import pytest

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.packing as jpacking
import gnnkeras_tpu.ops.fused as jfused
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.packing as tpacking
import gnnkeras_tpu_torch.ops.fused as tfused
from torch_port_common import assert_batches_equal as _assert_batches_equal
from torch_port_common import eq_array as _eq
from torch_port_common import eq_padded as _eq_padded
from torch_port_common import merged_pair, raw_molecules, unique_pairs

# 110 molecules pack into > 16 tiles (the JAX strip pre-pads there), and a
# 150-node graph spans two tiles (cross-tile residual, spanning readout)
_RAW = raw_molecules(n_graphs=110, seed=3, big=(150,))


@pytest.mark.parametrize(
    "mode,kwargs",
    [
        ("plain", {}),
        ("tile_pack", {"tile_pack": True}),
        ("slot128_int8", {"slot_pack": 128, "strip_dtype": "int8"}),
        ("slot128_f32", {"slot_pack": 128, "strip_dtype": "float32"}),
    ],
)
def test_batch_matches_jax(mode, kwargs):
    raw = unique_pairs(_RAW)  # factorable: int8 storage applies
    jm, tm = merged_pair(raw)
    jkw = dict(kwargs)
    if "strip_dtype" in jkw:
        jkw["strip_dtype"] = np.dtype(jkw["strip_dtype"]).name
    jb = jbatch.from_graph_object(jm, **jkw)
    tb = tbatch.from_graph_object(tm, device="cpu", **kwargs)
    if mode.startswith("slot"):
        t = tb.num_nodes // 128
        assert t > jfused.K_TILES and t % jfused.K_TILES, "workload too small to exercise the JAX pre-pad"
        assert tb.strip.residual is not None
        assert (tb.strip.scale is not None) == (mode == "slot128_int8")
    _assert_batches_equal(tb, jb)


def test_int8_fallback_to_bf16_matches_jax():
    """Parallel arcs make the weights non-factorable: both packages warn and
    store the strip in bf16 (bit-equal)."""
    jm, tm = merged_pair(_RAW[:30])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jb = jbatch.from_graph_object(jm, slot_pack=128, strip_dtype="int8")
        tb = tbatch.from_graph_object(tm, slot_pack=128, strip_dtype="int8", device="cpu")
    assert sum(issubclass(w.category, RuntimeWarning) for w in caught) == 2
    assert tb.strip.scale is None and str(tb.strip.strip.dtype) == "torch.bfloat16"
    _assert_batches_equal(tb, jb)


def test_padded_template_and_operator_caps_match_jax():
    """The eval-route template (fixed pad sizes) and the operator caps."""
    jm, tm = merged_pair(_RAW[:20])
    pads = dict(pad_nodes=1280, pad_arcs=2048, pad_graphs=24)
    jb = jbatch.pad_operators_to_cap(jbatch.from_graph_object(jm, **pads))
    tb = tbatch.pad_operators_to_cap(tbatch.from_graph_object(tm, device="cpu", **pads))
    _assert_batches_equal(tb, jb)


def test_fused_route_batch_and_blocks_match_jax():
    """The fused serving route's batch (tile-packed, template-uniform compact
    readout) and its bf16 whole-unfold blocks."""
    jm, tm = merged_pair(_RAW[1:40])
    kw = dict(pad_nodes=2560, pad_arcs=4096, pad_graphs=None, tile_pack=True, compact_gmax=40, compact_nspan=21)
    jb = jbatch.from_graph_object(jm, **kw)
    tb = tbatch.from_graph_object(tm, device="cpu", **kw)
    _assert_batches_equal(tb, jb)
    a = jm.arcs.shape[0]
    args = (np.asarray(jb.arc_src)[:a], np.asarray(jb.arc_dst)[:a], np.asarray(jb.arcnode_weight)[:a], jb.num_nodes)
    jop = jfused.build_fused_diag_t(*args)
    top = tfused.build_fused_diag_t(*args)
    _eq_padded(top.blocks, jop.blocks, "fused blocks (bf16 bits)")
    # an edge across tiles refuses the fused operator in both
    assert jfused.build_fused_diag_t(np.array([0, 130]), np.array([130, 0]), np.ones(2), 256) is None
    assert tfused.build_fused_diag_t(np.array([0, 130]), np.array([130, 0]), np.ones(2), 256) is None


@pytest.mark.parametrize("slot", [32, 128])
def test_packing_matches_jax(slot):
    sizes = np.random.default_rng(slot).integers(1, 160, 300)
    for fn in ("pack_tiles",):
        js, jn = getattr(jpacking, fn)(sizes)
        ts, tn = getattr(tpacking, fn)(sizes)
        np.testing.assert_array_equal(ts, js)
        assert tn == jn
    js, jn = jpacking.pack_slots(sizes, slot=slot)
    ts, tn = tpacking.pack_slots(sizes, slot=slot)
    np.testing.assert_array_equal(ts, js)
    assert tn == jn
    for j, t in zip(jpacking.graph_slots_from_starts(js, sizes), tpacking.graph_slots_from_starts(ts, sizes)):
        np.testing.assert_array_equal(t, j)
    for j, t in zip(jpacking.packed_graph_slots(sizes), tpacking.packed_graph_slots(sizes)):
        np.testing.assert_array_equal(t, j)
    gon = np.repeat(np.arange(len(sizes)), sizes)
    for j, t in zip(jpacking.packed_node_positions(gon), tpacking.packed_node_positions(gon)):
        np.testing.assert_array_equal(t, j)
    shuffled = np.random.default_rng(0).permutation(gon)
    np.testing.assert_array_equal(
        tpacking.positions_from_starts(shuffled, ts), jpacking.positions_from_starts(shuffled, js)
    )
