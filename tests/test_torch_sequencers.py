"""The port's sequencers (``gnnkeras_tpu_torch.data.sequencers``) against the
JAX package's.

Both packages draw their shuffles from NumPy's global stream, so with the
same seed they build the same batches: every batch is compared field for
field (``torch_port_common.assert_batches_equal``: bit for bit, the
composite label sums at rtol 1e-6), before and after an epoch's background
rebuild.  Covered: the four sequencer classes; plain, tile-packed and
slot-128 int8 batches and the bf16 degrade; arc focus (incidence pairs
padded to one count); the BCSR degrade latch of a quantised
``agg_dtype``; the residual pad; both shuffle modes; ``set_batch_size``,
``copy`` and ``with_graphs``; and a background rebuild that fails.
"""

import warnings

import numpy as np
import pytest
import torch

import gnnkeras_tpu.data.sequencers as jseq
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu_torch.data.sequencers as tseq
import gnnkeras_tpu_torch.graph.graph as tgraph
from gnnkeras_tpu_torch.ops.bcsr import BcsrMatrix
from torch_port_common import (arc_targets, assert_batches_equal, composite_graphs, graphs, node_targets,
                               raw_molecules, unique_pairs)

# 15 molecules; the 150-node one spans two tiles (a cross-tile residual in
# its batch only)
_RAW = raw_molecules(n_graphs=14, seed=3, big=(150,))

_LAYOUTS = {
    "plain": dict(tile_pack=False),
    "tile_pack": dict(),
    "slot128_int8": dict(slot_pack=128),
    "slot128_bf16_degrade": dict(slot_pack=128),
}


def _pair(cls, make, *args, seed=0, **kwargs):
    """The JAX and the port sequencer of class ``cls`` over graphs made by
    ``make(module)``, each built after seeding NumPy with ``seed``."""
    out = []
    for seq_mod, graph_mod, extra in ((jseq, jgraph, {}), (tseq, tgraph, {"device": "cpu"})):
        np.random.seed(seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out.append(getattr(seq_mod, cls)(make(graph_mod), *args, **kwargs, **extra))
    return out


def _epochs(js, ts, n_epochs=2):
    """Every batch equal, for ``n_epochs`` epochs: both sequencers shuffle
    from the same NumPy seed between them."""
    for epoch in range(n_epochs):
        assert len(js) == len(ts)
        for i in range(len(ts)):
            assert_batches_equal(ts[i], js[i])
        for s in (js, ts):
            np.random.seed(100 + epoch)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                s.on_epoch_end()
    ts.wait_for_rebuild()
    js._join_pending()


def _raw_for(layout):
    """Factorable molecules, and for the degrade one molecule with parallel
    arcs: its batch alone falls back to bf16, and the latch degrades the
    int8 batches beside it (``strip_to_dense``)."""
    if layout == "slot128_int8":
        return unique_pairs(_RAW)
    if layout == "slot128_bf16_degrade":
        return unique_pairs(_RAW[:5]) + [_RAW[5]] + unique_pairs(_RAW[6:])
    return _RAW


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_multi_graph_batches_match_jax(layout):
    raw = _raw_for(layout)
    if layout == "slot128_bf16_degrade":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tseq.MultiGraphSequencer(graphs(tgraph, raw), "g", "average", batch_size=4, shuffle=False,
                                     slot_pack=128, device="cpu")
        assert sum(issubclass(w.category, RuntimeWarning) for w in caught) == 1
    js, ts = _pair("MultiGraphSequencer", lambda m: graphs(m, raw), "g", "average", batch_size=4, **_LAYOUTS[layout])
    if layout.startswith("slot128"):
        want = torch.int8 if layout == "slot128_int8" else torch.bfloat16
        assert ts[0].strip.strip.dtype == want and ts._strip_scale_degraded == (want == torch.bfloat16)
    _epochs(js, ts)


def test_arc_focus_pairs_are_padded_like_jax():
    raw = arc_targets(_RAW[1:9])
    js, ts = _pair("MultiGraphSequencer", lambda m: graphs(m, raw, focus="a"), "a", "average", batch_size=3,
                   slot_pack=128)
    counts = {ts[i].arc_inc.n_pairs for i in range(len(ts))}
    assert len(counts) == 1 and ts._pad_inc_pairs == counts.pop()
    _epochs(js, ts)


def test_residual_pad_matches_jax():
    """Only the batch holding the 150-node graph has cross-tile arcs; every
    other batch gets the all-zero residual of the same block count."""
    raw = unique_pairs(_RAW)
    js, ts = _pair("MultiGraphSequencer", lambda m: graphs(m, raw), "g", "average", batch_size=4, shuffle=False,
                   slot_pack=128)
    blocks = [ts[i].strip.residual.blocks for i in range(len(ts))]
    assert len({b.shape for b in blocks}) == 1 and ts._pad_strip_res == blocks[0].shape[0]
    assert not blocks[-1].any() and blocks[0].any()  # the 150-node graph is first, alone in batch 0's residual
    _epochs(js, ts, n_epochs=1)


def test_composite_multi_graph_matches_jax():
    js, ts = _pair("CompositeMultiGraphSequencer", lambda m: composite_graphs(m, _RAW[1:12]), "g",
                   "composite_average", batch_size=4, slot_pack=128)
    assert ts[0].type_mask.shape[1] == 3
    _epochs(js, ts)


@pytest.mark.parametrize("cls", ["SingleGraphSequencer", "CompositeSingleGraphSequencer"])
def test_single_graph_matches_jax(cls):
    """One node-focused graph (the union of 8 molecules), mini-batched by
    set masks; only ``set_mask`` / ``target_mask`` change between batches."""
    raw = node_targets(_RAW[1:9])

    def make(m):
        parts = composite_graphs(m, raw, focus="n") if cls.startswith("Composite") else graphs(m, raw, focus="n")
        merged = type(parts[0]).merge(parts, focus="n", aggregation_mode=parts[0].aggregation_mode)
        merged.set_mask[::5] = False  # some nodes unsupervised
        return merged

    js, ts = _pair(cls, make, "n", batch_size=40)
    assert len(ts) > 2
    for i in range(len(ts)):
        assert ts[i].bcsr is ts[0].bcsr and ts[i].nodes is ts[0].nodes
        # predict's rows: the batch's target rows in order, as the JAX
        # package reads them off the target mask
        np.testing.assert_array_equal(ts[i].host_pred_rows, np.flatnonzero(ts[i].target_mask.numpy()))
    for epoch in range(2):
        for i in range(len(ts)):
            jb = js[i]
            for name in ("set_mask", "target_mask", "nodes", "targets", "arcnode_weight"):
                np.testing.assert_array_equal(getattr(ts[i], name).numpy(), np.asarray(getattr(jb, name)), name)
            np.testing.assert_array_equal(ts[i].bcsr.blocks.numpy(), np.asarray(jb.bcsr.blocks))
        for s in (js, ts):
            np.random.seed(7 + epoch)
            s.on_epoch_end()
    ts.wait_for_rebuild()
    js._join_pending()


def test_shuffle_mode_batches_matches_jax():
    js, ts = _pair("MultiGraphSequencer", lambda m: graphs(m, _RAW), "g", "average", batch_size=4,
                   shuffle_mode="batches")
    first = list(ts.batches)
    _epochs(js, ts, n_epochs=3)
    assert sorted(map(id, ts.batches)) == sorted(map(id, first))  # reordered, not rebuilt


def test_quantised_operators_degrade_to_float_blocks_latched():
    """``agg_dtype='int8'`` over a multi-graph sequencer: float blocks
    (with the RuntimeWarning), ``agg_dtype`` latched off across rebuilds,
    as JAX's ``tests/test_bcsr.py::TestQuantizedSequencerDegrade``."""
    rng = np.random.default_rng(31)
    raw = []
    for _ in range(8):
        nn = int(rng.integers(6, 14))
        pairs = np.unique(np.stack([rng.integers(0, nn, 20), rng.integers(0, nn, 20)], 1), axis=0)
        arcs = np.concatenate([pairs.astype(np.float64), np.ones((len(pairs), 1))], 1)
        raw.append((rng.normal(size=(nn, 3)), arcs, rng.normal(size=(nn, 2))))
    with pytest.warns(RuntimeWarning, match="per-merge shaped"):
        ts = tseq.MultiGraphSequencer(graphs(tgraph, raw, focus="n"), "n", "average", batch_size=4, shuffle=False,
                                      agg_dtype="int8", device="cpu")
    assert ts.agg_dtype is None
    assert all(isinstance(ts[i].bcsr, BcsrMatrix) for i in range(len(ts)))
    ts.set_batch_size(3)  # a rebuild does not bring the quantised operators back
    assert all(isinstance(ts[i].bcsr, BcsrMatrix) for i in range(len(ts)))
    np.random.seed(4)
    with pytest.warns(RuntimeWarning, match="per-merge shaped"):
        js = jseq.MultiGraphSequencer(graphs(jgraph, raw, focus="n"), "n", "average", batch_size=3, shuffle=False,
                                      agg_dtype="int8")
    for i in range(len(ts)):
        assert_batches_equal(ts[i], js[i])


def test_set_batch_size_copy_and_with_graphs():
    js, ts = _pair("MultiGraphSequencer", lambda m: graphs(m, _RAW), "g", "average", batch_size=4, slot_pack=128)
    js.set_batch_size(6)
    ts.set_batch_size(6)
    assert len(ts) == 3
    for i in range(len(ts)):
        assert_batches_equal(ts[i], js[i])
    twin = ts.copy()
    assert twin.get_config().keys() == ts.get_config().keys() and twin.data[0] is not ts.data[0]
    for i in range(len(ts)):
        assert_batches_equal(twin[i], js[i])
    other = ts.with_graphs(graphs(tgraph, _RAW[2:8]))
    assert len(other) == 1 and other.batch_size == 6 and other.slot_pack == 128 and other.device.type == "cpu"
    np.random.seed(3)
    assert_batches_equal(other[0], js.with_graphs(graphs(jgraph, _RAW[2:8]))[0])
    assert repr(ts) == repr(js) and repr(tseq.CompositeMultiGraphSequencer(
        composite_graphs(tgraph, _RAW[1:3]), "g", "composite_average", device="cpu")).startswith("composite_")


def test_failing_background_rebuild_reraises(monkeypatch):
    ts = tseq.MultiGraphSequencer(graphs(tgraph, _RAW), "g", "average", batch_size=4, device="cpu")

    def broken():
        raise ValueError("merge failed")

    monkeypatch.setattr(ts, "build_batches", broken)
    ts.on_epoch_end()  # the rebuild runs (and fails) in the background
    with pytest.raises(RuntimeError, match="background batch rebuild failed") as err:
        ts[0]
    assert isinstance(err.value.__cause__, ValueError)
    assert ts._pending_build is None and ts._pending_exc is None


def test_slot_pack_below_128_and_bad_shuffle_mode_refused():
    with pytest.raises(ValueError, match="slot_pack=128"):
        tseq.MultiGraphSequencer(graphs(tgraph, _RAW[:2]), "g", "average", slot_pack=32, device="cpu")
    with pytest.raises(ValueError, match="shuffle_mode"):
        tseq.MultiGraphSequencer(graphs(tgraph, _RAW[:2]), "g", "average", shuffle_mode="tiles", device="cpu")
