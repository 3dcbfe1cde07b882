"""The port's ``Predictor`` against the JAX package's on the same graphs and
weights, on both routes.

The fused route runs in f32 over the same bf16-rounded 1/indeg weights in
both packages (JAX's Pallas kernel in interpret mode on the CPU); the eval
route is f32 throughout.  Only summation order differs: rtol 1e-5 /
atol 1e-6.
"""

import numpy as np
import pytest

import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.serving as tserving
import gnnkeras_tpu.graph.graph as jgraph
from torch_port_common import flagship_pair, graphs, node_targets, raw_molecules

RTOL, ATOL = 1e-5, 1e-6

_RAW = raw_molecules(n_graphs=16, seed=13)
_J, _T = graphs(jgraph, _RAW), graphs(tgraph, _RAW)


def _predictors(fused, seed=3, big=False):
    jmodel, tmodel = flagship_pair(seed=seed)
    jg, tg = (_BIG_J, _BIG_T) if big else (_J, _T)
    jp = jserving.Predictor.for_graphs(jmodel, jg, batch_size=len(jg), fused=fused)
    tp = tserving.Predictor.for_graphs(tmodel, tg, batch_size=len(tg), fused=fused, device="cpu")
    return jp, tp


_BIG_RAW = raw_molecules(n_graphs=5, seed=14, big=(150,))
_BIG_J, _BIG_T = graphs(jgraph, _BIG_RAW), graphs(tgraph, _BIG_RAW)


@pytest.mark.parametrize("fused", ["auto", False])
def test_predictor_matches_jax(fused):
    jp, tp = _predictors(fused)
    assert tp.fused == jp.fused == (fused == "auto")
    np.testing.assert_allclose(tp(_T), jp(_J), rtol=RTOL, atol=ATOL)
    # a single-graph request, and rows in request order
    np.testing.assert_allclose(tp(_T[4]), jp(_J[4]), rtol=RTOL, atol=ATOL)
    order = [5, 0, 11, 3]
    got = tp([_T[i] for i in order])
    np.testing.assert_allclose(got, jp([_J[i] for i in order]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tp(_T)[order], rtol=RTOL, atol=ATOL)


def test_fused_route_is_taken(monkeypatch):
    """'auto' on a fusable model serves tile-local requests through the
    whole-unfold operator, never the eval forward."""
    _, tp = _predictors("auto")
    monkeypatch.setattr(tp, "_predict_eval", lambda merged: pytest.fail("eval route taken"))
    out = tp(_T)
    assert out.shape == (len(_T), 2)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-6)


def test_graph_larger_than_a_tile_takes_eval_route_in_both():
    jp, tp = _predictors("auto", big=True)
    jm = jp._merge(_BIG_J)
    tm = tp._merge(_BIG_T)
    assert jp._predict_fused(jm) is None and tp._predict_fused(tm) is None
    np.testing.assert_allclose(tp(_BIG_T), jp(_BIG_J), rtol=RTOL, atol=ATOL)


def test_warmup_and_overflow():
    jp, tp = _predictors("auto")
    assert tp.warmup() is tp
    with pytest.raises(ValueError, match="graphs > template"):
        tp(_T + _T[:1])
    small = tserving.Predictor(tp.model, max_nodes=128, max_arcs=64, max_graphs=4, device="cpu")
    with pytest.raises(ValueError, match="overflows template"):
        small(_T[:4])


def test_fused_node_focus_matches_jax():
    """The counterpart of the JAX package's node-focused fused-route test:
    the node focus served through the whole-unfold kernel in both packages,
    and close to the eval route (bf16 blocks against f32 BCSR)."""
    raw = node_targets(raw_molecules(n_graphs=10, seed=5), seed=5)
    jg, tg = graphs(jgraph, raw, focus="n"), graphs(tgraph, raw, focus="n")
    jmodel, tmodel = flagship_pair(seed=5, node_focus=True)
    jp = jserving.Predictor.for_graphs(jmodel, jg, batch_size=len(jg), fused=True)
    tp = tserving.Predictor.for_graphs(tmodel, tg, batch_size=len(tg), fused=True, device="cpu")
    assert tp.focus == jp.focus == "n" and tp.fused and jp.fused
    got = tp(tg)
    assert got.shape == (sum(len(g.nodes) for g in tg), 2)
    np.testing.assert_allclose(got, jp(jg), rtol=RTOL, atol=ATOL)
    eval_route = tserving.Predictor.for_graphs(tmodel, tg, batch_size=len(tg), fused=False, device="cpu")
    assert np.abs(got - eval_route(tg)).max() < 0.05


def test_tiles_per_step_is_stored_as_in_jax():
    jp, tp = _predictors("auto")
    assert tp.tiles_per_step == jp.tiles_per_step == 8
    jmodel, tmodel = flagship_pair(seed=3)
    jp3 = jserving.Predictor(jmodel, 256, 512, 4, tiles_per_step=3)
    tp3 = tserving.Predictor(tmodel, 256, 512, 4, tiles_per_step=3, device="cpu")
    assert tp3.tiles_per_step == jp3.tiles_per_step == 3
    np.testing.assert_allclose(tp3(_T[:4]), jp3(_J[:4]), rtol=RTOL, atol=ATOL)
