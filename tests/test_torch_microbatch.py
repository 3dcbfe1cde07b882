"""The port's ``MicroBatcher`` (request coalescing in front of a
``Predictor``): the counterparts of the JAX package's ``TestMicroBatcher``
and ``TestMicroBatcherRobustness``, and its coalesced outputs against the
JAX package's ``MicroBatcher`` on the same requests and weights.

Outputs: one coalesced batch against single-request batches of the same
weights, f32 sums in other orders: rtol 1e-5 / atol 1e-6, as the JAX tests
hold theirs; against JAX the same (the fused route's bf16 blocks are the
same in both packages).
"""

import numpy as np
import pytest

import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu_torch.graph.graph as tgraph
from gnnkeras_tpu_torch.serving import MicroBatcher, Predictor
from torch_port_common import flagship_pair, graphs, node_targets, raw_molecules

RTOL, ATOL = 1e-5, 1e-6


def _predictor(raw, seed=3, node_focus=False):
    _, tm = flagship_pair(seed=seed, node_focus=node_focus)
    gs = graphs(tgraph, raw, focus="n" if node_focus else "g")
    return Predictor.for_graphs(tm, gs, batch_size=len(gs), device="cpu"), gs


@pytest.mark.parametrize("focus", ["g", "n"])
def test_coalesced_results_match_individual(focus):
    raw = raw_molecules(n_graphs=12, seed=21)
    if focus == "n":
        raw = node_targets(raw, seed=21)
    p, gs = _predictor(raw, node_focus=focus == "n")
    want = [p([g]) for g in gs]
    mb = MicroBatcher(p, max_delay_ms=100.0)
    futs = [mb.submit(g) for g in gs]
    got = [f.result(timeout=60) for f in futs]
    mb.close()
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # coalesced into far fewer served batches than requests
    assert mb.launches < len(gs)


def test_coalesced_outputs_match_the_jax_micro_batcher():
    raw = raw_molecules(n_graphs=10, seed=23)
    jm, tm = flagship_pair(seed=5)
    jg, tg = graphs(jgraph, raw), graphs(tgraph, raw)
    jp = jserving.Predictor.for_graphs(jm, jg, batch_size=len(jg))
    tp = Predictor.for_graphs(tm, tg, batch_size=len(tg), device="cpu")
    requests = [[0], [1, 2], [3], [4, 5, 6], [7], [8, 9]]
    got, want = [], []
    for cls, p, gs, out in ((MicroBatcher, tp, tg, got), (jserving.MicroBatcher, jp, jg, want)):
        mb = cls(p, max_delay_ms=100.0)
        futs = [mb.submit([gs[i] for i in req]) for req in requests]
        out.extend(f.result(timeout=120) for f in futs)
        mb.close()
    for g, w, req in zip(got, want, requests):
        assert g.shape == (len(req), 2)
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def test_oversized_request_fails_alone():
    raw = raw_molecules(n_graphs=6, seed=22)
    p, gs = _predictor(raw[:3])  # a template of 3 graphs
    all_six = graphs(tgraph, raw)
    mb = MicroBatcher(p, max_delay_ms=50.0)
    ok = mb.submit(all_six[0])
    too_big = mb.submit(all_six)
    ok2 = mb.submit(all_six[1])
    r1, r2 = ok.result(timeout=60), ok2.result(timeout=60)
    with pytest.raises(ValueError, match="graphs > template"):
        too_big.result(timeout=60)
    mb.close()
    np.testing.assert_allclose(r1, p([all_six[0]]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r2, p([all_six[1]]), rtol=RTOL, atol=ATOL)


def test_cancelled_future_does_not_kill_worker():
    p, gs = _predictor(raw_molecules(n_graphs=6, seed=11)[:4])
    p.warmup()
    mb = MicroBatcher(p, max_delay_ms=20.0)
    try:
        f1 = mb.submit([gs[0]])
        f1.cancel()  # may or may not win the race with the worker
        out = mb([gs[1]])  # served either way
        assert out.shape == (1, 2) and np.all(np.isfinite(out))
    finally:
        mb.close()


def test_close_resolves_stragglers():
    p, gs = _predictor(raw_molecules(n_graphs=4, seed=12))
    mb = MicroBatcher(p, max_delay_ms=1.0)
    mb.submit([gs[0]]).result(timeout=30)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([gs[1]])
    # a request left in the queue at close() is failed, not left waiting
    from concurrent.futures import Future

    straggler = Future()
    mb._queue.put(([gs[2]], straggler))
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        straggler.result(timeout=5)
