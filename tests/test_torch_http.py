"""The port's HTTP endpoint (``serving_http.GraphServer``): the counterpart
of the JAX package's ``TestHttpServer`` on ephemeral ports of 127.0.0.1,
and its ``/predict`` outputs against the JAX package's ``Predictor`` for
the same JSON payload and weights.

Outputs: rtol 1e-5 / atol 1e-6 (f32 sums in other orders; the JSON carries
f32 values through float64 and back exactly).
"""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu_torch.graph.graph as tgraph
from gnnkeras_tpu_torch.serving import Predictor
from gnnkeras_tpu_torch.serving_http import GraphServer
from torch_port_common import flagship_pair, graphs, node_targets, raw_molecules

RTOL, ATOL = 1e-5, 1e-6


def _server(focus="g", micro_batch=True):
    raw = raw_molecules(n_graphs=8, seed=3)
    if focus == "n":
        raw = node_targets(raw, seed=3)
    jm, tm = flagship_pair(seed=0, node_focus=focus == "n")
    gs = graphs(tgraph, raw, focus=focus)
    p = Predictor.for_graphs(tm, gs, batch_size=len(gs), device="cpu").warmup()
    server = GraphServer(p, port=0, micro_batch=micro_batch).start()  # ephemeral port
    return server, p, gs, (jm, graphs(jgraph, raw, focus=focus))


def _url(server, path):
    host, port = server.address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, payload):
    req = urllib.request.Request(_url(server, "/predict"), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _payload(gs):
    return {"graphs": [{"nodes": g.nodes.tolist(), "arcs": g.arcs.tolist()} for g in gs]}


@pytest.mark.parametrize("focus", ["g", "n"])
def test_predict_matches_inprocess_and_jax(focus):
    server, p, gs, (jm, jg) = _server(focus)
    try:
        got = _post(server, _payload(gs[:3]))["outputs"]
        flat = np.concatenate([np.asarray(o) for o in got], axis=0)
        np.testing.assert_allclose(flat, p(gs[:3]), rtol=RTOL, atol=ATOL)
        jp = jserving.Predictor.for_graphs(jm, jg, batch_size=len(jg))
        np.testing.assert_allclose(flat, np.asarray(jp(jg[:3])), rtol=RTOL, atol=ATOL)
        # one row per graph, or one per node
        assert [len(o) for o in got] == [1 if focus == "g" else g.nodes.shape[0] for g in gs[:3]]
    finally:
        server.close()


def test_health_metadata_and_errors():
    server, p, gs, _ = _server()
    try:
        with urllib.request.urlopen(_url(server, "/healthz"), timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(_url(server, "/metadata"), timeout=10) as r:
            meta = json.loads(r.read())
        assert meta["focus"] == "g" and meta["max_graphs"] == 8 and meta["fused"] and meta["micro_batched"]
        assert meta["dims"] == [14, 3, 2]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"grphs": []})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"graphs": [{"nodes": [[1.0]], "arcs": [1, 2]}]})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(server, "/nowhere"), timeout=10)
        assert e.value.code == 404
    finally:
        server.close()


@pytest.mark.parametrize("micro_batch", [True, False])
def test_concurrent_clients(micro_batch):
    """8 clients at once: through the MicroBatcher, or straight into the
    Predictor, whose lock serialises the handler threads."""
    server, p, gs, _ = _server(micro_batch=micro_batch)
    try:
        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(lambda g: _post(server, _payload([g])), gs))
        for g, res in zip(gs, results):
            np.testing.assert_allclose(np.asarray(res["outputs"][0]), p([g]), rtol=RTOL, atol=ATOL)
        if micro_batch:
            assert server.batcher.launches <= len(gs)
        else:
            assert server.batcher is None
    finally:
        server.close()


def test_overflow_request_returns_413():
    server, p, gs, _ = _server()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, _payload(gs * 2))  # more graphs than the template holds
        assert e.value.code == 413
    finally:
        server.close()
