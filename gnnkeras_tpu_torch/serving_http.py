"""HTTP serving endpoint, counterpart of ``gnnkeras_tpu.serving_http``: a
stdlib threaded server in front of the ``Predictor`` / ``MicroBatcher``
tier.  Every handler thread submits to one shared ``MicroBatcher``, so
concurrent requests coalesce into one served batch (or, with
``micro_batch=False``, call the ``Predictor``, whose lock serialises them).

Protocol (JSON):

- ``GET /healthz``  → ``{"status": "ok"}``
- ``GET /metadata`` → template sizes, focus, dims, fused flag
- ``POST /predict`` → request ``{"graphs": [{"nodes": [[...]], "arcs":
  [[src, dst, label...] ...]}, ...]}``; response ``{"outputs": [[[...]] per
  graph]}``: per-graph output rows (one row for graph focus, one per node
  or arc for node or arc focus), in request order.  A malformed request
  gets 400, one that overflows the template 413, an unknown path 404.

Requests carry no targets; zero targets of the template's target width
satisfy the ``GraphObject`` constructor.

Usage, on the card::

    from gnnkeras_tpu_torch.serving import Predictor
    from gnnkeras_tpu_torch.serving_http import serve

    p = Predictor.for_graphs(model, samples, batch_size=16).warmup()
    serve(p, port=8080)            # blocks; or GraphServer(p, port=8080).start()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from gnnkeras_tpu_torch.graph.graph import GraphObject
from gnnkeras_tpu_torch.serving import MicroBatcher, Predictor


class GraphServer:
    """Threaded HTTP server over a Predictor (wrapped in a MicroBatcher)."""

    def __init__(
        self,
        predictor: Predictor,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_delay_ms: float = 2.0,
        micro_batch: bool = True,
    ):
        self.predictor = predictor
        self.batcher: Optional[MicroBatcher] = (
            MicroBatcher(predictor, max_delay_ms=max_delay_ms) if micro_batch else None
        )
        t_dim = predictor.dims[2] if predictor.dims else 1
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet by default
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/metadata":
                    p = outer.predictor
                    self._send(200, {
                        "focus": p.focus,
                        "max_nodes": p.max_nodes,
                        "max_arcs": p.max_arcs,
                        "max_graphs": p.max_graphs,
                        "aggregation_mode": p.aggregation_mode,
                        "dims": list(p.dims) if p.dims else None,
                        "fused": bool(p.fused),
                        "micro_batched": outer.batcher is not None,
                    })
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    graphs = [outer._to_graph(g, t_dim) for g in req["graphs"]]
                except (KeyError, ValueError, TypeError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    out = (outer.batcher or outer.predictor)(graphs)
                except ValueError as e:  # template overflow
                    self._send(413, {"error": str(e)})
                    return
                # the concatenated rows split back per graph, in request order
                splits = np.cumsum([outer._rows_of(g) for g in graphs])[:-1]
                self._send(200, {"outputs": [part.tolist() for part in np.split(np.asarray(out), splits)]})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- request decoding -------------------------------------------------------
    def _to_graph(self, payload: dict, t_dim: int) -> GraphObject:
        nodes = np.asarray(payload["nodes"], dtype=float)
        arcs = np.asarray(payload["arcs"], dtype=float)
        if arcs.ndim != 2 or arcs.shape[1] < 2:
            raise ValueError("arcs must be rows of [src, dst, label...]")
        focus = self.predictor.focus
        rows = {"g": 1, "n": nodes.shape[0], "a": arcs.shape[0]}[focus]
        return GraphObject(nodes=nodes, arcs=arcs, targets=np.zeros((rows, t_dim)), focus=focus,
                           aggregation_mode=self.predictor.aggregation_mode)

    def _rows_of(self, g: GraphObject) -> int:
        focus = self.predictor.focus
        if focus == "g":
            return g.num_graphs
        # the constructor's dedup may have dropped duplicate arc rows
        return g.arcs.shape[0] if focus == "a" else g.nodes.shape[0]

    # -- lifecycle ----------------------------------------------------------------
    @property
    def address(self):
        return self._httpd.server_address

    def start(self) -> "GraphServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def serve(predictor: Predictor, host: str = "127.0.0.1", port: int = 8080, **kwargs) -> None:
    """Blocking convenience wrapper: serve ``predictor`` over HTTP."""
    server = GraphServer(predictor, host, port, **kwargs)
    print(f"serving on http://{server.address[0]}:{server.address[1]} "
          f"(focus={predictor.focus}, fused={predictor.fused})")
    try:
        server.serve_forever()
    finally:
        server.close()
