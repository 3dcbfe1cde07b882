"""Serving demo: train the starter GNN briefly, then stand up the serving
tiers of the port on it; the port of the repository's ``examples/serve.py``.

    python -m gnnkeras_tpu_torch.tools.serve [--epochs N] [--requests K] [--device cuda]

1. ``Predictor``: an in-process fixed-shape endpoint; requests (lists of
   GraphObjects) are merged and padded to a template, and small requests
   run the whole unfolding in one launch of the fused kernel
   (``ops/fused.py``, ``csrc/fused_unfold.cu``);
2. ``export_forward`` / ``load_exported``: a ``torch.export`` artifact of
   the eval forward and the trained weights, loadable in a process that
   never imports the model classes;
3. ``serving_http.GraphServer``: JSON in, per-graph outputs back.

``main`` loads Mutagenicity from a ``MUTAG_raw`` dump in the working
directory (``FileNotFoundError`` without one); ``run(graphs, device=...)``
is the body for any list of one-hot graph-focused graphs.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import urllib.request

import numpy as np


def run(graphs, device="cuda", epochs: int = 3, requests: int = 20, seed: int = 42, verbose: int = 1) -> dict:
    """Train the flagship on ``graphs``' training split (``dataset_splits``
    with ``seed``), then serve ``requests`` random requests of 1-8 test
    graphs through the Predictor, the artifact's call on a template of 8
    test graphs, and one HTTP request.  Returns the model, the Predictor,
    the requests (lists of test-graph indices) with their outputs, the
    accuracy, the artifact's outputs and the HTTP response."""
    from gnnkeras_tpu_torch import (MLP, GNNgraphBased, MultiGraphSequencer, Predictor, export_forward,
                                    get_inout_dims, load_exported)
    from gnnkeras_tpu_torch.data.mutag import dataset_splits
    from gnnkeras_tpu_torch.graph.batch import graphs_to_batch
    from gnnkeras_tpu_torch.serving_http import GraphServer

    for g in graphs:
        g.setAggregation("average")
    gTr, gTe, _ = dataset_splits(graphs, seed=seed)

    ins, ls = get_inout_dims("state", 14, 3, 2, "g", 0)
    ino, lo = get_inout_dims("output", 14, 3, 2, "g", 0)
    gnn = GNNgraphBased(
        MLP(input_dim=ins[0], layers=ls, activations="selu",
            kernel_initializer="lecun_normal", bias_initializer="lecun_normal"),
        MLP(input_dim=ino[0], layers=lo, activations="softmax",
            kernel_initializer="glorot_normal", bias_initializer="glorot_normal"),
        0, 5, 0.0).build(seed=0, device=device)
    gnn.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    gnn.fit(MultiGraphSequencer(gTr, "g", "average", batch_size=1000, device=device), epochs=epochs, verbose=verbose)

    # -- tier 1: in-process endpoint ----------------------------------------
    p = Predictor.for_graphs(gnn, gTe, batch_size=8, fused="auto", device=device).warmup()
    if verbose:
        print(f"Predictor template: {p.max_nodes} nodes / {p.max_arcs} arcs / {p.max_graphs} graphs, "
              f"fused={p.fused}")
    rng = np.random.default_rng(0)
    taken, outputs = [], []
    n_correct = n_total = 0
    t0 = time.perf_counter()
    for _ in range(requests):
        take = [int(i) for i in rng.choice(len(gTe), size=int(rng.integers(1, 9)), replace=False)]
        req = [gTe[i] for i in take]
        probs = p(req)  # (len(req), 2), rows in request order
        want = np.concatenate([g.targets for g in req]).argmax(1)
        n_correct += int((probs.argmax(1) == want).sum())
        n_total += len(req)
        taken.append(take)
        outputs.append(probs)
    request_s = time.perf_counter() - t0
    if verbose:
        print(f"{requests} requests in {request_s * 1e3:.1f} ms wall "
              f"({request_s / requests * 1e3:.2f} ms/request incl. host work); accuracy {n_correct / n_total:.3f}")

    # -- tier 2: portable artifact -------------------------------------------
    template = graphs_to_batch(gTe[:8], "g", "average", device=device)
    with tempfile.TemporaryDirectory() as d:
        export_forward(gnn, template, d)
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        loaded = load_exported(d, device=device)
        out, mask = loaded.call(template)
        artifact = (out.cpu().numpy(), mask.cpu().numpy())
        if verbose:
            print(f"exported artifact: {sorted(os.listdir(d))} ({size / 1024:.0f} KiB); "
                  f"reloaded forward output {tuple(out.shape)}")

    # -- tier 3: HTTP endpoint (JSON in, per-graph outputs back) -------------
    server = GraphServer(p, port=0).start()
    addr = server.address
    try:
        g0 = gTe[0]
        payload = {"graphs": [{"nodes": g0.nodes.tolist(), "arcs": g0.arcs.tolist()}]}
        req = urllib.request.Request(f"http://{addr[0]}:{addr[1]}/predict", data=json.dumps(payload).encode())
        resp = json.loads(urllib.request.urlopen(req, timeout=30).read())
        if verbose:
            print(f"HTTP endpoint on {addr}: predict -> {np.round(resp['outputs'][0], 4).tolist()}")
    finally:
        server.close()
    return {"model": gnn, "predictor": p, "test_graphs": gTe, "requests": taken, "outputs": outputs,
            "accuracy": n_correct / n_total, "request_s": request_s, "template": template,
            "artifact": artifact, "http": resp}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from gnnkeras_tpu_torch.data.mutag import load_mutag

    run(load_mutag(), device=args.device, epochs=args.epochs, requests=args.requests)


if __name__ == "__main__":
    main()
