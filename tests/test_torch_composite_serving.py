"""Serving the composite and layered models in the port against the JAX
package: ``Predictor`` (always the eval forward: these models do not fold)
for a composite GNN in graph and arc focus, a composite LGNN and a
homogeneous LGNN, on the same requests and weights; the composite warmup's
need of a ``warmup_graph``; ``MicroBatcher`` over composite requests; and
``export_forward`` / ``load_exported`` of a dim_state 0 CLGNN against
``model.forward`` and the JAX artifact, also loaded in a process that
imports no model class.

3 node types by atom class ('composite_average'); dim_state 0 throughout
(a dim_state > 0 forward draws its initial state, and an export of one
raises for want of a generator, as the JAX export does for want of an
rng).

Tolerances: f32 in both, sums in other orders, rtol 1e-5 / atol 1e-6
(the single GNN's: the stacks served here are 2 layers deep, and their
outputs stay within it).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.serving as tserving
from torch_port_common import arc_targets, cgnn_pair, composite_graphs, composite_merged_pair, graphs, lgnn_pair, \
    raw_molecules

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RAW = raw_molecules(n_graphs=12, seed=21)
_RAW_ARC = arc_targets(_RAW, seed=21)


def _requests(kind):
    """The JAX and the port's graphs of a model kind."""
    if kind == "lgnn":
        return graphs(jgraph, _RAW), graphs(tgraph, _RAW)
    raw, focus = (_RAW_ARC, "a") if kind == "cgnn_arc" else (_RAW, "g")
    return composite_graphs(jgraph, raw, focus=focus), composite_graphs(tgraph, raw, focus=focus)


@pytest.fixture(scope="module")
def models():
    """``get(kind)``: the JAX and the port's model of a kind, built once
    for the module (serving reads their weights and changes none)."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = {
                "cgnn": lambda: cgnn_pair("g", ds=0, seed=3),
                "cgnn_arc": lambda: cgnn_pair("a", ds=0, seed=3),
                "clgnn": lambda: lgnn_pair(True, "g", 0, 2, seed=3, n_types=3),
                "lgnn": lambda: lgnn_pair(False, "g", 0, 2, seed=3),
            }[kind]()
        return built[kind]

    return get


@pytest.mark.parametrize("kind", ["cgnn", "cgnn_arc", "clgnn", "lgnn"])
def test_predictor_matches_jax(kind, models):
    jg, tg = _requests(kind)
    jm, tm = models(kind)
    jp = jserving.Predictor.for_graphs(jm, jg, batch_size=len(jg))
    tp = tserving.Predictor.for_graphs(tm, tg, batch_size=len(tg), device="cpu")
    assert not tp.fused and not jp.fused and tp.focus == jp.focus
    got = tp(tg)
    assert got.shape[0] == sum(len(g.targets) for g in tg)
    np.testing.assert_allclose(got, jp(jg), rtol=RTOL, atol=ATOL)
    # a single-graph request, and rows in request order
    np.testing.assert_allclose(tp(tg[4]), jp(jg[4]), rtol=RTOL, atol=ATOL)
    order = [5, 0, 11, 3]
    reordered = tp([tg[i] for i in order])
    np.testing.assert_allclose(reordered, jp([jg[i] for i in order]), rtol=RTOL, atol=ATOL)
    rows = np.cumsum([0] + [len(g.targets) for g in tg])
    np.testing.assert_allclose(reordered, np.concatenate([got[rows[i]:rows[i + 1]] for i in order]), rtol=RTOL,
                               atol=ATOL)


def test_composite_warmup_needs_a_warmup_graph(models):
    _, tg = _requests("cgnn")
    _, tm = models("cgnn")
    bare = tserving.Predictor(tm, 2048, 4096, 12, aggregation_mode="composite_average", dims=(14, 3, 2),
                              device="cpu")
    with pytest.raises(ValueError, match="warmup_graph"):
        bare.warmup()
    _, tl = models("clgnn")
    with pytest.raises(ValueError, match="warmup_graph"):
        tserving.Predictor(tl, 2048, 4096, 12, dims=(14, 3, 2), device="cpu").warmup()
    p = tserving.Predictor.for_graphs(tm, tg, batch_size=len(tg), device="cpu")
    assert p._warmup_graph is tg[0]
    assert p.warmup() is p


def test_microbatcher_serves_composite_requests(models):
    _, tg = _requests("cgnn")
    _, tm = models("cgnn")
    p = tserving.Predictor.for_graphs(tm, tg, batch_size=len(tg), device="cpu")
    mb = tserving.MicroBatcher(p, max_delay_ms=20.0)
    try:
        futures = [mb.submit(tg[i:i + 3]) for i in range(0, len(tg), 3)]
        outs = [f.result(timeout=60) for f in futures]
    finally:
        mb.close()
    for i, out in zip(range(0, len(tg), 3), outs):
        np.testing.assert_allclose(out, p(tg[i:i + 3]), rtol=RTOL, atol=ATOL)
    assert 1 <= mb.launches <= len(futures)


_LOADER = r"""
import sys
import torch
from gnnkeras_tpu_torch.serving import load_exported

path = sys.argv[1]
batch, want = torch.load(path + "/inputs.pt", weights_only=False)
out, _ = load_exported(path, device="cpu").call(batch)
torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
print(sorted(m for m in sys.modules if m.startswith("gnnkeras_tpu_torch.models")))
"""


def test_clgnn_export_matches_forward_and_jax_artifact(tmp_path, models):
    jm, tm = models("clgnn")
    jgm, tgm = composite_merged_pair(_RAW, focus="g")
    jb = jbatch.from_graph_object(jgm, slot_pack=128, strip_dtype="float32")
    tb = tbatch.from_graph_object(tgm, slot_pack=128, strip_dtype="float32", device="cpu")
    tserving.export_forward(tm, tb, str(tmp_path / "port"))
    jserving.export_forward(jm, jb, str(tmp_path / "jax"))
    loaded = tserving.load_exported(str(tmp_path / "port"), device="cpu")
    out, out_mask = loaded.call(tb)
    _, _, outs, want_mask, _ = tm.forward(tb)
    jout, jmask = jserving.load_exported(str(tmp_path / "jax")).call(jb)
    rows = out_mask.numpy()
    assert torch.equal(out_mask, want_mask)
    np.testing.assert_array_equal(rows, np.asarray(jmask))
    np.testing.assert_allclose(out.numpy()[rows], outs[-1].numpy()[rows], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jout)[rows], rtol=RTOL, atol=ATOL)
    meta = loaded.meta
    assert meta["model_class"] == "CompositeLGNN" and meta["focus"] == "g"
    assert meta["n_params"] == len(tm.state_dict())
    program = torch.export.load(str(tmp_path / "port" / "forward.pt2"))
    ops = [str(n.target) for n in program.graph.nodes if "gnnkeras_tpu_torch" in str(n.target)]
    # the strip kernel once per aggregation: layer 0 peels iteration 0 from
    # the host sums, layer 1 (whose labels changed) does not
    assert ops == ["gnnkeras_tpu_torch.strip_matmul.default"] * 9
    # loaded in a process that imports no model class
    torch.save((tb, out), str(tmp_path / "port" / "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _LOADER, str(tmp_path / "port")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_export_of_a_random_initial_state_raises(tmp_path):
    _, tm = lgnn_pair(True, "g", 10, 2, seed=6)
    _, tgm = composite_merged_pair(_RAW, focus="g", n_types=1)
    tb = tbatch.from_graph_object(tgm, slot_pack=128, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tserving.export_forward(tm, tb, str(tmp_path))
