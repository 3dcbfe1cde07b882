"""The single large graph in both packages: ``from_graph_object(agg_dtype=…)``
routing, and the node-focused model (the architecture of the large-graph
workload, 8 node-label and 2 arc-label features) on a small banded graph
(the banded decomposition) and a small scattered one (quantised BCSR).

- each ``agg_dtype`` picks the same operator type as in JAX, with equal
  operator bits, on a banded graph, a wide-band one (7 tile offsets, more
  than the decomposition takes) and a scattered one;
- ``data/synthetic.large_banded_graph`` draws the graph of the JAX
  package's ``scripts/bench_large_graph.py`` (at 16 tiles);
- ``GNNnodeBased`` unfold (k and state, inference and training), forward
  and one Adam step equal JAX's; the feature-major engine is taken for
  every quantised operator;
- ``single_graph_batch`` views with set masks, and ``fit`` over two of them;
- ``export_forward`` over a quantised and a banded batch equals
  ``model.forward``, with the kernels as custom-op nodes.

Tolerances.  f32 in both packages, sums in other orders: outputs and
losses rtol 1e-5 / atol 1e-6; states rtol 1e-5 / atol 1e-5, since over 5
chained iterations (BatchNorm on batch moments in training) on states of
magnitude ~1-4 the two packages' sums part by up to 1.6e-6; Adam's first step is about lr·sign(g),
so parameters are compared where |g| is at least 1e-6 of its leaf's
largest (the test counts the excluded entries: none here), rtol 1e-5 /
atol 1e-6.  The exported program runs the forward's own operations:
rtol 1e-5 / atol 1e-6.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.models.gnn as jgnn
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.models.gnn as tgnn
import gnnkeras_tpu_torch.models.mlp as tmlp
import gnnkeras_tpu_torch.data.synthetic as tsynthetic
import gnnkeras_tpu_torch.serving as tserving
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import Batches, _nets, np_of, np_of_jax, perturb_bn

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
STATE_ATOL = 1e-5


def _arrays(kind, seed=0):
    """(nodes, arcs, targets) of a node-focused graph: ``banded`` (12 tiles,
    band 30, wrapping: offsets -1, 0, 1 and a residual of wraparound blocks), ``wide_band`` (12 tiles, band 384: 7 tile offsets)
    or ``scattered`` (20 tiles, one block per destination tile at a
    pseudo-random source tile, as the JAX package's quantised-engine test
    builds it)."""
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        n = 20 * 128
        dst = np.arange(n)
        src = ((dst // 128 * 2) % 20) * 128 + rng.integers(0, 128, n)
    else:
        n_tiles, per_node, band = (12, 3, 30) if kind == "banded" else (12, 6, 384)
        n = n_tiles * 128
        src = np.repeat(np.arange(n), per_node)
        dst = src + rng.integers(-band, band + 1, len(src))
        keep = (dst >= 0) & (dst < n) if kind == "wide_band" else slice(None)
        src, dst = src[keep], dst[keep] % n
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    arcs = np.concatenate([pairs.astype(np.float32), rng.normal(size=(len(pairs), 2)).astype(np.float32)], 1)
    nodes = rng.normal(size=(n, 8)).astype(np.float32)
    targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return nodes, arcs, targets


def _graph_pair(kind, seed=0):
    nodes, arcs, targets = _arrays(kind, seed)
    kw = dict(focus="n", aggregation_mode="average")
    return (jgraph.GraphObject(nodes=nodes, arcs=arcs, targets=targets, **kw),
            tgraph.GraphObject(nodes=nodes, arcs=arcs, targets=targets, **kw))


_WANT_TYPE = {  # (graph, agg_dtype) -> operator type, in both packages
    "banded": {None: "BcsrMatrix", "auto": "BandedOperator", "int8": "BandedOperator", "bfloat16": "BcsrMatrix",
               "float32": "BcsrMatrix"},
    "wide_band": {None: "BcsrMatrix", "auto": "BcsrMatrix", "int8": "QuantBcsr", "bfloat16": "BcsrMatrix",
                  "float32": "BcsrMatrix"},
    "scattered": {None: "BcsrMatrix", "auto": "BcsrMatrix", "int8": "QuantBcsr", "bfloat16": "BcsrMatrix",
                  "float32": "BcsrMatrix"},
}


def _tensors_of(op):
    """Every tensor of an operator, in field order, as NumPy (bf16 as bits)."""
    if type(op).__name__ == "BandedOperator":
        out = []
        for d in op.diags:
            out += [d.strip, d.scale]
        return out + _tensors_of(op.residual) if op.residual is not None else out
    names = {"BcsrMatrix": ("blocks", "src_tile", "dst_tile"),
             "QuantBcsr": ("mask", "scale", "src_tile", "dst_tile")}[type(op).__name__]
    return [getattr(op, name) for name in names]


@pytest.mark.parametrize("agg_dtype", [None, "auto", "int8", "bfloat16", "float32"])
@pytest.mark.parametrize("kind", list(_WANT_TYPE))
def test_agg_dtype_picks_the_jax_operator(kind, agg_dtype):
    jg, tg = _graph_pair(kind)
    jb = jbatch.from_graph_object(jg, agg_dtype=agg_dtype)
    tb = tbatch.from_graph_object(tg, agg_dtype=agg_dtype, device="cpu")
    want = _WANT_TYPE[kind][agg_dtype]
    assert type(tb.bcsr).__name__ == type(jb.bcsr).__name__ == want
    if want == "BandedOperator":
        assert tb.bcsr.offsets == jb.bcsr.offsets == (-1, 0, 1) and tb.bcsr.residual is not None
    for got, ref in zip(_tensors_of(tb.bcsr), _tensors_of(jb.bcsr)):
        assert (got is None) == (ref is None)
        if got is not None:
            ref = np_of_jax(ref)
            # JAX pads its diagonals to 16 tiles with zero tiles
            np.testing.assert_array_equal(np_of(got), ref[: got.shape[0]])
    if agg_dtype == "bfloat16":
        assert tb.bcsr.blocks.dtype == torch.bfloat16


def _bench_large_graph():
    """The JAX package's large-graph benchmark script as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "bench_large_graph.py")
    spec = importlib.util.spec_from_file_location("bench_large_graph", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("band,agg_dtype,want", [(64, "auto", "BandedOperator"), (384, "int8", "QuantBcsr")])
def test_large_banded_graph_is_the_jax_workload(band, agg_dtype, want, monkeypatch):
    """``data/synthetic.large_banded_graph`` at 16 tiles draws the graph of
    ``scripts/bench_large_graph.build`` at the same size: the same arcs,
    node labels and targets, and under ``agg_dtype`` the same operator."""
    jlarge = _bench_large_graph()
    monkeypatch.setattr(jlarge, "N_NODES", 2048)
    monkeypatch.setattr(jlarge, "BAND", band)
    _, jb, n_arcs = jlarge.build(agg_dtype=agg_dtype)
    g = tsynthetic.large_banded_graph(2048, band=band)
    tb = tbatch.from_graph_object(g, agg_dtype=agg_dtype, device="cpu")
    assert g.arcs.shape[0] == n_arcs
    for name in ("nodes", "targets", "arc_src", "arc_dst", "arcnode_weight", "agg_arc_labels"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    assert type(tb.bcsr).__name__ == type(jb.bcsr).__name__ == want
    for got, ref in zip(_tensors_of(tb.bcsr), _tensors_of(jb.bcsr)):
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(np_of(got), np_of_jax(ref)[: got.shape[0]])


def test_agg_dtype_rejects_unknown_names():
    _, tg = _graph_pair("banded")
    with pytest.raises(ValueError, match="agg_dtype"):
        tbatch.from_graph_object(tg, agg_dtype="int4", device="cpu")


def _model_pair(seed=0, max_iteration=5, threshold=0.0):
    jm = jgnn.GNNnodeBased(*_nets(jmlp, dims=(8, 2, 2), focus="n"), 0, max_iteration, threshold)
    jm.build(seed=seed)
    jm.variables = perturb_bn(jm.variables, seed)
    tm = tgnn.GNNnodeBased(*_nets(tmlp, dims=(8, 2, 2), focus="n"), 0, max_iteration, threshold)
    tm.build(seed=seed, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


_ROUTES = {"banded": ("banded", "auto", "BandedOperator"), "quantised": ("scattered", "int8", "QuantBcsr")}


def _batch_pair(route):
    kind, agg_dtype, want = _ROUTES[route]
    jg, tg = _graph_pair(kind, seed=3)
    jb = jbatch.from_graph_object(jg, agg_dtype=agg_dtype)
    tb = tbatch.from_graph_object(tg, agg_dtype=agg_dtype, device="cpu")
    assert type(tb.bcsr).__name__ == want
    return jb, tb


@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("route", list(_ROUTES))
def test_unfold_and_forward_match_jax(route, threshold):
    jb, tb = _batch_pair(route)
    jm, tm = _model_pair(threshold=threshold)
    assert tm._use_transposed(tb) and jm._use_transposed(jb)
    for training in (False, True):
        jk, jstate, _ = jax.jit(lambda v, b: jm.unfold(v, b, training=training))(jm.variables, jb)
        with torch.set_grad_enabled(False):
            tk, tstate, _ = tm.unfold(tb, training=training)
        assert float(tk) == float(jk)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=RTOL, atol=STATE_ATOL)
    jk, _, jout, jmask, _ = jax.jit(lambda v, b: jm.forward(v, b, training=False))(jm.variables, jb)
    tk, _, tout, tmask, _ = tm.forward(tb, training=False)
    assert tk == int(jk) and (threshold > 0 or tk == 5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    rows = tmask.numpy()
    np.testing.assert_allclose(tout.numpy()[rows], np.asarray(jout)[rows], rtol=RTOL, atol=ATOL)


def _port_params(tree):
    return variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, tree), "state": {}})


@pytest.mark.parametrize("route", list(_ROUTES))
def test_adam_step_matches_jax(route):
    jb, tb = _batch_pair(route)
    jm, tm = _model_pair(seed=1)
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    params, mstate = jm.variables["params"], jm.variables["state"]
    new_params, new_mstate, _, jlogs = jtr._train_step_body(jm)(params, mstate, jm.optimizer.init(params), jb,
                                                                 jax.random.PRNGKey(0))
    logs, aux = ttr.train_step(tm, tb)
    assert float(aux["k"]) == 5.0
    for key in ("loss_sum", "count", "accuracy_sum", "accuracy_count"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=RTOL, err_msg=key)
    want = _port_params(new_params)
    excluded = 0
    for name, p in tm.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), p.grad.numpy()
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        excluded += int((~live).sum())
        np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=ATOL, err_msg=name)
    assert excluded == 0
    want_stats = variables_from_jax({"state": jax.tree_util.tree_map(np.asarray, new_mstate), "params": {}})
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def _views(kind, agg_dtype, n_views=2, seed=5):
    """``n_views`` single-graph batch views with disjoint random set masks,
    in both packages."""
    jg, tg = _graph_pair(kind, seed=seed)
    n = tg.nodes.shape[0]
    part = np.random.default_rng(seed).integers(0, n_views, n)
    masks = [part == i for i in range(n_views)]
    jviews = [jbatch.from_graph_object(jg, set_mask_override=m, agg_dtype=agg_dtype) for m in masks]
    tviews = [tbatch.single_graph_batch(tg, m, agg_dtype=agg_dtype, device="cpu") for m in masks]
    return jviews, tviews, masks


def test_single_graph_batch_views_match_jax():
    jviews, tviews, masks = _views("banded", "auto")
    jg, tg = _graph_pair("banded", seed=5)
    plain = jbatch.single_graph_batch(jg, masks[0])
    assert type(tviews[0].bcsr).__name__ == "BandedOperator"
    for jv, tv, m in zip(jviews, tviews, masks):
        for name in ("set_mask", "target_mask", "output_mask", "node_mask", "targets", "nodes"):
            np.testing.assert_array_equal(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)), err_msg=name)
        assert tv.target_mask.numpy()[: len(m)].tolist() == m.tolist()
    # without agg_dtype the view keeps the f32 BCSR, as the JAX package's does
    tv = tbatch.single_graph_batch(tg, masks[0], device="cpu")
    np.testing.assert_array_equal(tv.bcsr.blocks.numpy(), np.asarray(plain.bcsr.blocks))
    np.testing.assert_array_equal(tv.target_mask.numpy(), np.asarray(plain.target_mask))


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fit_over_single_graph_views_matches_jax(route):
    kind, agg_dtype, _ = _ROUTES[route]
    jviews, tviews, _ = _views(kind, agg_dtype)
    jm, tm = _model_pair(seed=2)
    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    jh = jm.fit(Batches(jviews), epochs=1, verbose=0, scan_batches=False)
    th = tm.fit(Batches(tviews), epochs=1, verbose=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("route", list(_ROUTES))
def test_export_forward_equals_model_forward(route, tmp_path):
    _, tb = _batch_pair(route)
    _, tm = _model_pair(seed=4)
    tserving.export_forward(tm, tb, str(tmp_path))
    loaded = tserving.load_exported(str(tmp_path), device="cpu")
    out, mask = loaded.call(tb)
    _, _, want, want_mask, _ = tm.forward(tb)
    assert torch.equal(mask, want_mask)
    rows = mask.numpy()
    np.testing.assert_allclose(out.numpy()[rows], want.numpy()[rows], rtol=RTOL, atol=ATOL)
    program = torch.export.load(os.path.join(str(tmp_path), "forward.pt2"))
    ops = {str(n.target) for n in program.graph.nodes if "gnnkeras_tpu_torch" in str(n.target)}
    want_op = {"quantised": "gnnkeras_tpu_torch.qbcsr_matmul.default",
               "banded": "gnnkeras_tpu_torch.strip_matmul.default"}[route]
    assert ops == {want_op}
