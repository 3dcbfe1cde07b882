"""The port's ``GNNConfig`` (``gnnkeras_tpu_torch.config``) against the JAX
package's, and the small user-surface pieces beside it: ``set_floatx``,
``parallel.device_count`` and ``utils/profiling``.

- JSON written by either package's config reads in the other, and invalid
  settings raise the same errors;
- ``build_model`` builds the same classes with the same variable shapes at
  every focus, composite and layered; with the JAX model's weights copied
  in (``convert.variables_from_jax``) the port's eval forward on the
  config's own sequencer batch equals JAX's at rtol 1e-5 / atol 1e-6 (f32
  in both, only the sum order differs: phase 4's CPU tolerance);
- ``build_sequencer`` gives the same batches, bit for bit.
"""

import dataclasses
import functools
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import gnnkeras_tpu.config as jconfig
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu_torch.config as tconfig
import gnnkeras_tpu_torch.graph.graph as tgraph
from gnnkeras_tpu_torch import GNNConfig
from gnnkeras_tpu_torch.convert import variables_from_jax, variables_to_jax
from torch_port_common import (arc_targets, assert_batches_equal, composite_graphs, feed_init_draw, graphs,
                               jax_init_draw, node_targets, raw_molecules, run_jitted, unique_pairs)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
_RAW = unique_pairs(raw_molecules(n_graphs=10, seed=11))


def test_top_level_name():
    import gnnkeras_tpu_torch

    assert gnnkeras_tpu_torch.GNNConfig is tconfig.GNNConfig
    assert [f.name for f in dataclasses.fields(GNNConfig)] == [f.name for f in dataclasses.fields(jconfig.GNNConfig)]


def test_json_round_trip_between_packages():
    kw = dict(focus="n", dim_state=7, layers=3, training_mode="residual", metrics=("accuracy", "mse"),
              hidden_units=[12, 6], slot_pack=0, strip_dtype="bfloat16", agg_dtype=None, parallel="dp",
              parallel_devices=2, per_iteration_bn=True, transposed=False)
    t, j = GNNConfig(**kw), jconfig.GNNConfig(**kw)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert dataclasses.asdict(jconfig.GNNConfig.from_json(t.to_json())) == dataclasses.asdict(t)
    assert dataclasses.asdict(GNNConfig.from_json(j.to_json())) == dataclasses.asdict(j)
    assert GNNConfig.from_json(GNNConfig().to_json()) == GNNConfig()


@pytest.mark.parametrize("bad", [
    dict(focus="x"), dict(training_mode="eager"), dict(dim_state=-1), dict(layers=0), dict(slot_pack=64),
    dict(strip_dtype="int4"), dict(transposed="yes"), dict(agg_dtype="fp8"), dict(parallel="typo"),
    dict(parallel="pipeline", layers=1), dict(parallel="packed", focus="n"),
    dict(parallel="packed", layers=2, training_mode="serial"), dict(parallel_devices=-1),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_validation_errors_alike(bad):
    with pytest.raises(ValueError) as t_err:
        GNNConfig(**bad)
    with pytest.raises(ValueError) as j_err:
        jconfig.GNNConfig(**bad)
    assert str(t_err.value) == str(j_err.value)


# (config, dim_node_label, dims) cases: every focus, composite (1 and 3
# types) and layered
_CASES = {
    "graph": (dict(), 14),
    "arc": (dict(focus="a"), 14),
    "node": (dict(focus="n", hidden_units=[9]), 14),
    "graph_ds10_per_iteration_bn": (dict(dim_state=10, per_iteration_bn=True), 14),
    "lgnn_3": (dict(layers=3), 14),
    "lgnn_residual_ds4": (dict(layers=2, dim_state=4, training_mode="residual"), 14),
    "composite_1": (dict(dim_state=10), (14,)),
    "composite_3_arc": (dict(focus="a", dim_state=6), (5, 10, 14)),
    "clgnn_3": (dict(layers=3, dim_state=10), (14,)),
}


@functools.lru_cache(maxsize=None)
def _pair(case, composite_average=False):
    """The JAX and the port model of ``case``'s config, the port's with the
    JAX model's weights (built once a case: the models are only read)."""
    cfg_kw, node_dim = _CASES[case]
    if composite_average:
        cfg_kw = dict(cfg_kw, aggregation_mode="composite_average")
    jm = jconfig.GNNConfig(**cfg_kw).build_model(node_dim, 3, 2)
    jm.build(seed=3)
    tm = GNNConfig(**cfg_kw).build_model(node_dim, 3, 2, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


@pytest.mark.parametrize("case", list(_CASES))
def test_build_model_same_classes_and_widths(case):
    jm, tm = _pair(case)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.device.type == "cpu" and tm.optimizer is not None and tm.loss is not None
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jm.variables))
    got = jax.tree_util.tree_leaves(variables_to_jax(tm))
    assert [w.shape for w in want] == [g.shape for g in got]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if hasattr(jm, "gnns"):
        assert tm.training_mode == jm.training_mode
        assert [type(g).__name__ for g in tm.gnns] == [type(g).__name__ for g in jm.gnns]


def _graph_lists(focus, n_types=0):
    """Both packages' graphs of ``_RAW`` in ``focus``; composite of
    ``n_types`` types when > 0."""
    raw = arc_targets(_RAW) if focus == "a" else node_targets(_RAW) if focus == "n" else _RAW
    if n_types:
        return [composite_graphs(m, raw, focus=focus, n_types=n_types) for m in (jgraph, tgraph)]
    return [graphs(m, raw, focus=focus) for m in (jgraph, tgraph)]


@pytest.mark.parametrize("case", ["graph", "arc", "node", "lgnn_3", "composite_1"])
def test_forward_on_config_batches_matches_jax(case, monkeypatch):
    cfg_kw, node_dim = _CASES[case]
    composite = isinstance(node_dim, tuple)
    focus = cfg_kw.get("focus", "g")
    jg, tg = _graph_lists(focus, len(node_dim) if composite else 0)
    if composite:
        assert tuple(tg[0].DIM_NODE_LABEL) == node_dim
        cfg_kw = dict(cfg_kw, aggregation_mode="composite_average")
    jm, tm = _pair(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jb = jconfig.GNNConfig(**cfg_kw).build_sequencer(jg, shuffle=False)[0]
        tb = GNNConfig(**cfg_kw).build_sequencer(tg, shuffle=False, device="cpu")[0]
    assert_batches_equal(tb, jb)
    rng = jax.random.PRNGKey(4)
    ds = cfg_kw.get("dim_state", 0)
    if ds:  # the random initial state: JAX's draw in both
        feed_init_draw(monkeypatch, jax_init_draw(rng, tb.num_nodes, ds))
    jout = run_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r)[2:4], jm.variables, jb, rng)
    _, _, out, mask, _ = tm.forward(tb, training=False, generator=torch.Generator().manual_seed(0))
    out = tm.served_output(out)
    jo = jout[0][-1] if isinstance(jout[0], (list, tuple)) else jout[0]  # an LGNN's: its last layer's
    m = np.asarray(jout[1])
    np.testing.assert_array_equal(mask.numpy(), m)
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jo)[m], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["multi", "composite_multi", "single", "transductive_multi", "transductive_single"])
def test_build_sequencer_same_batches(kind):
    cfg_kw = dict(batch_size=4, focus="n")
    jg, tg = _graph_lists("n", 3 if kind == "composite_multi" else 0)
    if kind == "composite_multi":
        cfg_kw["aggregation_mode"] = "composite_average"
    if kind.endswith("single"):
        jg = jgraph.GraphObject.merge(jg, "n", "average")
        tg = tgraph.GraphObject.merge(tg, "n", "average")
    rate = 0.5 if kind.startswith("transductive") else None
    out = []
    for cfg, gl, extra in ((jconfig.GNNConfig(**cfg_kw), jg, {}), (GNNConfig(**cfg_kw), tg, {"device": "cpu"})):
        np.random.seed(5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            seq = cfg.build_sequencer(gl, transductive_rate=rate, **extra)
            out.append([seq[i] for i in range(len(seq))])
    assert len(out[0]) == len(out[1]) > 0
    for jb, tb in zip(*out):
        if kind.endswith("single"):  # one graph's batches: its supervised rows change
            for name in ("nodes", "set_mask", "target_mask", "targets", "arcnode_weight", "sample_weight"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), name)
            assert type(tb.bcsr).__name__ == type(jb.bcsr).__name__
        else:
            assert_batches_equal(tb, jb)


def test_transductive_refuses_composite():
    _, tg = _graph_lists("n", 3)
    with pytest.raises(ValueError, match="homogeneous"):
        GNNConfig(focus="n").build_sequencer(tg, transductive_rate=0.5, device="cpu")


@pytest.fixture
def floatx_restored():
    from gnnkeras_tpu_torch.utils import dtypes

    saved = dtypes.floatx()
    yield dtypes
    dtypes.set_floatx(saved)


def test_set_floatx(floatx_restored):
    import gnnkeras_tpu.utils.dtypes as jdtypes

    dtypes = floatx_restored
    assert dtypes.floatx() is np.float32 and dtypes.torch_floatx() is torch.float32
    dtypes.set_floatx("float64")
    assert dtypes.floatx() is np.float64 and dtypes.torch_floatx() is torch.float64
    g = tgraph.GraphObject(*_RAW[0], focus="g")
    assert g.nodes.dtype == g.arcs.dtype == g.arcnode_weight.dtype == np.float64
    jsaved = jdtypes.floatx()
    try:
        jdtypes.set_floatx("float64")
        j = jgraph.GraphObject(*_RAW[0], focus="g")
        np.testing.assert_array_equal(g.arcs, j.arcs)
        assert j.arcs.dtype == g.arcs.dtype
    finally:
        jdtypes.set_floatx(jsaved)


def test_device_count():
    from gnnkeras_tpu_torch import parallel
    from gnnkeras_tpu_torch.parallel.mesh import device_count

    assert parallel.device_count is device_count
    assert device_count() == torch.cuda.device_count()


def test_throughput_meter_matches_jax(monkeypatch):
    import gnnkeras_tpu.utils.profiling as jprof
    import gnnkeras_tpu_torch.utils.profiling as tprof

    clock = iter([1.0, 3.5, 10.0, 10.5])
    times = list(clock)
    reports = []
    for mod in (jprof, tprof):
        it = iter(times)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        m = mod.ThroughputMeter()
        assert m.edges_per_s == 0.0 and m.steps_per_s == 0.0
        m.start()
        m.step(1000, 5)
        m.step(200)
        m.stop()
        m.start()
        m.stop()
        reports.append(m.report())
        monkeypatch.undo()
    assert reports[0] == reports[1] == {"edges_per_s": 5200 / 3.0, "steps_per_s": 2 / 3.0, "steps": 2,
                                        "elapsed_s": 3.0}


def test_profiling_trace_names_the_annotated_span(tmp_path):
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules
    from gnnkeras_tpu_torch.graph.batch import graphs_to_batch
    from gnnkeras_tpu_torch.utils.profiling import annotate, trace

    model = flagship_gnn("cpu")
    batch = graphs_to_batch(random_molecules(8), "g", "average", slot_pack=128, device="cpu")
    with trace(str(tmp_path / "log")) as prof:
        with annotate("eval_forward"):
            model.forward(batch, training=False)
    files = os.listdir(tmp_path / "log")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "log" / files[0]) as f:
        assert "eval_forward" in f.read()
    assert any(e.key == "eval_forward" for e in prof.key_averages())
