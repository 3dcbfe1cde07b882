"""The ports of the repository's examples (``gnnkeras_tpu_torch.tools.starter``,
``starter_composite`` and ``serve``) on the CPU, on synthetic molecules
(``data/synthetic.random_molecules``; Mutagenicity is not needed): each
tool's body trains and evaluates its models, and ``serve`` answers through
the Predictor, the exported artifact and HTTP the same as the model's own
forward.  Without a ``MUTAG_raw`` dump each ``main`` raises
``FileNotFoundError`` (no synthetic fallback).

The starters are held against the JAX examples (``examples/starter.py``,
``examples/starter_composite.py``), run through their ``main`` on the same
4,337 molecules (the size at which the examples' fixed 750/750 tail slices
and the tools' proportional split coincide): the same script options, the
same split and sequencers, the same MLP configurations, parameter shapes
and compile settings; with the JAX models' initial weights copied in, the
GNNs' one-epoch fit (History and test logs, rtol 1e-5, and the trained
weights, rtol 1e-5 / atol 1e-6: f32 in both, only the sum order differs)
and the LGNNs' test logs before training (their fits, whose JAX compile
takes minutes on one core, are held to JAX in ``test_torch_serial.py`` and
``test_torch_lgnn.py``).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.data.synthetic import composite_of, random_molecules
from gnnkeras_tpu_torch.tools import serve, starter, starter_composite

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    """The JAX example ``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _finite_logs(logs):
    return all(np.isfinite(v) for v in logs.values())


@pytest.mark.parametrize("fit", ["gnn", "lgnn"])
def test_starter(fit):
    res = starter.run(random_molecules(120, seed=3, max_nodes=56), device="cpu", epochs=2, fit=fit,
                      mode="parallel", verbose=0)
    assert [len(s) for s in res["splits"]] == [78, 21, 21]  # the starter's proportions of 4,337
    assert _finite_logs(res["test"]) and len(res["history"]["loss"]) == 2
    assert type(res["lgnn"]).__name__ == "LGNN" and res["lgnn"].LAYERS == starter.layers
    # the GNN and the LGNN's first layer hold parameters of their own
    assert res["gnn"].net_state.layers[1].kernel is not res["lgnn"].gnns[0].net_state.layers[1].kernel


def test_starter_serial_lgnn():
    res = starter.run(random_molecules(80, seed=4, max_nodes=40), device="cpu", epochs=1, fit="lgnn", verbose=0)
    assert res["lgnn"].training_mode == "serial" and _finite_logs(res["test"])


def test_starter_composite_clgnn():
    graphs = [composite_of(g) for g in random_molecules(120, seed=4, max_nodes=56)]
    res = starter_composite.run(graphs, device="cpu", epochs=2, fit="lgnn", verbose=0)
    assert type(res["lgnn"]).__name__ == "CompositeLGNN" and res["lgnn"].LAYERS == starter_composite.layers
    assert {"loss", "accuracy", "mse"} <= set(res["test"]) and _finite_logs(res["test"])
    res = starter_composite.run(graphs, device="cpu", epochs=1, fit="gnn", verbose=0)
    assert type(res["gnn"]).__name__ == "CompositeGNNgraphBased" and _finite_logs(res["test"])


def test_serve():
    """The served rows against the JAX package's Predictor with the same
    trained weights on the same requests (both fused routes: f32 over the
    same bf16-rounded weights, only the sum order differs: rtol 1e-5 /
    atol 1e-6); the artifact against the model's eval forward; the HTTP
    answer against the Predictor's."""
    import jax
    import jax.numpy as jnp

    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.mlp as jmlp
    import gnnkeras_tpu.serving as jserving
    from gnnkeras_tpu_torch.convert import variables_to_jax
    from torch_port_common import _nets

    res = serve.run(random_molecules(120, seed=5, max_nodes=56), device="cpu", epochs=2, requests=6, verbose=0)
    model, p, gte = res["model"], res["predictor"], res["test_graphs"]
    assert p.fused  # the flagship folds: small requests take the fused route
    jm = jgnn.GNNgraphBased(*_nets(jmlp), 0, 5, 0.0)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables_to_jax(model))
    jte = [jgraph.GraphObject(nodes=g.nodes, arcs=g.arcs, targets=g.targets, focus="g", aggregation_mode="average")
           for g in gte]
    jp = jserving.Predictor.for_graphs(jm, jte, batch_size=8, fused="auto")
    assert (jp.max_nodes, jp.max_arcs, jp.max_graphs) == (p.max_nodes, p.max_arcs, p.max_graphs) and jp.fused
    for take, got in zip(res["requests"], res["outputs"]):
        assert got.shape == (len(take), 2)
        np.testing.assert_allclose(got, jp([jte[i] for i in take]), rtol=1e-5, atol=1e-6)
    out, mask = res["artifact"]
    _, _, want, want_mask, _ = model.forward(res["template"], training=False)
    np.testing.assert_array_equal(mask, want_mask.numpy())
    np.testing.assert_allclose(out[mask], want.numpy()[mask], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res["http"]["outputs"][0]), p([gte[0]]), rtol=1e-6, atol=1e-7)
    assert 0.0 <= res["accuracy"] <= 1.0


@pytest.mark.parametrize("tool", [starter, starter_composite, serve])
def test_main_needs_the_dataset(tool, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["tool", "--device", "cpu", "--epochs", "1"])
    with pytest.raises(FileNotFoundError, match="MUTAG_raw"):
        tool.main()


@pytest.mark.parametrize("tool, name", [(starter, "starter"), (starter_composite, "starter_composite")])
def test_script_options_match_the_example(tool, name):
    ex = _example(name)
    options = [k for k, v in vars(ex).items() if not k.startswith("_") and isinstance(v, (str, int, float, bool))]
    assert len(options) >= 18
    assert {k: getattr(tool, k) for k in options} == {k: getattr(ex, k) for k in options}


@pytest.fixture(scope="module")
def molecules():
    """4,337 small molecules: the size of Mutagenicity, where the examples'
    750/750 tail slices apply."""
    return random_molecules(4337, seed=3, min_nodes=5, max_nodes=9)


def _jax_graphs(graphs, composite):
    import gnnkeras_tpu.graph.graph as jgraph

    if composite:
        return [jgraph.CompositeGraphObject(g.nodes, g.arcs, g.targets, g.type_mask, g.DIM_NODE_LABEL, focus="g",
                                            aggregation_mode="average") for g in graphs]
    return [jgraph.GraphObject(nodes=g.nodes, arcs=g.arcs, targets=g.targets, focus="g", aggregation_mode="average")
            for g in graphs]


def _recording(owner, attr, calls, monkeypatch):
    """Replace the sequencer class ``owner.attr`` by one that records its
    arguments (the graphs and the rest) in ``calls``."""
    real = getattr(owner, attr)

    def make(graphs, *args, **kwargs):
        recorded = {k: v for k, v in kwargs.items() if k != "device"}  # the port's only
        calls.append((list(graphs), tuple(args), {"shuffle": True, **recorded}))
        return real(graphs, *args, **kwargs)

    monkeypatch.setattr(owner, attr, make)


def _run_example(ex, graphs, which, mode, monkeypatch):
    """The example's ``main`` on ``graphs`` with ``--fit which``: its
    sequencers' arguments, its model and the model's initial variables
    (NumPy).  ``mode`` "fit" runs its one-epoch fit and test evaluation
    (History and test logs recorded), "evaluate" skips the fit and runs the
    evaluation, "capture" skips both."""
    rec = {"sequencers": []}
    seq_name = "CompositeMultiGraphSequencer" if hasattr(ex, "CompositeMultiGraphSequencer") else "MultiGraphSequencer"
    _recording(ex, seq_name, rec["sequencers"], monkeypatch)
    monkeypatch.setattr(ex, "load_mutag", lambda **kwargs: list(graphs))
    cls = ex.CompositeLGNN if which == "lgnn" and hasattr(ex, "CompositeLGNN") else (
        ex.LGNN if which == "lgnn" else getattr(ex, "CompositeGNNgraphBased", None) or ex.GNNgraphBased)
    real_fit, real_evaluate = cls.fit, cls.evaluate

    def fit(self, seq, **kwargs):
        self.build()
        rec["model"], rec["init"] = self, _variables(self)
        if mode == "fit":
            rec["history"] = real_fit(self, seq, **kwargs).history

    def evaluate(self, seq, **kwargs):
        if mode != "capture":
            rec["test"] = real_evaluate(self, seq, **kwargs)
        return rec.get("test")

    monkeypatch.setattr(cls, "fit", fit)
    monkeypatch.setattr(cls, "evaluate", evaluate)
    monkeypatch.setattr(sys, "argv", ["example", "--epochs", "1", "--fit", which, "--seed", "7"])
    ex.main()
    return rec


def _same_graphs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.nodes, w.nodes)
        np.testing.assert_array_equal(g.arcs, w.arcs)
        np.testing.assert_array_equal(g.targets, w.targets)


def _wiring(model):
    """Per GNN layer: the state MLPs' and the readout's configurations and
    the loop's settings."""
    out = []
    for g in getattr(model, "gnns", [model]):
        nets = g.net_state if isinstance(g.net_state, (list, tuple, torch.nn.ModuleList)) else [g.net_state]
        cfgs = [m.get_config() for m in nets] + [g.net_output.get_config()]
        out.append(([{k: np.asarray(v).tolist() if k == "input_dim" else v for k, v in c.items()} for c in cfgs],
                    g.max_iteration, g.state_threshold))
    return out


@pytest.mark.parametrize("tool, name, which", [(starter, "starter", "gnn"), (starter, "starter", "lgnn"),
                                               (starter_composite, "starter_composite", "gnn"),
                                               (starter_composite, "starter_composite", "lgnn")])
def test_starter_matches_the_example(tool, name, which, molecules, monkeypatch):
    """The tool against the JAX example's ``main`` on the same molecules,
    with the example's initial weights: the starter's GNN through its
    one-epoch fit and test evaluation, its LGNN through the test evaluation;
    the composite starter's models (dim_state 10: each framework draws its
    own random initial state) through one forward on the first test batch
    with the JAX draw fed to the port."""
    import gnnkeras_tpu_torch
    from gnnkeras_tpu_torch.convert import variables_from_jax

    composite = tool is starter_composite
    graphs = [composite_of(g) for g in molecules] if composite else list(molecules)
    mode = "capture" if composite else {"gnn": "fit", "lgnn": "evaluate"}[which]
    rec = _run_example(_example(name), _jax_graphs(graphs, composite), which, mode, monkeypatch)

    seq_calls = []
    _recording(gnnkeras_tpu_torch, "CompositeMultiGraphSequencer" if composite else "MultiGraphSequencer", seq_calls,
               monkeypatch)
    built = tool.build(graphs, device="cpu", seed=7)
    assert [len(s) for s in built["splits"]] == [2837, 750, 750]
    model, jm = built[which], rec["model"]
    assert _wiring(model) == _wiring(jm)
    assert (model.average_st_grads, model.metrics) == (jm.average_st_grads, tuple(jm.metrics))
    if which == "lgnn":
        assert (model.training_mode, model.get_state, model.get_output) == (jm.training_mode, jm.get_state,
                                                                            jm.get_output)
    init = variables_from_jax(rec["init"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in init.items()}
    model.load_state_dict(init)

    gTr, gTe, gVa = built["splits"]
    if mode == "fit":
        starter.train(built, fit=which, epochs=1, verbose=0)
        for key, values in rec["history"].items():
            np.testing.assert_allclose(built["history"].history[key], values, rtol=RTOL, err_msg=key)
        trained = variables_from_jax(_variables(jm))
        for key, value in model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), trained[key].numpy(), rtol=RTOL, atol=ATOL, err_msg=key)
    else:
        test_seq = built["sequencer"](gTe, False)
    if mode == "evaluate":
        built["test"] = model.evaluate(test_seq, verbose=0)
    if mode != "capture":
        for key, value in rec["test"].items():
            np.testing.assert_allclose(built["test"][key], value, rtol=RTOL, err_msg=key)
    else:
        _forward_matches(model, jm, test_seq[0], rec["sequencers"][2][0], monkeypatch)
    # the same graphs in each split, and the same sequencers over them (the
    # example builds train, validation and test sequencers; the tool's
    # train builds them in that order, and only the test one otherwise)
    for got, want in zip((gTr, gTe, gVa), (rec["sequencers"][0], rec["sequencers"][2], rec["sequencers"][1])):
        _same_graphs(got, want[0])
    for got, want in zip(seq_calls, rec["sequencers"] if mode == "fit" else rec["sequencers"][2:]):
        _same_graphs(got[0], want[0])
        assert got[1:] == want[1:]


def _forward_matches(model, jm, tb, jax_graphs, monkeypatch):
    """The eval forward of ``model`` and of the JAX ``jm`` (same weights) on
    the batch ``tb`` and its JAX twin, with JAX's random initial state fed
    to the port: outputs within RTOL / ATOL."""
    import jax

    import gnnkeras_tpu.graph.graph as jgraph
    from gnnkeras_tpu.graph.batch import from_graph_object
    from torch_port_common import feed_init_draw, jax_init_draw, jax_lgnn_draws, run_jitted

    jb = from_graph_object(jgraph.CompositeGraphObject.merge(jax_graphs[: starter_composite.batch_size], "g",
                                                             "average"), slot_pack=128)
    rng = jax.random.PRNGKey(5)
    ds = starter_composite.dim_state
    feed_init_draw(monkeypatch, jax_lgnn_draws(rng, tb.num_nodes, ds, model.LAYERS) if hasattr(model, "gnns")
                   else jax_init_draw(rng, tb.num_nodes, ds))
    jout = run_jitted(lambda v, b, r: jm.forward(v, b, training=False, rng=r)[2:4], jm.variables, jb, rng)
    _, _, out, mask, _ = model.forward(tb, training=False, generator=torch.Generator())
    jo = jout[0][-1] if isinstance(jout[0], (list, tuple)) else jout[0]
    m = np.asarray(jout[1])
    np.testing.assert_array_equal(mask.numpy(), m)
    np.testing.assert_allclose(model.served_output(out).numpy()[m], np.asarray(jo)[m], rtol=RTOL, atol=ATOL)


def _variables(model):
    import jax

    return jax.tree_util.tree_map(np.asarray, model.variables)
