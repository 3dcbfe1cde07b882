"""The port's command line (``python -m gnnkeras_tpu_torch.cli``) on the CPU,
against the JAX package's (``gnnkeras_tpu.cli``), over a TU dump the test
writes (300 ``random_molecules``).

- train / evaluate / predict / export / bench in-process with
  ``--device cpu``: the JAX CLI's JSON lines, a saved model folder, the
  predictions of the test split, a ``torch.export`` artifact;
- a model the JAX CLI trained and saved, evaluated and predicted by the
  port's CLI (and the reverse): the same split, logs within rtol 1e-5 and
  predictions within rtol 1e-5 / atol 1e-6 (f32 in both, only the sum
  order differs);
- ``bench`` at scale 0.001: one JSON line with the metric;
- each ``--parallel`` engine at 2 ranks (gloo, spawned processes); dp,
  packed and partitioned against the JAX CLI's ``--parallel`` run on 2
  host devices from the same initial weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from gnnkeras_tpu.cli import main as jmain
from gnnkeras_tpu_torch import kernels
from gnnkeras_tpu_torch.cli import PARALLEL_ENGINES, main

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
CONFIG = {"batch_size": 128, "epochs": 1, "max_iter": 2, "state_threshold": 0.0}


@pytest.fixture(scope="module")
def tu_dump(tmp_path_factory):
    from gnnkeras_tpu_torch.data.synthetic import random_molecules, write_tu_dump

    root = str(tmp_path_factory.mktemp("tu"))
    write_tu_dump(random_molecules(300, seed=0, max_nodes=56), root, "SYN")
    return f"tu:{root}:SYN"


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "cfg.json"
    path.write_text(json.dumps(CONFIG))
    return str(path)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run(fn, args, capsys):
    assert fn(args) == 0
    return last_json(capsys)


def test_train_evaluate_predict_export(tu_dump, config, tmp_path, capsys):
    kernels.reset_launches()
    model_dir = str(tmp_path / "model")
    common = ["--config", config, "--dataset", tu_dump, "--verbose", "0", "--device", "cpu"]
    out = run(main, ["train", *common, "--save", model_dir], capsys)
    assert set(out) == {"test", "final_train"} and np.isfinite(out["test"]["loss"])
    assert {"loss", "accuracy", "val_loss", "val_accuracy"} <= set(out["final_train"])
    with open(os.path.join(model_dir, "config.json")) as f:
        assert json.load(f)["model_class"] == "GNNgraphBased"
    ev = run(main, ["evaluate", *common, "--model", model_dir], capsys)
    assert ev == pytest.approx(out["test"], rel=1e-6)
    preds = str(tmp_path / "preds.npy")
    assert main(["predict", *common, "--model", model_dir, "--out", preds]) == 0
    assert np.load(preds).shape == (52, 2)  # round(300 · 750 / 4337) test graphs
    art = str(tmp_path / "artifact")
    assert main(["export", *common, "--model", model_dir, "--out", art]) == 0
    assert sorted(os.listdir(art)) == ["forward.pt2", "serving.json"]
    # on the CPU every operator runs its plain version: no kernel launched
    assert set(kernels.LAUNCHES) >= {"strip_matmul", "strip_matmul_t", "fused_unfold_t"}
    assert not any(kernels.LAUNCHES.values())


def test_arc_focus_on_a_saved_npz_dataset(tmp_path, capsys):
    """``npz:<folder>`` reads a ``GraphObject.save_dataset`` folder in the
    config's focus: arc-focused targets train and predict (one row an arc)."""
    from gnnkeras_tpu_torch.data.synthetic import random_molecules
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    rng = np.random.default_rng(1)
    graphs = [GraphObject(nodes=g.nodes, arcs=g.arcs, targets=np.eye(2)[rng.integers(0, 2, len(g.arcs))], focus="a",
                          aggregation_mode="average") for g in random_molecules(40, seed=2)]
    GraphObject.save_dataset(str(tmp_path / "arcs"), graphs)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**CONFIG, "focus": "a"}))
    common = ["--config", str(cfg), "--dataset", f"npz:{tmp_path / 'arcs'}", "--verbose", "0", "--device", "cpu"]
    out = run(main, ["train", *common, "--save", str(tmp_path / "m")], capsys)
    assert np.isfinite(out["test"]["loss"])
    assert main(["predict", *common, "--model", str(tmp_path / "m"), "--out", str(tmp_path / "p.npy")]) == 0
    from gnnkeras_tpu_torch.data.mutag import dataset_splits

    loaded = GraphObject.load_dataset(str(tmp_path / "arcs"), "a", "average")  # g0, g1, g10, ... order
    test_split = dataset_splits(loaded, seed=42)[1]
    assert np.load(tmp_path / "p.npy").shape == (sum(len(g.arcs) for g in test_split), 2)


def test_bad_dataset_spec_and_no_card(monkeypatch):
    with pytest.raises(SystemExit):
        main(["train", "--dataset", "nope", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--dataset", "nope"])  # the card is the default


def _predictions(fn, args, tmp_path, name, capsys):
    path = str(tmp_path / f"{name}.npy")
    assert fn(["predict", *args, "--out", path]) == 0
    capsys.readouterr()
    return np.load(path)


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_saved_models_cross_between_the_clis(tu_dump, config, tmp_path, capsys, trainer):
    """One CLI trains and saves; both evaluate and predict the saved
    model on the same test split."""
    model_dir = str(tmp_path / "model")
    common = ["--config", config, "--dataset", tu_dump, "--verbose", "0"]
    cpu = ["--device", "cpu"]
    train = jmain if trainer == "jax" else main
    trained = run(train, ["train", *common, *([] if trainer == "jax" else cpu), "--save", model_dir], capsys)
    port_ev = run(main, ["evaluate", *common, *cpu, "--model", model_dir], capsys)
    jax_ev = run(jmain, ["evaluate", *common, "--model", model_dir], capsys)
    assert port_ev == pytest.approx(jax_ev, rel=RTOL)
    assert port_ev["loss"] == pytest.approx(trained["test"]["loss"], rel=RTOL)
    port_p = _predictions(main, [*common, *cpu, "--model", model_dir], tmp_path, "port", capsys)
    jax_p = _predictions(jmain, [*common, "--model", model_dir], tmp_path, "jax", capsys)
    assert port_p.shape == jax_p.shape == (52, 2)
    np.testing.assert_allclose(port_p, jax_p, rtol=RTOL, atol=ATOL)


def test_bench_contract(capsys, monkeypatch):
    monkeypatch.setenv("GNNK_BENCH_SCALE", "0.001")  # as bench.py's scale
    assert main(["bench", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "transition_edges_per_s" and rec["unit"] == "edges/s/card"
    assert rec["value"] > 0 and rec["iterations"] == 5 and rec["workload"] == "synthetic"
    assert rec["device"] == "cpu" and rec["card"] is None and "vs_baseline" not in rec


# every engine spawns 2 ranks (~14 s each on one core): partitioned, pipeline
# and expert run outside tier 1, dp and packed in it
_ENGINES = [e if e in ("dp", "packed") else pytest.param(e, marks=pytest.mark.slow) for e in PARALLEL_ENGINES]
# the engines whose models start from a fixed state (dim_state 0): these are
# held to the JAX CLI's --parallel run from the same initial weights
_HELD_TO_JAX = ("dp", "packed", "partitioned")


def _jax_initial_weights(monkeypatch):
    """Make the JAX CLI's ``build_model`` initialise its model at once and
    record the initial variables (NumPy) in the returned dict."""
    import jax

    from gnnkeras_tpu.config import GNNConfig as JConfig

    rec, real = {}, JConfig.build_model

    def build_model(self, *args, **kwargs):
        model = real(self, *args, **kwargs)
        model.build()
        rec["variables"] = jax.tree_util.tree_map(np.asarray, model.variables)
        return model

    monkeypatch.setattr(JConfig, "build_model", build_model)
    return rec


def _port_starts_from(variables, monkeypatch):
    """Make the port CLI's ``build_model`` load ``variables`` (the JAX tree)."""
    from gnnkeras_tpu_torch.config import GNNConfig
    from gnnkeras_tpu_torch.convert import variables_from_jax

    real = GNNConfig.build_model

    def build_model(self, *args, **kwargs):
        model = real(self, *args, **kwargs)
        model.load_state_dict(variables_from_jax(variables))
        return model

    monkeypatch.setattr(GNNConfig, "build_model", build_model)


@pytest.mark.parametrize("engine", _ENGINES)
def test_parallel_engines_train(tu_dump, tmp_path, capsys, monkeypatch, engine):
    """Each engine on 2 ranks: finite logs, and the saved weights are the
    trained ones (the port's evaluate of the folder gives the same test
    logs).  Where the model starts from fixed weights, the JAX CLI's
    ``--parallel`` run on 2 host devices, started from the same weights:
    the same test and last-epoch logs (rtol 1e-5) and the same trained
    weights (rtol 1e-5 / atol 1e-6)."""
    from gnnkeras_tpu_torch.cli import _load_model

    extra = {"pipeline": {"layers": 2, "dim_state": 4}, "expert": {"dim_state": 4}}.get(engine, {})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**CONFIG, **extra}))
    dataset = tu_dump + (":composite" if engine == "expert" else "")
    common = ["--config", str(cfg), "--dataset", dataset, "--verbose", "0"]
    train = ["train", *common, "--parallel", engine, "--parallel-devices", "2"]
    cpu = ["--device", "cpu"]
    model_dir = str(tmp_path / "model")
    if engine in _HELD_TO_JAX:
        initial = _jax_initial_weights(monkeypatch)
        jax_dir = str(tmp_path / "jax_model")
        jax_out = run(jmain, [*train, "--save", jax_dir], capsys)
        _port_starts_from(initial["variables"], monkeypatch)
    out = run(main, [*train, *cpu, "--save", model_dir], capsys)
    assert np.isfinite(out["test"]["loss"]) and np.isfinite(out["final_train"]["loss"])
    ev = run(main, ["evaluate", *common, *cpu, "--model", model_dir], capsys)
    assert ev["loss"] == pytest.approx(out["test"]["loss"], rel=1e-6)
    if engine in _HELD_TO_JAX:
        for part in ("test", "final_train"):
            assert set(out[part]) == set(jax_out[part]), part
            for key, value in jax_out[part].items():
                np.testing.assert_allclose(out[part][key], value, rtol=RTOL, err_msg=f"{part} {key}")
        want = _load_model(jax_dir, "cpu").state_dict()
        for key, value in _load_model(model_dir, "cpu").state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=RTOL, atol=ATOL, err_msg=key)
