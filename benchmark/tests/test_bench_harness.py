"""The harness on the CPU at toy sizes (``bench_toy``): every cell runs and
reads correct; a traced run reports the cell's per-layer metrics; a cell
and a metric are added by files alone; the TF32 control reads incorrect;
and with the timed path broken underneath (a step that leaves the state
unchanged, half of the batch left out with the mean over the rest, the
loss altered where it is produced) a run reads incorrect."""

import json
import os

import pytest
import torch

from bench_toy import cells, toy_root
from benchmark import calibrate, harness

SEED = 2**31 + 2024


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(str(tmp_path_factory.mktemp("toy")))


def run(root, cell, traced=False, seconds=0.3):
    return harness.run_cell(root, cell, SEED, seconds, traced, "cpu")


@pytest.mark.parametrize("cell", cells())
def test_every_cell_reads_correct(root, cell):
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    assert set(result["metrics"]) == {m["name"] for m in harness.e2e_names(bench, cell)}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", cells())
def test_traced_run_reports_per_layer_metrics(root, cell):
    result = run(root, cell, traced=True, seconds=4.0)
    assert result["correct"]
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    listed = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    # on the CPU no device operation is traced, so the kernels' roofline finds nothing to read
    assert set(result["metrics"]) == {n for n in listed if not n.startswith("aggregation_roofline")}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_a_cell_and_a_metric_added_by_files(tmp_path):
    root = toy_root(str(tmp_path))
    bench_file = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_file))
    cfg = json.load(open(os.path.join(root, "benchmark", "configs", "banded_gnn.json")))
    cfg.update(name="toy_gnn", n_nodes=1024)
    json.dump(cfg, open(os.path.join(root, "benchmark", "configs", "toy_gnn.json"), "w"))
    wl = json.load(open(os.path.join(root, "benchmark", "workloads", "banded_gnn.fit_band64.json")))
    wl.update(config="toy_gnn", why="a toy", graph={"band": 16})
    json.dump(wl, open(os.path.join(root, "benchmark", "workloads", "toy_gnn.fit_band16.json"), "w"))
    with open(os.path.join(root, "benchmark", "metrics", "toy_calls.py"), "w") as f:
        f.write("def read(record):\n    return len(record['work'])\n")
    bench["configs"].append({"name": "toy_gnn", "source": "a toy", "file": "benchmark/configs/toy_gnn.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy_gnn.fit_band16", "config": "toy_gnn", "traffic": "fit_band16",
                               "chips": 1, "why": "a toy"})
    next(m for m in bench["end_to_end"] if m["name"] == "train_edges_per_s")["workloads"].append("toy_gnn.fit_band16")
    bench["per_layer"].append({"name": "toy_calls", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "train_edges_per_s", "workloads": ["toy_gnn.fit_band16"]})
    json.dump(bench, open(bench_file, "w"))
    result = harness.run_cell(root, "toy_gnn.fit_band16", SEED, 1.5, True, "cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"toy_calls"}
    assert result["metrics"]["toy_calls"]["value"] >= 1
    plain = harness.run_cell(root, "toy_gnn.fit_band16", SEED, 0.2, False, "cpu")
    assert set(plain["metrics"]) == {"train_edges_per_s", "call_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", cells())
def test_tf32_control_reads_incorrect(root, cell):
    # the starter's control fails about half of its seeds (its limits sit above
    # every sound run's rounding outliers), so a check's many runs catch it
    lines = [line for seed in (SEED, 1, 2, 3) for line in calibrate.readings(root, cell, seed, ["tf32"], "cpu")]
    assert sum(not line["correct"] for line in lines) >= 2, lines


def _half(mask):
    keep = mask.clone()
    keep[torch.nonzero(keep).flatten()[keep.sum() // 2:]] = False
    return keep


def _mean_fault(mp, broken):
    """``trainer.masked_mean`` replaced by ``broken(masked_mean, per_row, mask, sw)``."""
    from gnnkeras_tpu_torch.training.losses import masked_mean

    mp.setattr("gnnkeras_tpu_torch.training.trainer.masked_mean",
                lambda per_row, mask, sw: broken(masked_mean, per_row, mask, sw))


FAULTS = {
    "unchanged_train": lambda mp: mp.setattr("gnnkeras_tpu_torch.training.optimizers.Adam._update",
                                             lambda self, p, g, state, group: torch.zeros_like(p)),
    "half_batch_train": lambda mp: _mean_fault(mp, lambda f, per_row, mask, sw: f(per_row, _half(mask), sw)),
    "altered_train": lambda mp: _mean_fault(mp, lambda f, per_row, mask, sw: 1.01 * f(per_row, mask, sw)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_broken_training_reads_incorrect(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not run(root, cell)["correct"]
