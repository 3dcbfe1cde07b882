"""A copy of the benchmark at toy sizes, for CPU tests: the committed
``BENCHMARK.json`` and ``benchmark/`` files under a temporary root, with
the configurations cut to a few thousand nodes and a few dozen molecules."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOY_SIZES = {
    "banded_gnn": {"n_nodes": 4096},
    "starter_gnn": {"data": {"kind": "molecules", "graphs": 70, "atoms": 2100, "bonds": 2150, "test": 10,
                             "validation": 10}, "batch_size": 20},
}


def toy_root(path: str) -> str:
    """``path`` holding the benchmark at toy sizes; returns it."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"), dirs_exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(path, "BENCHMARK.json"))
    for name, sizes in TOY_SIZES.items():
        file = os.path.join(path, "benchmark", "configs", f"{name}.json")
        with open(file) as f:
            cfg = json.load(f)
        cfg.update(sizes)
        with open(file, "w") as f:
            json.dump(cfg, f)
    return path


def cells() -> list:
    """The cells of ``BENCHMARK.json``."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
