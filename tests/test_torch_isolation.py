"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to fall back to the CPU when asked for the card."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import gnnkeras_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gnnkeras_tpu_torch.__path__, "gnnkeras_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "gnnkeras_tpu" or m.startswith("gnnkeras_tpu."))
# nothing is built and no TensorFlow is imported by importing the modules
from gnnkeras_tpu_torch import native
bad += ["tensorflow"] if "tensorflow" in sys.modules else []
bad += ["native build"] if native._tried else []
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split()[0], res.stdout.strip().split(" ", 1)[1:]
    import gnnkeras_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(gnnkeras_tpu_torch.__path__, "gnnkeras_tpu_torch.")}
    assert int(n_modules) == len(names) >= 15
    # the data pipeline and the fit surface are among them
    assert names >= {f"gnnkeras_tpu_torch.{m}" for m in (
        "data.sequencers", "data.transductive", "data.prefetch", "data.mutag", "training.fit_loop",
        "training.checkpoint", "training.calibrate", "training.serial", "training.callbacks",
        "parallel.data_parallel", "parallel.packed", "parallel.tensor_parallel", "parallel.hybrid",
        "parallel.multihost", "tools.multihost_sim", "cli", "config", "graph.tensor_io", "utils.profiling",
        "utils.keras_interop", "tools.bench", "tools.starter", "tools.starter_composite", "tools.serve")}
    assert bad == [], f"the port pulled in {bad}"


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "gnnkeras_tpu." not in src.replace("gnnkeras_tpu_torch", "")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_card(no_card):
    from gnnkeras_tpu_torch import GNNgraphBased, MLP, Predictor, from_graph_object, get_inout_dims
    from gnnkeras_tpu_torch.data.synthetic import random_molecules

    g = random_molecules(n_graphs=1)[0]
    with pytest.raises(RuntimeError, match="cuda"):
        from_graph_object(g)
    ins, ls = get_inout_dims("state", 14, 3, 2, "g", 0)
    ino, lo = get_inout_dims("output", 14, 3, 2, "g", 0)
    model = GNNgraphBased(MLP(ins[0], ls, "selu"), MLP(ino[0], lo, "softmax"), 0, 5, 0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        model.build(seed=0)
    model.build(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(model, 128, 64, 2)
    batch = from_graph_object(g, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        batch.to("cuda")
    assert batch.nodes.device.type == "cpu" and np.isfinite(model.forward(batch)[2].numpy()).all()


def test_serving_entry_points_raise_without_card(no_card, tmp_path):
    from gnnkeras_tpu_torch import MicroBatcher, Predictor, export_forward, from_graph_object, load_exported
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules

    with pytest.raises(RuntimeError, match="cuda"):
        flagship_gnn()
    model = flagship_gnn("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        MicroBatcher(Predictor(model, 128, 64, 2))
    batch = from_graph_object(random_molecules(n_graphs=1)[0], device="cpu")
    export_forward(model, batch, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(str(tmp_path))
    loaded = load_exported(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        loaded._module("cuda")
    out, _ = loaded.call(batch)
    assert np.isfinite(out.numpy()).all()


_RANK_MODULES = ("gnnkeras_tpu_torch.parallel.mesh", "gnnkeras_tpu_torch.parallel.collectives",
                 "gnnkeras_tpu_torch.parallel.partition", "gnnkeras_tpu_torch.ops.ring",
                 "gnnkeras_tpu_torch.tools.partitioned_large_graph", "gnnkeras_tpu_torch.tools.bench_strip_compact",
                 "gnnkeras_tpu_torch.tools.bench_strip64", "gnnkeras_tpu_torch.parallel.data_parallel",
                 "gnnkeras_tpu_torch.parallel.packed", "gnnkeras_tpu_torch.parallel.tensor_parallel",
                 "gnnkeras_tpu_torch.parallel.hybrid", "gnnkeras_tpu_torch.parallel.multihost",
                 "gnnkeras_tpu_torch.tools.multihost_sim")


def _modules_of_a_rank(rank: int, world: int) -> list:
    import importlib

    for name in _RANK_MODULES:
        importlib.import_module(name)
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "gnnkeras_tpu"
                  or m.startswith("gnnkeras_tpu."))


def test_spawned_ranks_import_no_jax():
    """The ranks ``parallel.launch.spawn`` starts import only what their
    function's module imports (this module imports no JAX): the partitioned
    engine, the ring, the data-parallel, packed, tensor-parallel, hybrid and
    multi-host modules and the tools pull in none."""
    from gnnkeras_tpu_torch.parallel.launch import spawn

    assert spawn(_modules_of_a_rank, 2) == [[], []]


def test_partitioned_entry_points_raise_without_card(no_card):
    from gnnkeras_tpu_torch.data.synthetic import large_banded_graph
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.partition import partition_graph

    with pytest.raises(RuntimeError, match="cuda"):
        rank_device("cuda")
    assert rank_device("cpu").type == "cpu"
    pg = partition_graph(large_banded_graph(2048, band=8), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        pg.shard(0)
    assert pg.shard(1, "cpu").nodes.device.type == "cpu"


def test_pipeline_entry_points_raise_without_card(no_card):
    """The sequencers and the prefetcher default to the card and refuse to
    carry on on the CPU without one."""
    from gnnkeras_tpu_torch.data import (PrefetchSequencer, MultiGraphSequencer, SingleGraphSequencer,
                                         TransductiveMultiGraphSequencer)
    from gnnkeras_tpu_torch.data.synthetic import large_banded_graph, random_molecules

    graphs = random_molecules(n_graphs=3)
    with pytest.raises(RuntimeError, match="cuda"):
        MultiGraphSequencer(graphs, "g", "average")
    with pytest.raises(RuntimeError, match="cuda"):
        SingleGraphSequencer(graphs[0], "g")
    with pytest.raises(RuntimeError, match="cuda"):
        TransductiveMultiGraphSequencer([large_banded_graph(256, band=8)], "n", "average")
    seq = MultiGraphSequencer(graphs, "g", "average", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        PrefetchSequencer(seq)
    assert seq[0].nodes.device.type == "cpu"


def test_distributed_entry_points_raise_without_card(no_card):
    """The packed partition and the multi-host simulation default to the
    card and refuse to carry on on the CPU without one."""
    from gnnkeras_tpu_torch.data.synthetic import random_molecules
    from gnnkeras_tpu_torch.graph.graph import GraphObject
    from gnnkeras_tpu_torch.parallel.packed import partition_packed
    from gnnkeras_tpu_torch.tools.multihost_sim import build_problem

    merged = GraphObject.merge(random_molecules(n_graphs=4), "g", "average")
    with pytest.raises(RuntimeError, match="cuda"):
        partition_packed(merged, 2, strip_dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        build_problem(2, 2)
    batches, meta = partition_packed(merged, 2, strip_dtype="float32", device="cpu")
    assert [b.nodes.device.type for b in batches] == ["cpu", "cpu"] and len(meta.groups) == 2
