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
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split()[0], res.stdout.strip().split(" ", 1)[1:]
    import gnnkeras_tpu_torch

    expected = len(list(pkgutil.walk_packages(gnnkeras_tpu_torch.__path__, "gnnkeras_tpu_torch.")))
    assert int(n_modules) == expected >= 15
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
