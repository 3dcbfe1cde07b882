"""The plain reference against the port's CPU paths at small sizes, in both
configurations: one training step's loss, gradients and Adam update, and
Adam started from a state mid-run as the program's optimizer holds it.  (This test imports both; the reference itself
imports nothing of the port.)"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.data.banded import banded_graph
from benchmark.data.molecules import molecules, subset
from benchmark.drivers import program as P
from benchmark.reference import gnn as R

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 99


def config(name):
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def banded_case(agg_dtype, band):
    from gnnkeras_tpu_torch.data.sequencers import SingleGraphSequencer

    cfg = config("banded_gnn")
    data = banded_graph(SEED, 2048, band)
    seq = SingleGraphSequencer(P.banded_graph_object(data, cfg), "n", batch_size=2048, shuffle=False,
                               agg_dtype=agg_dtype, device="cpu")
    ref = R.make_graph(data["nodes"], data["src"], data["dst"], data["arc_label"], data["targets"])
    return cfg, seq[0], ref


def starter_case():
    from gnnkeras_tpu_torch.data.sequencers import MultiGraphSequencer

    cfg = config("starter_gnn")
    mols = subset(molecules(SEED, graphs=40, atoms=1200, bonds=1230), np.arange(40))
    seq = MultiGraphSequencer(P.molecule_graph_objects(mols, cfg), "g", "average", 40, False,
                              slot_pack=128, strip_dtype="int8", device="cpu")
    ref = R.make_graph(mols["nodes"], mols["src"], mols["dst"], mols["arc_label"], mols["targets"],
                       mols["node_start"])
    return cfg, seq[0], ref


CASES = {"banded_auto": lambda: banded_case("auto", 64), "banded_int8": lambda: banded_case("int8", 384),
         "starter": starter_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_loss_gradients_and_adam(case):
    from gnnkeras_tpu_torch.training.trainer import train_step

    cfg, batch, ref = CASES[case]()
    w = weights.draw(cfg, SEED, "cpu")
    model = P.build_model(cfg, w, "cpu")
    logs, _ = train_step(model, batch)
    leaves = P.trainable_leaves(model, cfg)
    out = R.train(w, [ref], cfg, cfg["learning_rate"], R.Matmul())
    after = out["states"][1]
    assert float(logs["loss_sum"] / logs["count"]) == pytest.approx(out["losses"][0], rel=1e-6)
    for name, p in leaves.items():
        g = out["first_grads"][name]
        assert torch.allclose(p.grad, g, rtol=1e-4, atol=1e-6 * float(g.abs().max())), name
        # Adam's first step moves a leaf by about lr · sign(g): equal where the gradient is not at round-off
        step = p.detach() - w[name]
        ref_step = after["params"][name] - w[name]
        firm = g.abs() > 1e-4 * float(g.abs().max())
        assert torch.allclose(step[firm], ref_step[firm], rtol=1e-4, atol=1e-7), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_adam_followed_from_the_programs_state(case):
    """The reference's second step, started from the program's parameters
    and optimizer state after its first, lands where the program's does."""
    from gnnkeras_tpu_torch.training.trainer import train_step

    cfg, batch, ref = CASES[case]()
    w = weights.draw(cfg, SEED, "cpu")
    model = P.build_model(cfg, w, "cpu")
    train_step(model, batch)
    leaves = P.trainable_leaves(model, cfg)
    state = model._opt.state
    start = {"params": {k: p.detach().clone() for k, p in leaves.items()},
             "mu": {k: state[p]["mu"].clone() for k, p in leaves.items()},
             "nu": {k: state[p]["nu"].clone() for k, p in leaves.items()},
             "t": int(state[next(iter(leaves.values()))]["step"].item())}
    assert start["t"] == 1
    logs, _ = train_step(model, batch)
    out = R.train({**w, **start["params"]}, [ref], cfg, cfg["learning_rate"], R.Matmul(), adam=start)
    after = out["states"][1]
    assert after["t"] == 2
    assert float(logs["loss_sum"] / logs["count"]) == pytest.approx(out["losses"][0], rel=1e-6)
    for name, p in leaves.items():
        mu = state[p]["mu"]
        assert torch.allclose(mu, after["mu"][name], rtol=1e-4, atol=1e-6 * float(mu.abs().max())), name
        firm = out["first_grads"][name].abs() > 1e-4 * float(out["first_grads"][name].abs().max())
        assert torch.allclose(p.detach()[firm], after["params"][name][firm], rtol=1e-4, atol=1e-6), name
