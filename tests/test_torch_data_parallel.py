"""Data parallelism (``parallel/data_parallel.py``) against the JAX package's,
on the CPU.

The port runs on 2 gloo ranks spawned once for the module (``_rank_run``),
the JAX package on a 2-device sub-mesh of the conftest's 8 CPU devices, with
the same weights.  Three batches of 10 molecules on 2 ranks: the second
group is partial (batch 2 and the filler, weight 0).

- ``make_dp_train_step``: the two groups' steps (SGD, lr 0.1) against
  JAX's ``make_dp_train_step`` on the same groups, for a graph-focused and
  an arc-focused GNN: the log sums, the new moving statistics (averaged over
  the real batches only) and the parameters;
- ``DataParallelTrainer.fit``: 3 epochs of a shuffled sequencer with
  validation every epoch and ``class_weight`` against JAX's fit from the same
  NumPy seed (rank 0's; the other rank seeds its stream otherwise, and
  ``fit`` must give it rank 0's); the batches the ranks train on in each
  epoch are disjoint and cover the epoch; a fit stopped after 2 epochs and
  resumed to 3 ends bit for bit where the uninterrupted fit ends, on every
  rank; ``evaluate`` and ``predict`` are the model's single-device ones.

Losses, log sums, statistics and parameters at rtol 1e-5 / atol 1e-6 (the
gradient average of two ranks is added in gloo's order, JAX's psum in
XLA's).  This module imports JAX only inside its fixtures and tests.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

RANKS = 2
RTOL, ATOL = 1e-5, 1e-6
BATCH = 10


def _raw(n_graphs=30, seed=0, focus="g"):
    """(nodes, arcs, targets) of 5-24-node molecules with one-hot labels; a
    target a graph (focus 'g') or an arc ('a', in the arcs' sorted order)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 25))
        a = int(rng.integers(n, 3 * n))
        src, dst = rng.integers(0, n, a), rng.integers(0, n, a)
        arcs = np.concatenate([np.stack([src, dst], 1), np.eye(3)[rng.integers(0, 3, a)]], 1).astype(np.float32)
        nodes = np.eye(14, dtype=np.float32)[rng.integers(0, 14, n)]
        rows = 1 if focus == "g" else len(np.unique(arcs, axis=0))
        out.append((nodes, arcs, np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)]))
    return out


def _graphs(module, raw, focus="g", weighted=False):
    """``raw`` as GraphObjects; ``weighted`` gives graph i the sample weight
    1 + i/1000 (so a batch tells which graphs it holds)."""
    return [module.GraphObject(nodes=n, arcs=a, targets=t, focus=focus, aggregation_mode="average",
                               sample_weight=(1.0 + i / 1000) if weighted else 1)
            for i, (n, a, t) in enumerate(raw)]


def _nets(mlp, focus):
    ins, ls = mlp.get_inout_dims("state", 14, 3, 2, focus, 0)
    ino, lo = mlp.get_inout_dims("output", 14, 3, 2, focus, 0)
    return (mlp.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                    bias_initializer="lecun_normal"),
            mlp.MLP(input_dim=ino[0], layers=lo, activations="softmax", kernel_initializer="glorot_normal",
                    bias_initializer="glorot_normal"))


def _port_model(state, focus="g"):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    cls = tgnn.GNNgraphBased if focus == "g" else tgnn.GNNarcBased
    m = cls(*_nets(tmlp, focus), 0, 5, 0.0).build(device="cpu")
    m.load_state_dict(state)
    m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"])
    return m


def _sequencer(module, graphs, focus="g", shuffle=False, **kw):
    return module.MultiGraphSequencer(graphs, focus, "average", batch_size=BATCH, shuffle=shuffle, slot_pack=128,
                                      strip_dtype="float32", **kw)


class _Recording:
    """A sequencer that records, for every batch read, the epoch, the index
    and the graphs it holds (their sample weights, graph i weighing
    1 + i/1000)."""

    def __init__(self, seq):
        self.seq, self.epoch, self.reads = seq, 0, []

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, i):
        batch = self.seq[i]
        ids = np.rint((batch.sample_weight[batch.target_mask].numpy() - 1.0) * 1000).astype(int)
        self.reads.append((self.epoch, i, sorted(ids.tolist())))
        return batch

    def on_epoch_end(self):
        self.epoch += 1
        self.seq.on_epoch_end()

    def wait_for_rebuild(self):
        self.seq.wait_for_rebuild()


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


# -- the port's ranks -----------------------------------------------------------------


def _rank_run(rank: int, world: int, states: dict, graphs: dict, ck: str) -> dict:
    import os

    import gnnkeras_tpu_torch.data.sequencers as tseq
    from gnnkeras_tpu_torch.parallel.data_parallel import DataParallelTrainer, _rank_batch, make_dp_train_step

    out = {}
    for focus in ("g", "a"):
        model = _port_model(states[focus], focus)
        seq = _sequencer(tseq, graphs[focus], focus, device="cpu")
        step = make_dp_train_step(model)
        logs = []
        for g in range(2):
            batch, weight = _rank_batch(seq, g, world, rank)
            logs.append({k: float(v) for k, v in step(batch, weight).items()})
        out[("step", focus)] = {"logs": logs, "state": _np(model.state_dict())}

    np.random.seed(0 if rank == 0 else 1000 + rank)  # fit gives every rank rank 0's stream
    model = _port_model(states["g"])
    seq = _Recording(_sequencer(tseq, graphs["weighted"], shuffle=True, device="cpu"))
    val = _sequencer(tseq, graphs["val"], device="cpu")
    trainer = DataParallelTrainer(model)
    out["fit"] = trainer.fit(seq, epochs=3, validation_data=val, class_weight={0: 2.0, 1: 0.5}, verbose=0).history
    out["fit_state"], out["reads"] = _np(model.state_dict()), seq.reads
    out["evaluate"] = (trainer.evaluate(val), model.evaluate(val))
    out["predict"] = (trainer.predict(val), model.predict(val))

    def fit(**kw):
        m = _port_model(states["g"])
        history = DataParallelTrainer(m).fit(_sequencer(tseq, graphs["g"], device="cpu"), verbose=0, **kw)
        return m, history.history

    whole, out["whole"] = fit(epochs=3, checkpoint_dir=os.path.join(ck, "whole"))
    fit(epochs=2, checkpoint_dir=os.path.join(ck, "resume"))
    resumed, out["resumed"] = fit(epochs=3, checkpoint_dir=os.path.join(ck, "resume"), resume=True)
    out["whole_state"], out["resumed_state"] = _np(whole.state_dict()), _np(resumed.state_dict())
    return out


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu_torch.graph.graph as tgraph
    import torch_port_common as C
    from gnnkeras_tpu.parallel.mesh import make_mesh

    pairs = {focus: C.gnn_pair(focus=focus, seed=3) for focus in ("g", "a")}
    raw = {"g": _raw(), "a": _raw(seed=1, focus="a"), "val": _raw(n_graphs=12, seed=2)}
    graphs = {key: (_graphs(jgraph, r, "a" if key == "a" else "g"), _graphs(tgraph, r, "a" if key == "a" else "g"))
              for key, r in raw.items()}
    graphs["weighted"] = (_graphs(jgraph, raw["g"], weighted=True), _graphs(tgraph, raw["g"], weighted=True))
    states = {focus: tm.state_dict() for focus, (_, tm) in pairs.items()}
    ck = str(tmp_path_factory.mktemp("dp_ck"))
    results = spawn(_rank_run, RANKS, [(states, {k: v[1] for k, v in graphs.items()}, ck)] * RANKS)
    return dict(jax=jax, pairs=pairs, j0={f: jax.tree_util.tree_map(np.asarray, jm.variables)
                                           for f, (jm, _) in pairs.items()},
                graphs={k: v[0] for k, v in graphs.items()}, results=results,
                mesh=make_mesh(("data",), devices=jax.devices()[:RANKS]))


def _jax_model(setup, focus):
    import jax.numpy as jnp

    jm = setup["pairs"][focus][0]
    jm.variables = setup["jax"].tree_util.tree_map(jnp.asarray, setup["j0"][focus])
    jm._opt_state, jm._rng = None, setup["jax"].random.PRNGKey(0)
    jm.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"])
    return jm


def _assert_state(got: dict, jm, err=""):
    from torch_port_common import port_dict

    for section in ("params", "state"):
        for name, w in port_dict(jm.variables[section], section).items():
            np.testing.assert_allclose(got[name], w.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{err} {name}")


@pytest.mark.parametrize("focus", ["g", "a"])
def test_dp_steps_with_a_partial_group_match_jax(setup, focus):
    import gnnkeras_tpu.data.sequencers as jseq
    from gnnkeras_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer
    from gnnkeras_tpu.parallel.data_parallel import make_dp_train_step
    from torch_port_common import fast_jax_jit

    jax = setup["jax"]
    jm = _jax_model(setup, focus)
    jm.build()
    seq = _sequencer(jseq, setup["graphs"][focus], focus)
    groups, reals = JTrainer(jm, setup["mesh"])._device_groups(seq)
    assert [np.asarray(r).tolist() for r in reals] == [[1.0, 1.0], [1.0, 0.0]]
    params, mstate = jm.variables["params"], jm.variables["state"]
    opt = jm.optimizer.init(params)
    want = []
    with fast_jax_jit():
        step = make_dp_train_step(jm, setup["mesh"])
        for group, real in zip(groups, reals):
            params, mstate, opt, logs = step(params, mstate, opt, group, jax.random.split(jax.random.PRNGKey(0),
                                                                                           RANKS), real)
            want.append({k: float(np.asarray(v)) for k, v in logs.items()})
    jm.variables = {"params": params, "state": mstate}
    for r in setup["results"]:
        got = r[("step", focus)]
        for g_logs, w_logs in zip(got["logs"], want):
            assert set(g_logs) == set(w_logs)
            for key in w_logs:
                np.testing.assert_allclose(g_logs[key], w_logs[key], rtol=RTOL, atol=ATOL, err_msg=key)
        _assert_state(got["state"], jm, focus)


def test_dp_fit_with_validation_and_class_weight_matches_jax(setup):
    import gnnkeras_tpu.data.sequencers as jseq
    from gnnkeras_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer
    from torch_port_common import fast_jax_jit

    jm = _jax_model(setup, "g")
    np.random.seed(0)
    seq = _sequencer(jseq, setup["graphs"]["weighted"], shuffle=True)
    val = _sequencer(jseq, setup["graphs"]["val"])
    with fast_jax_jit():
        want = JTrainer(jm, setup["mesh"]).fit(seq, epochs=3, validation_data=val, class_weight={0: 2.0, 1: 0.5},
                                               verbose=0).history
    for r in setup["results"]:
        assert set(r["fit"]) == set(want) == {"loss", "accuracy", "val_loss", "val_accuracy"}
        for key in want:
            np.testing.assert_allclose(r["fit"][key], want[key], rtol=RTOL, err_msg=key)
        _assert_state(r["fit_state"], jm)


def test_dp_ranks_train_on_disjoint_batches_covering_each_epoch(setup):
    """Every epoch: the ranks' own batches (index = group · D + rank; the
    filler re-reads the last) are disjoint and hold every graph once, and
    the shuffled epochs differ."""
    res = setup["results"]
    n_batches = -(-30 // BATCH)
    epochs = []
    for e in range(3):
        seen = []
        for rank, r in enumerate(res):
            own = [ids for epoch, i, ids in r["reads"] if epoch == e and i % RANKS == rank and i < n_batches]
            seen += [g for ids in own for g in ids]
        assert sorted(seen) == list(range(30)), (e, sorted(seen))
        epochs.append([ids for epoch, i, ids in res[0]["reads"] if epoch == e])
    assert epochs[0] != epochs[1] != epochs[2]


def test_dp_resume_ends_where_the_uninterrupted_fit_ends(setup):
    first = setup["results"][0]
    for r in setup["results"]:
        assert r["whole"] == first["whole"] and r["resumed"]["loss"] == first["whole"]["loss"][2:]
        for name, value in first["whole_state"].items():
            np.testing.assert_array_equal(r["resumed_state"][name], value, err_msg=name)
            np.testing.assert_array_equal(r["whole_state"][name], value, err_msg=name)
            np.testing.assert_array_equal(r["fit_state"][name], first["fit_state"][name], err_msg=name)


def test_dp_evaluate_and_predict_are_the_models(setup):
    for r in setup["results"]:
        assert r["evaluate"][0] == r["evaluate"][1]
        np.testing.assert_array_equal(r["predict"][0], r["predict"][1])
