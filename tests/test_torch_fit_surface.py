"""The port's fit surface (``training/fit_loop.py``, ``callbacks.py``,
``checkpoint.py``, ``calibrate.py``) against the JAX package's.

The flagship GNN (same weights in both packages, ``adam:0.01``) trains 4
epochs over two-batch sequencers with a one-batch validation sequencer:

- ``validation_data`` with ``validation_freq`` 1 and 2, and each callback
  (``EarlyStopping`` with ``restore_best_weights``, ``ReduceLROnPlateau``,
  ``TerminateOnNaN``, ``CSVLogger``, ``LambdaCallback``): the History, the
  callbacks' own effects (stop epoch, restored weights, live learning rate,
  CSV rows, hook calls) and the final parameters against JAX's; logs at
  rtol 1e-5 and parameters at rtol 1e-5 / atol 1e-6, as the trainer's
  parity tests hold a fit (``tests/test_torch_training.py``);
- ``recalibrate_batchnorm``: the moving statistics after 3 passes against
  JAX's at rtol 1e-5 / atol 1e-6, the weights untouched.

Checkpoint and resume are the port's own format: a run stopped after 2
epochs and resumed to 4 ends bit for bit where an uninterrupted 4-epoch
run ends (parameters, moving statistics, optimizer state, random stream),
also with dropout drawing from the model's stream.

``fit`` joins the background rebuild that its last epoch's end starts: a
script that ends right after ``fit`` exits with code 0 and no thread left,
and a failing last rebuild raises from ``fit``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.data.sequencers as jseq
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.training.callbacks as jcb
import gnnkeras_tpu.training.calibrate as jcal
import gnnkeras_tpu.training.optimizers as jopt
import gnnkeras_tpu_torch.data.sequencers as tseq
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.training.callbacks as tcb
import gnnkeras_tpu_torch.training.calibrate as tcal
import gnnkeras_tpu_torch.training.optimizers as topt
from gnnkeras_tpu_torch.training.checkpoint import CheckpointCallback, CheckpointManager
from torch_port_common import (assert_stats, fast_jax_jit, flagship_pair, graphs, port_dict, raw_molecules,
                               unique_pairs)

RTOL, ATOL = 1e-5, 1e-6
_RAW = unique_pairs(raw_molecules(n_graphs=12, seed=17))


def _sequencers(seq_mod, graph_mod, **extra):
    train = seq_mod.MultiGraphSequencer(graphs(graph_mod, _RAW[:8]), "g", "average", batch_size=4, shuffle=False,
                                        **extra)
    valid = seq_mod.MultiGraphSequencer(graphs(graph_mod, _RAW[8:]), "g", "average", batch_size=4, shuffle=False,
                                        **extra)
    return train, valid


@pytest.fixture(scope="module")
def setup():
    """The flagship in both packages (same weights, compiled with
    ``adam:0.01``), both packages' sequencers, and a reset to the first
    weights (the JAX model keeps its compiled steps)."""
    with fast_jax_jit():
        jm, tm = flagship_pair(seed=6)
        for m in (jm, tm):
            m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
        j0 = jax.tree_util.tree_map(np.asarray, jm.variables)  # host copies: the JAX step donates
        t0 = {k: v.clone() for k, v in tm.state_dict().items()}
        seqs = _sequencers(jseq, jgraph) + _sequencers(tseq, tgraph, device="cpu")

        def reset():
            jm.variables = jax.tree_util.tree_map(jnp.asarray, j0)
            jm._opt_state, jm._rng = None, jax.random.PRNGKey(0)
            tm.load_state_dict(t0)
            tm._opt = None
            return jm, tm, seqs

        yield reset


def _fit_both(setup, j_kw, t_kw, epochs=4, **kw):
    jm, tm, (js, jv, ts, tv) = setup()
    with fast_jax_jit():
        jh = jm.fit(js, epochs=epochs, validation_data=jv, verbose=0, **kw, **j_kw)
    th = tm.fit(ts, epochs=epochs, validation_data=tv, verbose=0, **kw, **t_kw)
    assert th.epoch == jh.epoch
    assert set(th.keys()) == set(jh.keys())
    for key in jh.keys():
        np.testing.assert_allclose(th[key], jh[key], rtol=RTOL, err_msg=key)
    want = port_dict(jm.variables["params"], "params")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    return jm, tm, jh, th


@pytest.mark.parametrize("freq", [1, 2])
def test_validation_and_its_frequency_match_jax(setup, freq):
    _, _, _, th = _fit_both(setup, {}, {}, validation_freq=freq)
    assert len(th["loss"]) == 4 and len(th["val_loss"]) == 4 // freq
    assert set(th.keys()) == {"loss", "accuracy", "val_loss", "val_accuracy"}


def test_early_stopping_restores_the_best_weights_like_jax(setup):
    """The training loss falls every epoch, so in ``max`` mode it never
    improves after epoch 0: training stops after epoch 2 (patience 1) and
    epoch 0's weights come back."""
    kw = dict(monitor="loss", mode="max", patience=1, restore_best_weights=True)
    jm, tm, jh, th = _fit_both(setup, {"callbacks": [jcb.EarlyStopping(**kw)]},
                               {"callbacks": [tcb.EarlyStopping(**kw)]})
    assert th.epoch == [0, 1, 2]
    assert_stats(dict(tm.named_buffers()), jm.variables["state"], rtol=RTOL, atol=ATOL)
    restored = {k: v.clone() for k, v in tm.state_dict().items()}
    _, one_epoch, _, _ = _fit_both(setup, {}, {}, epochs=1)
    for name, v in one_epoch.state_dict().items():  # epoch 0's weights and statistics
        assert torch.equal(restored[name], v), name


def test_reduce_lr_on_plateau_matches_jax(setup):
    """Every epoch after the first is a plateau in ``max`` mode: the rate
    halves each epoch down to ``min_lr``, the moments kept."""
    kw = dict(monitor="loss", mode="max", patience=0, factor=0.5, min_lr=0.002)
    jm, tm, _, _ = _fit_both(setup, {"callbacks": [jcb.ReduceLROnPlateau(**kw)]},
                             {"callbacks": [tcb.ReduceLROnPlateau(**kw)]})
    assert topt.current_learning_rate(tm._opt) == pytest.approx(0.002)
    assert jopt.current_learning_rate(jm._opt_state) == pytest.approx(0.002)
    assert tm._opt.state_dict()["state"][0]["step"] == 8  # the same Adam state throughout


def test_terminate_on_nan_matches_jax(setup):
    _fit_both(setup, {"callbacks": [jcb.TerminateOnNaN()]}, {"callbacks": [tcb.TerminateOnNaN()]})
    for cb in (jcb.TerminateOnNaN(), tcb.TerminateOnNaN()):
        cb.on_epoch_end(0, {"loss": 0.5})
        assert not cb.stop_training
        cb.on_epoch_end(1, {"loss": float("nan")})
        assert cb.stop_training


def test_csv_logger_matches_jax(setup, tmp_path):
    paths = {name: str(tmp_path / f"{name}.csv") for name in ("jax", "port")}
    _fit_both(setup, {"callbacks": [jcb.CSVLogger(paths["jax"])]}, {"callbacks": [tcb.CSVLogger(paths["port"])]})
    rows = {name: open(path).read().splitlines() for name, path in paths.items()}
    assert rows["port"][0] == rows["jax"][0] == "epoch,accuracy,loss,val_accuracy,val_loss"
    assert len(rows["port"]) == len(rows["jax"]) == 5
    got = np.array([[float(v) for v in r.split(",")] for r in rows["port"][1:]])
    want = np.array([[float(v) for v in r.split(",")] for r in rows["jax"][1:]])
    # 6 significant digits printed: each value rounded by up to 5e-6 of itself
    np.testing.assert_allclose(got, want, rtol=RTOL + 1e-5)
    # append=True keeps the rows and writes no second header
    cb = tcb.CSVLogger(paths["port"], append=True)
    cb.on_train_begin()
    cb.on_epoch_end(4, {"loss": 1.0})
    cb.on_train_end()
    assert open(paths["port"]).read().splitlines()[1:] == rows["port"][1:] + ["4,1"]


def test_lambda_callback_matches_jax(setup):
    calls = {"jax": [], "port": []}

    def hooks(module, name):
        return module.LambdaCallback(on_train_begin=lambda logs: calls[name].append("begin"),
                                     on_epoch_end=lambda epoch, logs: calls[name].append((epoch, sorted(logs))),
                                     on_train_end=lambda logs: calls[name].append("end"))

    _fit_both(setup, {"callbacks": [hooks(jcb, "jax")]}, {"callbacks": [hooks(tcb, "port")]}, validation_freq=2)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 6


def _dropout_gnn(seed=0):
    """The flagship with dropout after the state net's BatchNorm: each step
    draws from the model's random stream."""
    from gnnkeras_tpu_torch import MLP, GNNgraphBased, get_inout_dims

    ins, ls = get_inout_dims("state", 14, 3, 2, "g", 0)
    ino, lo = get_inout_dims("output", 14, 3, 2, "g", 0)
    gnn = GNNgraphBased(MLP(ins[0], ls, "selu", dropout_rate=0.1, dropout_pos=0), MLP(ino[0], lo, "softmax"), 0, 3,
                        0.0).build(seed=seed, device="cpu")
    gnn.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    return gnn


def test_resume_ends_where_the_uninterrupted_run_ends(tmp_path):
    ts, tv = _sequencers(tseq, tgraph, device="cpu")
    whole = _dropout_gnn()
    h_whole = whole.fit(ts, epochs=4, validation_data=tv, verbose=0)

    ck = str(tmp_path / "ck")
    first = _dropout_gnn()
    first.fit(ts, epochs=2, validation_data=tv, verbose=0, checkpoint_dir=ck)
    assert CheckpointManager(ck).all_steps() == [0, 1]
    resumed = _dropout_gnn()
    h_rest = resumed.fit(ts, epochs=4, validation_data=tv, verbose=0, checkpoint_dir=ck, resume=True)
    assert h_rest.epoch == [2, 3]
    for key in h_whole.keys():
        assert h_rest[key] == h_whole[key][2:], key
    for (name, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(whole._rng.get_state(), resumed._rng.get_state())
    opt_a, opt_b = whole._opt.state_dict()["state"], resumed._opt.state_dict()["state"]
    assert opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    with open(os.path.join(ck, "extra_3.json")) as f:
        assert json.load(f)["epoch"] == 3


def test_checkpoints_cross_boundaries_and_keep_the_newest(tmp_path):
    """``checkpoint_every=3`` over 4 epochs saves after epoch 2 (the
    boundary) and after the last; ``max_to_keep`` drops the oldest files;
    a restore without its sidecar refuses to guess the epoch."""
    ts, _ = _sequencers(tseq, tgraph, device="cpu")
    gnn = _dropout_gnn()
    ck = str(tmp_path / "every3")
    gnn.fit(ts, epochs=4, verbose=0, checkpoint_dir=ck, checkpoint_every=3)
    assert CheckpointManager(ck).all_steps() == [2, 3]
    cb = CheckpointCallback(str(tmp_path / "cb"), every_epochs=1, max_to_keep=2)
    gnn.fit(ts, epochs=3, verbose=0, callbacks=[cb])
    assert cb.manager.all_steps() == [1, 2]
    assert sorted(os.listdir(cb.manager.directory)) == ["ckpt_1.pt", "ckpt_2.pt", "extra_1.json", "extra_2.json"]
    os.unlink(os.path.join(cb.manager.directory, "extra_2.json"))
    with pytest.raises(RuntimeError, match="sidecar"):
        cb.manager.restore(_dropout_gnn())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_dropout_gnn())


def test_recalibrate_batchnorm_matches_jax(setup):
    jm, tm, (js, _, ts, _) = setup()
    before = {k: v.clone() for k, v in tm.named_parameters()}
    mean0 = tm.net_state.layers[0].moving_mean.clone()
    with fast_jax_jit():
        jcal.recalibrate_batchnorm(jm, js, passes=3, seed=0)
    assert tcal.recalibrate_batchnorm(tm, ts, passes=3, seed=0) is tm
    assert_stats(dict(tm.named_buffers()), jm.variables["state"], rtol=RTOL, atol=ATOL)
    for name, p in tm.named_parameters():
        assert torch.equal(p, before[name]), name
    # the statistics moved: 3 passes of 2 batches at momentum 0.99
    assert not torch.equal(tm.net_state.layers[0].moving_mean, mean0)


_FIT_AND_EXIT = """
import threading
import numpy as np
import torch
from gnnkeras_tpu_torch.data import MultiGraphSequencer
from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules
torch.set_num_threads(1)
np.random.seed(0)
seq = MultiGraphSequencer(random_molecules(8, seed=1, max_nodes=20), "g", "average", batch_size=4, device="cpu")
model = flagship_gnn("cpu", seed=0)
model.compile(optimizer="adam:0.01", loss="categorical_crossentropy")
model.fit(seq, epochs=1, verbose=0)
print("threads", threading.active_count())
"""


def test_a_script_ending_right_after_fit_exits_cleanly():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _FIT_AND_EXIT], capture_output=True, text=True, timeout=300,
                         cwd=repo)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-2:] == ["threads", "1"], res.stdout


def test_fit_raises_a_failing_last_rebuild(monkeypatch):
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules

    np.random.seed(0)
    seq = tseq.MultiGraphSequencer(random_molecules(8, seed=1, max_nodes=20), "g", "average", batch_size=4,
                                   device="cpu")
    model = flagship_gnn("cpu", seed=0)
    model.compile(optimizer="adam:0.01", loss="categorical_crossentropy")

    def fail():
        raise ValueError("merge failed")

    monkeypatch.setattr(seq, "build_batches", fail)
    with pytest.raises(RuntimeError, match="background batch rebuild failed"):
        model.fit(seq, epochs=1, verbose=0)
    assert seq._pending_build is None
