"""The scanned epoch (``fit(scan_batches=...)``, ``evaluate(scan_batches=...)``,
``training/trainer.py``) against the JAX package's one-launch ``lax.scan``
epoch, on the CPU, and the captured CUDA graph on the card.

On the CPU (the plain version: the same steps run eagerly):

- JAX's ``fit(scan_batches=True)`` against the port's for the flagship GNN
  (Adam), a 2-layer LGNN in ``parallel`` mode (SGD: with Adam, f32 noise
  in a near-zero gradient of layer 1 moves an entry by up to 2·lr, as
  ``tests/test_torch_serial.py`` notes) and a 3-type composite GNN at
  dim_state 10 (Adam) (its initial states: JAX's draws from the model's key
  stream, fed to the port), 3 epochs over shuffled sequencers of two
  batches (a rebuild after each epoch, as in both packages): the History
  at rtol 1e-5 and the parameters and moving statistics at rtol 1e-5 /
  atol 1e-6, the tolerances ``tests/test_torch_fit_surface.py`` holds a
  per-step fit to;
- the port's scanned fit equals its per-step fit bit for bit (History,
  state dict, random stream), with class weights, validation (the
  scanned evaluate's fixed-length loop against the ``while`` loop) and
  the dim_state 10 model's own random draws;
- the automatic choice falls back where JAX's ``_try_stack`` does: one
  batch, batches of two structures, ``SingleGraphSequencer``;
- ``evaluate(scan_batches=True)`` against JAX's at rtol 1e-5;
- ``ReduceLROnPlateau`` halving the rate mid-fit, against JAX's;
- a scanned fit resumed from its checkpoint, and one stopped by
  ``EarlyStopping(restore_best_weights=True)``, end bit for bit where the
  uninterrupted scanned fit (or its first epoch) ends;
- ``predict(seed=...)`` draws from a local stream and leaves the model's.

On the card (skipped without one; ``--noconftest -m cuda``, no JAX):
the captured epoch against the per-step epoch, a new capture after the
pads grow and after the optimizer's tensors are replaced (none after a
checkpoint restore, which copies in place), ``set_learning_rate``
reaching a replay, the scanned evaluate, and a capture error that
propagates instead of falling back to the per-step loop.
"""

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6


# -- the CPU against the JAX package -----------------------------------------------


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and the shared test helpers."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    import jax

    import gnnkeras_tpu.data.sequencers as jseq
    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu.training.callbacks as jcb
    import gnnkeras_tpu.training.optimizers as jopt
    import gnnkeras_tpu.training.trainer as jtr
    import torch_port_common as common

    return SimpleNamespace(jax=jax, jseq=jseq, jgraph=jgraph, jcb=jcb, jopt=jopt, jtr=jtr, c=common)


def _raw(jx, n=8, seed=17):
    return jx.c.unique_pairs(jx.c.raw_molecules(n_graphs=n, seed=seed))


def _sequencers(jx, kind, raw, shuffle=True, batch_size=4):
    """The same sequencer in both packages (the port's on the CPU)."""
    import gnnkeras_tpu_torch.data.sequencers as tseq
    import gnnkeras_tpu_torch.graph.graph as tgraph

    kw = dict(batch_size=batch_size, shuffle=shuffle, slot_pack=128, strip_dtype="float32")
    if kind == "cgnn":
        return (jx.jseq.CompositeMultiGraphSequencer(jx.c.composite_graphs(jx.jgraph, raw), "g",
                                                     "composite_average", **kw),
                tseq.CompositeMultiGraphSequencer(jx.c.composite_graphs(tgraph, raw), "g", "composite_average",
                                                  device="cpu", **kw))
    return (jx.jseq.MultiGraphSequencer(jx.c.graphs(jx.jgraph, raw), "g", "average", **kw),
            tseq.MultiGraphSequencer(jx.c.graphs(tgraph, raw), "g", "average", device="cpu", **kw))


def _models(jx, kind, optimizer="adam:0.01"):
    if kind == "flagship":
        jm, tm = jx.c.flagship_pair(seed=6)
        mode = {}
    elif kind == "lgnn":
        jm, tm = jx.c.lgnn_pair(composite=False, focus="g", ds=0, layers=2, seed=4)
        mode = {"training_mode": "parallel"}
    else:
        jm, tm = jx.c.cgnn_pair("g", ds=10, seed=3)
        mode = {}
    for m in (jm, tm):
        m.compile(optimizer=optimizer, loss="categorical_crossentropy", metrics=["accuracy"], **mode)
    return jm, tm


def _feed_jax_stream(jx, monkeypatch, jm):
    """The port's dim_state > 0 initial states drawn as JAX draws them in
    its fit: one key a step from the model's stream (``next_rng``), whose
    first half after a split seeds the draw."""
    import gnnkeras_tpu_torch.models.gnn as tgnn

    key = [jm._rng]

    def draw(n, ds, generator, device):
        key[0], sub = jx.jax.random.split(key[0])
        return torch.tensor(jx.c.jax_init_draw(sub, n, ds), device=device)

    monkeypatch.setattr(tgnn, "initial_state", draw)


def _assert_like_jax(jx, jm, tm, jh, th):
    assert th.epoch == jh.epoch and set(th.keys()) == set(jh.keys())
    for key in jh.keys():
        np.testing.assert_allclose(th[key], jh[key], rtol=RTOL, err_msg=key)
    want = jx.c.port_dict(jm.variables["params"], "params")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    jx.c.assert_stats(dict(tm.named_buffers()), jm.variables["state"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["flagship", "lgnn", "cgnn"])
def test_scanned_fit_matches_jax(jx, kind, monkeypatch):
    raw = _raw(jx)
    jm, tm = _models(jx, kind, "sgd:0.1" if kind == "lgnn" else "adam:0.01")
    js, ts = _sequencers(jx, kind, raw)
    if kind == "cgnn":
        _feed_jax_stream(jx, monkeypatch, jm)
    with jx.c.fast_jax_jit():
        np.random.seed(5)
        jh = jm.fit(js, epochs=3, verbose=0, scan_batches=True)
    np.random.seed(5)
    th = tm.fit(ts, epochs=3, verbose=0, scan_batches=True)
    assert "train" in tm._scan and len(ts) == 2  # the scanned path ran
    _assert_like_jax(jx, jm, tm, jh, th)


def _fit_twice(make, fit_kw, seqs):
    """Two runs of ``make()``'s model from one NumPy seed, scanned and
    per-step."""
    out = []
    for scan in (True, False):
        model = make()
        train, valid = seqs()
        np.random.seed(7)
        history = model.fit(train, epochs=3, verbose=0, validation_data=valid, scan_batches=scan, **fit_kw)
        out.append((model, history))
    return out


def test_scanned_fit_equals_the_per_step_fit_bit_for_bit(jx):
    raw = _raw(jx, n=12)
    _, base = _models(jx, "cgnn")
    weights = {k: v.clone() for k, v in base.state_dict().items()}

    def make():
        model = base.copy(copy_weights=False)
        model.build(seed=0, device="cpu")
        model.load_state_dict(weights)
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
        return model

    def seqs():
        train = _sequencers(jx, "cgnn", raw[:8])[1]
        valid = _sequencers(jx, "cgnn", raw[8:], shuffle=False, batch_size=2)[1]
        return train, valid

    (scanned, hs), (stepped, hp) = _fit_twice(make, {"class_weight": {0: 2.0, 1: 0.5}}, seqs)
    assert "train" in scanned._scan and "eval" in scanned._scan and not stepped._scan
    assert hs.history == hp.history and set(hs.keys()) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    for (name, a), b in zip(scanned.state_dict().items(), stepped.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(scanned._rng.get_state(), stepped._rng.get_state())


def test_auto_falls_back_where_jax_does(jx):
    import gnnkeras_tpu.graph.batch as jbatch
    import gnnkeras_tpu_torch.data.sequencers as tseq
    import gnnkeras_tpu_torch.graph.batch as tbatch
    import gnnkeras_tpu_torch.training.trainer as ttr

    raw = _raw(jx)
    js, ts = _sequencers(jx, "flagship", raw, shuffle=False)
    both = [(js, [js[i] for i in range(len(js))]), (ts, [ts[i] for i in range(len(ts))])]
    assert jx.jtr._try_stack(both[0][1], cache_host=js) is not None
    assert ttr._scan_structure(both[1][1], ts) is not None
    # one batch
    assert jx.jtr._try_stack(both[0][1][:1]) is None and ttr._scan_structure(both[1][1][:1], None) is None
    # two structures: the second batch padded further
    jg, tg = jx.c.merged_pair(raw[:4])
    jg2, tg2 = jx.c.merged_pair(raw[4:])
    mixed_j = [jbatch.from_graph_object(jg), jbatch.from_graph_object(jg2, pad_nodes=512)]
    mixed_t = [tbatch.from_graph_object(tg, device="cpu"), tbatch.from_graph_object(tg2, pad_nodes=512, device="cpu")]
    assert jx.jtr._try_stack(mixed_j) is None and ttr._scan_structure(mixed_t, None) is None
    # the single-graph sequencers opt out (test_single_graph_sequencer_steps_per_batch)
    assert jx.jseq.SingleGraphSequencer.scan_stack_ok is False and tseq.SingleGraphSequencer.scan_stack_ok is False
    # the fit over mixed batches runs the per-step loop: equal to scan_batches=False
    _, tm = _models(jx, "flagship")
    other = tm.copy()
    other.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    h1 = tm.fit(jx.c.Batches(mixed_t), epochs=2, verbose=0, scan_batches=True)
    h2 = other.fit(jx.c.Batches(mixed_t), epochs=2, verbose=0, scan_batches=False)
    assert h1.history == h2.history and not tm._scan.get("train")


def test_single_graph_sequencer_steps_per_batch(jx):
    import gnnkeras_tpu_torch.data.sequencers as tseq
    import gnnkeras_tpu_torch.training.trainer as ttr
    from gnnkeras_tpu_torch.data.synthetic import random_molecules
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    g = GraphObject.merge(random_molecules(6, seed=3, max_nodes=12), "g", "average")
    node = GraphObject(nodes=g.nodes, arcs=g.arcs, targets=np.eye(2, dtype=np.float32)[np.arange(len(g.nodes)) % 2],
                       focus="n", aggregation_mode="average")
    single = tseq.SingleGraphSequencer(node, "n", batch_size=10, device="cpu")
    batches = [single[i] for i in range(len(single))]
    assert len(batches) >= 2 and ttr._scan_structure(batches, single) is None
    assert ttr._scan_structure(batches, None) is not None  # the same batches would stack, as in JAX


def test_scanned_evaluate_matches_jax(jx):
    raw = _raw(jx)
    jm, tm = _models(jx, "flagship")
    js, ts = _sequencers(jx, "flagship", raw, shuffle=False)
    with jx.c.fast_jax_jit():
        want = jm.evaluate(js, scan_batches=True, prefix="val_")
    got = tm.evaluate(ts, scan_batches=True, prefix="val_")
    assert "eval" in tm._scan and set(got) == set(want) == {"val_loss", "val_accuracy"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert tm.evaluate(ts, scan_batches=False, prefix="val_") == got  # the while loop's logs, bit for bit


def test_reduce_lr_on_plateau_mid_scanned_fit_matches_jax(jx):
    """In ``max`` mode every epoch after the first is a plateau: the rate
    halves each epoch, down to ``min_lr``, the moments kept."""
    raw = _raw(jx)
    jm, tm = _models(jx, "flagship")
    js, ts = _sequencers(jx, "flagship", raw)
    kw = dict(monitor="loss", mode="max", patience=0, factor=0.5, min_lr=0.003)
    with jx.c.fast_jax_jit():
        np.random.seed(9)
        jh = jm.fit(js, epochs=3, verbose=0, scan_batches=True, callbacks=[jx.jcb.ReduceLROnPlateau(**kw)])
    import gnnkeras_tpu_torch.training.callbacks as tcb
    import gnnkeras_tpu_torch.training.optimizers as topt

    np.random.seed(9)
    th = tm.fit(ts, epochs=3, verbose=0, scan_batches=True, callbacks=[tcb.ReduceLROnPlateau(**kw)])
    _assert_like_jax(jx, jm, tm, jh, th)
    assert topt.current_learning_rate(tm._opt) == pytest.approx(0.003)
    assert jx.jopt.current_learning_rate(jm._opt_state) == pytest.approx(0.003)


def test_predict_with_a_seed_leaves_the_model_stream(jx):
    """``predict(seed=...)`` draws a dim_state 10 model's initial states
    from a local stream (JAX ``trainer.py:383-391``): two calls agree, the
    model's own stream does not move, and without a seed it does."""
    _, tm = _models(jx, "cgnn")
    _, ts = _sequencers(jx, "cgnn", _raw(jx), shuffle=False)
    state = tm._rng.get_state()
    a, b = tm.predict(ts, seed=3), tm.predict(ts, seed=3)
    assert np.array_equal(a, b) and torch.equal(tm._rng.get_state(), state)
    assert not np.array_equal(a, tm.predict(ts, seed=4))
    tm.predict(ts)
    assert not torch.equal(tm._rng.get_state(), state)


def _dropout_cgnn(jx):
    """A dim_state 10 composite GNN with dropout in its state nets: every
    step draws from the model's stream twice over (state and masks)."""
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.mlp as tmlp

    nets, out = jx.c.composite_nets(tmlp, "g", 10)
    for net in nets:
        cfg = net.get_config()
        cfg.update(dropout_rate=0.1, dropout_pos=0)
        nets[nets.index(net)] = tmlp.MLP.from_config(cfg)
    model = tcomp.CompositeGNNgraphBased(nets, out, 10, 4, 0.0).build(seed=0, device="cpu")
    model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    return model


def test_resumed_and_early_stopped_scanned_fits_keep_the_trajectory(jx, tmp_path):
    import gnnkeras_tpu_torch.training.callbacks as tcb

    raw = _raw(jx)

    def fit(model, epochs, **kw):
        np.random.seed(11)
        return model.fit(_sequencers(jx, "cgnn", raw)[1], epochs=epochs, verbose=0, scan_batches=True, **kw)

    whole = _dropout_cgnn(jx)
    h_whole = fit(whole, 4)
    ck = str(tmp_path / "ck")
    fit(_dropout_cgnn(jx), 2, checkpoint_dir=ck)
    resumed = _dropout_cgnn(jx)
    # the resumed run replays NumPy's shuffles of epochs 0-1 first
    np.random.seed(11)
    seq = _sequencers(jx, "cgnn", raw)[1]
    for _ in range(2):
        seq.on_epoch_end()
    seq.wait_for_rebuild()
    h_rest = resumed.fit(seq, epochs=4, verbose=0, scan_batches=True, checkpoint_dir=ck, resume=True)
    assert h_rest.epoch == [2, 3] and h_rest["loss"] == h_whole["loss"][2:]
    for (name, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(whole._rng.get_state(), resumed._rng.get_state())

    stopped = _dropout_cgnn(jx)
    early = tcb.EarlyStopping(monitor="loss", mode="max", patience=1, restore_best_weights=True)
    assert fit(stopped, 4, callbacks=[early]).epoch == [0, 1, 2]
    first = _dropout_cgnn(jx)
    fit(first, 1)
    for (name, a), b in zip(first.state_dict().items(), stopped.state_dict().values()):
        assert torch.equal(a, b), name


# -- the card ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the captured CUDA graph)")
    from gnnkeras_tpu_torch import kernels

    kernels.build_all()
    return torch.device("cuda")


def _card_model(seed=0):
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn

    model = flagship_gnn("cuda", seed=seed)
    model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    return model


def _card_sequencer(n=60, batch_size=20, seed=1, max_nodes=30, **kw):
    from gnnkeras_tpu_torch.data import MultiGraphSequencer
    from gnnkeras_tpu_torch.data.synthetic import random_molecules

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strips
        return MultiGraphSequencer(random_molecules(n, seed=seed, max_nodes=max_nodes), "g", "average",
                                   batch_size=batch_size, slot_pack=128, strip_dtype="int8", device="cuda", **kw)


def _card_fit(scan, epochs=2, **kw):
    model = _card_model()
    np.random.seed(3)
    history = model.fit(_card_sequencer(), epochs=epochs, verbose=0, scan_batches=scan, **kw)
    torch.cuda.synchronize()
    return model, history


@pytest.mark.cuda
def test_captured_epoch_equals_the_per_step_epoch_on_card(card):
    captured, hc = _card_fit(True)
    entry = next(iter(captured._scan["train"].values()))
    assert entry.graph is not None
    stepped, hs = _card_fit(False)
    again, ha = _card_fit(False)
    deterministic = ha.history == hs.history and all(
        torch.equal(a, b) for a, b in zip(stepped.state_dict().values(), again.state_dict().values()))
    for key in hs.keys():
        np.testing.assert_allclose(hc[key], hs[key], rtol=RTOL, err_msg=key)
    for (name, a), b in zip(captured.state_dict().items(), stepped.state_dict().values()):
        if deterministic:
            assert torch.equal(a, b), name
        else:
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.cuda
def test_captured_evaluate_on_card(card):
    model = _card_model()
    seq = _card_sequencer()
    got = model.evaluate(seq, scan_batches=True)
    want = model.evaluate(seq, scan_batches=False)
    assert "eval" in model._scan
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def _why_new(old, new, model):
    """Why ``new`` replaced the capture ``old``: another structure, or other
    tensors than ``old`` captured."""
    from gnnkeras_tpu_torch.training.trainer import _addresses

    now = _addresses(model)
    return {"same_key": old.key == new.key, "same_optimizer": old.addresses[0] == now[0],
            "moved": [i for i, (a, b) in enumerate(zip(old.addresses[1], now[1])) if a != b]}


class _Growing:
    """Two batches of one sequencer, then from the second epoch on the same
    molecules' two batches padded further (a sequencer of a larger
    ``pad_multiple``): the structure changes as when a rebuild grows the
    pads."""

    def __init__(self):
        self.sets = [_card_sequencer(n=40, seed=4, shuffle=False, pad_multiple=pad).batches for pad in (128, 1024)]
        self.epoch = 0

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return self.sets[min(self.epoch, 1)][i]

    def on_epoch_end(self):
        self.epoch += 1


@pytest.mark.cuda
def test_recapture_after_pad_growth_and_a_replaced_optimizer_state_on_card(card, tmp_path):
    model = _card_model()
    seq = _Growing()
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    first = next(iter(model._scan["train"].values()))
    model.fit(seq, epochs=2, verbose=0, scan_batches=True)  # the pads grow: a new capture, replayed once more
    second = next(iter(model._scan["train"].values()))
    assert second is not first and second.key != first.key
    # a checkpoint restore copies into the live tensors: the capture stays
    from gnnkeras_tpu_torch.training.checkpoint import CheckpointManager

    manager = CheckpointManager(str(tmp_path / "ck"))
    manager.save(0, model, extra={"epoch": 0})
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    manager.restore(model)
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    latest = next(iter(model._scan["train"].values()))
    assert latest is second, _why_new(second, latest, model)
    # a restore that replaces the optimizer's tensors (PyTorch's own
    # load_state_dict) makes the next epoch capture again
    torch.optim.Optimizer.load_state_dict(model._opt, model._opt.state_dict())
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    third = next(iter(model._scan["train"].values()))
    assert third is not second and third.graph is not None


@pytest.mark.cuda
def test_set_learning_rate_reaches_a_replay_on_card(card):
    from gnnkeras_tpu_torch.training.optimizers import set_learning_rate

    model = _card_model()
    seq = _card_sequencer(shuffle=False)  # the same batches every epoch: one capture
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    entry = next(iter(model._scan["train"].values()))
    set_learning_rate(model._opt, 0.0)
    before = [p.detach().clone() for p in model.parameters()]
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))  # a zero rate moves nothing
    set_learning_rate(model._opt, 0.01)
    model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    assert not all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    latest = next(iter(model._scan["train"].values()))
    assert latest is entry, _why_new(entry, latest, model)


@pytest.mark.cuda
def test_a_capture_error_propagates_on_card(card, monkeypatch):
    """A host read inside the step cannot be captured: ``fit`` raises it
    and does not fall back to the per-step loop."""
    import gnnkeras_tpu_torch.training.trainer as ttr

    real = ttr._step_logs

    def reads_the_host(model, loss, y_pred, batch):
        float(loss)  # a device-to-host copy: illegal while capturing
        return real(model, loss, y_pred, batch)

    model = _card_model()
    seq = _card_sequencer()
    monkeypatch.setattr(ttr, "_step_logs", reads_the_host)
    with pytest.raises(RuntimeError):
        model.fit(seq, epochs=1, verbose=0, scan_batches=True)
    torch.cuda.synchronize()
