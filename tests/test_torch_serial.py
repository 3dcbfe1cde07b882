"""Serial LGNN training (``gnnkeras_tpu_torch.training.serial``) against the
JAX package's ``fit_serial``.

A 3-layer homogeneous LGNN (flagship layers, dim_state 0, get_state and
get_output, ``average_st_grads``) trains 2 epochs a layer with validation
in both packages from the same weights, over multi-graph sequencers
shuffled from the same NumPy seed, baking one graph at a time
(``bake_batch_size=1``) and 3 at a time; then ``evaluate`` and
``predict``.  A 2-layer composite LGNN trains over a transductive
sequencer.  The no-re-initialisation test needs no JAX.

The parity runs train with SGD (lr 0.1): Adam's first steps, lr·g/(|g| +
eps), turn an f32 difference in a gradient entry near zero into a
parameter difference of up to 2·lr, and a layer trains on the features
the layers below baked, so such a difference grows layer by layer (an
Adam run of this stack: logs 2e-3 apart at layer 2).  With SGD the
per-epoch logs agree to rtol 1e-5 (measured: 3.4e-7), the parameters and
moving statistics to rtol 1e-5 / atol 1e-5 (f32 sums in other orders
through three trained layers), the predictions to rtol 1e-5 / atol 1e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.data.sequencers as jseq
import gnnkeras_tpu.data.transductive as jtrans
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.models.composite as jcomp
import gnnkeras_tpu.models.lgnn as jlgnn
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.data.sequencers as tseq
import gnnkeras_tpu_torch.data.transductive as ttrans
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.models.composite as tcomp
import gnnkeras_tpu_torch.models.lgnn as tlgnn
import gnnkeras_tpu_torch.models.mlp as tmlp
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import (assert_stats, fast_jax_jit, graphs, lgnn_pair, node_targets, port_dict,
                               raw_molecules, unique_pairs)

RTOL, ATOL = 1e-5, 1e-5
_RAW = unique_pairs(raw_molecules(n_graphs=10, seed=21))


@pytest.fixture(scope="module")
def stacks():
    """The JAX and port LGNNs (same weights, compiled for serial training)
    and a reset to those weights: each test starts from them, and the JAX
    layers keep their compiled steps."""
    with fast_jax_jit():
        jm, tm = lgnn_pair(False, "g", 0, 3, seed=3)
        for m in (jm, tm):
            m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"],
                      training_mode="serial", average_st_grads=True)
        # host copies: the JAX train step donates the arrays it is given
        j0 = jax.tree_util.tree_map(np.asarray, jm.variables)
        t0 = {k: v.clone() for k, v in tm.state_dict().items()}

        def reset():
            jm.variables = jax.tree_util.tree_map(jnp.asarray, j0)
            for g in jm.gnns:
                g._opt_state, g._rng = None, jax.random.PRNGKey(0)
            tm.load_state_dict(t0)
            for g in tm.gnns:
                g._opt, g._rng = None, torch.Generator().manual_seed(0)
            return jm, tm

        yield reset


def _sequencers(module, graph_module, raw, **kw):
    extra = {"device": "cpu"} if module is tseq else {}
    train = module.MultiGraphSequencer(graphs(graph_module, raw), "g", "average", batch_size=4, **kw, **extra)
    valid = module.MultiGraphSequencer(graphs(graph_module, raw[:4]), "g", "average", batch_size=4, shuffle=False,
                                       **extra)
    return train, valid


def _assert_histories(th, jh):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert set(t.keys()) == set(j.keys())
        for key in j.keys():
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("bake_batch_size", [1, 3])
def test_serial_fit_matches_jax(stacks, bake_batch_size):
    jm, tm = stacks()
    with fast_jax_jit():
        np.random.seed(0)
        js, jv = _sequencers(jseq, jgraph, _RAW)
        jh = jm.fit(js, epochs=2, validation_data=jv, verbose=0, bake_batch_size=bake_batch_size)
        np.random.seed(0)
        ts, tv = _sequencers(tseq, tgraph, _RAW)
        th = tm.fit(ts, epochs=2, validation_data=tv, verbose=0, bake_batch_size=bake_batch_size)
        assert len(th) == 3 and all(h.epoch == [0, 1] for h in th)
        _assert_histories(th, jh)
        want = port_dict(jm.variables["params"], "params")
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
        # the bakes' BatchNorm commits (per graph or per chunk) included
        assert_stats(dict(tm.named_buffers()), jm.variables["state"], rtol=RTOL, atol=ATOL)

        # the trained stack: evaluate and predict read the last layer
        ev_t, ev_j = tm.evaluate(tv), jm.evaluate(jv)
        assert set(ev_t) == set(ev_j)
        for key in ev_j:
            np.testing.assert_allclose(ev_t[key], ev_j[key], rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(tm.predict(tv), jtr.predict(jm, jv), rtol=RTOL, atol=1e-6)
    ts.wait_for_rebuild()
    js._join_pending()


def test_layers_keep_the_stack_weights_before_their_first_step(monkeypatch):
    """Each layer's ``fit`` builds it; it must train from the stack's
    weights, not re-initialise them: the weights a layer holds at its first
    train step are those it had before ``fit`` (the layers below train and
    bake first)."""
    _, tm = lgnn_pair(False, "g", 0, 3, seed=5)
    tm.compile(optimizer="adam:0.01", loss="categorical_crossentropy", training_mode="serial")
    before = [{k: v.clone() for k, v in g.state_dict().items()} for g in tm.gnns]
    assert all(g.built and g.device.type == "cpu" and g._rng.initial_seed() == 0 for g in tm.gnns)
    first = {}
    real = ttr.train_step

    def spy(model, batch, generator=None):
        first.setdefault(id(model), {k: v.clone() for k, v in model.state_dict().items()})
        return real(model, batch, generator)

    monkeypatch.setattr(ttr, "train_step", spy)
    ts, _ = _sequencers(tseq, tgraph, _RAW[:6])
    tm.fit(ts, epochs=1, verbose=0)
    assert len(first) == 3
    for g, want in zip(tm.gnns, before):
        got = first[id(g)]
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert any(not torch.equal(v, want[k]) for k, v in g.state_dict().items())  # and then it trained


def _transductive_clgnn(mlp, comp, lgnn, layers=2):
    """A CompositeLGNN over the transduction's 2 node types (label widths
    14 and 16), dim_state 0 (the state is the whole label), node focus:
    each layer prepends the state and the 2-wide output below."""
    gnns, dims = [], (14, 16)
    for _ in range(layers):
        width = dims[-1]
        nets = [mlp.MLP(input_dim=(d_t + 2 * width + sum(dims) + 3,), layers=[width], activations="selu",
                        kernel_initializer="lecun_normal", bias_initializer="lecun_normal") for d_t in dims]
        out = mlp.MLP(input_dim=(width,), layers=[2], activations="softmax", kernel_initializer="glorot_normal",
                      bias_initializer="glorot_normal")
        gnns.append(comp.CompositeGNNnodeBased(nets, out, 0, 3, 0.0))
        dims = tuple(d + width + 2 for d in dims)
    return lgnn.CompositeLGNN(gnns, True, True)


def test_serial_fit_over_a_transductive_sequencer_matches_jax():
    raw = node_targets(_RAW[:6], seed=2)
    with fast_jax_jit():
        jm = _transductive_clgnn(jmlp, jcomp, jlgnn)
        jm.build(seed=4)
        tm = _transductive_clgnn(tmlp, tcomp, tlgnn).build(seed=4, device="cpu")
        tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
        hists = []
        for m, seq_mod, graph_mod, extra in ((jm, jtrans, jgraph, {}), (tm, ttrans, tgraph, {"device": "cpu"})):
            m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", metrics=["accuracy"],
                      training_mode="serial")
            np.random.seed(6)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                seq = seq_mod.TransductiveMultiGraphSequencer(graphs(graph_mod, raw, focus="n"), "n", "average", 0.5,
                                                              batch_size=3, **extra)
                hists.append(m.fit(seq, epochs=2, verbose=0, bake_batch_size=3))
        _assert_histories(hists[1], hists[0])
        want = port_dict(jm.variables["params"], "params")
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def test_serial_needs_one_callback_list_per_layer(stacks):
    _, tm = stacks()
    ts, _ = _sequencers(tseq, tgraph, _RAW[:4])
    with pytest.raises(ValueError, match="one callback list per layer"):
        tm.fit(ts, callbacks=[[]], verbose=0)
