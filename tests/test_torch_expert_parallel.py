"""Expert parallelism (``gnnkeras_tpu_torch/parallel/expert.py``) against
the JAX package's ``gnnkeras_tpu.parallel.expert`` on the CPU.

- ``stack_expert_params`` / ``unstack_expert_params``: array for array
  against JAX's, with and without ``label_widths``, and their round trip
  (exact).
- The port runs on 4 gloo ranks spawned once for the module
  (``port_results``): as one 4-rank expert group (1 expert a rank) and as two
  2-rank groups (a 2 × 2 mesh, 2 experts a rank).  JAX runs on a 4-device
  ``expert`` mesh of the conftest's CPU devices.
- The forward of ``tests/test_expert_parallel.py``'s dim_state-0 graph
  (4 types) on both groupings against JAX's ``ExpertParallelCompositeGNN.
  forward``: k equal, state and output at rtol 1e-5 / atol 1e-6.
- One SGD step with L2 regularizers on 4 ranks against JAX's expert-parallel
  step: loss at rtol 1e-5, the output head and every expert (padding rows
  removed) at rtol 1e-4 / atol 1e-6 (JAX's own test's bounds).
- One Adam step with ``average_st_grads`` of the 3-type molecule model
  (types padded to 4: rank 3 holds an expert of zero parameters) on both
  groupings against JAX's single-device train step: loss at rtol 1e-5; k
  equal; parameters at rtol 1e-4 / atol 1e-6 where Adam's first step is
  not steep in the gradient (``torch_port_common.adam_live``); the padded
  expert's parameters and gradients exactly zero.  The training-mode
  forward of that model against JAX's single-device one, at rtol 1e-5 /
  atol 1e-6.
- Dropout: the expert-parallel forward with active dropout equals the
  wrapped model's forward bit for bit from the same generator (the port's
  own draws; JAX's keys are another stream), on the row-major and the
  feature-major (strip) engine.
- ``fit``: the trained experts reach the wrapped model (its forward equals
  the engine's), every rank logs the same History, validation runs, and a
  run resumed from its checkpoint ends where the whole run ends.
- The refusals: ``per_iteration_bn``, homogeneous models and per-type nets
  of different programs.

This module imports JAX only inside its fixtures and tests, so the ranks,
which import it to find ``_rank_cases``, import no JAX.
"""

import sys

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

RANKS = 4
RTOL, ATOL = 1e-5, 1e-6


# -- graphs and models (NumPy specs, both packages) ------------------------------------


def _graph_spec(seed, n=40, a=150, n_types=4):
    """``tests/test_expert_parallel.py``'s composite graph as NumPy arrays."""
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(2, 6, n_types))
    nodes = rng.normal(size=(n, max(dims)))
    arcs = np.concatenate([rng.integers(0, n, (a, 2)), rng.normal(size=(a, 2))], axis=1)
    tm = np.zeros((n, n_types), dtype=bool)
    tm[np.arange(n), rng.integers(0, n_types, n)] = True
    return dict(nodes=nodes, arcs=arcs, targets=rng.normal(size=(n, 2)), type_mask=tm, dim_node_label=dims,
                focus="n", aggregation_mode="composite_average")


def _graph(module, spec):
    return module.CompositeGraphObject(**spec)


def _ds0_nets(module, spec, reg=None):
    """The dim_state-0 per-type nets (the model's own input widths) and
    the output net of ``tests/test_expert_parallel.py``."""
    width = spec["nodes"].shape[1]
    comp_w = int(np.sum(spec["dim_node_label"])) + spec["arcs"].shape[1] - 2
    nets = [module.MLP(input_dim=(int(d_t) + 2 * width + comp_w,), layers=[width], activations="selu",
                       kernel_initializer="lecun_normal", bias_initializer="lecun_normal", kernel_regularizer=reg)
            for d_t in spec["dim_node_label"]]
    out = module.MLP(input_dim=(width,), layers=[2], activations="softmax", kernel_initializer="glorot_normal",
                     bias_initializer="glorot_normal", kernel_regularizer=reg)
    return nets, out


def _port_ds0_model(spec, state, reg=None):
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = tcomp.CompositeGNNnodeBased(*_ds0_nets(tmlp, spec, reg), 0, 4, 0.01).build(seed=0, device="cpu")
    m.load_state_dict(state)
    return m


def _typed_raw():
    """20 molecules of the 3 atom types (``torch_port_common``'s inputs)."""
    import torch_port_common as C

    return C.raw_molecules(n_graphs=20, seed=3)


def _port_typed(state, raw, slot=False):
    """The port's 3-type graph-focused model with the JAX model's weights,
    and the merged batch of ``raw`` (strip-packed with ``slot``)."""
    import gnnkeras_tpu_torch.graph.graph as tgraph
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.mlp as tmlp
    from gnnkeras_tpu_torch import from_graph_object

    TYPE_BOUNDS = (5, 10, 14)
    graphs = []
    for n, a, t in raw:
        types = np.searchsorted(TYPE_BOUNDS[:-1], np.argmax(n, axis=1), side="right")
        graphs.append(tgraph.CompositeGraphObject(nodes=n, arcs=a, targets=t, type_mask=np.eye(3, dtype=bool)[types],
                                                  dim_node_label=TYPE_BOUNDS, focus="g",
                                                  aggregation_mode="composite_average"))
    merged = tgraph.CompositeGraphObject.merge(graphs, focus="g", aggregation_mode="composite_average")
    batch = from_graph_object(merged, device="cpu", **(dict(slot_pack=128, strip_dtype="float32") if slot else {}))
    full = 14
    nets = [tmlp.MLP(input_dim=(d_t + 2 * full + int(np.sum(TYPE_BOUNDS)) + 3,), layers=[full], activations="selu",
                     kernel_initializer="lecun_normal", bias_initializer="lecun_normal") for d_t in TYPE_BOUNDS]
    out = tmlp.MLP(input_dim=(full,), layers=[2], activations="softmax", kernel_initializer="glorot_normal",
                   bias_initializer="glorot_normal")
    m = tcomp.CompositeGNNgraphBased(nets, out, 0, 5, 0.0).build(seed=0, device="cpu")
    if state is not None:
        m.load_state_dict(state)
    return m, batch


def _dropout_model(seed=2):
    """A 2-type composite model with dropout after the state nets' Dense
    (``tests/test_expert_parallel.py``'s dropout parity case, at
    dim_state 4)."""
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.mlp as tmlp

    nets = [tmlp.MLP(input_dim=(5 + 4 + 4 + 12,), layers=[4], activations="tanh", kernel_initializer="lecun_normal",
                     bias_initializer="lecun_normal", dropout_rate=0.3, dropout_pos=1) for _ in range(2)]
    out = tmlp.MLP(input_dim=(4,), layers=[2], activations="linear", kernel_initializer="glorot_normal",
                   bias_initializer="zeros", dropout_rate=0.2, dropout_pos=0)
    return tcomp.CompositeGNNnodeBased(nets, out, 4, 3, 0.0).build(seed=seed, device="cpu")


def _dropout_batch(slot):
    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu_torch import from_graph_object

    rng = np.random.default_rng(3)
    n = 24
    nodes = rng.normal(size=(n, 5)).astype(np.float32)
    src, dst = rng.integers(0, n, 40), rng.integers(0, n, 40)
    keep = src != dst
    arcs = np.concatenate([np.stack([src[keep], dst[keep]], 1), rng.normal(size=(int(keep.sum()), 2))], 1)
    tm = np.zeros((n, 2), bool)
    tm[np.arange(n), rng.integers(0, 2, n)] = True
    g = tgraph.CompositeGraphObject(nodes=nodes, arcs=arcs, targets=rng.normal(size=(n, 2)).astype(np.float32),
                                    type_mask=tm, dim_node_label=(5, 5), focus="n", aggregation_mode="average")
    return from_graph_object(g, device="cpu", **(dict(slot_pack=128, strip_dtype="float32") if slot else {}))


# -- the port's ranks ------------------------------------------------------------------


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


class _Seq:
    """A sequencer over prebuilt batches."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def on_epoch_end(self):
        pass


def _rank_cases(rank: int, world: int, cases: dict, ck: str) -> dict:
    import gnnkeras_tpu_torch.graph.graph as tgraph
    import gnnkeras_tpu_torch.models.gnn as tgnn
    from gnnkeras_tpu_torch import from_graph_object
    from gnnkeras_tpu_torch.parallel.expert import ExpertParallelCompositeGNN, stack_expert_params
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh

    pairs = make_mesh(("pair", "expert"), (2, 2))  # two 2-rank expert groups
    out = {}

    # the dim_state-0 forward, on the world and on the 2-rank groups
    spec, state = cases["fwd"]
    batch = from_graph_object(_graph(tgraph, spec), device="cpu")
    for key, mesh in (("fwd_4", None), ("fwd_2", pairs)):
        k, st, o, _ = ExpertParallelCompositeGNN(_port_ds0_model(spec, state), mesh).forward(batch, training=True)
        out[key] = (float(k), st.numpy(), o.numpy())

    # one SGD step with L2 regularizers on the world
    spec, state = cases["step_reg"]
    batch = from_graph_object(_graph(tgraph, spec), device="cpu")
    model = _port_ds0_model(spec, state, reg="l2")
    model.compile(optimizer="sgd:0.1", loss="mse")
    ep = ExpertParallelCompositeGNN(model)
    logs = ep.train_step(batch, torch.Generator().manual_seed(0))
    local = {n: p.detach().numpy().copy() for n, p in ep.experts.named_parameters()}
    ep.sync_to_model()
    stacked, _ = stack_expert_params(model.net_state, [net.state_dict() for net in model.net_state], ep.types_pad,
                                     [int(d) for d in batch.dim_node_label])
    out["step_reg"] = {"loss": float(logs["loss"]), "params": _params(model), "local": local,
                       "stacked": {k: v.numpy() for k, v in stacked.items()}}

    # the 3-type model (a padded expert): forward and an Adam step, both groupings
    state, raw = cases["typed"]
    for key, mesh in (("typed_4", None), ("typed_2", pairs)):
        model, batch = _port_typed(state, raw)
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", average_st_grads=True)
        ep = ExpertParallelCompositeGNN(model, mesh)
        k, _, o, _ = ep.forward(batch, training=True)
        logs = ep.train_step(batch, torch.Generator().manual_seed(0))
        padded = [(j, t) for j, t in enumerate(ep.local_types) if t >= ep.n_types]
        zero = all(not p.detach().any() and not p.grad.any()
                   for j, _ in padded for p in ep.experts[j].parameters())
        ep.sync_to_model()
        out[key] = {"k_fwd": float(k), "out": o.numpy(), "loss": float(logs["loss"]), "k": float(logs["k"]),
                    "params": _params(model), "padded": len(padded), "padded_zero": zero,
                    "grads": {n: p.grad.numpy().copy() for n, p in model.net_output.named_parameters()}}

    # dropout: the engine's draws are the wrapped model's, on both engines
    drop = {}
    for slot in (False, True):
        batch = _dropout_batch(slot)
        model = _dropout_model()
        model.transposed = slot
        ref = model.forward(batch, training=True, generator=torch.Generator().manual_seed(9))
        got = ExpertParallelCompositeGNN(model, pairs).forward(batch, training=True,
                                                               generator=torch.Generator().manual_seed(9))
        drop[slot] = (bool(torch.equal(ref[1], got[1])), bool(torch.equal(ref[2], got[2])))
    out["dropout"] = drop

    # fit over two batches of the 3-type model: validation, the experts
    # written back, a checkpoint and a resumed run
    def run(epochs, **kw):
        model, b0 = _port_typed(state, raw[:10])
        _, b1 = _port_typed(None, raw[10:])
        model.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
        ep = ExpertParallelCompositeGNN(model)
        h = ep.fit(_Seq([b0, b1]), epochs=epochs, verbose=0, validation_data=_Seq([b1]), **kw)
        return model, ep, b0, h.history

    state, raw = cases["typed"]
    fit = {}
    model, ep, b0, fit["whole"] = run(2)
    before = _port_typed(state, raw[:10])[0]
    fit["changed"] = any(not torch.equal(a, b) for a, b in zip(model.net_state.parameters(),
                                                               before.net_state.parameters()))
    _, _, o_ep, _ = ep.forward(b0)
    _, _, o_m, _, _ = model.forward(b0)
    fit["sync_max_diff"] = float((o_ep - o_m).abs().max())
    run(1, checkpoint_dir=ck)
    fit["resumed"] = run(2, checkpoint_dir=ck, resume=True)[3]
    out["fit"] = fit
    out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "gnnkeras_tpu.")))
    return out


# -- fixtures ---------------------------------------------------------------------------


def _jax_ds0_model(spec, seed, reg=None):
    import jax

    import gnnkeras_tpu.models.composite as jcomp
    import gnnkeras_tpu.models.mlp as jmlp
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = jcomp.CompositeGNNnodeBased(*_ds0_nets(jmlp, spec, reg), 0, 4, 0.01)
    jm.build(seed=seed)
    return jm, variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))


@pytest.fixture(scope="module")
def setups():
    """The specs, JAX models and port weights of every case."""
    import torch_port_common as C

    fwd_spec, step_spec = _graph_spec(seed=4), _graph_spec(seed=7)
    jtyped, ttyped = C.cgnn_pair(focus="g", ds=0, seed=0, threshold=0.0, max_iteration=5)
    return {
        "fwd": (fwd_spec, _jax_ds0_model(fwd_spec, seed=5)),
        "step_reg": (step_spec, _jax_ds0_model(step_spec, seed=5, reg="l2")),
        "typed": (_typed_raw(), (jtyped, ttyped.state_dict())),
    }


@pytest.fixture(scope="module")
def port_results(setups, tmp_path_factory):
    cases = {"fwd": (setups["fwd"][0], setups["fwd"][1][1]),
             "step_reg": (setups["step_reg"][0], setups["step_reg"][1][1]),
             "typed": (setups["typed"][1][1], setups["typed"][0])}
    ck = str(tmp_path_factory.mktemp("ep_ckpt"))
    return spawn(_rank_cases, RANKS, [(cases, ck)] * RANKS)


@pytest.fixture(scope="module")
def mesh4():
    import jax

    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(("expert",), devices=jax.devices()[:RANKS])


# -- stacking ---------------------------------------------------------------------------


def _port_stacked(tree_params, tree_state):
    """JAX's stacked (params, state) trees as the port's stacked dict."""
    out = {}
    for tree in (tree_params, tree_state):
        for i, leaves in enumerate(tree):
            for leaf, value in leaves.items():
                out[f"layers.{i}.{leaf}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("with_label_widths", [False, True])
def test_stack_expert_params_matches_jax(setups, with_label_widths):
    from gnnkeras_tpu.parallel.expert import stack_expert_params as jstack
    from gnnkeras_tpu.parallel.expert import unstack_expert_params as junstack
    from gnnkeras_tpu_torch.parallel.expert import stack_expert_params, unstack_expert_params

    spec, (jm, state) = setups["fwd"]
    tm = _port_ds0_model(spec, state)
    lw = list(spec["dim_node_label"]) if with_label_widths else None
    jsp, jss, jw = jstack(jm.net_state, jm.variables["params"]["net_state"], jm.variables["state"]["net_state"], 8,
                          label_widths=lw)
    dicts = [net.state_dict() for net in tm.net_state]
    stacked, w = stack_expert_params(tm.net_state, dicts, 8, label_widths=lw)
    want = _port_stacked(jsp, jss)
    assert w == jw and set(stacked) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(stacked[key].numpy(), value, err_msg=key)
    # the round trip, and JAX's inverse on the same stack
    back = unstack_expert_params(tm.net_state, stacked, label_widths=lw)
    jp_back, js_back = junstack(jm.net_state, jsp, jss, label_widths=lw)
    for t, (sd, d) in enumerate(zip(back, dicts)):
        want_t = _port_stacked(jp_back[t], js_back[t])
        for key, value in d.items():
            assert torch.equal(sd[key], value), (t, key)
            np.testing.assert_array_equal(sd[key].numpy(), want_t[key], err_msg=f"{t} {key}")


# -- forward and steps against JAX ------------------------------------------------------------


def test_ep_forward_matches_jax(setups, port_results, mesh4):
    import jax

    from gnnkeras_tpu.graph.batch import from_graph_object
    from gnnkeras_tpu.graph.graph import CompositeGraphObject
    from gnnkeras_tpu.parallel.expert import ExpertParallelCompositeGNN

    import torch_port_common as C

    spec, (jm, _) = setups["fwd"]
    batch = from_graph_object(CompositeGraphObject(**spec))
    with C.fast_jax_jit():
        k, state, out, _ = ExpertParallelCompositeGNN(jm, mesh4).forward(batch, training=True,
                                                                        rng=jax.random.PRNGKey(0))
    n = spec["nodes"].shape[0]
    for r, res in enumerate(port_results):
        for key in ("fwd_4", "fwd_2"):
            tk, tstate, tout = res[key]
            assert tk == float(k), (r, key)
            np.testing.assert_allclose(tstate[:n], np.asarray(state)[:n], rtol=RTOL, atol=ATOL, err_msg=f"{key} {r}")
            np.testing.assert_allclose(tout[:n], np.asarray(out)[:n], rtol=RTOL, atol=ATOL, err_msg=f"{key} {r}")


def test_ep_step_with_regularizers_matches_jax(setups, port_results, mesh4):
    """One expert-parallel SGD step with L2 regularizers against JAX's
    expert-parallel step (its loss includes every expert's penalty)."""
    import jax

    import torch_port_common as C
    from gnnkeras_tpu.graph.batch import from_graph_object
    from gnnkeras_tpu.graph.graph import CompositeGraphObject
    from gnnkeras_tpu.parallel.expert import ExpertParallelCompositeGNN, unstack_expert_params
    from gnnkeras_tpu_torch.convert import variables_from_jax

    spec, (jm, _) = setups["step_reg"]
    jm.compile(optimizer="sgd:0.1", loss="mse")
    batch = from_graph_object(CompositeGraphObject(**spec))
    ep = ExpertParallelCompositeGNN(jm, mesh4)
    ep._ensure_stacked(batch)
    out_p, out_s = jm.variables["params"]["net_output"], jm.variables["state"]["net_output"]
    opt_e, opt_o = jm.optimizer.init(ep.stacked_params), jm.optimizer.init(out_p)
    with C.fast_jax_jit():
        sparams, sstate, out_p2, _, _, _, logs = ep.make_train_step(opt_e, opt_o)(
            ep.stacked_params, ep.stacked_state, out_p, out_s, opt_e, opt_o, ep._nodes_by_type(batch),
            ep._type_masks(batch), batch, jax.random.PRNGKey(21))
    p_list, _ = unstack_expert_params(jm.net_state, sparams, sstate, label_widths=list(spec["dim_node_label"]))
    want = variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, {"net_state": p_list,
                                                                             "net_output": out_p2}),
                               "state": {}})
    want_stacked = _port_stacked(sparams, [{} for _ in sparams])
    for r, res in enumerate(port_results):
        got = res["step_reg"]
        np.testing.assert_allclose(got["loss"], float(logs["loss"]), rtol=RTOL, err_msg=f"loss {r}")
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=f"{name} {r}")
        for name, value in got["local"].items():  # this rank's expert (one a rank), padded
            j, leaf = name.split(".", 1)
            np.testing.assert_allclose(value, want_stacked[leaf][r + int(j)], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {r}")
        for name, value in want_stacked.items():
            np.testing.assert_allclose(got["stacked"][name], value, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_typed(setups):
    """JAX's single-device training-mode forward and Adam step
    (``average_st_grads``) of the 3-type model on the merged molecules."""
    import jax

    import gnnkeras_tpu.graph.batch as jbatch
    import torch_port_common as C
    from gnnkeras_tpu.training.trainer import _objective

    raw, (jm, _) = setups["typed"]
    batch = jbatch.from_graph_object(C.composite_merged_pair(raw, focus="g")[0])
    jm.compile(optimizer="adam:0.01", loss="categorical_crossentropy", average_st_grads=True)
    host = lambda t: jax.tree_util.tree_map(np.array, t)
    params, mstate = host(jm.variables["params"]), host(jm.variables["state"])

    def objective(p, s, b):
        loss, aux = _objective(jm, p, s, b, jax.random.PRNGKey(0), True)
        return loss, (aux["k"], aux["y_pred"])

    (loss, (k_step, out)), grads = C.run_jitted(jax.value_and_grad(objective, has_aux=True), params, mstate, batch)
    # the trainer's step: the state nets' gradients divided by k, then Adam
    grads, new_params = C.jax_optimizer_step(jm, params, grads, k_step)
    return {"out": np.asarray(out), "loss": float(loss), "k_step": float(k_step),
            "params": C.port_dict(host(new_params), "params"), "grads": C.port_dict(host(grads), "params")}


@pytest.mark.parametrize("key", ["typed_4", "typed_2"])
def test_ep_padded_expert_step_matches_jax(jax_typed, port_results, key):
    import torch_port_common as C

    n_graphs = 20
    for r, res in enumerate(port_results):
        got = res[key]
        assert got["k_fwd"] == jax_typed["k_step"]
        np.testing.assert_allclose(got["out"][:n_graphs], jax_typed["out"][:n_graphs], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["loss"], jax_typed["loss"], rtol=RTOL)
        assert got["k"] == jax_typed["k_step"]
        # 3 types padded to 4: one padded expert in the world, on rank 3 (key typed_4) or on ranks 1 and 3
        assert got["padded"] == (int(r == 3) if key == "typed_4" else r % 2) and got["padded_zero"], (r, got["padded"])
        for name, value in got["params"].items():
            want, g = jax_typed["params"][name].numpy(), jax_typed["grads"][name].numpy()
            keep = C.adam_live(g, g)
            np.testing.assert_allclose(value[keep], want[keep], rtol=1e-4, atol=1e-6, err_msg=f"{key} {name} {r}")


def test_ep_dropout_draws_are_the_wrapped_models(port_results):
    for res in port_results:
        assert res["dropout"] == {False: (True, True), True: (True, True)}, res["dropout"]


def test_ep_fit_syncs_experts_and_resumes(port_results):
    first = port_results[0]["fit"]
    assert first["changed"], "the trained experts must reach the wrapped model"
    assert first["sync_max_diff"] == 0.0
    whole = first["whole"]
    assert len(whole["loss"]) == 2 and np.isfinite(whole["loss"]).all() and len(whole["val_loss"]) == 2
    assert "accuracy" in whole and "val_accuracy" in whole
    assert first["resumed"]["loss"] == whole["loss"][1:], (first["resumed"], whole)
    for res in port_results[1:]:
        assert res["fit"]["whole"] == whole


def test_ep_refusals():
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn
    from gnnkeras_tpu_torch.parallel.expert import ExpertParallelCompositeGNN

    model, _ = _port_typed(None, _typed_raw()[:2])
    bn = type(model)([type(n).from_config(n.get_config()) for n in model.net_state],
                     type(model.net_output).from_config(model.net_output.get_config()), 0, 5, 0.0,
                     per_iteration_bn=True)
    with pytest.raises(ValueError, match="per_iteration_bn"):
        ExpertParallelCompositeGNN(bn)
    with pytest.raises(ValueError, match="composite"):
        ExpertParallelCompositeGNN(flagship_gnn("cpu"))
    import gnnkeras_tpu_torch.models.mlp as tmlp

    model.net_state[1] = tmlp.MLP(input_dim=model.net_state[1].input_dim, layers=[14], activations="tanh")
    with pytest.raises(ValueError, match="same layer program"):
        ExpertParallelCompositeGNN(model)


def test_ranks_import_no_jax(port_results):
    """The spawned ranks ran the port alone: no JAX and nothing of the JAX
    package in their processes."""
    assert [res["jax_imported"] for res in port_results] == [[]] * len(port_results)
