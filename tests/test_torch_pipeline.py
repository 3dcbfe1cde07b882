"""Pipeline parallelism (``gnnkeras_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``gnnkeras_tpu.parallel.pipeline`` on the CPU.

The port runs on 4 gloo ranks (one LGNN layer a rank) spawned once for the
module (``port_results``); the models and batches are
``tests/test_pipeline.py``'s (4 layers at dim_state 4, merged batches of
12 graphs padded to 256 nodes, 512 arcs and 16 graphs), with the JAX
model's weights, and the JAX package's per-layer initial states fed to the
port's ranks (``torch_port_common.jax_lgnn_draws``: the draws of each
microbatch's single-device LGNN forward, in layer order).

- ``stack_variables`` / ``unstack_variables``: array for array against
  JAX's stacked tree (layer 0 zero-padded at the propagated features'
  rows), and the round trip exactly.
- The M = 1 step with BatchNorm and ``average_st_grads`` against JAX's
  ``PipelineLGNN.train_step`` on a 4-device ``stage`` mesh: loss at rtol
  1e-5, every parameter at rtol 1e-4 / atol 1e-6 (JAX's own bounds).
- Against JAX's single-device LGNN (the reference JAX's own tests hold the
  wrapper to; its gradients through one jitted ``value_and_grad``, SGD at
  0.1 applied in NumPy): M = 3 without BatchNorm (the mean of the three
  per-batch gradients), node and arc focus at M = 1 (loss at rtol 1e-5,
  parameters at rtol 1e-4 / atol 1e-6), and the full-batch objective
  over two unequal microbatches with non-unit sample weights.
- A 2-epoch ``fit`` with validation: the same finite History on every
  rank, the model synchronised on every rank.
- The refusals: dim_state 0, a stage count other than the layer count, a
  composite LGNN, an arc stack without ``node_label_dim``.

This module imports JAX only inside its fixtures and tests, so the ranks,
which import it to find ``_rank_cases``, import no JAX.
"""

import sys

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

STAGES = 4
DS = 4
RTOL = 1e-5


# -- batches and models (NumPy specs, both packages) -------------------------------------


def _raw(seed=0, n_graphs=12, dn=3, da=2, T=2, focus="g"):
    """``tests/test_pipeline.py``'s graphs as (nodes, arcs, targets)."""
    import gnnkeras_tpu_torch.graph.graph as tgraph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n, a = int(rng.integers(6, 12)), int(rng.integers(10, 20))
        nodes = rng.normal(size=(n, dn))
        arcs = np.concatenate([rng.integers(0, n, (a, 2)), rng.normal(size=(a, da))], axis=1)
        if focus == "g":
            t = np.zeros((1, T))
            t[0, rng.integers(T)] = 1
        elif focus == "a":
            arcs = tgraph.GraphObject(nodes=nodes, arcs=arcs, targets=np.ones((1, 1)), focus="g").arcs
            t = rng.normal(size=(arcs.shape[0], T))
        else:
            t = rng.normal(size=(n, T))
        out.append((nodes, arcs, t))
    return out


def _batch(module, raw, focus):
    merged = module.GraphObject.merge([module.GraphObject(nodes=n, arcs=a, targets=t, focus=focus,
                                                          aggregation_mode="average") for n, a, t in raw],
                                      focus=focus, aggregation_mode="average")
    kw = dict(pad_nodes=256, pad_arcs=512, pad_graphs=16, dense_blocks=False)
    if module.__name__.startswith("gnnkeras_tpu_torch"):
        from gnnkeras_tpu_torch import from_graph_object

        return from_graph_object(merged, device="cpu", **kw)
    from gnnkeras_tpu.graph.batch import from_graph_object

    return from_graph_object(merged, **kw)


def _lgnn(mlp_mod, gnn_mod, lgnn_mod, layers=STAGES, focus="g", bn=True, ds=DS):
    """``tests/test_pipeline.py``'s ``build_lgnn`` in either package
    (unbuilt)."""
    cls = {"g": gnn_mod.GNNgraphBased, "n": gnn_mod.GNNnodeBased, "a": gnn_mod.GNNarcBased}[focus]
    gnns = []
    for i in range(layers):
        kw = dict(layer=i, get_state=True, get_output=True)
        ins, ls = mlp_mod.get_inout_dims("state", 3, 2, 2, focus, ds, **kw)
        ino, lo = mlp_mod.get_inout_dims("output", 3, 2, 2, focus, ds, **kw)
        net_st = mlp_mod.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                             bias_initializer="lecun_normal", batch_normalization=bn)
        net_out = mlp_mod.MLP(input_dim=ino[0], layers=lo, activations="softmax", kernel_initializer="glorot_normal",
                              bias_initializer="glorot_normal", batch_normalization=bn)
        gnns.append(cls(net_st, net_out, ds, 3, 0.01))
    return lgnn_mod.LGNN(gnns, True, True)


def _port_lgnn(state, focus="g", bn=True, loss="categorical_crossentropy", average_st_grads=False, layers=STAGES):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.lgnn as tlgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = _lgnn(tmlp, tgnn, tlgnn, layers=layers, focus=focus, bn=bn).build(seed=0, device="cpu")
    if state is not None:
        m.load_state_dict(state)
    m.compile(optimizer="sgd:0.1", loss=loss, training_mode="parallel", average_st_grads=average_st_grads)
    return m


_LOSS = {"g": "categorical_crossentropy", "n": "mse", "a": "mse"}


# -- the port's ranks -------------------------------------------------------------------


def _feed(draws):
    """The port's ``initial_state`` returns ``draws`` in turn (cycling)."""
    import gnnkeras_tpu_torch.models.gnn as tgnn

    calls = [0]

    def fake(n, ds, generator, device):
        d = draws[calls[0] % len(draws)]
        calls[0] += 1
        return torch.tensor(d, device=device)

    tgnn.initial_state = fake


class _Seq:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def on_epoch_end(self):
        pass


def _rank_cases(rank: int, world: int, cases: dict) -> dict:
    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu_torch.parallel.pipeline import PipelineLGNN

    out = {}
    for name, case in cases.items():
        focus = case["focus"]
        model = _port_lgnn(case["state"], focus, case["bn"], _LOSS[focus], case.get("avg", False))
        batches = [_batch(tgraph, raw, focus) for raw in case["raws"]]
        for b, scale in zip(batches, case.get("sw_scale", [1.0] * len(batches))):
            b.sample_weight.mul_(scale)
        _feed(case["draws"])
        pp = PipelineLGNN(model, node_label_dim=3 if focus == "a" else None)
        if name == "m1_wrapper":
            out["stacked"] = {k: v.numpy() for k, v in pp.stack_variables().items()}
            back = pp.unstack_variables(pp.stack_variables())
            out["round_trip"] = all(torch.equal(back[k], v) for k, v in model.state_dict().items())
        logs = pp.train_step(batches, torch.Generator().manual_seed(0))
        pp.sync_to_model()
        out[name] = {"loss": float(logs["loss"]), "k": float(logs["k"]),
                     "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}

    # a 2-epoch fit with validation
    case = cases["m1_wrapper"]
    model = _port_lgnn(case["state"], "g", True, average_st_grads=True)
    _feed(case["draws"])
    batches = [_batch(tgraph, raw, "g") for raw in case["raws"]]
    history = PipelineLGNN(model).fit([batches], epochs=2, verbose=0, validation_data=_Seq(batches)).history
    out["fit"] = {"history": history, "params": {n: p.detach().numpy() for n, p in model.named_parameters()}}

    # the refusals that need a group
    refusals = {}
    try:
        PipelineLGNN(_port_lgnn(None, layers=3))
    except ValueError as err:
        refusals["stages"] = str(err)
    try:
        PipelineLGNN(_port_lgnn(None, focus="a", loss="mse"))
    except ValueError as err:
        refusals["node_label_dim"] = str(err)
    out["refusals"] = refusals
    out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "gnnkeras_tpu.")))
    return out


# -- fixtures -----------------------------------------------------------------------------


def _jax_model(focus="g", bn=True, seed=7):
    import jax

    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.lgnn as jlgnn
    import gnnkeras_tpu.models.mlp as jmlp
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = _lgnn(jmlp, jgnn, jlgnn, focus=focus, bn=bn)
    jm.compile(optimizer="sgd:0.1", loss=_LOSS[focus], training_mode="parallel")
    jm.build(seed=seed)
    return jm, variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))


def _draws(keys, n_nodes=256):
    import torch_port_common as C

    return [d for key in keys for d in C.jax_lgnn_draws(key, n_nodes, DS, STAGES)]


@pytest.fixture(scope="module")
def setups():
    """Every case's JAX model, port weights, raw batches and draws."""
    import jax

    rng = jax.random.PRNGKey
    out = {}
    jm, state = _jax_model("g", True)
    out["m1_wrapper"] = dict(jm=jm, state=state, focus="g", bn=True, avg=True, raws=[_raw(seed=7)],
                             keys=[rng(31)])
    jm, state = _jax_model("g", False)
    keys = list(jax.random.split(rng(13), 3))
    out["m3_no_bn"] = dict(jm=jm, state=state, focus="g", bn=False, raws=[_raw(seed=20 + i) for i in range(3)],
                           keys=keys, mean_of_grads=True)
    out["unequal"] = dict(jm=jm, state=state, focus="g", bn=False, raws=[_raw(seed=40), _raw(seed=41, n_graphs=4)],
                          keys=list(jax.random.split(rng(23), 2)), sw_scale=[1.0, 2.0])
    jm, state = _jax_model("n", True)
    out["node"] = dict(jm=jm, state=state, focus="n", bn=True, raws=[_raw(seed=5, focus="n")], keys=[rng(17)])
    jm, state = _jax_model("a", True)
    out["arc"] = dict(jm=jm, state=state, focus="a", bn=True, raws=[_raw(seed=9, focus="a")], keys=[rng(23)])
    for case in out.values():
        case["draws"] = _draws(case["keys"])
    return out


@pytest.fixture(scope="module")
def port_results(setups):
    keys = ("state", "focus", "bn", "avg", "raws", "draws", "sw_scale")
    cases = {name: {k: v for k, v in case.items() if k in keys} for name, case in setups.items()}
    return spawn(_rank_cases, STAGES, [(cases,)] * STAGES)


def _jax_batches(case):
    import gnnkeras_tpu.graph.graph as jgraph

    batches = [_batch(jgraph, raw, case["focus"]) for raw in case["raws"]]
    for i, scale in enumerate(case.get("sw_scale", [])):
        batches[i] = batches[i].replace(sample_weight=batches[i].sample_weight * scale)
    return batches


# -- stacking -------------------------------------------------------------------------------


def test_stack_variables_matches_jax(setups, port_results, mesh4):
    import jax

    from gnnkeras_tpu.parallel.pipeline import PipelineLGNN as JPipelineLGNN
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = setups["m1_wrapper"]["jm"]
    stacked = JPipelineLGNN(jm, mesh4).stack_variables()
    want = variables_from_jax(jax.tree_util.tree_map(np.asarray, stacked))
    for r, res in enumerate(port_results):
        assert res["round_trip"], r
        assert set(res["stacked"]) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(res["stacked"][key], value.numpy(), err_msg=f"{key} rank {r}")


# -- steps --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh4():
    import jax

    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(("stage",), devices=jax.devices()[:STAGES])


def _assert_params(got, want, what):
    assert set(got) == set(want), what
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-4, atol=1e-6, err_msg=f"{what} {name}")


def test_m1_step_matches_jax_pipeline(setups, port_results, mesh4):
    """M = 1 with BatchNorm and ``average_st_grads`` against JAX's
    pipelined step itself."""
    import jax

    import torch_port_common as C
    from gnnkeras_tpu.parallel.pipeline import PipelineLGNN as JPipelineLGNN
    from gnnkeras_tpu_torch.convert import variables_from_jax

    case = setups["m1_wrapper"]
    jm = case["jm"]
    jm.compile(optimizer="sgd:0.1", loss="categorical_crossentropy", training_mode="parallel", average_st_grads=True)
    pp = JPipelineLGNN(jm, mesh4)
    stacked = pp.stack_variables()
    svp, svs = stacked["params"], stacked["state"]
    opt = jax.vmap(jm.optimizer.init)(svp)
    with C.fast_jax_jit():
        svp, svs, _, logs = pp.train_step(svp, svs, opt, _jax_batches(case), case["keys"][0])
    full = pp.unstack_variables({"params": svp, "state": svs})
    want = variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, full["params"]), "state": {}})
    for r, res in enumerate(port_results):
        np.testing.assert_allclose(res["m1_wrapper"]["loss"], float(logs["loss"]), rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["m1_wrapper"]["k"], float(logs["k"]), rtol=RTOL)
        _assert_params(res["m1_wrapper"]["params"], {n: v.numpy() for n, v in want.items()}, f"rank {r}")


_COMPILED = {}


def _single_device_step(case, full_batch: bool):
    """SGD at 0.1 on JAX's single-device objective over the case's
    microbatches: each microbatch's ``c·Σ_layers Σ_rows loss·sw·mask +
    r·reg`` differentiated in one jitted ``value_and_grad``, with c the
    pipeline's weighting (the full batch's mask count, or the mean of
    per-microbatch means) and r splitting the penalty over the
    microbatches; ``average_st_grads`` divides each layer's state-net
    gradient by its k.  Returns (loss, new parameters as port names)."""
    import jax
    import jax.numpy as jnp

    import torch_port_common as C
    from gnnkeras_tpu_torch.convert import variables_from_jax

    jm = case["jm"]
    params, mstate = jm.variables["params"], jm.variables["state"]
    L = len(jm.gnns)

    def objective(p, s, batch, rng, c, r):
        ks, _, outs, _, _ = jm.forward({"params": p, "state": s}, batch, training=True, rng=rng)
        w = batch.sample_weight * batch.target_mask.astype(jnp.float32)
        num = sum(jnp.sum(jm.loss(batch.targets, out) * w) for out in outs)
        return c * num + r * jm.regularization_loss(p), jnp.stack(ks)

    batches = _jax_batches(case)
    key = id(jm)  # one compile per model: its microbatches share one padded shape
    if key not in _COMPILED:
        _COMPILED[key] = C.compile_jitted(jax.value_and_grad(objective, has_aux=True), params, mstate, batches[0],
                                          case["keys"][0], jnp.float32(1.0), jnp.float32(1.0))
    fn = _COMPILED[key]
    counts = [float(np.sum(np.asarray(b.target_mask))) for b in batches]
    M = len(batches)
    total_loss, total_grads, ks = 0.0, None, []
    for b, rng, count in zip(batches, case["keys"], counts):
        c = 1.0 / (L * sum(counts)) if full_batch else 1.0 / (L * M * count)
        (loss, k), grads = fn(params, mstate, b, rng, jnp.float32(c), jnp.float32(1.0 / M))
        total_loss += float(loss)
        total_grads = grads if total_grads is None else jax.tree_util.tree_map(jnp.add, total_grads, grads)
        ks.append(np.asarray(k))
    grads = variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, total_grads), "state": {}})
    if case.get("avg"):
        k_mean = np.mean(ks, axis=0)
        for name in grads:
            layer = int(name.split(".")[1])
            if ".net_state." in name:
                grads[name] = grads[name] / max(float(k_mean[layer]), 1.0)
    start = variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, params), "state": {}})
    return total_loss, {n: start[n].numpy() - 0.1 * g.numpy() for n, g in grads.items()}


@pytest.mark.parametrize("name", ["m3_no_bn", "unequal", "node", "arc"])
def test_step_matches_jax_single_device(setups, port_results, name):
    case = setups[name]
    loss, want = _single_device_step(case, full_batch=not case.get("mean_of_grads", False))
    for r, res in enumerate(port_results):
        if len(case["raws"]) == 1:
            np.testing.assert_allclose(res[name]["loss"], loss, rtol=RTOL, err_msg=f"{name} rank {r}")
        _assert_params(res[name]["params"], want, f"{name} rank {r}")


def test_fit_history_and_sync(port_results):
    first = port_results[0]["fit"]
    h = first["history"]
    assert len(h["loss"]) == 2 and np.isfinite(h["loss"]).all() and len(h["val_loss"]) == 2
    # the first epoch's step is the M = 1 step from the same weights and draws
    np.testing.assert_allclose(h["loss"][0], port_results[0]["m1_wrapper"]["loss"], rtol=RTOL)
    for res in port_results[1:]:
        assert res["fit"]["history"] == h
        for name, value in first["params"].items():  # every rank holds every trained layer
            np.testing.assert_array_equal(res["fit"]["params"][name], value, err_msg=name)


def test_refusals(port_results):
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.lgnn as tlgnn
    from gnnkeras_tpu_torch.data.synthetic import flagship_lgnn, typed_cgnn
    from gnnkeras_tpu_torch.parallel.pipeline import PipelineLGNN

    for res in port_results:
        assert "one stage a layer" in res["refusals"]["stages"]
        assert "node_label_dim" in res["refusals"]["node_label_dim"]
    with pytest.raises(ValueError, match="dim_state > 0"):
        PipelineLGNN(flagship_lgnn("cpu", layers=2))
    layer = typed_cgnn(10, device="cpu")
    assert isinstance(layer, tcomp.CompositeGNNnodeBased)
    with pytest.raises(ValueError, match="homogeneous"):
        PipelineLGNN(tlgnn.CompositeLGNN([layer, typed_cgnn(10, device="cpu")], True, False))


def test_ranks_import_no_jax(port_results):
    """The spawned ranks ran the port alone: no JAX and nothing of the JAX
    package in their processes."""
    assert [res["jax_imported"] for res in port_results] == [[]] * len(port_results)
