"""Tensor parallelism (``parallel/tensor_parallel.py``) against the JAX
package's, on the CPU.

- ``TensorParallelMLP``: the split ``plan``, ``shard_variables`` (array for
  array against JAX's stacked shards, the padding included), the round trip
  through ``gather_variables`` and ``tied_mask``, at 2 and 4 shards;
- on 4 gloo ranks spawned once for the module (2-shard cases on a sub-group
  of ranks 0 and 1): ``apply`` of a 1-, 2- and 3-Dense MLP (column split
  gathered; column then row; column, row, column) row-major and
  feature-major, eval and training mode (BatchNorm's batch moments), against
  JAX's ``MLP.apply`` of the whole MLP, at 2 shards and at 4 (where 14 or
  10 features pad to 16 or 12);
- ``TensorParallelGNN`` of a flagship-shaped graph GNN (14 state features:
  7 a rank at 2 shards, 16 padded and 4 a rank at 4) and of one with a
  hidden state layer: its model-level ``shard_variables`` /
  ``gather_variables`` round trip, the forward and one SGD step (lr 0.1;
  ``fit`` writes the gathered weights back) against JAX's
  ``TensorParallelGNN`` on a 2- or 4-device mesh; the ``per_iteration_bn``
  refusal.

The port's engine runs the model's feature-major unfolding on the batch's
strip operator; JAX's runs the row-major one on its BCSR: the same sums in
another order.  Outputs, statistics, losses and parameters at rtol 1e-5 /
atol 1e-6.  This module imports JAX only inside its fixtures and tests.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

RANKS = 4
RTOL, ATOL = 1e-5, 1e-6
MLP_CASES = {"one": [14], "two": [10, 14], "three": [10, 7, 14]}


def _mlp(module, layers):
    return module.MLP(input_dim=(11,), layers=layers, activations="selu", kernel_initializer="lecun_normal",
                      bias_initializer="lecun_normal")


def _gnn(mlp, gnn_mod, hidden=None, per_iteration_bn=False):
    ins, ls = mlp.get_inout_dims("state", 14, 3, 2, "g", 0, hidden_units=hidden)
    ino, lo = mlp.get_inout_dims("output", 14, 3, 2, "g", 0)
    return gnn_mod.GNNgraphBased(
        mlp.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                bias_initializer="lecun_normal"),
        mlp.MLP(input_dim=ino[0], layers=lo, activations="softmax", kernel_initializer="glorot_normal",
                bias_initializer="glorot_normal"),
        0, 5, 0.0, per_iteration_bn=per_iteration_bn)


def _port_gnn(state, hidden=None):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = _gnn(tmlp, tgnn, hidden).build(device="cpu")
    m.load_state_dict(state)
    m.compile(optimizer="sgd:0.1", loss="categorical_crossentropy")
    return m


def _inputs():
    rng = np.random.default_rng(1)
    return rng.normal(size=(40, 11)).astype(np.float32), rng.random(40) > 0.2


# -- the port's ranks -----------------------------------------------------------------


def _rank_run(rank: int, world: int, mlp_states: dict, gnn_states: dict, batch) -> dict:
    import gnnkeras_tpu_torch.models.mlp as tmlp
    import gnnkeras_tpu_torch.models.gnn as tgnn
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh
    from gnnkeras_tpu_torch.parallel.tensor_parallel import TensorParallelGNN, TensorParallelMLP

    halves = make_mesh(("data", "model"), (2, 2))  # model groups {0, 1} and {2, 3}
    x, mask = (torch.from_numpy(a) for a in _inputs())
    out = {}
    for shards, mesh in ((2, halves), (4, None)):
        group = None if mesh is None else mesh.group("model")
        if shards == 2 and rank > 1:
            continue
        for name, layers in MLP_CASES.items():
            full = _mlp(tmlp, layers)
            tp = TensorParallelMLP(full, shards, group)
            local = tp.local_module(tp.shard_variables(mlp_states[name])[rank])
            for fm in (False, True):
                for training in (False, True):
                    inp = x.T.contiguous() if fm else x
                    y, stats = local.run(inp, feature_major=fm, training=training, mask=mask)
                    out[("mlp", shards, name, fm, training)] = {
                        "out": (y.T if fm else y).detach().numpy(), "stats": {k: v.numpy() for k, v in stats.items()}}
        for hidden in (None, [10]):
            model = _port_gnn(gnn_states[str(hidden)], hidden)
            engine = TensorParallelGNN(model, mesh)
            back = engine.gather_variables(engine.shard_variables())
            assert all(torch.equal(back[n], t) for n, t in model.state_dict().items()) and set(back) == set(
                model.state_dict())
            k, _, o = engine.forward(batch)
            history = engine.fit(batch, epochs=1, verbose=0)
            out[("gnn", shards, str(hidden))] = {"k": float(k), "out": o.numpy(), "loss": history["loss"],
                                                "state": {n: t.numpy() for n, t in model.state_dict().items()}}
    if rank == 0:
        with pytest.raises(ValueError, match="per_iteration_bn"):
            TensorParallelGNN(_gnn(tmlp, tgnn, per_iteration_bn=True).build(device="cpu"), halves)
        out["refused"] = True
    return out


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.mlp as jmlp
    import torch_port_common as C
    from gnnkeras_tpu_torch.convert import variables_from_jax

    mlps, mlp_states = {}, {}
    for i, (name, layers) in enumerate(MLP_CASES.items()):
        jm = _mlp(jmlp, layers)
        variables = jm.init(jax.random.PRNGKey(i))
        variables = C.perturb_bn({"params": {"m": variables["params"]}, "state": {"m": variables["state"]}}, i)
        mlps[name] = (jm, {"params": variables["params"]["m"], "state": variables["state"]["m"]})
        sd = variables_from_jax(jax.tree_util.tree_map(np.asarray, variables))
        mlp_states[name] = {k[2:]: v for k, v in sd.items()}
    gnns, gnn_states = {}, {}
    for hidden in (None, [10]):
        jg = _gnn(jmlp, jgnn, hidden)
        jg.build(seed=3)
        jg.variables = C.perturb_bn(jg.variables, 3)
        gnns[str(hidden)] = (jg, jax.tree_util.tree_map(np.asarray, jg.variables))
        gnn_states[str(hidden)] = variables_from_jax(gnns[str(hidden)][1])
    raw = C.raw_molecules(10, seed=2)
    jmerged, tmerged = C.merged_pair(raw)
    import gnnkeras_tpu.graph.batch as jbatch
    from gnnkeras_tpu_torch.graph.batch import from_graph_object

    jb = jbatch.from_graph_object(jmerged, slot_pack=128, strip_dtype="float32")
    tb = from_graph_object(tmerged, slot_pack=128, strip_dtype="float32", device="cpu")
    results = spawn(_rank_run, RANKS, [(mlp_states, gnn_states, tb)] * RANKS)
    return dict(jax=jax, mlps=mlps, mlp_states=mlp_states, gnns=gnns, jb=jb, results=results)


def _mesh(jax, shards):
    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(("model",), devices=jax.devices()[:shards])


# -- host side: plan, shards, round trip ------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(MLP_CASES))
def test_shard_variables_match_jax_and_round_trip(setup, shards, name):
    import gnnkeras_tpu.models.mlp as jmlp
    import gnnkeras_tpu_torch.models.mlp as tmlp
    from gnnkeras_tpu.parallel.tensor_parallel import TensorParallelMLP as JTP
    from gnnkeras_tpu_torch.parallel.tensor_parallel import TensorParallelMLP

    layers = MLP_CASES[name]
    jtp, tp = JTP(_mlp(jmlp, layers), shards), TensorParallelMLP(_mlp(tmlp, layers), shards)
    assert tp.plan == jtp.plan and tp.gather_output == jtp.gather_output
    want = jtp.shard_variables(setup["mlps"][name][1])
    got = tp.shard_variables(setup["mlp_states"][name])
    for i, (p, s) in enumerate(zip(want["params"], want["state"])):
        for leaf, value in {**p, **s}.items():
            for d in range(shards):
                np.testing.assert_array_equal(got[d][f"layers.{i}.{leaf}"].numpy(), np.asarray(value[d]),
                                              err_msg=f"{i}.{leaf}[{d}]")
    tied = tp.tied_mask()
    for i, entry in enumerate(jtp.tied_mask()):
        for leaf, value in entry.items():
            assert tied[f"layers.{i}.{leaf}"] == value
    back = tp.gather_variables(got)
    assert set(back) == set(setup["mlp_states"][name])
    for key, value in setup["mlp_states"][name].items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)


# -- the ranks ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(MLP_CASES))
def test_sharded_apply_matches_jax_mlp(setup, shards, name):
    import jax.numpy as jnp

    from torch_port_common import port_dict

    jm, variables = setup["mlps"][name]
    x, mask = _inputs()
    for training in (False, True):
        want, state = jm.apply(variables, jnp.asarray(x), training=training, mask=jnp.asarray(mask))
        want_stats = {k[2:]: v for k, v in port_dict({"m": state}, "state").items()}
        for fm in (False, True):
            for rank in range(shards):
                got = setup["results"][rank][("mlp", shards, name, fm, training)]
                np.testing.assert_allclose(got["out"], np.asarray(want), rtol=RTOL, atol=ATOL)
                if training:  # the leading BatchNorm, replicated before the first split
                    for key, value in got["stats"].items():
                        np.testing.assert_allclose(value, want_stats[key].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("hidden", [None, [10]])
def test_tensor_parallel_gnn_forward_and_step_match_jax(setup, shards, hidden):
    import jax.numpy as jnp

    from gnnkeras_tpu.parallel.tensor_parallel import TensorParallelGNN as JTPG
    from torch_port_common import fast_jax_jit, port_dict

    jax = setup["jax"]
    jm, v0 = setup["gnns"][str(hidden)]
    jm.variables = jax.tree_util.tree_map(jnp.asarray, v0)
    jm._opt_state = None
    jm.compile(optimizer="sgd:0.1", loss="categorical_crossentropy")
    engine = JTPG(jm, _mesh(jax, shards))
    with fast_jax_jit():
        k, _, out = engine.forward(setup["jb"])
        history = engine.fit(setup["jb"], epochs=1, verbose=0)
    rows = setup["jb"].graph_mask
    for rank in range(shards):
        got = setup["results"][rank][("gnn", shards, str(hidden))]
        assert got["k"] == float(k) == 5.0
        np.testing.assert_allclose(got["out"][np.asarray(rows)], np.asarray(out)[np.asarray(rows)], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["loss"], history["loss"], rtol=RTOL)
        for section in ("params", "state"):
            for name, value in port_dict(jm.variables[section], section).items():
                np.testing.assert_allclose(got["state"][name], value.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def test_per_iteration_bn_refused(setup):
    assert setup["results"][0]["refused"]
