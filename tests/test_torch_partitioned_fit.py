"""``PartitionedGNN.fit`` through the one fit loop (``training/fit_loop.py``)
against the JAX package's, on the CPU.

The port runs on 2 gloo ranks (spawned once for the module), the JAX
package on a 2-device sub-mesh of the conftest's 8 CPU devices.  A node
model (Adam, lr 0.01) trains on a partitioned banded graph:

- validation from a partitioned validation shard (``evaluate``) and from
  a plain sequencer scored on one device, with ``steps_per_launch=2``
  (validation forces chunks of one epoch);
- ``EarlyStopping(restore_best_weights=True)`` stopping after epoch 2 and
  restoring epoch 0's weights;
- checkpoints at ``steps_per_launch=2`` and ``checkpoint_every=3`` over 5
  epochs: the chunk crossing the boundary (epochs 2-3) saves, and so does
  the last; both packages keep the same steps;
- a run stopped after 2 epochs and resumed to 5 ends bit for bit where the
  uninterrupted run ends, on every rank.

The History at rtol 1e-5 and the parameters at rtol 1e-5 / atol 1e-6 (as
``tests/test_torch_partition.py`` holds the engine's step); every rank
takes the same decisions and ends with the same weights.  This module
imports JAX only inside its fixtures and tests, so the ranks, which import
it to find ``_rank_fits``, import no JAX.
"""

import os

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

PARTS = 2
RTOL, ATOL = 1e-5, 1e-6
DIMS = (3, 2, 2)


def _banded(seed, n=256, per_node=4, band=6):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    arcs = np.concatenate([np.stack([src, dst], 1), rng.normal(size=(len(src), 2))], axis=1)
    return rng.normal(size=(n, 3)), arcs, rng.normal(size=(n, 2))


def _graph(module, seed):
    nodes, arcs, targets = _banded(seed)
    return module.GraphObject(nodes=nodes, arcs=arcs, targets=targets, focus="n", aggregation_mode="average")


def _nets(module):
    dn, da, dt = DIMS
    ins, ls = module.get_inout_dims("state", dn, da, dt, "n", 0)
    ino, lo = module.get_inout_dims("output", dn, da, dt, "n", 0)
    return (module.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                       bias_initializer="lecun_normal"),
            module.MLP(input_dim=ino[0], layers=lo, activations="linear", kernel_initializer="glorot_normal",
                       bias_initializer="glorot_normal"))


def _port_model(state):
    import gnnkeras_tpu_torch.models.gnn as tgnn
    import gnnkeras_tpu_torch.models.mlp as tmlp

    m = tgnn.GNNnodeBased(*_nets(tmlp), 0, 5, 0.01).build(seed=0, device="cpu")
    m.load_state_dict(state)
    m.compile(optimizer="adam:0.01", loss="mse", metrics=["mse"])
    return m


def _early():
    from gnnkeras_tpu_torch.training.callbacks import EarlyStopping

    # the loss falls every epoch: in max mode epoch 0 stays the best
    return EarlyStopping(monitor="loss", mode="max", patience=1, restore_best_weights=True)


# -- the port's ranks -----------------------------------------------------------------


def _rank_fits(rank: int, world: int, pg, val_pg, val_graph, state, ck: str) -> dict:
    from gnnkeras_tpu_torch.data.sequencers import MultiGraphSequencer
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.training.checkpoint import CheckpointManager

    shard, val_shard = pg.shard(rank, "cpu"), val_pg.shard(rank, "cpu")
    val_seq = MultiGraphSequencer([val_graph], "n", "average", batch_size=1, shuffle=False, device="cpu")

    def fit(**kw):
        model = _port_model(state)
        history = PartitionedGNN(model).fit(shard, verbose=0, **kw)
        return model, history.history

    def params(model):
        return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}

    out = {}
    m, out["val_shard"] = fit(epochs=3, steps_per_launch=2, validation_data=val_shard)
    m, out["val_sequencer_early"] = fit(epochs=4, validation_data=val_seq, callbacks=[_early()])
    out["early_params"] = params(m)
    whole, out["checkpoints"] = fit(epochs=5, steps_per_launch=2, checkpoint_dir=os.path.join(ck, "every3"),
                                    checkpoint_every=3)
    out["checkpoint_steps"] = CheckpointManager(os.path.join(ck, "every3")).all_steps()
    out["whole_params"] = params(whole)
    fit(epochs=2, steps_per_launch=2, checkpoint_dir=os.path.join(ck, "resume"))
    resumed, out["resumed"] = fit(epochs=5, steps_per_launch=2, checkpoint_dir=os.path.join(ck, "resume"),
                                  resume=True)
    out["resumed_state"] = {n: t.numpy().copy() for n, t in resumed.state_dict().items()}
    out["whole_state"] = {n: t.numpy().copy() for n, t in whole.state_dict().items()}
    return out


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' graphs, partitions and model, and the port's ranks'
    results."""
    pytest.importorskip("jax")
    import jax

    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu.models.gnn as jgnn
    import gnnkeras_tpu.models.mlp as jmlp
    import gnnkeras_tpu_torch.graph.graph as tgraph
    import torch_port_common as C
    from gnnkeras_tpu.parallel.mesh import make_mesh
    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.convert import variables_from_jax
    from gnnkeras_tpu_torch.parallel.partition import partition_graph as tpartition

    jm = jgnn.GNNnodeBased(*_nets(jmlp), 0, 5, 0.01)
    jm.build(seed=3)
    jm.variables = C.perturb_bn(jm.variables, 3)
    state = variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables))
    graphs = {seed: (_graph(jgraph, seed), _graph(tgraph, seed)) for seed in (11, 12)}
    kw = dict(dense_blocks=True)
    jparts = {seed: jpartition(g[0], PARTS, **kw) for seed, g in graphs.items()}
    tparts = {seed: tpartition(g[1], PARTS, **kw) for seed, g in graphs.items()}
    ck = str(tmp_path_factory.mktemp("port_ck"))
    results = spawn(_rank_fits, PARTS, [(tparts[11], tparts[12], graphs[12][1], state, ck)] * PARTS)
    mesh = make_mesh(("graph",), devices=jax.devices()[:PARTS])
    return dict(jax=jax, jm=jm, j0=jax.tree_util.tree_map(np.asarray, jm.variables), jparts=jparts,
                jval_graph=graphs[12][0], mesh=mesh, results=results, tmp=tmp_path_factory)


def _jax_fit(setup, **kw):
    import jax.numpy as jnp

    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN
    from torch_port_common import fast_jax_jit

    jm = setup["jm"]
    jm.variables = setup["jax"].tree_util.tree_map(jnp.asarray, setup["j0"])
    jm._opt_state, jm._rng = None, setup["jax"].random.PRNGKey(0)
    jm.compile(optimizer="adam:0.01", loss="mse", metrics=["mse"])
    with fast_jax_jit():
        history = JPartitionedGNN(jm, setup["mesh"]).fit(setup["jparts"][11], verbose=0, **kw)
    return jm, history.history


def _assert_history(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def _assert_params(got, jm):
    from torch_port_common import port_dict

    want = port_dict(jm.variables["params"], "params")
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def _ranks_agree(results, key):
    for res in results[1:]:
        got, want = res[key], results[0][key]
        if isinstance(want, dict) and want and isinstance(next(iter(want.values())), np.ndarray):
            for name in want:
                np.testing.assert_array_equal(got[name], want[name], err_msg=f"{key}.{name}")
        else:
            assert got == want, key


def test_validation_from_a_partitioned_shard_matches_jax(setup):
    _, want = _jax_fit(setup, epochs=3, steps_per_launch=2, validation_data=setup["jparts"][12])
    _ranks_agree(setup["results"], "val_shard")
    got = setup["results"][0]["val_shard"]
    _assert_history(got, want)
    assert len(got["val_loss"]) == 3 and set(got) == {"loss", "k", "val_loss", "val_mse"}


def test_validation_from_a_sequencer_and_early_stopping_match_jax(setup):
    import gnnkeras_tpu.data.sequencers as jseq
    import gnnkeras_tpu.training.callbacks as jcb

    val = jseq.MultiGraphSequencer([setup["jval_graph"]], "n", "average", batch_size=1, shuffle=False)
    early = jcb.EarlyStopping(monitor="loss", mode="max", patience=1, restore_best_weights=True)
    jm, want = _jax_fit(setup, epochs=4, validation_data=val, callbacks=[early])
    _ranks_agree(setup["results"], "val_sequencer_early")
    _ranks_agree(setup["results"], "early_params")
    got = setup["results"][0]["val_sequencer_early"]
    _assert_history(got, want)
    assert len(got["loss"]) == 3  # stopped after epoch 2
    _assert_params(setup["results"][0]["early_params"], jm)


def test_checkpoints_cross_chunk_boundaries_as_jax(setup):
    from gnnkeras_tpu.training.checkpoint import CheckpointManager as JManager

    ck = str(setup["tmp"].mktemp("jax_ck"))
    jm, want = _jax_fit(setup, epochs=5, steps_per_launch=2, checkpoint_dir=ck, checkpoint_every=3)
    _ranks_agree(setup["results"], "checkpoints")
    _ranks_agree(setup["results"], "whole_params")
    res = setup["results"][0]
    _assert_history(res["checkpoints"], want)
    assert res["checkpoint_steps"] == sorted(JManager(ck)._mgr.all_steps()) == [3, 4]
    _assert_params(res["whole_params"], jm)


def test_resume_ends_where_the_uninterrupted_run_ends(setup):
    _ranks_agree(setup["results"], "resumed_state")
    for res in setup["results"]:
        assert res["resumed"]["loss"] == res["checkpoints"]["loss"][2:]
        for name, value in res["whole_state"].items():
            np.testing.assert_array_equal(res["resumed_state"][name], value, err_msg=name)
