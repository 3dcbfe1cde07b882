"""Hybrid data × graph (× model) training (``parallel/hybrid.py``), the
multi-host layout (``parallel/multihost.py``) and the multi-host simulation
(``tools/multihost_sim.py``) against the JAX package's, on the CPU.

The port runs on 4 gloo ranks spawned once for the module, each with the
environment torchrun gives 2 hosts of 2 ranks (``GROUP_RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); the JAX package on 4 of the
conftest's 8 CPU devices.  The model is ``scripts/multihost_sim.py``'s (a
node GNN, SGD lr 0.1, mse) with the JAX package's weights:

- the two-axis step (``("data", "graph")``, 2 × 2): 3 steps of the
  simulation's problem (two 32-node graphs, edge lists) through the port's
  ``run_steps`` against the JAX script's ``run_steps`` on a 2 × 2 mesh
  (losses and |parameter| checksum); one step on two banded 256-node graphs
  partitioned with ``dense_blocks=True, agg_dtype='auto'`` (the banded
  operators) against JAX's ``make_hybrid_train_step``;
- the three-axis step (``("data", "graph", "model")``, 1 × 2 × 2,
  ``tp_shards=2``: 3 state features padded to 4, 2 a rank) on both
  problems against JAX's three-axis step; ``forward`` refusing the
  tensor-parallel engine;
- ``make_multihost_mesh(2, 2)``: its rows are the hosts, its steps equal
  the plain 2 × 2 mesh's bit for bit; it refuses a layout whose rows would
  straddle hosts, a host size other than ``LOCAL_WORLD_SIZE``, the wrong
  world size, and ranks without ``GROUP_RANK`` on one machine;
  ``initialize_multihost`` is a no-op in a joined group and in one process;
- ``comm_volume`` equal to JAX's, field for field;
- ``tools/multihost_sim.launch`` (2 hosts of 1 rank): every rank's losses
  equal JAX's ``run_steps`` on a 2 × 1 mesh.

Losses at rtol 1e-5, parameters and statistics at rtol 1e-5 / atol 1e-6
(the gradient means over ranks are added in gloo's order).  This module
imports JAX only inside its fixtures and tests.
"""

import os

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

RANKS, PER_HOST = 4, 2
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3


def _banded(module, seed, n=256, per_node=4, band=6):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    arcs = np.concatenate([np.stack([src, dst], 1), rng.normal(size=(len(src), 2))], axis=1)
    return module.GraphObject(nodes=rng.normal(size=(n, 3)), arcs=arcs, targets=rng.normal(size=(n, 2)), focus="n",
                              aggregation_mode="average")


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


# -- the port's ranks -----------------------------------------------------------------


def _rank_run(rank: int, world: int, env: dict, state: dict, banded) -> dict:
    os.environ.update(env)
    import torch.distributed as dist

    from gnnkeras_tpu_torch.parallel.hybrid import make_hybrid_train_step, stack_partitioned
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh
    from gnnkeras_tpu_torch.parallel.multihost import initialize_multihost, make_multihost_mesh
    from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN
    from gnnkeras_tpu_torch.tools.multihost_sim import build_problem, run_steps

    out = {"initialize": initialize_multihost()}
    host_mesh = make_multihost_mesh(2, PER_HOST)
    out["host_mesh"] = (host_mesh.shape, host_mesh.coords)
    out["multihost"] = run_steps(host_mesh, STEPS, state, "cpu")
    refusals = {}
    for n_hosts, per_host in ((1, 4), (4, 1), (2, 3)):
        with pytest.raises(ValueError) as err:
            make_multihost_mesh(n_hosts, per_host)
        refusals[(n_hosts, per_host)] = str(err.value)
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    with pytest.raises(ValueError) as err:  # the hosts' rank counts disagree with the rows
        make_multihost_mesh(2, PER_HOST)
    refusals["local_world_size"] = str(err.value)
    os.environ.pop("GROUP_RANK")
    os.environ.pop("LOCAL_WORLD_SIZE")
    with pytest.raises(ValueError) as err:  # one host name: the 2 rows would share a host
        make_multihost_mesh(2, PER_HOST)
    refusals["one_machine"] = str(err.value)
    os.environ.update(env)
    out["refusals"] = refusals

    two = make_mesh(("data", "graph"), (2, PER_HOST))
    out["two_axis_sim"] = run_steps(two, STEPS, state, "cpu")

    def model():
        gnn, _ = build_problem(PER_HOST, 2, "cpu")
        gnn.load_state_dict(state)
        return gnn

    gnn = model()
    step = make_hybrid_train_step(PartitionedGNN(gnn, two.group("graph")), two)
    out["two_axis_banded"] = {"loss": float(step(stack_partitioned(banded, two, "cpu"))["loss"]),
                              "state": _np(gnn.state_dict())}

    three = make_mesh(("data", "graph", "model"), (1, 2, 2))
    _, sim_pgs = build_problem(2, 1, "cpu")
    for name, pgs in (("sim", sim_pgs), ("banded", banded[:1])):
        gnn = model()
        engine = PartitionedGNN(gnn, three.group("graph"), tp_shards=2, model_group=three.group("model"))
        step = make_hybrid_train_step(engine, three)
        loss = float(step(stack_partitioned(pgs, three, "cpu"))["loss"])
        engine.gather_tp_into_model()
        out[("three_axis", name)] = {"loss": loss, "state": _np(gnn.state_dict()),
                                     "local": {k: tuple(v.shape) for k, v in engine.tp_local.state_dict().items()}}
        with pytest.raises(ValueError, match="hybrid"):
            engine.forward(stack_partitioned(pgs, three, "cpu"))
    dist.barrier()
    return out


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim():
    """The JAX package's ``scripts/multihost_sim.py`` at 2 ranks a host."""
    pytest.importorskip("jax")
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "multihost_sim.py")
    spec = importlib.util.spec_from_file_location("jax_multihost_sim", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.DEVICES_PER_HOST = PER_HOST
    return module


@pytest.fixture(scope="module")
def setup(sim):
    import jax

    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu_torch.convert import variables_from_jax
    from gnnkeras_tpu_torch.parallel.partition import partition_graph
    from gnnkeras_tpu_torch.tools.multihost_sim import host_env

    jgnn, _ = sim.build_problem()
    state = variables_from_jax(jax.tree_util.tree_map(np.asarray, jgnn.variables))
    banded = [partition_graph(_banded(tgraph, s), 2, dense_blocks=True, agg_dtype="auto") for s in (11, 12)]
    results = spawn(_rank_run, RANKS, [(host_env(r, PER_HOST), state, banded) for r in range(RANKS)])
    return dict(jax=jax, state=state, results=results)


def _jax_mesh(jax, axes, shape):
    from gnnkeras_tpu.parallel.mesh import make_mesh

    return make_mesh(axes, shape=shape, devices=jax.devices()[:int(np.prod(shape))])


def _assert_model(got: dict, params, mstate, err=""):
    from torch_port_common import port_dict

    for section, tree in (("params", params), ("state", mstate)):
        for name, value in port_dict(tree, section).items():
            np.testing.assert_allclose(got[name], value.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{err} {name}")


def test_two_axis_steps_match_jax_run_steps(sim, setup):
    from torch_port_common import fast_jax_jit

    with fast_jax_jit():
        losses, checksum = sim.run_steps(_jax_mesh(setup["jax"], ("data", "graph"), (2, PER_HOST)), STEPS)
    for r in setup["results"]:
        got_losses, got_checksum = r["two_axis_sim"]
        np.testing.assert_allclose(got_losses, losses, rtol=RTOL)
        np.testing.assert_allclose(got_checksum, checksum, rtol=RTOL)


def _jax_banded(sim, n_replicas):
    import gnnkeras_tpu.graph.graph as jgraph
    from gnnkeras_tpu.parallel.hybrid import stack_partitioned
    from gnnkeras_tpu.parallel.partition import partition_graph

    pgs = [partition_graph(_banded(jgraph, s), 2, dense_blocks=True, agg_dtype="auto") for s in (11, 12)]
    return stack_partitioned(pgs[:n_replicas])


def test_two_axis_step_on_banded_operators_matches_jax(sim, setup):
    from gnnkeras_tpu.parallel.hybrid import make_hybrid_train_step
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN
    from torch_port_common import fast_jax_jit

    jax = setup["jax"]
    mesh = _jax_mesh(jax, ("data", "graph"), (2, 2))
    gnn, _ = sim.build_problem()
    with fast_jax_jit():
        step = make_hybrid_train_step(JPartitionedGNN(gnn, mesh), mesh)
        params, mstate, _, logs = step(gnn.variables["params"], gnn.variables["state"], gnn._opt_state,
                                       _jax_banded(sim, 2), jax.random.PRNGKey(0))
    for r in setup["results"]:
        got = r["two_axis_banded"]
        np.testing.assert_allclose(got["loss"], float(np.asarray(logs["loss"])), rtol=RTOL)
        _assert_model(got["state"], params, mstate)


@pytest.mark.parametrize("problem", ["sim", "banded"])
def test_three_axis_step_matches_jax(sim, setup, problem):
    from gnnkeras_tpu.parallel.hybrid import make_hybrid_train_step, stack_partitioned
    from gnnkeras_tpu.parallel.partition import PartitionedGNN as JPartitionedGNN
    from gnnkeras_tpu.parallel.partition import partition_graph
    from torch_port_common import fast_jax_jit

    jax = setup["jax"]
    mesh = _jax_mesh(jax, ("data", "graph", "model"), (1, 2, 2))
    gnn, _ = sim.build_problem()
    engine = JPartitionedGNN(gnn, mesh, tp_shards=2)
    stacked = engine.shard_tp_variables(gnn.variables)
    opt = gnn.optimizer.init(stacked["params"])
    if problem == "sim":
        pgs = stack_partitioned([partition_graph(p, 2) for p in [_sim_graph(0)]])
    else:
        pgs = _jax_banded(sim, 1)
    with fast_jax_jit():
        step = make_hybrid_train_step(engine, mesh, opt_template=opt)
        params, mstate, _, logs = step(stacked["params"], stacked["state"], opt, pgs, jax.random.PRNGKey(0))
    full = engine.gather_tp_variables({"params": params, "state": mstate})
    for r in setup["results"]:
        got = r[("three_axis", problem)]
        np.testing.assert_allclose(got["loss"], float(np.asarray(logs["loss"])), rtol=RTOL)
        _assert_model(got["state"], full["params"], full["state"], problem)
        # 3 state features padded to 4: 2 a rank
        assert got["local"]["layers.1.kernel"][1] == 2 and got["local"]["layers.1.bias"] == (2,)


def _sim_graph(seed):
    """``scripts/multihost_sim.py``'s graph of replica ``seed`` (JAX
    package's classes)."""
    import gnnkeras_tpu.graph.graph as jgraph

    r = np.random.default_rng(seed)
    n = 32
    src = np.repeat(np.arange(n), 2)
    dst = (src + np.tile([1, 2], n)) % n
    arcs = np.concatenate([np.stack([src, dst], 1), r.normal(size=(len(src), 2))], axis=1)
    return jgraph.GraphObject(nodes=r.normal(size=(n, 3)), arcs=arcs, targets=r.normal(size=(n, 2)), focus="n",
                              aggregation_mode="average")


def test_multihost_mesh_rows_are_hosts_and_match_the_plain_mesh(setup):
    for rank, r in enumerate(setup["results"]):
        assert r["initialize"] == RANKS
        assert r["host_mesh"] == ((2, PER_HOST), (rank // PER_HOST, rank % PER_HOST))
        assert r["multihost"] == r["two_axis_sim"]  # the same program on the same layout: bit for bit


def test_multihost_mesh_refusals(setup):
    from gnnkeras_tpu_torch.parallel.multihost import initialize_multihost

    for r in setup["results"]:
        refusals = r["refusals"]
        assert "each row stays on one host" in refusals[(1, 4)]
        assert "each row stays on one host" in refusals[(4, 1)]
        assert "LOCAL_WORLD_SIZE is [4]" in refusals["local_world_size"]
        assert "need 6 ranks, have 4" in refusals[(2, 3)]
        assert "each row stays on one host" in refusals["one_machine"]
    assert initialize_multihost() == 1  # one process, no environment: nothing to join


def test_comm_volume_matches_jax(sim):
    import gnnkeras_tpu.graph.graph as jgraph
    import gnnkeras_tpu_torch.graph.graph as tgraph
    from gnnkeras_tpu.parallel.multihost import comm_volume as jcomm
    from gnnkeras_tpu.parallel.partition import partition_graph as jpartition
    from gnnkeras_tpu_torch.parallel.multihost import comm_volume
    from gnnkeras_tpu_torch.parallel.partition import partition_graph
    from gnnkeras_tpu_torch.tools.multihost_sim import build_problem

    jgnn, _ = sim.build_problem()
    tgnn, _ = build_problem(PER_HOST, 2, "cpu")
    for halo in (True, False):
        for kw in (dict(state_width=3, n_iterations=6), dict(state_width=8)):
            want = jcomm(jpartition(_banded(jgraph, 11), 2, halo=halo), jgnn.variables["params"], **kw)
            got = comm_volume(partition_graph(_banded(tgraph, 11), 2, halo=halo), tgnn, **kw)
            assert got.__dict__ == want.__dict__
            assert got.scaling_efficiency_estimate(3.5e-3) == want.scaling_efficiency_estimate(3.5e-3)


def test_multihost_sim_launch_matches_jax(sim, setup):
    from gnnkeras_tpu_torch.tools.multihost_sim import launch
    from torch_port_common import fast_jax_jit

    sim.DEVICES_PER_HOST = 1
    try:
        with fast_jax_jit():
            losses, _ = sim.run_steps(_jax_mesh(setup["jax"], ("data", "graph"), (2, 1)), 2)
    finally:
        sim.DEVICES_PER_HOST = PER_HOST
    reports = launch(2, 1, steps=2, state=setup["state"], device="cpu")
    assert [r["host"] for r in reports] == [0, 1]
    for r in reports:
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL)
