"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*.py).

Every input is made with NumPy from a seed and handed to both packages; the
port's weights are the JAX model's, copied through
``gnnkeras_tpu_torch.convert.variables_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.models.gnn as jgnn
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.models.gnn as tgnn
import gnnkeras_tpu_torch.models.mlp as tmlp
from gnnkeras_tpu_torch.convert import variables_from_jax

torch.set_num_threads(1)


def raw_molecules(n_graphs=12, seed=0, dn=14, da=3, t_dim=2, big=()):
    """(nodes, arcs, targets) NumPy triples of 5-40-node molecules with
    random arcs and no self loops; ``big`` adds graphs of those node counts
    (larger than a 128-node tile when > 128) at the front."""
    rng = np.random.default_rng(seed)
    sizes = list(big) + [int(rng.integers(5, 40)) for _ in range(n_graphs)]
    out = []
    for n in sizes:
        nodes = np.eye(dn, dtype=np.float32)[rng.integers(0, dn, n)]
        a = int(rng.integers(n, 3 * n))
        src, dst = rng.integers(0, n, a), rng.integers(0, n, a)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            src, dst = np.array([0]), np.array([1 % n])
        arcs = np.concatenate(
            [np.stack([src, dst], 1), np.eye(da, dtype=np.float32)[rng.integers(0, da, len(src))]], 1
        ).astype(np.float32)
        targets = np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, 1)]
        out.append((nodes, arcs, targets))
    return out


def node_targets(raw, t_dim=2, seed=0):
    """``raw`` with one one-hot target per node (node focus)."""
    rng = np.random.default_rng(seed)
    return [(n, a, np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, n.shape[0])]) for n, a, _ in raw]


class Batches:
    """A sequencer over prebuilt batches (``len``, ``[i]``,
    ``on_epoch_end``), for either package's ``fit``/``evaluate``/``predict``."""

    def __init__(self, batches):
        self.batches = list(batches)

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def on_epoch_end(self):
        pass


def unique_pairs(raw):
    """Keep the first arc of every (src, dst) pair: no parallel arcs, so the
    average-aggregation operator factors into an int8 mask and a scale."""
    res = []
    for nodes, arcs, targets in raw:
        _, first = np.unique(arcs[:, :2], axis=0, return_index=True)
        res.append((nodes, arcs[np.sort(first)], targets))
    return res


def graphs(module, raw, focus="g", mode="average"):
    return [module.GraphObject(nodes=n, arcs=a, targets=t, focus=focus, aggregation_mode=mode) for n, a, t in raw]


def merged_pair(raw, focus="g", mode="average"):
    """The merged disjoint union of ``raw`` in both packages."""
    jm = jgraph.GraphObject.merge(graphs(jgraph, raw, focus, mode), focus=focus, aggregation_mode=mode)
    tm = tgraph.GraphObject.merge(graphs(tgraph, raw, focus, mode), focus=focus, aggregation_mode=mode)
    return jm, tm


def arc_targets(raw, t_dim=2, seed=0):
    """``raw`` with one one-hot target per arc (arc focus), in the order of
    the arcs after ``GraphObject``'s dedup and sort."""
    rng = np.random.default_rng(seed)
    out = []
    for n, a, _ in raw:
        n_arcs = len(np.unique(a, axis=0))
        out.append((n, a, np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, n_arcs)]))
    return out


def _nets(module, dims=(14, 3, 2), focus="g", ds=0):
    dn, da, dt = dims
    ins, ls = module.get_inout_dims("state", dn, da, dt, focus, ds)
    ino, lo = module.get_inout_dims("output", dn, da, dt, focus, ds)
    net_st = module.MLP(input_dim=ins[0], layers=ls, activations="selu",
                        kernel_initializer="lecun_normal", bias_initializer="lecun_normal")
    net_out = module.MLP(input_dim=ino[0], layers=lo, activations="softmax",
                         kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
    return net_st, net_out


def perturb_bn(variables, seed):
    """Non-trivial BatchNorm statistics and affine parameters (a freshly
    built model has mean 0, var 1, gamma 1, beta 0)."""
    rng = np.random.default_rng(seed)
    for net in variables["params"]:
        for p, s in zip(variables["params"][net], variables["state"][net]):
            if "moving_mean" in s:
                f = s["moving_mean"].shape  # (f,), or (K, f) per iteration
                s["moving_mean"] = jnp.asarray(rng.normal(0.0, 0.3, f).astype(np.float32))
                s["moving_var"] = jnp.asarray(rng.uniform(0.5, 2.0, f).astype(np.float32))
                p["gamma"] = jnp.asarray(rng.uniform(0.7, 1.3, f[-1]).astype(np.float32))
                p["beta"] = jnp.asarray(rng.normal(0.0, 0.1, f[-1]).astype(np.float32))
    return variables


def flagship_pair(seed=0, threshold=0.0, max_iteration=5, node_focus=False, state_dense=None):
    """The flagship GNN (starter architecture, dim_state 0) in both packages
    with the same weights; the port's model lives on the CPU.
    ``state_dense=(scale, shift)`` multiplies the state net's Dense kernel by
    ``scale`` and adds ``shift`` to its bias: a small scale and a large shift
    make each step move the state little against its norm, so the unfolding
    converges before ``max_iteration`` at a threshold > 0."""
    focus = "n" if node_focus else "g"
    jcls = jgnn.GNNnodeBased if node_focus else jgnn.GNNgraphBased
    tcls = tgnn.GNNnodeBased if node_focus else tgnn.GNNgraphBased
    jm = jcls(*_nets(jmlp, focus=focus), 0, max_iteration, threshold)
    jm.build(seed=seed)
    jm.variables = perturb_bn(jm.variables, seed)
    if state_dense is not None:
        dense = jm.variables["params"]["net_state"][-1]
        dense["kernel"] = dense["kernel"] * state_dense[0]
        dense["bias"] = dense["bias"] + state_dense[1]
    tm = tcls(*_nets(tmlp, focus=focus), 0, max_iteration, threshold).build(seed=seed, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


_CLASSES = {"n": "GNNnodeBased", "a": "GNNarcBased", "g": "GNNgraphBased"}


def gnn_pair(focus="g", ds=0, seed=0, threshold=0.0, max_iteration=5, per_iteration_bn=False):
    """A GNN of ``focus`` with the starter architecture at dim_state ``ds``
    in both packages with the same weights (non-trivial BatchNorm
    statistics); the port's model lives on the CPU."""
    kw = dict(per_iteration_bn=per_iteration_bn)
    jm = getattr(jgnn, _CLASSES[focus])(*_nets(jmlp, focus=focus, ds=ds), ds, max_iteration, threshold, **kw)
    jm.build(seed=seed)
    jm.variables = perturb_bn(jm.variables, seed)
    tm = getattr(tgnn, _CLASSES[focus])(*_nets(tmlp, focus=focus, ds=ds), ds, max_iteration, threshold, **kw)
    tm.build(seed=seed, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


def jax_init_draw(rng, n, ds):
    """The JAX package's dim_state > 0 initial state for a forward called
    with ``rng`` (its unfolding takes the first half of the split)."""
    rng_loop, _ = jax.random.split(rng)
    return np.asarray(jgnn.STATE_INIT_STDDEV * jax.random.normal(rng_loop, (n, ds), dtype=jnp.float32))


def feed_init_draw(monkeypatch, draw):
    """Make the port's ``initial_state`` return ``draw`` (the JAX draw)."""
    monkeypatch.setattr(tgnn, "initial_state", lambda n, ds, generator, device: torch.tensor(draw, device=device))


def np_of(x):
    """NumPy view of a torch tensor (bf16 as its raw uint16 bits)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.detach().cpu().numpy()


def np_of_jax(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a
