"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*.py).

Every input is made with NumPy from a seed and handed to both packages; the
port's weights are the JAX model's, copied through
``gnnkeras_tpu_torch.convert.variables_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
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


def jax_lgnn_draws(rng, n, ds, layers):
    """The JAX package's per-layer dim_state > 0 initial states of an LGNN
    forward called with ``rng``: each layer splits (rng, rng_loop,
    rng_out); the layers below the last unfold with rng_loop, the last runs
    its forward with it (whose unfolding takes the first half of a split)."""
    draws = []
    for idx in range(layers):
        rng, rng_loop, _ = jax.random.split(rng, 3)
        if idx == layers - 1:
            rng_loop, _ = jax.random.split(rng_loop)
        draws.append(np.asarray(jgnn.STATE_INIT_STDDEV * jax.random.normal(rng_loop, (n, ds), dtype=jnp.float32)))
    return draws


def feed_init_draw(monkeypatch, draw):
    """Make the port's ``initial_state`` return ``draw`` (the JAX draw); a
    list of draws is returned in turn, one a call, from the first again
    after the last (an LGNN draws once per layer and forward)."""
    draws = list(draw) if isinstance(draw, (list, tuple)) else [draw]
    calls = [0]

    def fake(n, ds, generator, device):
        d = draws[calls[0] % len(draws)]
        calls[0] += 1
        return torch.tensor(d, device=device)

    monkeypatch.setattr(tgnn, "initial_state", fake)


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


# -- composite graphs and models (3 node types by atom class) ------------------

TYPE_BOUNDS = (5, 10, 14)  # type t: atom classes below TYPE_BOUNDS[t], reading its first TYPE_BOUNDS[t] labels


def type_mask_of(nodes, n_types=3):
    """(n, T) one-hot node types: 3 by the argmax of the one-hot atom
    label (``TYPE_BOUNDS``), or 1."""
    if n_types == 1:
        return np.ones((nodes.shape[0], 1), dtype=bool)
    return np.eye(3, dtype=bool)[np.searchsorted(TYPE_BOUNDS[:-1], np.argmax(nodes, axis=1), side="right")]


def composite_graphs(module, raw, focus="g", n_types=3, mode=None, absent=None):
    """``raw`` as ``module.CompositeGraphObject``s: 3 types with label
    widths ``TYPE_BOUNDS`` ('composite_average'), or 1 type of the whole
    label ('average').  ``absent``: a type whose nodes are moved to the
    next type, so no node carries it."""
    dims = TYPE_BOUNDS if n_types == 3 else (raw[0][0].shape[1],)
    mode = mode or ("composite_average" if n_types == 3 else "average")
    out = []
    for n, a, t in raw:
        tm = type_mask_of(n, n_types)
        if absent is not None:
            moved = tm[:, absent].copy()
            tm[moved, absent] = False
            tm[moved, (absent + 1) % n_types] = True
        out.append(module.CompositeGraphObject(nodes=n, arcs=a, targets=t, type_mask=tm, dim_node_label=dims,
                                               focus=focus, aggregation_mode=mode))
    return out


def composite_merged_pair(raw, focus="g", n_types=3, absent=None):
    """The merged composite union of ``raw`` in both packages."""
    kw = dict(focus=focus, n_types=n_types, absent=absent)
    jg, tg = composite_graphs(jgraph, raw, **kw), composite_graphs(tgraph, raw, **kw)
    mode = jg[0].aggregation_mode
    return (jgraph.CompositeGraphObject.merge(jg, focus=focus, aggregation_mode=mode),
            tgraph.CompositeGraphObject.merge(tg, focus=focus, aggregation_mode=mode))


def composite_nets(module, focus="g", ds=0, dims=TYPE_BOUNDS, da=3, dt=2, layer=0, grow_state=True):
    """Per-type state MLPs and the output MLP of a composite GNN at
    dim_state ``ds``: at ds > 0 the shape algebra's widths (``layer`` of a
    CLGNN with get_state and get_output), at ds 0 the model's own (the
    state is the full label, which the shape algebra leaves out)."""
    width = dims[-1] if ds == 0 else ds
    if ds:
        ins, ls = module.get_inout_dims("state", list(dims), da, dt, focus, ds, layer=layer, get_state=grow_state,
                                        get_output=grow_state)
    else:
        full = dims[-1]
        ins, ls = [(d_t + 2 * full + int(np.sum(dims)) + da,) for d_t in dims], [full]
    nets = [module.MLP(input_dim=shape, layers=ls, activations="selu", kernel_initializer="lecun_normal",
                       bias_initializer="lecun_normal") for shape in ins]
    out_in = 2 * width + da if focus == "a" else width
    net_out = module.MLP(input_dim=(out_in,), layers=[dt], activations="softmax", kernel_initializer="glorot_normal",
                         bias_initializer="glorot_normal")
    return nets, net_out


def perturb_bn_tree(variables, seed):
    """``perturb_bn`` for composite and LGNN trees: every BatchNorm's
    statistics and affine parameters drawn anew."""
    rng = np.random.default_rng(seed)

    def walk(params, state):
        if isinstance(params, dict) and "moving_mean" not in state and any(
                isinstance(v, (list, dict)) for v in params.values()):
            for key in params:
                walk(params[key], state[key])
        elif isinstance(params, list):
            for p, s in zip(params, state):
                walk(p, s)
        elif "moving_mean" in state:
            f = state["moving_mean"].shape
            state["moving_mean"] = jnp.asarray(rng.normal(0.0, 0.3, f).astype(np.float32))
            state["moving_var"] = jnp.asarray(rng.uniform(0.5, 2.0, f).astype(np.float32))
            params["gamma"] = jnp.asarray(rng.uniform(0.7, 1.3, f[-1]).astype(np.float32))
            params["beta"] = jnp.asarray(rng.normal(0.0, 0.1, f[-1]).astype(np.float32))

    walk(variables["params"], variables["state"])
    return variables


_COMPOSITE_CLASSES = {"n": "CompositeGNNnodeBased", "a": "CompositeGNNarcBased", "g": "CompositeGNNgraphBased"}


def cgnn_pair(focus="g", ds=0, seed=0, threshold=0.0, max_iteration=5, per_iteration_bn=False, n_types=3):
    """A composite GNN of ``focus`` at dim_state ``ds`` over ``n_types``
    types in both packages with the same weights (non-trivial BatchNorm
    statistics); the port's model lives on the CPU."""
    import gnnkeras_tpu.models.composite as jcomp
    import gnnkeras_tpu_torch.models.composite as tcomp

    dims = TYPE_BOUNDS if n_types == 3 else (14,)
    kw = dict(per_iteration_bn=per_iteration_bn)
    cls = _COMPOSITE_CLASSES[focus]
    jm = getattr(jcomp, cls)(*composite_nets(jmlp, focus, ds, dims), ds, max_iteration, threshold, **kw)
    jm.build(seed=seed)
    jm.variables = perturb_bn_tree(jm.variables, seed)
    tm = getattr(tcomp, cls)(*composite_nets(tmlp, focus, ds, dims), ds, max_iteration, threshold, **kw)
    tm.build(seed=seed, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


def lgnn_pair(composite=True, focus="g", ds=10, layers=3, seed=0, threshold=0.0, n_types=1):
    """An LGNN (get_state and get_output) of ``layers`` GNNs in both
    packages with the same weights: composite layers over ``n_types``
    types (the starter's architecture at ds 10), or homogeneous layers of
    the flagship architecture (``get_inout_dims`` at each layer)."""
    import gnnkeras_tpu.models.composite as jcomp
    import gnnkeras_tpu.models.lgnn as jlgnn
    import gnnkeras_tpu_torch.models.composite as tcomp
    import gnnkeras_tpu_torch.models.lgnn as tlgnn

    def build(mlp_mod, gnn_mod, comp_mod, lgnn_mod):
        gnns = []
        for i in range(layers):
            if composite:
                dims = TYPE_BOUNDS if n_types == 3 else (14,)
                if ds == 0:
                    # the state is the whole label: the layer below's state
                    # and (off the arc focus) output before the t=0 label;
                    # in arc focus the t=0 arc label follows its output
                    width = 14 + i * (14 if focus == "a" else 16)
                    dims = tuple(d + width - 14 for d in dims)
                    da = 3 + (2 if focus == "a" and i else 0)
                    nets = [mlp_mod.MLP(input_dim=(d_t + 2 * width + int(np.sum(dims)) + da,), layers=[width],
                                        activations="selu", kernel_initializer="lecun_normal",
                                        bias_initializer="lecun_normal") for d_t in dims]
                    net_out = mlp_mod.MLP(input_dim=(2 * width + da if focus == "a" else width,), layers=[2],
                                          activations="softmax", kernel_initializer="glorot_normal",
                                          bias_initializer="glorot_normal")
                else:
                    nets, net_out = composite_nets(mlp_mod, focus, ds, dims, layer=i)
                gnns.append(getattr(comp_mod, _COMPOSITE_CLASSES[focus])(nets, net_out, ds, 5, threshold))
            else:
                kw = dict(layer=i, get_state=True, get_output=True)
                ins, ls = mlp_mod.get_inout_dims("state", 14, 3, 2, focus, ds, **kw)
                ino, lo = mlp_mod.get_inout_dims("output", 14, 3, 2, focus, ds, **kw)
                nets = mlp_mod.MLP(input_dim=ins[0], layers=ls, activations="selu", kernel_initializer="lecun_normal",
                                   bias_initializer="lecun_normal")
                net_out = mlp_mod.MLP(input_dim=ino[0], layers=lo, activations="softmax",
                                      kernel_initializer="glorot_normal", bias_initializer="glorot_normal")
                gnns.append(getattr(gnn_mod, _CLASSES[focus])(nets, net_out, ds, 5, threshold))
        cls = lgnn_mod.CompositeLGNN if composite else lgnn_mod.LGNN
        return cls(gnns, True, True)

    jm = build(jmlp, jgnn, jcomp, jlgnn)
    jm.build(seed=seed)
    jm.variables = perturb_bn_tree(jm.variables, seed)
    tm = build(tmlp, tgnn, tcomp, tlgnn).build(seed=seed, device="cpu")
    tm.load_state_dict(variables_from_jax(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, tm


# XLA's backend (LLVM) optimisations off: the JAX references' compile time
# dominates the composite and LGNN parity tests; the HLO, and so the f32
# operations and their order, are those of a default jit
_FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compile_jitted(fn, *args):
    """``fn`` through ``jax.jit``, compiled with ``_FAST_COMPILE`` for the
    shapes of ``args`` (call it again on others of those shapes)."""
    return jax.jit(fn).lower(*args).compile(_FAST_COMPILE)


def run_jitted(fn, *args):
    """``fn(*args)`` through ``jax.jit``, compiled with ``_FAST_COMPILE``."""
    return compile_jitted(fn, *args)(*args)


def jax_optimizer_step(jm, params, grads, k):
    """The JAX package's first step of ``jm``'s optimizer on ``grads``,
    scaled by ``average_st_grads`` as its trainer scales them (``k``: the
    iteration count, an LGNN's per layer), jitted: (scaled grads, new
    params)."""

    def step(p, g, k):
        g = jm.scale_state_grads(g, k)
        updates, _ = jm.optimizer.update(g, jm.optimizer.init(p), p)
        return g, optax.apply_updates(p, updates)

    return run_jitted(step, params, grads, k)



def adam_live(grad, want_grad, grad_rtol=1e-4, grad_atol_rel=1e-6, lr=0.01, eps=1e-7, atol=1e-6):
    """The entries of a parameter whose first Adam step (lr·g/(|g| + eps))
    moves by less than ``atol`` under the gradient error the parity checks
    allow (``grad_rtol``·|g| + ``grad_atol_rel`` of the leaf's largest
    |g|, a sign flip included), or whose gradient is exactly zero in both
    packages: where Adam's step is not steep in g."""
    g_abs = np.abs(want_grad)
    g_err = grad_rtol * g_abs + grad_atol_rel * g_abs.max()
    steep = lr * eps * g_err / (np.maximum(g_abs - g_err, 0.0) + eps) ** 2 >= atol
    return ~steep | ((grad == 0) & (want_grad == 0))


def port_dict(tree, section):
    """The port's state-dict entries of one section ('params' or 'state')
    of a JAX variables tree (gradients and new statistics come as such
    sections)."""
    other = "state" if section == "params" else "params"
    return variables_from_jax({section: jax.tree_util.tree_map(np.asarray, tree), other: {}})


def assert_stats(got, want_tree, rtol=1e-5, atol=1e-6):
    """The port's moving statistics ``got`` (state-dict keys) against a JAX
    statistics tree: the same names and shapes, values at rtol / atol."""
    want = port_dict(want_tree, "state")
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=name)
