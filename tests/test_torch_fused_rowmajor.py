"""The port's row-major whole unfold (``build_fused_diag``, ``fused_unfold``,
``GNNnodeBased.forward_fused``) against the JAX package's on the same inputs.

JAX's Pallas kernel runs in interpret mode on the CPU; the port's wrapper
runs its plain version on a CPU tensor.  Tolerances:

- f32 blocks: nothing is rounded; only the order of the f32 sums differs,
  compounded over 5 chained iterations: rtol 1e-5, atol 1e-6.
- bf16 blocks: both round the state, the weights and the aggregate to bf16
  at the same points.  Where two f32 sums of another order straddle a bf16
  rounding boundary, the rounded values are neighbours one bf16 ulp apart
  (at most 2^-7 of the value), and the difference travels on through the
  remaining iterations of that tile.  On identical inputs this happened in
  1 row of 384 (seed 1 below, 2.1e-3 at most); the bound the test states:
  at most 2% of the rows outside the f32 tolerance, and every element
  within 2^-6 of the state's largest magnitude.  Through ``forward_fused``
  each package also folds BatchNorm with its own rsqrt, which can differ in
  the last f32 bit, so a folded weight at a bf16 boundary can round to the
  neighbouring value in one package and move every row (seed 2 below:
  state 0.0089, outputs 2.3e-3 at most): there the bound is every state
  element within 2^-6 of the state's largest magnitude and every output
  (a probability) within 2^-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.models.gnn as jgnn
import gnnkeras_tpu.models.mlp as jmlp
import gnnkeras_tpu.ops.fused as jfused
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.models.gnn as tgnn
import gnnkeras_tpu_torch.models.mlp as tmlp
import gnnkeras_tpu_torch.ops.fused as tfused
from torch_port_common import flagship_pair, gnn_pair, merged_pair, node_targets, np_of, np_of_jax, raw_molecules

RTOL, ATOL = 1e-5, 1e-6
BF16_ROWS = 0.02  # share of rows a bf16 flip may move beyond the f32 tolerance
BF16_REL = 2.0**-6  # of the state's largest magnitude, elementwise
BF16_OUT = 2.0**-6

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batches(focus):
    raw = raw_molecules(n_graphs=12, seed=9)
    if focus == "n":
        raw = node_targets(raw)
    jm, tm = merged_pair(raw, focus=focus)
    jb = jbatch.from_graph_object(jm, tile_pack=True)
    tb = tbatch.from_graph_object(tm, tile_pack=True, device="cpu")
    a = jm.arcs.shape[0]
    args = (np.asarray(jb.arc_src)[:a], np.asarray(jb.arc_dst)[:a], np.asarray(jb.arcnode_weight)[:a], jb.num_nodes)
    return jb, tb, args


_BATCHES = {focus: _batches(focus) for focus in ("g", "n")}
_JB, _TB, _OP_ARGS = _BATCHES["g"]


def _ops(dtype, args=_OP_ARGS):
    jd, td = _DTYPES[dtype]
    return jfused.build_fused_diag(*args, dtype=jd), tfused.build_fused_diag(*args, dtype=td)


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_build_fused_diag_matches_jax(dtype):
    jop, top = _ops(dtype)
    assert top.blocks.dtype == _DTYPES[dtype][1] and top.tile == 128
    np.testing.assert_array_equal(np_of(top.blocks), np_of_jax(jop.blocks))
    # dst rows × src cols: the transpose of the feature-major kernel's blocks
    top_t = tfused.build_fused_diag_t(*_OP_ARGS, dtype=_DTYPES[dtype][1])
    assert torch.equal(top.blocks, top_t.blocks.transpose(1, 2))


def test_build_fused_diag_refuses_cross_tile_edges_and_other_dtypes():
    src, dst, w = np.array([0, 130]), np.array([130, 0]), np.ones(2)
    assert tfused.build_fused_diag(src, dst, w, 256) is None
    assert jfused.build_fused_diag(src, dst, w, 256) is None
    assert tfused.build_fused_diag(src, dst, w, 200) is None  # not a tile multiple
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfused.build_fused_diag(*_OP_ARGS, dtype=torch.int8)


def _random_inputs(seed, n):
    """State ~N(0, 1), constant ~N(0, 0.3²) and (14, 14) weights ~N(0,
    0.1²): each iteration's map then shrinks differences (its Jacobian's
    norm is below 1), so f32 rounding is not amplified 5 times over, and 5
    chained iterations of linear or relu stay bounded."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)
    return f(n, 14), f(n, 14, s=0.3), f(14, 14, s=0.1), f(14, 14, s=0.1)


def _flagship_inputs(seed):
    """The flagship's BatchNorm-folded transition (JAX's fold), fed to both."""
    jm, _ = flagship_pair(seed=seed)
    w_state, w_agg, w_arc, bias, _ = jm.fold_transition(jm.variables)
    const = np.asarray(_JB.agg_arc_labels @ w_arc + bias)
    return np.asarray(_JB.nodes), const, np.asarray(w_state), np.asarray(w_agg)


def _unfold_both(dtype, inputs, n_iter, activation, tiles_per_step=8):
    jop, top = _ops(dtype)
    want = np.asarray(jfused.fused_unfold(*(jnp.asarray(x) for x in inputs), jop, n_iter, activation,
                                          tiles_per_step=tiles_per_step))
    got = tfused.fused_unfold(*(torch.tensor(x) for x in inputs), top, n_iter, activation,
                              tiles_per_step=tiles_per_step).numpy()
    return got, want


@pytest.mark.parametrize("n_iter", [1, 5])
@pytest.mark.parametrize("activation", ["selu", "relu", "tanh", "sigmoid", "linear"])
def test_fused_unfold_f32_matches_jax(activation, n_iter):
    got, want = _unfold_both("float32", _random_inputs(n_iter, _JB.num_nodes), n_iter, activation)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_fused_unfold_on_the_flagship_transition_matches_jax(dtype, seed):
    got, want = _unfold_both(dtype, _flagship_inputs(seed), 5, "selu")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    diff = np.abs(got - want)
    beyond = (diff > ATOL + RTOL * np.abs(want)).any(axis=1)
    assert beyond.sum() <= BF16_ROWS * len(beyond), (int(beyond.sum()), len(beyond))
    assert diff.max() <= BF16_REL * np.abs(want).max(), diff.max()


def test_fused_unfold_bf16_rounds_where_the_jax_kernel_rounds():
    """Random inputs at bf16: the same rounding points keep the port within
    the f32 tolerance of JAX except where a flip occurs (the bound above),
    and far from the unrounded f32 result."""
    inputs = _random_inputs(7, _JB.num_nodes)
    got, want = _unfold_both("bfloat16", inputs, 5, "tanh")
    diff = np.abs(got - want)
    beyond = (diff > ATOL + RTOL * np.abs(want)).any(axis=1)
    assert beyond.sum() <= BF16_ROWS * len(beyond)
    assert diff.max() <= BF16_REL * np.abs(want).max()
    got32, _ = _unfold_both("float32", inputs, 5, "tanh")
    assert np.abs(got32 - got).max() > 100 * max(diff.max(), ATOL)


def test_tiles_per_step_changes_nothing():
    inputs = _random_inputs(5, _JB.num_nodes)
    outs = [_unfold_both("float32", inputs, 5, "selu", tiles_per_step=tps) for tps in (1, 3, 8)]
    for got, want in outs:
        assert np.array_equal(got, outs[0][0])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _, top = _ops("float32")
    with pytest.raises(ValueError, match="tiles_per_step"):
        tfused.fused_unfold(*(torch.tensor(x) for x in inputs), top, 5, "selu", tiles_per_step=0)


def test_fused_unfold_rejects_bad_operands():
    _, top = _ops("float32")
    n = _JB.num_nodes
    s, w = torch.zeros(n, 14), torch.zeros(14, 14)
    with pytest.raises(ValueError, match="activation"):
        tfused.fused_unfold(s, s, w, w, top, 1, "gelu")
    with pytest.raises(ValueError, match="rows"):  # state not covered by the operator
        tfused.fused_unfold(torch.zeros(n + 128, 14), torch.zeros(n + 128, 14), w, w, top, 1)
    with pytest.raises(ValueError, match="invariant"):  # d != h
        tfused.fused_unfold(s, torch.zeros(n, 12), torch.zeros(14, 12), torch.zeros(14, 12), top, 1)
    narrow = tfused.FusedDiagOperator(blocks=top.blocks[:, :64], tile=128)
    with pytest.raises(ValueError):  # blocks that are not 128 x 128
        tfused.fused_unfold(s, s, w, w, narrow, 1)


@pytest.mark.parametrize("case", [("float32", 0), ("bfloat16", 0), ("bfloat16", 2)])
@pytest.mark.parametrize("focus", ["g", "n"])
def test_forward_fused_matches_jax(focus, case):
    dtype, seed = case
    jb, tb, args = _BATCHES[focus]
    jm, tm = flagship_pair(seed=seed, node_focus=focus == "n")
    jop, top = _ops(dtype, args)
    js, jo, jmask = jm.forward_fused(jm.variables, jb, jop)
    ts, to, tmask = tm.forward_fused(tb, top)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    real, rows = np.asarray(jb.node_mask), np.asarray(jmask)
    js, jo, ts, to = np.asarray(js)[real], np.asarray(jo)[rows], ts.numpy()[real], to.numpy()[rows]
    if dtype == "float32":
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(ts - js).max() <= BF16_REL * np.abs(js).max()
        assert np.abs(to - jo).max() <= BF16_OUT
    np.testing.assert_allclose(to.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("focus", ["g", "n"])
def test_forward_fused_f32_matches_the_eval_forward(focus):
    """f32 blocks against the port's own ``model.forward`` at the JAX
    package's tolerance for the same check (rtol 2e-5, atol 2e-6): the
    eval forward aggregates through another operator and order."""
    jb, tb, args = _BATCHES[focus]
    _, tm = flagship_pair(seed=1, node_focus=focus == "n")
    _, top = _ops("float32", args)
    state, out, out_mask = tm.forward_fused(tb, top)
    k, state_ref, out_ref, mask_ref, _ = tm.forward(tb)
    assert k == 5 and torch.equal(out_mask, mask_ref)
    real, rows = tb.node_mask.numpy(), mask_ref.numpy()
    np.testing.assert_allclose(state.numpy()[real], state_ref.numpy()[real], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out.numpy()[rows], out_ref.numpy()[rows], rtol=2e-5, atol=2e-6)


def test_forward_fused_rejects_what_does_not_fold():
    _, top = _ops("float32")
    jop, _ = _ops("float32")
    # a deep state net
    for module, cls in ((jmlp, jgnn.GNNnodeBased), (tmlp, tgnn.GNNnodeBased)):
        net_st = module.MLP(input_dim=(31,), layers=[16, 14], activations="selu")
        net_out = module.MLP(input_dim=(14,), layers=[2], activations="softmax")
        model = cls(net_st, net_out, 0, 5, 0.0)
        if module is jmlp:
            model.build(seed=0)
            assert model.fold_transition(model.variables) is None
            with pytest.raises(ValueError, match="fusable"):
                model.forward_fused(model.variables, _JB, jop)
        else:
            model.build(seed=0, device="cpu")
            assert model.fold_transition() is None
            with pytest.raises(ValueError, match="fusable"):
                model.forward_fused(_TB, top)
    # dim_state > 0
    jm, tm = gnn_pair("g", ds=5)
    assert jm.fold_transition(jm.variables) is None and tm.fold_transition() is None
    with pytest.raises(ValueError, match="fusable"):
        tm.forward_fused(_TB, top)
    # no precomputed arc-label sums
    _, tm = flagship_pair(seed=0)
    with pytest.raises(ValueError, match="agg_arc_labels"):
        tm.forward_fused(_TB.replace(agg_arc_labels=None), top)
