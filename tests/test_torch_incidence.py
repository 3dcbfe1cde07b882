"""The port's incidence pairs and the plain versions of the arc readout's
select and scatter (``gnnkeras_tpu_torch.ops.incidence``) against the JAX
package's (its Pallas pair kernels in interpret mode on the CPU).

Tolerances.  The pair arrays are host-built from the same inputs: exact
equality.  The select is a copy: bit-equal to ``state[arc_src]`` and to the
JAX select on every row, padding rows included.  The scatter sums a node's
few incident-arc cotangents in f32 in another order than JAX and
``np.add.at``: rtol 1e-5, atol 1e-5.  The gradient through
``incidence_gather`` against ``jax.grad``: rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.ops.incidence as jinc
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.ops.incidence as tinc
from gnnkeras_tpu_torch import kernels
from torch_port_common import arc_targets, merged_pair, raw_molecules

# the arc-tile-ordered pairs; the port does not build JAX's node-tile-ordered
# copy (``b_*``), which only JAX's scatter walks
_FIELDS = ("f_arc_tile", "f_node_tile", "f_cols_src", "f_cols_dst", "f_start")

pytestmark = pytest.mark.filterwarnings("ignore:int8 mask\\+scale strip storage")

_LAYOUTS = {"slot128": dict(slot_pack=128, strip_dtype="int8"), "plain": dict()}


def _batches(layout, seed=3, n_graphs=12):
    """About a dozen molecules of 5-40 nodes in arc focus, in both packages."""
    raw = arc_targets(raw_molecules(n_graphs=n_graphs, seed=seed), seed=seed)
    jm, tm = merged_pair(raw, focus="a")
    return (jbatch.from_graph_object(jm, **_LAYOUTS[layout]),
            tbatch.from_graph_object(tm, device="cpu", **_LAYOUTS[layout]))


def _assert_pairs_equal(t, j):
    for name in _FIELDS:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (t.n_arc_tiles, t.n_node_tiles, tinc.TILE, t.n_pairs) == (j.n_arc_tiles, j.n_node_tiles, j.tile, j.n_pairs)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_pairs_match_jax(layout):
    jb, tb = _batches(layout)
    assert tb.arc_inc is not None and tb.arc_inc.n_live <= tb.arc_inc.n_pairs
    _assert_pairs_equal(tb.arc_inc, jb.arc_inc)
    n_pairs = tinc._MAX_PAIRS_PER_ARC_TILE * tb.arc_inc.n_arc_tiles
    padded = tinc.pad_incidence_pairs(tb.arc_inc, n_pairs)
    _assert_pairs_equal(padded, jinc.pad_incidence_pairs(jb.arc_inc, n_pairs))
    assert padded.n_live == tb.arc_inc.n_live
    # the operator caps of the serving template
    _assert_pairs_equal(tbatch.pad_operators_to_cap(tb).arc_inc, jbatch.pad_operators_to_cap(jb).arc_inc)


def test_build_declines_as_jax():
    src, dst = np.array([0, 5, 130]), np.array([1, 2, 3])
    assert tinc.build_incidence_pairs(src, dst, 200) is None  # not 128-aligned
    assert tinc.build_incidence_pairs(src, dst, 128) is None  # endpoint outside
    assert tinc.build_incidence_pairs(src[:0], dst[:0], 128) is None
    # 13 arcs in one arc tile, each endpoint in another node tile
    far = np.arange(13) * 128
    assert tinc.build_incidence_pairs(far, far, 13 * 128) is None
    assert jinc.build_incidence_pairs(far, far, 13 * 128) is None


def _state(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("d", [3, 14, 24])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_select_plain_is_exact(layout, d):
    jb, tb = _batches(layout)
    inc = tb.arc_inc
    state = _state(tb.num_nodes, d, d)
    # -0.0 and subnormals come back bit for bit
    state[1, 0], state[2, -1] = -0.0, np.float32(1e-40)
    before = dict(kernels.LAUNCHES)
    y_src, y_dst = tinc.incidence_select(torch.from_numpy(state), inc)
    assert kernels.LAUNCHES == before
    a, a_pad = tb.num_arcs, inc.n_arc_tiles * 128
    assert y_src.shape == y_dst.shape == (a_pad, d)
    src, dst = tb.arc_src.long().numpy(), tb.arc_dst.long().numpy()
    bits = lambda x: np.asarray(x).view(np.uint32)
    np.testing.assert_array_equal(bits(y_src.numpy()[:a]), bits(state[src]))
    np.testing.assert_array_equal(bits(y_dst.numpy()[:a]), bits(state[dst]))
    assert not y_src.numpy()[a:].any() and not y_dst.numpy()[a:].any()

    # the JAX select on every row (its edges, -0.0 and subnormals, left out)
    state = _state(tb.num_nodes, d, d + 1)
    y_src, y_dst = tinc.incidence_select(torch.from_numpy(state), inc)
    j_src, j_dst = jinc.incidence_select(jnp.asarray(state), jb.arc_inc)
    np.testing.assert_array_equal(bits(y_src.numpy()), bits(j_src))
    np.testing.assert_array_equal(bits(y_dst.numpy()), bits(j_dst))


@pytest.mark.parametrize("d", [1, 14, 24])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_scatter_plain_matches_jax_and_oracle(layout, d):
    jb, tb = _batches(layout, seed=13)
    inc = tb.arc_inc
    rng = np.random.default_rng(d)
    a = tb.num_arcs
    ct_src = rng.normal(size=(a, d)).astype(np.float32)
    ct_dst = rng.normal(size=(a, d)).astype(np.float32)
    got = tinc.incidence_scatter(torch.from_numpy(ct_src), torch.from_numpy(ct_dst), inc).numpy()
    assert got.shape == (tb.num_nodes, d)
    oracle = np.zeros((tb.num_nodes, d), np.float32)
    np.add.at(oracle, tb.arc_src.long().numpy(), ct_src)
    np.add.at(oracle, tb.arc_dst.long().numpy(), ct_dst)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    want = np.asarray(jinc.incidence_scatter(jnp.asarray(ct_src), jnp.asarray(ct_dst), jb.arc_inc))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_gradient_matches_jax():
    jb, tb = _batches("slot128", seed=7)
    d = 14
    state = _state(tb.num_nodes, d, 4)
    rng = np.random.default_rng(5)
    w_src = rng.normal(size=(tb.num_arcs, d)).astype(np.float32)
    w_dst = rng.normal(size=(tb.num_arcs, d)).astype(np.float32)

    def jloss(s):
        ys, yd = jinc.incidence_gather(s, jb.arc_src, jb.arc_dst, jb.arc_inc)
        return jnp.sum(jnp.sin(ys) * w_src) + jnp.sum(yd * yd * w_dst)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(state)))
    x = torch.from_numpy(state).requires_grad_(True)
    ys, yd = tinc.incidence_gather(x, tb.num_arcs, tb.arc_inc)
    assert ys.shape == yd.shape == (tb.num_arcs, d)
    (torch.sum(torch.sin(ys) * torch.from_numpy(w_src)) + torch.sum(yd * yd * torch.from_numpy(w_dst))).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_padded_pairs_give_the_same_outputs(layout):
    _, tb = _batches(layout, seed=9)
    inc = tb.arc_inc
    padded = tinc.pad_incidence_pairs(inc, 12 * inc.n_arc_tiles)
    assert padded.n_pairs > inc.n_pairs
    state = torch.from_numpy(_state(tb.num_nodes, 14, 2))
    for a, b in zip(tinc.incidence_select(state, inc), tinc.incidence_select(state, padded)):
        assert torch.equal(a, b)
    ct = torch.from_numpy(_state(tb.num_arcs, 14, 3))
    torch.testing.assert_close(tinc.incidence_scatter(ct, -ct, padded), tinc.incidence_scatter(ct, -ct, inc),
                               rtol=0, atol=0)


def test_wrappers_reject_bad_operands():
    _, tb = _batches("plain")
    inc = tb.arc_inc
    with pytest.raises(ValueError, match="2-D"):
        tinc.incidence_select(torch.zeros(tb.num_nodes), inc)
    ct = torch.zeros((inc.n_arc_tiles * 128 + 1, 3))
    with pytest.raises(ValueError, match="rows"):
        tinc.incidence_scatter(ct, ct, inc)
    with pytest.raises(ValueError, match="differ"):
        tinc.incidence_scatter(torch.zeros((4, 3)), torch.zeros((4, 2)), inc)
