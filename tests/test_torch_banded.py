"""The port's banded decomposition (``ops/banded.py``: one slot-128 strip
product per tile offset, kernel rows 1 and 1b on the card, plus a BCSR
residual) against the JAX package's.

- ``build_banded_operator``: offsets, diagonal masks and scales bit for bit
  (the JAX diagonals are padded to 16 tiles with zero tiles; the port's are
  not), and the residual; None without band structure, with more than
  ``max_diagonals`` offsets, or under ``strict_int8`` when the weights do not
  factor; the bf16 degrade and its warning; ``force_offsets``;
  ``dense_offsets``; ``uniformize_residuals``;
- ``banded_aggregate_t`` forward and gradient against JAX's and a dense
  float64 oracle; ``banded_aggregate`` (row-major).

Tolerances.  Against JAX: the same f32 products in another summation order,
rtol 1e-5 / atol 1e-6 (bf16 storage too: both round the weights to the same
bf16 values).  Against the dense oracle: rtol / atol 1e-5 (f32 against
float64 sums of a few terms).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.ops.banded as jband
import gnnkeras_tpu_torch.ops.banded as tband
from torch_port_common import np_of, np_of_jax

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _graph(n_tiles=6, per_node=4, band=40, seed=11, weights="average", wrap=True):
    rng = np.random.default_rng(seed)
    n = n_tiles * 128
    src = np.repeat(np.arange(n), per_node)
    dst = src + rng.integers(-band, band + 1, len(src))
    if wrap:
        dst = dst % n
    else:
        src, dst = src[(dst >= 0) & (dst < n)], dst[(dst >= 0) & (dst < n)]
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    if weights == "average":
        indeg = np.bincount(dst, minlength=n).astype(np.float64)
        return src, dst, 1.0 / indeg[dst], n
    return src, dst, np.random.default_rng(seed + 1).normal(size=len(src)), n


def _dense(src, dst, w, n):
    adj = np.zeros((n, n), np.float64)
    np.add.at(adj, (src, dst), w)
    return adj


def _assert_same_operator(tb, jb):
    assert tb.offsets == jb.offsets and tb.n_tiles == jb.n_tiles
    t = tb.n_tiles
    for td, jd in zip(tb.diags, jb.diags):
        assert td.slot == jd.slot == 128 and td.residual is None
        assert td.strip.shape[0] == t
        np.testing.assert_array_equal(np_of(td.strip), np_of_jax(jd.strip)[:t])
        assert not np.asarray(jd.strip, np.float32)[t:].any()  # JAX's K_TILES padding
        assert (td.scale is None) == (jd.scale is None)
        if td.scale is not None:
            np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale)[:t])
    assert (tb.residual is None) == (jb.residual is None)
    if tb.residual is not None:
        for name in ("blocks", "src_tile", "dst_tile"):
            np.testing.assert_array_equal(getattr(tb.residual, name).numpy(), np.asarray(getattr(jb.residual, name)))


@pytest.mark.parametrize("kwargs", [dict(min_fill=0.5), dict(), dict(force_offsets=(-2, 0, 3))],
                         ids=["min_fill_0.5", "defaults", "force_offsets"])
def test_build_matches_jax(kwargs):
    src, dst, w, n = _graph()
    jb = jband.build_banded_operator(src, dst, w, n, dtype=np.int8, **kwargs)
    tb = tband.build_banded_operator(src, dst, w, n, dtype="int8", **kwargs)
    _assert_same_operator(tb, jb)
    if "min_fill" in kwargs:
        # at 6 tiles the wraparound offsets (one tile each) ride the residual
        assert tb.offsets == (-1, 0, 1) and tb.residual is not None
    if "force_offsets" in kwargs:
        assert tb.offsets == (-2, 0, 3) and not tb.diags[0].strip.any()
    assert all(d.scale is not None for d in tb.diags)


def test_declines_like_jax():
    rng = np.random.default_rng(13)
    n = 8 * 128
    src, dst = rng.integers(0, n, 2000), rng.integers(0, n, 2000)  # offsets spread over all tiles
    assert tband.build_banded_operator(src, dst, np.ones(2000), n) is None
    assert jband.build_banded_operator(src, dst, np.ones(2000), n, dtype=np.int8) is None
    # a band of 3 tiles (no wraparound): 7 offsets reach the fill rule, above max_diagonals=6
    src, dst, w, n = _graph(n_tiles=12, per_node=6, band=384, seed=3, wrap=False)
    assert len(tband.dense_offsets(src, dst, w, n)) == 7 == len(jband.dense_offsets(src, dst, w, n))
    assert tband.build_banded_operator(src, dst, w, n) is None
    assert jband.build_banded_operator(src, dst, w, n, dtype=np.int8) is None
    assert tband.build_banded_operator(src, dst, w, n, max_diagonals=7) is not None
    # per-arc weights do not factor: strict_int8 (agg_dtype='auto') declines
    src, dst, w, n = _graph(weights="normal")
    assert tband.build_banded_operator(src, dst, w, n, strict_int8=True) is None
    assert jband.build_banded_operator(src, dst, w, n, dtype=np.int8, strict_int8=True) is None


def test_bf16_degrade_warns_and_matches_jax():
    src, dst, w, n = _graph(seed=14, weights="normal")
    with pytest.warns(RuntimeWarning, match="int8 mask\\+scale banded storage does not apply"):
        tb = tband.build_banded_operator(src, dst, w, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jb = jband.build_banded_operator(src, dst, w, n, dtype=np.int8)
    assert all(d.scale is None and d.strip.dtype == torch.bfloat16 for d in tb.diags)
    _assert_same_operator(tb, jb)
    x = np.random.default_rng(16).normal(size=(8, n)).astype(np.float32)
    got = tband.banded_aggregate_t(torch.from_numpy(x), tb).numpy()
    want = jax.jit(lambda s: jband.banded_aggregate_t(s, jb))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("min_fill", [0.5, 0.1])
def test_banded_aggregate_t_forward_and_gradient_match_jax_and_dense(min_fill):
    src, dst, w, n = _graph()
    jb = jband.build_banded_operator(src, dst, w, n, dtype=np.int8, min_fill=min_fill)
    tb = tband.build_banded_operator(src, dst, w, n, min_fill=min_fill)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(8, n)).astype(np.float32)
    ct = rng.normal(size=(8, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jband.banded_aggregate_t(s, jb))(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda s: jnp.sum(jband.banded_aggregate_t(s, jb) * ct)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tband.banded_aggregate_t(xt, tb)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)
    adj = _dense(src, dst, w, n)
    np.testing.assert_allclose(got.detach().numpy(), x @ adj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), ct @ adj.T, rtol=1e-5, atol=1e-5)


def test_row_major_sandwich_matches_jax():
    src, dst, w, n = _graph(n_tiles=4, per_node=2, band=10, seed=23)
    jb = jband.build_banded_operator(src, dst, w, n, dtype=np.int8)
    tb = tband.build_banded_operator(src, dst, w, n)
    state = np.random.default_rng(24).normal(size=(n, 5)).astype(np.float32)
    got = tband.banded_aggregate(torch.from_numpy(state), tb).numpy()
    want = jax.jit(lambda s: jband.banded_aggregate(s, jb))(jnp.asarray(state))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _dense(src, dst, w, n).T @ state, rtol=1e-5, atol=1e-5)


def test_uniformize_residuals_matches_jax():
    src, dst, w, n = _graph()
    with_res = dict(min_fill=0.5)
    # every offset a diagonal: no residual
    offs = tuple(sorted(set((src // 128 - dst // 128).tolist())))
    jbs = [jband.build_banded_operator(src, dst, w, n, dtype=np.int8, **with_res),
           jband.build_banded_operator(src, dst, w, n, dtype=np.int8, force_offsets=offs)]
    tbs = [tband.build_banded_operator(src, dst, w, n, **with_res),
           tband.build_banded_operator(src, dst, w, n, force_offsets=offs)]
    assert tbs[1].residual is None
    ju, tu = jband.uniformize_residuals(jbs), tband.uniformize_residuals(tbs)
    for t_op, j_op in zip(tu, ju):
        for name in ("blocks", "src_tile", "dst_tile"):
            np.testing.assert_array_equal(getattr(t_op.residual, name).numpy(),
                                          np.asarray(getattr(j_op.residual, name)))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, n)).astype(np.float32))
    torch.testing.assert_close(tband.banded_aggregate_t(x, tu[1]), tband.banded_aggregate_t(x, tbs[1]),
                               rtol=0, atol=0)
    assert tband.uniformize_residuals(tbs[1:]) == tbs[1:]
