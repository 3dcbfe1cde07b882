"""The port's quantised BCSR (``ops/bcsr.py`` ``QuantBcsr``, the plain
versions of kernel row 8 on the CPU) against the JAX package's.

- ``quantize_bcsr``: mask, scale, tile ids and padding equal JAX's bit for
  bit, for int8 and for the bf16 fallback (with its warning); the
  source-ordered walk reads the blocks of JAX's transposed copy;
- ``qbcsr_aggregate_t`` forward and gradient, on square operators, on a
  block count that is not a multiple of 16, and on a rectangular (N × G)
  operator; ``qbcsr_aggregate`` (row-major); ``pad_qbcsr``.

Tolerances.  Both packages sum f32 products of the same operands (JAX runs
its Pallas kernel in interpret mode on the CPU): rtol 1e-5 / atol 1e-6.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.ops.bcsr as jb
import gnnkeras_tpu_torch.ops.bcsr as tb
from torch_port_common import np_of, np_of_jax

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _banded(n_tiles=6, per_node=4, band=40, seed=0, average=True):
    rng = np.random.default_rng(seed)
    n = n_tiles * 128
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    if average:
        indeg = np.bincount(dst, minlength=n).astype(np.float64)
        w = 1.0 / indeg[dst]
    else:
        w = rng.normal(size=len(src))  # per-arc weights: not factorable
    return src, dst, w, n


def _rectangular(seed=7):
    rng = np.random.default_rng(seed)
    n, g_rows = 512, 128
    src = np.arange(n)
    dst = rng.integers(0, 100, n)
    counts = np.bincount(dst, minlength=g_rows).astype(np.float64)
    return src, dst, 1.0 / counts[dst], n, g_rows


def _pair(src, dst, w, n, n_dst=None, storage="int8"):
    jm = jb.quantize_bcsr(jb.build_bcsr(src, dst, w, n, n_dst), storage)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the per-arc case's fallback, checked on its own
        tm = tb.quantize_bcsr(tb.build_bcsr(src, dst, w, n, n_dst), storage)
    return jm, tm


_CASES = {
    "int8": dict(),
    "bf16_fallback": dict(average=False),
    "not_multiple_of_16": dict(n_tiles=2, per_node=2, band=10, seed=5),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_quantize_matches_jax(case):
    src, dst, w, n = _banded(**_CASES[case])
    jm, tm = _pair(src, dst, w, n)
    assert (tm.scale is None) == (case == "bf16_fallback")
    assert tm.mask.dtype == (torch.bfloat16 if case == "bf16_fallback" else torch.int8)
    assert tm.mask.shape[0] % 16 == 0
    np.testing.assert_array_equal(np_of(tm.mask), np_of_jax(jm.mask))
    if tm.scale is not None:
        np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    np.testing.assert_array_equal(tm.src_tile.numpy(), np.asarray(jm.src_tile))
    np.testing.assert_array_equal(tm.dst_tile.numpy(), np.asarray(jm.dst_tile))
    # the backward's walk: per source tile, the blocks of JAX's transposed copy
    # (padding blocks excluded: the two packages pad each direction apart)
    real = int(jb.build_bcsr(src, dst, w, n).blocks.shape[0])
    order = tm.src_order.numpy()
    order = order[order < real]
    np.testing.assert_array_equal(np_of(tm.mask[order].transpose(1, 2).contiguous()),
                                  np_of_jax(jm.mask_t)[:real])
    np.testing.assert_array_equal(tm.src_tile.numpy()[order], np.asarray(jm.dst_tile_t)[:real])
    ptr = tm.row_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == tm.mask.shape[0]
    np.testing.assert_array_equal(np.diff(ptr), np.bincount(tm.dst_tile.numpy(), minlength=tm.n_dst_tiles))


def test_bf16_fallback_warns():
    src, dst, w, n = _banded(average=False)
    with pytest.warns(RuntimeWarning, match="int8 mask\\+scale BCSR storage does not apply"):
        tm = tb.quantize_bcsr(tb.build_bcsr(src, dst, w, n), "int8")
    assert tm.scale is None and tm.mask.dtype == torch.bfloat16
    assert tb.quantize_bcsr(None) is None


@pytest.mark.parametrize("case", list(_CASES) + ["rectangular", "bf16_requested"])
def test_qbcsr_aggregate_t_forward_and_gradient_match_jax(case):
    if case == "rectangular":
        src, dst, w, n, n_dst = _rectangular()
        storage = "int8"
    else:
        src, dst, w, n = _banded(**_CASES.get(case, {}))
        n_dst = None
        storage = "bfloat16" if case == "bf16_requested" else "int8"
    jm, tm = _pair(src, dst, w, n, n_dst, storage)
    assert tm.n_src_tiles == n // 128
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, n)).astype(np.float32)
    ct = rng.normal(size=(8, tm.n_dst_tiles * 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jb.qbcsr_aggregate_t(s, jm))(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda s: jnp.sum(jb.qbcsr_aggregate_t(s, jm) * ct)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tb.qbcsr_aggregate_t(xt, tm)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)


def test_row_major_sandwich_matches_jax_and_dense():
    src, dst, w, n = _banded(n_tiles=2, per_node=2, band=10, seed=5)
    jm, tm = _pair(src, dst, w, n)
    state = np.random.default_rng(6).normal(size=(n, 5)).astype(np.float32)
    got = tb.qbcsr_aggregate(torch.from_numpy(state), tm).numpy()
    want = jax.jit(lambda s: jb.qbcsr_aggregate(s, jm))(jnp.asarray(state))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    adj = np.zeros((n, n), np.float64)
    np.add.at(adj, (src, dst), w)
    np.testing.assert_allclose(got, adj.T @ state, rtol=1e-5, atol=1e-5)


def test_pad_qbcsr_matches_jax_and_adds_nothing():
    src, dst, w, n = _banded(seed=3)
    jm, tm = _pair(src, dst, w, n)
    jp, tp = jb.pad_qbcsr(jm, 70), tb.pad_qbcsr(tm, 70)
    assert tp.mask.shape[0] == 80
    np.testing.assert_array_equal(np_of(tp.mask), np_of_jax(jp.mask))
    np.testing.assert_array_equal(tp.dst_tile.numpy(), np.asarray(jp.dst_tile))
    np.testing.assert_array_equal(tp.src_tile.numpy(), np.asarray(jp.src_tile))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, n)).astype(np.float32))
    torch.testing.assert_close(tb.qbcsr_matmul(x, tp), tb.qbcsr_matmul(x, tm), rtol=0, atol=0)
    torch.testing.assert_close(tb.qbcsr_matmul_t(x, tp), tb.qbcsr_matmul_t(x, tm), rtol=0, atol=0)
    assert tb.pad_qbcsr(tm, 10) is tm


def test_cast_and_empty_bcsr_match_jax():
    src, dst, w, n = _banded(seed=8)
    jm, tm = jb.build_bcsr(src, dst, w, n), tb.build_bcsr(src, dst, w, n)
    np.testing.assert_array_equal(np_of(tb.cast_bcsr(tm, "bfloat16").blocks),
                                  np_of_jax(jb.cast_bcsr(jm, jnp.bfloat16).blocks))
    assert tb.cast_bcsr(None, "bfloat16") is None
    x = np.random.default_rng(9).normal(size=(8, n)).astype(np.float32)
    # bf16 blocks times the state rounded to bf16, summed in f32 in both
    got = tb.bcsr_aggregate_t(torch.from_numpy(x), tb.cast_bcsr(tm, "bfloat16")).numpy()
    want = np.asarray(jb.bcsr_aggregate_t(jnp.asarray(x), jb.cast_bcsr(jm, jnp.bfloat16)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    je, te = jb.empty_bcsr(6, 6, 5), tb.empty_bcsr(6, 6, 5)
    for name in ("blocks", "src_tile", "dst_tile"):
        np.testing.assert_array_equal(getattr(te, name).numpy(), np.asarray(getattr(je, name)))
    assert (te.n_src_tiles, te.n_dst_tiles, te.tile) == (je.n_src_tiles, je.n_dst_tiles, je.tile)


def test_qbcsr_rejects_bad_operands():
    src, dst, w, n = _banded(seed=2)
    _, tm = _pair(src, dst, w, n)
    with pytest.raises(ValueError, match="columns"):
        tb.qbcsr_matmul(torch.zeros(8, n - 128), tm)
    with pytest.raises(ValueError, match="scale"):
        tb.qbcsr_matmul(torch.zeros(8, n), dataclasses.replace(tm, scale=None))
    with pytest.raises(ValueError):
        tb.quantize_bcsr(tb.build_bcsr(src, dst, w, n), "int4")
