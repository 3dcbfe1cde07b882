"""The per-block nonzero lists of ``QuantBcsr`` (``ops/bcsr.py``: the
forward's by destination column, the backward's by source row, and the
bf16 weights in each order) and their plain walks
(``_qbcsr_list_matmul_plain``, ``_qbcsr_list_matmul_t_plain``), the
quantised block kernels' plain versions and the CPU wrappers' route.

- The lists rebuild the dense mask, and the bf16 weights, exactly, after
  ``pad_qbcsr`` too; each list is sorted as its kernel walks it.
- The walks equal the JAX package's ``qbcsr_aggregate_t`` forward and
  gradient (its Pallas kernel in interpret mode on the CPU, jitted) and the
  dense plain versions, on square, rectangular and non-multiple-of-16
  operators, int8 and bf16, with an empty destination tile and a full
  block (16,384 entries, the lists' largest block-local offset).

Tolerances.  The lists are host-built: exact equality.  The walks sum f32
products of the same operands as JAX and the dense plain versions in
another order: rtol 1e-5 / atol 1e-6, as ``tests/test_torch_qbcsr.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.ops.bcsr as jb
import gnnkeras_tpu_torch.ops.bcsr as tb
from gnnkeras_tpu_torch import kernels

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
T = 128


def _banded(n_tiles=6, per_node=4, band=40, seed=0, average=True, skip_dst_tile=None):
    """A banded graph; ``skip_dst_tile`` drops every arc into that tile."""
    rng = np.random.default_rng(seed)
    n = n_tiles * T
    src = np.repeat(np.arange(n), per_node)
    dst = (src + rng.integers(-band, band + 1, len(src))) % n
    if skip_dst_tile is not None:
        keep = dst // T != skip_dst_tile
        src, dst = src[keep], dst[keep]
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    if average:
        indeg = np.bincount(dst, minlength=n).astype(np.float64)
        w = 1.0 / np.maximum(indeg[dst], 1)
    else:
        w = rng.normal(size=len(src))  # per-arc weights: not factorable
    return src, dst, w, n, None


def _full_block(seed=1):
    """A banded graph on 3 tiles plus every (source, destination) pair of
    tile 0: one block with all 16,384 entries."""
    src, dst, _, n, _ = _banded(n_tiles=3, per_node=2, band=20, seed=seed)
    s, t = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    pairs = np.unique(np.concatenate([np.stack([src, dst], 1), np.stack([s.ravel(), t.ravel()], 1)]), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    return src, dst, 1.0 / indeg[dst], n, None


def _rectangular(seed=7):
    """Nodes into 100 graph rows of one 128-row tile (an N × G readout)."""
    rng = np.random.default_rng(seed)
    n = 512
    src = np.arange(n)
    dst = rng.integers(0, 100, n)
    counts = np.bincount(dst, minlength=T).astype(np.float64)
    return src, dst, 1.0 / counts[dst], n, T


_GRAPHS = {
    "square": lambda: _banded(),
    "bf16_fallback": lambda: _banded(average=False),
    "not_multiple_of_16": lambda: _banded(n_tiles=2, per_node=2, band=10, seed=5),
    "rectangular": _rectangular,
    "empty_dst_tile": lambda: _banded(seed=4, skip_dst_tile=2),
    "full_block": _full_block,
}
_STORAGES = ("int8", "bfloat16")


def _pair(case, storage):
    src, dst, w, n, n_dst = _GRAPHS[case]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the per-arc case's bf16 fallback
        jm = jb.quantize_bcsr(jb.build_bcsr(src, dst, w, n, n_dst), storage)
        tm = tb.quantize_bcsr(tb.build_bcsr(src, dst, w, n, n_dst), storage)
    return jm, tm, n


def _rebuild(qm, by_column):
    """The dense (B, T, T) f32 operator the lists describe (1 for an int8
    entry, its weight for bf16), and whether each block's list is sorted
    as the kernel walks it (ids ascending within a column or row)."""
    starts = (qm.col_start if by_column else qm.row_start).numpy().astype(np.int64)
    ids = (qm.col_rows if by_column else qm.row_cols).numpy().astype(np.int64)
    weights = qm.col_weights if by_column else qm.row_weights
    vals = np.ones(len(ids)) if weights is None else weights.float().numpy()
    nz_start = qm.nz_start.numpy().astype(np.int64)
    b = qm.src_tile.shape[0]
    dense = np.zeros((b, T, T), np.float32)
    ordered = True
    for blk in range(b):
        lo, hi = nz_start[blk], nz_start[blk + 1]
        assert starts[blk, 0] == 0 and starts[blk, -1] == hi - lo and (np.diff(starts[blk]) >= 0).all()
        outer = np.repeat(np.arange(T), np.diff(starts[blk]))  # column (or row) of each entry
        inner = ids[lo:hi]
        if by_column:
            dense[blk, inner, outer] = vals[lo:hi]
        else:
            dense[blk, outer, inner] = vals[lo:hi]
        key = outer * T + inner
        ordered &= bool((np.diff(key) > 0).all())
    return dense, ordered


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("case", list(_GRAPHS))
def test_lists_rebuild_the_mask(case, storage, padded):
    _, tm, _ = _pair(case, storage)
    if padded:
        tm = tb.pad_qbcsr(tm, tm.mask.shape[0] + 40)
        assert not tm.mask[-1].any() and int(tm.nz_start[-1]) == int(tm.nz_start[-2])
    assert tm.nz_start.dtype == torch.int32 and tm.col_start.dtype == tm.row_start.dtype == torch.int16
    assert tm.col_rows.dtype == tm.row_cols.dtype == torch.uint8
    assert tm.nz_start.shape == (tm.mask.shape[0] + 1,) and tm.col_start.shape == (tm.mask.shape[0], T + 1)
    is_bf16 = tm.mask.dtype == torch.bfloat16
    assert (tm.col_weights is not None) == (tm.row_weights is not None) == is_bf16
    if is_bf16:
        assert tm.col_weights.dtype == tm.row_weights.dtype == torch.bfloat16
    assert int(tm.nz_start[-1]) == int(torch.count_nonzero(tm.mask))
    for by_column in (True, False):
        dense, ordered = _rebuild(tm, by_column)
        assert ordered
        # the bf16 weights are the mask's own values, bit for bit
        np.testing.assert_array_equal(dense, tm.mask.float().numpy())
    if case == "full_block":
        assert int(torch.diff(tm.nz_start).max()) == T * T
    if case == "empty_dst_tile":
        ptr = tm.row_ptr.numpy()
        assert int(tm.nz_start[ptr[3]] - tm.nz_start[ptr[2]]) == 0


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("case", list(_GRAPHS))
def test_list_walks_match_jax_forward_and_gradient(case, storage):
    jm, tm, n = _pair(case, storage)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, n)).astype(np.float32)
    ct = rng.normal(size=(8, tm.n_dst_tiles * T)).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jb.qbcsr_aggregate_t(s, jm))(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda s: jnp.sum(jb.qbcsr_aggregate_t(s, jm) * ct)))(jnp.asarray(x)))
    xt, ctt = torch.from_numpy(x), torch.from_numpy(ct)
    walk = tb._qbcsr_list_matmul_plain(xt, tm.scale, tm.col_weights, tm.src_tile, tm.dst_tile, tm.nz_start,
                                       tm.col_start, tm.col_rows, tm.n_dst_tiles)
    walk_t = tb._qbcsr_list_matmul_t_plain(ctt, tm.scale, tm.row_weights, tm.src_tile, tm.dst_tile, tm.nz_start,
                                           tm.row_start, tm.row_cols, tm.n_src_tiles)
    np.testing.assert_allclose(walk.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(walk_t.numpy(), want_grad, rtol=RTOL, atol=ATOL)
    # the dense plain versions, the independent references on the card
    dense = tb._qbcsr_matmul_plain(xt, tm.mask, tm.scale, tm.src_tile, tm.dst_tile, tm.n_dst_tiles)
    dense_t = tb._qbcsr_matmul_t_plain(ctt, tm.mask, tm.scale, tm.src_tile, tm.dst_tile, tm.n_src_tiles)
    torch.testing.assert_close(walk, dense, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(walk_t, dense_t, rtol=RTOL, atol=ATOL)
    # the CPU wrappers and the autograd backward take the walks, launching nothing
    before = dict(kernels.LAUNCHES)
    xg = xt.clone().requires_grad_(True)
    out = tb.qbcsr_aggregate_t(xg, tm)
    (grad,) = torch.autograd.grad(out, xg, ctt)
    assert torch.equal(out.detach(), walk) and torch.equal(grad, walk_t)
    assert kernels.LAUNCHES == before
    if case == "empty_dst_tile":
        assert not walk[:, 2 * T:3 * T].any()


@pytest.mark.parametrize("storage", _STORAGES)
def test_padding_blocks_add_nothing_to_the_walks(storage):
    _, tm, n = _pair("square", storage)
    tp = tb.pad_qbcsr(tm, tm.mask.shape[0] + 40)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, n)).astype(np.float32))
    torch.testing.assert_close(tb.qbcsr_matmul(x, tp), tb.qbcsr_matmul(x, tm), rtol=0, atol=0)
    torch.testing.assert_close(tb.qbcsr_matmul_t(x, tp), tb.qbcsr_matmul_t(x, tm), rtol=0, atol=0)


def test_a_non_finite_state_reaches_only_the_entries_that_read_it():
    """An inf in the state: the list walk (and the kernels, which walk the
    same lists) reaches only the output columns whose entries read that
    row; a walk over the dense blocks also multiplies it by the block's
    zeros, and inf·0 is NaN in every other column of the block.  So the two
    agree for finite inputs only."""
    _, tm, n = _pair("square", "int8")
    x = torch.zeros((8, n))
    b = 0
    row = int(tm.col_rows[int(tm.nz_start[b])])  # a source row that block 0 reads
    x[0, int(tm.src_tile[b]) * T + row] = float("inf")
    walk = tb._qbcsr_list_matmul_plain(x, tm.scale, tm.col_weights, tm.src_tile, tm.dst_tile, tm.nz_start,
                                       tm.col_start, tm.col_rows, tm.n_dst_tiles)
    dense = tb._qbcsr_matmul_plain(x, tm.mask, tm.scale, tm.src_tile, tm.dst_tile, tm.n_dst_tiles)
    reads = torch.zeros(n, dtype=torch.bool)  # destination columns with an entry reading the inf
    for blk in range(tm.mask.shape[0]):
        if int(tm.src_tile[blk]) == int(tm.src_tile[b]):
            cols = torch.nonzero(tm.mask[blk, row]).squeeze(1)
            reads[int(tm.dst_tile[blk]) * T + cols] = True
    assert torch.isinf(walk[0, reads]).all() and (walk[0, ~reads] == 0).all() and not walk[1:].any()
    assert torch.isnan(dense[0]).sum() > 0 and torch.isnan(dense[0, ~reads]).any()
