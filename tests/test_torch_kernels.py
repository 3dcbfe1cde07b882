"""The CUDA kernels' wrappers: on a CPU tensor they take the plain version;
on the card they launch the kernel (compared with the plain version there).
The card tests carry the ``cuda`` marker and skip where
``torch.cuda.is_available()`` is False; on a machine with a card (and no JAX)
run them with ``python -m pytest tests/test_torch_kernels.py --noconftest``."""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch import kernels
from gnnkeras_tpu_torch.ops import bcsr, fused, incidence, strip

# one thread: the CPU wrapper tests compare bit for bit, and a multi-threaded
# BLAS may split a product differently from one call to the next
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _strip_inputs(storage, t=5, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(d, t * 128, generator=g)
    m = (torch.rand(t, 128, 128, generator=g) < 0.05)
    if storage == "int8":
        return x, m.to(torch.int8), torch.rand(t, 128, generator=g)
    w = m * torch.rand(t, 128, 128, generator=g)
    return x, w.to(getattr(torch, storage)), None


def _mixed_inputs(storage, slot, ts=3, tb=2, d=16, seed=0):
    """State and a mixed-format operator: ``ts`` compact (slot, 128) strips,
    then ``tb`` full blocks (None when 0), in ``storage`` with the int8
    scales."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(d, (ts + tb) * 128, generator=g)

    def op(shape):
        m = torch.rand(*shape, generator=g) < 0.08
        if storage == "int8":
            return m.to(torch.int8), torch.rand(shape[0], 128, generator=g)
        return (m * torch.rand(*shape, generator=g)).to(getattr(torch, storage)), None

    strip_op, scale = op((ts, slot, 128))
    blocks, blocks_scale = op((tb, 128, 128)) if tb else (None, None)
    return x, strip_op, scale, blocks, blocks_scale


def _qbcsr_inputs(storage, n_tiles=12, n_dst_tiles=None, per_tile=3, d=16, pad_to=None, seed=0):
    """State and a quantised operator of ``per_tile`` random source tiles per
    destination tile (``n_dst_tiles`` of them: rectangular when it differs
    from ``n_tiles``), sparse 0/1 masks with random column scales, or bf16
    weights; optionally padded to ``pad_to`` blocks."""
    rng = np.random.default_rng(seed)
    n_dst_tiles = n_tiles if n_dst_tiles is None else n_dst_tiles
    dst_tile = np.repeat(np.arange(n_dst_tiles), per_tile)
    src_tile = rng.integers(0, n_tiles, len(dst_tile))
    key = np.unique(src_tile * n_dst_tiles + dst_tile)
    src, dst = [], []
    for k in key:
        s, t = divmod(int(k), n_dst_tiles)
        e = rng.integers(0, 128, (2, 40))
        src.append(s * 128 + e[0])
        dst.append(t * 128 + e[1])
    src, dst = np.concatenate(src), np.concatenate(dst)
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    w = rng.random(len(pairs)) + 0.5
    if storage == "int8":  # one weight per destination column: factors
        w = (1.0 / (1 + pairs[:, 1] % 7))
    m = bcsr.build_bcsr(pairs[:, 0], pairs[:, 1], w, n_tiles * 128, n_dst_tiles * 128, max_band_factor=10**9)
    qm = bcsr.quantize_bcsr(m, storage)
    assert (qm.scale is not None) == (storage == "int8")
    if pad_to is not None:
        qm = bcsr.pad_qbcsr(qm, pad_to)
    x = torch.from_numpy(rng.normal(size=(d, n_tiles * 128)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(d, n_dst_tiles * 128)).astype(np.float32))
    return x, ct, qm


def _fused_inputs(t=4, d=14, d_pad=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    s0 = torch.zeros(d_pad, t * 128)
    s0[:d] = torch.randn(d, t * 128, generator=g)
    c = torch.zeros(d_pad, t * 128)
    c[:d] = 0.3 * torch.randn(d, t * 128, generator=g)
    # Weights scaled by 1/sqrt(d), and block columns summing to about 1 as
    # average aggregation's 1/indeg weights do, keep the 5-iteration map from
    # growing the state: grown to hundreds (d = 22 or 30 with unscaled
    # inputs), f32 alone departs from f64 by more than the tolerance.
    w = lambda: 0.25 * (14 / d) ** 0.5 * torch.randn(d, d, generator=g)
    blocks = 0.3 * (torch.rand(t, 128, 128, generator=g) < 0.05) * torch.rand(t, 128, 128, generator=g)
    blocks = blocks.to(torch.bfloat16)
    return s0, c, w(), w(), fused.FusedDiagOperator(blocks=blocks, tile=128)


@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
def test_strip_cpu_wrapper_takes_plain_version(storage):
    x, m, s = _strip_inputs(storage)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(strip.strip_matmul(x, m, s), strip._strip_matmul_plain(x, m, s), rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
def test_strip_t_cpu_wrapper_takes_plain_version(storage):
    x, m, s = _strip_inputs(storage)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(strip.strip_matmul_t(x, m, s), strip._strip_matmul_t_plain(x, m, s), rtol=0, atol=0)
    # the autograd backward of strip_matmul runs the same wrapper
    x.requires_grad_(True)
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad(strip.strip_matmul(x, m, s), x, ct)
    torch.testing.assert_close(grad, strip._strip_matmul_t_plain(ct, m, s), rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("slot", [32, 64])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
def test_mixed_strip_cpu_wrappers_take_plain_version(storage, slot):
    x, *op = _mixed_inputs(storage, slot)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(strip.strip_matmul(x, *op, slot), strip._strip_matmul_plain(x, *op, slot),
                               rtol=0, atol=0)
    torch.testing.assert_close(strip.strip_matmul_t(x, *op, slot), strip._strip_matmul_t_plain(x, *op, slot),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_qbcsr_cpu_wrappers_take_plain_version(storage):
    x, ct, qm = _qbcsr_inputs(storage, n_dst_tiles=5)
    before = dict(kernels.LAUNCHES)
    want = bcsr._qbcsr_matmul_plain(x, qm.mask, qm.scale, qm.src_tile, qm.dst_tile, qm.n_dst_tiles)
    torch.testing.assert_close(bcsr.qbcsr_matmul(x, qm), want, rtol=0, atol=0)
    want_t = bcsr._qbcsr_matmul_t_plain(ct, qm.mask, qm.scale, qm.src_tile, qm.dst_tile, qm.n_src_tiles)
    torch.testing.assert_close(bcsr.qbcsr_matmul_t(ct, qm), want_t, rtol=0, atol=0)
    # the autograd backward of qbcsr_aggregate_t runs the same wrapper
    x.requires_grad_(True)
    (grad,) = torch.autograd.grad(bcsr.qbcsr_aggregate_t(x, qm), x, ct)
    torch.testing.assert_close(grad, want_t, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_fused_cpu_wrapper_takes_plain_version():
    s0, c, ws, wa, op = _fused_inputs()
    before = dict(kernels.LAUNCHES)
    got = fused.fused_unfold_t(s0, c, ws, wa, op, 5, "selu")
    pad = lambda w: torch.nn.functional.pad(w.T, (0, 2, 0, 2))
    want = fused._fused_unfold_t_plain(s0, c, pad(ws), pad(wa), op.blocks, 5, "selu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def _fused_rm_inputs(t=4, d=14, storage=torch.bfloat16, seed=0):
    """Row-major whole-unfold inputs: state (N, d), constant (N, d), two
    (d, d) weights scaled as in ``_fused_inputs``, blocks dst rows × src
    cols in ``storage``."""
    g = torch.Generator().manual_seed(seed)
    s0 = torch.randn(t * 128, d, generator=g)
    c = 0.3 * torch.randn(t * 128, d, generator=g)
    w = lambda: 0.25 * (14 / d) ** 0.5 * torch.randn(d, d, generator=g)
    blocks = 0.3 * (torch.rand(t, 128, 128, generator=g) < 0.05) * torch.rand(t, 128, 128, generator=g)
    return s0, c, w(), w(), fused.FusedDiagOperator(blocks=blocks.to(storage), tile=128)


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32])
def test_fused_rowmajor_cpu_wrapper_takes_plain_version(storage):
    s0, c, ws, wa, op = _fused_rm_inputs(storage=storage)
    before = dict(kernels.LAUNCHES)
    got = fused.fused_unfold(s0, c, ws, wa, op, 5, "selu")
    want = fused._fused_unfold_plain(s0, c, ws, wa, op.blocks, 5, "selu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def _incidence_inputs(n_arcs=1000, n_node_tiles=12, spread=(3, 3), pad_to=None, seed=0):
    """Incidence pairs of ``n_arcs`` arcs whose source lies in one of
    ``spread[0]`` node tiles after its arc tile's own and whose destination in
    one of the ``spread[1]`` after those, so each arc tile touches up to
    sum(spread) node tiles; optionally padded to ``pad_to`` pairs."""
    rng = np.random.default_rng(seed)
    at = np.arange(n_arcs) // 128
    src = ((at + rng.integers(0, spread[0], n_arcs)) % n_node_tiles) * 128 + rng.integers(0, 128, n_arcs)
    dst = ((at + spread[0] + rng.integers(0, spread[1], n_arcs)) % n_node_tiles) * 128 + rng.integers(0, 128, n_arcs)
    inc = incidence.build_incidence_pairs(src, dst, n_node_tiles * 128)
    if pad_to is not None:
        inc = incidence.pad_incidence_pairs(inc, pad_to)
    return inc, src, dst


def test_incidence_cpu_wrappers_take_plain_version():
    inc, src, dst = _incidence_inputs()
    g = torch.Generator().manual_seed(3)
    state = torch.randn(inc.n_node_tiles * 128, 14, generator=g)
    ct = torch.randn(len(src), 14, generator=g)
    before = dict(kernels.LAUNCHES)
    for got, want in zip(incidence.incidence_select(state, inc), incidence._incidence_select_plain(state, inc)):
        assert torch.equal(got, want)
    torch.testing.assert_close(incidence.incidence_scatter(ct, 2 * ct, inc),
                               incidence._incidence_scatter_plain(ct, 2 * ct, inc), rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_sources_and_build_paths():
    for name in kernels.SOURCES:
        path = kernels.library_path(name)
        assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    assert set(kernels.LAUNCHES) == {"strip_matmul", "strip_matmul_t", "strip_matmul_bf16_state",
                                     "strip_matmul_t_bf16_state", "fused_unfold_t", "fused_unfold",
                                     "incidence_select", "incidence_scatter", "qbcsr_matmul", "qbcsr_matmul_t",
                                     "ring_all_gather"}


# Every width each kernel is built for: the strip kernels' 8-row and 16-row
# chunks in both directions (the backward's f32 tile needs more than 48 KiB
# of shared memory), and the fused kernel's four instances (24 and 32 need
# more than 48 KiB).  The flagship runs d_pad 16.
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48])
def test_strip_kernel_matches_plain_on_card(cuda, d, storage, direction):
    x, m, s = (None if a is None else a.to(cuda) for a in _strip_inputs(storage, t=40, d=d, seed=d))
    plain = {"strip_matmul": strip._strip_matmul_plain, "strip_matmul_t": strip._strip_matmul_t_plain}[direction]
    before = kernels.LAUNCHES[direction]
    for _ in range(2):  # the second launch finds any shared-memory limit already raised
        got = getattr(strip, direction)(x, m, s)
        torch.cuda.synchronize()
        # f32 sums of the same terms in another order
        torch.testing.assert_close(got, plain(x, m, s), rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES[direction] == before + 2


# The strip kernels at slot 32 and 64: both regions (compact strips, then
# full blocks), no strip tile (Ts = 0: the blocks run as slot-128 strips, as
# ``diag_operands`` passes them), and no block tile, in all three storages
# and both directions, at the 8- and 16-row chunks.
_MIXED_CASES = {"both_regions": dict(ts=20, tb=20), "no_strip_tile": dict(ts=0, tb=20),
                "no_block_tile": dict(ts=20, tb=0)}


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_MIXED_CASES))
@pytest.mark.parametrize("slot", [32, 64])
@pytest.mark.parametrize("d", [8, 16, 24])
def test_mixed_strip_kernel_matches_plain_on_card(cuda, d, slot, case, storage, direction):
    x, strip_op, scale, blocks, blocks_scale = _mixed_inputs(storage, slot, d=d, seed=d + slot,
                                                             **_MIXED_CASES[case])
    op = strip.diag_operands(strip.StripOperator(strip=strip_op, residual=None, scale=scale, slot=slot,
                                                 blocks=blocks, blocks_scale=blocks_scale))
    x, op = x.to(cuda), [o if not isinstance(o, torch.Tensor) else o.to(cuda) for o in op]
    plain = {"strip_matmul": strip._strip_matmul_plain, "strip_matmul_t": strip._strip_matmul_t_plain}[direction]
    before = kernels.LAUNCHES[direction]
    for _ in range(2):  # the second launch finds any shared-memory limit already raised
        got = getattr(strip, direction)(x, *op)
        torch.cuda.synchronize()
        # f32 sums of the same terms in another order
        torch.testing.assert_close(got, plain(x, *op), rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES[direction] == before + 2


# Row 8 at every width its kernel is built for (chunks of 8 to 40 rows:
# 8-40, and 48 = two 24-row chunks), int8 and bf16, both directions; a
# padded block list (zero blocks at the last tile) and a rectangular
# operator (more source than destination tiles, and fewer).
_QBCSR_CASES = {"square": dict(), "padded": dict(pad_to=80), "rectangular_wide": dict(n_dst_tiles=5),
                "rectangular_tall": dict(n_tiles=5, n_dst_tiles=12)}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("case", list(_QBCSR_CASES))
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48])
def test_qbcsr_kernels_match_plain_on_card(cuda, d, case, storage):
    x, ct, qm = _qbcsr_inputs(storage, d=d, seed=d, **_QBCSR_CASES[case])
    if case == "padded":
        assert qm.mask.shape[0] == 80 and not qm.mask[-1].any()
    x, ct, qm = x.to(cuda), ct.to(cuda), qm.to(cuda)
    want = bcsr._qbcsr_matmul_plain(x, qm.mask, qm.scale, qm.src_tile, qm.dst_tile, qm.n_dst_tiles)
    want_t = bcsr._qbcsr_matmul_t_plain(ct, qm.mask, qm.scale, qm.src_tile, qm.dst_tile, qm.n_src_tiles)
    before = dict(kernels.LAUNCHES)
    for _ in range(2):  # the second launch finds any shared-memory limit already raised
        got, got_t = bcsr.qbcsr_matmul(x, qm), bcsr.qbcsr_matmul_t(ct, qm)
        torch.cuda.synchronize()
        # f32 sums of a tile's block products in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES["qbcsr_matmul"] == before["qbcsr_matmul"] + 2
    assert kernels.LAUNCHES["qbcsr_matmul_t"] == before["qbcsr_matmul_t"] + 2
    # the autograd backward of qbcsr_aggregate_t launches the backward kernel
    xg = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(bcsr.qbcsr_aggregate_t(xg, qm), xg, ct)
    torch.testing.assert_close(grad, want_t, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES["qbcsr_matmul_t"] == before["qbcsr_matmul_t"] + 3


@pytest.mark.cuda
def test_qbcsr_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, ct, qm = _qbcsr_inputs("int8")
    x, qm = x.to(cuda), qm.to(cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        bcsr.qbcsr_matmul(x[:6].contiguous(), qm)
    with pytest.raises(ValueError, match="float32"):
        bcsr.qbcsr_matmul(x.double(), qm)
    with pytest.raises(ValueError, match="contiguous"):
        bcsr.qbcsr_matmul(torch.zeros(x.shape[1], x.shape[0], device=cuda).T, qm)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["selu", "relu", "tanh", "sigmoid", "linear"])
@pytest.mark.parametrize("d_pad", [8, 16, 24, 32])
def test_fused_kernel_matches_plain_on_card(cuda, d_pad, activation):
    s0, c, ws, wa, op = _fused_inputs(t=20, d=d_pad - 2, d_pad=d_pad, seed=d_pad)
    s0, c, ws, wa, op = s0.to(cuda), c.to(cuda), ws.to(cuda), wa.to(cuda), op.to(cuda)
    pad = lambda w: torch.nn.functional.pad(w.T, (0, 2, 0, 2))
    want = fused._fused_unfold_t_plain(s0, c, pad(ws), pad(wa), op.blocks, 5, activation)
    before = kernels.LAUNCHES["fused_unfold_t"]
    for _ in range(2):  # the second launch finds the shared-memory limit already raised
        got = fused.fused_unfold_t(s0, c, ws, wa, op, 5, activation)
        torch.cuda.synchronize()
        # 5 chained iterations of f32 sums in another order
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert kernels.LAUNCHES["fused_unfold_t"] == before + 2
    assert np.isfinite(got.cpu().numpy()).all()


# Every state width the row-major kernel takes (1 to 32, padded on chip to
# 16 or 32; f32 blocks need more than 48 KiB of shared memory at both, bf16
# blocks at 32), both block storages.  Against the plain
# version on the card: with f32 blocks only the order of f32 sums differs,
# over 5 chained iterations; with bf16 blocks a sum of another order can
# round to the neighbouring bf16 value (one bf16 ulp), and the difference
# spreads through the rest of the unfolding to the rows the block links it
# to (these random blocks link each row to ~6 others anywhere in its tile).
# So there every element stays within 2^-6 of the state's largest magnitude,
# and a few rows leave the f32 tolerance: at most 70 of 2,560 (2.7%) at any
# width on an H100 (NVIDIA H100 80GB HBM3, 700 W); the bound allows 5%.
@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", list(range(1, 33)))
def test_fused_rowmajor_kernel_matches_plain_on_card(cuda, d, storage):
    dtype = getattr(torch, storage)
    s0, c, ws, wa, op = (x.to(cuda) for x in _fused_rm_inputs(t=20, d=d, storage=dtype, seed=d))
    want = fused._fused_unfold_plain(s0, c, ws, wa, op.blocks, 5, "selu")
    before = kernels.LAUNCHES["fused_unfold"]
    for _ in range(2):  # the second launch finds the shared-memory limit already raised
        got = fused.fused_unfold(s0, c, ws, wa, op, 5, "selu")
        torch.cuda.synchronize()
        diff = (got - want).abs()
        beyond = (diff > 1e-5 + 1e-4 * want.abs()).any(dim=1)
        if storage == "float32":
            assert not beyond.any(), float(diff.max())
        else:
            stats = (float(diff.max()), int(beyond.sum()), len(beyond))
            print("bf16 d", d, "max_abs_diff, rows beyond the f32 tolerance, rows:", *stats)
            assert float(diff.max()) <= 2.0**-6 * float(want.abs().max()), stats
            assert int(beyond.sum()) <= 0.05 * len(beyond), stats
    assert kernels.LAUNCHES["fused_unfold"] == before + 2
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid", "linear"])
def test_fused_rowmajor_kernel_activations_on_card(cuda, activation):
    s0, c, ws, wa, op = (x.to(cuda) for x in _fused_rm_inputs(t=20, storage=torch.float32, seed=1))
    want = fused._fused_unfold_plain(s0, c, ws, wa, op.blocks, 5, activation)
    got = fused.fused_unfold(s0, c, ws, wa, op, 5, activation)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(fused.fused_unfold(s0, c, ws, wa, op, 0, activation), s0)


@pytest.mark.cuda
def test_fused_rowmajor_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    s0, c, ws, wa, op = (x.to(cuda) for x in _fused_rm_inputs(t=2, d=33, storage=torch.float32))
    with pytest.raises(ValueError, match="1 to 32"):
        fused.fused_unfold(s0, c, ws, wa, op, 5, "selu")
    s0, c, ws, wa, op = (x.to(cuda) for x in _fused_rm_inputs(t=2))
    with pytest.raises(ValueError, match="float32"):
        fused.fused_unfold(s0.double(), c, ws, wa, op, 5, "selu")
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_unfold(s0, c.T.contiguous().T, ws, wa, op, 5, "selu")


# Widths 1 and 3 (one float per load), 14 (two), 24 and 32 (four, 16 bytes);
# the scatter's 8-, 16- and 32-feature chunks, and two chunks at 40.  An arc
# count that is not a multiple of 128 leaves -1 cols in the last arc tile;
# padding pairs are inert; "above_budget" has more than 10,240 pairs, where
# the JAX package leaves its fused pair kernel for the XLA-assisted one.
_INCIDENCE_CASES = {
    "ragged": dict(n_arcs=1000),
    "padded": dict(n_arcs=1000, pad_to=12 * 8),
    "above_budget": dict(n_arcs=1000 * 128 - 37, n_node_tiles=40, spread=(6, 6)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_INCIDENCE_CASES))
@pytest.mark.parametrize("d", [1, 3, 14, 24, 32, 40])
def test_incidence_kernels_match_plain_on_card(cuda, d, case):
    inc, src, dst = _incidence_inputs(seed=d, **_INCIDENCE_CASES[case])
    if case == "above_budget":
        assert inc.n_live > 10_240
    if case == "padded":
        assert inc.n_pairs > inc.n_live
    inc = inc.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(d)
    state = torch.randn(inc.n_node_tiles * 128, d, generator=g, device=cuda)
    state[0, 0] = -0.0
    state[1, -1] = 1e-40  # a subnormal
    ct_src = torch.randn(len(src), d, generator=g, device=cuda)
    ct_dst = torch.randn(len(src), d, generator=g, device=cuda)
    want_sel = incidence._incidence_select_plain(state, inc)
    want_sc = incidence._incidence_scatter_plain(ct_src, ct_dst, inc)
    before = dict(kernels.LAUNCHES)
    for _ in range(2):
        y_src, y_dst = incidence.incidence_select(state, inc)
        out = incidence.incidence_scatter(ct_src, ct_dst, inc)
        torch.cuda.synchronize()
        # a copy: bit for bit
        assert torch.equal(y_src.view(torch.int32), want_sel[0].view(torch.int32))
        assert torch.equal(y_dst.view(torch.int32), want_sel[1].view(torch.int32))
        # f32 sums of a node's few incident cotangents in another order
        torch.testing.assert_close(out, want_sc, rtol=1e-5, atol=1e-5)
    src_t, dst_t = torch.from_numpy(src).to(cuda).long(), torch.from_numpy(dst).to(cuda).long()
    assert torch.equal(y_src[: len(src)], state[src_t]) and torch.equal(y_dst[: len(src)], state[dst_t])
    assert not y_src[len(src):].any()
    assert kernels.LAUNCHES["incidence_select"] == before["incidence_select"] + 2
    assert kernels.LAUNCHES["incidence_scatter"] == before["incidence_scatter"] + 2


@pytest.mark.cuda
def test_incidence_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    inc, src, _ = _incidence_inputs()
    inc = inc.to(cuda)
    state = torch.zeros(inc.n_node_tiles * 128, 6, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        incidence.incidence_select(state.double(), inc)
    with pytest.raises(ValueError, match="contiguous"):
        incidence.incidence_select(torch.zeros(6, inc.n_node_tiles * 128, device=cuda).T, inc)
    with pytest.raises(ValueError, match="rows"):
        incidence.incidence_select(state[:-128], inc)
    ct = torch.zeros(len(src), 6, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        incidence.incidence_scatter(ct.half(), ct.half(), inc)


@pytest.mark.cuda
def test_exported_program_moves_to_the_card_and_calls_the_kernels(cuda, tmp_path):
    """A program exported on the CPU, loaded onto the card: its strip
    custom op launches the kernel there, and its outputs equal the CPU
    forward's (f32 sums in another order: rtol 1e-5, atol 1e-6)."""
    from gnnkeras_tpu_torch import export_forward, graphs_to_batch, load_exported
    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn, random_molecules

    model = flagship_gnn("cpu", seed=0)
    batch = graphs_to_batch(random_molecules(16, seed=1), "g", "average", slot_pack=128, strip_dtype="float32",
                            device="cpu")
    export_forward(model, batch, str(tmp_path))
    loaded = load_exported(str(tmp_path), device=cuda)
    before = kernels.LAUNCHES["strip_matmul"]
    out, mask = loaded.call(batch.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["strip_matmul"] == before + 4
    _, _, want, want_mask, _ = model.forward(batch)
    assert torch.equal(mask.cpu(), want_mask)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_exported_arc_program_serves_a_batch_with_more_live_pairs(cuda, tmp_path):
    """The live pair count is a tensor input of the exported program, read
    by the select kernel on the card: the arc artifact traced on a batch of
    2 molecules serves a batch of 32 padded to the same shapes in full, its
    select walking every live pair of the 32.  Against the CPU forward of
    that batch: f32 sums in another order, rtol 1e-5, atol 1e-6."""
    from gnnkeras_tpu_torch import GraphObject, export_forward, graphs_to_batch, load_exported
    from gnnkeras_tpu_torch.data.synthetic import arc_gnn, random_molecules
    from gnnkeras_tpu_torch.graph.batch import pad_operators_to_cap

    def arc_graphs(n_graphs, seed):
        rng = np.random.default_rng(seed)
        return [GraphObject(nodes=g.nodes, arcs=g.arcs, focus="a", aggregation_mode="average",
                            targets=np.eye(2, dtype=np.float32)[rng.integers(0, 2, len(g.arcs))], arcs_canonical=True)
                for g in random_molecules(n_graphs, seed=seed)]

    small, big = arc_graphs(2, 1), arc_graphs(32, 2)
    # arcs padded to the 32's own arc tiles, so every arc tile holds real arcs
    pad_arcs = -(-sum(len(g.arcs) for g in big) // 128) * 128
    template, batch = (pad_operators_to_cap(graphs_to_batch(g, "a", "average", pad_nodes=2048, pad_arcs=pad_arcs,
                                                            pad_graphs=32, slot_pack=128, strip_dtype="float32",
                                                            device="cpu")) for g in (small, big))
    model = arc_gnn("cpu", seed=0)
    inc, lo = batch.arc_inc, template.arc_inc.n_live
    assert inc.n_live > lo and inc.n_pairs == template.arc_inc.n_pairs
    # a select that stopped at the template's live count would leave the
    # supervised arc rows that the later pairs feed at zero
    past = (inc.f_arc_tile[lo:].long()[:, None] * 128 + torch.arange(128))[inc.f_cols_src[lo:] >= 0]
    assert batch.output_row_mask[past].any()
    export_forward(model, template, str(tmp_path))
    loaded = load_exported(str(tmp_path), device=cuda)
    before = kernels.LAUNCHES["incidence_select"]
    out, mask = loaded.call(batch.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["incidence_select"] == before + 1
    _, _, want, want_mask, _ = model.forward(batch)
    assert torch.equal(mask.cpu(), want_mask)
    torch.testing.assert_close(out.cpu()[want_mask], want[want_mask], rtol=1e-5, atol=1e-6)


# The strip kernels' bf16-state instantiation (the experiment scripts'
# product, ``round_state=True``): every width they are built for (8- and
# 16-row chunks), slots 32, 64 and 128, both directions.  The plain version
# rounds the state the same way, so only the order of f32 sums differs.
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("slot", [32, 64, 128])
@pytest.mark.parametrize("d", [8, 16, 24])
def test_bf16_state_strip_kernel_matches_plain_on_card(cuda, d, slot, direction):
    g = torch.Generator().manual_seed(d + slot)
    x = torch.randn(d, 40 * 128, generator=g)
    m = ((torch.rand(40, slot, 128, generator=g) < 0.1) * torch.rand(40, slot, 128, generator=g)).to(torch.bfloat16)
    x, m = x.to(cuda), m.to(cuda)
    plain = {"strip_matmul": strip._strip_matmul_plain, "strip_matmul_t": strip._strip_matmul_t_plain}[direction]
    want = plain(x, m, None, slot=slot, round_state=True)
    before = dict(kernels.LAUNCHES)
    got = getattr(strip, direction)(x, m, slot=slot, round_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES[direction + "_bf16_state"] == before[direction + "_bf16_state"] + 1
    assert kernels.LAUNCHES[direction] == before[direction]
    # the unrounded product differs: the instantiation does round
    assert (getattr(strip, direction)(x, m, slot=slot) - got).abs().max() > 1e-4


def test_bf16_state_refuses_what_it_is_not_built_for():
    x, m, _ = _strip_inputs("float32", t=2)
    with pytest.raises(ValueError, match="round_state"):
        strip.strip_matmul(x, m, round_state=True)
    x, strip_op, scale, blocks, blocks_scale = _mixed_inputs("bfloat16", 32, ts=16, tb=1)
    with pytest.raises(ValueError, match="round_state"):
        strip.strip_matmul(x, strip_op, None, blocks, None, slot=32, round_state=True)


# The ring all-gather (kernel row 9) on P ranks sharing the card: against its
# plain version bit for bit (it only moves data), at widths 1 to 40, a single
# row, row counts whose bytes are not a multiple of 16 (the kernel's narrower
# copies), bf16 and f32, a block larger than the first buffer (the group's
# regions are reallocated), and every call right after the last on one group
# (the flags are running counters: no reset between launches).
_RING_SHAPES = [(rows, d, dt) for d in (1, 3, 8, 14, 16, 40) for rows, dt in ((1, "float32"), (37, "bfloat16"),
                                                                               (1000, "float32"))]
_RING_SHAPES.append((120_000, 8, "float32"))


def _ring_on_card(rank: int, world: int) -> list:
    from gnnkeras_tpu_torch.ops import ring
    from gnnkeras_tpu_torch.parallel.mesh import rank_device

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    out = []
    for i, (rows, d, dt) in enumerate(_RING_SHAPES):
        g = torch.Generator(device=dev).manual_seed(1000 * i + rank)
        x = torch.randn(rows, d, generator=g, device=dev).to(getattr(torch, dt))
        before = kernels.LAUNCHES["ring_all_gather"]
        got = ring.ring_all_gather(x)
        again = ring.ring_all_gather(x)
        want = ring._ring_all_gather_plain(x)
        out.append((rows, d, dt, bool(torch.equal(got, want)), bool(torch.equal(again, want)),
                    kernels.LAUNCHES["ring_all_gather"] - before))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3, 4])
def test_ring_kernel_matches_plain_on_card(cuda, parts):
    from gnnkeras_tpu_torch.parallel.launch import spawn

    for rank_results in spawn(_ring_on_card, parts, timeout_s=600):
        for rows, d, dt, equal, equal_again, launches in rank_results:
            assert equal and equal_again, (parts, rows, d, dt)
            assert launches == 2
