"""The CUDA kernels' wrappers: on a CPU tensor they take the plain version;
on the card they launch the kernel (compared with the plain version there).
The card tests carry the ``cuda`` marker and skip where
``torch.cuda.is_available()`` is False; on a machine with a card (and no JAX)
run them with ``python -m pytest tests/test_torch_kernels.py --noconftest``."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_fused_order as order
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
    want = bcsr._qbcsr_list_matmul_plain(x, qm.scale, qm.col_weights, qm.src_tile, qm.dst_tile, qm.nz_start,
                                         qm.col_start, qm.col_rows, qm.n_dst_tiles)
    torch.testing.assert_close(bcsr.qbcsr_matmul(x, qm), want, rtol=0, atol=0)
    want_t = bcsr._qbcsr_list_matmul_t_plain(ct, qm.scale, qm.row_weights, qm.src_tile, qm.dst_tile, qm.nz_start,
                                             qm.row_start, qm.row_cols, qm.n_src_tiles)
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
    got_sel = incidence.incidence_select(state, inc)
    want_rows = incidence._incidence_select_rows(state, inc.arc_ends, inc.n_arc_tiles)
    for got, want, pairs in zip(got_sel, want_rows, incidence._incidence_select_plain(state, inc)):
        assert torch.equal(got, want) and torch.equal(got, pairs)
    torch.testing.assert_close(incidence.incidence_scatter(ct, 2 * ct, inc),
                               incidence._incidence_scatter_walk(ct, 2 * ct, inc), rtol=0, atol=0)
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


# Past 48 feature rows the strip kernels run chunks of 48 rows, one grid row
# each (the homogeneous LGNN's layers 3 and 4 run d_pad 64 and 80): against
# the plain version, and bit for bit against a second launch (each output
# is one chain over its contraction, in one chunk).
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("d", [56, 64, 80, 96])
def test_strip_kernel_past_48_rows_on_card(cuda, d, storage, direction):
    x, m, s = (None if a is None else a.to(cuda) for a in _strip_inputs(storage, t=40, d=d, seed=d))
    plain = {"strip_matmul": strip._strip_matmul_plain, "strip_matmul_t": strip._strip_matmul_t_plain}[direction]
    fn = getattr(strip, direction)
    got, again = fn(x, m, s), fn(x, m, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(x, m, s), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    # each chunk of 48 rows is its own product: the rows past 48 equal a launch on them alone
    tail = fn(x[48:].contiguous(), m, s)
    assert torch.equal(got[48:], tail)


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


def _strip_case_on(cuda, storage, slot, d, seed):
    """(x, operands) of a slot-128 operator, or at slot 32 a mixed one."""
    if slot == 128:
        x, m, s = _strip_inputs(storage, t=40, d=d, seed=seed)
        return x.to(cuda), [m.to(cuda), None if s is None else s.to(cuda), None, None, 128]
    x, *op = _mixed_inputs(storage, slot, ts=20, tb=20, d=d, seed=seed)
    return x.to(cuda), [None if o is None else o.to(cuda) for o in op] + [slot]


# The strip kernels sum in a fixed order (no atomics): two launches on the
# same operands give the same bits.
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("slot", [32, 128])
def test_strip_kernel_is_deterministic_on_card(cuda, slot, storage, direction):
    x, op = _strip_case_on(cuda, storage, slot, 16, seed=7)
    fn = getattr(strip, direction)
    assert torch.equal(fn(x, *op), fn(x, *op))


# Every f32 exponent the kernels meet: feature rows scaled by 2^-60 … 2^60
# (each row, scaled back, against the plain version at the tolerance above),
# and values of those exponents mixed within a row (against the exact f64
# product, within 2^-17 of the sum of the terms' magnitudes: 128 f32
# roundings of a fused multiply-add chain).
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("slot", [32, 128])
def test_strip_kernel_across_exponents_on_card(cuda, slot, storage, direction):
    x, op = _strip_case_on(cuda, storage, slot, 16, seed=11)
    fn = getattr(strip, direction)
    plain = getattr(strip, f"_{direction}_plain")
    rows = torch.ldexp(torch.ones(16, 1, device=cuda), torch.arange(-60, 61, 8, device=cuda)[:, None])
    got, want = fn(x * rows, *op), plain(x * rows, *op)
    torch.testing.assert_close(got / rows, want / rows, rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(12)
    mixed = torch.ldexp(x, torch.randint(-60, 61, x.shape, generator=g).to(cuda))
    full, sc = strip._full_operator(*op[:4], op[4])
    dense = (full.double() if sc is None else full.double() * sc.double()[:, None, :])
    dense = dense.transpose(1, 2) if direction == "strip_matmul_t" else dense
    tiles = mixed.double().reshape(16, -1, 128).permute(1, 0, 2)
    exact = torch.bmm(tiles, dense).permute(1, 0, 2).reshape(mixed.shape)
    mag = torch.bmm(tiles.abs(), dense.abs()).permute(1, 0, 2).reshape(mixed.shape)
    err = (fn(mixed, *op).double() - exact).abs()
    assert (err <= 2.0**-17 * mag).all()


def _fma_chain(x, op, scale, transpose):
    """Per tile and output, the f32 fused multiply-add chain from 0 over
    the contraction in order, as ``_strip_matmul_plain`` / ``_t_plain``
    multiply (each step in f64, where the product is exact, rounded once to
    f32), with the forward's scale on the output columns and the
    backward's on the cotangent first."""
    d, n = x.shape
    tiles = x.reshape(d, -1, 128).permute(1, 0, 2).numpy()  # (T, d, 128)
    w = op.double().numpy()
    if transpose:
        if scale is not None:
            tiles = tiles * scale.numpy()[:, None, :]  # f32 products, as the plain version's
        w = w.transpose(0, 2, 1)
    acc = np.zeros(tiles.shape, np.float32)
    x64 = tiles.astype(np.float64)
    for k in range(128):
        acc = (acc + x64[:, :, k, None] * w[:, None, k, :]).astype(np.float32)
    if not transpose and scale is not None:
        acc = acc * scale.numpy()[:, None, :]
    return torch.from_numpy(acc).permute(1, 0, 2).reshape(d, n)


# The plain version, the CPU's path and the reference of the card's checks,
# sums each output as a fused multiply-add chain over the contraction in
# order: the order the kernels follow (below).
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("slot", [32, 128])
def test_strip_plain_sums_in_contraction_order(slot, storage, direction):
    x, op = _strip_case_on("cpu", storage, slot, 16, seed=13)
    full, sc = strip._full_operator(*op[:4], op[4])
    want = _fma_chain(x, full, sc, direction == "strip_matmul_t")
    assert torch.equal(getattr(strip, f"_{direction}_plain")(x, *op), want)


# The strip kernels sum as the plain version's f32 product does: each output
# a fused multiply-add chain over the contraction in order, bit for bit, so
# the card's forwards and train steps meet the CPU's (zero entries leave a
# chain unchanged, so the kernels skip the expanded strips' zero blocks).
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["strip_matmul", "strip_matmul_t"])
@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("slot", [32, 128])
def test_strip_kernel_sums_in_contraction_order_on_card(cuda, slot, storage, direction):
    x, op = _strip_case_on(cuda, storage, slot, 16, seed=13)
    got = getattr(strip, direction)(x, *op).cpu()
    full, sc = strip._full_operator(*[None if o is None else o.cpu() for o in op[:4]], op[4])
    want = _fma_chain(x.cpu(), full, sc, direction == "strip_matmul_t")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_strip_kernel_refuses_a_misaligned_operand(cuda):
    x, m, _ = _strip_inputs("bfloat16", t=4)
    x, m = x.to(cuda), m.to(cuda)
    flat = torch.zeros(m.numel() + 8, dtype=m.dtype, device=cuda)
    view = flat[2:2 + m.numel()].view(m.shape)  # 4 bytes past a 16-byte boundary
    view.copy_(m)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    for fn in (strip.strip_matmul, strip.strip_matmul_t):
        with pytest.raises(ValueError, match="16-byte"):
            fn(x, view)
    torch.testing.assert_close(strip.strip_matmul(x, m), strip._strip_matmul_plain(x, m, None), rtol=1e-5, atol=1e-5)


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
    walk = bcsr._qbcsr_list_matmul_plain(x, qm.scale, qm.col_weights, qm.src_tile, qm.dst_tile, qm.nz_start,
                                         qm.col_start, qm.col_rows, qm.n_dst_tiles)
    walk_t = bcsr._qbcsr_list_matmul_t_plain(ct, qm.scale, qm.row_weights, qm.src_tile, qm.dst_tile, qm.nz_start,
                                             qm.row_start, qm.row_cols, qm.n_src_tiles)
    before = dict(kernels.LAUNCHES)
    outs = []
    for _ in range(2):
        got, got_t = bcsr.qbcsr_matmul(x, qm), bcsr.qbcsr_matmul_t(ct, qm)
        torch.cuda.synchronize()
        # f32 sums of a tile's block products in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, walk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_t, walk_t, rtol=1e-5, atol=1e-5)
        outs.append((got, got_t))
    # a fixed sum order and no atomics: the same bits from call to call
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
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
    # the lists in another type than the kernel reads, or an int8 mask's
    # lists without its scale
    with pytest.raises(ValueError, match="int16"):
        bcsr.qbcsr_matmul(x, dataclasses.replace(qm, col_start=qm.col_start.int()))
    with pytest.raises(ValueError, match="uint8"):
        bcsr.qbcsr_matmul_t(ct.to(cuda), dataclasses.replace(qm, row_cols=qm.row_cols.int()))
    with pytest.raises(ValueError, match="scale"):
        bcsr._launch_qbcsr("qbcsr_matmul", x, None, None, qm.src_tile, None, qm.row_ptr, qm.nz_start, qm.col_start,
                           qm.col_rows, qm.n_dst_tiles)


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


# (tiles, seed, special): the special tiles beside sparse ones, and more
# tiles than the card keeps resident blocks (132 SMs; two blocks each at
# the flagship's widths, one at the widest), in counts that divide neither,
# so blocks walk several tiles through the ring
_ORDER_CASES = {"special": (6, 3, True), "301_tiles": (301, 4, False), "157_tiles": (157, 5, False)}


# The whole-unfold kernels sum as tests/torch_fused_order.py does: each
# aggregate an fmaf chain over the contraction ascending (zero entries
# skipped, which leaves a chain as it was), each transition output two
# chains over f ascending, then (zs + za) + c.  With the linear activation
# (no exp or tanh of the card's own) the state is the reference's bit for
# bit, and two launches give the same bits.  Row 2 at every width it is
# built for; many tiles at the flagship's width and the widest.
@pytest.mark.cuda
@pytest.mark.parametrize("case,d_pad", [("special", 8), ("special", 16), ("special", 24), ("special", 32),
                                        ("301_tiles", 16), ("157_tiles", 32)])
def test_fused_kernel_sums_in_the_kernels_order_on_card(cuda, case, d_pad):
    t, seed, special = _ORDER_CASES[case]
    s0, c, ws, wa, blocks = order.inputs_t(d_pad, t, seed, special)
    want = order.unfold_t(s0, c, order.pad_t(ws, d_pad), order.pad_t(wa, d_pad), blocks, 5, "linear")
    op = fused.FusedDiagOperator(blocks=torch.from_numpy(blocks).to(torch.bfloat16).to(cuda), tile=128)
    args = [torch.from_numpy(x).to(cuda) for x in (s0, c, ws, wa)]
    got = [fused.fused_unfold_t(*args, op, 5, "linear").cpu().numpy() for _ in range(2)]
    assert order.same_bits(got[0], got[1])
    assert order.same_bits(got[0], want), float(np.abs(got[0] - want).max())


# Row 4 at d 1 (DP 16), 14 (the flagship), 16, 17 (DP 32) and 32, both
# storages; many tiles at d 14 and 32.
@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,d", [("special", 1), ("special", 14), ("special", 16), ("special", 17),
                                    ("special", 32), ("301_tiles", 14), ("157_tiles", 32)])
def test_fused_rowmajor_kernel_sums_in_the_kernels_order_on_card(cuda, case, d, storage):
    t, seed, special = _ORDER_CASES[case]
    s0, c, ws, wa, blocks = order.inputs_rm(d, t, seed, special, w_std=0.25 * (14 / d) ** 0.5)
    want = order.unfold(s0, c, ws, wa, blocks, 5, "linear", round_bf16=storage == "bfloat16")
    op = fused.FusedDiagOperator(blocks=torch.from_numpy(blocks).to(getattr(torch, storage)).to(cuda), tile=128)
    args = [torch.from_numpy(x).to(cuda) for x in (s0, c, ws, wa)]
    got = [fused.fused_unfold(*args, op, 5, "linear").cpu().numpy() for _ in range(2)]
    assert order.same_bits(got[0], got[1])
    assert order.same_bits(got[0], want), float(np.abs(got[0] - want).max())


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
    want_rows = incidence._incidence_select_rows(state, inc.arc_ends, inc.n_arc_tiles)
    want_sc = incidence._incidence_scatter_plain(ct_src, ct_dst, inc)
    want_walk = incidence._incidence_scatter_walk(ct_src, ct_dst, inc)
    before = dict(kernels.LAUNCHES)
    outs = []
    for _ in range(2):
        y_src, y_dst = incidence.incidence_select(state, inc)
        out = incidence.incidence_scatter(ct_src, ct_dst, inc)
        torch.cuda.synchronize()
        # a copy: bit for bit, against both plain versions
        for got, pairs, rows in zip((y_src, y_dst), want_sel, want_rows):
            assert torch.equal(got.view(torch.int32), pairs.view(torch.int32))
            assert torch.equal(got.view(torch.int32), rows.view(torch.int32))
        # f32 sums of a node's few incident cotangents in another order
        torch.testing.assert_close(out, want_sc, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out, want_walk, rtol=1e-5, atol=1e-5)
        outs.append(out)
    # the scatter's sum order is fixed: the same bits from call to call
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
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
    # the arc-major index in another type, or of more arcs than its tiles hold
    with pytest.raises(ValueError, match="int32"):
        incidence.incidence_select(state, dataclasses.replace(inc, arc_ends=inc.arc_ends.long()))
    with pytest.raises(ValueError, match="index"):
        incidence._incidence_select_op(state, inc.arc_ends, 1)


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
    """The select's arc-major index is a tensor input of the exported
    program, read by the select kernel on the card: the arc artifact traced
    on a batch of 2 molecules serves a batch of 32 padded to the same shapes
    in full, its select copying every arc row of the 32.  Against the CPU
    forward of that batch: f32 sums in another order, rtol 1e-5, atol
    1e-6."""
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
# row (f32 and bf16), row counts whose bytes are not a multiple of 16 (the
# kernels' narrower copies), bf16 and f32, a block larger than the first
# buffer (the group's regions are reallocated), every call right after the
# last on one group (the counters run on: no reset between calls), and a
# ring on the sub-group of ranks 1 .. P - 1 beside the world's.
_RING_SHAPES = [(rows, d, dt) for d in (1, 3, 8, 14, 16, 40) for rows, dt in ((1, "float32"), (1, "bfloat16"),
                                                                               (37, "bfloat16"), (1000, "float32"))]
_RING_SHAPES.append((120_000, 8, "float32"))


def _ring_on_card(rank: int, world: int) -> list:
    import torch.distributed as dist

    from gnnkeras_tpu_torch.ops import ring
    from gnnkeras_tpu_torch.parallel.mesh import rank_device

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    sub = dist.new_group(list(range(1, world)))  # every rank takes part in making it
    groups = [("world", None)] + ([("ranks_1_up", sub)] if world > 2 and rank > 0 else [])
    out = []
    for label, group in groups:
        for i, (rows, d, dt) in enumerate(_RING_SHAPES):
            g = torch.Generator(device=dev).manual_seed(1000 * i + rank)
            x = torch.randn(rows, d, generator=g, device=dev).to(getattr(torch, dt))
            before = kernels.LAUNCHES["ring_all_gather"]
            got = ring.ring_all_gather(x, group)
            again = ring.ring_all_gather(x, group)
            want = ring._ring_all_gather_plain(x, group)
            out.append((label, rows, d, dt, bool(torch.equal(got, want)), bool(torch.equal(again, want)),
                        kernels.LAUNCHES["ring_all_gather"] - before))
    dist.barrier()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3, 4])
def test_ring_kernel_matches_plain_on_card(cuda, parts):
    from gnnkeras_tpu_torch.parallel.launch import spawn

    results = spawn(_ring_on_card, parts, timeout_s=600)
    for rank, rank_results in enumerate(results):
        labels = {label for label, *_ in rank_results}
        assert labels == ({"world", "ranks_1_up"} if parts > 2 and rank > 0 else {"world"})
        for label, rows, d, dt, equal, equal_again, launches in rank_results:
            assert equal and equal_again, (parts, label, rows, d, dt)
            assert launches == 4  # two calls, each a push and a copy-out


def _ring_peer_stops(rank: int, world: int, timeout_s: float) -> tuple:
    """One call on both ranks, then a second on rank 0 alone: rank 0's wait
    for rank 1's push must run out after ``ring.TIMEOUT_S`` and raise, and
    the group's ring then refuses further calls."""
    import time

    import torch.distributed as dist

    from gnnkeras_tpu_torch.ops import ring
    from gnnkeras_tpu_torch.parallel.mesh import rank_device

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    ring.TIMEOUT_S = timeout_s
    x = torch.full((8, 4), float(rank), device=dev)
    first = bool(torch.equal(ring.ring_all_gather(x), ring._ring_all_gather_plain(x)))
    dist.barrier()
    raised, waited, refused = None, None, None
    if rank == 0:
        t = time.perf_counter()
        try:
            ring.ring_all_gather(x)
        except RuntimeError as err:
            raised = str(err)
        waited = time.perf_counter() - t
        try:
            ring.ring_all_gather(x)
        except RuntimeError as err:
            refused = str(err)
    torch.cuda.synchronize()
    dist.barrier()
    return first, raised, waited, refused


@pytest.mark.cuda
def test_ring_raises_when_a_peer_never_calls(cuda):
    from gnnkeras_tpu_torch.parallel.launch import spawn

    timeout_s = 2.0
    (first0, raised, waited, refused), (first1, *_) = spawn(_ring_peer_stops, 2, [(timeout_s,)] * 2, timeout_s=300)
    assert first0 and first1
    assert raised is not None and "ran out" in raised
    assert timeout_s <= waited < timeout_s + 10.0, waited
    assert refused is not None and "broken" in refused


def _ring_push_stalls(rank: int, world: int, timeout_s: float) -> tuple:
    """One call on both ranks, then a second whose push on rank 1 is queued
    behind a kernel that sleeps several times ``ring.TIMEOUT_S``: rank 0's
    call returns (rank 1 posted it), but ``ring_wait`` must run out after
    ``ring.TIMEOUT_S`` and raise instead of blocking until the push lands.
    Once it has landed, rank 0's output is still every rank's block."""
    import time

    import torch.distributed as dist

    from gnnkeras_tpu_torch.ops import ring
    from gnnkeras_tpu_torch.parallel.mesh import rank_device

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    ring.TIMEOUT_S = timeout_s
    x = torch.full((8, 4), float(rank), device=dev)
    first = bool(torch.equal(ring.ring_all_gather(x), ring._ring_all_gather_plain(x)))
    dist.barrier()
    raised, waited = None, None
    if rank == 1:
        torch.cuda._sleep(int(6e9 * timeout_s))  # about 3-6 timeouts at an H100's 1-2 GHz
    out = ring.ring_all_gather(x)
    if rank == 0:
        t = time.perf_counter()
        try:
            ring.ring_wait()
        except RuntimeError as err:
            raised = str(err)
        waited = time.perf_counter() - t
    torch.cuda.synchronize()
    landed = bool(torch.equal(out, torch.arange(world, dtype=x.dtype, device=dev).repeat_interleave(8)[:, None]
                              .expand(-1, 4)))
    dist.barrier()
    return first, raised, waited, landed


@pytest.mark.cuda
def test_ring_wait_raises_when_a_peer_push_never_lands(cuda):
    from gnnkeras_tpu_torch.parallel.launch import spawn

    timeout_s = 2.0
    (first0, raised, waited, landed0), (first1, _, _, landed1) = spawn(_ring_push_stalls, 2, [(timeout_s,)] * 2,
                                                                       timeout_s=300)
    assert first0 and first1
    assert raised is not None and "did not complete" in raised
    assert timeout_s <= waited < timeout_s + 1.0, waited
    assert landed0 and landed1


def _ring_counters(rank: int, world: int) -> tuple:
    """The ring's shared host counters on gloo ranks: each rank writes its
    line, every rank reads every line after a barrier, and the file behind
    them is gone once every rank has mapped it."""
    import os
    import struct

    import torch.distributed as dist

    from gnnkeras_tpu_torch import kernels
    from gnnkeras_tpu_torch.ops import ring

    before = set(os.listdir(kernels.BUILD_DIR)) if os.path.isdir(kernels.BUILD_DIR) else set()
    counters = ring._shared_counters(None, rank, world)
    struct.pack_into("<Q", counters, 64 * rank, 10 + rank)
    dist.barrier()
    seen = [struct.unpack_from("<Q", counters, 64 * q)[0] for q in range(2 * world)]
    dist.barrier()
    left = sorted(f for f in set(os.listdir(kernels.BUILD_DIR)) - before if f.startswith("ring-"))
    size = len(counters)
    counters.close()
    return size, seen, left


def test_ring_shares_counters_between_ranks():
    from gnnkeras_tpu_torch.parallel.launch import spawn

    for size, seen, left in spawn(_ring_counters, 3):
        assert size == 3 * 2 * 64
        assert seen == [10, 11, 12, 0, 0, 0]
        assert left == []


@pytest.mark.cuda
def test_composite_arc_forward_on_card_matches_cpu(cuda):
    """The 3-type arc CGNN (``data/synthetic.typed_arc_cgnn``) on a small
    slot-packed batch: the eval forward on the card (4 strip launches, 1
    select) against the same forward on the CPU, f32 sums in other orders
    (rtol 1e-5, atol 1e-6)."""
    from gnnkeras_tpu_torch import GraphObject, graphs_to_batch
    from gnnkeras_tpu_torch.data import synthetic as S

    rng = np.random.default_rng(4)
    arc = [GraphObject(nodes=g.nodes, arcs=g.arcs, targets=np.eye(2, dtype=np.float32)[rng.integers(0, 2, len(g.arcs))],
                       focus="a", aggregation_mode="average", arcs_canonical=True)
           for g in S.random_molecules(40, seed=4)]
    typed = [S.composite_of(g, 3, "composite_average") for g in arc]
    b_cpu = graphs_to_batch(typed, "a", "composite_average", slot_pack=128, device="cpu")
    model, model_cpu = S.typed_arc_cgnn("cuda"), S.typed_arc_cgnn("cpu")
    kernels.reset_launches()
    k, state, out, mask, _ = model.forward(b_cpu.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["strip_matmul"] == 4 and kernels.LAUNCHES["incidence_select"] == 1
    k_cpu, state_cpu, out_cpu, mask_cpu, _ = model_cpu.forward(b_cpu)
    assert k == k_cpu == 5 and torch.equal(mask.cpu(), mask_cpu)
    rows = mask_cpu
    torch.testing.assert_close(out.cpu()[rows], out_cpu[rows], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state.cpu()[b_cpu.node_mask], state_cpu[b_cpu.node_mask], rtol=1e-5, atol=1e-6)
