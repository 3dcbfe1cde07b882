"""The CUDA kernels' wrappers: on a CPU tensor they take the plain version;
on the card they launch the kernel (compared with the plain version there).
The card tests carry the ``cuda`` marker and skip where
``torch.cuda.is_available()`` is False; on a machine with a card (and no JAX)
run them with ``python -m pytest tests/test_torch_kernels.py --noconftest``."""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch import kernels
from gnnkeras_tpu_torch.ops import fused, incidence, strip

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


def test_fused_cpu_wrapper_takes_plain_version():
    s0, c, ws, wa, op = _fused_inputs()
    before = dict(kernels.LAUNCHES)
    got = fused.fused_unfold_t(s0, c, ws, wa, op, 5, "selu")
    pad = lambda w: torch.nn.functional.pad(w.T, (0, 2, 0, 2))
    want = fused._fused_unfold_t_plain(s0, c, pad(ws), pad(wa), op.blocks, 5, "selu")
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
    assert set(kernels.LAUNCHES) == {"strip_matmul", "strip_matmul_t", "fused_unfold_t", "incidence_select",
                                     "incidence_scatter"}


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
