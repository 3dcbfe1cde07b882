"""The gradient of the port's strip aggregation (``torch.autograd`` through
the ``strip_matmul`` Function, whose backward is ``strip_matmul_t``, plus
autograd's transpose of the plain BCSR residual) against ``jax.grad`` of the
JAX ``strip_aggregate_t`` (its custom VJP runs the Pallas kernel with
``scale_in=True`` on the transposed blocks, in interpret mode on the CPU).

Both compute in f32; only summation order differs: rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.ops.strip as jstrip
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.ops.strip as tstrip
from gnnkeras_tpu_torch import kernels
from torch_port_common import merged_pair, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_strip_aggregate_t_grad_matches_jax(storage, with_residual):
    # 12 molecules, plus one 150-node graph whose cross-tile arcs make the residual
    raw = unique_pairs(raw_molecules(n_graphs=12, seed=9, big=(150,) if with_residual else ()))
    jm, tm = merged_pair(raw)
    jb = jbatch.from_graph_object(jm, slot_pack=128, strip_dtype=storage)
    tb = tbatch.from_graph_object(tm, slot_pack=128, strip_dtype=storage, device="cpu")
    assert (tb.strip.residual is not None) == with_residual
    rng = np.random.default_rng(4)
    state_t = rng.normal(size=(16, tb.num_nodes)).astype(np.float32)
    # a cotangent with zero pad rows, as the unfolding's padded state gives
    ct = rng.normal(size=(16, tb.num_nodes)).astype(np.float32)
    ct[14:] = 0.0

    loss = lambda s: jnp.sum(jstrip.strip_aggregate_t(s, jb.strip) * ct)
    want = np.asarray(jax.grad(loss)(jnp.asarray(state_t)))

    x = torch.from_numpy(state_t).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    (tstrip.strip_aggregate_t(x, tb.strip) * torch.from_numpy(ct)).sum().backward()
    assert kernels.LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_strip_matmul_t_plain_is_transposed_product():
    """The plain backward is the kernel's decomposition: per tile
    (ct_t · diag(scale_t)) @ M_tᵀ, on a hand-built operator."""
    rng = np.random.default_rng(5)
    t, d = 3, 8
    mask = (rng.random((t, 128, 128)) < 0.05).astype(np.int8)
    scale = rng.random((t, 128)).astype(np.float32)
    ct = rng.normal(size=(d, t * 128)).astype(np.float32)
    got = tstrip.strip_matmul_t(torch.from_numpy(ct), torch.from_numpy(mask), torch.from_numpy(scale)).numpy()
    for k in range(t):
        cols = slice(128 * k, 128 * (k + 1))
        want = (ct[:, cols].astype(np.float64) * scale[k]) @ mask[k].T
        np.testing.assert_allclose(got[:, cols], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_strip_matmul_backward_is_adjoint(storage):
    """⟨strip_matmul(x), y⟩ = ⟨x, strip_matmul_t(y)⟩ on the same operator."""
    g = torch.Generator().manual_seed(6)
    t = 4
    m = torch.rand(t, 128, 128, generator=g) < 0.05
    scale = torch.rand(t, 128, generator=g) if storage == "int8" else None
    m = m.to(torch.int8) if storage == "int8" else m * torch.rand(t, 128, 128, generator=g)
    x, y = torch.randn(16, t * 128, generator=g, dtype=torch.float64), torch.randn(16, t * 128, generator=g,
                                                                                   dtype=torch.float64)
    lhs = torch.sum(tstrip._strip_matmul_plain(x, m, None if scale is None else scale.double()) * y)
    rhs = torch.sum(x * tstrip._strip_matmul_t_plain(y, m, None if scale is None else scale.double()))
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_strip_matmul_t_rejects_bad_operands():
    x = torch.zeros(16, 256)
    with pytest.raises(ValueError):  # operator covers 384 columns
        tstrip.strip_matmul_t(x, torch.zeros(3, 128, 128, dtype=torch.int8), torch.zeros(3, 128))
    with pytest.raises(ValueError):  # int8 storage without its scale
        tstrip.strip_matmul_t(x, torch.zeros(2, 128, 128, dtype=torch.int8))
    with pytest.raises(ValueError):  # float storage takes no scale
        tstrip.strip_matmul_t(x, torch.zeros(2, 128, 128), torch.zeros(2, 128))
