"""The port's strip aggregation (plain version of the strip kernel) against
JAX ``strip_aggregate_t`` on the same operator.

Both compute in f32 (JAX runs its Pallas kernel in interpret mode on the
CPU); only the summation order differs, hence rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.ops.strip as jstrip
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.ops.strip as tstrip
from torch_port_common import merged_pair, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("storage", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_strip_aggregate_t_matches_jax(storage, with_residual):
    raw = unique_pairs(raw_molecules(n_graphs=24, seed=5, big=(170,) if with_residual else ()))
    jm, tm = merged_pair(raw)
    jb = jbatch.from_graph_object(jm, slot_pack=128, strip_dtype=storage)
    tb = tbatch.from_graph_object(tm, slot_pack=128, strip_dtype=storage, device="cpu")
    assert (tb.strip.residual is not None) == with_residual
    assert (tb.strip.scale is not None) == (storage == "int8")
    state_t = np.random.default_rng(1).normal(size=(16, tb.num_nodes)).astype(np.float32)
    want = np.asarray(jstrip.strip_aggregate_t(jnp.asarray(state_t), jb.strip))
    got = tstrip.strip_aggregate_t(torch.from_numpy(state_t), tb.strip).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_strip_matmul_plain_is_per_tile_product():
    """The plain version is the kernel's decomposition: per tile
    (x_t @ M_t) * scale_t, on a hand-built operator."""
    rng = np.random.default_rng(2)
    t, d = 3, 8
    mask = (rng.random((t, 128, 128)) < 0.05).astype(np.int8)
    scale = rng.random((t, 128)).astype(np.float32)
    x = rng.normal(size=(d, t * 128)).astype(np.float32)
    got = tstrip.strip_matmul(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(scale)).numpy()
    for k in range(t):
        cols = slice(128 * k, 128 * (k + 1))
        want = (x[:, cols].astype(np.float64) @ mask[k]) * scale[k]
        np.testing.assert_allclose(got[:, cols], want, rtol=RTOL, atol=ATOL)


def test_strip_matmul_rejects_bad_operands():
    x = torch.zeros(16, 256)
    with pytest.raises(ValueError):
        tstrip.strip_matmul(x, torch.zeros(3, 128, 128, dtype=torch.int8), torch.zeros(3, 128))
    with pytest.raises(ValueError):  # int8 storage without its scale
        tstrip.strip_matmul(x, torch.zeros(2, 128, 128, dtype=torch.int8))
    with pytest.raises(ValueError):  # a scale that does not cover every tile
        tstrip.strip_matmul(x, torch.zeros(2, 128, 128, dtype=torch.int8), torch.zeros(1, 128))
    with pytest.raises(ValueError):  # a slot other than 32, 64 or 128
        tstrip.build_strip_operator(np.array([0]), np.array([1]), np.ones(1), 128, slot=48)
    with pytest.raises(ValueError):  # a compact strip whose slot does not match its shape
        tstrip.strip_matmul(x, torch.zeros(2, 32, 128), slot=64)
