"""The whole unfolds summed in the CUDA kernels' order
(``tests/torch_fused_order.py``, the reference of the card's bit-for-bit
tests in ``tests/test_torch_kernels.py``) on the CPU.

- Skipping a chain's zero entries leaves it bit for bit the dense chain:
  the premise of the kernels' nonzero walk.
- The reference agrees with the JAX package's ``fused_unfold_t`` /
  ``fused_unfold`` (Pallas in interpret mode on the CPU) and with the port's
  plain versions within the tolerances ``tests/test_torch_fused.py`` and
  ``tests/test_torch_fused_rowmajor.py`` state: the same arithmetic summed
  in another order.  Row 2 and row 4 with f32 blocks: rtol 1e-5 with atol
  1e-5 / 1e-6.  Row 4 with bf16 blocks: a sum of another order can round to
  the neighbouring bf16 value, and the flip travels through the rest of the
  unfolding to the rows the tile links, so at most 2% of the rows leave the
  f32 tolerance and every element stays within 2^-6 of the state's largest
  magnitude.

The blocks: a fully dense tile (weights about 1/128, as average
aggregation's), an all-zero tile (half its zeros -0), a sparse tile with
an empty row and column, and a sparse tile, each weight a bf16 value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.ops.fused as jfused
import gnnkeras_tpu_torch.ops.fused as tfused
import torch_fused_order as order

torch.set_num_threads(1)

T = 4
RTOL = 1e-5
BF16_ROWS = 0.02
BF16_REL = 2.0**-6

_jit_t = jax.jit(jfused.fused_unfold_t, static_argnames=("n_iter", "activation"))
_jit_rm = jax.jit(jfused.fused_unfold, static_argnames=("n_iter", "activation"))


def _inputs_t(d_pad, seed):
    return order.inputs_t(d_pad, T, seed, special=True)


def _inputs_rm(d, seed):
    """Weights ~N(0, 0.1²), as ``tests/test_torch_fused_rowmajor.py`` draws
    them: each iteration's map then shrinks differences, so its tolerance
    is not amplified 5 times over."""
    return order.inputs_rm(d, T, seed, special=True, w_std=0.1)


@pytest.mark.parametrize("d_pad", [8, 16])
def test_unfold_t_skipping_zeros_keeps_the_dense_chain(d_pad):
    s0, c, ws, wa, blocks = _inputs_t(d_pad, seed=d_pad)
    args = (s0, c, order.pad_t(ws, d_pad), order.pad_t(wa, d_pad), blocks, 5, "selu")
    assert order.same_bits(order.unfold_t(*args), order.unfold_t(*args, skip_zeros=False))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16])
def test_unfold_skipping_zeros_keeps_the_dense_chain(d, storage):
    s0, c, ws, wa, blocks = _inputs_rm(d, seed=d + 1)
    args = (s0, c, ws, wa, blocks, 5, "selu", storage == "bfloat16")
    assert order.same_bits(order.unfold(*args), order.unfold(*args, skip_zeros=False))


@pytest.mark.parametrize("d_pad", [8, 16])
def test_unfold_t_reference_matches_jax_and_plain(d_pad):
    s0, c, ws, wa, blocks = _inputs_t(d_pad, seed=d_pad + 2)
    got = order.unfold_t(s0, c, order.pad_t(ws, d_pad), order.pad_t(wa, d_pad), blocks, 5, "selu")
    jop = jfused.FusedDiagOperator(blocks=jnp.asarray(blocks).astype(jnp.bfloat16), tile=128)
    jax_out = np.asarray(_jit_t(*(jnp.asarray(x) for x in (s0, c, ws, wa)), jop, n_iter=5, activation="selu"))
    top = tfused.FusedDiagOperator(blocks=torch.from_numpy(blocks).to(torch.bfloat16), tile=128)
    plain = tfused.fused_unfold_t(*(torch.from_numpy(x) for x in (s0, c, ws, wa)), top, 5, "selu").numpy()
    np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16])
def test_unfold_reference_matches_jax_and_plain(d, storage):
    s0, c, ws, wa, blocks = _inputs_rm(d, seed=d + 3)
    got = order.unfold(s0, c, ws, wa, blocks, 5, "selu", storage == "bfloat16")
    jop = jfused.FusedDiagOperator(blocks=jnp.asarray(blocks).astype(getattr(jnp, storage)), tile=128)
    jax_out = np.asarray(_jit_rm(*(jnp.asarray(x) for x in (s0, c, ws, wa)), jop, n_iter=5, activation="selu"))
    top = tfused.FusedDiagOperator(blocks=torch.from_numpy(blocks).to(getattr(torch, storage)), tile=128)
    plain = tfused.fused_unfold(*(torch.from_numpy(x) for x in (s0, c, ws, wa)), top, 5, "selu").numpy()
    for other in (jax_out, plain):
        if storage == "float32":
            np.testing.assert_allclose(got, other, rtol=RTOL, atol=1e-6)
            continue
        diff = np.abs(got - other)
        beyond = (diff > 1e-6 + RTOL * np.abs(other)).any(axis=1)
        assert beyond.sum() <= BF16_ROWS * len(beyond), (int(beyond.sum()), len(beyond))
        assert diff.max() <= BF16_REL * np.abs(other).max(), diff.max()
