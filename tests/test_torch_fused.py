"""The port's whole-unfold (plain version of the fused kernel) against JAX
``fused_unfold_t`` with the same bf16 blocks.

Both upcast the same bf16 weights and compute in f32 (JAX's Pallas kernel
runs in interpret mode on the CPU); only the summation order differs, and
it compounds over ``n_iter`` chained iterations, hence rtol 1e-5 /
atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.ops.fused as jfused
import gnnkeras_tpu_torch.ops.fused as tfused
from torch_port_common import merged_pair, raw_molecules

RTOL, ATOL = 1e-5, 1e-5

_JM, _ = merged_pair(raw_molecules(n_graphs=14, seed=9))
_JB = jbatch.from_graph_object(_JM, tile_pack=True)
_A = _JM.arcs.shape[0]
_OP_ARGS = (np.asarray(_JB.arc_src)[:_A], np.asarray(_JB.arc_dst)[:_A],
            np.asarray(_JB.arcnode_weight)[:_A], _JB.num_nodes)


@pytest.mark.parametrize("n_iter", [1, 5])
@pytest.mark.parametrize("activation", ["selu", "relu", "tanh", "sigmoid", "linear"])
def test_fused_unfold_t_matches_jax(activation, n_iter):
    rng = np.random.default_rng(n_iter)
    n, d, d_pad = _JB.num_nodes, 14, 16
    state0 = np.zeros((d_pad, n), np.float32)
    state0[:d] = rng.normal(size=(d, n))
    const = np.zeros((d_pad, n), np.float32)
    const[:d] = rng.normal(0.0, 0.3, size=(d, n))
    # small weights keep 5 chained iterations of linear/relu bounded
    w_state = rng.normal(0.0, 0.25, size=(d, d)).astype(np.float32)
    w_agg = rng.normal(0.0, 0.25, size=(d, d)).astype(np.float32)

    jop = jfused.build_fused_diag_t(*_OP_ARGS)
    want = np.asarray(jfused.fused_unfold_t(
        jnp.asarray(state0), jnp.asarray(const), jnp.asarray(w_state), jnp.asarray(w_agg), jop, n_iter, activation,
    ))
    top = tfused.build_fused_diag_t(*_OP_ARGS)
    got = tfused.fused_unfold_t(
        torch.from_numpy(state0), torch.from_numpy(const), torch.from_numpy(w_state), torch.from_numpy(w_agg),
        top, n_iter, activation,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_unfold_t_rejects_bad_operands():
    top = tfused.build_fused_diag_t(*_OP_ARGS)
    n = _JB.num_nodes
    w = torch.zeros(14, 14)
    with pytest.raises(ValueError):  # unknown activation
        tfused.fused_unfold_t(torch.zeros(16, n), torch.zeros(16, n), w, w, top, 1, "gelu")
    with pytest.raises(ValueError):  # state not covered by the operator
        tfused.fused_unfold_t(torch.zeros(16, n + 128), torch.zeros(16, n + 128), w, w, top, 1)
    with pytest.raises(ValueError):  # d_pad not a multiple of 8
        tfused.fused_unfold_t(torch.zeros(15, n), torch.zeros(15, n), w, w, top, 1)
    narrow = tfused.FusedDiagOperator(blocks=top.blocks[:, :64], tile=128)
    with pytest.raises(ValueError):  # blocks that are not 128 x 128
        tfused.fused_unfold_t(torch.zeros(16, n), torch.zeros(16, n), w, w, narrow, 1)
