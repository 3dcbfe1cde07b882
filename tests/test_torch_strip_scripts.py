"""Kernel rows 10-12, the JAX package's experiment scripts, against their port
(``gnnkeras_tpu_torch/tools/bench_strip_compact.py`` and ``bench_strip64.py``).

The scripts' Pallas kernels run in interpret mode on the CPU; the port's
functions take the strip kernel's plain version there (a CPU tensor).  Inputs
are a few synthetic tiles made with NumPy from a seed: sparse random strips
and normal state, f32 and bf16 strips.  A bf16 strip multiplies the state
rounded to bf16 in both packages, so the products are exact in f32 and only
the order of the f32 sums differs: rtol 1e-5, atol 1e-6 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.bench_pallas_compact as jcompact
import scripts.bench_strip64 as j64
import scripts.bench_strip_blocked as jblocked
from gnnkeras_tpu_torch.tools import bench_strip64 as t64
from gnnkeras_tpu_torch.tools import bench_strip_compact as tcompact

torch.set_num_threads(1)

TILES = 16
RTOL, ATOL = 1e-5, 1e-6


def _strip(slot, seed, storage):
    """Sparse random (TILES, slot, 128) weights as (JAX array, torch tensor)
    in ``storage``, the same values in both (bf16 rounded once, by torch)."""
    rng = np.random.default_rng(seed)
    w = rng.random((TILES, slot, 128)) * (rng.random((TILES, slot, 128)) < 0.1)
    ts = torch.from_numpy(w.astype(np.float32)).to(getattr(torch, storage))
    return jnp.asarray(ts.float().numpy()).astype(getattr(jnp, storage)), ts


@pytest.fixture(scope="module")
def compact_refs():
    """The scripts' kernels on the same inputs: strip_aggregate and
    blocked_aggregate at K 2 and 8, f32 and bf16 strips (jitted)."""
    rng = np.random.default_rng(0)
    state_t = rng.standard_normal((16, TILES * 128)).astype(np.float32)
    state_t[14:] = 0.0
    out = {}
    for name in ("float32", "bfloat16"):
        js, ts = _strip(32, 1, name)
        x = jnp.asarray(state_t)
        out[name] = {
            "inputs": (torch.from_numpy(state_t), ts),
            "strip": np.asarray(jax.jit(jcompact.strip_aggregate)(x, js)),
            **{f"blocked_{k}": np.asarray(jax.jit(jblocked.blocked_aggregate, static_argnums=2)(x, js, k))
               for k in (2, 8)},
        }
    return out


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_strip_aggregate_matches_script(compact_refs, storage):
    x, strip = compact_refs[storage]["inputs"]
    got = tcompact.strip_aggregate(x, strip).numpy()
    np.testing.assert_allclose(got, compact_refs[storage]["strip"], rtol=RTOL, atol=ATOL)
    if storage == "bfloat16":  # the rounding of the state is what the scripts compute
        unrounded = tcompact.strip_matmul(x, strip, slot=32).numpy()
        assert np.abs(unrounded - got).max() > 1e-4


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_tiles", [2, 8])
def test_blocked_aggregate_matches_script(compact_refs, storage, k_tiles):
    x, strip = compact_refs[storage]["inputs"]
    got = tcompact.blocked_aggregate(x, strip, k_tiles).numpy()
    np.testing.assert_allclose(got, compact_refs[storage][f"blocked_{k_tiles}"], rtol=RTOL, atol=ATOL)


def test_blocked_aggregate_keeps_the_shape_rule():
    x = torch.zeros(16, 6 * 128)
    with pytest.raises(ValueError, match="% 4"):
        tcompact.blocked_aggregate(x, torch.zeros(6, 32, 128), 4)


@pytest.fixture(scope="module")
def strip64_refs():
    """The script's row-major slot-64 kernels on the same inputs:
    strip64_aggregate (d 14, K 8) and packed_aggregate (d_pad 16, K 8)."""
    rng = np.random.default_rng(2)
    state = rng.standard_normal((TILES * 128, 14)).astype(np.float32)
    packed = np.zeros((TILES * 128, 16), np.float32)
    packed[:, :14] = state
    packed = packed.reshape(-1, 128)
    out = {}
    for name in ("float32", "bfloat16"):
        js, ts = _strip(64, 3, name)
        out[name] = {
            "inputs": (torch.from_numpy(state), torch.from_numpy(packed), ts),
            "strip64": np.asarray(jax.jit(j64.strip64_aggregate, static_argnums=2)(jnp.asarray(state), js, 8)),
            "packed": np.asarray(jax.jit(j64.packed_aggregate, static_argnums=(2, 3))(jnp.asarray(packed), js, 8, 16)),
        }
    return out


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_strip64_aggregate_matches_script(strip64_refs, storage):
    state, _, strip = strip64_refs[storage]["inputs"]
    got = t64.strip64_aggregate(state, strip, 8).numpy()
    np.testing.assert_allclose(got, strip64_refs[storage]["strip64"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_packed_aggregate_matches_script(strip64_refs, storage):
    _, packed, strip = strip64_refs[storage]["inputs"]
    got = t64.packed_aggregate(packed, strip, 8, 16).numpy()
    np.testing.assert_allclose(got, strip64_refs[storage]["packed"], rtol=RTOL, atol=ATOL)


def test_pack_slot64_matches_script():
    sizes = np.random.default_rng(4).integers(3, 200, 300)
    starts, n_pad = t64.pack_slot64(sizes)
    want_starts, want_n = j64.pack_slot64(sizes)
    assert n_pad == want_n
    np.testing.assert_array_equal(starts, want_starts)


def test_strip64_plus_residual_matches_dense():
    """The script's "strip64 + residual" check on the tool's slot-64 packing
    of molecules of 5-150 nodes: the strip covers within-slot edges, the
    BCSR residual the rest (f32 sums in another order)."""
    from gnnkeras_tpu_torch.data.synthetic import random_molecules
    from gnnkeras_tpu_torch.graph.graph import GraphObject
    from gnnkeras_tpu_torch.ops.bcsr import bcsr_aggregate

    merged = GraphObject.merge(random_molecules(12, seed=5, min_nodes=5, max_nodes=150), "g", "average")
    strip, residual, n, src, dst, w, in_slot = t64.build(merged=merged)
    assert 0 < in_slot.sum() < len(src) and residual is not None
    state = np.random.default_rng(6).standard_normal((n, 14)).astype(np.float32)
    x = torch.from_numpy(state)
    got = t64.strip64_aggregate(x, torch.from_numpy(strip), 1) + bcsr_aggregate(x, residual)
    np.testing.assert_allclose(got.numpy(), t64.dense_reference(state, src, dst, w), rtol=RTOL, atol=ATOL)
