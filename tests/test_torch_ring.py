"""Kernel row 9, the ring all-gather (``gnnkeras_tpu_torch/ops/ring.py``): its
plain version over gloo ranks on the CPU, against ``np.concatenate`` in rank
order and against the JAX package's ``ring_all_gather`` (its Pallas kernel
in interpret mode) on a ``("data", "graph")`` mesh of 2×4, bit for bit: the
gather only moves data.

One set of 8 ranks runs every case (``ring_results``).  This module imports
JAX only inside its fixtures, so the ranks, which import it to find
``_rank_cases``, import no JAX.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

WORLD = 8
ROWS, D = 8, 5


def _block(seed: int, rows: int, d: int, dtype) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32).astype(dtype)


def _grid_x() -> np.ndarray:
    """The 2×4 mesh's input of ``tests/test_parallel.py``'s multi-axis ring
    test: row i of the data axis gathers ``x[i]``."""
    return np.arange(2 * 4 * ROWS * D, dtype=np.float32).reshape(2, 4 * ROWS, D)


def _rank_cases(rank: int, world: int) -> dict:
    """Every ring case on this rank: a 1-D ring over all 8 ranks, rings of
    4 and of 2 on sub-groups of ("data", "graph") meshes of 2×4 and 4×2, a
    single bf16 row, and two calls in a row on one group."""
    from gnnkeras_tpu_torch.ops.ring import ring_all_gather
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh

    out = {}
    flat = make_mesh(("graph",))
    out["world"] = ring_all_gather(torch.from_numpy(_block(rank, ROWS, D, np.float32)), flat.group("graph")).numpy()
    out["world_again"] = ring_all_gather(torch.from_numpy(_block(100 + rank, 3, 2, np.float32)),
                                         flat.group("graph")).numpy()
    m24 = make_mesh(("data", "graph"), shape=(2, 4))
    i, j = m24.index("data"), m24.index("graph")
    x = torch.from_numpy(_grid_x()[i, j * ROWS:(j + 1) * ROWS])
    out["grid_2x4"] = (i, ring_all_gather(x, m24.group("graph")).numpy())
    m42 = make_mesh(("data", "graph"), shape=(4, 2))
    x = torch.from_numpy(_block(200 + rank, 1, 1, np.float32)).to(torch.bfloat16)
    got = ring_all_gather(x, m42.group("graph"))
    out["pairs_bf16_row"] = (m42.index("data"), got.float().numpy(), str(got.dtype))
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn(_rank_cases, WORLD)


def test_ring_over_the_world_matches_concatenate(ring_results):
    want = np.concatenate([_block(r, ROWS, D, np.float32) for r in range(WORLD)])
    again = np.concatenate([_block(100 + r, 3, 2, np.float32) for r in range(WORLD)])
    for res in ring_results:
        np.testing.assert_array_equal(res["world"], want)
        np.testing.assert_array_equal(res["world_again"], again)


def test_ring_pairs_single_bf16_row(ring_results):
    for rank, res in enumerate(ring_results):
        row, got, dtype = res["pairs_bf16_row"]
        assert dtype == "torch.bfloat16" and got.shape == (2, 1)
        want = np.concatenate([_block(200 + q, 1, 1, np.float32) for q in (2 * row, 2 * row + 1)])
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_ring_on_sub_groups_matches_jax_ring(ring_results):
    """Each data row of a 2×4 mesh runs its own ring of 4, as the JAX
    package's kernel does on its ("data", "graph") mesh of 2×4."""
    from functools import partial

    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gnnkeras_tpu.ops.ring import ring_all_gather
    from gnnkeras_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(("data", "graph"), shape=(2, 4))
    mesh_axes = tuple((n, mesh.shape[n]) for n in mesh.axis_names)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P("data", "graph", None), out_specs=P("data", None, None),
             check_vma=False)
    def via_ring(xs):
        return ring_all_gather(xs[0], "graph", 4, mesh_axes=mesh_axes)[None]

    want = np.asarray(via_ring(_grid_x()))
    np.testing.assert_array_equal(want, _grid_x())
    for res in ring_results:
        row, got = res["grid_2x4"]
        np.testing.assert_array_equal(got, want[row])
