"""The incidence scatter's node-major index (``node_start`` / ``node_entry``
of ``gnnkeras_tpu_torch.ops.incidence.IncidencePairs``) and its plain walk,
the scatter kernel's plain version, on the pair lists of the card tests
(``tests/test_torch_kernels.py``): ragged (1,000 arcs on 12 node tiles),
padded (the same pairs padded to 96) and above the JAX package's
10,240-pair budget, where its XLA-assisted pair kernel runs: 1,000 arc
tiles on 500 node tiles, about 4 entries a node, as in the bench arc
batch (263,944 arcs on 131,584 node rows).  The card tests put that list
on 40 node tiles, 50 entries a node: there f32 sums in two orders differ
by more than the tolerance below, which holds for a node's few terms.

Tolerances.  The index is host-built: exact equality with a brute force
over the endpoints.  The walk sums a node's few incident cotangents in f32
in the index's order; the JAX package (its Pallas pair kernels in
interpret mode on the CPU) and the port's pair-based
``_incidence_scatter_plain`` sum them in other orders: rtol 1e-6, atol
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.ops.incidence as jinc
import gnnkeras_tpu_torch.ops.incidence as tinc
from gnnkeras_tpu_torch import kernels

torch.set_num_threads(1)

# (arcs, node tiles, node tiles each endpoint spreads over, pairs padded to)
_CASES = {
    "ragged": (1000, 12, (3, 3), None),
    "padded": (1000, 12, (3, 3), 12 * 8),
    "above_budget": (1000 * 128 - 37, 500, (6, 6), None),
}


def _endpoints(n_arcs, n_node_tiles, spread, seed):
    """As ``_incidence_inputs`` of the card tests: each arc's source in one of
    ``spread[0]`` node tiles after its arc tile's own, its destination in one
    of the ``spread[1]`` after those."""
    rng = np.random.default_rng(seed)
    at = np.arange(n_arcs) // 128
    src = ((at + rng.integers(0, spread[0], n_arcs)) % n_node_tiles) * 128 + rng.integers(0, 128, n_arcs)
    dst = ((at + spread[0] + rng.integers(0, spread[1], n_arcs)) % n_node_tiles) * 128 + rng.integers(0, 128, n_arcs)
    return src, dst


@pytest.fixture(scope="module")
def built():
    """Per case: the port's pairs, the JAX package's, and the endpoints."""
    out = {}
    for case, (n_arcs, n_node_tiles, spread, pad_to) in _CASES.items():
        src, dst = _endpoints(n_arcs, n_node_tiles, spread, seed=len(out))
        n = n_node_tiles * 128
        inc, jnc = tinc.build_incidence_pairs(src, dst, n), jinc.build_incidence_pairs(src, dst, n)
        if pad_to is not None:
            inc, jnc = tinc.pad_incidence_pairs(inc, pad_to), jinc.pad_incidence_pairs(jnc, pad_to)
        out[case] = (inc, jnc, src, dst)
    return out


_jax_scatter = jax.jit(jinc.incidence_scatter)


@pytest.mark.parametrize("case", list(_CASES))
def test_node_index_matches_brute_force(built, case):
    inc, _, src, dst = built[case]
    if case == "above_budget":
        assert inc.n_live > 10_240
    if case == "padded":
        assert inc.n_pairs > inc.n_live
    n = inc.n_node_tiles * 128
    want = [[] for _ in range(n)]
    for a, (s, t) in enumerate(zip(src.tolist(), dst.tolist())):
        want[s].append(2 * a)
        want[t].append(2 * a + 1)
    start, entry = inc.node_start.numpy(), inc.node_entry.numpy()
    assert start.dtype == entry.dtype == np.int32
    assert start.shape == (n + 1,) and entry.shape == (2 * len(src),) and start[0] == 0
    for node in range(n):
        assert entry[start[node]:start[node + 1]].tolist() == want[node], node


@pytest.mark.parametrize("d", [3, 14])
@pytest.mark.parametrize("case", list(_CASES))
def test_walk_matches_jax_and_pair_scatter(built, case, d):
    inc, jnc, src, _ = built[case]
    rng = np.random.default_rng(d)
    ct_src = rng.normal(size=(len(src), d)).astype(np.float32)
    ct_dst = rng.normal(size=(len(src), d)).astype(np.float32)
    t_src, t_dst = torch.from_numpy(ct_src), torch.from_numpy(ct_dst)
    before = dict(kernels.LAUNCHES)
    got = tinc._incidence_scatter_walk(t_src, t_dst, inc)
    assert got.shape == (inc.n_node_tiles * 128, d)
    # the CPU wrapper takes the walk, and launches nothing
    assert torch.equal(tinc.incidence_scatter(t_src, t_dst, inc), got)
    assert kernels.LAUNCHES == before
    want = np.asarray(_jax_scatter(jnp.asarray(ct_src), jnp.asarray(ct_dst), jnc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, tinc._incidence_scatter_plain(t_src, t_dst, inc), rtol=1e-6, atol=1e-6)


def test_walk_drops_rows_past_the_cotangents(built):
    """Cotangents of fewer rows than the pairs were built from: the index's
    entries of the missing rows add nothing, as in the pair scatter."""
    inc, _, src, _ = built["ragged"]
    rows = len(src) - 200
    ct = torch.from_numpy(np.random.default_rng(0).normal(size=(rows, 14)).astype(np.float32))
    got = tinc._incidence_scatter_walk(ct, -2 * ct, inc)
    torch.testing.assert_close(got, tinc._incidence_scatter_plain(ct, -2 * ct, inc), rtol=1e-6, atol=1e-6)
