"""The incidence select's arc-major index (``arc_ends`` of
``gnnkeras_tpu_torch.ops.incidence.IncidencePairs``) and its plain copy
(``_incidence_select_rows``), the select kernel's plain version, against a
brute force over the endpoints, against the select from the pairs
(``_incidence_select_plain``) and against the JAX package's select (its
Pallas pair kernels in interpret mode on the CPU, jitted): on the pair
lists of the card tests (ragged: 1,000 arcs on 12 node tiles; padded: the
same pairs padded to 96; above the JAX package's 10,240-pair budget, where
its XLA-assisted pair kernel runs) and on molecule batches in arc focus in
both layouts, their pair lists padded to the serving cap.

Tolerances.  The index is host-built: exact equality.  The select is a
copy: bit for bit against ``state[arc_src]`` / ``state[arc_dst]`` and the
pairs' select, -0.0 and subnormals included, and against the JAX select on
a state without them (its one-hot products do not keep them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.ops.incidence as jinc
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.ops.incidence as tinc
from gnnkeras_tpu_torch import kernels
from torch_port_common import arc_targets, merged_pair, raw_molecules

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:int8 mask\\+scale strip storage")

# (arcs, node tiles, node tiles each endpoint spreads over, pairs padded to)
_LISTS = {
    "ragged": (1000, 12, (3, 3), None),
    "padded": (1000, 12, (3, 3), 12 * 8),
    "above_budget": (1000 * 128 - 37, 500, (6, 6), None),
}
_LAYOUTS = {"slot128": dict(slot_pack=128, strip_dtype="int8"), "plain": dict()}


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
    """Per case: the port's pairs, the JAX package's, and the endpoints: the
    three lists, and the molecule batches (pairs padded to the cap)."""
    out = {}
    for case, (n_arcs, n_node_tiles, spread, pad_to) in _LISTS.items():
        src, dst = _endpoints(n_arcs, n_node_tiles, spread, seed=len(out) + 10)
        n = n_node_tiles * 128
        inc, jnc = tinc.build_incidence_pairs(src, dst, n), jinc.build_incidence_pairs(src, dst, n)
        if pad_to is not None:
            inc, jnc = tinc.pad_incidence_pairs(inc, pad_to), jinc.pad_incidence_pairs(jnc, pad_to)
        out[case] = (inc, jnc, src, dst)
    for layout, kw in _LAYOUTS.items():
        raw = arc_targets(raw_molecules(n_graphs=12, seed=21), seed=21)
        jm, tm = merged_pair(raw, focus="a")
        jb = jbatch.pad_operators_to_cap(jbatch.from_graph_object(jm, **kw))
        tb = tbatch.pad_operators_to_cap(tbatch.from_graph_object(tm, device="cpu", **kw))
        out[f"molecules_{layout}"] = (tb.arc_inc, jb.arc_inc, tb.arc_src.numpy(), tb.arc_dst.numpy())
    return out


_CASES = list(_LISTS) + [f"molecules_{layout}" for layout in _LAYOUTS]
_jax_select = jax.jit(jinc.incidence_select)
_bits = lambda x: np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("case", _CASES)
def test_arc_index_matches_brute_force(built, case):
    inc, _, src, dst = built[case]
    if case == "above_budget":
        assert inc.n_live > 10_240
    if case == "padded":
        assert inc.n_pairs > inc.n_live
    ends = inc.arc_ends.numpy()
    assert ends.dtype == np.int32 and ends.shape == (len(src), 2)
    want = [[int(s), int(t)] for s, t in zip(src, dst)]
    assert ends.tolist() == want
    # the pairs stay on the host; the kernels' indices go to a device
    assert inc.device == inc.arc_ends.device
    assert all(getattr(inc, name).device.type == "cpu" for name in tinc._PAIR_FIELDS)


@pytest.mark.parametrize("d", [3, 14, 24])
@pytest.mark.parametrize("case", _CASES)
def test_arc_major_select_is_the_pairs_select_and_jax(built, case, d):
    inc, jnc, src, dst = built[case]
    rng = np.random.default_rng(d)
    n = inc.n_node_tiles * 128
    state = rng.normal(size=(n, d)).astype(np.float32)
    # -0.0 and subnormals come back bit for bit
    marked = state.copy()
    marked[src[0], 0], marked[dst[1], -1] = -0.0, np.float32(1e-40)
    before = dict(kernels.LAUNCHES)
    y_src, y_dst = tinc._incidence_select_rows(torch.from_numpy(marked), inc.arc_ends, inc.n_arc_tiles)
    a, a_pad = len(src), inc.n_arc_tiles * 128
    assert y_src.shape == y_dst.shape == (a_pad, d)
    np.testing.assert_array_equal(_bits(y_src.numpy()[:a]), _bits(marked[src]))
    np.testing.assert_array_equal(_bits(y_dst.numpy()[:a]), _bits(marked[dst]))
    assert not y_src.numpy()[a:].any() and not y_dst.numpy()[a:].any()
    # the pairs' select, and the CPU wrapper (which takes the arc-major copy)
    pairs = tinc._incidence_select_plain(torch.from_numpy(marked), inc)
    wrapped = tinc.incidence_select(torch.from_numpy(marked), inc)
    for got, p, w in zip((y_src, y_dst), pairs, wrapped):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(p.numpy()))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(w.numpy()))
    assert kernels.LAUNCHES == before
    # the JAX select on every row, padding rows included
    y_src, y_dst = tinc._incidence_select_rows(torch.from_numpy(state), inc.arc_ends, inc.n_arc_tiles)
    j_src, j_dst = _jax_select(jnp.asarray(state), jnc)
    np.testing.assert_array_equal(_bits(y_src.numpy()), _bits(j_src))
    np.testing.assert_array_equal(_bits(y_dst.numpy()), _bits(j_dst))


def test_padding_pairs_leave_the_index_alone(built):
    inc, _, _, _ = built["ragged"]
    padded = tinc.pad_incidence_pairs(inc, 12 * inc.n_arc_tiles)
    assert padded.n_pairs > inc.n_pairs
    assert padded.arc_ends is inc.arc_ends
    assert padded.node_start is inc.node_start and padded.node_entry is inc.node_entry
