"""The ordered segment sum (``gnnkeras_tpu_torch.ops.segment.segment_sum_ordered``).

It adds each segment's rows one after another in their order, which is
what ``index_add_`` does on the CPU: on the CPU the two agree bit for bit,
in value and gradient, and both agree with JAX's ``segment_sum`` to f32
rounding (rtol 1e-6, atol 1e-6).  The neighbour sums of labels that an
LGNN layer past the first takes on the device go through it: the composite
models' per-type node-label sums and the arc-label sums.

The card tests carry the ``cuda`` marker and skip without a card; on a
machine with one (and no JAX) run them with ``python -m pytest
tests/test_torch_segment.py --noconftest``: the card's sums equal the CPU's
bit for bit, are the same from run to run, and capture in a CUDA graph; a
composite model's per-type sums on the card equal the CPU's bit for bit.
"""

import numpy as np
import pytest
import torch

from gnnkeras_tpu_torch.ops.segment import segment_sum, segment_sum_ordered

torch.set_num_threads(1)

# (rows, segments, trailing shape): node labels, empty, 3-D rows, one column
CASES = [(1000, 300, (7,)), (0, 5, (3,)), (50, 9, (4, 128)), (4000, 64, (1,))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the card's segment sum has no CPU mode)")
    return torch.device("cuda")


def _inputs(rows, segments, shape, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segments, size=rows)
    data = rng.standard_normal((rows,) + shape).astype(np.float32)
    return torch.from_numpy(data), torch.from_numpy(ids)


@pytest.mark.parametrize("rows,segments,shape", CASES)
def test_ordered_sum_is_index_add_on_the_cpu(rows, segments, shape):
    data, ids = _inputs(rows, segments, shape)
    out = segment_sum_ordered(data, ids, segments)
    assert out.shape == (segments,) + shape
    assert torch.equal(out, segment_sum(data, ids, segments))


@pytest.mark.parametrize("rows,segments,shape", CASES[:1] + CASES[2:])
def test_ordered_sum_gradient(rows, segments, shape):
    data, ids = _inputs(rows, segments, shape)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal((segments,) + shape).astype(np.float32))
    grads = []
    for fn in (segment_sum, segment_sum_ordered):
        x = data.clone().requires_grad_(True)
        (fn(x, ids, segments) * cot).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("rows,segments,shape", CASES)
def test_ordered_sum_matches_jax(rows, segments, shape):
    jax = pytest.importorskip("jax")  # the card's machine has no JAX
    from gnnkeras_tpu.ops.segment import segment_sum as jax_segment_sum

    data, ids = _inputs(rows, segments, shape)
    ref = jax.jit(jax_segment_sum, static_argnums=2)(data.numpy(), ids.numpy(), segments)
    np.testing.assert_allclose(segment_sum_ordered(data, ids, segments).numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,segments,shape", CASES)
def test_ordered_sum_on_card_is_the_cpu_sum(cuda, rows, segments, shape):
    data, ids = _inputs(rows, segments, shape)
    want = segment_sum_ordered(data, ids, segments)
    x, i = data.to(cuda), ids.to(cuda)
    first = segment_sum_ordered(x, i, segments)
    assert torch.equal(first.cpu(), want)
    for _ in range(3):
        assert torch.equal(segment_sum_ordered(x, i, segments), first)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = segment_sum_ordered(x, i, segments)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_composite_per_type_sums_on_card(cuda):
    """The sums an LGNN layer past the first takes on the device (its
    labels changed, so the batch's host-built sums are dropped)."""
    from gnnkeras_tpu_torch import from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import bench_composite_graph, starter_cgnn

    batch = from_graph_object(bench_composite_graph(), device="cpu").replace(agg_component=None)
    model = starter_cgnn("cpu", seed=0)
    want = model._aggregated_component(batch)
    got = model._aggregated_component(batch.to(cuda))
    assert torch.equal(got.cpu(), want)
