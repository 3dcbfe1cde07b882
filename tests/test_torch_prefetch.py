"""The CUDA-stream prefetcher (``gnnkeras_tpu_torch.data.prefetch``) and
sequencers built on the card.

On the CPU (here) the prefetcher hands the inner batches out as they are,
``GraphBatch.to`` takes ``non_blocking``, and a sequencer asked to build
pinned batches on the card refuses.  The card tests carry the
``cuda`` marker and skip without a card; on a machine with one (and no
JAX) run them with ``python -m pytest tests/test_torch_prefetch.py
--noconftest``: the prefetched batches equal the batches a sequencer builds
on the card directly (over an epoch's rebuild; also from an inner
sequencer that builds them pinned), each carries the event its
copies recorded on the side stream, and a sequencer built on the card never
yields a CPU tensor.
"""

import warnings

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from gnnkeras_tpu_torch.data import (PrefetchSequencer, MultiGraphSequencer, SingleGraphSequencer,
                                     TransductiveSingleGraphSequencer)
from gnnkeras_tpu_torch.data.synthetic import large_banded_graph, random_molecules
from gnnkeras_tpu_torch.utils.pytree import static_signature

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA streams and events have no CPU mode)")
    return torch.device("cuda")


def _sequencer(device, seed=0, **kw):
    np.random.seed(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strips
        return MultiGraphSequencer(random_molecules(24, seed=3, max_nodes=60), "g", "average", batch_size=8,
                                   slot_pack=128, device=device, **kw)


def _assert_same_batch(a, b):
    """Two batches equal field for field, whatever their devices."""
    la, spec_a = pytree.tree_flatten(a)
    lb, spec_b = pytree.tree_flatten(b)
    assert static_signature(spec_a) == static_signature(spec_b)
    np.testing.assert_array_equal(a.host_pred_rows, b.host_pred_rows)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_prefetch_on_the_cpu_is_a_pass_through():
    seq = _sequencer("cpu")
    p = PrefetchSequencer(seq, lookahead=2, device="cpu")
    assert len(p) == len(seq) == 3 and p.focus == "g" and p.data is seq.data
    assert all(p[i] is seq[i] for i in range(len(p)))
    p._cache[0] = "stale"
    p.set_batch_size(12)  # a mutator drops what was copied ahead
    assert p._cache == {} and len(p) == 2
    assert isinstance(p.copy(), PrefetchSequencer) and p.copy().inner is not seq
    other = p.with_graphs(random_molecules(4, seed=9))
    assert isinstance(other, PrefetchSequencer) and len(other) == 1
    np.random.seed(1)
    p.on_epoch_end()
    seq.wait_for_rebuild()
    with pytest.raises(ValueError, match="lookahead"):
        PrefetchSequencer(seq, lookahead=0, device="cpu")


def test_batch_moves_non_blocking_on_the_cpu():
    b = _sequencer("cpu")[0]
    _assert_same_batch(b.to("cpu", non_blocking=True), b)


def test_pinned_batches_are_built_on_the_cpu():
    with pytest.raises(ValueError, match="pin_memory"):
        _sequencer("cuda", pin_memory=True)
    with pytest.raises(ValueError, match="pin_memory"):
        SingleGraphSequencer(large_banded_graph(1024, band=8), "n", batch_size=500, device="cuda", pin_memory=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pin_memory", [False, True])
def test_prefetch_gives_the_batches_built_on_the_card(cuda, pin_memory):
    """Also over an inner sequencer that builds its batches pinned (every
    tensor pinned, after a rebuild too): the copies then pin nothing."""
    direct, inner = _sequencer("cuda"), _sequencer("cpu", pin_memory=pin_memory)
    p = PrefetchSequencer(inner, lookahead=2)
    for epoch in range(2):
        if pin_memory:
            assert all(t.is_pinned() for i in range(len(inner)) for t in pytree.tree_leaves(inner[i]))
        for i in range(len(p)):
            got = p[i]
            assert all(t.device.type == "cuda" for t in pytree.tree_leaves(got))
            _assert_same_batch(got, direct[i])
        for s in (direct, p):
            np.random.seed(10 + epoch)
            s.on_epoch_end()
    direct.wait_for_rebuild()
    inner.wait_for_rebuild()


@pytest.mark.cuda
def test_prefetched_batches_carry_the_side_streams_event(cuda):
    p = PrefetchSequencer(_sequencer("cpu", shuffle=False), lookahead=2)
    assert p._stream != torch.cuda.current_stream()
    b0 = p[0]
    assert sorted(p._cache) == [1, 2]  # copied ahead on the side stream
    ahead = {j: event for j, (_, event) in p._cache.items()}
    assert all(isinstance(e, torch.cuda.Event) for e in ahead.values())
    b1 = p[1]
    torch.cuda.current_stream().synchronize()  # the current stream waited on batch 1's event
    assert ahead[1].query() and 1 not in p._cache
    _assert_same_batch(b1, p.inner[1].to("cuda"))
    assert b0.nodes.device.type == "cuda"


@pytest.mark.cuda
def test_card_sequencers_never_yield_a_cpu_tensor(cuda):
    """Every tensor of every batch lies on the card (the incidence pairs'
    host-only lists are static fields, not tensors of the batch tree), also
    after a background rebuild."""
    seqs = [_sequencer("cuda"), SingleGraphSequencer(large_banded_graph(4096, band=8), "n", batch_size=1000,
                                                     agg_dtype="auto", device="cuda"),
            TransductiveSingleGraphSequencer(large_banded_graph(2048, band=8), "n", 0.5, batch_size=600,
                                             device="cuda")]
    for seq in seqs:
        for epoch in range(2):
            for i in range(len(seq)):
                assert all(t.device.type == "cuda" for t in pytree.tree_leaves(seq[i])), (type(seq).__name__, i)
            np.random.seed(epoch)
            seq.on_epoch_end()
        seq.wait_for_rebuild()
