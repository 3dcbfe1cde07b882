"""The port's ``GNNgraphBased.forward(training=False)`` against the JAX
package's, with the same weights (non-trivial BatchNorm statistics) on the
same batch.

The iteration count must be equal.  Both engines are f32 throughout (JAX's
Pallas strip kernel runs in interpret mode on the CPU); only summation order
differs, hence rtol 1e-5 / atol 1e-6 on the node state and graph outputs.
"""

import numpy as np
import pytest

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu_torch.graph.batch as tbatch
from torch_port_common import flagship_pair, merged_pair, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6

_BATCHES = {
    # the flagship layout: slot-packed, int8 mask+scale strips → strip engine
    "slot128_int8": dict(slot_pack=128, strip_dtype="int8"),
    # parallel arcs: the strip falls back to bf16 weights
    "slot128_bf16_fallback": dict(slot_pack=128, strip_dtype="int8"),
    # no packing: plain BCSR → transposed BCSR engine
    "plain_bcsr": dict(),
    # no dense blocks: edge-list segment sums → row-major engine
    "edge_list": dict(dense_blocks=False),
}


@pytest.mark.filterwarnings("ignore:int8 mask\\+scale strip storage")
@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("layout", list(_BATCHES))
def test_forward_matches_jax(layout, threshold):
    raw = raw_molecules(n_graphs=20, seed=21, big=(140,))
    if layout != "slot128_bf16_fallback":
        raw = unique_pairs(raw)
    jm, tm = merged_pair(raw)
    jb = jbatch.from_graph_object(jm, **_BATCHES[layout])
    tb = tbatch.from_graph_object(tm, device="cpu", **_BATCHES[layout])
    jmodel, tmodel = flagship_pair(seed=6, threshold=threshold)
    assert tmodel._use_transposed(tb) == jmodel._use_transposed(jb) == (layout != "edge_list")

    jk, jstate, jout, jmask, _ = jmodel.forward(jmodel.variables, jb, training=False)
    k, state, out, mask, _ = tmodel.forward(tb, training=False)

    assert k == int(jk)
    if threshold == 0.0:
        assert k == 5
    node_mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(state.numpy()[node_mask], np.asarray(jstate)[node_mask], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    m = np.asarray(jmask)
    np.testing.assert_allclose(out.numpy()[m], np.asarray(jout)[m], rtol=RTOL, atol=ATOL)


def test_strip_forward_aggregates_k_minus_one_times(monkeypatch):
    """Iteration 0 is peeled from the precomputed ``Adjᵀ·labels``: a
    forward of k iterations calls the strip aggregation k − 1 times."""
    import gnnkeras_tpu_torch.ops.strip as tstrip

    calls = []
    real = tstrip.strip_matmul
    monkeypatch.setattr(tstrip, "strip_matmul", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, tm = merged_pair(unique_pairs(raw_molecules(n_graphs=6, seed=2)))
    tb = tbatch.from_graph_object(tm, slot_pack=128, strip_dtype="int8", device="cpu")
    _, tmodel = flagship_pair(seed=1)
    k, *_ = tmodel.forward(tb)
    assert k == 5 and len(calls) == k - 1


def test_dim_state_and_training_not_ported():
    """dim_state > 0 now builds, and its forward needs a generator for the
    random initial state (its parity with JAX is in
    test_torch_dim_state.py); the training forward runs (its parity with JAX
    is in test_torch_training.py) and returns k as a device float and the
    new moving statistics keyed as in the state dict."""
    import torch

    import gnnkeras_tpu_torch.models.gnn as tgnn
    from torch_port_common import _nets, tmlp

    _, tm = merged_pair(raw_molecules(n_graphs=2, seed=2))
    batch = tbatch.from_graph_object(tm, device="cpu")
    wide = tgnn.GNNgraphBased(*_nets(tmlp, ds=5), 5, 5, 0.0).build(seed=1, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        wide.forward(batch)
    assert wide.forward(batch, generator=torch.Generator().manual_seed(0))[1].shape == (batch.num_nodes, 5)
    _, tmodel = flagship_pair(seed=1)
    k, _, out, _, stats = tmodel.forward(batch, training=True)
    assert isinstance(k, torch.Tensor) and float(k) == 5.0 and out.requires_grad
    assert set(stats) == {name for name, _ in tmodel.named_buffers()}
