"""Slot-32/64 compact strips and the mixed format (kernel rows 1 and 3 on
the card, their plain versions here) against the JAX package.

- ``order_tiles_by_format`` and the node positions of
  ``from_graph_object(slot_pack=32|64)`` equal JAX's;
- ``build_strip_operator(slot=32|64, n_strip_tiles=…)``: strips, full
  blocks, scales and residual bit for bit (the JAX block region is padded
  to 16 tiles with zero tiles; the port's is not), also slot-pure without
  ``n_strip_tiles``; ``strip_to_dense``;
- ``strip_aggregate_t`` forward and gradient with both regions present, with
  no strip tile (Ts = 0) and with no block tile;
- the flagship model's forward and one Adam step on ``graphs_to_batch(
  slot_pack=32|64)`` batches of molecules whose sizes straddle the slot, in
  graph and node focus.

Tolerances.  Aggregation: the same f32 products summed in another order
(JAX runs its Pallas kernels in interpret mode), rtol 1e-5 / atol 1e-6.
Model: as ``tests/test_torch_training.py``: outputs, loss and moving
statistics rtol 1e-5 / atol 1e-6; parameters after Adam's first step rtol
1e-5 / atol 1e-6 where |g| is at least 1e-6 of its leaf's largest (the
test counts the excluded entries: none here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.graph.graph as jgraph
import gnnkeras_tpu.graph.packing as jpacking
import gnnkeras_tpu.ops.strip as jstrip
import gnnkeras_tpu.training.trainer as jtr
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.graph.graph as tgraph
import gnnkeras_tpu_torch.graph.packing as tpacking
import gnnkeras_tpu_torch.ops.strip as tstrip
import gnnkeras_tpu_torch.training.trainer as ttr
from gnnkeras_tpu_torch.convert import variables_from_jax
from torch_port_common import (flagship_pair, graphs, merged_pair, node_targets, np_of, np_of_jax, raw_molecules,
                               unique_pairs)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6

# molecules of 5-39 nodes plus some above 32 and 64 (and one above a tile)
_BIG = {"straddling": (170, 50, 70, 100, 45), "all_large": (70, 90, 100, 130, 75)}


def _raw(case, seed=5, n_graphs=16):
    if case == "all_large":  # every tile holds a graph larger than the slot: Ts = 0
        return unique_pairs(raw_molecules(n_graphs=0, seed=seed, big=_BIG[case]))
    return unique_pairs(raw_molecules(n_graphs=n_graphs, seed=seed, big=_BIG[case]))


@pytest.mark.parametrize("slot", [32, 64])
def test_order_tiles_by_format_and_positions_match_jax(slot):
    raw = _raw("straddling")
    sizes = np.array([n.shape[0] for n, _, _ in raw])
    starts, _ = tpacking.pack_slots(sizes, slot=slot, tile=128)
    got = tpacking.order_tiles_by_format(starts, sizes, slot, 128, align=16)
    want = jpacking.order_tiles_by_format(starts, sizes, slot, 128, align=16)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[1] % 16 == 0 and got[1] > 0
    jm, tm = merged_pair(raw)
    jb = jbatch.from_graph_object(jm, slot_pack=slot, strip_dtype="float32")
    tb = tbatch.from_graph_object(tm, slot_pack=slot, strip_dtype="float32", device="cpu")
    for name in ("nodes", "node_mask", "arc_src", "arc_dst", "graph_of_node", "graph_mask", "targets"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.host_pred_rows, jb.host_pred_rows)


def _assert_same_strip(t_op, j_op):
    assert t_op.slot == j_op.slot
    np.testing.assert_array_equal(np_of(t_op.strip), np_of_jax(j_op.strip)[: t_op.strip.shape[0]])
    assert (t_op.scale is None) == (j_op.scale is None)
    if t_op.scale is not None:
        np.testing.assert_array_equal(t_op.scale.numpy(), np.asarray(j_op.scale)[: t_op.scale.shape[0]])
    assert (t_op.blocks is None) == (j_op.blocks is None)
    if t_op.blocks is not None:
        tb = t_op.blocks.shape[0]
        np.testing.assert_array_equal(np_of(t_op.blocks), np_of_jax(j_op.blocks)[:tb])
        assert not np.asarray(j_op.blocks, np.float32)[tb:].any()  # JAX's padding to 16 tiles
        if t_op.blocks_scale is not None:
            np.testing.assert_array_equal(t_op.blocks_scale.numpy(), np.asarray(j_op.blocks_scale)[:tb])
    assert (t_op.residual is None) == (j_op.residual is None)
    if t_op.residual is not None:
        for name in ("blocks", "src_tile", "dst_tile"):
            np.testing.assert_array_equal(getattr(t_op.residual, name).numpy(),
                                          np.asarray(getattr(j_op.residual, name)))


def _batches(case, slot, storage, focus="g"):
    raw = _raw(case)
    if focus == "n":
        raw = node_targets(raw, seed=5)
    jm, tm = merged_pair(raw, focus=focus)
    jb = jbatch.from_graph_object(jm, slot_pack=slot, strip_dtype=storage)
    tb = tbatch.from_graph_object(tm, slot_pack=slot, strip_dtype=storage, device="cpu")
    return jb, tb


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("slot", [32, 64])
def test_mixed_operator_matches_jax(slot, storage):
    jb, tb = _batches("straddling", slot, storage)
    op = tb.strip
    assert op.strip.shape[0] > 0 and op.blocks.shape[0] > 0 and op.residual is not None
    assert op.strip.shape[0] + op.blocks.shape[0] == tb.num_nodes // 128
    _assert_same_strip(op, jb.strip)


@pytest.mark.parametrize("slot", [32, 64])
def test_slot_pure_operator_matches_jax(slot):
    raw = _raw("straddling")
    jm, tm = merged_pair(raw)
    a = jm.arcs.shape[0]
    jb = jbatch.from_graph_object(jm, slot_pack=slot, strip_dtype="float32")
    src, dst, w = (np.asarray(x)[:a] for x in (jb.arc_src, jb.arc_dst, jb.arcnode_weight))
    n = jb.num_nodes
    j_op = jstrip.build_strip_operator(src, dst, w, n, slot=slot, dtype=np.int8)
    t_op = tstrip.build_strip_operator(src, dst, w, n, slot=slot, dtype="int8")
    assert t_op.blocks is None and t_op.strip.shape == (n // 128, slot, 128)
    _assert_same_strip(t_op, j_op)
    x = np.random.default_rng(3).normal(size=(8, n)).astype(np.float32)
    got = tstrip.strip_aggregate_t(torch.from_numpy(x), t_op).numpy()
    want = jax.jit(lambda s: jstrip.strip_aggregate_t(s, j_op))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slot", [32, 64])
def test_strip_to_dense_matches_jax(slot):
    jb, tb = _batches("straddling", slot, "int8")
    dense = tstrip.strip_to_dense(tb.strip, "bfloat16")
    assert dense.scale is None and dense.blocks_scale is None and dense.strip.dtype == torch.bfloat16
    _assert_same_strip(dense, jstrip.strip_to_dense(jb.strip, jnp.bfloat16))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(16, tb.num_nodes)).astype(np.float32))
    # bf16 weights against the f32 product of mask and scale: bf16's relative rounding
    torch.testing.assert_close(tstrip.strip_aggregate_t(x, dense), tstrip.strip_aggregate_t(x, tb.strip),
                               rtol=1e-2, atol=1e-2)
    f32 = tstrip.strip_to_dense(tb.strip, "float32")
    torch.testing.assert_close(tstrip.strip_aggregate_t(x, f32), tstrip.strip_aggregate_t(x, tb.strip),
                               rtol=RTOL, atol=ATOL)
    assert tstrip.strip_to_dense(dense) is dense


@pytest.mark.parametrize("slot,case,storage", [
    (32, "straddling", "int8"), (32, "straddling", "bfloat16"), (64, "straddling", "int8"),
    (64, "straddling", "bfloat16"), (32, "all_large", "int8"), (64, "all_large", "bfloat16"),
])
def test_strip_aggregate_t_forward_and_gradient_match_jax(slot, case, storage):
    jb, tb = _batches(case, slot, storage)
    ts = tb.strip.strip.shape[0]
    assert (ts == 0) == (case == "all_large")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, tb.num_nodes)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jstrip.strip_aggregate_t(s, jb.strip))(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda s: jnp.sum(jstrip.strip_aggregate_t(s, jb.strip) * ct)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tstrip.strip_aggregate_t(xt, tb.strip)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)


def test_plain_version_expands_the_compact_strip():
    """The plain version is the per-tile product with the block diagonal
    that the compact strip stands for, on a hand-built operator: strip
    tiles then full block tiles."""
    rng = np.random.default_rng(2)
    ts, tbk, slot, d = 2, 1, 32, 8
    strip = ((rng.random((ts, slot, 128)) < 0.2) * rng.random((ts, slot, 128))).astype(np.float32)
    blocks = ((rng.random((tbk, 128, 128)) < 0.05) * rng.random((tbk, 128, 128))).astype(np.float32)
    x = rng.normal(size=(d, (ts + tbk) * 128)).astype(np.float32)
    got = tstrip.strip_matmul(torch.from_numpy(x), torch.from_numpy(strip), None, torch.from_numpy(blocks),
                              None, slot).numpy()
    for t in range(ts + tbk):
        if t < ts:
            full = np.zeros((128, 128))
            for g in range(128 // slot):
                full[g * slot:(g + 1) * slot, g * slot:(g + 1) * slot] = strip[t][:, g * slot:(g + 1) * slot]
        else:
            full = blocks[t - ts]
        cols = slice(128 * t, 128 * (t + 1))
        np.testing.assert_allclose(got[:, cols], x[:, cols].astype(np.float64) @ full, rtol=RTOL, atol=ATOL)


def _port_dict(tree, section):
    other = "state" if section == "params" else "params"
    return variables_from_jax({section: jax.tree_util.tree_map(np.asarray, tree), other: {}})


@pytest.mark.parametrize("slot,focus", [(32, "g"), (64, "n")])
def test_forward_and_adam_step_match_jax(slot, focus):
    raw = _raw("straddling", seed=6, n_graphs=12)
    if focus == "n":
        raw = node_targets(raw, seed=6)
    jb = jbatch.graphs_to_batch(graphs(jgraph, raw, focus), focus, "average", slot_pack=slot, strip_dtype="int8")
    tb = tbatch.graphs_to_batch(graphs(tgraph, raw, focus), focus, "average", slot_pack=slot, strip_dtype="int8",
                                device="cpu")
    assert tb.strip.blocks is not None and tb.strip.scale is not None
    jm, tm = flagship_pair(seed=3, node_focus=focus == "n")
    jk, _, jout, jmask, _ = jax.jit(lambda v, b: jm.forward(v, b, training=False))(jm.variables, jb)
    tk, _, tout, tmask, _ = tm.forward(tb, training=False)
    assert tk == int(jk) == 5
    rows = tmask.numpy()
    np.testing.assert_array_equal(rows, np.asarray(jmask))
    np.testing.assert_allclose(tout.numpy()[rows], np.asarray(jout)[rows], rtol=RTOL, atol=ATOL)

    for m in (jm, tm):
        m.compile(optimizer="adam:0.01", loss="categorical_crossentropy", metrics=["accuracy"])
    params, mstate = jm.variables["params"], jm.variables["state"]
    new_params, new_mstate, _, jlogs = jtr._train_step_body(jm)(params, mstate, jm.optimizer.init(params), jb,
                                                                 jax.random.PRNGKey(0))
    logs, _ = ttr.train_step(tm, tb)
    for key in ("loss_sum", "count", "accuracy_sum", "accuracy_count"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=RTOL, err_msg=key)
    want_stats = _port_dict(new_mstate, "state")
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    want = _port_dict(new_params, "params")
    excluded = 0
    for name, p in tm.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), p.grad.numpy()
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        excluded += int((~live).sum())
        np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=ATOL, err_msg=name)
    assert excluded == 0
