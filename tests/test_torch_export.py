"""The port's exported eval forward (``export_forward`` / ``load_exported``,
``torch.export``) against the port's ``model.forward`` and the JAX
package's exported artifact (``jax.export``) on the same batches, and the
fixed-length eval loop that export traces against the ``while`` loop.

Tolerances.  The artifact against the JAX artifact: f32 in both, sums in
other orders, rtol 1e-5 / atol 1e-6.  Against the port's own forward the
program runs the same operations in the same order, so the same tolerance
holds with room to spare.  The fixed-length loop against the ``while``
loop: bit for bit (``where`` keeps the frozen state exactly).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gnnkeras_tpu.graph.batch as jbatch
import gnnkeras_tpu.serving as jserving
import gnnkeras_tpu_torch.graph.batch as tbatch
import gnnkeras_tpu_torch.serving as tserving
from torch_port_common import arc_targets, flagship_pair, gnn_pair, merged_pair, raw_molecules, unique_pairs

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LAYOUTS = {
    "plain": dict(),
    "strip": dict(slot_pack=128, strip_dtype="float32"),
    "edge_list": dict(dense_blocks=False),
}


def _batch_pair(focus, layout, seed=8, n_graphs=8, **pads):
    raw = unique_pairs(raw_molecules(n_graphs=n_graphs, seed=seed))
    if focus == "a":
        raw = arc_targets(raw, seed=seed)
    jm, tm = merged_pair(raw, focus=focus)
    jb = jbatch.from_graph_object(jm, **_LAYOUTS[layout], **pads)
    tb = tbatch.from_graph_object(tm, device="cpu", **_LAYOUTS[layout], **pads)
    return jb, tb


def _custom_ops(path):
    program = torch.export.load(os.path.join(path, "forward.pt2"))
    return {str(n.target) for n in program.graph.nodes if "gnnkeras_tpu_torch" in str(n.target)}


@pytest.mark.parametrize("case", [("g", "plain"), ("g", "strip"), ("a", "strip")])
def test_artifact_matches_forward_and_jax_artifact(case, tmp_path):
    focus, layout = case
    jm, tm = gnn_pair(focus, seed=7)
    jb, tb = _batch_pair(focus, layout)
    tserving.export_forward(tm, tb, str(tmp_path / "port"))
    jserving.export_forward(jm, jb, str(tmp_path / "jax"))
    loaded = tserving.load_exported(str(tmp_path / "port"), device="cpu")
    out, out_mask = loaded.call(tb)
    _, _, want, want_mask, _ = tm.forward(tb)
    jout, jmask = jserving.load_exported(str(tmp_path / "jax")).call(jb)
    assert torch.equal(out_mask, want_mask)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(jmask))
    rows = out_mask.numpy()
    np.testing.assert_allclose(out.numpy()[rows], want.numpy()[rows], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jout)[rows], rtol=RTOL, atol=ATOL)
    meta = loaded.meta
    assert meta["model_class"] == type(tm).__name__ == jserving.load_exported(str(tmp_path / "jax")).meta["model_class"]
    assert meta["focus"] == focus and meta["n_params"] == len(tm.state_dict())
    # the kernels are one node each in the program
    want_ops = set()
    if layout == "strip":
        want_ops.add("gnnkeras_tpu_torch.strip_matmul.default")
    if focus == "a":
        want_ops.add("gnnkeras_tpu_torch.incidence_select.default")
    assert _custom_ops(str(tmp_path / "port")) == want_ops


def test_artifact_runs_on_a_new_batch_of_the_template_shapes(tmp_path):
    pads = dict(pad_nodes=512, pad_arcs=1024, pad_graphs=8)
    _, tm = flagship_pair(seed=8)
    _, tb = _batch_pair("g", "plain", seed=8, **pads)
    _, tb2 = _batch_pair("g", "plain", seed=9, **pads)
    tb, tb2 = tbatch.pad_operators_to_cap(tb), tbatch.pad_operators_to_cap(tb2)
    tserving.export_forward(tm, tb, str(tmp_path))
    loaded = tserving.load_exported(str(tmp_path), device="cpu")
    got, _ = loaded.call(tb2)
    _, _, want, _, _ = tm.forward(tb2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    _, other = _batch_pair("g", "plain", seed=9)
    with pytest.raises(ValueError, match="template"):
        loaded.call(other)
    # the same tensor shapes, another static structure than the one traced
    with pytest.raises(ValueError, match="static structure"):
        loaded.call(tb2.replace(focus="n"))


def _arc_pair_padded(n_graphs, seed, pads):
    jb, tb = _batch_pair("a", "strip", seed=seed, n_graphs=n_graphs, **pads)
    return jbatch.pad_operators_to_cap(jb), tbatch.pad_operators_to_cap(tb)


def test_arc_artifact_runs_on_a_batch_with_more_live_pairs(tmp_path):
    """The select's index is an input of the program, not a constant of
    the template: a batch padded to the same shapes with more live pairs
    is served in full, as the JAX artifact serves it."""
    # arcs padded to the 32's own arc tiles, so every arc tile holds real arcs
    n_arcs = int(_batch_pair("a", "strip", seed=6, n_graphs=32)[1].arc_mask.sum())
    pads = dict(pad_nodes=1024, pad_arcs=-(-n_arcs // 128) * 128, pad_graphs=40)
    jm, tm = gnn_pair("a", seed=5)
    jb, tb = _arc_pair_padded(2, 5, pads)
    jb2, tb2 = _arc_pair_padded(32, 6, pads)
    inc, lo = tb2.arc_inc, tb.arc_inc.n_live
    assert inc.n_live > lo and inc.n_pairs == tb.arc_inc.n_pairs
    # the later pairs feed supervised arc rows (the card's select copies them)
    past = (inc.f_arc_tile[lo:].long()[:, None] * 128 + torch.arange(128))[inc.f_cols_src[lo:] >= 0]
    assert tb2.output_row_mask[past].any()
    tserving.export_forward(tm, tb, str(tmp_path / "port"))
    jserving.export_forward(jm, jb, str(tmp_path / "jax"))
    program = torch.export.load(str(tmp_path / "port" / "forward.pt2"))
    select = [n for n in program.graph.nodes if "incidence_select" in str(n.target)]
    assert len(select) == 1 and all(isinstance(a, torch.fx.Node) for a in select[0].args[:2])
    got, mask = tserving.load_exported(str(tmp_path / "port"), device="cpu").call(tb2)
    _, _, want, want_mask, _ = tm.forward(tb2)
    jout, jmask = jserving.load_exported(str(tmp_path / "jax")).call(jb2)
    rows = mask.numpy()
    assert torch.equal(mask, want_mask) and rows.sum() == int(tb2.arc_mask.sum())
    np.testing.assert_array_equal(rows, np.asarray(jmask))
    np.testing.assert_allclose(got.numpy()[rows], want.numpy()[rows], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(jout)[rows], rtol=RTOL, atol=ATOL)


_LOADER = r"""
import sys
import torch
from gnnkeras_tpu_torch.serving import load_exported

path = sys.argv[1]
batch, want = torch.load(path + "/inputs.pt", weights_only=False)
out, _ = load_exported(path, device="cpu").call(batch)
torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
print(sorted(m for m in sys.modules if m.startswith("gnnkeras_tpu_torch.models")))
"""


def test_artifact_loads_without_the_model_classes(tmp_path):
    _, tm = gnn_pair("a", seed=3)
    _, tb = _batch_pair("a", "strip", seed=3)
    tserving.export_forward(tm, tb, str(tmp_path))
    _, _, want, _, _ = tm.forward(tb)
    torch.save((tb, want), str(tmp_path / "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _LOADER, str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_export_refuses_a_batch_on_another_device(tmp_path):
    _, tm = flagship_pair(seed=0)
    _, tb = _batch_pair("g", "plain")
    with pytest.raises(ValueError, match="device"):
        tserving.export_forward(tm, tb.replace(nodes=tb.nodes.to("meta")), str(tmp_path))


# threshold, state net (kernel scale, bias shift): the second makes each
# step move the state little against its norm, so the unfolding stops early
_THRESHOLDS = {"0": (0.0, None), "0.05-converging": (0.05, (0.3, 10.0))}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("threshold", list(_THRESHOLDS))
def test_fixed_length_loop_equals_the_while_loop(threshold, layout):
    thr, state_dense = _THRESHOLDS[threshold]
    _, tm = flagship_pair(seed=2, threshold=thr, state_dense=state_dense)
    _, tb = _batch_pair("g", layout)
    k, state, out, mask, bn = tm.forward(tb)
    k_fixed, state_fixed, out_fixed, mask_fixed, bn_fixed = tm.forward(tb, fixed_length=True)
    assert isinstance(k, int) and k_fixed.shape == () and float(k_fixed) == k
    assert (k < tm.max_iteration) == (threshold != "0")
    assert torch.equal(state_fixed, state) and torch.equal(out_fixed, out) and torch.equal(mask_fixed, mask)
    assert bn_fixed.keys() == bn.keys() and all(torch.equal(bn_fixed[key], bn[key]) for key in bn)


def test_fixed_length_loop_with_per_iteration_statistics():
    _, tm = gnn_pair("g", seed=4, threshold=0.01, per_iteration_bn=True)
    _, tb = _batch_pair("g", "strip")
    k, state, _, _, bn = tm.forward(tb)
    k_fixed, state_fixed, _, _, bn_fixed = tm.forward(tb, fixed_length=True)
    assert float(k_fixed) == k and torch.equal(state_fixed, state)
    assert all(torch.equal(bn_fixed[key], bn[key]) for key in bn)
