"""The FLOP and byte counts of ``train_mfu`` and
``aggregation_roofline.train`` against hand counts on a 3-molecule toy, and the
trace reduction on a handmade trace."""

import importlib.util
import json
import os

import pytest

from benchmark import peaks, trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def metric(name):
    spec = importlib.util.spec_from_file_location("t_" + name.replace(".", "_"),
                                                  os.path.join(REPO, "benchmark", "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def starter():
    with open(os.path.join(REPO, "benchmark", "configs", "starter_gnn.json")) as f:
        return json.load(f)


# three molecules: a triangle (3 atoms, 6 arcs), a chain of 4 (6 arcs) and a
# 5-ring (10 arcs): 12 nodes, 22 arcs; the batch of all three in one step
NODES, ARCS = 12, 22


def test_forward_flops_by_hand(starter):
    f = metric("train_mfu")
    # state Dense 31 → 14 on 12 nodes, 5 iterations: 5 · 2 · 12 · 31 · 14 = 52,080
    # 4 aggregations of 14 features over 22 arcs: 4 · 2 · 22 · 14 = 2,464
    # output Dense 14 → 2 on 12 nodes: 2 · 12 · 14 · 2 = 672
    assert f.forward_flops(starter, NODES, ARCS, 5) == 52_080 + 2_464 + 672
    assert f.forward_flops(starter, NODES, ARCS, 1) == 10_416 + 0 + 672
    assert f.train_step_flops(starter, NODES, ARCS) == 3 * (52_080 + 2_464 + 672)


def test_mfu_readers(starter):
    record = {"config": starter, "kind": "train", "trace": {"busy_s": 0.0}, "stretch_s": 2e-3,
              "work": [{"train_steps": [(NODES, ARCS)], "edges": ARCS * 5}] * 2}
    step = 3 * 55_216
    assert metric("train_mfu").read(record) == pytest.approx(100 * 2 * step / (2e-3 * peaks.F32_FLOPS))
    record["kind"] = "infer"
    assert metric("train_mfu").read(record) is None


def test_aggregation_bytes_and_count_by_hand(starter):
    a = metric("aggregation_roofline")
    # 22 arcs · 12 B + 12 nodes · 14 features · 4 B read and again written = 264 + 1,344 = 1,608 B
    assert a.least_seconds(NODES, ARCS, 14) == pytest.approx(1_608 / peaks.HBM_BYTES_PER_S)
    # 2 · 22 · 14 = 616 FLOPs, under the bytes' time at this width
    assert 616 / peaks.F32_FLOPS < a.least_seconds(NODES, ARCS, 14)
    work = {"train_steps": [(NODES, ARCS), (NODES, ARCS)]}
    assert a.aggregations(work, starter) == [(NODES, ARCS, 8), (NODES, ARCS, 8)]


def test_roofline_reader(starter):
    ops = {"void strip_kernel<128, 16>(float const*)": 4e-6, "void qbcsr_list_t_kernel<8>()": 1e-6,
           "elementwise": 9e-6}
    record = {"config": starter, "kind": "train", "trace": {"device_ops": ops}, "stretch_s": 1e-3,
              "work": [{"train_steps": [(NODES, ARCS)], "edges": 0}]}
    least = 8 * 1_608 / peaks.HBM_BYTES_PER_S
    assert metric("aggregation_roofline.train").read(record) == pytest.approx(100 * least / 5e-6)
    record["kind"] = "infer"
    assert metric("aggregation_roofline.train").read(record) is None
    record["kind"] = "train"
    record["trace"] = {"device_ops": {"elementwise": 1e-6}}
    assert metric("aggregation_roofline.train").read(record) is None


def test_idle_share_and_host_build(starter):
    record = {"kind": "train", "trace": {"busy_s": 0.25}, "stretch_s": 1.0, "spans": {"host_build_s": 3.5}}
    assert metric("device_idle_share.train").read(record) == pytest.approx(75.0)
    assert metric("device_idle_share.train").read({**record, "kind": "infer"}) is None
    assert metric("host_build_s").read(record) == 3.5


def test_trace_union_and_gaps():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        ev("cpu_op", "aten::mm", 0, 100),
        ev("cuda_runtime", "cudaStreamSynchronize", 40, 30),
        ev("kernel", "k1", 10, 20),  # 10-30
        ev("kernel", "k2", 20, 20),  # 20-40, overlaps k1 on another stream
        ev("gpu_memcpy", "Memcpy DtoH", 80, 10),  # 80-90
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(40e-6)  # 10-40 and 80-90
    assert s["span_s"] == pytest.approx(100e-6)
    assert s["device_ops"] == pytest.approx({"k1": 20e-6, "k2": 20e-6, "Memcpy DtoH": 10e-6})
    # gaps: 0-10 (aten::mm), 40-80 (the sync at 60), 90-100 (aten::mm)
    assert s["idle_gaps"] == pytest.approx({"aten::mm": 20e-6, "cudaStreamSynchronize": 40e-6})
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
    name = "void gnn_strip::strip_kernel<8, 128, signed char, true, false, (bool)0>(float const*, int)"
    assert trace.short_name(name) == "gnn_strip::strip_kernel<8, 128, signed char, true, false, (bool)0>"
    # a gap that no host event covers
    s = trace.summarize([ev("kernel", "k", 0, 10), ev("cpu_op", "a", 12, 2), ev("kernel", "k", 20, 10)])
    assert s["idle_gaps"] == pytest.approx({trace.NO_HOST: 10e-6})
