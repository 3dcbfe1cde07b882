"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the cell,
its configuration and its metrics; the cell's file
``benchmark/workloads/<cell>.json`` names its driver
(``benchmark/drivers/<driver>.py``, a ``Cell`` class) and holds its
traffic and limits; ``benchmark/configs/<config>.json`` holds the
configuration; each per-layer metric is read by
``benchmark/metrics/<metric>.py`` (``read(record)``, None when it finds
nothing to read).

The window: a driver calls ``on_call()`` after each user call (one epoch of
``fit``), which synchronises the device, records the call's end and says
when ``seconds`` have passed since the window opened.  With
``trace`` one profiler session covers whole calls from the
``TRACE_AFTER``-th call on, for at least ``TRACE_SECONDS`` and
``TRACE_CALLS`` calls.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from benchmark import trace as T

TRACE_AFTER, TRACE_SECONDS, TRACE_CALLS = 3, 1.0, 3
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnkeras_tpu")


class Window:
    def __init__(self, seconds: float, traced: bool, cuda: bool, clock: Callable[[], float]):
        self.seconds, self.traced, self.cuda, self.clock = float(seconds), traced, cuda, clock
        self.ends: List[float] = []
        self.t0 = None
        self.profiler = None
        self.stretch = None  # (first call, calls after it, start, end)
        self.events: List[dict] = []

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def open(self) -> float:
        self._sync()
        self.t0 = self.clock()
        return self.t0

    def on_call(self) -> bool:
        self._sync()
        t = self.clock()
        self.ends.append(t)
        done = len(self.ends)
        if self.traced and self.stretch is None:
            if self.profiler is None and done == TRACE_AFTER:
                self.profiler = T.Profiler(self.cuda)
                self._trace_from = (done, self.clock())
            elif self.profiler is not None:
                first, start = self._trace_from
                if (t - start >= TRACE_SECONDS and done - first >= TRACE_CALLS) or t - self.t0 >= self.seconds:
                    self.stretch = (first, done, start, t)
                    self.events = self.profiler.stop()
                    self.profiler = None
        return t - self.t0 >= self.seconds

    def close(self) -> None:
        """End a stretch the window outran."""
        if self.profiler is not None:
            first, start = self._trace_from
            self.stretch = (first, len(self.ends), start, self.ends[-1])
            self.events = self.profiler.stop()
            self.profiler = None

    def durations(self) -> np.ndarray:
        return np.diff(np.concatenate([[self.t0], self.ends]))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str):
    """(the cell's BENCHMARK.json entry, its workload file, its
    configuration file, the whole BENCHMARK.json)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    wl = _json(os.path.join(root, "benchmark", "workloads", f"{workload}.json"))
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = _json(os.path.join(root, config["file"]))
    return entry, wl, cfg, bench


def make_cell(root: str, workload: str, seed: int, device):
    entry, wl, cfg, bench = load_cell(root, workload)
    driver = _load(os.path.join(root, "benchmark", "drivers", f"{wl['driver']}.py"), f"bench_driver_{wl['driver']}")
    return driver.Cell(cfg, wl, seed, device), entry, wl, cfg, bench


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {name: {"value": float(numbers[name]), "limit": float(limits[name])} for name in limits}


def is_correct(checked: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def cell_metrics(bench: dict, workload: str, reports: set) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move one of the cell's end-to-end metrics."""
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and workload in cells) or (cells is None and m["moves"] in reports):
            out.append(m)
    return out


def e2e_names(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: Optional[float] = None, clock: Callable[[], float] = time.perf_counter) -> dict:
    """One run; returns the result line's object.  ``device`` "cpu" runs the
    same path on the CPU (tests), where no time is a device number."""
    import torch

    t_start = clock() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    t_data = clock()
    cell, entry, wl, cfg, bench = make_cell(root, workload, seed, device)
    t_setup = clock()
    spans: Dict[str, float] = {}
    cell.setup(spans, clock)
    print(f"set-up: imports {t_data - t_start:.3f} s, data and weights {t_setup - t_data:.3f} s, sequencers "
          f"{spans['host_build_s']:.3f} s, the program's first calls {clock() - t_setup - spans['host_build_s']:.3f} s",
          file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = Window(seconds, traced, cuda, clock)
    window.open()
    setup_s = window.t0 - t_start
    cell.run_window(window.on_call)
    window.close()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())) if cuda else 0

    program = cell.program_readings()
    cell.free()
    checked = checks(cell.judge(program), wl["limits"])

    durations = window.durations()
    works = [cell.call_work(i) for i in range(len(durations))]
    window_s = float(window.ends[-1] - window.t0)
    e2e = {m["name"]: m for m in e2e_names(bench, workload)}
    values = {"setup_s": setup_s, "train_edges_per_s": sum(w["edges"] for w in works) / window_s,
              "train_graphs_per_s": sum(w["graphs"] for w in works) / window_s,
              "call_p95_ms": float(np.percentile(durations, 95)) * 1e3}
    print(f"window: {len(durations)} calls in {window_s:.6f} s, call median "
          f"{float(np.median(durations)) * 1e3:.6f} ms, p95 over {len(durations)} samples", file=sys.stderr)

    result = {"correct": is_correct(checked), "attempted": int(len(durations)), "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(entry.get("chips", 1)) if cuda else 1, "memory_peak_bytes": int(peak)}
    if not traced:
        result["metrics"] = {name: {"value": values[name], "unit": m["unit"]} for name, m in e2e.items()}
    elif window.stretch is not None:
        summary = T.summarize(window.events)
        first, last, start, end = window.stretch
        record = {"config": cfg, "workload": wl, "kind": cell.kind, "spans": spans,
                  "trace": summary, "stretch_s": end - start, "work": works[first:last]}
        metrics = {}
        for m in cell_metrics(bench, workload, set(e2e)):
            reader = _load(os.path.join(root, "benchmark", "metrics", f"{m['name']}.py"),
                           "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = end - start
        result["breakdown"] = {"device_ops": T.top(summary["device_ops"], shorten=True),
                              "idle_gaps": T.top(summary["idle_gaps"])}
    result["device"] = device_info
    result["checks"] = checked
    return result


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    entry = load_cell(root, args.workload)[0]

    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX package", file=sys.stderr)
        return 4
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
