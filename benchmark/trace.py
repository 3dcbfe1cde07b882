"""The reduction of a profiler trace to device numbers.

The traced stretch is one ``torch.profiler`` session (CPU and CUDA
activity) over whole calls of the window.  Its Chrome trace is read once:
device operations are the events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the device is busy in the union of their
intervals (overlapping streams are counted once); an idle gap is an
interval between them, named by the innermost host event (an operator or a
CUDA runtime call) running at its middle.  The breakdown's names of device
operations lose their return type and argument list (``short_name``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
GAPS_NAMED = 20000  # the longest gaps that are named; the rest count as "(shorter gaps)"
WALK = 256  # host events looked at, back from a gap's middle, for one that covers it
NO_HOST = "(host: between traced operators)"
NAME_CHARS = 160


class Profiler:
    """One profiler session; ``stop`` returns the trace's events."""

    def __init__(self, cuda: bool):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()

    def stop(self) -> List[dict]:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted (start, end) rows of ``intervals``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    intervals = intervals[np.argsort(intervals[:, 0])]
    merged = [list(intervals[0])]
    for start, end in intervals[1:]:
        if start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return np.asarray(merged)


def summarize(events: List[dict]) -> Dict:
    """``busy_s``, ``span_s`` (first to last event), ``device_ops``
    {name: seconds}, ``idle_gaps`` {host name: seconds} of one trace."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES]
    ops: Dict[str, float] = {}
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
    if not events:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": ops, "idle_gaps": {}}
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = _union(np.array([[e["ts"], e["ts"] + e["dur"]] for e in device], dtype=np.float64).reshape(-1, 2))
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)  # (gap start, gap end) rows
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])]
    named, rest = gaps[:GAPS_NAMED], gaps[GAPS_NAMED:]
    idle: Dict[str, float] = {}
    if len(named):
        order = sorted(range(len(host)), key=lambda i: host[i]["ts"])
        h_start = np.array([host[i]["ts"] for i in order], dtype=np.float64)
        h_end = h_start + np.array([host[i]["dur"] for i in order], dtype=np.float64)
        for start, end in named:
            name = _covering(host, order, h_start, h_end, 0.5 * (start + end))
            idle[name] = idle.get(name, 0.0) + (end - start) * 1e-6
    if len(rest):
        idle["(shorter gaps)"] = float(np.sum(rest[:, 1] - rest[:, 0])) * 1e-6
    return {"busy_s": float(np.sum(busy[:, 1] - busy[:, 0])) * 1e-6 if len(busy) else 0.0,
            "span_s": (hi - lo) * 1e-6, "device_ops": ops, "idle_gaps": idle}


def _covering(host, order, h_start, h_end, t) -> str:
    """The innermost host event running at ``t`` (the latest to start among
    those that cover it), looked for among the ``WALK`` that started last."""
    i = int(np.searchsorted(h_start, t, side="right")) - 1
    for j in range(i, max(i - WALK, -1), -1):
        if h_end[j] > t:
            return host[order[j]]["name"]
    return NO_HOST


def short_name(name: str) -> str:
    """A device operation's name without its return type and its argument
    list, at most ``NAME_CHARS`` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:NAME_CHARS]


def top(table: Dict[str, float], n: int = TOP, shorten: bool = False) -> List[Tuple[str, float]]:
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[short_name(k) if shorten else k, v] for k, v in rows]
