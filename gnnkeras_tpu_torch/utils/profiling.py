"""Tracing and throughput hooks, the counterpart of
``gnnkeras_tpu.utils.profiling``.

- ``annotate(name)``: a named span (``torch.profiler.record_function``)
  that shows in a captured trace, on the host and, around kernels, on the
  device; a cheap no-op when no profiler runs;
- ``trace(log_dir)``: one ``torch.profiler.profile`` session around the
  block (CPU and, with a card, CUDA activity) whose Chrome trace is written
  into ``log_dir`` as ``trace_<pid>_<n>.json`` (open it in Perfetto or
  ``chrome://tracing``); the profile is returned for ``key_averages()``;
- ``ThroughputMeter``: host-side edges/s and steps/s counters.

A process should open one ``trace`` session while a captured CUDA graph is
replayed: a second session replaying a graph has crashed the process.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator, Optional

import torch

_traces = itertools.count()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span visible in profiler traces (cheap no-op otherwise)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block and write its trace into ``log_dir`` (created);
    yields the profile (its events are complete after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_traces)}.json"))


class ThroughputMeter:
    """Accumulates per-step edges/iterations and reports edges/s."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._edges = 0.0
        self._steps = 0
        self._t0: Optional[float] = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def step(self, n_edges: int, n_iterations: float = 1.0) -> None:
        self._edges += float(n_edges) * float(n_iterations)
        self._steps += 1

    @property
    def edges_per_s(self) -> float:
        return self._edges / self._elapsed if self._elapsed else 0.0

    @property
    def steps_per_s(self) -> float:
        return self._steps / self._elapsed if self._elapsed else 0.0

    def report(self) -> dict:
        return {
            "edges_per_s": self.edges_per_s,
            "steps_per_s": self.steps_per_s,
            "steps": self._steps,
            "elapsed_s": self._elapsed,
        }
