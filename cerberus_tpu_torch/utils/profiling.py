"""Timing + device profiling (port of `cerberus_tpu/utils/profiling.py`).

TicToc: the reference's manual wall-clock stopwatch (reference:
src/utils/tic_toc.h). trace(): context manager around `torch.profiler` for
per-kernel traces of the card (the replacement for the reference's
ROS_DEBUG timing prints, SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self):
        self.t0 = time.perf_counter()

    def toc(self) -> float:
        """Milliseconds since tic()."""
        return (time.perf_counter() - self.t0) * 1000.0


class Timers:
    """Named cumulative timers (replacement for the scattered sum_t /
    printStatistics counters, visualization.cpp:109-118)."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> dict:
        return {k: dict(total_s=self.total[k], count=self.count[k],
                        mean_ms=1000.0 * self.total[k] / max(self.count[k], 1))
                for k in self.total}


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block (host ops, and the card's
    kernels when CUDA is available) into logdir/trace.json, viewable in
    chrome://tracing or Perfetto. Yields the profiler, whose
    key_averages() gives the per-op table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
