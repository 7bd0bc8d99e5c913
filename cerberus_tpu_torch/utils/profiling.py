"""Device profiling (port of `cerberus_tpu/utils/profiling.py`).

trace(): context manager around `torch.profiler` for per-kernel traces of
the card (the replacement for the reference's ROS_DEBUG timing prints,
SURVEY.md §5).

count() / counters() / reset_counters(): named counts of the program's
work (LM iterations, accepted steps, valid feature slots), kept only while
a torch.profiler records, so that a traced run reads its ratios where the
work happens. Off the profiler `count` is one flag check: it stores and
launches nothing. Under it a device tensor is added on its device, and
nothing is read back until `counters()`. accumulator() gives a kernel a
counter on its device to add into itself.
"""

from __future__ import annotations

import contextlib
import os

import torch

_COUNTS: dict = {}


def recording() -> bool:
    """True while a torch.profiler (or autograd profiler) records."""
    return torch._C._autograd._profiler_enabled()


def count(name: str, value) -> None:
    """Add `value` (a number, or a tensor of one element, left on its
    device) to the counter `name`, while a profiler records."""
    if not recording():
        return
    old = _COUNTS.get(name)
    _COUNTS[name] = value if old is None else old + value


def accumulator(name: str, device):
    """The counter `name` as a one-element int64 tensor on `device` (zero
    when first asked for) for a kernel to add into, while a profiler
    records; None otherwise."""
    if not recording():
        return None
    acc = _COUNTS.get(name)
    if acc is None:
        acc = _COUNTS[name] = torch.zeros((), dtype=torch.int64,
                                          device=device)
    return acc


def counters() -> dict:
    """Every counter's value as a float (reads device counters back)."""
    return {k: float(v) for k, v in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block (host ops, and the card's
    kernels when CUDA is available) into logdir/trace.json, viewable in
    chrome://tracing or Perfetto. Yields the profiler, whose
    key_averages() gives the per-op table."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
