"""Reduction of a `torch.profiler` chrome trace to what the per-layer
metrics read: device operations and their intervals, the host launch of
each kernel (by correlation id), the host's CUDA runtime and driver calls,
the benchmark's and the program's spans (`record_function` annotations),
the busy union and the idle gaps.

Times in the trace are microseconds on one clock for host and device."""

from __future__ import annotations

import bisect
import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    ts: float      # us
    dur: float     # us
    corr: int      # correlation id (-1 when the trace gives none)


class HostOp(NamedTuple):
    name: str
    cat: str
    ts: float
    end: float


class Trace(NamedTuple):
    device_ops: list   # DeviceOp, sorted by ts
    launches: dict     # correlation id -> host ts of the runtime call
    host_ops: list     # HostOp (cpu ops and user spans), sorted by ts
    runtime: list      # (start, end) of each CUDA runtime or driver call

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if op.cat == "kernel"]

    def spans(self, name: str) -> list:
        """(start, end) of every user span called `name`."""
        return [(h.ts, h.end) for h in self.host_ops
                if h.cat == "user_annotation" and h.name == name]


def from_events(events: list) -> Trace:
    """A Trace from the `traceEvents` list of a chrome trace."""
    device_ops, host_ops, launches, runtime = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation", -1)
        if cat in DEVICE_CATS:
            device_ops.append(DeviceOp(e.get("name", ""), cat, ts, dur,
                                       int(corr)))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            runtime.append((ts, ts + dur))
            if corr != -1:
                launches[int(corr)] = ts
        elif cat in HOST_CATS:
            host_ops.append(HostOp(e.get("name", ""), cat, ts, ts + dur))
    device_ops.sort(key=lambda o: o.ts)
    host_ops.sort(key=lambda h: h.ts)
    return Trace(device_ops, launches, host_ops, sorted(runtime))


def load(path) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    return from_events(doc["traceEvents"] if isinstance(doc, dict) else doc)


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as disjoint
    sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_us(trace: Trace, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device operation ran."""
    return sum(b - a for a, b in merged(
        ((o.ts, o.ts + o.dur) for o in trace.device_ops), lo, hi))


def idle_gaps(trace: Trace, lo: float, hi: float) -> list:
    """(start, end) of every stretch of [lo, hi] with no device operation."""
    gaps, t = [], lo
    for a, b in merged(((o.ts, o.ts + o.dur) for o in trace.device_ops),
                       lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_own_us(trace: Trace, span_name: str) -> float:
    """Microseconds of the user spans `span_name` in which the host was in
    none of its CUDA runtime or driver calls: the host's own work inside
    them, without the time it waited in a launch on a full queue or in a
    copy."""
    total = 0.0
    for lo, hi in trace.spans(span_name):
        total += (hi - lo) - sum(b - a for a, b in
                                 merged(trace.runtime, lo, hi))
    return total


def launched_in(trace: Trace, span_name: str) -> list:
    """Kernels whose host launch lies inside a user span `span_name`."""
    spans = sorted(trace.spans(span_name))
    starts = [a for a, _ in spans]
    out = []
    for k in trace.kernels:
        t = trace.launches.get(k.corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            out.append(k)
    return out


def host_activity(trace: Trace, t: float, skip=()) -> str:
    """What the host was doing at time t: the innermost user span open
    then, and the innermost cpu op, as "span/op"."""
    span = op = None
    for h in trace.host_ops:
        if h.ts > t:
            break
        if h.end >= t and h.name not in skip:
            if h.cat == "user_annotation":
                span = h
            else:
                op = h
    names = [x.name for x in (span, op) if x is not None]
    return "/".join(names) if names else "no host op"


def breakdown(trace: Trace, lo: float, hi: float, top: int = 10,
              skip=()) -> dict:
    """The device operations that took most time in [lo, hi], summed by
    name, and the longest idle gaps named by the host's activity at their
    start; seconds, at most `top` entries each."""
    by_name = {}
    for o in trace.device_ops:
        d = min(o.ts + o.dur, hi) - max(o.ts, lo)
        if d > 0:
            by_name[o.name] = by_name.get(o.name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n, d * 1e-6] for n, d in ops],
        "idle_gaps": [[host_activity(trace, a, skip), (b - a) * 1e-6]
                      for a, b in gaps],
    }
