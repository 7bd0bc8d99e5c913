"""What the stage metrics read: the device time of the kernels launched
inside the program's stage spans, and the program's work counters.

The program's `lm_solve` span is partitioned by eleven stage spans
(`ops/solver.py`, `ops/structured.py`): every kernel of a solve is launched
inside exactly one. Its counters (`utils/profiling.counters()`) are kept
only while a profiler records, so after a run they hold the traced batch.
They are read from the program module the harness's `Program` loaded
(`sys.modules`); nothing here imports the program. A program without those
spans or counters gives None."""

from __future__ import annotations

import sys

from vilo_bench import trace as tr

STAGES = ("proj_jacobians", "proj_normal", "ileg_factor", "prior_calib",
          "gauge_project", "robust_cost", "schur_reduce", "lane_chol",
          "back_substitute", "lm_update", "reanchor")
PROFILING = "cerberus_tpu_torch.utils.profiling"


def launched_in_any(trace: tr.Trace, names) -> list | None:
    """Kernels launched inside any span of `names`; None when the trace
    holds no such span."""
    if not any(trace.spans(n) for n in names):
        return None
    return list({k.corr: k for n in names
                 for k in tr.launched_in(trace, n)}.values())


def device_ms_per_iter(r, *names) -> float | None:
    """Device ms of the kernels launched inside the spans `names`, over the
    solve's LM iterations; None where they launched none."""
    if r.trace is None:
        return None
    ks = launched_in_any(r.trace, names)
    if not ks:
        return None
    return sum(k.dur for k in ks) * 1e-3 / r.iters


def counters() -> dict | None:
    """The program's counters, or None where the loaded program keeps
    none."""
    mod = sys.modules.get(PROFILING)
    read = getattr(mod, "counters", None)
    return read() if read is not None else None


def counter_pct(r, num: str, den: str) -> float | None:
    """100 * counter `num` / counter `den` after the traced batch."""
    if r.trace is None:
        return None
    c = counters()
    if not c or num not in c or not c.get(den):
        return None
    return 100.0 * c[num] / c[den]
