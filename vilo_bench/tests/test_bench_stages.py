"""The stage metrics on a small synthetic chrome trace and hand-set
counters: device time by the stage span a kernel was launched in, the
assembly's stages adding up to `assemble_device_ms_per_iter`, the share of
the solve launched outside every stage, the counter ratios, and None where
a program keeps no such span or counter (the parent of the change that
added them)."""

import sys
import types

import pytest

from vilo_bench import harness, stages
from vilo_bench import trace as tr
from vilo_bench.entries import fleet as FLEET



def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


STAGE_METRICS = ("proj_jac_device_ms_per_iter",
                 "proj_normal_device_ms_per_iter", "ileg_device_ms_per_iter",
                 "gauge_device_ms_per_iter", "schur_device_ms_per_iter",
                 "lm_update_device_ms_per_iter", "unspanned_device_pct")
COUNTER_METRICS = ("active_window_pct", "accepted_step_pct",
                   "valid_slot_pct")

# one solve of one iteration: an assembly (in the stage spans of
# ops/structured.py and ops/solver.py), a solve step, the LM update and the
# reanchor; kernel k launched at host time 10 k + 2 with correlation id k
SPANS = [
    ("lm_solve", 0, 300),
    ("assemble", 5, 90),
    ("proj_jacobians", 10, 20), ("proj_normal", 30, 10),
    ("proj_normal", 40, 10), ("ileg_factor", 50, 10),
    ("prior_calib", 60, 10), ("gauge_project", 70, 10),
    ("robust_cost", 80, 10),
    ("solve_step", 100, 40),
    ("schur_reduce", 100, 10), ("lane_chol", 110, 10),
    ("back_substitute", 120, 10),
    ("lm_update", 130, 20), ("reanchor", 150, 10),
]
LAUNCHED = {1: 100, 3: 50, 4: 20, 5: 8, 6: 4, 7: 6, 8: 2,      # assembly
            10: 30, 11: 200, 12: 10,                           # solve step
            13: 5, 14: 5, 15: 3,                               # LM update
            16: 40,        # in lm_solve, outside every stage span
            31: 1000}      # after the solve


def events(spans=SPANS):
    ev = [X("user_annotation", "vilo_bench.batch", 0, 1000)]
    ev += [X("user_annotation", n, ts, d) for n, ts, d in spans]
    for k, dur in LAUNCHED.items():
        ev.append(X("cuda_runtime", "cudaLaunchKernel", 10 * k + 2, 1,
                    corr=k))
        ev.append(X("kernel", f"k{k}", 400 + 10 * k, dur, corr=k))
    return ev


def reading(evs, iters=2):
    return FLEET.Reading(tr.from_events(evs), (0.0, 1000.0), iters, 4096,
                         222, "float32")


def read(name, r):
    return harness.metric_reader(name)(r)


def test_stage_metrics_read_the_kernels_launched_in_their_spans():
    r = reading(events())
    ms = lambda us: pytest.approx(us * 1e-3 / 2)
    assert read("proj_jac_device_ms_per_iter", r) == ms(100)
    assert read("proj_normal_device_ms_per_iter", r) == ms(50 + 20)
    assert read("ileg_device_ms_per_iter", r) == ms(8)
    assert read("gauge_device_ms_per_iter", r) == ms(6)
    assert read("schur_device_ms_per_iter", r) == ms(30 + 10)
    assert read("lm_update_device_ms_per_iter", r) == ms(5 + 5 + 3)
    # 40 of the 483 us launched inside lm_solve lie outside every stage
    assert read("unspanned_device_pct", r) == pytest.approx(100 * 40 / 483)


def test_assembly_stages_add_up_to_the_assembly():
    r = reading(events())
    parts = sum(read(n, r) for n in (
        "proj_jac_device_ms_per_iter", "proj_normal_device_ms_per_iter",
        "ileg_device_ms_per_iter", "gauge_device_ms_per_iter"))
    parts += stages.device_ms_per_iter(r, "prior_calib", "robust_cost")
    assert parts == pytest.approx(read("assemble_device_ms_per_iter", r))


def test_a_solve_wholly_in_stages_reads_no_unspanned_time():
    spans = [s for s in SPANS if s[0] != "lm_solve"] + [("lm_solve", 0, 160)]
    assert read("unspanned_device_pct", reading(events(spans))) == 0.0


def test_stage_metrics_read_nothing_without_their_spans():
    old = [s for s in SPANS if s[0] in ("lm_solve", "assemble",
                                        "solve_step")]
    r = reading(events(old))
    assert read("assemble_device_ms_per_iter", r) is not None
    for name in STAGE_METRICS:
        assert read(name, r) is None
        assert read(name, reading(events())._replace(trace=None)) is None


@pytest.fixture
def program_counters(monkeypatch):
    """Plants a loaded program module whose `counters()` returns the dict
    the test fills."""
    values = {}
    mod = types.ModuleType(stages.PROFILING)
    mod.counters = lambda: dict(values)
    monkeypatch.setitem(sys.modules, stages.PROFILING, mod)
    return values


def test_counter_metrics_read_the_programs_counters(program_counters):
    program_counters.update({
        "lm.window_iterations": 4096 * 12,
        "lm.active_window_iterations": 4096 * 9,
        "lm.accepted_steps": 4096 * 6,
        "assemble.slots": 4096 * 160, "assemble.valid_slots": 4096 * 100})
    r = reading(events())
    assert read("active_window_pct", r) == pytest.approx(75.0)
    assert read("accepted_step_pct", r) == pytest.approx(100 * 6 / 9)
    assert read("valid_slot_pct", r) == pytest.approx(62.5)
    assert read("active_window_pct", r._replace(trace=None)) is None


def test_counter_metrics_read_nothing_without_counters(program_counters,
                                                       monkeypatch):
    r = reading(events())
    for name in COUNTER_METRICS:            # no solve was traced
        assert read(name, r) is None
    program_counters.update({"lm.window_iterations": 0,
                             "lm.active_window_iterations": 0})
    assert read("active_window_pct", r) is None
    monkeypatch.delattr(sys.modules[stages.PROFILING],
                        "counters")          # a program without counters
    for name in COUNTER_METRICS:
        assert read(name, r) is None
    monkeypatch.delitem(sys.modules, stages.PROFILING)
    for name in COUNTER_METRICS:
        assert read(name, r) is None
