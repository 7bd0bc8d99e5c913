"""The port's stage spans and work counters on the CPU: one fleet step
(`parallel/fleet.solve_fleet`, the production options) of B = 2 windows at
F = 16 and max_iters = 2 under torch.profiler, its chrome trace read here.

- Each stage span opens the expected number of times a solve, inside
  `lm_solve` (`fleet_score` after it).
- The stage spans partition the solve: no two overlap, and every CPU op
  inside `lm_solve` lies inside one of them. (Entering and leaving
  `torch.func.vmap` around `assemble` records no op of its own here, so
  no op is excepted.)
- `utils/profiling.count` stores nothing without a profiler; under one the
  solve's counters equal what its inputs and `SolveInfo` say.
"""

import bisect
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window_batched
from cerberus_tpu_torch.parallel.fleet import solve_fleet
from cerberus_tpu_torch.utils import profiling

B, F, ITERS = 2, 16, 2
ASSEMBLIES = ITERS + 1
# name -> spans a solve under a profiler
STAGES = {
    "proj_jacobians": ASSEMBLIES,
    "proj_normal": 2 * ASSEMBLIES,
    "ileg_factor": ASSEMBLIES,
    "prior_calib": ASSEMBLIES,
    "gauge_project": ASSEMBLIES,
    "robust_cost": ASSEMBLIES,
    "schur_reduce": ITERS,
    "lane_chol": ITERS,
    "back_substitute": ITERS,
    # before the loop, twice an iteration, and the counters after it
    "lm_update": 2 * ITERS + 2,
    "reanchor": 1,
}
OUTER = {"lm_solve": 1, "assemble": ASSEMBLIES, "solve_step": ITERS,
         "fleet_score": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet_step():
    sim = simulate(SimConfig(duration=2.0, speed=0.5, seed=3,
                             n_landmarks=80))
    data, truth, _ = build_window_from_sim(sim, kf_stride=1, start_cam=2,
                                           F=F, device="cpu")
    truths = fac.map_tensors(lambda x: torch.stack([x] * B), truth)
    states = truths._replace(
        p=truths.p + 0.01 * torch.arange(1, B + 1)[:, None, None])
    datas = fac.map_tensors(lambda x: x.expand((B,) + x.shape), data)
    return states, datas, truths


@pytest.fixture(scope="module")
def traced(fleet_step, tmp_path_factory):
    """(host events of the traced step by name, every cpu op, counters,
    the step's result)."""
    states, datas, truths = fleet_step
    opts = SolveOptions(max_iters=ITERS)
    solve_fleet(states, datas, truths, opts=opts)   # placement matrices
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = solve_fleet(states, datas, truths, opts=opts)
    counts = profiling.counters()
    profiling.reset_counters()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    spans, ops = {}, []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") != "X":
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(iv)
        elif e.get("cat") == "cpu_op":
            ops.append((e["name"], iv))
    return spans, ops, counts, out


@pytest.mark.parametrize("name,n", sorted({**STAGES, **OUTER}.items()))
def test_span_opens_as_often_as_its_stage_runs(traced, name, n):
    spans = traced[0]
    assert len(spans.get(name, [])) == n
    (lo, hi), = spans["lm_solve"]
    inside = [lo <= a and b <= hi for a, b in spans[name]]
    assert all(inside) if name != "fleet_score" else not any(inside)


def test_stage_spans_partition_the_solve(traced):
    spans, ops = traced[0], traced[1]
    (lo, hi), = spans["lm_solve"]
    stages = sorted(iv for n in STAGES for iv in spans[n])
    assert all(b <= a2 for (_, b), (a2, _) in zip(stages, stages[1:]))
    starts = [a for a, _ in stages]
    outside = set()
    n_inside = 0
    for name, (a, b) in ops:
        if not (lo <= a and b <= hi):
            continue
        n_inside += 1
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or b > stages[i][1]:
            outside.add(name)
    assert n_inside > 1000 and not outside, sorted(outside)


def test_counters_hold_the_solves_work(traced, fleet_step):
    counts, out = traced[2], traced[3]
    states, datas, _ = fleet_step
    _, info = solve_window_batched(states, datas,
                                   SolveOptions(max_iters=ITERS))
    assert torch.equal(info.cost, out.cost)
    window_iters = B * ITERS
    assert counts["lm.window_iterations"] == window_iters
    assert counts["assemble.slots"] == B * F
    assert counts["assemble.valid_slots"] == float(datas.f_valid.sum())
    assert counts["lm.accepted_steps"] == float(info.accepted.sum())
    assert 0 < counts["lm.accepted_steps"] \
        <= counts["lm.active_window_iterations"] <= window_iters


def test_converged_windows_leave_the_active_count(fleet_step):
    """With function_tolerance 1 every accepted step converges its window,
    so a window is active at the first iteration only."""
    states, datas, _ = fleet_step
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _, info = solve_window_batched(
            states, datas, SolveOptions(max_iters=ITERS,
                                        function_tolerance=1.0))
    counts = profiling.counters()
    profiling.reset_counters()
    assert info.accepted.tolist() == [1] * B
    assert counts["lm.accepted_steps"] == B
    assert counts["lm.active_window_iterations"] == B
    assert counts["lm.window_iterations"] == B * ITERS


def test_counters_record_nothing_without_a_profiler(fleet_step):
    states, datas, truths = fleet_step
    profiling.reset_counters()
    profiling.count("probe", 1)
    solve_fleet(states, datas, truths, opts=SolveOptions(max_iters=1))
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("probe", 2)
        profiling.count("probe", torch.tensor(3))
    assert profiling.counters() == {"probe": 5.0}
    profiling.reset_counters()
    assert profiling.counters() == {}
