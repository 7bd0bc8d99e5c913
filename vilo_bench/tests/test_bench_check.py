"""The comparison that decides `correct`, through the fleet entry: the plain
reference agrees with the program's `solve_fleet` at a small size on the
CPU, and a run whose timed path is broken underneath comes out not correct,
once for each fault a fleet cell can have (the harness's look for a chip
is skipped): on the CPU at a small size for the float64 cell, and on the
card at their own size for the float32 cells, whose limits hold only there
(the float32 solve agrees with the float32 reference to the rounding of
the card's kernels)."""

import time

import pytest
import torch

from vilo_bench import fleet, harness, scene, spec
from vilo_bench.entries import fleet as FLEET
from vilo_bench.frozen import solver as ref_solver

CELL = "fleet-f64-dense"
SEED = 2 ** 31 + 99


def test_reference_matches_solve_fleet(small):
    cell = spec.load_cell(CELL, small)
    prog = FLEET.Program(cell.cfg)
    dev = torch.device("cpu")
    inputs = FLEET.make_inputs(
        cell.cfg, cell.traffic, SEED, dev, prog,
        simulation=scene.Simulation(cell.cfg, cell.traffic, SEED, workers=0))
    init = fleet.perturbed(inputs.truths, cell.traffic, SEED, 0)
    st, cost0, cost = prog.solve(prog.state(init), inputs.datas,
                                 prog.state(inputs.truths))
    datas = fleet.replicate(inputs.seg_datas, 4, len(inputs.n_valid))
    ref_st, info = ref_solver.solve_windows(
        init, datas, ref_solver.SolveOptions(**cell.cfg["solver"]))
    assert cost0 == pytest.approx(info.cost0, rel=1e-12)
    assert cost == pytest.approx(info.cost, rel=1e-9)
    assert (cost < 1e-6 * cost0).all()          # the solve did its work
    for f in FLEET.STATE_FIELDS:
        assert (getattr(st, f) - getattr(ref_st, f)).abs().max() < 1e-9, f


def unchanged(prog):
    def solve(st, datas, truths):
        _, cost0, _ = prog.solve(st, datas, truths)
        return st, cost0, cost0
    return solve


def half_left_out(prog):
    def solve(st, datas, truths):
        out, cost0, cost = prog.solve(st, datas, truths)
        h = st.p.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:h], b[h:]])
        return (type(out)(*(keep(a, b) for a, b in zip(out, st))), cost0,
                keep(cost, cost0))
    return solve


def altered(prog):
    """One window in 16 answers a position 1 mm off (the check reads a
    sample of each batch: 64 windows)."""
    def solve(st, datas, truths):
        out, cost0, cost = prog.solve(st, datas, truths)
        p = out.p.clone()
        p[::16, 3, 0] += 1e-3
        return out._replace(p=p), cost0, cost
    return solve


def run(small, fault=None):
    cell = spec.load_cell(CELL, small)
    prog = FLEET.Program(cell.cfg)
    return harness.run_cell(
        cell, SEED, 0.0, False, "cpu", time.perf_counter(), program=prog,
        solve=fault(prog) if fault else None,
        simulation=scene.Simulation(cell.cfg, cell.traffic, SEED, workers=0))


def test_a_sound_run_is_correct(small):
    res = run(small)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 4
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"windows_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_timed_path_is_not_correct(small, fault):
    res = run(small, fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, unchanged, half_left_out, altered])
@pytest.mark.parametrize("name", ["fleet-f32-dense", "fleet-f32-dim"])
def test_on_the_card_a_run_is_correct_unless_broken(cuda, name, fault):
    cell = spec.load_cell(name)
    prog = FLEET.Program(cell.cfg)
    res = harness.run_cell(
        cell, SEED, 0.0, False, "cuda:0", time.perf_counter(), program=prog,
        solve=fault(prog) if fault else None)
    assert res["correct"] == (fault is None), res["checks"]
