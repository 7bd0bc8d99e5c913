"""A configuration names the entry that runs its requests: a configuration
whose request is not one fleet solve is added as new files (an entry
module, its configuration, a traffic file, a metric and BENCHMARK.json
entries), with no file that was there edited, and runs end to end through
`harness.run_cell`. An entry that is not there is named before any
simulation starts."""

import functools
import json
import time

import pytest

from vilo_bench import harness, run, scene, spec

SEED = 2 ** 31 + 5

# A chained request that imports no program: each request solves the
# segments' windows from fresh perturbations, then again from that answer,
# with the plain solver. Its check solves request k's chain once more.
TOY_ENTRY = '''
import time
from types import SimpleNamespace

import torch

from vilo_bench import fleet, scene
from vilo_bench.frozen import solver

STEPS = 2


def setup(cell, seed, device, simulation, parts):
    t = time.perf_counter()
    datas, truths, n_valid = scene.build_windows(
        cell.cfg, cell.traffic, simulation.result(), device)
    parts["toy_build_s"] = time.perf_counter() - t
    return Chain(cell, seed, datas, truths)


class Chain:
    def __init__(self, cell, seed, datas, truths):
        self.traffic, self.seed = cell.traffic, seed
        self.datas, self.truths = datas, truths
        self.opts = solver.SolveOptions(**cell.cfg["solver"])
        self.windows = STEPS * truths.p.shape[0]
        self.note = f"steps={STEPS}"

    def chain(self, k):
        st = fleet.perturbed(self.truths, self.traffic, self.seed, k)
        for _ in range(STEPS):
            st, info = solver.solve_windows(st, self.datas, self.opts)
        return st, info

    def request(self, k):
        t = time.perf_counter()
        st, info = self.chain(k)
        s = time.perf_counter() - t
        rec = SimpleNamespace(k=k, seconds=s, dispatch_s=s, p=st.p)
        return rec, (~torch.isfinite(info.cost)).sum()

    def reading(self, trace, window):
        return SimpleNamespace(trace=trace, window=window, steps=STEPS)

    def checked_numbers(self, records, refs):
        gap = max(float((r.p - self.chain(r.k)[0].p).abs().max())
                  for r in records)
        return {f"{ref}.chain_gap": gap for ref in refs}
'''


def add_toy(small, entry="toy_chain"):
    """The toy configuration, its traffic, a metric and their entries,
    added to the small copy; returns the cell's name."""
    b = small / "vilo_bench"
    cfg = json.loads((b / "configs/a1-fleet-f64.json").read_text())
    cfg.update(name="a1-toy", entry=entry)
    cfg["solver"]["max_iters"] = 2
    (b / "configs/a1-toy.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "workloads/fleet-f64-dense.json").read_text())
    traffic["limits"] = {"f64.chain_gap": 0.0}
    (b / "workloads/toy-chain.json").write_text(json.dumps(traffic))
    (b / "metrics/toy_steps.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    bench = json.loads((small / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "a1-toy", "source": "a test",
                             "file": "vilo_bench/configs/a1-toy.json",
                             "reduced": [], "why": "a chained request"})
    bench["workloads"].append({"name": "toy-chain", "config": "a1-toy",
                               "traffic": "toy-chain", "chips": 1,
                               "why": "a request of two chained solves"})
    bench["per_layer"].append({"name": "toy_steps", "unit": "steps",
                               "better": "lower", "source": "program_counter",
                               "layer": "device", "moves": "windows_per_s",
                               "workloads": ["toy-chain"]})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))
    return "toy-chain"


def files(root):
    return {p: p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()
            and p.name != "BENCHMARK.json"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_configuration_with_its_own_request_runs_as_new_files(small,
                                                                 trace):
    before = files(small)
    (small / "vilo_bench/entries/toy_chain.py").write_text(TOY_ENTRY)
    name = add_toy(small)
    after = files(small)
    assert {p: after[p] for p in before} == before

    cell = spec.load_cell(name, small)
    assert cell.entry == small / "vilo_bench/entries/toy_chain.py"
    res = harness.run_cell(
        cell, SEED, 0.0, trace, "cpu", time.perf_counter(),
        simulation=scene.Simulation(cell.cfg, cell.traffic, SEED, workers=0))
    requests = 2 if trace else 1
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == requests * 2 * len(cell.traffic["segments"])
    assert res["checks"] == {"f64.chain_gap": {"value": 0.0, "limit": 0.0},
                             "failed_windows": {"value": 0, "limit": 0}}
    if trace:
        assert res["metrics"] == {"toy_steps": {"value": 2.0,
                                                "unit": "steps"}}
        assert res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {"windows_per_s", "peak_mem_gib",
                                       "setup_s"}


def test_an_unknown_entry_is_named_before_any_simulation_starts(
        small, monkeypatch):
    name = add_toy(small, entry="no_such_entry")
    started = []
    monkeypatch.setattr(spec, "load_cell",
                        functools.partial(spec.load_cell, repo=small))
    monkeypatch.setattr(scene, "Simulation",
                        lambda *a, **k: started.append(a))
    with pytest.raises(FileNotFoundError,
                       match="entries/no_such_entry.py"):
        run.main(["--workload", name, "--seed", "1", "--seconds", "0"])
    assert started == []
