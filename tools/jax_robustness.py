#!/usr/bin/env python3
"""The JAX package's robustness battery and estimator branch runs on the
CPU: the reference numbers that chip_smoke.py's `robustness` and `estimator
branches` gates are set from.

    python3 tools/jax_robustness.py [--duration 3] [--cases a,b]
        [--branches a,b] [--out build/jax_robustness/results.json]

Runs the JAX driver `evals/robustness.py --platform cpu` in-process on the
chosen cases (default all 12) with the default EstimatorConfig, and the
branch runs of `cerberus_tpu_torch.evals.robustness` (`branch_inputs`,
`drive`: the same inputs and switches) through the JAX package's Estimator
and replay (default all 5). JAX is forced onto the CPU in f64. Each run's
numbers are taken unrounded from its replay, with the estimator's counts
(solves across restarts, stale IMU intervals, when it first adopted a step
on a placeholder newest interval and the scores of the frames before;
`robustness.watch`); one
JSON line a run, and all of them in `--out`. At full width a 3 s run takes
minutes on a CPU, most of it the LM solves; `--cases` and `--branches ""`
split the runs between processes.
"""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the JAX driver points JAX's compilation cache at a directory outside the
# repo unless one is set
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      str(ROOT / "build" / "jax_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

sys.path.insert(0, str(ROOT))

import cerberus_tpu.data.replay as jreplay_mod  # noqa: E402
import cerberus_tpu.estimator.estimator as jest  # noqa: E402
from cerberus_tpu.config import EstimatorConfig  # noqa: E402
from cerberus_tpu.data import SimConfig, simulate  # noqa: E402
from cerberus_tpu_torch.evals import robustness as port  # noqa: E402


def jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_evals_robustness", ROOT / "evals" / "robustness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cases(names, duration, out_path):
    """The JAX driver's main on `names`; returns {name: (entry with
    unrounded numbers, counts)}."""
    made, outs = [], []

    class Recorded(jest.Estimator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen = port.watch(self)
            made.append(self)

    replay = jreplay_mod.replay

    def recorded_replay(*a, **kw):
        outs.append(replay(*a, **kw))
        return outs[-1]

    inner = jest.Estimator
    jest.Estimator, jreplay_mod.replay = Recorded, recorded_replay
    argv = sys.argv
    sys.argv = ["robustness", "--platform", "cpu", "--duration",
                str(duration), "--out", str(out_path), "--cases",
                ",".join(names)]
    try:
        jax_driver().main()
    finally:
        jest.Estimator, jreplay_mod.replay = inner, replay
        sys.argv = argv
    assert jax.devices()[0].platform == "cpu"
    rounded = json.loads(Path(out_path).read_text())
    order = [n for n in rounded if not n.startswith("_")]
    res = {}
    for name, est, out in zip(order, made, outs):
        entry = dict(rounded[name])
        entry.update(drift_pct=float(out["drift_pct"]),
                     ate_rmse=float(out["ate_rmse"]),
                     distance=float(out["distance"]))
        if "td_final_ms" in entry:
            entry["td_final_ms"] = float(est.td) * 1e3
        counts = dict(
            solves_all=est.seen["all"] + est.stats["solves"],
            init_solves=None, keyframes=est.stats.get("keyframes", 0),
            stale_imu_intervals=est.stats.get("stale_imu_intervals", 0),
            placeholder_at=est.seen["placeholder_at"])
        if counts["placeholder_at"] is not None:
            counts["before_placeholder"] = port.before_placeholder(
                out, counts["placeholder_at"])
        res[name] = (entry, counts)
    return res


def run_branches(names, duration):
    res = {}
    for name in names:
        cfg, sim, switches = port.branch_inputs(
            name, duration, EstimatorConfig(), SimConfig, simulate)
        res[name] = port.run_one(jest.Estimator(cfg), sim, switches,
                                 branch=True, replay_fn=jreplay_mod.replay)
        # the JAX estimator does not count its initialization solves
        res[name][1]["init_solves"] = None
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--cases", default=",".join(
        c["name"] for c in port.make_cases(1.0)))
    ap.add_argument("--branches", default=",".join(port.BRANCHES))
    ap.add_argument("--out", default=str(ROOT / "build" / "jax_robustness"
                                         / "results.json"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = {}
    cases = [c for c in args.cases.split(",") if c]
    if cases:
        res.update(run_cases(cases, args.duration,
                             out.with_suffix(".driver.json")))
    res.update(run_branches([b for b in args.branches.split(",") if b],
                            args.duration))
    for name, (entry, counts) in res.items():
        print(json.dumps({"run": name, **entry, "counts": counts}))
    out.write_text(json.dumps(
        {"_meta": dict(platform="cpu", x64=True, duration_s=args.duration,
                       wall_s=time.perf_counter() - t0),
         **{k: dict(v[0], counts=v[1]) for k, v in res.items()}}, indent=1))
    print(json.dumps(dict(wall_s=time.perf_counter() - t0, out=str(out))))


if __name__ == "__main__":
    main()
