"""Multi-device scaling: windows solved per second against mesh size (port
of the JAX repo's `evals/multichip_scaling.py`).

Spreads a batch of full production window solves (structured + Schur +
gauge-projected LM, 12 iterations) over a mesh of 1, 2, 4, 8 devices
(`parallel/mesh.make_mesh`, `parallel/batched.batched_solve`, batch-per-
device windows each) and measures throughput. Each mesh size runs in a
process of its own, so that a size that fails becomes a row with "error";
a size larger than the cards present fails, as the JAX driver's does. No
smaller mesh runs in its place.

On the CPU a mesh of n entries runs its chunks one after another in one
process: its rows check the program, not scaling. On cards, one host
thread dispatches every card's chunk in turn.

Runs on the card unless `--device cpu` is given (no fallback): f32 on the
card, f64 on the CPU. `--out FILE` writes the result; without it no file
is written.

    python -m cerberus_tpu_torch.evals.multichip_scaling [--devices 1,2,4,8] \
        [--batch-per-device 16] [--reps 5] [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from cerberus_tpu_torch.evals.measure import (bench_problem, device_and_dtype,
                                              device_name, launches_since,
                                              make_batch)
from cerberus_tpu_torch.ops import lane_cholesky as lc
from cerberus_tpu_torch.ops.solver import SolveOptions
from cerberus_tpu_torch.parallel.batched import batched_solve
from cerberus_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPTS = SolveOptions(max_iters=12)   # the production options


def mesh_of(n, dev):
    """make_mesh(n) on dev's type; fails unless it has n entries."""
    mesh = make_mesh(n, device=dev.type)
    if len(mesh) != n:
        raise RuntimeError(f"a mesh of {n} devices: only {len(mesh)} present")
    return mesh


def solve_on_mesh(states, datas, mesh, opts=OPTS):
    """The batch solved with one chunk per mesh entry; the new states."""
    return batched_solve(states, datas, mesh=mesh, opts=opts)[0]


def worker_row(n, B, device, reps=5, problem=None):
    """One mesh size: n devices, B windows; (row with the JAX driver's
    keys, the lane kernel's launches and the solves that made them)."""
    dev, dtype = device_and_dtype(device)
    mesh = mesh_of(n, dev)
    states, datas = make_batch(problem or bench_problem(dev, dtype), B)

    def run(sts):
        return float(solve_on_mesh(sts, datas, mesh).p[:, 0, 0].sum())

    before = lc.LAUNCHES_BY_SHAPE.copy()
    run(states)
    times = []
    for i in range(reps):
        sts = states._replace(p=states.p + 1e-7 * i)
        t0 = time.perf_counter()
        run(sts)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    row = {"n": n, "batch": B, "windows_per_s": round(B / dt, 2),
           "latency_ms": round(dt * 1000, 3), "platform": dev.type}
    return row, dict(calls=reps + 1, by_shape=launches_since(before))


def worker(n, B, device, reps):
    """A mesh size in a process of its own: prints its row and launches as
    one JSON line."""
    row, launches = worker_row(n, B, device, reps)
    print(json.dumps({"row": row, "launches": launches}), flush=True)


def run_size(n, B, device, reps, problem=None):
    """(row, launches) of one mesh size: in a child process, or in this one
    when a problem is given (the tests' small windows). A failure is a row
    with "error"."""
    if problem is not None:
        try:
            return worker_row(n, B, device, reps, problem)
        except RuntimeError as e:
            return {"n": n, "error": f"{type(e).__name__}: {e}"[-500:]}, None
    code = ("from cerberus_tpu_torch.evals.multichip_scaling import worker; "
            f"worker({n}, {B}, {device!r}, {reps})")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=1800)
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        out = json.loads(line)
        return out["row"], out["launches"]
    except (json.JSONDecodeError, KeyError):
        return {"n": n, "error": (r.stderr or r.stdout)[-500:]}, None


def main(argv=None, *, problem=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--batch-per-device", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev, _ = device_and_dtype(args.device)
    rows, launches = [], {}
    for n in [int(x) for x in args.devices.split(",")]:
        row, counts = run_size(n, n * args.batch_per_device, args.device,
                               args.reps, problem)
        rows.append(row)
        if counts is not None:
            launches[str(n)] = counts
        print(row, flush=True)
    base = next((r for r in rows if r.get("n") == 1 and "windows_per_s" in r),
                None)
    for r in rows:
        if base and "windows_per_s" in r:
            r["speedup_vs_1dev"] = round(
                r["windows_per_s"] / base["windows_per_s"], 2)
    if dev.type == "cpu":
        note = ("CPU mesh entries run their chunks one after another in one "
                f"process (os.cpu_count={os.cpu_count()}): these rows check "
                "the program; they measure no scaling")
    else:
        note = ("one host thread dispatches every card's chunk in turn "
                "(parallel/batched.py); the solve is host-bound, so more "
                "cards need not scale")
    out = {"rows": rows, "note": note,
           "solver": "structured+schur+gauge, max_iters=12 (production)",
           "device_name": device_name(dev), "_launches": launches}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
