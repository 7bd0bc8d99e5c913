"""Profile the batched window solve (bench.py's B = 128 product) and
attribute the per-window time: assembly vs Schur-Cholesky vs retract vs
loop overhead (port of the JAX repo's `evals/profile_batched.py`).

Each stage of the LM iteration is timed alone at the same batch size, with
each rep ending in a value fetch and inputs varied between reps; the
null roundtrip (one trivial op and its fetch) is subtracted per stage.
`--trace DIR` also writes a torch.profiler trace of three full solves
(`utils/profiling.trace`).

Runs on the card unless `--device cpu` is given (no fallback): f32 on the
card, f64 on the CPU. `--out FILE` writes the result; without it no file
is written.

    python -m cerberus_tpu_torch.evals.profile_batched [--batch 128] \
        [--trace DIR] [--reps 10] [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.func import vmap

from cerberus_tpu_torch.device import matmul_precision
from cerberus_tpu_torch.evals.measure import (Timer, bench_problem,
                                              device_and_dtype, device_name,
                                              make_batch, nudge)
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.solver import (SolveOptions, _assemble_schur,
                                           _damped_solve_schur,
                                           solve_window_batched)
from cerberus_tpu_torch.utils.profiling import trace

OPTS = SolveOptions(max_iters=12)


def scalar_of(tree):
    """The sum of every floating tensor of tree (nested tuples): one
    scalar to fetch."""
    if isinstance(tree, tuple):
        return sum(scalar_of(x) for x in tree)
    return tree.sum() if tree.is_floating_point() else 0.0


def null_program(x):
    return x.sum() + 1.0


def full_solve(states, datas):
    """The production solve, 12 iterations; the sum of p[0, 0]."""
    return solve_window_batched(states, datas, OPTS)[0].p[:, 0, 0].sum()


def assemble_once(states, datas):
    """One assembly of every window: the Schur blocks (H_pp, H_pd, h_dd,
    b_p, b_d), gauge-projected, and the robust cost."""
    pieces, cost = vmap(lambda s, d: _assemble_schur(s, d, OPTS))(states,
                                                                  datas)
    return pieces + (cost,)


def schur_once(H_pp, H_pd, h_dd, b_p, b_d, lam):
    """One damped Schur-Cholesky solve of every window's cached pieces."""
    return _damped_solve_schur(H_pp, H_pd, h_dd, b_p, b_d, lam, OPTS)


def retract_once(states, dx):
    return fac.retract(states, dx)


def vary_all(args, i):
    """Rep i's inputs: every floating input moved by 1e-7 (i + 1)."""
    return tuple(nudge(a, 1e-7 * (i + 1)) if isinstance(a, tuple)
                 else (a + 1e-7 * (i + 1) if a.is_floating_point() else a)
                 for a in args)


def main(argv=None, *, problem=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--trace", default=None,
                    help="torch.profiler trace output dir")
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args.device)
    print("platform:", dev.type, flush=True)
    problem = problem or bench_problem(dev, dtype)
    dtype = problem[1].p.dtype
    B = args.batch
    states, datas = make_batch(problem, B)
    timer = Timer(args.reps)
    per = (B, "us/window")

    with matmul_precision("highest"):
        # null roundtrip: the per-dispatch latency floor
        t_null = timer.ms("null_roundtrip", null_program,
                          torch.zeros((4,), dtype=dtype, device=dev),
                          vary=vary_all, per=per)
        t_full = timer.ms("full_solve_12it", full_solve, states, datas,
                          vary=vary_all, per=per)
        t_asm = timer.ms("assembly_x1",
                         lambda s, d: scalar_of(assemble_once(s, d)),
                         states, datas, vary=vary_all, per=per)
        pieces = assemble_once(states, datas)[:5]
        lam = torch.full((B,), 1e-4, dtype=dtype, device=dev)
        t_sch = timer.ms("schur_cholesky_x1",
                         lambda *p: schur_once(*p).sum(), *pieces, lam,
                         vary=vary_all, per=per)
        dx = schur_once(*pieces, lam)
        t_ret = timer.ms("retract_x1",
                         lambda s, d: scalar_of(retract_once(s, d)),
                         states, dx, vary=vary_all, per=per)

        # the 12-iteration extrapolation against the measured solve is the
        # loop's overhead; each stage alone pays the roundtrip that the
        # solve pays once, so t_null comes off each
        per_iter = (t_asm - t_null) + (t_sch - t_null) + (t_ret - t_null)
        overhead = (t_full - t_null) - 12 * per_iter

    result = dict(
        platform=dev.type, device_name=device_name(dev),
        dtype=str(dtype).split(".")[-1], batch=B, reps=args.reps,
        null_roundtrip_ms=round(t_null, 3),
        full_solve_ms=round(t_full, 3),
        per_window_us=round(t_full / B * 1000, 1),
        assembly_ms_per_iter=round(t_asm - t_null, 3),
        schur_cholesky_ms_per_iter=round(t_sch - t_null, 3),
        retract_ms_per_iter=round(t_ret - t_null, 3),
        extrapolated_12it_ms=round(12 * per_iter, 3),
        residual_overhead_ms=round(overhead, 3),
        note="stage times (null roundtrip subtracted), each alone at the "
             "same B; residual = (full-null) - 12*(asm+schur+retract): "
             "loop bookkeeping, cost-compare/select",
        _launches=timer.launches,
    )
    if args.trace:
        with trace(args.trace):
            for i in range(3):
                float(full_solve(states._replace(p=states.p + 1e-7 * i),
                                 datas))
        result["trace_dir"] = args.trace
        print("trace written to", args.trace, flush=True)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
