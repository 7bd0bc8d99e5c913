"""In-loop attribution of the batched LM solve (port of the JAX repo's
`evals/profile_inloop.py`): time the real 12-iteration loop against copies
with one stage stubbed out, all of the same shapes and dispatched the same
way (a stage timed alone is dispatched differently than inside the loop).

Variants (function_tolerance 0: always 12 iterations):
  full        assemble + Schur-Cholesky + retract each iteration
  no_chol     the Schur solve replaced by a diagonal-preconditioned step
  asm_once    the candidate assembly reused from iteration 0 (the loop
              runs solve + retract only)
  full - no_chol = the in-loop Cholesky; full - asm_once = the in-loop
  assembly (x 12/11: 11 of 12 assemblies are stubbed).

Then the production solve (`solve_window_batched`, 12 iterations) across
batch sizes.

Runs on the card unless `--device cpu` is given (no fallback): f32 on the
card, f64 on the CPU. `--out FILE` merges the result into FILE under
"inloop"; without it no file is written.

    python -m cerberus_tpu_torch.evals.profile_inloop [--batch 128] \
        [--batches 128,512,1024] [--reps 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.func import vmap

from cerberus_tpu_torch.device import matmul_precision
from cerberus_tpu_torch.evals.measure import (Timer, bench_problem,
                                              device_and_dtype, device_name,
                                              make_batch)
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.solver import (SolveOptions, _assemble_schur,
                                           _damped_solve_schur,
                                           solve_window_batched)

VARIANTS = ("full", "no_chol", "asm_once")
ITERS = 12


def variant_loop(variant, states, datas, iters=ITERS):
    """The LM loop of `variant` over a batch of windows (leading axis B),
    as the JAX driver's `solve_one` (:87-129) under vmap: exactly `iters`
    iterations, lam divided by 3 or multiplied by 4 unclamped, no
    convergence mask and no re-anchoring. Nothing reads back to the host.
    Returns (states, cost)."""
    opts = SolveOptions(max_iters=iters, function_tolerance=0.0)
    B = states.p.shape[0]
    assemble = vmap(lambda st, d: _assemble_schur(st, d, opts))

    def solve_step(pieces, lam):
        H_pp, H_pd, h_dd, b_p, b_d = pieces
        if variant == "no_chol":
            diag = torch.diagonal(H_pp, dim1=-2, dim2=-1)
            dp = -b_p / torch.clamp(diag, min=1e-8) / (1 + lam[:, None])
            dd = -b_d / torch.clamp(h_dd, min=1e-8) / (1 + lam[:, None])
            return torch.cat([dp, dd], dim=1)
        return _damped_solve_schur(H_pp, H_pd, h_dd, b_p, b_d, lam, opts)

    def pick(ok, a, b):
        return torch.where(ok.reshape((B,) + (1,) * (a.ndim - 1)), a, b)

    with matmul_precision("highest"):
        st = states
        pieces, cost = assemble(st, datas)
        lam = torch.full((B,), opts.lam0, dtype=st.p.dtype,
                         device=st.p.device)
        for _ in range(iters):
            dx = solve_step(pieces, lam)
            mx = torch.amax(torch.abs(dx), dim=1, keepdim=True)
            dx = dx * torch.clamp(opts.step_clip / torch.clamp(mx, min=1e-30),
                                  max=1.0)
            cand = fac.retract(st, dx)
            if variant == "asm_once":
                cand_pieces, new_cost = pieces, cost * 0.999
            else:
                cand_pieces, new_cost = assemble(cand, datas)
            ok = new_cost < cost
            st = fac.WindowState(*(pick(ok, a, b) for a, b in zip(cand, st)))
            pieces = tuple(pick(ok, a, b)
                           for a, b in zip(cand_pieces, pieces))
            lam = torch.where(ok, lam / 3.0, lam * 4.0)
            cost = torch.where(ok, new_cost, cost)
    return st, cost


def make_solver(variant, iters=ITERS):
    """The timed program of a variant: (states, datas) -> the sum over the
    batch of p[0, 0] after `variant_loop`."""
    def solve(states, datas):
        return variant_loop(variant, states, datas, iters)[0].p[:, 0, 0].sum()
    return solve


def production_solve(states, datas):
    """The sweep's timed program: `solve_window_batched` with the
    production options, 12 iterations; the sum of p[0, 0]."""
    st, _ = solve_window_batched(states, datas, SolveOptions(max_iters=ITERS))
    return st.p[:, 0, 0].sum()


def vary_p(args, i):
    """Rep i's inputs: the states' positions moved by 1e-7 (i + 1) m."""
    states, datas = args
    return states._replace(p=states.p + 1e-7 * (i + 1)), datas


def main(argv=None, *, problem=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", default="128,512,1024")
    ap.add_argument("--out", default=None,
                    help="merge the result into this JSON file")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args.device)
    print("platform:", dev.type, flush=True)
    problem = problem or bench_problem(dev, dtype)
    dtype = problem[1].p.dtype
    F = int(problem[1].depth.shape[0])
    timer = Timer(args.reps)

    B = args.batch
    states, datas = make_batch(problem, B)
    t = {v: timer.ms(f"variant_{v}", make_solver(v), states, datas,
                     vary=vary_p, per=(B, "us/window")) for v in VARIANTS}
    chol_ms = t["full"] - t["no_chol"]
    asm_ms = (t["full"] - t["asm_once"]) * 12 / 11   # 11 of 12 stubbed
    print(f"in-loop cholesky: {chol_ms:.1f} ms/solve ({chol_ms / 12:.2f} "
          f"ms/iter); in-loop assembly: {asm_ms:.1f} ms/solve "
          f"({asm_ms / 12:.2f} ms/iter)", flush=True)

    rows = []
    for Bi in [int(x) for x in args.batches.split(",")]:
        sts, dts = make_batch(problem, Bi)
        ms = timer.ms(f"prod_B{Bi}", production_solve, sts, dts,
                      vary=vary_p, per=(Bi, "us/window"))
        rows.append(dict(batch=Bi, ms=round(ms, 3),
                         windows_per_s=round(Bi / ms * 1000, 1)))
        del sts, dts

    result = dict(platform=dev.type, device_name=device_name(dev),
                  dtype=str(dtype).split(".")[-1], batch=B, F=F,
                  variant_full_ms=round(t["full"], 3),
                  variant_no_chol_ms=round(t["no_chol"], 3),
                  variant_asm_once_ms=round(t["asm_once"], 3),
                  inloop_cholesky_ms_per_iter=round(chol_ms / 12, 3),
                  inloop_assembly_ms_per_iter=round(asm_ms / 12, 3),
                  batch_sweep=rows,
                  note="12-iteration loop skeletons dispatched as the "
                       "production loop; full-no_chol = cholesky+triangular "
                       "cost in situ, full-asm_once = assembly cost in situ "
                       "(x12/11)",
                  _launches=timer.launches)
    print(json.dumps(result))
    if args.out:
        existing = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        existing["inloop"] = result
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    return result


if __name__ == "__main__":
    main()
