"""Micro-profile of the batched window solve: which stage dominates? (port
of the JAX repo's `evals/profile_solver.py`).

Times (median of reps, each ending in a value fetch) of programs over B
windows (environment variable B, default 128; every window the benchmark
window's truth): the full solve at 12 and at 1 iteration, the dense
(222 + F)-dim assembly, that assembly plus its damped Cholesky solve (the
lane kernel at (B, 222 + F)), the robust cost, the gauge basis's QR, and one
iteration of the dense-Jacobian (jacfwd) solve. That last one may run out
of memory at a large B; it is then recorded as "failed: <Type>".

Runs on the card unless `--device cpu` is given (no fallback): f32 on the
card, f64 on the CPU. `--out FILE` writes the result; without it no file
is written.

    B=128 python -m cerberus_tpu_torch.evals.profile_solver [--reps 6] \
        [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.func import vmap

from cerberus_tpu_torch.device import matmul_precision
from cerberus_tpu_torch.evals.measure import (Timer, bench_problem, broadcast,
                                              device_and_dtype, device_name)
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.marginalize import _gauge_null_basis
from cerberus_tpu_torch.ops.solver import (SolveOptions, _damped_solve, _lm,
                                           solve_window_batched)
from cerberus_tpu_torch.ops.structured import build_normal_equations


def solve_p00(iters):
    """The production solve at `iters` iterations: p[0, 0] per window."""
    def solve(states, datas):
        st, _ = solve_window_batched(states, datas,
                                     SolveOptions(max_iters=iters))
        return st.p[:, 0, 0]
    return solve


def assembly(states, datas):
    """The dense (222 + F)-dim H of every window; H[0, 0] per window."""
    return vmap(lambda s, d: build_normal_equations(s, d)[0][0, 0])(states,
                                                                   datas)


def assembly_chol(states, datas):
    """The dense assembly, then `_damped_solve` at lam 1e-4 (the lane
    kernel at (B, 222 + F)); dx[0] per window."""
    H, b, _ = vmap(build_normal_equations)(states, datas)
    lam = torch.full((H.shape[0],), 1e-4, dtype=H.dtype, device=H.device)
    return _damped_solve(H, b, lam, SolveOptions())[:, 0]


def cost(states, datas):
    """The robust cost of every window at its state."""
    F = states.depth.shape[-1]
    dim = fac.tangent_dim(F)
    return vmap(lambda s, d: fac.robust_cost(fac.window_residuals(
        s, torch.zeros(dim, dtype=s.p.dtype, device=s.p.device), d), F))(
            states, datas)


def gauge_qr(states, datas):
    """The QR of every window's gauge basis; Q[0, 0] per window."""
    dim = fac.tangent_dim(states.depth.shape[-1])
    N = vmap(lambda s: _gauge_null_basis(s, dim))(states)
    return torch.linalg.qr(N).Q[:, 0, 0]


def dense1(states, datas):
    """One LM iteration of the dense-Jacobian path (J by jacfwd of
    `factors.linearize`, J^T J, the full system through the lane kernel);
    p[0, 0] per window. `solve_window_batched` takes the production
    options only, so this calls the loop as `solve_window` does."""
    with matmul_precision("highest"):
        st, _ = _lm(states, datas, SolveOptions(max_iters=1,
                                                structured=False))
    return st.p[:, 0, 0]


PROGRAMS = {"solve12": solve_p00(12), "solve1": solve_p00(1),
            "assembly": assembly, "assembly+chol": assembly_chol,
            "cost": cost, "gaugeQR": gauge_qr}


def main(argv=None, *, problem=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args.device)
    data, truth = problem or bench_problem(dev, dtype)
    B = int(os.environ.get("B", "128"))
    states, datas = broadcast(truth, B), broadcast(data, B)
    timer = Timer(args.reps, verbose=False)

    def ms(name, fn):
        return round(timer.ms(name, lambda s, d: fn(s, d).sum(), states,
                              datas), 3)

    out = {"platform": dev.type, "device_name": device_name(dev), "B": B,
           "F": int(truth.depth.shape[0])}
    with matmul_precision("highest"):
        for name, fn in PROGRAMS.items():
            out[f"{name}_ms"] = ms(name, fn)
        try:
            out["dense1_ms"] = ms("dense1", dense1)
        except RuntimeError as e:   # the dense path may run out of memory
            out["dense1_ms"] = f"failed: {type(e).__name__}"
            torch.cuda.empty_cache()
    out["_launches"] = timer.launches
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
