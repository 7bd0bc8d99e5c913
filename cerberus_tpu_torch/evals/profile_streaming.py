"""Latency decomposition of the per-frame streaming solve at B = 1 (port of
the JAX repo's `evals/profile_streaming.py`).

Times each sub-program of one window's frame, each rep ending in a value
fetch, and subtracts the null program's roundtrip: the newest interval's
preintegration (S = 48 sequential steps), one structured H/b assembly,
`solve_window` at 1, 2, 4, 8 and 12 iterations (function_tolerance 0) and
their per-iteration slope, and the marginalization of the oldest frame.

Runs on the card unless `--device cpu` is given (no fallback): f32 on the
card, f64 on the CPU. `--out FILE` writes the result; without it no file
is written.

    python -m cerberus_tpu_torch.evals.profile_streaming [--reps 8] \
        [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.device import matmul_precision
from cerberus_tpu_torch.evals.measure import (Timer, bench_problem,
                                              device_and_dtype, device_name)
from cerberus_tpu_torch.ops import marginalize as marg
from cerberus_tpu_torch.ops.preintegration import (PreintParams,
                                                   il_preintegrate)
from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window
from cerberus_tpu_torch.ops.structured import build_normal_equations_blocks

S = 48               # samples of the streaming bucket
SOLVE_ITERS = (1, 2, 4, 8, 12)


def preint_inputs(dev, dtype, S=S):
    """The JAX driver's preintegration inputs (:167-175): numpy
    default_rng(0) normals x 0.1 drawn in the same order (acc + gravity,
    gyr, phi, dphi), 2 ms steps, contacts all on, sample 0 masked, zero
    biases, rho 0.21."""
    rng = np.random.default_rng(0)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    a = lambda *s: t(rng.normal(size=s) * 0.1)
    mask = torch.ones((S,), dtype=torch.bool, device=dev)
    mask[0] = False
    return (torch.full((S,), 0.002, dtype=dtype, device=dev),
            a(S, 3) + t([0.0, 0.0, 9.8]), a(S, 3), a(S, 12), a(S, 12),
            torch.ones((S, 4), dtype=dtype, device=dev), mask,
            torch.zeros(3, dtype=dtype, device=dev),
            torch.zeros(3, dtype=dtype, device=dev),
            torch.full((4,), 0.21, dtype=dtype, device=dev))


def preint(params):
    def run(*x):
        with matmul_precision("highest"):
            return il_preintegrate(*x, params).P
    return run


def assembly(st, data):
    with matmul_precision("highest"):
        return build_normal_equations_blocks(st, data)[0]


def solve(iters):
    """solve_window at exactly `iters` iterations; the new positions."""
    opts = SolveOptions(max_iters=iters, function_tolerance=0.0)
    return lambda st, data: solve_window(st, data, opts)[0].p


def marg_old(st, data):
    """The new prior's J of marginalizing frame 0."""
    return marg.marginalize_old(st, data)[0]


def main(argv=None, *, problem=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args.device)
    cfg = EstimatorConfig()
    data, truth = problem or bench_problem(dev, dtype)
    dtype = truth.p.dtype
    st = truth._replace(p=truth.p + 0.02)
    timer = Timer(args.reps, verbose=False)

    def ms(tag, fn, *xs):
        return round(timer.ms(tag, lambda *a: fn(*a).sum(), *xs), 3)

    out = {"platform": dev.type, "device_name": device_name(dev),
           "F": int(st.depth.shape[0])}
    # null roundtrip: dispatch and fetch of a trivial program
    out["null_roundtrip_ms"] = ms("null", lambda x: x + 1.0,
                                  torch.zeros((4,), dtype=dtype, device=dev))
    params = PreintParams.from_config(cfg, dtype, device=dev)
    out[f"preint_scan_S{S}_ms"] = ms("preint", preint(params),
                                     *preint_inputs(dev, dtype))
    out["assembly_ms"] = ms("assembly", assembly, st, data)
    for it in SOLVE_ITERS:
        out[f"solve_{it}it_ms"] = ms(f"solve_{it}it", solve(it), st, data)
    out["per_iter_ms"] = round(
        (out["solve_12it_ms"] - out["solve_4it_ms"]) / 8.0, 3)
    out["marg_old_ms"] = ms("marg_old", marg_old, st, data)

    null_ms = out["null_roundtrip_ms"]
    out["_device_estimates"] = {
        k.replace("_ms", "_dev_ms"): round(max(v - null_ms, 0.0), 3)
        for k, v in out.items()
        if k.endswith("_ms") and k != "null_roundtrip_ms"
        and isinstance(v, (int, float))}
    out["_launches"] = timer.launches
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
