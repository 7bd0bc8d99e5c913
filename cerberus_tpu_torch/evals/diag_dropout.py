"""Which failure check reboots the estimator under an IMU hang (port of the
JAX repo's `evals/diag_dropout.py`, the `imu_dropout_2x1s` robustness
case): the street simulation (seed 31) with the IMU frozen over 1 s at
0.3 and 0.7 of the run, replayed through the estimator; reboots, stale IMU
intervals, the failure reasons, and the position error around each
dropout window and at the end.

  * `make_sim`: the simulation with both dropout windows
    (`robustness.imu_dropout`);
  * `drive`: the replay through a new f64 estimator, watched
    (`robustness.watch`) for its first adopted step on a placeholder
    newest interval: a stale IMU leaves frame 10's speed without
    information, and from that step on the answer is roundoff, so the
    scores of the frames published before it are given beside the whole
    run's;
  * `error_trace`: the analysis, from the replay's positions.

The JAX script runs f32 on a TPU and f64 elsewhere; the port runs f64 on
the card as everywhere. With no card and no `--device cpu` it raises.
`--out FILE` writes the results. The JAX script's knob: the duration in
seconds as the first positional argument (default 60).

    python -m cerberus_tpu_torch.evals.diag_dropout 3 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.replay import replay
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.evals import robustness as rb


def windows(dur):
    """The two 1 s IMU dropout windows."""
    return [(dur * 0.3, dur * 0.3 + 1.0), (dur * 0.7, dur * 0.7 + 1.0)]


def make_sim(dur=60.0):
    sim = simulate(SimConfig(duration=dur, speed=0.5, path="street",
                             seed=31))
    return rb.imu_dropout(sim, windows(dur))


def drive(sim, device="cuda", cfg=None):
    """(estimator, replay dict, watch record)."""
    est = Estimator(cfg or EstimatorConfig(), dtype=torch.float64,
                    device=device)
    seen = rb.watch(est)
    return est, replay(sim, est=est), seen


def error_trace(out, dur):
    """Position error (both tracks from their first sample) sampled every
    third frame from 2 s before to 4 s after each window's start, and every
    fifth of the last 30 frames: lists of (t, err)."""
    t = out["est_t"]
    err = np.linalg.norm(out["est_p"] - out["est_p"][0]
                         - (out["gt_p"] - out["gt_p"][0]), axis=1)
    around = {}
    for t0, _ in windows(dur):
        sel = (t > t0 - 2) & (t < t0 + 4)
        around[t0] = [(float(a), float(b))
                      for a, b in zip(t[sel][::3], err[sel][::3])]
    final = [(float(a), float(b)) for a, b in zip(t[-30::5], err[-30::5])]
    return around, final


def summary(est, out, seen, dur):
    around, final = error_trace(out, dur)
    res = dict(drift_pct=float(out["drift_pct"]),
               ate=float(out["ate_rmse"]), reboots=est.stats["reboots"],
               stale_intervals=est.stats.get("stale_imu_intervals"),
               failure_reasons=[[float(t), r] for t, r in
                                est.stats.get("failure_reasons", [])],
               err_around=around, final_errs=final,
               frames=len(out["est_t"]), solves=est.stats["solves"],
               solves_all=seen["all"] + est.stats["solves"],
               init_solves=est.stats.get("init_solves", 0),
               placeholder_at=seen["placeholder_at"])
    if seen["placeholder_at"] is not None:
        res["before_placeholder"] = rb.before_placeholder(
            out, seen["placeholder_at"])
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("duration", nargs="?", type=float, default=60.0)
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("platform:", dev.type, flush=True)
    dur = args.duration
    res = summary(*drive(make_sim(dur), dev), dur)
    print("drift_pct", round(res["drift_pct"], 4), "ate",
          round(res["ate"], 4), "reboots", res["reboots"],
          "stale_intervals", res["stale_intervals"], flush=True)
    print("failure_reasons:", res["failure_reasons"], flush=True)
    for t0, rows in res["err_around"].items():
        print(f"err around {t0:.0f}s:",
              " ".join(f"{tt:.2f}:{ee:.3f}" for tt, ee in rows), flush=True)
    print("final errs:", " ".join(f"{tt:.1f}:{ee:.3f}"
                                  for tt, ee in res["final_errs"]))
    if res["placeholder_at"] is not None:
        b = res["before_placeholder"]
        print(f"first step on a placeholder interval at "
              f"{res['placeholder_at']:.3f} s: {b['frames']} frames before "
              f"it, drift_pct {b['drift_pct']:.4f} ate {b['ate_rmse']:.4f}")
    res.update(duration=dur, device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
