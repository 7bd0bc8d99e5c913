"""Does online extrinsic estimation hurt? (port of the JAX repo's
`evals/diag_ex.py`): replay accuracy with `estimate_extrinsic` on and off,
and on without vision, with the camera extrinsics' drift from their
nominal values and the window's inverse-depth statistics.

  * `replay_variant`: the run, one `replay` of the simulation through a
    new f64 estimator (the features withheld when `vision` is False);
  * `extrinsic_drift`: the analysis, from the estimator's state and the
    replay's scores.

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results. The JAX
script's knobs: `DIAG_DUR` (simulated seconds, default 8.0) and
`DIAG_FRAMES` (camera frames replayed, default 999: all).

    DIAG_FRAMES=14 python -m cerberus_tpu_torch.evals.diag_ex \
        [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.replay import replay
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator, _quat_to_rot_np
from cerberus_tpu_torch.evals import diag_util

# (estimate_extrinsic, vision), in the JAX script's order
VARIANTS = ((True, True), (False, True), (True, False))


def make_sim(duration=8.0, speed=0.5, seed=5):
    return simulate(SimConfig(duration=duration, speed=speed, seed=seed))


def replay_variant(sim, est_ex, vision, max_frames=999, device="cuda",
                   base_cfg=None):
    """(estimator, replay dict) of one variant."""
    cfg = dataclasses.replace(base_cfg or EstimatorConfig(),
                              estimate_extrinsic=est_ex)
    est = Estimator(cfg, dtype=torch.float64, device=device)
    if not vision:
        sim = dict(sim, features=[{} for _ in sim["features"]])
    return est, replay(sim, est=est, max_frames=max_frames)


def extrinsic_drift(est, out):
    """Scores, |tic - nominal| and the rotation angle from nominal (deg)
    of both cameras, and the positive inverse depths' median / min / max /
    count (None when there are none)."""
    ric, tic = est.cfg.ric_tic()
    dtic = np.linalg.norm(est.tic - tic, axis=1)
    dang = [float(np.degrees(np.arccos(np.clip(
        (np.trace(_quat_to_rot_np(est.qic[i]) @ ric[i].T) - 1) / 2, -1, 1))))
        for i in range(2)]
    d = est.fm.depth[est.fm.active & (est.fm.depth > 0)]
    depths = dict(med=float(np.median(d)), min=float(d.min()),
                  max=float(d.max()), n=int(len(d))) if len(d) else None
    return dict(ate=float(out["ate_rmse"]), drift_pct=float(out["drift_pct"]),
                dist=float(out["distance"]), dtic=dtic, dang_deg=dang,
                inv_depths=depths, keyframes=est.stats["keyframes"],
                solves=est.stats["solves"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dur = float(os.environ.get("DIAG_DUR", "8.0"))
    maxf = int(os.environ.get("DIAG_FRAMES", "999"))
    sim = make_sim(dur)
    res = dict(duration=dur, frames=maxf, device=dev.type)
    for est_ex, vision in VARIANTS:
        print(f"--- estimate_extrinsic={est_ex} vision={vision}", flush=True)
        r = extrinsic_drift(*replay_variant(sim, est_ex, vision, maxf, dev))
        print(f"estimate_extrinsic={est_ex} vision={vision}: "
              f"ate={r['ate']:.5f} "
              f"drift%={r['drift_pct']:.3f} dist={r['dist']:.3f}")
        print(f"  extrinsic drift: |dt|={r['dtic']} dang_deg={r['dang_deg']}")
        d = r["inv_depths"]
        if d:
            print(f"  inv depths: med={d['med']:.4f} min={d['min']:.4f} "
                  f"max={d['max']:.4f} n={d['n']}")
        res[f"ex={est_ex},vision={vision}"] = r
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
