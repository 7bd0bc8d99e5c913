"""The feature manager's bookkeeping against the truth (port of the JAX
repo's `evals/diag_obs.py`): every stored observation of the streaming
estimator's window, after its first 20 camera frames, against a fresh
projection of the TRUE landmark at the TRUE pose of that window frame. A
mismatch far above the pixel noise (bad: over 3 px) is corrupt
bookkeeping: a wrong frame association, stale data after a slide, or a
recycled slot. Also prints the window's headers and the keyframe count.

  * `drive`: diag_proj's (the estimator fed the first `max_frames` camera
    frames, `diag_util.feed`);
  * `check_observations`: the analysis, from the estimator's state.

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results.

    python -m cerberus_tpu_torch.evals.diag_obs [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse

import numpy as np

from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.evals.diag_proj import drive, make_sim

FOCAL = 460.0
BAD_PX = 3.0


def check_observations(est, sim, frames_fed=None):
    """Every (active slot, window frame) observation against the true
    landmark's projection: observations checked, the bad ones (slot,
    landmark id, frame, error px, true depth), those behind the camera
    (slot, landmark id, frame, depth), the headers and keyframes."""
    ric, tic = est.cfg.ric_tic()
    lm = sim["landmarks"]
    kis = diag_util.window_indices(est, sim)
    fm = est.fm
    bad, behind, tot = [], [], 0
    for s in np.nonzero(fm.active)[0]:
        lid = int(fm.ids[s])
        for fi in range(11):
            if not fm.obs[s, fi]:
                continue
            ki = kis[fi]
            Rwc = sim["R"][ki] @ ric[0]
            twc = sim["R"][ki] @ tic[0] + sim["p"][ki]
            pc = Rwc.T @ (lm[lid] - twc)
            if pc[2] < 0.05:
                behind.append((int(s), lid, fi, float(pc[2])))
                continue
            pred = pc[:2] / pc[2]
            errpx = float(np.linalg.norm(fm.pts[s, fi, :2] - pred) * FOCAL)
            tot += 1
            if errpx > BAD_PX:
                bad.append((int(s), lid, fi, errpx, float(pc[2])))
    return dict(checked=tot, bad=bad, behind=behind,
                headers=[float(h) for h in est.headers],
                frames_fed=frames_fed, keyframes=est.stats["keyframes"])


def print_check(est, res):
    for s, lid, fi, z in res["behind"]:
        print(f"slot {s} lid {lid} frame {fi}: behind camera z={z:.2f}")
    print(f"checked {res['checked']} observations, {len(res['bad'])} bad "
          f"(>3 px)")
    for s, lid, fi, errpx, z in res["bad"][:25]:
        print(f"  slot={s} lid={lid} frame={fi} err_px={errpx:8.2f} "
              f"z_true={z:.2f} start={est.fm.start[s]} "
              f"obs={est.fm.obs[s].astype(int)}")
    print("headers:", [round(h, 3) for h in res["headers"]])
    print("frames fed:", res["frames_fed"], "keyframes:", res["keyframes"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sim = make_sim()
    max_frames = 20
    est = drive(sim, device=dev, max_frames=max_frames)
    res = check_observations(
        est, sim, frames_fed=min(max_frames, len(sim["cam_idx"])))
    print_check(est, res)
    res["device"] = dev.type
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
