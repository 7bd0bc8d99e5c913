"""Tracker quality: the OpenCV and the device KLT tracker on rendered
frames of one street run (port of the JAX repo's `evals/diag_tracker.py`).

Each track is tied at its birth to the nearest ideal landmark projection
(within 3 px), and the pixel error of its tracked position against that
landmark's true projection is measured over the track's life: front-end
accuracy apart from the estimator's. Reports features per frame, track
error p50 / p90 and track length p50, per tracker.

  * `ideal_px`: the true left-camera pixel of every landmark in view;
  * `run_tracker`: one tracker over the first `n_frames` camera frames,
    each rendered as it is tracked (the renderer's pixel noise runs on:
    the second tracker sees the same scenes with other noise, as in the
    JAX script);
  * `run`: the simulation (8 s street, 0.75 m/s, seed 77), the renderer,
    and both trackers (`FeatureTracker` needs OpenCV; `DeviceTracker` runs
    on `device`).

The device tracker runs on the card unless `--device cpu` is given; with
no card and no `--device cpu` it raises. `--out FILE` writes the results.

    python -m cerberus_tpu_torch.evals.diag_tracker [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import (ImageRenderer, SimConfig,
                                               simulate)
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
from cerberus_tpu_torch.frontend.tracker import FeatureTracker, PinholeCamera

BIRTH_PX = 3.0


def ideal_px(sim, r, i):
    """{landmark id: true pixel (2,)} for camera frame i (left camera)."""
    k = int(sim["cam_idx"][i])
    Rk = sim["R"][k]
    pk = sim["p"][k]
    ric, tic = r.cfg.ric_tic()
    lm = sim["landmarks"]
    pc = (lm - pk) @ Rk
    pc = (pc - tic[0]) @ ric[0]
    vis = pc[:, 2] > 0.3
    u = r.f * pc[:, 0] / np.where(vis, pc[:, 2], 1.0) + r.cx
    v = r.f * pc[:, 1] / np.where(vis, pc[:, 2], 1.0) + r.cy
    inb = vis & (u >= 0) & (u < r.W) & (v >= 0) & (v < r.H)
    return {j: np.array([u[j], v[j]]) for j in np.nonzero(inb)[0]}


def run_tracker(name, tracker, sim, r, n_frames, f, cx, cy):
    """Features per frame, every tracked error (px) and the track lengths,
    summarized as the script prints them."""
    birth = {}      # track id -> landmark id
    errs = []
    lens = {}
    counts = []
    for i in range(n_frames):
        k = int(sim["cam_idx"][i])
        im0, im1 = r.render_stereo(k)
        out = tracker.track(float(sim["cam_t"][i]), im0, im1)
        counts.append(len(out))
        truth = ideal_px(sim, r, i)
        tp = np.array([truth[j] for j in truth]) if truth else np.zeros((0, 2))
        tids = list(truth)
        for fid, (pt, vel, ptr, velr) in out.items():
            px = np.array([f * pt[0] + cx, f * pt[1] + cy])
            if fid not in birth:
                if len(tp) == 0:
                    continue
                d = np.linalg.norm(tp - px, axis=1)
                j = int(np.argmin(d))
                if d[j] < BIRTH_PX:
                    birth[fid] = tids[j]
                continue
            lmid = birth[fid]
            if lmid in truth:
                errs.append(float(np.linalg.norm(truth[lmid] - px)))
                lens[fid] = lens.get(fid, 0) + 1
    errs = np.array(errs) if errs else np.array([np.nan])
    ln = np.array(list(lens.values())) if lens else np.array([0])
    res = dict(n_feat_p50=float(np.percentile(counts, 50)),
               err_p50=float(np.nanpercentile(errs, 50)),
               err_p90=float(np.nanpercentile(errs, 90)),
               len_p50=float(np.percentile(ln, 50)), counts=counts,
               n_errs=int(np.isfinite(errs).sum()), births=len(birth))
    print(f"{name}: n_feat p50 {res['n_feat_p50']:.0f}  "
          f"track-err px p50 {res['err_p50']:.3f} "
          f"p90 {res['err_p90']:.3f}  "
          f"track len p50 {res['len_p50']:.0f}")
    return res


def run(duration=8.0, speed=0.75, seed=77, max_frames=90, cfg=None,
        device="cuda"):
    """{tracker: run_tracker's numbers} over the first min(camera frames,
    max_frames) frames of the street run, rendered at cfg's image size."""
    cfg = cfg or EstimatorConfig()
    sim = simulate(SimConfig(duration=duration, speed=speed, path="street",
                             seed=seed), est_cfg=cfg)
    r = ImageRenderer(sim, cfg)
    n_frames = min(len(sim["cam_t"]), max_frames)
    cams = [PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
            for _ in range(2)]
    make = {
        "cv": lambda: FeatureTracker(cams[0], cams[1], max_cnt=cfg.max_cnt,
                                     min_dist=cfg.min_dist,
                                     flow_back=cfg.flow_back),
        "device": lambda: DeviceTracker(cams[0], cams[1],
                                        max_cnt=cfg.max_cnt,
                                        min_dist=cfg.min_dist,
                                        flow_back=cfg.flow_back,
                                        device=device)}
    res = dict(frames=n_frames)
    for name in ("cv", "device"):
        res[name] = run_tracker(f"{name:6s}", make[name](), sim, r, n_frames,
                                r.f, r.cx, r.cy)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = dict(run(device=dev), device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
