"""Long-horizon drift evaluation (port of the JAX repo's
`evals/long_run.py`): a long simulated walk through the full streaming
VILO pipeline, scored as the reference scores its rosbag runs — drift % of
the distance traveled after gravity-yaw alignment, and ATE.

Modes:
  default            ideal simulated features -> estimator
  --images           rendered stereo images -> KLT front-end -> estimator
                     (the reference's hot path, main.cpp:95-202)
  --tracker device   the port's device KLT tracker instead of OpenCV's
  --loop             the loop-closure back-end off the estimator's
                     keyframes, with loop-corrected drift reported beside
                     the odometric drift on the same keyframes

The estimator runs in f64 on the card unless `--device cpu` is given; with
no card and no `--device cpu` it raises. `--out FILE` merges the result
into FILE under its tag; without it no file is written.

    python -m cerberus_tpu_torch.evals.long_run --images --tracker device \
        --loop --prerender --path figure8 --speed 0.75 --duration 40
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time

import numpy as np

from cerberus_tpu_torch.config import GO1, EstimatorConfig
from cerberus_tpu_torch.data.replay import replay, replay_images, score
from cerberus_tpu_torch.data.simulator import (ImageRenderer,
                                               PrerenderedFrames, SimConfig,
                                               simulate)
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator
from cerberus_tpu_torch.loop.closer import LoopCloser

RETAINED_IMAGES = 32   # rendered left images kept for the loop closer; the
#                        window is 11 frames deep


class RetainedImages:
    """The left images of the latest `depth` rendered frames, by time, for
    the loop closer's keyframes.

    The renderer adds an image as it renders a frame, on the replay's
    worker thread when the front end is pipelined, and alone evicts the
    oldest; the estimator's keyframe_callback takes its keyframe's image on
    the main thread, up to a frame after the window slid. Each step holds
    the lock, so neither thread sees the dict mid-change."""

    def __init__(self, depth: int = RETAINED_IMAGES):
        self.depth = depth
        self._imgs: dict[float, np.ndarray] = {}
        self._lock = threading.Lock()

    def put(self, t, img):
        with self._lock:
            self._imgs[round(float(t), 6)] = img
            while len(self._imgs) > self.depth:
                self._imgs.pop(next(iter(self._imgs)))

    def take(self, t):
        with self._lock:
            return self._imgs.pop(round(float(t), 6), None)


class _LoopRenderer:
    """A renderer that also retains each rendered left image."""

    def __init__(self, inner, t, images: RetainedImages):
        self._r, self._t, self._images = inner, t, images
        for a in ("f", "cx", "cy", "W", "H"):
            setattr(self, a, getattr(inner, a))

    def render_stereo(self, k):
        im0, im1 = self._r.render_stereo(k)
        self._images.put(self._t[k], im0)
        return im0, im1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--path", default="figure8")
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the estimator, tracker and pose graph run "
                         "(f64); no fallback when the card is missing")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--no-leg", action="store_true",
                    help="disable leg-odometry factors (vision+IMU only)")
    ap.add_argument("--no-vision", action="store_true",
                    help="disable vision (IMU+leg only)")
    ap.add_argument("--images", action="store_true",
                    help="render images and run the real KLT front-end")
    ap.add_argument("--tracker", default="cv", choices=["cv", "device"],
                    help="front-end for --images: OpenCV or the device KLT")
    ap.add_argument("--no-predict", action="store_true",
                    help="disable feature prediction seeding")
    ap.add_argument("--no-pipeline-frontend", action="store_true",
                    help="render+track serially with the estimator (A/B of "
                         "the pipelined front-end's one-frame prediction "
                         "lag; slower wall-clock)")
    ap.add_argument("--loop-kf-dist", type=float, default=0.25,
                    help="pose-graph keyframe spacing (m); raise for runs "
                         "long enough to saturate the 2048-node pool")
    ap.add_argument("--loop", action="store_true",
                    help="run loop closure and report corrected drift")
    ap.add_argument("--loop-record", default=None,
                    help="pickle the keyframe record stream for offline "
                         "loop-back-end replay (evals/loop_replay.py)")
    ap.add_argument("--prerender", action="store_true",
                    help="render all frames before the timed replay (a "
                         "robot's camera frames cost the VILO process "
                         "nothing; the software renderer is simulation "
                         "overhead): realtime_factor then measures "
                         "track -> solve -> adopt only")
    ap.add_argument("--robot", default="a1", choices=["a1", "go1"],
                    help="go1 = force-sigmoid contacts (type 2) with leg "
                         "bias fixed, per the reference's Go1 config "
                         "(config/go1_config/hardware_go1_vilo_config.yaml)")
    ap.add_argument("--out", default=None, help="merge the result into this "
                                                "JSON file under its tag")
    ap.add_argument("--tag", default=None)
    return ap.parse_args(argv)


def robot_config(robot: str) -> EstimatorConfig:
    """The default EstimatorConfig, or the Go1's: force-sigmoid contacts
    with the leg bias fixed."""
    cfg = EstimatorConfig()
    if robot == "go1":
        cfg = dataclasses.replace(cfg, robot=GO1, contact_sensor_type=2,
                                  optimize_leg_bias=False)
    return cfg


def make_tracker(kind, renderer, cfg, device, det_stereo=32):
    """The image front end on the renderer's pinhole model: "cv" =
    OpenCV's FeatureTracker on the host, "device" = DeviceTracker on
    `device` with `det_stereo` stereo detections a frame."""
    from cerberus_tpu_torch.frontend.tracker import PinholeCamera
    f = renderer.f
    cams = [PinholeCamera(f, f, renderer.cx, renderer.cy,
                          size=(renderer.W, renderer.H)) for _ in range(2)]
    if kind == "device":
        from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
        return DeviceTracker(cams[0], cams[1], max_cnt=cfg.max_cnt,
                             min_dist=cfg.min_dist, flow_back=cfg.flow_back,
                             det_stereo=det_stereo, device=device)
    from cerberus_tpu_torch.frontend.tracker import FeatureTracker
    return FeatureTracker(cams[0], cams[1], max_cnt=cfg.max_cnt,
                          min_dist=cfg.min_dist, flow_back=cfg.flow_back)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    cfg = robot_config(args.robot)
    sim = simulate(SimConfig(duration=args.duration, speed=args.speed,
                             path=args.path, seed=args.seed), est_cfg=cfg)
    if args.no_leg:
        cfg = dataclasses.replace(cfg, use_leg_odom=False,
                                  optimize_leg_bias=False)
    if args.no_vision:
        sim = dict(sim)
        sim["features"] = [{} for _ in sim["features"]]
    est = Estimator(cfg, device=dev)

    closer = None
    images = RetainedImages()
    if args.loop:
        closer = LoopCloser(cfg, min_kf_dist=args.loop_kf_dist,
                            record=args.loop_record is not None, device=dev)

        def on_keyframe(t, p, q, ids, obs):
            closer.add_keyframe(t, p, q, ids, obs, images.take(t))

        est.keyframe_callback = on_keyframe

    prerender_s = None
    if args.images:
        renderer = ImageRenderer(sim, cfg)
        if args.prerender:
            renderer = PrerenderedFrames(
                renderer, sorted(set(int(i) for i in sim["cam_idx"])),
                progress=True)
            prerender_s = renderer.prerender_s
        tracker = make_tracker(args.tracker, renderer, cfg, dev,
                               int(os.environ.get("CERB_DET_STEREO", "32")))
        if args.loop:
            renderer = _LoopRenderer(renderer, sim["t"], images)
        t0 = time.time()
        out = replay_images(sim, est=est, tracker=tracker, renderer=renderer,
                            csv_path=args.csv,
                            use_prediction=not args.no_predict,
                            pipeline_frontend=not args.no_pipeline_frontend)
    else:
        t0 = time.time()
        out = replay(sim, est=est, csv_path=args.csv)
    wall = time.time() - t0
    n_solves = max(est.stats["solves"], 1)

    result = dict(
        platform=dev.type, dtype=str(est.dtype).removeprefix("torch."),
        robot=args.robot,
        duration_s=args.duration, path=args.path, speed=args.speed,
        images=bool(args.images),
        tracker=args.tracker if args.images else None,
        distance_m=round(out["distance"], 2),
        drift_pct=round(out["drift_pct"], 4),
        final_err_m=round(out.get("final_err", float("nan")), 4),
        ate_rmse_m=round(out["ate_rmse"], 4),
        solves=est.stats["solves"], reboots=est.stats["reboots"],
        keyframes=est.stats["keyframes"],
        mean_solve_ms=round(1000 * est.stats["solve_time"] / n_solves, 1),
        mean_pack_ms=round(1000 * est.stats.get("pack_time", 0.0)
                           / n_solves, 1),
        mean_solve_only_ms=round(1000 * est.stats.get("solve_only_time", 0.0)
                                 / n_solves, 1),
        wall_s=round(wall, 1), realtime_factor=round(args.duration / wall, 2),
    )
    if args.images:
        result["render_ms_per_frame"] = round(out["render_ms_per_frame"], 1)
        result["track_ms_per_frame"] = round(out["track_ms_per_frame"], 1)
        if prerender_s is not None:
            result["prerendered"] = True
            result["prerender_s"] = round(prerender_s, 1)
    if closer is not None:
        if args.loop_record:
            closer.dump_records(args.loop_record)
        closer.finish()
        kf_t = closer.times()
        gt = np.column_stack([np.interp(kf_t, sim["t"], sim["p"][:, i])
                              for i in range(3)])
        m_loop = score(closer.corrected(), gt)
        # odometric drift on the same subsampled keyframe set: the fair
        # baseline for the corrected drift
        m_odo = score(closer.odometric(), gt)
        result["loop"] = dict(
            loops_found=closer.loops_found,
            loops_rejected=closer.loops_rejected,
            rollbacks=closer.pg.stats["rollbacks"],
            pruned_edges=closer.pg.stats["pruned_edges"],
            optimizes=closer.pg.stats["optimizes"],
            best_sim=round(closer.best_sim, 3),
            keyframes=closer.pg.n,
            kf_skipped=closer.kf_skipped,
            corrected_drift_pct=round(m_loop["drift_pct"], 4),
            corrected_ate_m=round(m_loop["ate_rmse"], 4),
            odometric_kf_drift_pct=round(m_odo["drift_pct"], 4),
            odometric_kf_ate_m=round(m_odo["ate_rmse"], 4),
        )
    print(json.dumps(result))
    if args.out:
        existing = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        tag = args.tag or f"{args.path}_{int(args.duration)}s" + \
            ("_img" if args.images else "") + \
            (f"_{args.tracker}" if args.images else "") + \
            ("_loop" if args.loop else "") + \
            (f"_{args.robot}" if args.robot != "a1" else "")
        existing[tag] = result
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    return result


if __name__ == "__main__":
    main()
