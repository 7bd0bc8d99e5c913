"""Replay driver: stream a simulated sequence or a logged dataset through
the estimator and score the trajectory (port of
`cerberus_tpu/data/replay.py`: `replay`, `replay_images`, `score`, `_PyCsv`
and the command line `_main`).

`replay` streams the simulator's output sample by sample through
`Estimator` (500 Hz IMU+leg ticks, ideal stereo features at each camera
frame); `replay_images` renders the stereo images and runs a feature
tracker on them instead — the reference's actual hot path. Either may run
the legged EKF beside the estimator (contact source 0). The trajectory is
scored against ground truth: ATE RMSE and drift % of the distance traveled.

    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.replay import replay
    out = replay(simulate(SimConfig(duration=3.0, seed=5)), max_frames=20,
                 device="cpu")   # or the default "cuda"

From the shell, a schema-v1 dataset (data/log_adapter.py) on the card:

    python -m cerberus_tpu_torch.data.replay --dataset DIR --images \
        --csv out.csv --metrics metrics.jsonl --max-frames 20
"""

from __future__ import annotations

import os
import time

import numpy as np

from cerberus_tpu_torch import native
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.estimator.estimator import Estimator

CSV_HEADER = ("t_ns,px,py,pz,vx,vy,vz,kf_px,kf_py,kf_pz,kf_vx,kf_vy,kf_vz,"
              "gt_x,gt_y,gt_z,rho1,rho2,rho3,rho4")


def _proprio_tick(est, ekf, sim, k):
    """One 500 Hz sample k: the EKF first (if any), then the estimator with
    the contact source of its config (reference: main.cpp:319-330 switch on
    CONTACT_SENSOR_TYPE): 0 = EKF contact probabilities (with `ekf`),
    2 = raw foot force (the preintegration's sigmoid contact model), else
    the simulated (plan) contacts."""
    t = sim["t"]
    if ekf is not None:
        if not ekf.is_inited():
            ekf.init_filter(t[k], sim["acc"][k], sim["gyr"][k], sim["phi"][k])
        else:
            ekf.update_filter(t[k], sim["acc"][k], sim["gyr"][k],
                              sim["phi"][k], dphi=sim["dphi"][k],
                              foot_force=sim["foot_forces"][k])
    ctype = est.cfg.contact_sensor_type
    if ctype == 0 and ekf is not None and ekf.is_inited():
        contact = ekf.get_contacts()
    elif ctype == 2:
        contact = sim["foot_forces"][k]
    else:
        contact = sim["contacts"][k]
    est.input_imu_leg(t[k], sim["acc"][k], sim["gyr"][k], sim["phi"][k],
                      sim["dphi"][k], contact)


class _Trajectory:
    """The published NON_LINEAR poses of a replay, and its CSV rows (written
    by the native CsvWriter when the estimator runs the native sync, as the
    JAX package writes them when its library is built; the same bytes)."""

    def __init__(self, csv_path, est):
        self.t, self.p, self.q, self.gt = [], [], [], []
        self.writer = None
        if csv_path:
            self.writer = (native.CsvWriter(csv_path, CSV_HEADER)
                           if est.use_native else _PyCsv(csv_path, CSV_HEADER))

    def after_frame(self, est, ekf, sim, k):
        if est.solver_flag != Estimator.NON_LINEAR:
            return
        p, q = est.pose
        self.t.append(sim["t"][k])
        self.p.append(p)
        self.q.append(q)
        gt_k = sim["p"][k] if "p" in sim else np.full(3, np.nan)
        self.gt.append(gt_k)
        if self.writer is not None:
            kf = (ekf.get_state()[:6] if ekf is not None and ekf.is_inited()
                  else np.zeros(6))
            self.writer.row([sim["t"][k] * 1e9, *p, *est.velocity, *kf[0:3],
                             *kf[3:6], *gt_k, *est.rho[-1]])

    def result(self, est, **extra):
        if self.writer is not None:
            self.writer.close()
        est_p = np.array(self.p) if self.p else np.zeros((0, 3))
        gt_p = np.array(self.gt) if self.gt else np.zeros((0, 3))
        return dict(est_t=np.array(self.t), est_p=est_p, est_q=self.q,
                    gt_p=gt_p, estimator=est, **extra, **score(est_p, gt_p))


def replay(sim: dict, cfg: EstimatorConfig | None = None,
           est: Estimator | None = None, max_frames: int | None = None,
           csv_path: str | None = None, ekf=None, device="cuda") -> dict:
    """Feed simulator output through the estimator (a new one on `device`
    unless `est` is given).

    Returns dict with est_t, est_p, est_q, gt_p, ate_rmse, drift_pct,
    distance, and the estimator instance. With csv_path set, writes the
    reference's 20-column result schema (reference: main.cpp:152-197):
    [t_ns, p_wr(3), v_wr(3), ekf_pos(3), ekf_vel(3), gt_pos(3), rho(4)].
    If `ekf` (LeggedEKF) is given it is run alongside at sensor rate and its
    state fills columns 8-13 (else zeros).
    """
    est = est or Estimator(cfg, device=device)
    t = sim["t"]
    if "cam_idx" not in sim:
        # proprioception-only log: synthesize the keyframe clock at the
        # camera rate so the IMU+leg window pipeline still runs
        rate = float(sim.get("meta", {}).get("cam_rate", 15.0)) or 15.0
        cam_t = np.arange(t[0], t[-1], 1.0 / rate)
        sim = dict(sim, cam_t=cam_t,
                   cam_idx=np.clip(np.searchsorted(t, cam_t), 0, len(t) - 1))
    if "features" not in sim:
        sim = dict(sim, features=[{} for _ in sim["cam_idx"]])
    cam_idx = set(int(i) for i in sim["cam_idx"])
    cam_lookup = {int(k): f for k, f in zip(sim["cam_idx"], sim["features"])}
    if max_frames is not None:
        cam_idx = set(sorted(cam_idx)[:max_frames])

    traj = _Trajectory(csv_path, est)
    for k in range(len(t)):
        _proprio_tick(est, ekf, sim, k)
        if k in cam_idx:
            est.input_image(t[k], cam_lookup[k])
            traj.after_frame(est, ekf, sim, k)
    est.flush()   # adopt the dispatched step of the last frame
    return traj.result(est)


def replay_images(sim: dict, cfg=None, est: Estimator | None = None,
                  tracker=None, renderer=None, max_frames: int | None = None,
                  csv_path: str | None = None, ekf=None,
                  use_prediction: bool = True,
                  pipeline_frontend: bool = True, device="cuda") -> dict:
    """Full-pipeline replay: rendered stereo images -> feature tracker ->
    estimator — the reference's actual hot path (main.cpp:95-133
    sync_process -> inputImage -> trackImage -> processMeasurements),
    which plain `replay()` bypasses by injecting ideal features. A new
    estimator is made on `device` unless `est` is given.

    tracker: FeatureTracker or DeviceTracker (anything with
      .track(t, img0, img1) -> feature dict and .set_prediction(pixels)).
      Defaults to a DeviceTracker on the estimator's device with the
      renderer's pinhole model; the OpenCV front-end (FeatureTracker) runs
      only when passed.
    renderer: ImageRenderer (built from sim when None) or PrerenderedFrames.
    use_prediction: seed each track with the estimator's predicted pixels
      of the tracked features; False gives the estimator no
      predict_callback, so the tracker runs unseeded.
    pipeline_frontend: render+track frame k+1 on a worker thread while the
      estimator's deferred step of frame k completes — the reference's own
      thread split (sync_process tracks while processMeasurements
      optimizes, main.cpp:478 + estimator.cpp:133-137). Prediction seeds
      then lag one extra frame (~3 px at walking speed).

    Returns replay()'s dict plus the tracker, render_ms_per_frame and
    track_ms_per_frame (host wall time per camera frame).
    """
    from cerberus_tpu_torch.data.simulator import ImageRenderer

    est = est or Estimator(cfg, device=device)
    if renderer is None:
        renderer = ImageRenderer(sim, est.cfg)
    if tracker is None:
        from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
        from cerberus_tpu_torch.frontend.tracker import PinholeCamera
        cam = PinholeCamera(renderer.f, renderer.f, renderer.cx, renderer.cy,
                            size=(renderer.W, renderer.H))
        tracker = DeviceTracker(cam, cam, max_cnt=est.cfg.max_cnt,
                                min_dist=est.cfg.min_dist,
                                flow_back=est.cfg.flow_back,
                                device=est.device)

    if use_prediction:
        # estimator cam-frame predictions -> pixel seeds for the next track
        # (reference: predictPtsInNextFrame -> setPrediction,
        # estimator.cpp:1694-1739 + feature_tracker.cpp:501-518). One
        # constant-velocity step, as the JAX package measured best;
        # CERB_PREDICT_STEPS overrides it for experiments, as there.
        est.predict_steps = int(os.environ.get("CERB_PREDICT_STEPS", "1"))
        f, cx, cy = renderer.f, renderer.cx, renderer.cy

        def _seed(pred_cam: dict):
            px = {}
            for fid, pc in pred_cam.items():
                if pc[2] > 0.1:
                    px[fid] = np.array([f * pc[0] / pc[2] + cx,
                                        f * pc[1] / pc[2] + cy])
            tracker.set_prediction(px)

        est.predict_callback = _seed

    t = sim["t"]
    cam_idx = set(int(i) for i in sim["cam_idx"])
    if max_frames is not None:
        cam_idx = set(sorted(cam_idx)[:max_frames])

    def produce(k):
        t0 = time.perf_counter()
        img0, img1 = renderer.render_stereo(k)
        t1 = time.perf_counter()
        feats = tracker.track(t[k], img0, img1)
        return feats, (t1 - t0) * 1000, (time.perf_counter() - t1) * 1000

    traj = _Trajectory(csv_path, est)
    track_ms = render_ms = 0.0
    cam_order = sorted(cam_idx)
    nxt = {cam_order[i]: cam_order[i + 1] for i in range(len(cam_order) - 1)}
    pool = fut = None
    if pipeline_frontend and cam_order:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(produce, cam_order[0])
    try:
        for k in range(len(t)):
            _proprio_tick(est, ekf, sim, k)
            if k not in cam_idx:
                continue
            if fut is not None:
                feats, r_ms, tk_ms = fut.result()
                # start the NEXT frame's render+track before the estimator
                # blocks on its deferred fetch — front end and back end
                # overlap like the reference's sync_process/processThread
                if k in nxt:
                    fut = pool.submit(produce, nxt[k])
            else:
                feats, r_ms, tk_ms = produce(k)
            render_ms += r_ms
            track_ms += tk_ms
            est.input_image(t[k], feats)
            traj.after_frame(est, ekf, sim, k)
        est.flush()   # adopt the dispatched step of the last frame
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    n_frames = max(len(cam_idx), 1)
    return traj.result(est, tracker=tracker,
                       render_ms_per_frame=render_ms / n_frames,
                       track_ms_per_frame=track_ms / n_frames)


class _PyCsv:
    """CSV writer of the replay's result rows."""

    def __init__(self, path, header):
        self.f = open(path, "w")
        self.f.write(header + "\n")

    def row(self, vals):
        self.f.write(",".join(f"{v:.9g}" for v in vals) + "\n")

    def close(self):
        self.f.close()


def score(est_p: np.ndarray, gt_p: np.ndarray) -> dict:
    """ATE/drift after 4-DoF alignment: first position + optimal yaw.

    Yaw is a gauge freedom of VIO/VILO — the estimator zeroes its initial
    yaw (g2R, reference: estimator.cpp:524-544) while ground truth starts at
    an arbitrary heading, so a rotation about gravity is aligned before the
    errors are computed (the TUM/EVO 4-DoF ATE convention for VIO)."""
    if len(est_p) < 2:
        return dict(ate_rmse=np.inf, drift_pct=np.inf, distance=0.0)
    if not np.all(np.isfinite(gt_p)):
        # a log without ground truth: the replay runs, accuracy is unscorable
        return dict(ate_rmse=np.nan, drift_pct=np.nan, distance=np.nan,
                    final_err=np.nan)
    # planar callers: pad each array to 3-D based on its own width
    if est_p.shape[1] == 2:
        est_p = np.column_stack([est_p, np.zeros(len(est_p))])
    if gt_p.shape[1] == 2:
        gt_p = np.column_stack([gt_p, np.zeros(len(gt_p))])
    if not est_p.shape[1] == gt_p.shape[1] == 3:
        raise ValueError(f"score(): shape mismatch est {est_p.shape} "
                         f"vs gt {gt_p.shape}")
    a = est_p - est_p[0]
    b = gt_p - gt_p[0]
    # closed-form yaw Procrustes about z: maximize sum of planar dot products
    num = float(np.sum(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]))
    den = float(np.sum(a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]))
    th = np.arctan2(num, den)
    c, s = np.cos(th), np.sin(th)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    err = a @ Rz.T - b
    ate = float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))
    dist = float(np.sum(np.linalg.norm(np.diff(gt_p, axis=0), axis=1)))
    final_err = float(np.linalg.norm(err[-1]))
    drift = 100.0 * final_err / max(dist, 1e-9)
    return dict(ate_rmse=ate, drift_pct=drift, distance=dist,
                final_err=final_err, yaw_align_deg=float(np.degrees(th)))


def _main(argv=None):
    """CLI replay driver — the reference's `roslaunch vilo run_*_bag_vilo`
    equivalent (launch/dataset/*.launch): stream a logged dataset (or a
    synthetic run) through the full estimator, f64, on the card (or the CPU
    when asked), and report drift/ATE as one JSON line. Returns replay()'s
    (or replay_images()') dict.

    Examples (python -m cerberus_tpu_torch.data.replay ...):
      ... --dataset /data/street_v1 --images
      ... --sim 30 --path street --csv out.csv --device cpu
    """
    import argparse
    import json

    from cerberus_tpu_torch.config import load_yaml

    ap = argparse.ArgumentParser(description=_main.__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="schema-v1 dataset directory "
                                       "(data/log_adapter.py)")
    src.add_argument("--sim", type=float, metavar="SECONDS",
                     help="synthetic run of this duration instead of a log")
    ap.add_argument("--config", help="reference-style YAML config "
                                     "(defaults to A1-shaped defaults)")
    ap.add_argument("--path", default="street", help="--sim trajectory shape")
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--images", action="store_true",
                    help="run the image front-end (dataset: cam.csv images; "
                         "sim: rendered stereo) instead of ideal features")
    ap.add_argument("--tracker", default="device", choices=["cv", "device"],
                    help="device: DeviceTracker on --device; cv: OpenCV's "
                         "FeatureTracker on the host")
    ap.add_argument("--focal", type=float, default=460.0,
                    help="dataset image focal length (px)")
    ap.add_argument("--csv", help="write the 20-column result CSV")
    ap.add_argument("--metrics", help="write a JSONL metrics stream")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the estimator and tracker run (f64); no "
                         "fallback when the card is missing")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config) if args.config else EstimatorConfig()
    est = Estimator(cfg, device=args.device)
    if args.metrics:
        from cerberus_tpu_torch.utils.metrics import MetricsLogger
        est.metrics = MetricsLogger(args.metrics)

    renderer = None
    if args.dataset:
        from cerberus_tpu_torch.data.log_adapter import (ImageLoader,
                                                         load_dataset)
        data = load_dataset(args.dataset)
        if args.images:
            renderer = ImageLoader(data, args.focal, cfg.image_width / 2.0,
                                   cfg.image_height / 2.0)
    else:
        from cerberus_tpu_torch.data.simulator import (ImageRenderer,
                                                       SimConfig, simulate)
        data = simulate(SimConfig(duration=args.sim, speed=args.speed,
                                  path=args.path, seed=args.seed))
        if args.images:
            renderer = ImageRenderer(data, cfg)

    if not args.images and "features" not in data:
        raise SystemExit(
            "dataset has no features.npz — pass --images to run the "
            "KLT front-end on cam.csv imagery (vision is required: the "
            "reference asserts stereo+IMU, parameters.cpp:273)")
    try:
        if args.images:
            from cerberus_tpu_torch.frontend.tracker import PinholeCamera
            cam = PinholeCamera(renderer.f, renderer.f, renderer.cx,
                                renderer.cy, size=(renderer.W, renderer.H))
            if args.tracker == "device":
                from cerberus_tpu_torch.frontend.device_tracker import \
                    DeviceTracker
                tracker = DeviceTracker(cam, cam, max_cnt=cfg.max_cnt,
                                        min_dist=cfg.min_dist,
                                        flow_back=cfg.flow_back,
                                        device=est.device)
            else:
                from cerberus_tpu_torch.frontend.tracker import FeatureTracker
                tracker = FeatureTracker(cam, cam, max_cnt=cfg.max_cnt,
                                         min_dist=cfg.min_dist,
                                         flow_back=cfg.flow_back)
            out = replay_images(data, est=est, renderer=renderer,
                                tracker=tracker, csv_path=args.csv,
                                max_frames=args.max_frames)
        else:
            out = replay(data, est=est, csv_path=args.csv,
                         max_frames=args.max_frames)
    finally:
        if est.metrics is not None:
            est.metrics.close()
    print(json.dumps({k: round(float(v), 5) if isinstance(v, (int, float))
                      else v for k, v in out.items()
                      if k in ("drift_pct", "ate_rmse", "distance",
                               "final_err")}
                     | {"solves": est.stats["solves"],
                        "reboots": est.stats["reboots"],
                        "device": est.device.type}))
    return out


if __name__ == "__main__":
    _main()
