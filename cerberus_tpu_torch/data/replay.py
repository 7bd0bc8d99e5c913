"""Replay driver: stream a simulated sequence through the estimator and
score the trajectory (port of `cerberus_tpu/data/replay.py::replay`,
`score` and `_PyCsv`).

The simulator's output is streamed sample by sample through `Estimator`
(500 Hz IMU+leg ticks, ideal stereo features at each camera frame) and the
trajectory is scored against ground truth: ATE RMSE and drift % of the
distance traveled. The image front-end replay (`replay_images`, which needs
the tracker and the renderer) and the EKF contact source are not ported
yet.

    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.replay import replay
    out = replay(simulate(SimConfig(duration=3.0, seed=5)), max_frames=20,
                 device="cpu")   # or the default "cuda"
"""

from __future__ import annotations

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.estimator.estimator import Estimator


def replay(sim: dict, cfg: EstimatorConfig | None = None,
           est: Estimator | None = None, max_frames: int | None = None,
           csv_path: str | None = None, device="cuda") -> dict:
    """Feed simulator output through the estimator (a new one on `device`
    unless `est` is given).

    Returns dict with est_t, est_p, est_q, gt_p, ate_rmse, drift_pct,
    distance, and the estimator instance. With csv_path set, writes the
    reference's 20-column result schema (reference: main.cpp:152-197):
    [t_ns, p_wr(3), v_wr(3), ekf_pos(3), ekf_vel(3), gt_pos(3), rho(4)], the
    EKF columns zero.
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

    est_t, est_p, est_q, gt_p = [], [], [], []
    writer = None
    if csv_path:
        writer = _PyCsv(csv_path, "t_ns,px,py,pz,vx,vy,vz,kf_px,kf_py,kf_pz,"
                                  "kf_vx,kf_vy,kf_vz,gt_x,gt_y,gt_z,rho1,rho2,"
                                  "rho3,rho4")
    # contact source (reference: main.cpp:319-330): 2 = raw foot force (the
    # preintegration's sigmoid contact model), else the simulated contacts
    ctype = est.cfg.contact_sensor_type
    for k in range(len(t)):
        contact = sim["foot_forces"][k] if ctype == 2 else sim["contacts"][k]
        est.input_imu_leg(t[k], sim["acc"][k], sim["gyr"][k], sim["phi"][k],
                          sim["dphi"][k], contact)
        if k in cam_idx:
            est.input_image(t[k], cam_lookup[k])
            if est.solver_flag == Estimator.NON_LINEAR:
                p, q = est.pose
                est_t.append(t[k])
                est_p.append(p)
                est_q.append(q)
                gt_k = sim["p"][k] if "p" in sim else np.full(3, np.nan)
                gt_p.append(gt_k)
                if writer is not None:
                    writer.row([t[k] * 1e9, *p, *est.velocity, *np.zeros(6),
                                *gt_k, *est.rho[-1]])

    est.flush()   # adopt the dispatched step of the last frame
    if writer is not None:
        writer.close()
    est_p = np.array(est_p) if est_p else np.zeros((0, 3))
    gt_p = np.array(gt_p) if gt_p else np.zeros((0, 3))
    return dict(est_t=np.array(est_t), est_p=est_p, est_q=est_q, gt_p=gt_p,
                estimator=est, **score(est_p, gt_p))


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
