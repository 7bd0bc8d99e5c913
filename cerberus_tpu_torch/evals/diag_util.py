"""What the port's diagnostics (`evals/diag_*.py`) share, each piece the
JAX repo's scripts write out more than once:

  * `feed`: the IMU and leg samples at every sample time and the first
    `max_frames` camera frames (JAX `evals/diag_obs.py:34-38`,
    `diag_proj.py:45-49`, `diag_vision.py:44-49`);
  * `window_indices`, `aligned_truth`, `true_inv_depths` and `truth_state`:
    the truth at the window's frames, aligned to the estimate's frame 0 in
    position and yaw, with the true inverse depths of the window's features
    in their anchor frames (`diag_proj.py:52-78`, `diag_vision.py:106-143`);
  * `ekf_run`: the legged EKF over a simulation, scored in the plane
    (`diag_ekf_slip.py:32-43` = `diag_ekf_slip2.py:31-42`);
  * `add_device` / `write_out`: the port's `--device` and `--out` flags.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cerberus_tpu_torch.data.replay import score
from cerberus_tpu_torch.estimator.estimator import _quat_mul_np
from cerberus_tpu_torch.frontend.ekf import LeggedEKF
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.utils import lie

IMU_HZ = 500   # the simulator's sample rate (header time -> sample index)


def add_device(ap):
    """The port's `--device` (default cuda: no fallback without a card) and
    `--out` (nothing is written without it)."""
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port runs (f64); without a card "
                         "`cuda` raises")
    ap.add_argument("--out", default=None,
                    help="write the results to this JSON file")


def write_out(path, results):
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1, default=_plain)


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(type(x))


def feed(est, sim, max_frames, vision=True, on_frame=None):
    """Every IMU/leg sample of `sim` into `est`, and at the first
    `max_frames` camera sample indices the frame's features (none when
    `vision` is False); `on_frame(k)` after each frame. Returns the frames
    fed."""
    t = sim["t"]
    cam_lookup = {int(k): f for k, f in zip(sim["cam_idx"], sim["features"])}
    allowed = set(sorted(cam_lookup)[:max_frames])
    n = 0
    for k in range(len(t)):
        est.input_imu_leg(t[k], sim["acc"][k], sim["gyr"][k], sim["phi"][k],
                          sim["dphi"][k], sim["contacts"][k])
        if k in allowed:
            est.input_image(t[k], cam_lookup[k] if vision else {})
            n += 1
            if on_frame is not None:
                on_frame(k)
    return n


def window_indices(est, sim):
    """The sample index of each window frame's header (clipped)."""
    last = len(sim["t"]) - 1
    return [min(int(round(h * IMU_HZ)), last) for h in est.headers]


def _yaw_deg(q):
    q = torch.as_tensor(np.asarray(q, float), dtype=torch.float64)
    return float(lie.rot_to_ypr(lie.quat_to_rot(q))[0])


def aligned_truth(est, sim, kis):
    """The true p, q, v at the window frames `kis`, moved and yawed so that
    frame 0 sits on the estimate's frame 0 (the gauge)."""
    p_t, q_t, v_t = sim["p"][kis], sim["q"][kis], sim["v"][kis]
    dyaw = np.deg2rad(_yaw_deg(est.q[0]) - _yaw_deg(q_t[0]))
    c, s = np.cos(dyaw), np.sin(dyaw)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    qz = np.array([np.cos(dyaw / 2), 0, 0, np.sin(dyaw / 2)])
    p_a = (p_t - p_t[0]) @ Rz.T + est.p[0]
    q_a = np.stack([_quat_mul_np(qz, q) for q in q_t])
    return p_a, q_a, v_t @ Rz.T


def true_inv_depths(est, sim, slots, kis):
    """(len(slots),) true inverse depth of each window feature in its
    anchor frame's left camera (depth floored at 0.1 m)."""
    ric, tic = est.cfg.ric_tic()
    lm = sim["landmarks"]
    d = np.ones(len(slots))
    for n, slot in enumerate(slots):
        ki = kis[int(est.fm.start[slot])]
        Rw = sim["R"][ki] @ ric[0]
        tw = sim["R"][ki] @ tic[0] + sim["p"][ki]
        z = (Rw.T @ (lm[int(est.fm.ids[slot])] - tw))[2]
        d[n] = 1.0 / max(z, 0.1)
    return d


def truth_state(est, sim, slots):
    """The window state at aligned truth on the estimator's device: true
    biases and calf lengths, the estimate's extrinsics and td, the true
    inverse depths. Returns (state, true inverse depths, kis)."""
    kis = window_indices(est, sim)
    p_a, q_a, v_a = aligned_truth(est, sim, kis)
    d_true = true_inv_depths(est, sim, slots, kis)
    a = est._dev
    st = est._window_state(d_true)._replace(
        p=a(p_a), q=a(q_a), v=a(v_a),
        ba=a(np.tile(sim["acc_bias"], (11, 1))),
        bg=a(np.tile(sim["gyr_bias"], (11, 1))),
        rho=a(np.full((11, 4), sim["rho"][0])))
    return st, d_true, kis


def residuals_at(st, data, F):
    """(window_residuals at st, robust cost) read back to the host; the
    residual is [ileg (310), proj (44 F), prior, calibration prior]."""
    assert fac.proj_row_slice(F) == slice(310, 310 + F * 44)
    zero = torch.zeros((fac.tangent_dim(F),), dtype=st.p.dtype,
                       device=st.p.device)
    r = fac.window_residuals(st, zero, data)
    return r.cpu().numpy(), float(fac.robust_cost(r, F))


def ekf_run(cfg, sim, device="cuda", filter_window=4):
    """LeggedEKF(cfg, filter_window) over every sample of `sim`, its
    positions scored in the plane against the truth (drift %, ATE)."""
    ekf = LeggedEKF(cfg, filter_window=filter_window, device=device)
    ekf.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    ps = []
    for k in range(1, len(sim["t"])):
        ekf.update_filter(sim["t"][k], sim["acc"][k], sim["gyr"][k],
                          sim["phi"][k], dphi=sim["dphi"][k],
                          foot_force=sim["foot_forces"][k])
        ps.append(ekf.get_state()[0:3])
    ps = np.array(ps)
    gt = sim["p"][1:len(ps) + 1] - sim["p"][0]
    return score(ps[:, :2], gt[:, :2])
