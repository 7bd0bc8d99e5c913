"""Synthetic quadruped VILO data generator (frozen copy of
`cerberus_tpu_torch/data/simulator.py` without the image renderer; one
field added, `SimConfig.landmark_span`).

The reference is evaluated by replaying real rosbags (launch/dataset/*.launch);
those bags are not vendored (bags/put_rosbags_here.txt), so this simulator is
the framework's dataset: it produces ground-truth body trajectories plus the
exact sensor suite Cerberus consumes (README.md:114-128) —

  * 500 Hz IMU (accel/gyro with bias + noise),
  * 500 Hz joint angles/velocities for 4 legs (trot gait, feet pinned to the
    ground during stance, numerically-IK'd) + contact flags / foot forces,
  * 15 Hz stereo features: landmark projections onto two pinhole cameras with
    track ids, normalized-plane coordinates and feature velocities, matching
    the front-end output format (feature_tracker.cpp:260-302).

Everything is generated in NumPy f64 on host (this is the data pipeline, not
the compute path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vilo_bench.frozen.config import NUM_OF_LEG, EstimatorConfig


@dataclass
class SimConfig:
    duration: float = 10.0
    imu_rate: float = 500.0
    cam_rate: float = 15.0
    speed: float = 0.5              # m/s nominal forward speed
    path: str = "arc"               # arc | line | figure8 | street
    street_w: float = 40.0          # street circuit bounding box (m)
    street_h: float = 20.0
    street_corner_r: float = 6.0
    gait_freq: float = 2.0          # trot cycles per second
    step_height: float = 0.06
    body_height: float = 0.30
    # sensor noise (applied on top of truth)
    acc_noise: float = 0.08
    gyr_noise: float = 0.004
    acc_bias: tuple = (0.05, -0.03, 0.08)
    gyr_bias: tuple = (0.002, -0.001, 0.0015)
    joint_noise: float = 0.001
    djoint_noise: float = 0.01
    pix_noise: float = 0.5          # pixels (converted via focal 460)
    # leg-odometry realism: stance feet are not truly rigid anchors — real
    # quadruped feet slip, roll on their rubber ball, and deform (this is the
    # very reason Cerberus fuses vision; with perfectly pinned feet, leg
    # odometry alone would be mm-accurate and vision could only add noise)
    foot_slip_sigma: float = 0.004   # m/s: std of the random (per-stance,
                                     # constant-velocity) creep of a stance
                                     # foot — smooth drift, not white noise
    foot_slip_forward_bias: float = 0.0015  # m/s systematic slip opposite to
                                            # travel (compliance/rolling)
    late_contact_frac: float = 0.08 # fraction of stance (at each end) where
                                    # the contact flag is wrong (impact /
                                    # early-liftoff transients)
    # trot-induced body oscillation (degrees): real quadrupeds pitch and roll
    # with every diagonal-pair step — this rotation richness is what makes
    # camera extrinsics / td observable for the reference on its bags
    roll_amp_deg: float = 1.5
    pitch_amp_deg: float = 2.0
    # landmarks
    n_landmarks: int = 600
    corridor_halfwidth: float = 6.0
    max_view_dist: float = 12.0     # feature visibility range (finite track
                                    # lifetimes: anchors refresh as in real
                                    # footage)
    landmark_span: float = 0.0      # seconds of path the landmarks are
                                    # scattered along (0: the duration), so
                                    # a short run sees a long run's scene
    seed: int = 0


def _path_street(t, cfg: SimConfig):
    """Rounded-rectangle street circuit (constant speed): straights + 90-deg
    corner arcs, repeating laps — the shape of the reference's street/track
    datasets (README.md:53-68: suburban block, stadium track). Revisits the
    same places every lap, which is what loop closure exists for."""
    v = cfg.speed
    W, H, r = cfg.street_w, cfg.street_h, cfg.street_corner_r
    sw, sh = W - 2 * r, H - 2 * r            # straight lengths
    qa = 0.5 * np.pi * r                     # quarter-arc length
    L = 2 * sw + 2 * sh + 4 * qa             # lap length
    # segments: [straight +x] [arc] [straight +y] [arc] [-x] [arc] [-y] [arc]
    segs = []
    s0 = 0.0
    # each entry: (s_start, length, kind, params)
    defs = [
        ("line", sw, (r, 0.0, 0.0)),          # from (r,0) heading 0
        ("arc", qa, (W - r, r, -0.5 * np.pi)),  # center, start angle
        ("line", sh, (W, r, 0.5 * np.pi)),
        ("arc", qa, (W - r, H - r, 0.0)),
        ("line", sw, (W - r, H, np.pi)),
        ("arc", qa, (r, H - r, 0.5 * np.pi)),
        ("line", sh, (0.0, H - r, 1.5 * np.pi)),
        ("arc", qa, (r, r, np.pi)),
    ]
    for kind, ln, par in defs:
        segs.append((s0, ln, kind, par))
        s0 += ln
    s_arr = np.mod(v * t, L)
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    yaw = np.zeros_like(t)
    kappa = np.zeros_like(t)
    for s_start, ln, kind, par in segs:
        m = (s_arr >= s_start) & (s_arr < s_start + ln + 1e-12)
        if not m.any():
            continue
        ds = s_arr[m] - s_start
        if kind == "line":
            x0, y0, psi = par
            x[m] = x0 + ds * np.cos(psi)
            y[m] = y0 + ds * np.sin(psi)
            yaw[m] = psi
            kappa[m] = 0.0
        else:
            cx, cy, a0 = par
            a = a0 + ds / r
            x[m] = cx + r * np.cos(a)
            y[m] = cy + r * np.sin(a)
            yaw[m] = a + 0.5 * np.pi        # CCW tangent
            kappa[m] = 1.0 / r
    vx = v * np.cos(yaw)
    vy = v * np.sin(yaw)
    ax = -v * v * kappa * np.sin(yaw)
    ay = v * v * kappa * np.cos(yaw)
    yaw = np.unwrap(yaw)
    return x, y, vx, vy, ax, ay, yaw


def _path_xy(t, cfg: SimConfig):
    """Ground-truth planar path: position, yaw, and derivatives."""
    s = cfg.speed
    if cfg.path == "street":
        return _path_street(t, cfg)
    if cfg.path == "line":
        x, y = s * t, np.zeros_like(t)
        vx, vy = s * np.ones_like(t), np.zeros_like(t)
        ax = ay = np.zeros_like(t)
    elif cfg.path == "arc":
        R = 8.0
        w = s / R
        x, y = R * np.sin(w * t), R * (1 - np.cos(w * t))
        vx, vy = s * np.cos(w * t), s * np.sin(w * t)
        ax, ay = -s * w * np.sin(w * t), s * w * np.cos(w * t)
    else:  # figure8
        w = 2 * np.pi * s / 25.0
        x = 4.0 * np.sin(w * t)
        y = 2.0 * np.sin(2 * w * t)
        vx = 4.0 * w * np.cos(w * t)
        vy = 4.0 * w * np.cos(2 * w * t)
        ax = -4.0 * w * w * np.sin(w * t)
        ay = -8.0 * w * w * np.sin(2 * w * t)
    yaw = np.arctan2(vy, vx + 1e-12)
    return x, y, vx, vy, ax, ay, yaw


def _rotz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(yaw.shape + (3, 3))
    R[..., 0, 0], R[..., 0, 1] = c, -s
    R[..., 1, 0], R[..., 1, 1] = s, c
    R[..., 2, 2] = 1.0
    return R


def _quat_from_yaw(yaw):
    q = np.zeros(yaw.shape + (4,))
    q[..., 0] = np.cos(yaw / 2)
    q[..., 3] = np.sin(yaw / 2)
    return q


def _quat_from_rot_batch(R):
    """(N, 3, 3) -> (N, 4) wxyz, sign-continuous along the trajectory."""
    from scipy.spatial.transform import Rotation
    q = np.roll(Rotation.from_matrix(R).as_quat(), 1, axis=-1)
    # enforce sign continuity so finite differences are valid
    for k in range(1, len(q)):
        if np.dot(q[k], q[k - 1]) < 0:
            q[k] = -q[k]
    return q


def _quat_mul_np_batch(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def _omega_from_quat(q, dt):
    """(N, 4) wxyz -> (N, 3) body-frame angular velocity via central
    differences: w = 2 vec(q_k^-1 q_{k+1}) / dt."""
    N = len(q)
    qc = q.copy()
    qc[..., 1:] = -qc[..., 1:]
    w = np.zeros((N, 3))
    dq_c = _quat_mul_np_batch(qc[:-2], q[2:])            # q_{k-1}^-1 q_{k+1}
    w[1:-1] = 2.0 * dq_c[..., 1:] / (2 * dt)
    dq_f = _quat_mul_np_batch(qc[:-1], q[1:])
    w[0] = 2.0 * dq_f[0, 1:] / dt
    w[-1] = 2.0 * dq_f[-1, 1:] / dt
    return w


def _fk_np(q, lc, rho_fix):
    """NumPy closed-form FK (same geometric model as kinematics/leg.py),
    kept host-side so the data pipeline never touches the accelerator."""
    ox, oy, d, lu = rho_fix
    s0, c0 = np.sin(q[0]), np.cos(q[0])
    s1, c1 = np.sin(q[1]), np.cos(q[1])
    s12, c12 = np.sin(q[1] + q[2]), np.cos(q[1] + q[2])
    px = -lu * s1 - lc * s12
    pz = -(lu * c1 + lc * c12)
    return np.array([ox + px, oy + d * c0 - pz * s0, d * s0 + pz * c0])


def _jac_np(q, lc, rho_fix):
    ox, oy, d, lu = rho_fix
    s0, c0 = np.sin(q[0]), np.cos(q[0])
    s1, c1 = np.sin(q[1]), np.cos(q[1])
    s12, c12 = np.sin(q[1] + q[2]), np.cos(q[1] + q[2])
    px = -lu * s1 - lc * s12
    pz = -(lu * c1 + lc * c12)
    dpx_d1 = -lu * c1 - lc * c12
    dpx_d2 = -lc * c12
    dpz_d1 = lu * s1 + lc * s12
    dpz_d2 = lc * s12
    return np.array([
        [0.0, dpx_d1, dpx_d2],
        [-d * s0 - pz * c0, -dpz_d1 * s0, -dpz_d2 * s0],
        [d * c0 - pz * s0, dpz_d1 * c0, dpz_d2 * c0],
    ])


def _leg_ik_np(target, lc, rho_fix, q0):
    q = np.array(q0)
    for _ in range(30):
        err = _fk_np(q, lc, rho_fix) - target
        if np.abs(err).max() < 1e-10:
            break
        J = _jac_np(q, lc, rho_fix)
        q = q - np.linalg.solve(J + 1e-9 * np.eye(3), err)
    return q


def simulate(cfg: SimConfig, est_cfg: EstimatorConfig | None = None) -> dict:
    """Generate a full synthetic dataset.

    Returns a dict of numpy arrays (see keys below). Body motion is planar
    with bounce/sway harmonics; feet follow a trot gait with stance feet
    pinned to the world ground plane so leg odometry is exactly consistent.
    """
    est_cfg = est_cfg or EstimatorConfig()
    rng = np.random.default_rng(cfg.seed)
    dt = 1.0 / cfg.imu_rate
    N = int(cfg.duration * cfg.imu_rate)
    t = np.arange(N) * dt

    x, y, vx, vy, ax, ay, yaw = _path_xy(t, cfg)
    wb = 2 * np.pi * cfg.gait_freq
    z = cfg.body_height + 0.004 * np.sin(2 * wb * t)
    vz = 0.004 * 2 * wb * np.cos(2 * wb * t)
    az = -0.004 * (2 * wb) ** 2 * np.sin(2 * wb * t)

    p = np.stack([x, y, z], -1)
    v = np.stack([vx, vy, vz], -1)
    a = np.stack([ax, ay, az], -1)
    # trot-induced roll/pitch oscillation at the gait frequency; IK below
    # uses the full body rotation so joints stay exactly consistent
    roll = np.deg2rad(cfg.roll_amp_deg) * np.sin(wb * t)
    pitch = np.deg2rad(cfg.pitch_amp_deg) * np.sin(2 * wb * t + 0.7)
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rx = np.zeros((N, 3, 3)); Ry = np.zeros((N, 3, 3))
    Rx[:, 0, 0] = 1; Rx[:, 1, 1] = cr; Rx[:, 1, 2] = -sr
    Rx[:, 2, 1] = sr; Rx[:, 2, 2] = cr
    Ry[:, 1, 1] = 1; Ry[:, 0, 0] = cp; Ry[:, 0, 2] = sp
    Ry[:, 2, 0] = -sp; Ry[:, 2, 2] = cp
    R = _rotz(yaw) @ Ry @ Rx
    q = _quat_from_rot_batch(R)
    # body-frame angular velocity from the quaternion central difference
    # (second-order accurate at 500 Hz; the yaw-rate also came from
    # np.gradient before)
    w_body = _omega_from_quat(q, dt)

    g = np.array([0.0, 0.0, est_cfg.g_norm])
    acc_body = np.einsum("nji,nj->ni", R, a + g)  # R^T (a + g)
    acc_meas = acc_body + np.array(cfg.acc_bias) + rng.normal(size=(N, 3)) * cfg.acc_noise
    gyr_meas = w_body + np.array(cfg.gyr_bias) + rng.normal(size=(N, 3)) * cfg.gyr_noise

    # ---- legs: trot gait (diagonal pairs FL+RR / FR+RL) ----
    robot = est_cfg.robot
    rho_fix = robot.rho_fix()
    rho = np.full((NUM_OF_LEG,), robot.lower_leg_length)
    hip_xy = np.stack([np.array([robot.leg_offset_x[j],
                                 robot.leg_offset_y[j] + np.sign(robot.motor_offset[j]) * 0.081,
                                 0.0]) for j in range(4)])
    phase_offset = np.array([0.0, 0.5, 0.5, 0.0])  # FL, FR, RL, RR
    duty = 0.6  # stance fraction

    phi = np.zeros((N, 12))
    dphi = np.zeros((N, 12))
    contacts = np.zeros((N, 4))
    foot_forces = np.zeros((N, 4))
    q_prev = np.tile(np.array([0.0, 0.8, -1.6]), (4, 1))

    # stance foot world anchor per leg (+ per-stance constant slip velocity)
    anchors = np.zeros((4, 3))
    have_anchor = np.zeros(4, dtype=bool)
    slip_v = np.zeros((4, 2))
    T_gait = 1.0 / cfg.gait_freq

    for k in range(N):
        Rk, pk = R[k], p[k]
        for j in range(4):
            ph = ((t[k] / T_gait) + phase_offset[j]) % 1.0
            in_stance = ph < duty
            hip_w = Rk @ hip_xy[j] + pk
            if in_stance:
                if not have_anchor[j]:
                    # touch down under the hip, slightly ahead along velocity
                    lead = 0.5 * (1 - duty) * T_gait
                    anchors[j] = hip_w + np.array([v[k][0], v[k][1], 0]) * lead
                    anchors[j][2] = 0.0
                    have_anchor[j] = True
                    # sample this stance phase's (constant) creep velocity:
                    # random direction + systematic component against travel
                    slip_v[j] = rng.normal(size=2) * cfg.foot_slip_sigma
                    sp = np.linalg.norm(v[k][:2])
                    if sp > 1e-6:
                        slip_v[j] -= (v[k][:2] / sp) * cfg.foot_slip_forward_bias
                elif cfg.foot_slip_sigma or cfg.foot_slip_forward_bias:
                    # stance foot creep: smooth constant-velocity drift
                    # (rubber-foot rolling / compliance) — feet stay planar
                    anchors[j][:2] += slip_v[j] * dt
                foot_w = anchors[j]
                # contact flag transients near touchdown/liftoff
                edge = min(ph, duty - ph) < cfg.late_contact_frac * duty
                contacts[k, j] = 0.0 if edge else 1.0
                foot_forces[k, j] = max(
                    0.0, (60.0 + 10.0 * np.sin(wb * t[k] + j))
                    * (0.3 if edge else 1.0))
            else:
                have_anchor[j] = False
                # swing: cycloidal from previous anchor toward next touchdown
                sw = (ph - duty) / (1 - duty)
                lead = 0.5 * (1 - duty) * T_gait
                target = hip_w + np.array([v[k][0], v[k][1], 0]) * lead
                target[2] = 0.0
                start = anchors[j] if anchors[j].any() else target
                foot_w = start + (target - start) * sw
                foot_w[2] = cfg.step_height * np.sin(np.pi * sw)
                contacts[k, j] = 0.0
                foot_forces[k, j] = max(0.0, 2.0 + rng.normal() * 0.5)
            # foot in body frame
            foot_b = Rk.T @ (foot_w - pk)
            qj = _leg_ik_np(foot_b, rho[j], rho_fix[j], q_prev[j])
            phi[k, 3*j:3*j+3] = qj
            q_prev[j] = qj
    dphi = np.gradient(phi, dt, axis=0)
    # central differences smear the velocity discontinuity at stance/swing
    # transitions across the boundary samples, which biases the leg-odometry
    # velocity exactly when the contact flag is active — recompute one-sided
    # differences within each contact phase
    for j in range(4):
        trans = np.nonzero(np.diff(contacts[:, j]) != 0)[0]
        for k in trans:
            cols = slice(3 * j, 3 * j + 3)
            if k >= 1:
                dphi[k, cols] = (phi[k, cols] - phi[k - 1, cols]) / dt
            if k + 2 < N:
                dphi[k + 1, cols] = (phi[k + 2, cols] - phi[k + 1, cols]) / dt
    phi_meas = phi + rng.normal(size=phi.shape) * cfg.joint_noise
    dphi_meas = dphi + rng.normal(size=dphi.shape) * cfg.djoint_noise

    # ---- landmarks + stereo features ----
    n_cam_frames = int(cfg.duration * cfg.cam_rate)
    cam_stride = int(round(cfg.imu_rate / cfg.cam_rate))
    cam_idx = np.arange(n_cam_frames) * cam_stride
    cam_t = t[cam_idx]

    # scatter landmarks around the path at varied depths/heights
    n_span = int((cfg.landmark_span or cfg.duration) * cfg.imu_rate)
    t_lm = rng.integers(0, n_span, size=cfg.n_landmarks) * dt
    x_lm, y_lm = _path_xy(t_lm, cfg)[:2]
    path_samples = np.stack(
        [x_lm, y_lm, cfg.body_height + 0.004 * np.sin(2 * wb * t_lm)], -1)
    lm = path_samples + np.stack([
        rng.uniform(-cfg.corridor_halfwidth, cfg.corridor_halfwidth, cfg.n_landmarks),
        rng.uniform(-cfg.corridor_halfwidth, cfg.corridor_halfwidth, cfg.n_landmarks),
        rng.uniform(-cfg.body_height, 2.5, cfg.n_landmarks),
    ], -1)

    ric, tic = est_cfg.ric_tic()
    focal = 460.0
    half_fov_x = (est_cfg.image_width / 2) / focal
    half_fov_y = (est_cfg.image_height / 2) / focal
    pix_sigma = cfg.pix_noise / focal

    # features[cam_frame] = dict id -> (obs0 (3,), vel0 (2,), obs1|None, vel1)
    feat_frames = []
    prev_obs: dict[int, np.ndarray] = {}
    for fi, k in enumerate(cam_idx):
        Rk, pk = R[k], p[k]
        frame = {}
        new_prev = {}
        for cam in range(2):
            Rwc = Rk @ ric[cam]
            twc = Rk @ tic[cam] + pk
            pc = (lm - twc) @ Rwc  # (L, 3) points in camera frame
            valid = (pc[:, 2] > 0.3) & (pc[:, 2] < cfg.max_view_dist)
            un = pc[:, 0] / np.maximum(pc[:, 2], 1e-6)
            vn = pc[:, 1] / np.maximum(pc[:, 2], 1e-6)
            valid &= (np.abs(un) < half_fov_x) & (np.abs(vn) < half_fov_y)
            noise = rng.normal(size=(cfg.n_landmarks, 2)) * pix_sigma
            for li in np.nonzero(valid)[0]:
                u, w_ = un[li] + noise[li, 0], vn[li] + noise[li, 1]
                if cam == 0:
                    vel = np.zeros(2)
                    if li in prev_obs:
                        vel = (np.array([u, w_]) - prev_obs[li][:2]) / (1.0 / cfg.cam_rate)
                    frame[li] = [np.array([u, w_, 1.0]), vel, None, np.zeros(2)]
                    new_prev[li] = np.array([u, w_])
                else:
                    if li in frame:
                        frame[li][2] = np.array([u, w_, 1.0])
        prev_obs = new_prev
        feat_frames.append(frame)

    return dict(
        t=t, p=p, q=q, v=v, R=R, acc=acc_meas, gyr=gyr_meas,
        acc_true=acc_body, gyr_true=w_body,
        phi=phi_meas, dphi=dphi_meas, phi_true=phi, dphi_true=dphi,
        contacts=contacts, foot_forces=foot_forces,
        cam_t=cam_t, cam_idx=cam_idx, features=feat_frames, landmarks=lm,
        acc_bias=np.array(cfg.acc_bias), gyr_bias=np.array(cfg.gyr_bias),
        rho=rho, gravity=g, sim_cfg=cfg,
    )


