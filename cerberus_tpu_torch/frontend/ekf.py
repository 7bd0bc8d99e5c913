"""Contact-aided legged kinematic EKF (proprioceptive front-end), on torch
tensors (port of `cerberus_tpu/frontend/ekf.py`).

Rebuild of the reference's missing `src/kalmanFilter` submodule
("legged-kalman-filter"). Its public behavior, recovered from the call sites
(reference: main.cpp:39-40, 281-330, 174-190, 379-389):
  * ingest raw 500 Hz IMU + joint streams, lightly filtered
    (A1SensorData::input_imu/input_leg with MovingWindowFilter smoothing),
  * estimate per-leg contact probability from foot force
    (kf.get_contacts() feeds CONTACT_SENSOR_TYPE==0),
  * maintain an independent position/velocity state
    (kf.get_state()[0:3]=pos, [3:6]=vel) used for logging and republishing.

`ekf_step` is one propagate + update step on tensors: no host read-back, so
a step on the card is only queued. `LeggedEKF` is the host wrapper with the
reference-shaped API; its state lives on `device` (the card unless the
caller names another), and its steps and fetches run on a stream of its own
there (`device.side_stream`).

State (error-state dim 27): [p(3), v(3), theta(3), pf1..pf4(12), ba(3), bg(3)]
  p, v   : body position/velocity in world
  theta  : attitude error (right perturbation of q)
  pf_j   : world position of foot j (random walk; tight in contact)
  ba, bg : IMU accel/gyro biases (random walk)
Measurements per leg (in contact), with z/h split so the state-dependent
terms live in h and the Jacobian H comes from `torch.func.jacfwd` (exact by
construction):
  z1_j = fk(phi_j)     h1_j = R^T (pf_j - p)         (foot position, 3)
  z2_j = -J phi'       h2_j = R^T v + (w - bg) x fk  (leg velocity, 3)
  z3_j = 0             h3_j = pf_j.z                 (ground height, 1)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation
from torch.func import jacfwd, vmap
from torch.profiler import record_function

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.device import on_stream, resolve_device, side_stream
from cerberus_tpu_torch.kinematics.leg import leg_fk, leg_jac
from cerberus_tpu_torch.utils import lie
from cerberus_tpu_torch.utils.filters import MovingWindowFilter

DIM = 27


class EKFParams(NamedTuple):
    rho_fix: torch.Tensor         # (4, 4)
    rho: torch.Tensor             # (4,) calf lengths
    p_br: torch.Tensor
    R_br: torch.Tensor
    gravity: torch.Tensor         # (3,)
    acc_n: torch.Tensor = None    # process noise
    gyr_n: torch.Tensor = None
    foot_walk_contact: torch.Tensor = None    # foot process noise in contact
    foot_walk_swing: torch.Tensor = None      # and in swing
    meas_fk_n: torch.Tensor = None
    meas_vel_n: torch.Tensor = None
    meas_height_n: torch.Tensor = None
    contact_force_thresh: torch.Tensor = None
    acc_bias_walk: torch.Tensor = None
    gyr_bias_walk: torch.Tensor = None
    slip_gate_chi2: torch.Tensor = None
    force_var_rescale: torch.Tensor = None

    @staticmethod
    def from_config(cfg: EstimatorConfig, dtype=torch.float64,
                    device="cuda") -> "EKFParams":
        dev = resolve_device(device)
        f = lambda x: torch.tensor(np.asarray(x, float), dtype=dtype,
                                   device=dev)
        nz = cfg.noise
        return EKFParams(
            rho_fix=f(cfg.robot.rho_fix()), rho=f(cfg.robot.rho_init()),
            p_br=f(cfg.robot.p_br), R_br=f(cfg.robot.R_br),
            gravity=f([0.0, 0.0, cfg.g_norm]),
            acc_n=f(nz.ekf_acc_n), gyr_n=f(nz.ekf_gyr_n),
            foot_walk_contact=f(nz.ekf_foot_walk_contact),
            foot_walk_swing=f(nz.ekf_foot_walk_swing),
            meas_fk_n=f(nz.ekf_meas_fk_n), meas_vel_n=f(nz.ekf_meas_vel_n),
            meas_height_n=f(nz.ekf_meas_height_n),
            contact_force_thresh=f(nz.ekf_contact_force_thresh),
            acc_bias_walk=f(nz.ekf_acc_bias_walk),
            gyr_bias_walk=f(nz.ekf_gyr_bias_walk),
            slip_gate_chi2=f(nz.ekf_slip_gate_chi2),
            force_var_rescale=f(nz.ekf_force_var_rescale),
        )


class EKFState(NamedTuple):
    p: torch.Tensor        # (3,)
    v: torch.Tensor        # (3,)
    q: torch.Tensor        # (4,) wxyz body->world
    pf: torch.Tensor       # (4, 3) foot world positions
    ba: torch.Tensor       # (3,) accel bias
    bg: torch.Tensor       # (3,) gyro bias
    P: torch.Tensor        # (27, 27)
    contacts: torch.Tensor  # (4,) smoothed contact probability
    # filtered foot-force statistics for contact estimation: the same
    # adaptive min/max tracker as the preintegration's force-sigmoid model
    # (reference imu_leg_integration_base.cpp:183-229)
    ff_min: torch.Tensor   # (4,) decaying force-minimum tracker
    ff_max: torch.Tensor   # (4,) decaying force-maximum tracker
    ff_window: torch.Tensor  # (4, W) recent forces for the variance term
    ff_idx: torch.Tensor   # () int32 ring index


def _fk_jac(phi, params: EKFParams):
    """Foot positions (4, 3) and joint Jacobians (4, 3, 3) in the leg frame:
    the two entries of `all_legs_fk_jac` the filter reads."""
    rho = params.rho[:, None]
    return (leg_fk(phi, rho, params.rho_fix),
            vmap(leg_jac)(phi, rho, params.rho_fix))


def ekf_init(p, q, phi, params: EKFParams) -> EKFState:
    """Initialize with feet placed by FK from the initial pose (p, q, phi:
    tensors on the parameters' device)."""
    dtype, dev = params.gravity.dtype, params.gravity.device
    fk, _ = _fk_jac(phi.reshape(4, 3), params)
    R = lie.quat_to_rot(q)
    foot_b = params.p_br[None] + fk @ params.R_br.T
    pf = p[None] + foot_b @ R.T
    P = torch.eye(DIM, dtype=dtype, device=dev) * 1e-4
    # bias uncertainty: biases start unknown at ~typical MEMS scales
    P[21:24, 21:24] = torch.eye(3, dtype=dtype, device=dev) * 0.05 ** 2
    P[24:27, 24:27] = torch.eye(3, dtype=dtype, device=dev) * 0.01 ** 2
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return EKFState(p=p, v=zeros(3), q=q, pf=pf, ba=zeros(3), bg=zeros(3),
                    P=P, contacts=torch.ones(4, dtype=dtype, device=dev),
                    ff_min=zeros(4), ff_max=zeros(4),
                    ff_window=zeros(4, C.FOOT_VAR_WINDOW_SIZE),
                    ff_idx=torch.zeros((), dtype=torch.int32, device=dev))


def ekf_step(s: EKFState, dt, acc, gyr, phi, dphi, foot_force,
             params: EKFParams) -> EKFState:
    """One propagate+update step. Every argument is a tensor on the state's
    device (dt 0-d); nothing is read back to the host."""
    dtype, dev = s.p.dtype, s.p.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    W = C.FOOT_VAR_WINDOW_SIZE

    # ---- contact probability from FILTERED FORCE STATISTICS ----
    # Adaptive per-leg normalization instead of a fixed newton threshold:
    # decaying min/max trackers place the stance/swing decision boundary at
    # a fixed fraction of each leg's observed force range (kf_lib behavior;
    # identical tracker to the preintegration's type-2 model).
    ff_min = torch.where(foot_force < s.ff_min,
                         0.9 * s.ff_min + 0.1 * foot_force, s.ff_min)
    ff_max = torch.where(foot_force > s.ff_max,
                         0.9 * s.ff_max + 0.1 * foot_force, s.ff_max)
    ff_min = ff_min * 0.9991
    ff_max = ff_max * 0.997
    rng = torch.clamp(ff_max - ff_min, min=1e-6)
    thres = ff_min + 0.5 * rng
    # steepness in NORMALIZED force units (6/range): scale-free
    contact = torch.sigmoid(6.0 * (foot_force - thres) / rng)
    contacts = 0.8 * s.contacts + 0.2 * contact
    ff_idx = (s.ff_idx + 1) % W
    # the ring write as a select against the slot index (no host index)
    slot = torch.arange(W, device=dev) == ff_idx
    ff_window = torch.where(slot[None, :], foot_force[:, None], s.ff_window)
    ff_mean = torch.mean(ff_window, dim=1, keepdim=True)
    # normalized short-window force variance: impact transients / slipping
    # stance phases carry high variance -> de-weight that leg's kinematic
    # measurements below
    ff_var_n = torch.sum((ff_window - ff_mean) ** 2, dim=1) \
        / (W - 1) / (rng * rng)

    # ---- propagate (bias-corrected IMU) ----
    acc_u = acc - s.ba
    gyr_u = gyr - s.bg
    R = lie.quat_to_rot(s.q)
    acc_w = R @ acc_u - params.gravity
    p_new = s.p + s.v * dt + 0.5 * acc_w * dt * dt
    v_new = s.v + acc_w * dt
    q_new = lie.quat_normalize(lie.quat_mul(s.q, lie.delta_q(gyr_u * dt)))

    F = torch.eye(DIM, dtype=dtype, device=dev)
    F[0:3, 3:6] = I3 * dt
    F[3:6, 6:9] = -R @ lie.skew(acc_u) * dt
    F[3:6, 21:24] = -R * dt             # dv / dba
    F[6:9, 24:27] = -I3 * dt            # dtheta / dbg

    foot_q = torch.where(contact > 0.5, params.foot_walk_contact,
                         params.foot_walk_swing)
    three = lambda x: x.expand(3)
    Q = torch.cat([three((0.5 * params.acc_n * dt * dt) ** 2),
                   three((params.acc_n * dt) ** 2),
                   three((params.gyr_n * dt) ** 2),
                   torch.repeat_interleave(foot_q ** 2 * dt, 3),
                   three(params.acc_bias_walk ** 2 * dt),
                   three(params.gyr_bias_walk ** 2 * dt)])
    P = F @ s.P @ F.T + torch.diag(Q)

    # ---- measurement model (z/h split; H by jacfwd, exact) ----
    fk, J = _fk_jac(phi.reshape(4, 3), params)
    foot_b = params.p_br[None] + fk @ params.R_br.T               # (4,3)
    jdphi = (params.R_br @ (J @ dphi.reshape(4, 3, 1))[..., 0].T).T

    # measured side: z1 = fk (foot pos), z2 = -J dphi (leg vel), z3 = 0
    z = torch.cat([foot_b.reshape(-1), (-jdphi).reshape(-1),
                   torch.zeros(4, dtype=dtype, device=dev)])

    def h_of(dx):
        p = p_new + dx[0:3]
        v = v_new + dx[3:6]
        q = lie.quat_mul(q_new, lie.delta_q(dx[6:9]))
        pf = s.pf + dx[9:21].reshape(4, 3)
        bg = s.bg + dx[24:27]
        Rq = lie.quat_to_rot(q)
        h1 = (pf - p[None]) @ Rq                              # R^T (pf - p)
        wb = gyr - bg
        h2 = (Rq.T @ v)[None] + lie.cross(wb.expand(4, 3), foot_b)
        h3 = pf[:, 2]
        h = torch.cat([h1.reshape(-1), h2.reshape(-1), h3])
        return h, h

    H, h0 = jacfwd(h_of, has_aux=True)(
        torch.zeros(DIM, dtype=dtype, device=dev))            # (28, 27)
    r = z - h0

    # noise: inflate hugely out of contact (hard gate at p = 0.5, the
    # reference's binary use of contact flags for type-0 sensing); in stance
    # the short-window force variance de-weights transient/slipping phases
    infl = torch.where(contact > 0.5,
                       1.0 + params.force_var_rescale * ff_var_n,
                       torch.full_like(contact, 1e8))
    Rdiag = torch.cat([torch.repeat_interleave(params.meas_fk_n ** 2 * infl, 3),
                       torch.repeat_interleave(params.meas_vel_n ** 2 * infl, 3),
                       params.meas_height_n ** 2 * infl])

    # ---- innovation-gated slip rejection (two-pass update) ----
    # A slipping foot passes the contact test (force stays high) but its
    # kinematic velocity measurement is inconsistent with the filter state.
    # Whiten each leg's velocity innovation by its predicted covariance; a
    # leg beyond the chi^2_3 99% gate (11.34) gets its measurements
    # inflated in proportion before the real update.
    HPHt = H @ P @ H.T
    S = HPHt + torch.diag(Rdiag)
    gate = params.slip_gate_chi2
    Sv = S[12:24, 12:24].reshape(4, 3, 4, 3).diagonal(dim1=0, dim2=2)
    Sv = Sv.permute(2, 0, 1)                                  # (4, 3, 3)
    rv = r[12:24].reshape(4, 3)
    m = torch.sum(rv * torch.linalg.solve_ex(Sv, rv[..., None]).result[..., 0],
                  dim=-1)
    fac = torch.where(gate > 0,
                      torch.clamp(m / torch.clamp(gate, min=1e-9), min=1.0),
                      torch.ones_like(m))
    infl2 = torch.cat([torch.repeat_interleave(fac, 3),
                       torch.repeat_interleave(fac, 3), fac])
    Rdiag = Rdiag * infl2
    S = HPHt + torch.diag(Rdiag)
    K = torch.linalg.solve_ex(S, H @ P).result.T              # (27, zdim)
    dx = K @ r
    P_up = (torch.eye(DIM, dtype=dtype, device=dev) - K @ H) @ P
    P_up = 0.5 * (P_up + P_up.T)

    p_up = p_new + dx[0:3]
    v_up = v_new + dx[3:6]
    q_up = lie.quat_normalize(lie.quat_mul(q_new, lie.delta_q(dx[6:9])))
    pf_up = s.pf + dx[9:21].reshape(4, 3)
    return EKFState(p=p_up, v=v_up, q=q_up, pf=pf_up,
                    ba=s.ba + dx[21:24], bg=s.bg + dx[24:27], P=P_up,
                    contacts=contacts, ff_min=ff_min, ff_max=ff_max,
                    ff_window=ff_window, ff_idx=ff_idx)


class LeggedEKF:
    """Host wrapper with the reference-shaped API (main.cpp call sites):
    input samples at 500 Hz, query state/contacts.

    The filter runs on `device` (the card unless the caller names another),
    f64. On the card its uploads, steps and fetches run on a stream of its
    own, so the per-sample `get_contacts()` fetch waits only for the filter's
    own step, not for work queued on other streams."""

    def __init__(self, cfg: EstimatorConfig | None = None, filter_window=10,
                 device="cuda"):
        self.cfg = cfg or EstimatorConfig()
        self.device = resolve_device(device)
        self.params = EKFParams.from_config(self.cfg, device=self.device)
        self.stream = side_stream(self.device)
        self.state: EKFState | None = None
        self.filt_acc = MovingWindowFilter(filter_window, 3)
        self.filt_gyr = MovingWindowFilter(filter_window, 3)
        self.filt_phi = MovingWindowFilter(filter_window // 2, 12)
        self.prev_t = None
        self.prev_phi = None

    def _upload(self, x):
        return torch.tensor(np.asarray(x, float), dtype=torch.float64,
                            device=self.device)

    def is_inited(self) -> bool:
        return self.state is not None

    def init_filter(self, t, acc, gyr, phi, p0=None):
        R0 = lie.g_to_rot(torch.tensor(np.asarray(acc, float),
                                       dtype=torch.float64)).numpy()
        q0 = np.roll(Rotation.from_matrix(R0).as_quat(), 1)
        with on_stream(self.stream):
            self.state = ekf_init(self._upload(np.zeros(3) if p0 is None
                                               else p0),
                                  self._upload(q0), self._upload(phi),
                                  self.params)
        self.prev_t = t
        self.prev_phi = np.asarray(phi)

    def update_filter(self, t, acc, gyr, phi, dphi=None, foot_force=None):
        acc_f = self.filt_acc.update(acc)
        gyr_f = self.filt_gyr.update(gyr)
        phi_f = self.filt_phi.update(phi)
        dt = t - self.prev_t
        if dphi is None:
            # joint velocities by differentiating angles (reference README:133)
            dphi = (phi_f - self.prev_phi) / max(dt, 1e-6)
        if foot_force is None:
            foot_force = np.full(4, 100.0)
        self.prev_t = t
        self.prev_phi = phi_f
        if dt <= 0:
            return
        # one upload of the step's inputs, split on the device
        x = np.concatenate([[dt], acc_f, gyr_f, phi_f, np.ravel(dphi),
                            np.asarray(foot_force, float)])
        with on_stream(self.stream), record_function("ekf_step"):
            u = self._upload(x)
            self.state = ekf_step(self.state, u[0], u[1:4], u[4:7], u[7:19],
                                  u[19:31], u[31:35], self.params)

    def get_state(self) -> np.ndarray:
        """[0:3]=pos, [3:6]=vel (reference main.cpp:379-389 layout)."""
        s = self.state
        with on_stream(self.stream):
            return torch.cat([s.p, s.v, s.pf.reshape(-1)]).cpu().numpy()

    def get_contacts(self) -> np.ndarray:
        with on_stream(self.stream):
            return self.state.contacts.cpu().numpy()
