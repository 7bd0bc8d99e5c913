"""On-manifold preintegration of IMU and IMU+leg measurement streams (port
of `cerberus_tpu/ops/preintegration.py`).

One keyframe interval's samples are packed into fixed-size padded tensors
and integrated by a Python loop over the samples with a masked accept, the
counterpart of the JAX package's `lax.scan`. Same midpoint scheme and the
same error-state transition F (31x31) and noise map V (31x46) as the
reference (src/factor/imu_leg_integration_base.cpp:138-469).

State conventions:
  IMU delta state (15): [p, theta, v, ba, bg]
  IMU+leg error state (31): [p, theta, v, eps1..4, ba, bg, rho1..4]
  IMU+leg noise (46): [a_i, g_i, a_i1, g_i1, ba_w, bg_w, phi_i, phi_i1,
                       dphi_i, dphi_i1, v_leg1..4, n_rho1..4]

The pure-IMU 15-state path (`imu_preintegrate`, `imu_residual`;
reference: integration_base.h:65-198) and the IMU+leg residual
(`il_residual`) are the same formulas on torch tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.kinematics.leg import all_legs_fk_jac
from cerberus_tpu_torch.utils import lie


class PreintParams(NamedTuple):
    """Parameters of the preintegration (geometry + noise densities)."""

    rho_fix: torch.Tensor        # (4, 4) fixed leg geometry
    p_br: torch.Tensor           # (3,) IMU->robot-body translation
    R_br: torch.Tensor           # (3, 3) IMU->robot-body rotation
    acc_n: torch.Tensor          # () accel white noise (xy)
    acc_n_z: torch.Tensor        # () accel white noise (z)
    gyr_n: torch.Tensor
    acc_w: torch.Tensor
    gyr_w: torch.Tensor
    phi_n: torch.Tensor
    dphi_n: torch.Tensor
    rho_c_n: torch.Tensor        # rho random walk, in contact
    rho_nc_n: torch.Tensor       # rho random walk, no contact
    v_n_min_xy: torch.Tensor
    v_n_min_z: torch.Tensor
    v_n_min: torch.Tensor
    v_n_max: torch.Tensor
    v_n_force_thres_ratio: torch.Tensor
    v_n_term1_steep: torch.Tensor
    v_n_term2_var_rescale: torch.Tensor
    v_n_term3_distance_rescale: torch.Tensor
    # LO-consistency guard for contact models 0/1 (see the JAX package's
    # PreintParams.lo_guard): adds lo_guard * (v_leg - v_ref)^2 to the
    # per-leg velocity variance, v_ref an EMA of the fused LO velocity
    lo_guard: torch.Tensor
    contact_sensor_type: int = 0   # selects the contact model branch

    @staticmethod
    def from_config(cfg: C.EstimatorConfig, dtype=torch.float64, *,
                    device) -> "PreintParams":
        n = cfg.noise
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        return PreintParams(
            rho_fix=f(cfg.robot.rho_fix()),
            p_br=f(cfg.robot.p_br),
            R_br=f(cfg.robot.R_br),
            acc_n=f(n.acc_n), acc_n_z=f(n.acc_n_z), gyr_n=f(n.gyr_n),
            acc_w=f(n.acc_w), gyr_w=f(n.gyr_w),
            phi_n=f(n.joint_angle_n), dphi_n=f(n.joint_velocity_n),
            rho_c_n=f(n.leg_bias_c_n), rho_nc_n=f(n.leg_bias_nc_n),
            v_n_min_xy=f(n.v_n_min_xy), v_n_min_z=f(n.v_n_min_z),
            v_n_min=f(n.v_n_min), v_n_max=f(n.v_n_max),
            v_n_force_thres_ratio=f(n.v_n_force_thres_ratio),
            v_n_term1_steep=f(n.v_n_term1_steep),
            v_n_term2_var_rescale=f(n.v_n_term2_var_rescale),
            v_n_term3_distance_rescale=f(n.v_n_term3_distance_rescale),
            lo_guard=f(n.contact_lo_guard_rescale),
            contact_sensor_type=cfg.contact_sensor_type,
        )


class ImuPreint(NamedTuple):
    """Result of pure-IMU preintegration over one interval."""

    dp: torch.Tensor          # (3,)
    dq: torch.Tensor          # (4,) wxyz
    dv: torch.Tensor          # (3,)
    J: torch.Tensor           # (15, 15) d(delta)/d(state at linearization)
    P: torch.Tensor           # (15, 15) covariance
    sum_dt: torch.Tensor      # ()
    ba: torch.Tensor          # (3,) linearization accel bias
    bg: torch.Tensor          # (3,) linearization gyro bias


class ILPreint(NamedTuple):
    """Result of IMU+leg preintegration over one interval."""

    dp: torch.Tensor            # (3,)
    dq: torch.Tensor            # (4,)
    dv: torch.Tensor            # (3,)
    deps: torch.Tensor          # (4, 3) per-leg contact displacement
    sum_deps: torch.Tensor      # (3,) uncertainty-weighted fused displacement
    J: torch.Tensor             # (31, 31)
    P: torch.Tensor             # (31, 31)
    sum_dt: torch.Tensor        # ()
    ba: torch.Tensor            # (3,)
    bg: torch.Tensor            # (3,)
    rho: torch.Tensor           # (4,) linearization calf lengths
    contact_flag: torch.Tensor  # (4,) final-step contact flag
    integration_contact: torch.Tensor  # (4,) bool: leg stayed in contact
    # final adaptive foot-force tracker state (contact model 2), threaded
    # into the next interval's il_preintegrate(ff_init=...)
    ff_min: torch.Tensor        # (4,)
    ff_max: torch.Tensor        # (4,)
    ff_window: torch.Tensor     # (4, FOOT_VAR_WINDOW_SIZE)
    ff_idx: torch.Tensor        # (4,) int32


# ---------------------------------------------------------------------------
# Pure IMU (15-state) — reference: integration_base.h:65-140
# ---------------------------------------------------------------------------


def _imu_step(carry, inp, ba, bg, params: PreintParams):
    """One midpoint step of the 15-state preintegration; a masked accept
    (`valid`) keeps the carry on padding samples."""
    dp, dq, dv, J, P, sum_dt, acc_0, gyr_0 = carry
    dt, acc_1, gyr_1, valid = inp
    dtype, dev = dp.dtype, dp.device

    un_acc_0 = lie.quat_rotate(dq, acc_0 - ba)
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    dq_new = lie.quat_normalize(lie.quat_mul(dq, lie.delta_q(un_gyr * dt)))
    un_acc_1 = lie.quat_rotate(dq_new, acc_1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    R0 = lie.quat_to_rot(dq)
    R1 = lie.quat_to_rot(dq_new)
    Rw = lie.skew(un_gyr)
    Ra0 = lie.skew(acc_0 - ba)
    Ra1 = lie.skew(acc_1 - ba)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    k7 = I3 - Rw * dt

    F = torch.zeros((15, 15), dtype=dtype, device=dev)
    k1 = -0.5 * R0 @ Ra0 * dt - 0.5 * R1 @ Ra1 @ k7 * dt
    F[0:3, 0:3] = I3
    F[0:3, 3:6] = 0.5 * dt * k1
    F[0:3, 6:9] = I3 * dt
    F[0:3, 9:12] = -0.25 * (R0 + R1) * dt * dt
    F[0:3, 12:15] = 0.25 * R1 @ Ra1 * dt * dt * dt
    F[3:6, 3:6] = k7
    F[3:6, 12:15] = -I3 * dt
    F[6:9, 3:6] = k1
    F[6:9, 6:9] = I3
    F[6:9, 9:12] = -0.5 * (R0 + R1) * dt
    F[6:9, 12:15] = 0.5 * R1 @ Ra1 * dt * dt
    F[9:12, 9:12] = I3
    F[12:15, 12:15] = I3

    V = torch.zeros((15, 18), dtype=dtype, device=dev)
    Vg = -0.25 * R1 @ Ra1 * dt * dt * 0.5 * dt
    V[0:3, 0:3] = 0.25 * R0 * dt * dt
    V[0:3, 3:6] = Vg
    V[0:3, 6:9] = 0.25 * R1 * dt * dt
    V[0:3, 9:12] = Vg
    V[3:6, 3:6] = 0.5 * I3 * dt
    V[3:6, 9:12] = 0.5 * I3 * dt
    V[6:9, 0:3] = 0.5 * R0 * dt
    Vg2 = -0.5 * R1 @ Ra1 * dt * 0.5 * dt
    V[6:9, 3:6] = Vg2
    V[6:9, 6:9] = 0.5 * R1 * dt
    V[6:9, 9:12] = Vg2
    V[9:12, 12:15] = I3 * dt
    V[12:15, 15:18] = I3 * dt

    an2, anz2, gn2 = params.acc_n ** 2, params.acc_n_z ** 2, params.gyr_n ** 2
    aw2, gw2 = params.acc_w ** 2, params.gyr_w ** 2
    noise = torch.cat([torch.stack([an2, an2, anz2, gn2, gn2, gn2,
                                    an2, an2, anz2, gn2, gn2, gn2]),
                       aw2.expand(3), gw2.expand(3)]).to(dtype)

    J_new = F @ J
    P_new = F @ P @ F.T + (V * noise[None, :]) @ V.T

    new = (dp_new, dq_new, dv_new, J_new, P_new, sum_dt + dt, acc_1, gyr_1)
    return tuple(torch.where(valid, a, b) for a, b in zip(new, carry))


def imu_preintegrate(dt, acc, gyr, mask, ba, bg,
                     params: PreintParams) -> ImuPreint:
    """Integrate one interval of IMU samples.

    Args:
      dt:  (S,) step durations; dt[k] spans sample k-1 -> k, with sample 0
           given by acc[0]/gyr[0] and dt[0] unused (set mask[0]=False).
      acc: (S, 3), gyr: (S, 3) raw samples (sample 0 = linearization sample).
      mask: (S,) bool; False entries are padding (carry passes through).
      ba, bg: (3,) linearization biases.
    Runs on the inputs' device, one eager step per sample.
    """
    dtype, dev = acc.dtype, acc.device
    carry = (torch.zeros(3, dtype=dtype, device=dev),
             lie.quat_identity(dtype, device=dev),
             torch.zeros(3, dtype=dtype, device=dev),
             torch.eye(15, dtype=dtype, device=dev),
             torch.zeros((15, 15), dtype=dtype, device=dev),
             torch.zeros((), dtype=dtype, device=dev), acc[0], gyr[0])
    for k in range(1, dt.shape[0]):
        carry = _imu_step(carry, (dt[k], acc[k], gyr[k], mask[k]), ba, bg,
                          params)
    dp, dq, dv, J, P, sum_dt, _, _ = carry
    return ImuPreint(dp, dq, dv, J, P, sum_dt, ba, bg)


def imu_residual(pre: ImuPreint, state_i, state_j, gravity):
    """15-dim bias-corrected residual (reference: integration_base.h:172-198).

    state_{i,j}: dicts with p (3,), q (4,), v (3,), ba (3,), bg (3,).
    """
    dba = state_i["ba"] - pre.ba
    dbg = state_i["bg"] - pre.bg
    dp = pre.dp + pre.J[0:3, 9:12] @ dba + pre.J[0:3, 12:15] @ dbg
    dq = lie.quat_mul(pre.dq, lie.delta_q(pre.J[3:6, 12:15] @ dbg))
    dv = pre.dv + pre.J[6:9, 9:12] @ dba + pre.J[6:9, 12:15] @ dbg

    qi_inv = lie.quat_conj(state_i["q"])
    r_p = lie.quat_rotate(
        qi_inv,
        0.5 * gravity * pre.sum_dt ** 2 + state_j["p"] - state_i["p"]
        - state_i["v"] * pre.sum_dt,
    ) - dp
    q_err = lie.quat_mul(lie.quat_conj(dq), lie.quat_mul(qi_inv, state_j["q"]))
    r_q = 2.0 * q_err[1:]
    r_v = lie.quat_rotate(
        qi_inv, gravity * pre.sum_dt + state_j["v"] - state_i["v"]) - dv
    return torch.cat([r_p, r_q, r_v, state_j["ba"] - state_i["ba"],
                      state_j["bg"] - state_i["bg"]])


# ---------------------------------------------------------------------------
# IMU + leg (31-state) — reference: imu_leg_integration_base.cpp:138-469
# ---------------------------------------------------------------------------

_EPS = C.ILO_EPS
_BA, _BG, _RHO = C.ILO_BA, C.ILO_BG, C.ILO_RHO


class _ILCarry(NamedTuple):
    dp: torch.Tensor
    dq: torch.Tensor
    dv: torch.Tensor
    deps: torch.Tensor       # (4, 3)
    sum_deps: torch.Tensor   # (3,)
    J: torch.Tensor          # (31, 31)
    P: torch.Tensor          # (31, 31)
    sum_dt: torch.Tensor
    acc_0: torch.Tensor
    gyr_0: torch.Tensor
    phi_0: torch.Tensor      # (12,)
    dphi_0: torch.Tensor     # (12,)
    c_0: torch.Tensor        # (4,)
    ff_min: torch.Tensor     # (4,) foot-force min tracker (type 2)
    ff_max: torch.Tensor     # (4,)
    ff_window: torch.Tensor  # (4, FOOT_VAR_WINDOW_SIZE)
    ff_idx: torch.Tensor     # (4,) int32 ring index
    contact_flag: torch.Tensor          # (4,)
    integration_contact: torch.Tensor   # (4,) bool
    lo_ref: torch.Tensor     # (3,) EMA of fused LO velocity (lo_guard ref)
    lo_ref_w: torch.Tensor   # () ref validity ramp in [0, 1]


def _leg_kin(phi, rho, params: PreintParams):
    """FK bundle (kinematics.leg.all_legs_fk_jac) of joint angles phi
    (..., 12) at calf lengths rho (4,): fk, J, dfk_drho, dJ_dq, dJ_drho with
    leading dims (..., 4)."""
    lead = phi.shape[:-1]
    return all_legs_fk_jac(phi.reshape(lead + (4, 3)),
                           rho.reshape(4, C.RHO_OPT_SIZE), params.rho_fix)


def _leg_velocities(kin, dphi, gyr_unbiased, params: PreintParams):
    """Per-leg body-frame velocity measurement and foot positions.

    v_j = -R_br @ J_j @ dphi_j - [w]x (p_br + R_br @ fk_j)
    (reference: imu_leg_integration_base.cpp:242-247)
    """
    w_x = lie.skew(gyr_unbiased)
    foot_b = params.p_br[None, :] + kin["fk"] @ params.R_br.T        # (4,3)
    v = (-(params.R_br @ (kin["J"] @ dphi.reshape(4, 3, 1))[..., 0].T).T
         - foot_b @ w_x.T)
    return v, foot_b


def _gh_terms(Rq, kin, dphi, w_x, params: PreintParams):
    """g = d v/d rho (3, R), h = d v/d phi (3, 3) per leg, rotated by delta_q
    (reference: imu_leg_integration_base.cpp:259-287)."""
    dphi_l = dphi.reshape(4, 3)
    # kron(dphi) @ dJ_dx contracts the 9-dim column-major J axis with dphi
    # (written as broadcast products and matmuls: torch.einsum's path
    # search costs more than the arithmetic at these sizes)
    dJr = kin["dJ_drho"].reshape(4, 3, 3, C.RHO_OPT_SIZE)  # (leg, col k, row, R)
    kron_dJr = (dphi_l[:, :, None, None] * dJr).sum(1)     # (4, 3, R)
    dJq = kin["dJ_dq"].reshape(4, 3, 3, 3)
    kron_dJq = (dphi_l[:, :, None, None] * dJq).sum(1)     # (4, 3, 3)

    Rbr = params.R_br
    wR = w_x @ Rbr
    g = -(Rq @ (Rbr @ kron_dJr + wR @ kin["dfk_drho"]))
    h = Rq @ (Rbr @ kron_dJq + wR @ kin["J"])
    return g, h


def il_init_carry(acc_0, gyr_0, phi_0, dphi_0, c_0,
                  ff_init=None) -> _ILCarry:
    """Fresh integration carry anchored at the given first sample.

    ff_init: optional (ff_min, ff_max, ff_window, ff_idx) carried over from
    the previous interval."""
    dtype, dev = acc_0.dtype, acc_0.device
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    if ff_init is None:
        ff_init = (z(4), z(4), z(4, C.FOOT_VAR_WINDOW_SIZE),
                   torch.zeros(4, dtype=torch.int32, device=dev))
    return _ILCarry(
        dp=z(3), dq=lie.quat_identity(dtype, device=dev), dv=z(3), deps=z(4, 3),
        sum_deps=z(3),
        J=torch.eye(31, dtype=dtype, device=dev), P=z(31, 31),
        sum_dt=z(),
        acc_0=acc_0, gyr_0=gyr_0, phi_0=phi_0, dphi_0=dphi_0, c_0=c_0,
        ff_min=torch.as_tensor(ff_init[0], dtype=dtype, device=dev),
        ff_max=torch.as_tensor(ff_init[1], dtype=dtype, device=dev),
        ff_window=torch.as_tensor(ff_init[2], dtype=dtype, device=dev),
        ff_idx=torch.as_tensor(ff_init[3], dtype=torch.int32, device=dev),
        contact_flag=z(4),
        integration_contact=torch.ones(4, dtype=torch.bool, device=dev),
        lo_ref=z(3), lo_ref_w=z(),
    )


def il_step_full(carry: _ILCarry, inp, ba, bg, rho, params: PreintParams):
    """One midpoint step; returns (new_carry, F, V, noise_diag)."""
    kin0 = _leg_kin(carry.phi_0, rho, params)
    kin1 = _leg_kin(inp[3], rho, params)
    return _il_step(carry, inp, kin0, kin1, ba, bg, params)


def _il_step(carry: _ILCarry, inp, kin0, kin1, ba, bg, params: PreintParams):
    """il_step_full with the FK bundles of carry.phi_0 (kin0) and phi_1
    (kin1) given: il_preintegrate computes them for a whole interval in one
    batched call, since they depend on the joint angles and the fixed
    linearization rho only."""
    dt, acc_1, gyr_1, phi_1, dphi_1, c_1, valid = inp
    dtype, dev = carry.dp.dtype, carry.dp.device
    I3 = torch.eye(3, dtype=dtype, device=dev)

    # --- IMU midpoint ---
    un_acc_0 = lie.quat_rotate(carry.dq, carry.acc_0 - ba)
    un_gyr = 0.5 * (carry.gyr_0 + gyr_1) - bg
    dq_new = lie.quat_normalize(lie.quat_mul(carry.dq, lie.delta_q(un_gyr * dt)))
    un_acc_1 = lie.quat_rotate(dq_new, acc_1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    dp_new = carry.dp + carry.dv * dt + 0.5 * un_acc * dt * dt
    dv_new = carry.dv + un_acc * dt

    # --- contact flag + foot-force statistics ---
    if params.contact_sensor_type in (0, 1):
        contact = (c_1 >= 0.5).to(dtype)
        ff_min, ff_max, ff_window, ff_idx = (
            carry.ff_min, carry.ff_max, carry.ff_window, carry.ff_idx)
        ff_var = torch.zeros(4, dtype=dtype, device=dev)
    else:
        force = 0.5 * (carry.c_0 + c_1)
        ff_min = torch.where(force < carry.ff_min,
                             0.9 * carry.ff_min + 0.1 * force, carry.ff_min)
        ff_max = torch.where(force > carry.ff_max,
                             0.9 * carry.ff_max + 0.1 * force, carry.ff_max)
        ff_min = ff_min * 0.9991
        ff_max = ff_max * 0.997
        thres = ff_min + params.v_n_force_thres_ratio * (ff_max - ff_min)
        contact = torch.sigmoid(params.v_n_term1_steep * (force - thres))
        ff_idx = (carry.ff_idx + 1) % C.FOOT_VAR_WINDOW_SIZE
        ff_window = carry.ff_window.clone()
        ff_window[torch.arange(4, device=dev), ff_idx.long()] = force
        mean = torch.mean(ff_window, dim=1, keepdim=True)
        ff_var = torch.sum((ff_window - mean) ** 2, dim=1) / (
            C.FOOT_VAR_WINDOW_SIZE - 1)
    integration_contact = carry.integration_contact & (contact >= 0.5)

    # --- leg-odometry velocities at both endpoints ---
    w0 = carry.gyr_0 - bg
    w1 = gyr_1 - bg
    vi, foot0 = _leg_velocities(kin0, carry.dphi_0, w0, params)
    vip1, foot1 = _leg_velocities(kin1, dphi_1, w1, params)
    R0 = lie.quat_to_rot(carry.dq)
    R1 = lie.quat_to_rot(dq_new)
    lo_vel = 0.5 * (vi @ R0.T + vip1 @ R1.T)        # (4, 3) world(frame-i) vel
    deps_new = carry.deps + lo_vel * dt

    # --- adaptive measurement noise per leg ---
    if params.contact_sensor_type in (0, 1):
        n_xy = params.v_n_max * (1 - contact) + contact * params.v_n_min_xy
        n_z = params.v_n_max * (1 - contact) + contact * params.v_n_min_z
        unc_base = torch.stack([n_xy, n_xy, n_z], dim=1)           # (4, 3)
        uncertainties = unc_base + params.lo_guard * carry.lo_ref_w \
            * (lo_vel - carry.lo_ref[None, :]) ** 2
    else:
        n1 = params.v_n_max * (1 - contact) + params.v_n_min      # (4,)
        n2 = params.v_n_term2_var_rescale * ff_var                # (4,)
        n3 = params.v_n_term3_distance_rescale * (lo_vel - carry.dv) ** 2
        uncertainties = n1[:, None] + n2[:, None] + n3            # (4, 3)

    rho_uncertainty = params.rho_c_n * contact + params.rho_nc_n  # (4,)

    # uncertainty-weighted fusion of the four LO velocities
    wsum = (params.v_n_max + params.v_n_term2_var_rescale
            + params.v_n_term3_distance_rescale)
    weight = torch.clamp(wsum / uncertainties, min=0.001)
    avg_deps = torch.sum(weight * lo_vel, dim=0) * dt / torch.sum(weight, dim=0)
    sum_deps_new = carry.sum_deps + avg_deps
    # lo_guard consensus reference: EMA of the guarded fused LO velocity
    ref_v = torch.sum(weight * lo_vel, dim=0) / torch.sum(weight, dim=0)
    alpha = 0.2
    lo_ref_new = (1 - alpha) * carry.lo_ref + alpha * ref_v
    lo_ref_w_new = torch.clamp(carry.lo_ref_w + 0.2, max=1.0)

    # all-feet-airborne: leg residuals get ~infinite noise
    airborne = torch.sum(contact) < 1e-6
    rho_uncertainty = torch.where(airborne, params.rho_nc_n, rho_uncertainty)
    uncertainties = torch.where(airborne, torch.full_like(uncertainties, 1e11),
                                uncertainties)

    # --- error-state transition F (31x31) and noise mapping V (31x46) ---
    Rw = lie.skew(un_gyr)
    Ra0 = lie.skew(carry.acc_0 - ba)
    Ra1 = lie.skew(acc_1 - ba)
    k7 = I3 - Rw * dt
    k1 = -0.5 * R0 @ Ra0 * dt - 0.5 * R1 @ Ra1 @ k7 * dt

    F = torch.zeros((31, 31), dtype=dtype, device=dev)
    F[0:3, 0:3] = I3
    F[0:3, 3:6] = 0.5 * dt * k1
    F[0:3, 6:9] = I3 * dt
    F[0:3, _BA:_BA + 3] = -0.25 * (R0 + R1) * dt * dt
    F[0:3, _BG:_BG + 3] = 0.25 * R1 @ Ra1 * dt ** 3
    F[3:6, 3:6] = k7
    F[3:6, _BG:_BG + 3] = -I3 * dt
    F[6:9, 3:6] = k1
    F[6:9, 6:9] = I3
    F[6:9, _BA:_BA + 3] = -0.5 * (R0 + R1) * dt
    F[6:9, _BG:_BG + 3] = 0.5 * R1 @ Ra1 * dt * dt

    g0, h0 = _gh_terms(R0, kin0, carry.dphi_0, lie.skew(w0), params)
    g1, h1 = _gh_terms(R1, kin1, dphi_1, lie.skew(w1), params)

    skew_vi = lie.skew(vi)        # (4, 3, 3)
    skew_vip1 = lie.skew(vip1)
    skew_f0 = lie.skew(foot0)
    skew_f1 = lie.skew(foot1)
    for j in range(C.NUM_OF_LEG):
        r = _EPS + 3 * j
        F[r:r + 3, 3:6] = (-0.5 * dt * R0 @ skew_vi[j]
                           - 0.5 * dt * R1 @ skew_vip1[j] @ k7)
        F[r:r + 3, r:r + 3] = I3
        F[r:r + 3, _BG:_BG + 3] = (
            0.5 * dt * dt * R1 @ skew_vip1[j]
            - 0.5 * dt * (R0 @ skew_f0[j] + R1 @ skew_f1[j]))
        F[r:r + 3, _RHO + j:_RHO + j + 1] = 0.5 * dt * (g0[j] + g1[j])
    F[_BA:_BA + 3, _BA:_BA + 3] = I3
    F[_BG:_BG + 3, _BG:_BG + 3] = I3
    F[_RHO:_RHO + 4, _RHO:_RHO + 4] = torch.eye(4, dtype=dtype, device=dev)

    V = torch.zeros((31, 46), dtype=dtype, device=dev)
    Vg = 0.25 * -R1 @ Ra1 * dt * dt * 0.5 * dt
    V[0:3, 0:3] = 0.25 * R0 * dt * dt
    V[0:3, 3:6] = Vg
    V[0:3, 6:9] = 0.25 * R1 * dt * dt
    V[0:3, 9:12] = Vg
    V[3:6, 3:6] = 0.5 * I3 * dt
    V[3:6, 9:12] = 0.5 * I3 * dt
    V[6:9, 0:3] = 0.5 * R0 * dt
    Vg2 = 0.5 * -R1 @ Ra1 * dt * 0.5 * dt
    V[6:9, 3:6] = Vg2
    V[6:9, 6:9] = 0.5 * R1 * dt
    V[6:9, 9:12] = Vg2
    for j in range(C.NUM_OF_LEG):
        r = _EPS + 3 * j
        V[r:r + 3, C.ILNO_GI:C.ILNO_GI + 3] = (
            -0.25 * dt * dt * R1 @ skew_vip1[j] + 0.5 * dt * R0 @ skew_f0[j])
        V[r:r + 3, C.ILNO_GI1:C.ILNO_GI1 + 3] = (
            -0.25 * dt * dt * R1 @ skew_vip1[j] + 0.5 * dt * R1 @ skew_f1[j])
        V[r:r + 3, C.ILNO_PHI:C.ILNO_PHI + 3] = -0.5 * dt * h0[j]
        V[r:r + 3, C.ILNO_PHI1:C.ILNO_PHI1 + 3] = -0.5 * dt * h1[j]
        V[r:r + 3, C.ILNO_DPHI:C.ILNO_DPHI + 3] = (
            -0.5 * dt * R0 @ params.R_br @ kin0["J"][j])
        V[r:r + 3, C.ILNO_DPHI1:C.ILNO_DPHI1 + 3] = (
            -0.5 * dt * R1 @ params.R_br @ kin1["J"][j])
        V[r:r + 3, C.ILNO_V + 3 * j:C.ILNO_V + 3 * j + 3] = -I3 * dt
    V[_BA:_BA + 3, C.ILNO_BA:C.ILNO_BA + 3] = -I3 * dt
    V[_BG:_BG + 3, C.ILNO_BG:C.ILNO_BG + 3] = -I3 * dt
    V[_RHO:_RHO + 4, C.ILNO_NRHO:C.ILNO_NRHO + 4] = (
        -torch.eye(4, dtype=dtype, device=dev) * dt)

    an2, anz2, gn2 = params.acc_n ** 2, params.acc_n_z ** 2, params.gyr_n ** 2
    full = lambda k, x: x.reshape(1).expand(k)
    noise = torch.cat([
        torch.stack([an2, an2, anz2, gn2, gn2, gn2,
                     an2, an2, anz2, gn2, gn2, gn2]),
        full(3, params.acc_w ** 2), full(3, params.gyr_w ** 2),
        full(6, params.phi_n ** 2), full(6, params.dphi_n ** 2),
        uncertainties.reshape(-1),
        rho_uncertainty,
    ])

    J_new = F @ carry.J
    P_new = F @ carry.P @ F.T + (V * noise[None, :]) @ V.T

    new = _ILCarry(
        dp=dp_new, dq=dq_new, dv=dv_new, deps=deps_new, sum_deps=sum_deps_new,
        J=J_new, P=P_new, sum_dt=carry.sum_dt + dt,
        acc_0=acc_1, gyr_0=gyr_1, phi_0=phi_1, dphi_0=dphi_1, c_0=c_1,
        ff_min=ff_min, ff_max=ff_max, ff_window=ff_window, ff_idx=ff_idx,
        contact_flag=contact, integration_contact=integration_contact,
        lo_ref=lo_ref_new, lo_ref_w=lo_ref_w_new,
    )
    out = _ILCarry(*(torch.where(valid, a, b) for a, b in zip(new, carry)))
    return out, F, V, noise


def il_preintegrate(dt, acc, gyr, phi, dphi, c, mask, ba, bg, rho,
                    params: PreintParams, ff_init=None) -> ILPreint:
    """Integrate one interval of synced IMU+leg samples.

    Args:
      dt: (S,) step durations (dt[0] unused; mask[0] must be False).
      acc/gyr: (S, 3); phi/dphi: (S, 12); c: (S, 4) contact flags or forces.
      mask: (S,) bool validity.
      ba, bg: (3,); rho: (4,) linearization points.
      ff_init: optional previous-interval (ff_min, ff_max, ff_window,
        ff_idx) for the contact model 2 adaptive force threshold.

    Runs on the inputs' device, one eager step per sample; callers wrap it
    in `device.matmul_precision("highest")` on the card (the JAX package
    pins 'highest' matmul precision here for the rho-calibration terms).
    """
    carry = il_init_carry(acc[0], gyr[0], phi[0], dphi[0], c[0],
                          ff_init=ff_init)
    kin = _leg_kin(phi, rho, params)
    kin0 = {name: x[0] for name, x in kin.items()}
    for k in range(1, dt.shape[0]):
        inp = (dt[k], acc[k], gyr[k], phi[k], dphi[k], c[k], mask[k])
        kin1 = {name: x[k] for name, x in kin.items()}
        carry, _, _, _ = _il_step(carry, inp, kin0, kin1, ba, bg, params)
        # the carry's phi_0 advances only on valid samples; so does kin0
        kin0 = {name: torch.where(mask[k], kin1[name], kin0[name])
                for name in kin}
    return ILPreint(
        dp=carry.dp, dq=carry.dq, dv=carry.dv, deps=carry.deps,
        sum_deps=carry.sum_deps, J=carry.J, P=carry.P, sum_dt=carry.sum_dt,
        ba=ba, bg=bg, rho=rho, contact_flag=carry.contact_flag,
        integration_contact=carry.integration_contact,
        ff_min=carry.ff_min, ff_max=carry.ff_max, ff_window=carry.ff_window,
        ff_idx=carry.ff_idx,
    )


# ---------------------------------------------------------------------------
# Parallel (log-depth) IMU+leg preintegration
# ---------------------------------------------------------------------------


def _quat_prefix(dq_steps):
    """Inclusive prefix product dq_steps[0] (x) ... (x) dq_steps[k] of
    per-step quaternions (T, 4), normalized: log2(T) Hillis-Steele rounds in
    place of `lax.associative_scan` (a later rotation composes on the right,
    as in the sequential dq_new = dq (x) delta_q)."""
    out = dq_steps
    off = 1
    while off < out.shape[0]:
        out = torch.cat([out[:off], quat_mul_assoc(out[:-off], out[off:])])
        off *= 2
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def quat_mul_assoc(q, p):
    """Hamilton product broadcast over leading axes: the combine of a
    parallel prefix of rotations, dq_total = dq_a (x) dq_b with a preceding
    b in scan order (a later rotation composes on the right, matching the
    sequential dq_new = dq (x) delta_q). `_quat_prefix` applies it."""
    return lie.quat_mul(q, p)


def _check_contiguous_mask(mask):
    """The mask contract of il_preintegrate_parallel, checked where the mask
    is on the host (a mask on the card is the caller's responsibility: the
    check would read it back)."""
    if mask.device.type != "cpu":
        return
    m = mask.numpy().astype(bool)
    if m.any():
        first = int(m.argmax())
        if not m[first:first + int(m.sum())].all():
            raise ValueError("il_preintegrate_parallel requires a contiguous "
                             "mask (trailing padding only); got interior holes")


def il_preintegrate_parallel(dt, acc, gyr, phi, dphi, c, mask, ba, bg, rho,
                             params: PreintParams, ff_init=None) -> ILPreint:
    """Log-depth form of `il_preintegrate`: the same result to
    floating-point reassociation (1e-10 in f64), port of the JAX package's
    `il_preintegrate_parallel`.

      * the step quaternion chain is a prefix product (`_quat_prefix`);
      * dp/dv/eps accumulate as cumulative sums of per-sample terms;
      * leg FK and its derivatives are evaluated once over all S samples;
      * J' = F J, P' = F P F^T + V n V^T compose as (F2, Q2) o (F1, Q1) =
        (F2 F1, F2 Q1 F2^T + Q2), reduced by a log2(S)-level pairwise tree of
        batched 31x31 matmuls;
      * the contact bookkeeping (adaptive foot-force min/max/variance for
        contact model 2, the lo_guard reference EMA for models 0/1) stays a
        short sequential loop over (4,)-vectors, as in the JAX function.

    MASK CONTRACT: `mask` must be True on samples [1, n) and False elsewhere
    (trailing padding only). With interior holes the sequential form carries
    the last valid sample across the hole and this one does not. A mask on
    the CPU is checked; a mask on the card is not (that would read it back).

    Runs on the inputs' device with no read-back to the host."""
    _check_contiguous_mask(mask)
    dtype, dev = acc.dtype, acc.device
    S = acc.shape[0]
    T = S - 1
    I3 = torch.eye(3, dtype=dtype, device=dev)
    valid = mask[1:]
    dtv = torch.where(valid, dt[1:], torch.zeros_like(dt[1:])).to(dtype)

    # --- quaternion prefix ---
    un_gyr = 0.5 * (gyr[:-1] + gyr[1:]) - bg                  # (T, 3)
    dq_step = lie.delta_q(un_gyr * dtv[:, None])              # (T, 4)
    dq_pref = _quat_prefix(dq_step)                           # (T, 4)
    # per-SAMPLE attitude: R_all[s] = R(dq after sample s), R_all[0] = I
    q_id = torch.cat([torch.ones((1, 1), dtype=dtype, device=dev),
                      torch.zeros((1, 3), dtype=dtype, device=dev)], dim=1)
    R_all = lie.quat_to_rot(torch.cat([q_id, dq_pref]))       # (S, 3, 3)
    R0 = R_all[:-1]
    R1 = R_all[1:]

    # --- IMU deltas via cumulative sums of per-sample rotated terms ---
    ua = (R_all @ (acc - ba)[:, :, None])[..., 0]             # (S, 3)
    un_acc = 0.5 * (ua[:-1] + ua[1:])                         # (T, 3)
    dv_pref = torch.cumsum(un_acc * dtv[:, None], dim=0)
    dv_prev = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                         dv_pref[:-1]])
    dp = torch.sum(dv_prev * dtv[:, None]
                   + 0.5 * un_acc * dtv[:, None] ** 2, dim=0)
    dv = dv_pref[-1]

    # --- legs: FK bundle and velocities over ALL samples ---
    kin = _leg_kin(phi, rho, params)                          # (S, 4, ...)
    w_all = gyr - bg                                          # (S, 3)
    Rbr = params.R_br
    foot = params.p_br + kin["fk"] @ Rbr.T                    # (S, 4, 3)
    dphi_l = dphi.reshape(S, 4, 3)
    v_all = (-(kin["J"] @ dphi_l[..., None])[..., 0] @ Rbr.T
             - lie.cross(w_all[:, None, :], foot))            # (S, 4, 3)
    rv = v_all @ R_all.transpose(-1, -2)                      # rotated
    lo_vel = 0.5 * (rv[:-1] + rv[1:])                         # (T, 4, 3)
    deps = torch.sum(lo_vel * dtv[:, None, None], dim=0)      # (4, 3)

    # --- contact state ---
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    if ff_init is None:
        ff_init = (z(4), z(4), z(4, C.FOOT_VAR_WINDOW_SIZE),
                   torch.zeros(4, dtype=torch.int32, device=dev))
    ff_min, ff_max, ff_window, ff_idx = (
        torch.as_tensor(ff_init[0], dtype=dtype, device=dev),
        torch.as_tensor(ff_init[1], dtype=dtype, device=dev),
        torch.as_tensor(ff_init[2], dtype=dtype, device=dev),
        torch.as_tensor(ff_init[3], dtype=torch.int32, device=dev))
    if params.contact_sensor_type in (0, 1):
        contact = ((c[1:] >= 0.5) & valid[:, None]).to(dtype)  # (T, 4)
        ff_var = z(T, 4)
    else:
        force = 0.5 * (c[:-1] + c[1:])                        # (T, 4)
        contact_rows, var_rows = [], []
        for k in range(T):
            f_, ok = force[k], valid[k]
            nmin = torch.where(f_ < ff_min, 0.9 * ff_min + 0.1 * f_,
                               ff_min) * 0.9991
            nmax = torch.where(f_ > ff_max, 0.9 * ff_max + 0.1 * f_,
                               ff_max) * 0.997
            thres = nmin + params.v_n_force_thres_ratio * (nmax - nmin)
            ct = torch.sigmoid(params.v_n_term1_steep * (f_ - thres))
            nidx = (ff_idx + 1) % C.FOOT_VAR_WINDOW_SIZE
            nwin = ff_window.scatter(1, nidx[:, None].long(), f_[:, None])
            mean = torch.mean(nwin, dim=1, keepdim=True)
            var = torch.sum((nwin - mean) ** 2, dim=1) \
                / (C.FOOT_VAR_WINDOW_SIZE - 1)
            ff_min = torch.where(ok, nmin, ff_min)
            ff_max = torch.where(ok, nmax, ff_max)
            ff_window = torch.where(ok, nwin, ff_window)
            ff_idx = torch.where(ok, nidx, ff_idx)
            contact_rows.append(torch.where(ok, ct, torch.zeros_like(ct)))
            var_rows.append(torch.where(ok, var, torch.zeros_like(var)))
        contact = torch.stack(contact_rows)
        ff_var = torch.stack(var_rows)
    # final flag = the last VALID step's (sequential carry semantics)
    has_valid = torch.any(valid)
    last = T - 1 - torch.argmax(valid.flip(0).to(torch.int32))
    last = torch.where(has_valid, last, torch.zeros_like(last))
    contact_final = torch.where(
        has_valid, torch.index_select(contact, 0, last.reshape(1))[0], z(4))
    int_contact = torch.all((contact >= 0.5) | ~valid[:, None], dim=0)

    # --- adaptive noise + fusion (elementwise over T) ---
    wsum = (params.v_n_max + params.v_n_term2_var_rescale
            + params.v_n_term3_distance_rescale)
    if params.contact_sensor_type in (0, 1):
        n_xy = params.v_n_max * (1 - contact) + contact * params.v_n_min_xy
        n_z = params.v_n_max * (1 - contact) + contact * params.v_n_min_z
        unc_base = torch.stack([n_xy, n_xy, n_z], dim=2)      # (T, 4, 3)
        # the lo_guard consensus EMA feeds the guarded weights back into its
        # own reference: a genuine nonlinear recursion over (3,) + ()
        lo_ref, ramp = z(3), z()
        rows = []
        for k in range(T):
            ok = valid[k]
            unc = unc_base[k] + params.lo_guard * ramp \
                * (lo_vel[k] - lo_ref[None, :]) ** 2
            w = torch.clamp(wsum / unc, min=0.001)
            ref_v = torch.sum(w * lo_vel[k], dim=0) / torch.sum(w, dim=0)
            lo_ref = torch.where(ok, (1 - 0.2) * lo_ref + 0.2 * ref_v, lo_ref)
            ramp = torch.where(ok, torch.clamp(ramp + 0.2, max=1.0), ramp)
            rows.append(unc)
        uncertainties = torch.stack(rows)
    else:
        n1 = params.v_n_max * (1 - contact) + params.v_n_min   # (T, 4)
        n2 = params.v_n_term2_var_rescale * ff_var
        n3 = params.v_n_term3_distance_rescale \
            * (lo_vel - dv_prev[:, None, :]) ** 2
        uncertainties = n1[..., None] + n2[..., None] + n3

    rho_uncertainty = params.rho_c_n * contact + params.rho_nc_n  # (T, 4)
    weight = torch.clamp(wsum / uncertainties, min=0.001)
    avg_deps = torch.sum(weight * lo_vel, dim=1) * dtv[:, None] \
        / torch.sum(weight, dim=1)
    sum_deps = torch.sum(avg_deps, dim=0)

    airborne = torch.sum(contact, dim=1) < 1e-6               # (T,)
    rho_uncertainty = torch.where(airborne[:, None], params.rho_nc_n,
                                  rho_uncertainty)
    uncertainties = torch.where(airborne[:, None, None],
                                torch.full_like(uncertainties, 1e11),
                                uncertainties)

    # --- batched F (T,31,31) / V (T,31,46) / noise (T,46) ---
    Rw = lie.skew(un_gyr)                                     # (T, 3, 3)
    Ra0 = lie.skew(acc[:-1] - ba)
    Ra1 = lie.skew(acc[1:] - ba)
    d1 = dtv[:, None, None]
    k7 = I3 - Rw * d1
    R1Ra1 = R1 @ Ra1
    k1 = -0.5 * (R0 @ Ra0) * d1 - 0.5 * (R1Ra1 @ k7) * d1

    # per-sample g/h (each sample is the endpoint of two steps)
    dJr = kin["dJ_drho"].reshape(S, 4, 3, 3, C.RHO_OPT_SIZE)
    kron_dJr = (dphi_l[..., None, None] * dJr).sum(2)         # (S, 4, 3, R)
    dJq = kin["dJ_dq"].reshape(S, 4, 3, 3, 3)
    kron_dJq = (dphi_l[..., None, None] * dJq).sum(2)         # (S, 4, 3, 3)
    wxR = (lie.skew(w_all) @ Rbr)[:, None]                    # (S, 1, 3, 3)
    Rl = R_all[:, None]                                       # (S, 1, 3, 3)
    g_all = -(Rl @ (Rbr @ kron_dJr + wxR @ kin["dfk_drho"]))
    h_all = Rl @ (Rbr @ kron_dJq + wxR @ kin["J"])
    sk_v = lie.skew(v_all)                                    # (S, 4, 3, 3)
    sk_f = lie.skew(foot)
    sv0, sv1 = sk_v[:-1], sk_v[1:]
    sf0, sf1 = sk_f[:-1], sk_f[1:]

    F = torch.zeros((T, 31, 31), dtype=dtype, device=dev)
    F[:, 0:3, 0:3] = I3
    F[:, 0:3, 3:6] = 0.5 * d1 * k1
    F[:, 0:3, 6:9] = I3 * d1
    F[:, 0:3, _BA:_BA + 3] = -0.25 * (R0 + R1) * d1 ** 2
    F[:, 0:3, _BG:_BG + 3] = 0.25 * R1Ra1 * d1 ** 3
    F[:, 3:6, 3:6] = k7
    F[:, 3:6, _BG:_BG + 3] = -I3 * d1
    F[:, 6:9, 3:6] = k1
    F[:, 6:9, 6:9] = I3
    F[:, 6:9, _BA:_BA + 3] = -0.5 * (R0 + R1) * d1
    F[:, 6:9, _BG:_BG + 3] = 0.5 * R1Ra1 * d1 ** 2
    d2 = dtv[:, None, None, None]
    R0l = R0[:, None]                                         # (T,1,3,3)
    R1l = R1[:, None]
    R1sv1 = R1l @ sv1
    eps_R = -0.5 * d2 * (R0l @ sv0) - 0.5 * d2 * R1sv1 @ k7[:, None]
    eps_BG = 0.5 * d2 ** 2 * R1sv1 - 0.5 * d2 * (R0l @ sf0 + R1l @ sf1)
    eps_RHO = 0.5 * d2 * (g_all[:-1] + g_all[1:])             # (T,4,3,R)
    for j in range(C.NUM_OF_LEG):
        r = _EPS + 3 * j
        F[:, r:r + 3, 3:6] = eps_R[:, j]
        F[:, r:r + 3, r:r + 3] = I3
        F[:, r:r + 3, _BG:_BG + 3] = eps_BG[:, j]
        F[:, r:r + 3, _RHO + j:_RHO + j + 1] = eps_RHO[:, j]
    F[:, _BA:_BA + 3, _BA:_BA + 3] = I3
    F[:, _BG:_BG + 3, _BG:_BG + 3] = I3
    F[:, _RHO:_RHO + 4, _RHO:_RHO + 4] = torch.eye(4, dtype=dtype, device=dev)

    V = torch.zeros((T, 31, 46), dtype=dtype, device=dev)
    Vg = 0.25 * -R1Ra1 * d1 ** 2 * 0.5 * d1
    V[:, 0:3, 0:3] = 0.25 * R0 * d1 ** 2
    V[:, 0:3, 3:6] = Vg
    V[:, 0:3, 6:9] = 0.25 * R1 * d1 ** 2
    V[:, 0:3, 9:12] = Vg
    V[:, 3:6, 3:6] = 0.5 * I3 * d1
    V[:, 3:6, 9:12] = 0.5 * I3 * d1
    V[:, 6:9, 0:3] = 0.5 * R0 * d1
    Vg2 = 0.5 * -R1Ra1 * d1 * 0.5 * d1
    V[:, 6:9, 3:6] = Vg2
    V[:, 6:9, 6:9] = 0.5 * R1 * d1
    V[:, 6:9, 9:12] = Vg2
    eps_Gi = -0.25 * d2 ** 2 * R1sv1 + 0.5 * d2 * (R0l @ sf0)
    eps_Gi1 = -0.25 * d2 ** 2 * R1sv1 + 0.5 * d2 * (R1l @ sf1)
    eps_DPHI = -0.5 * d2 * (R0l @ Rbr @ kin["J"][:-1])
    eps_DPHI1 = -0.5 * d2 * (R1l @ Rbr @ kin["J"][1:])
    for j in range(C.NUM_OF_LEG):
        r = _EPS + 3 * j
        V[:, r:r + 3, C.ILNO_GI:C.ILNO_GI + 3] = eps_Gi[:, j]
        V[:, r:r + 3, C.ILNO_GI1:C.ILNO_GI1 + 3] = eps_Gi1[:, j]
        V[:, r:r + 3, C.ILNO_PHI:C.ILNO_PHI + 3] = -0.5 * d1 * h_all[:-1, j]
        V[:, r:r + 3, C.ILNO_PHI1:C.ILNO_PHI1 + 3] = -0.5 * d1 * h_all[1:, j]
        V[:, r:r + 3, C.ILNO_DPHI:C.ILNO_DPHI + 3] = eps_DPHI[:, j]
        V[:, r:r + 3, C.ILNO_DPHI1:C.ILNO_DPHI1 + 3] = eps_DPHI1[:, j]
        V[:, r:r + 3, C.ILNO_V + 3 * j:C.ILNO_V + 3 * j + 3] = -I3 * d1
    V[:, _BA:_BA + 3, C.ILNO_BA:C.ILNO_BA + 3] = -I3 * d1
    V[:, _BG:_BG + 3, C.ILNO_BG:C.ILNO_BG + 3] = -I3 * d1
    V[:, _RHO:_RHO + 4, C.ILNO_NRHO:C.ILNO_NRHO + 4] = (
        -torch.eye(4, dtype=dtype, device=dev) * d1)

    an2, anz2, gn2 = params.acc_n ** 2, params.acc_n_z ** 2, params.gyr_n ** 2
    full = lambda k, x: x.reshape(1).expand(k)
    base = torch.cat([
        torch.stack([an2, an2, anz2, gn2, gn2, gn2,
                     an2, an2, anz2, gn2, gn2, gn2]),
        full(3, params.acc_w ** 2), full(3, params.gyr_w ** 2),
        full(6, params.phi_n ** 2), full(6, params.dphi_n ** 2)]).to(dtype)
    noise = torch.cat([base.expand(T, 30), uncertainties.reshape(T, 12),
                       rho_uncertainty], dim=1)
    Q = (V * noise[:, None, :]) @ V.transpose(-1, -2)

    # --- (F, Q) pairwise tree reduction ---
    M = 1 << (T - 1).bit_length() if T > 1 else 1
    Fs = torch.cat([F, torch.eye(31, dtype=dtype, device=dev).expand(
        M - T, 31, 31)])
    Qs = torch.cat([Q, torch.zeros((M - T, 31, 31), dtype=dtype, device=dev)])
    while Fs.shape[0] > 1:
        F1, F2 = Fs[0::2], Fs[1::2]
        Q1, Q2 = Qs[0::2], Qs[1::2]
        Fs = F2 @ F1
        Qs = F2 @ Q1 @ F2.transpose(-1, -2) + Q2

    return ILPreint(
        dp=dp, dq=dq_pref[-1], dv=dv, deps=deps, sum_deps=sum_deps,
        J=Fs[0], P=Qs[0], sum_dt=torch.sum(dtv), ba=ba, bg=bg, rho=rho,
        contact_flag=contact_final, integration_contact=int_contact,
        ff_min=ff_min, ff_max=ff_max, ff_window=ff_window, ff_idx=ff_idx,
    )


def il_residual(pre: ILPreint, state_i, state_j, gravity):
    """31-dim bias-corrected residual (reference:
    imu_leg_integration_base.cpp:845-898).

    state_{i,j}: dicts with p, q(wxyz), v, ba, bg (3-vecs) and rho (4,).
    """
    dba = state_i["ba"] - pre.ba
    dbg = state_i["bg"] - pre.bg
    drho = state_i["rho"] - pre.rho

    J = pre.J
    dp = pre.dp + J[0:3, _BA:_BA + 3] @ dba + J[0:3, _BG:_BG + 3] @ dbg
    dq = lie.quat_mul(pre.dq, lie.delta_q(J[3:6, _BG:_BG + 3] @ dbg))
    dv = pre.dv + J[6:9, _BA:_BA + 3] @ dba + J[6:9, _BG:_BG + 3] @ dbg

    qi_inv = lie.quat_conj(state_i["q"])
    r_p = lie.quat_rotate(
        qi_inv,
        0.5 * gravity * pre.sum_dt ** 2 + state_j["p"] - state_i["p"]
        - state_i["v"] * pre.sum_dt,
    ) - dp
    q_err = lie.quat_mul(lie.quat_conj(dq), lie.quat_mul(qi_inv, state_j["q"]))
    r_q = 2.0 * q_err[1:]
    r_v = lie.quat_rotate(
        qi_inv, gravity * pre.sum_dt + state_j["v"] - state_i["v"]) - dv

    rel_p = lie.quat_rotate(qi_inv, state_j["p"] - state_i["p"])
    r_eps = []
    for j in range(C.NUM_OF_LEG):
        r = _EPS + 3 * j
        deps_j = (pre.deps[j] + J[r:r + 3, _BG:_BG + 3] @ dbg
                  + J[r:r + 3, _RHO + j:_RHO + j + 1] @ drho[j:j + 1])
        r_eps.append(rel_p - deps_j)
    r_rho = state_j["rho"] - state_i["rho"]

    return torch.cat(
        [r_p, r_q, r_v] + r_eps
        + [state_j["ba"] - state_i["ba"], state_j["bg"] - state_i["bg"], r_rho]
    )
