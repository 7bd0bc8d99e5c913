"""IMU+leg preintegration of one keyframe interval in its log-depth form
(frozen copy of `cerberus_tpu_torch/ops/preintegration.py`: the parameters,
the result type, the leg kinematics bundle and `il_preintegrate_parallel`,
which equals the sequential `il_preintegrate` to floating-point
reassociation). Same midpoint scheme and the same error-state transition F
(31x31) and noise map V (31x46) as the reference
(src/factor/imu_leg_integration_base.cpp:138-469).

State conventions:
  IMU+leg error state (31): [p, theta, v, eps1..4, ba, bg, rho1..4]
  IMU+leg noise (46): [a_i, g_i, a_i1, g_i1, ba_w, bg_w, phi_i, phi_i1,
                       dphi_i, dphi_i1, v_leg1..4, n_rho1..4]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vilo_bench.frozen import config as C
from vilo_bench.frozen.leg import all_legs_fk_jac
from vilo_bench.frozen import lie


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




_EPS = C.ILO_EPS
_BA, _BG, _RHO = C.ILO_BA, C.ILO_BG, C.ILO_RHO


def _leg_kin(phi, rho, params: PreintParams):
    """FK bundle (kinematics.leg.all_legs_fk_jac) of joint angles phi
    (..., 12) at calf lengths rho (4,): fk, J, dfk_drho, dJ_dq, dJ_drho with
    leading dims (..., 4)."""
    lead = phi.shape[:-1]
    return all_legs_fk_jac(phi.reshape(lead + (4, 3)),
                           rho.reshape(4, C.RHO_OPT_SIZE), params.rho_fix)


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
