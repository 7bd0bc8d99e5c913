"""Structured (factor-sparse) normal-equation assembly (port of
`cerberus_tpu/ops/structured.py::build_normal_equations_blocks`).

Per-factor Jacobians come from small `torch.func` transforms vmapped across
factors: `jacfwd` over the 38-dim local tangent of each of the 10 IMU+leg
factors, `jacrev` over the 26-dim local tangent of each (feature, frame)
projection pair. The Gauss-Newton blocks are assembled from them without
ever materializing the big Jacobian. The segment-major tangent layout
(ops/factors.py) puts every block in a contiguous region, and the one
dynamic coupling (a projection factor's anchor frame) is a one-hot
contraction, so the whole assembly is free of in-place writes and runs under
`torch.func.vmap` over a batch of windows.

`linearize_rows` assembles the weighted Jacobian itself, row by row, from
the same per-factor Jacobians, for the marginalization. The full-matrix
`build_normal_equations` is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.utils import lie

NF = C.NUM_FRAMES
NI = NF - 1      # inter-keyframe intervals (one IMU+leg factor each)

# per projection pair local tangent: [pose_i(6), pose_j(6), ex0(6), ex1(6),
# depth(1), td(1)]
PROJ_TAN = 26
# per IMU+leg factor local tangent (segment-grouped): [pose_i(6), pose_j(6),
# sb_i(9), sb_j(9), rho_i(4), rho_j(4)]
ILEG_TAN = 38


def _retract_pose(p, q, d6):
    return p + d6[0:3], lie.quat_normalize(lie.quat_mul(q, lie.delta_q(d6[3:6])))


def _with_value(f):
    """f -> (d -> (f(d), f(d))): the `has_aux` form that returns a
    Jacobian together with the residual it was taken at."""
    return lambda d: (lambda r: (r, r))(f(d))


def _ileg_pairs(st: fac.WindowState, data: fac.WindowData):
    """Per-interval (leading axis 10) views of everything one IMU+leg factor
    touches — frames k and k+1 of the state plus interval k's
    preintegration."""
    return (st.p[:NI], st.q[:NI], st.v[:NI], st.ba[:NI], st.bg[:NI],
            st.rho[:NI],
            st.p[1:], st.q[1:], st.v[1:], st.ba[1:], st.bg[1:], st.rho[1:],
            data.pre_dp, data.pre_dq, data.pre_dv, data.pre_deps, data.pre_J,
            data.pre_L, data.pre_dt, data.pre_ba, data.pre_bg, data.pre_rho,
            data.interval_valid)


def _ileg_residual_pair(delta, pair, gravity):
    """(31,) whitened IMU+leg residual of one interval under a 38-dim local
    perturbation (segment-grouped layout). Mirrors factors._ileg_residuals."""
    (p_i0, q_i0, v_i0, ba_i0, bg_i0, rho_i0,
     p_j0, q_j0, v_j0, ba_j0, bg_j0, rho_j0,
     pre_dp, pre_dq, pre_dv, pre_deps, Jk, pre_L, pre_dt,
     pre_ba, pre_bg, pre_rho, ivalid) = pair
    p_i, q_i = _retract_pose(p_i0, q_i0, delta[0:6])
    p_j, q_j = _retract_pose(p_j0, q_j0, delta[6:12])
    v_i = v_i0 + delta[12:15]
    ba_i = ba_i0 + delta[15:18]
    bg_i = bg_i0 + delta[18:21]
    v_j = v_j0 + delta[21:24]
    ba_j = ba_j0 + delta[24:27]
    bg_j = bg_j0 + delta[27:30]
    rho_i = rho_i0 + delta[30:34]
    rho_j = rho_j0 + delta[34:38]

    dba = ba_i - pre_ba
    dbg = bg_i - pre_bg
    drho = rho_i - pre_rho
    dp = (pre_dp + Jk[0:3, C.ILO_BA:C.ILO_BA + 3] @ dba
          + Jk[0:3, C.ILO_BG:C.ILO_BG + 3] @ dbg)
    dq = lie.quat_mul(pre_dq,
                      lie.delta_q(Jk[3:6, C.ILO_BG:C.ILO_BG + 3] @ dbg))
    dv = (pre_dv + Jk[6:9, C.ILO_BA:C.ILO_BA + 3] @ dba
          + Jk[6:9, C.ILO_BG:C.ILO_BG + 3] @ dbg)

    qi_inv = lie.quat_conj(q_i)
    T = pre_dt
    g = gravity
    r_p = lie.quat_rotate(qi_inv, 0.5 * g * T * T + p_j - p_i - v_i * T) - dp
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(dq), lie.quat_mul(qi_inv, q_j))[1:]
    r_v = lie.quat_rotate(qi_inv, g * T + v_j - v_i) - dv
    rel_p = lie.quat_rotate(qi_inv, p_j - p_i)
    r_eps = []
    for leg in range(4):
        rr = C.ILO_EPS + 3 * leg
        deps = (pre_deps[leg]
                + Jk[rr:rr + 3, C.ILO_BG:C.ILO_BG + 3] @ dbg
                + Jk[rr:rr + 3, C.ILO_RHO + leg] * drho[leg])
        r_eps.append(rel_p - deps)
    raw = torch.cat([r_p, r_q, r_v] + r_eps
                    + [ba_j - ba_i, bg_j - bg_i, rho_j - rho_i])
    white = torch.linalg.solve_triangular(pre_L, raw[:, None],
                                          upper=False)[:, 0]
    return fac._zero_where(ivalid, white)


def _ileg_rows(st: fac.WindowState, data: fac.WindowData):
    """All 10 IMU+leg factor residuals and local Jacobians in one batched
    evaluation: r (10, 31), J (10, 31, 38)."""
    zero38 = torch.zeros((ILEG_TAN,), dtype=st.p.dtype, device=st.p.device)

    def one(pair):
        f = lambda d: _ileg_residual_pair(d, pair, data.gravity)
        J, r = jacfwd(_with_value(f), has_aux=True)(zero38)
        return r, J

    return vmap(one)(_ileg_pairs(st, data))


_PLACEMENT: dict = {}


def _placements(dtype, device):
    """One-hot placement matrices, made once per dtype and device (so the
    LM loop never copies them from the host):

    P79 (79, 222): the contiguous projection subspace [pose(66) | ex0 ex1
    (12) | td(1)] into the global layout.
    Pil (10, 38, 222): local tangent [pose_i+j(12) | sb_i+j(18) | rho_i+j(8)]
    of interval k into the global segment-major layout. Adjacent intervals
    overlap on the shared frame, so summing the placed blocks adds their
    contributions."""
    key = (dtype, torch.device(device))
    if key not in _PLACEMENT:
        P79 = np.zeros((79, fac.D_DENSE))
        P79[0:66, fac.POSE_OFF:fac.POSE_OFF + 66] = np.eye(66)
        P79[66:78, fac.EX0_OFF:fac.EX0_OFF + 12] = np.eye(12)
        P79[78, fac.TD_OFF] = 1.0
        Pil = np.zeros((NI, ILEG_TAN, fac.D_DENSE))
        for k in range(NI):
            Pil[k, 0:12, fac.POSE_OFF + 6 * k:fac.POSE_OFF + 6 * k + 12] = \
                np.eye(12)
            Pil[k, 12:30, fac.SB_OFF + 9 * k:fac.SB_OFF + 9 * k + 18] = \
                np.eye(18)
            Pil[k, 30:38, fac.RHO_OFF + 4 * k:fac.RHO_OFF + 4 * k + 8] = \
                np.eye(8)
        _PLACEMENT[key] = tuple(torch.as_tensor(P, dtype=dtype, device=device)
                                for P in (P79, Pil))
    return _PLACEMENT[key]


def _proj_rows_split(st: fac.WindowState, data: fac.WindowData):
    """Huber-weighted projection rows, depth column kept separate: residuals
    r_p / r_pw (P, 4), the dense row block A79 (P*4, 79) over
    [pose(66) | ex0(6) ex1(6) | td(1)], and the per-row depth derivative
    jd (P*4,). Rows are feature-major: row = (f * NF + j) * 4 + comp, so the
    depth block of the Gauss-Newton Hessian is DIAGONAL and the pose-depth
    coupling is a batched small contraction (the structure Ceres'
    DENSE_SCHUR exploits, reference estimator.cpp:1223)."""
    F = st.depth.shape[0]
    dtype, dev = st.p.dtype, st.p.device
    P = F * NF
    zero26 = torch.zeros((PROJ_TAN,), dtype=dtype, device=dev)
    frames = torch.arange(NF, device=dev)
    z1 = torch.zeros(1, dtype=dtype, device=dev)

    def per_feature(f_pts, f_pts_r, f_vel, f_vel_r, f_td, f_obs, f_stereo,
                    f_valid, start, depth_f):
        Ei = (frames == start).to(dtype)                   # (11,) one-hot
        pts_i0 = Ei @ f_pts
        vel_i0 = Ei @ f_vel
        td_i0 = Ei @ f_td
        obs_i = (Ei @ f_obs.to(dtype)) > 0.5
        p_i0 = Ei @ st.p
        q_i0 = Ei @ st.q                                   # exact row select

        def per_frame(j, pts_j0, vel_j0, td_j0, p_j0, q_j0, obs_j, stereo_j,
                      pts_jr0, vel_jr0):
            def res26(delta):
                p_i, q_i = _retract_pose(p_i0, q_i0, delta[0:6])
                p_j, q_j = _retract_pose(p_j0, q_j0, delta[6:12])
                tic0, qic0 = _retract_pose(st.tic[0], st.qic[0], delta[12:18])
                tic1, qic1 = _retract_pose(st.tic[1], st.qic[1], delta[18:24])
                inv_dep = depth_f + delta[24]
                td = st.td + delta[25]
                pts_i_td = pts_i0 - (td - td_i0) * torch.cat([vel_i0, z1])
                pts_j_td = pts_j0 - (td - td_j0) * torch.cat([vel_j0, z1])
                pts_cam_i = pts_i_td / inv_dep
                pts_imu_i = lie.quat_rotate(qic0, pts_cam_i) + tic0
                pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
                pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
                pts_cam_j = lie.quat_rotate(lie.quat_conj(qic0),
                                            pts_imu_j - tic0)
                zj = pts_cam_j[2]
                zj = torch.where(torch.abs(zj) < 1e-6,
                                 torch.full_like(zj, 1e-6), zj)
                r_mono = fac.PROJ_SQRT_INFO * (pts_cam_j[:2] / zj
                                               - pts_j_td[:2])
                mono_ok = obs_j & obs_i & (j != start) & f_valid
                r_mono = fac._zero_where(mono_ok, r_mono)
                pts_jr_td = pts_jr0 - (td - td_j0) * torch.cat([vel_jr0, z1])
                pts_cam_jr = lie.quat_rotate(lie.quat_conj(qic1),
                                             pts_imu_j - tic1)
                zr = pts_cam_jr[2]
                zr = torch.where(torch.abs(zr) < 1e-6,
                                 torch.full_like(zr, 1e-6), zr)
                r_st = fac.PROJ_SQRT_INFO * (pts_cam_jr[:2] / zr
                                             - pts_jr_td[:2])
                st_ok = stereo_j & obs_i & f_valid
                r_st = fac._zero_where(st_ok, r_st)
                return torch.cat([r_mono, r_st])

            # reverse mode: 4 output cotangents instead of 26 input tangents
            J, r = jacrev(_with_value(res26), has_aux=True)(zero26)
            return r, J

        return vmap(per_frame)(frames, f_pts, f_vel, f_td, st.p, st.q,
                               f_obs, f_stereo, f_pts_r, f_vel_r)

    r_f, J_f = vmap(per_feature)(
        data.f_pts, data.f_pts_r, data.f_vel, data.f_vel_r, data.f_td,
        data.f_obs, data.f_stereo, data.f_valid, data.f_start, st.depth)
    r_p = r_f.reshape(P, 4)

    # Huber IRLS on each 2-dim block
    def blk_w(rb):
        sq = torch.sum(rb * rb, dim=-1)
        return torch.where(
            sq <= fac.HUBER_DELTA ** 2, torch.ones_like(sq),
            fac.HUBER_DELTA / torch.sqrt(torch.clamp(sq, min=1e-30)))
    w_mono = blk_w(r_f[..., 0:2])
    w_st = blk_w(r_f[..., 2:4])
    sw = torch.sqrt(torch.stack([w_mono, w_mono, w_st, w_st], dim=-1))
    r_pw = (r_f * sw).reshape(P, 4)
    J_pw = J_f * sw[..., None]                             # (F, NF, 4, 26)

    # ---- widen the pose columns to all 11 frames (one-hot contraction) ----
    Ei = (data.f_start[:, None] == frames).to(dtype)      # (F, 11) anchor
    Ej = torch.eye(NF, dtype=dtype, device=dev)            # (11, 11) frame j
    pose_wide = (
        torch.einsum("fjab,fi->fjaib", J_pw[..., 0:6], Ei)
        + torch.einsum("fjab,ji->fjaib", J_pw[..., 6:12], Ej)
    ).reshape(F, NF, 4, 6 * NF)
    A79 = torch.cat([pose_wide, J_pw[..., 12:24], J_pw[..., 25:26]],
                    dim=-1).reshape(P * 4, 79)
    jd = J_pw[..., 24].reshape(P * 4)
    return r_p, r_pw, A79, jd


def build_normal_equations_blocks(st: fac.WindowState, data: fac.WindowData):
    """Assemble the Gauss-Newton normal equations in depth-Schur block form:

        (H_pp (222,222), H_pd (222,F), h_dd (F,), b_p (222,), b_d (F,), r0)

    where the full system is H = [[H_pp, H_pd], [H_pd^T, diag(h_dd)]] and
    b = [b_p, b_d]. The depth-depth block is diagonal by construction (each
    projection row touches exactly one inverse depth), so the solver
    eliminates it in closed form (ops/solver._damped_solve_schur). Huber
    IRLS weights and free-mask zeroing match the JAX package's
    factors.linearize."""
    F = st.depth.shape[0]
    dtype, dev = st.p.dtype, st.p.device
    P79, Pil = _placements(dtype, dev)

    r_p, r_pw, A79, jd = _proj_rows_split(st, data)
    b79 = A79.T @ r_pw.reshape(-1)

    # per-feature grouped views: rows (f, j, comp) → (F, NF*4)
    A_g = A79.reshape(F, NF * 4, 79)
    jd_g = jd.reshape(F, NF * 4)
    rw_g = r_pw.reshape(F, NF * 4)

    H79 = A79.T @ A79                                      # (79, 79)
    Hpd79 = torch.einsum("fnc,fn->cf", A_g, jd_g)          # (79, F)
    h_dd = torch.einsum("fn,fn->f", jd_g, jd_g)            # (F,)
    b_d = torch.einsum("fn,fn->f", jd_g, rw_g)             # (F,)

    # ---- place the projection subspace with one-hot contractions ----
    H_pp = P79.T @ H79 @ P79
    H_pd = P79.T @ Hpd79
    b_p = P79.T @ b79

    # ---- IMU+leg factors: batched rows, one placement contraction ----
    r_il, J_il = _ileg_rows(st, data)                      # (10,31) (10,31,38)
    Jw = torch.einsum("kra,kaA->krA", J_il, Pil)           # (NI, 31, 222)
    H_pp = H_pp + torch.einsum("krA,krB->AB", Jw, Jw)
    b_p = b_p + torch.einsum("krA,kr->A", Jw, r_il)

    # ---- prior (dense block only: the prior never references depths) ----
    r_prior = fac._zero_where(
        data.prior_valid,
        data.prior_r + data.prior_J @ fac.local_diff(st, data.prior_lin))
    Jpr = fac._zero_where(data.prior_valid, data.prior_J)
    H_pp = H_pp + Jpr.T @ Jpr
    b_p = b_p + Jpr.T @ r_prior

    # ---- standing calibration prior (13 diagonal rows on ex0/ex1/td;
    # factors._calib_residuals). J ~ calib_w * I on those dims.
    r_calib = fac._calib_residuals(st, data)
    pad = torch.zeros((fac.EX0_OFF,), dtype=dtype, device=dev)
    H_pp = H_pp + torch.diag_embed(torch.cat([pad, data.calib_w ** 2]))
    b_p = b_p + torch.cat([pad, data.calib_w * r_calib])

    # ---- free-mask (zero rows+cols of frozen dims) ----
    mp = data.free_mask.to(dtype)
    md = data.f_valid.to(dtype)
    H_pp = H_pp * mp[:, None] * mp[None, :]
    H_pd = H_pd * mp[:, None] * md[None, :]
    h_dd = h_dd * md
    b_p = b_p * mp
    b_d = b_d * md

    # residual vector for cost bookkeeping (same ordering as factors stack)
    r0 = torch.cat([r_il.reshape(-1), r_p.reshape(-1), r_prior, r_calib])
    return H_pp, H_pd, h_dd, b_p, b_d, r0


def linearize_rows(st: fac.WindowState, data: fac.WindowData):
    """Weighted residual r (N,) and dense Jacobian J (N, 222 + F) assembled
    from the same per-factor small Jacobians as
    `build_normal_equations_blocks`: the JAX package's `linearize_rows`, the
    marginalization's linearization. Row/column layout and IRLS/free-mask
    treatment match the JAX package's `factors.linearize`. One window (no
    batch axis); the rows are placed by slice assignment."""
    F = st.depth.shape[0]
    dtype, dev = st.p.dtype, st.p.device
    D = fac.D_DENSE
    J = torch.zeros((fac.num_residuals(F), fac.tangent_dim(F)), dtype=dtype,
                    device=dev)

    # ---- IMU+leg rows: batched (10, 31, 38) evaluation, static placement --
    r_il, J_il = _ileg_rows(st, data)
    for k in range(NI):
        row = 31 * k
        for a0, a1, g0 in ((0, 12, fac.POSE_OFF + 6 * k),
                           (12, 30, fac.SB_OFF + 9 * k),
                           (30, 38, fac.RHO_OFF + 4 * k)):
            J[row:row + 31, g0:g0 + (a1 - a0)] = J_il[k, :, a0:a1]

    # ---- projection rows: [pose(66) | ex0 ex1(12) | td(1)] and the depth
    # column of each row's feature (rows are feature-major) ----
    r_p, r_pw, A79, jd = _proj_rows_split(st, data)
    rows = slice(310, 310 + F * NF * 4)
    J[rows, fac.POSE_OFF:fac.POSE_OFF + 66] = A79[:, 0:66]
    J[rows, fac.EX0_OFF:fac.EX0_OFF + 12] = A79[:, 66:78]
    J[rows, fac.TD_OFF] = A79[:, 78]
    Ed = torch.eye(F, dtype=dtype, device=dev).repeat_interleave(NF * 4, 0)
    J[rows, D:] = jd[:, None] * Ed

    # ---- prior rows ----
    r_prior = fac._zero_where(
        data.prior_valid,
        data.prior_r + data.prior_J @ fac.local_diff(st, data.prior_lin))
    row1 = rows.stop
    J[row1:row1 + D, :D] = fac._zero_where(data.prior_valid, data.prior_J)

    # ---- calibration prior rows (diagonal on ex0/ex1/td) ----
    r_calib = fac._calib_residuals(st, data)
    row2 = row1 + D
    J[row2:row2 + 13, fac.EX0_OFF:fac.TD_OFF + 1] = torch.diag(data.calib_w)

    r = torch.cat([r_il.reshape(-1), r_pw.reshape(-1), r_prior, r_calib])
    col_mask = torch.cat([data.free_mask.to(dtype), data.f_valid.to(dtype)])
    return r, J * col_mask[None, :]
