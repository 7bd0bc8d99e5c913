"""Window factor graph: states, data, residual stacking (port of
`cerberus_tpu/ops/factors.py`).

The sliding window is a NamedTuple of fixed-shape tensors; every factor class
is a masked residual, evaluated over features and frames with
`torch.func.vmap`.

Tangent layout (dimension D = 222), SEGMENT-major so every factor type's
Hessian contribution lands in a contiguous block (see ops/structured.py):
  poses            : [dp(3), dtheta(3)] of frame i at 6*i            (0..65)
  speed/bias       : [dv(3), dba(3), dbg(3)] of frame i at 66 + 9*i  (66..164)
  leg bias         : drho(4) of frame i at 165 + 4*i                 (165..208)
  ex cam c in 0..1 : [dtic(3), dtheta_ic(3)] at 209 + 6*c            (209..220)
  td               : scalar at 221
  feature depths   : F extra dims appended after D (inverse depths)

Residual stack (rows):
  [0, 310)           10 x 31 whitened IMU+leg residuals
  [310, 310 + F*44)  (F, 11, 2+2) projection residuals: per (feature, frame)
                     a mono two-frame block and a stereo block
  [.., +222)         marginalization prior rows
  [.., +13)          standing calibration prior rows

`retract`, `local_diff` and `robust_cost`'s callers may give any number of
leading batch dimensions; the residual functions take one window and are
batched with `torch.func.vmap`. The solver linearizes through
ops/structured.py; the dense `linearize` (residual and full Jacobian by
`torch.func.jacfwd`) serves the pooled calibration's tests and callers
that want J itself, and `linearize_directions` gives J along a few
directions only (`parallel/batched.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.utils import lie

NF = C.NUM_FRAMES            # 11
PER_FRAME = 19               # tangent dims per frame (6 pose + 9 sb + 4 rho)
POSE_OFF = 0                 # poses: 6 dims x 11 frames
SB_OFF = 6 * NF              # 66: speed/bias: 9 dims x 11 frames
RHO_OFF = SB_OFF + 9 * NF    # 165: leg bias: 4 dims x 11 frames
EX0_OFF = RHO_OFF + 4 * NF   # 209
TD_OFF = EX0_OFF + 12        # 221
D_DENSE = TD_OFF + 1         # 222
PROJ_SQRT_INFO = C.FOCAL_LENGTH / 1.5  # reference: estimator.cpp:124-126
HUBER_DELTA = 1.0            # reference: estimator.cpp:1062


def frame_tangent_indices(i: int) -> np.ndarray:
    """Global tangent indices of frame i's 19 dims (pose, sb, rho)."""
    return np.concatenate([
        np.arange(POSE_OFF + 6 * i, POSE_OFF + 6 * i + 6),
        np.arange(SB_OFF + 9 * i, SB_OFF + 9 * i + 9),
        np.arange(RHO_OFF + 4 * i, RHO_OFF + 4 * i + 4),
    ])


class WindowState(NamedTuple):
    """All optimized variables of one sliding window (fixed shapes; a batch
    of windows carries one more leading dimension on every field)."""

    p: torch.Tensor      # (11, 3)
    q: torch.Tensor      # (11, 4) wxyz
    v: torch.Tensor      # (11, 3)
    ba: torch.Tensor     # (11, 3)
    bg: torch.Tensor     # (11, 3)
    rho: torch.Tensor    # (11, 4)
    tic: torch.Tensor    # (2, 3)
    qic: torch.Tensor    # (2, 4)
    td: torch.Tensor     # ()
    depth: torch.Tensor  # (F,) inverse depths in anchor frame

    @staticmethod
    def zero(F: int, dtype=torch.float64, *, device) -> "WindowState":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        qid = lie.quat_identity(dtype, device=device)
        return WindowState(
            p=z(NF, 3), q=qid.repeat(NF, 1), v=z(NF, 3), ba=z(NF, 3),
            bg=z(NF, 3),
            rho=torch.full((NF, 4), 0.21, dtype=dtype, device=device),
            tic=z(2, 3), qic=qid.repeat(2, 1),
            td=z(), depth=torch.ones((F,), dtype=dtype, device=device),
        )


class WindowData(NamedTuple):
    """Measurements + linearized prior for one window problem."""

    # stacked IMU+leg preintegrations per interval k: frames k -> k+1
    pre_dp: torch.Tensor       # (10, 3)
    pre_dq: torch.Tensor       # (10, 4)
    pre_dv: torch.Tensor       # (10, 3)
    pre_deps: torch.Tensor     # (10, 4, 3)
    pre_J: torch.Tensor        # (10, 31, 31)
    pre_L: torch.Tensor        # (10, 31, 31) cholesky(P): whitening solves L r
    pre_dt: torch.Tensor       # (10,)
    pre_ba: torch.Tensor       # (10, 3) linearization biases
    pre_bg: torch.Tensor       # (10, 3)
    pre_rho: torch.Tensor      # (10, 4)
    interval_valid: torch.Tensor  # (10,) bool

    # features
    f_start: torch.Tensor      # (F,) int anchor frame index
    f_pts: torch.Tensor        # (F, 11, 3) normalized obs (left cam)
    f_pts_r: torch.Tensor      # (F, 11, 3) right cam
    f_vel: torch.Tensor        # (F, 11, 2) feature image velocity (left)
    f_vel_r: torch.Tensor      # (F, 11, 2)
    f_td: torch.Tensor         # (F, 11) per-obs frame td offset (cur_td)
    f_obs: torch.Tensor        # (F, 11) bool observation mask (left)
    f_stereo: torch.Tensor     # (F, 11) bool stereo mask
    f_valid: torch.Tensor      # (F,) bool slot participates in the problem

    # marginalization prior: r = prior_r + prior_J @ (x [-] prior_lin)
    prior_J: torch.Tensor      # (222, 222)
    prior_r: torch.Tensor      # (222,)
    prior_valid: torch.Tensor  # () bool
    prior_lin: WindowState     # linearization point (depth ignored)

    free_mask: torch.Tensor    # (222,) bool — optimizable dense dims
    gravity: torch.Tensor      # (3,)

    # standing weak calibration prior pinning extrinsics/td near their
    # config values (13 rows: ex0(6), ex1(6), td)
    calib_w: torch.Tensor      # (13,) sqrt-information diagonal (0 disables)
    calib_tic: torch.Tensor    # (2, 3) reference extrinsic translations
    calib_qic: torch.Tensor    # (2, 4) reference extrinsic rotations (wxyz)
    calib_td: torch.Tensor     # () reference time offset


def map_tensors(fn, *trees):
    """Apply fn leaf by leaf over WindowState/WindowData trees (nested
    NamedTuples), the counterpart of `jax.tree.map` for these two types."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(map_tensors(fn, *leaves)
                             for leaves in zip(*trees)))
    return fn(*trees)


def num_residuals(F: int) -> int:
    return 310 + F * 44 + D_DENSE + 13


def tangent_dim(F: int) -> int:
    return D_DENSE + F


# ---------------------------------------------------------------------------
# retraction  x = lin [+] delta
# ---------------------------------------------------------------------------

def retract(s: WindowState, delta: torch.Tensor) -> WindowState:
    """s [+] delta for one window (delta (D+F,)) or a batch (leading dims)."""
    lead = delta.shape[:-1]
    pose = delta[..., POSE_OFF:POSE_OFF + 6 * NF].reshape(lead + (NF, 6))
    sb = delta[..., SB_OFF:SB_OFF + 9 * NF].reshape(lead + (NF, 9))
    rho = delta[..., RHO_OFF:RHO_OFF + 4 * NF].reshape(lead + (NF, 4))
    ex = delta[..., EX0_OFF:EX0_OFF + 12].reshape(lead + (2, 6))
    return WindowState(
        p=s.p + pose[..., 0:3],
        q=lie.quat_normalize(lie.quat_mul(s.q, lie.delta_q(pose[..., 3:6]))),
        v=s.v + sb[..., 0:3],
        ba=s.ba + sb[..., 3:6],
        bg=s.bg + sb[..., 6:9],
        rho=s.rho + rho,
        tic=s.tic + ex[..., 0:3],
        qic=lie.quat_normalize(lie.quat_mul(s.qic, lie.delta_q(ex[..., 3:6]))),
        td=s.td + delta[..., TD_OFF],
        depth=s.depth + delta[..., D_DENSE:],
    )


def local_diff(s: WindowState, lin: WindowState) -> torch.Tensor:
    """Dense-tangent x [-] lin (quaternion-aware), the prior's dx
    (reference: marginalization_factor.cpp:361-378)."""
    lead = s.p.shape[:-2]
    flat = lambda x: x.reshape(lead + (-1,))
    dth = 2.0 * lie.quat_mul(lie.quat_conj(lin.q), s.q)[..., 1:]
    pose = flat(torch.cat([s.p - lin.p, dth], dim=-1))
    sb = flat(torch.cat([s.v - lin.v, s.ba - lin.ba, s.bg - lin.bg], dim=-1))
    rho = flat(s.rho - lin.rho)
    dth_ic = 2.0 * lie.quat_mul(lie.quat_conj(lin.qic), s.qic)[..., 1:]
    ex = flat(torch.cat([s.tic - lin.tic, dth_ic], dim=-1))
    return torch.cat([pose, sb, rho, ex, (s.td - lin.td)[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# residual stack (one window)
# ---------------------------------------------------------------------------

def _zero_where(ok, r):
    return torch.where(ok, r, torch.zeros_like(r))


def _ileg_residuals(st: WindowState, data: WindowData):
    """(10, 31) whitened IMU+leg residuals (reference: imu_leg_factor.cpp)."""

    def one(k):
        Jk = data.pre_J[k]
        dba = st.ba[k] - data.pre_ba[k]
        dbg = st.bg[k] - data.pre_bg[k]
        drho = st.rho[k] - data.pre_rho[k]
        dp = (data.pre_dp[k] + Jk[0:3, C.ILO_BA:C.ILO_BA + 3] @ dba
              + Jk[0:3, C.ILO_BG:C.ILO_BG + 3] @ dbg)
        dq = lie.quat_mul(data.pre_dq[k],
                          lie.delta_q(Jk[3:6, C.ILO_BG:C.ILO_BG + 3] @ dbg))
        dv = (data.pre_dv[k] + Jk[6:9, C.ILO_BA:C.ILO_BA + 3] @ dba
              + Jk[6:9, C.ILO_BG:C.ILO_BG + 3] @ dbg)

        qi, qj = st.q[k], st.q[k + 1]
        qi_inv = lie.quat_conj(qi)
        T = data.pre_dt[k]
        g = data.gravity
        r_p = lie.quat_rotate(qi_inv, 0.5 * g * T * T + st.p[k + 1] - st.p[k]
                              - st.v[k] * T) - dp
        r_q = 2.0 * lie.quat_mul(lie.quat_conj(dq), lie.quat_mul(qi_inv, qj))[1:]
        r_v = lie.quat_rotate(qi_inv, g * T + st.v[k + 1] - st.v[k]) - dv
        rel_p = lie.quat_rotate(qi_inv, st.p[k + 1] - st.p[k])
        r_eps = []
        for j in range(4):
            rr = C.ILO_EPS + 3 * j
            deps_j = (data.pre_deps[k, j]
                      + Jk[rr:rr + 3, C.ILO_BG:C.ILO_BG + 3] @ dbg
                      + Jk[rr:rr + 3, C.ILO_RHO + j] * drho[j])
            r_eps.append(rel_p - deps_j)
        raw = torch.cat(
            [r_p, r_q, r_v] + r_eps
            + [st.ba[k + 1] - st.ba[k], st.bg[k + 1] - st.bg[k],
               st.rho[k + 1] - st.rho[k]])
        # whiten: r' = L^-1 raw with P = L L^T
        white = torch.linalg.solve_triangular(
            data.pre_L[k], raw[:, None], upper=False)[:, 0]
        return _zero_where(data.interval_valid[k], white)

    return torch.stack([one(k) for k in range(10)])


def _proj_residuals(st: WindowState, data: WindowData):
    """(F, 11, 4) projection residuals.

    Per (feature f, frame j): rows 0:2 = mono two-frame factor (anchor i ->
    frame j, left cam; reference projectionTwoFrameOneCamFactor.cpp:59-145);
    rows 2:4 = stereo factor into the right cam at frame j (two-frame when
    j != i, one-frame-two-cam when j == i). The anchor frame is selected by
    a one-hot contraction, as in ops/structured.py."""
    dtype, dev = st.p.dtype, st.p.device
    frames = torch.arange(NF, device=dev)
    z1 = torch.zeros(1, dtype=dtype, device=dev)

    def per_feature(f_pts, f_pts_r, f_vel, f_vel_r, f_td, f_obs, f_stereo,
                    f_valid, start, inv_dep):
        Ei = (frames == start).to(dtype)                  # (11,)
        pts_i = Ei @ f_pts
        vel_i = Ei @ f_vel
        td_i = Ei @ f_td
        obs_i = (Ei @ f_obs.to(dtype)) > 0.5
        p_i = Ei @ st.p
        q_i = Ei @ st.q

        def per_frame(j, pts_j, vel_j, td_j, p_j, q_j, obs_j, stereo_j,
                      pts_jr, vel_jr):
            dt_i = st.td - td_i
            dt_j = st.td - td_j
            pts_i_td = pts_i - dt_i * torch.cat([vel_i, z1])
            pts_j_td = pts_j - dt_j * torch.cat([vel_j, z1])
            pts_cam_i = pts_i_td / inv_dep
            pts_imu_i = lie.quat_rotate(st.qic[0], pts_cam_i) + st.tic[0]
            pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i

            # mono: into left cam at frame j
            pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
            pts_cam_j = lie.quat_rotate(lie.quat_conj(st.qic[0]),
                                        pts_imu_j - st.tic[0])
            zj = pts_cam_j[2]
            zj = torch.where(torch.abs(zj) < 1e-6, torch.full_like(zj, 1e-6), zj)
            r_mono = PROJ_SQRT_INFO * (pts_cam_j[:2] / zj - pts_j_td[:2])
            mono_ok = obs_j & obs_i & (j != start) & f_valid
            r_mono = _zero_where(mono_ok, r_mono)

            # stereo: into right cam at frame j (works for j == i too)
            pts_jr_td = pts_jr - dt_j * torch.cat([vel_jr, z1])
            pts_cam_jr = lie.quat_rotate(lie.quat_conj(st.qic[1]),
                                         pts_imu_j - st.tic[1])
            zr = pts_cam_jr[2]
            zr = torch.where(torch.abs(zr) < 1e-6, torch.full_like(zr, 1e-6), zr)
            r_st = PROJ_SQRT_INFO * (pts_cam_jr[:2] / zr - pts_jr_td[:2])
            st_ok = stereo_j & obs_i & f_valid
            r_st = _zero_where(st_ok, r_st)
            return torch.cat([r_mono, r_st])

        return vmap(per_frame)(frames, f_pts, f_vel, f_td, st.p, st.q, f_obs,
                               f_stereo, f_pts_r, f_vel_r)

    return vmap(per_feature)(data.f_pts, data.f_pts_r, data.f_vel,
                             data.f_vel_r, data.f_td, data.f_obs,
                             data.f_stereo, data.f_valid, data.f_start,
                             st.depth)


def _prior_residuals(st: WindowState, data: WindowData):
    dx = local_diff(st, data.prior_lin)
    r = data.prior_r + data.prior_J @ dx
    return _zero_where(data.prior_valid, r)


def _calib_residuals(st: WindowState, data: WindowData):
    """(13,) whitened calibration-prior rows: [ex0(6), ex1(6), td]."""
    dth_ic = 2.0 * lie.quat_mul(lie.quat_conj(data.calib_qic), st.qic)[..., 1:]
    ex = torch.cat([st.tic - data.calib_tic, dth_ic], dim=-1).reshape(12)
    return data.calib_w * torch.cat([ex, (st.td - data.calib_td)[None]])


def window_residuals(lin: WindowState, delta: torch.Tensor, data: WindowData):
    """Full stacked residual at lin [+] delta. Returns (N,) vector."""
    st = retract(lin, delta)
    r_ileg = _ileg_residuals(st, data).reshape(-1)
    r_proj = _proj_residuals(st, data).reshape(-1)
    r_prior = _prior_residuals(st, data)
    r_calib = _calib_residuals(st, data)
    return torch.cat([r_ileg, r_proj, r_prior, r_calib])


def proj_row_slice(F: int):
    return slice(310, 310 + F * 44)


def huber_row_weights(r: torch.Tensor, F: int):
    """Per-row sqrt IRLS weights: Huber(1.0) on each 2-dim projection block
    (reference applies ceres::HuberLoss(1.0) to projection factors only)."""
    sl = proj_row_slice(F)
    pr = r[sl].reshape(-1, 2)
    sq = torch.sum(pr * pr, dim=1)
    # Huber: rho'(s) = 1 for s <= delta^2 else delta/sqrt(s)
    wblk = torch.where(sq <= HUBER_DELTA ** 2, torch.ones_like(sq),
                       HUBER_DELTA / torch.sqrt(torch.clamp(sq, min=1e-30)))
    wrow = torch.sqrt(torch.repeat_interleave(wblk, 2))
    one = torch.ones_like(r)
    return torch.cat([one[:sl.start], wrow, one[sl.stop:]])


def robust_cost(r: torch.Tensor, F: int):
    """0.5 * sum of rho(s) with Huber on projection blocks, quadratic elsewhere."""
    sl = proj_row_slice(F)
    pr = r[sl].reshape(-1, 2)
    sq = torch.sum(pr * pr, dim=1)
    d2 = HUBER_DELTA ** 2
    rho = torch.where(
        sq <= d2, sq,
        2.0 * HUBER_DELTA * torch.sqrt(torch.clamp(sq, min=1e-30)) - d2)
    other = torch.sum(r[: sl.start] ** 2) + torch.sum(r[sl.stop:] ** 2)
    return 0.5 * (torch.sum(rho) + other)


def _weights_and_mask(lin: WindowState, data: WindowData, r0):
    """(IRLS row weights of r0, free-mask column mask) of `linearize`."""
    F = lin.depth.shape[0]
    col_mask = torch.cat([data.free_mask.to(lin.p.dtype),
                          data.f_valid.to(lin.p.dtype)])
    return huber_row_weights(r0, F), col_mask


def linearize(lin: WindowState, data: WindowData):
    """Residual r and dense Jacobian J at delta = 0, with IRLS row weights and
    free-mask column zeroing applied. J: (N, D_DENSE + F). Returns
    (r, J, r0), r0 the unweighted residual."""
    zero = torch.zeros(tangent_dim(lin.depth.shape[0]), dtype=lin.p.dtype,
                       device=lin.p.device)
    r0 = window_residuals(lin, zero, data)
    J = jacfwd(lambda d: window_residuals(lin, d, data))(zero)
    w, col_mask = _weights_and_mask(lin, data, r0)
    return r0 * w, J * w[:, None] * col_mask[None, :], r0


def linearize_directions(lin: WindowState, data: WindowData, dirs):
    """`linearize`'s (r, J @ dirs) for a few tangent directions dirs
    (D_DENSE + F, k): k forward-mode products instead of the full J, with
    the same row weights and column mask. Returns (r (N,), Jd (N, k))."""
    zero = torch.zeros(dirs.shape[1], dtype=lin.p.dtype,
                       device=lin.p.device)
    r0 = window_residuals(lin, torch.zeros_like(dirs[:, 0]), data)
    w, col_mask = _weights_and_mask(lin, data, r0)
    Jd = jacfwd(lambda a: window_residuals(
        lin, (dirs * col_mask[:, None]) @ a, data))(zero)
    return r0 * w, Jd * w[:, None]


def feature_reproj_errors(st: WindowState, data: WindowData):
    """(F,) average unwhitened reprojection error per feature, in normalized
    units (multiply by FOCAL_LENGTH for pixels) — reference:
    estimator.cpp:1741-1798 outliersRejection."""
    r = _proj_residuals(st, data) / PROJ_SQRT_INFO            # (F, 11, 4)
    F = r.shape[0]
    err = torch.linalg.vector_norm(r.reshape(F, -1, 2), dim=-1)  # (F, 22)
    frames = torch.arange(NF, device=r.device)
    mono_ok = data.f_obs & (frames[None, :] != data.f_start[:, None])
    cnt = torch.stack([mono_ok, data.f_stereo], dim=-1).reshape(F, -1).sum(1)
    return torch.sum(err, dim=1) / torch.clamp(cnt, min=1)
