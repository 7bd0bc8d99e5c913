"""Monocular initialization machinery: relative pose, extrinsic-rotation
calibration, global SfM, and visual-IMU alignment, on torch tensors (port of
`cerberus_tpu/estimator/initial_sfm.py`).

Re-design of the reference's `src/initial/` family (reference:
initial_sfm.{h,cpp}, solve_5pts.{h,cpp}, initial_ex_rotation.{h,cpp},
initial_aligment.cpp:126-293); the same formulas as the JAX package:

  * `relative_pose_ransac` — essential-matrix RANSAC: all hypotheses are one
    batched (H, 8, 9) SVD, scored in parallel. The JAX package draws the
    hypotheses with `jax.random.choice`; the port draws them with
    `torch.multinomial` (without replacement, weighted by the mask) from a
    `torch.Generator` seeded by `seed`, and `relative_pose_from_hypotheses`
    takes an explicit (H, 8) index set, so either package's draw can be fed.
  * `decompose_essential` / `recover_pose` — the four-way (R, t)
    disambiguation by triangulated-depth voting.
  * `calibrate_ex_rotation` — camera-IMU rotation from rotation pairs.
  * `global_sfm` — windowed mono SfM: seed pair, PnP chaining, bundle
    adjustment. The JAX package's `fori_loop` / `lax.cond` over frames
    become Python loops over the frame index: every branch depends on the
    index and the static seed frame only, so nothing is read back to the
    host; the "enough points for PnP" test stays a `torch.where`.
  * `visual_imu_alignment` — scale / gravity / velocity linear alignment
    with gravity refinement on its tangent basis.

SVD signs: the two packages' SVDs may return singular vectors of either
sign (and, for E's equal singular values, any rotation within their plane);
every result here is sign-invariant (R, t, inliers, a quaternion with
w >= 0), not E or V^T. Linear solves are `torch.linalg.solve_ex`, which,
like `jnp.linalg.solve`, returns non-finite values on a singular system
instead of raising.

Each entry point takes `device=` (the card unless the caller names
another) and moves its inputs there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from cerberus_tpu_torch.device import on_device, resolve_device
from cerberus_tpu_torch.utils import lie


def _solve(A, b):
    return torch.linalg.solve_ex(A, b).result


def _smallest_right_vector(A):
    """The right singular vector of A (..., m, n) for its smallest singular
    value: V^T's last row."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _essential_projection(E):
    """E (..., 3, 3) with its singular values set to (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s[..., None, :]) @ Vt


def _hom(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# Essential matrix / relative pose (reference: solve_5pts.cpp)
# ---------------------------------------------------------------------------


def _eight_point(p0, p1):
    """E from >= 8 normalized correspondences (p: (..., 8, 2)), batched over
    leading dims. Returns (..., 3, 3)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one = torch.ones_like(x0)
    # x1^T E x0 = 0 rows
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, one],
                    dim=-1)                                  # (..., 8, 9)
    E = _smallest_right_vector(A).reshape(A.shape[:-2] + (3, 3))
    return _essential_projection(E)


def _sampson_sq(E, p0, p1):
    """Squared Sampson distance of correspondences under E (normalized);
    E (..., 3, 3), p (N, 2) -> (..., N)."""
    x0, x1 = _hom(p0), _hom(p1)
    Ex0 = x0 @ E.transpose(-1, -2)          # (..., N, 3)
    Etx1 = x1 @ E
    num = torch.sum(x1 * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 \
        + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def _dlt_point(P0, P1, a, b):
    """DLT of points observed at normalized a, b (..., 2) by cameras
    P0, P1 (..., 3, 4). Returns X (..., 3)."""
    A = torch.stack(torch.broadcast_tensors(
        a[..., 0:1] * P0[..., 2, :] - P0[..., 0, :],
        a[..., 1:2] * P0[..., 2, :] - P0[..., 1, :],
        b[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        b[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]), dim=-2)
    X = _smallest_right_vector(A)
    w = X[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w


def _triangulate_pair(R, t, p0, p1):
    """DLT of each correspondence under cam0=[I|0], cam1=[R|t]. Returns
    points in cam0 and their depths in both cams (leading dims of R, t
    broadcast over the points)."""
    P0 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    P1 = torch.cat([R, t[..., None]], dim=-1)[..., None, :, :]
    X = _dlt_point(P0, P1, p0, p1)                    # (..., N, 3)
    z0 = X[..., 2]
    z1 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    return X, z0, z1


def decompose_essential(E):
    """Four (R, t) candidates from E (reference: decomposeE,
    solve_5pts.cpp:82-103). Returns R (4, 3, 3), t (4, 3)."""
    U, _, Vt = torch.linalg.svd(E)
    # keep proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def recover_pose(E, p0, p1, mask):
    """Pick the (R, t) candidate with the most points in front of both
    cameras (cheirality vote, reference: testTriangulation,
    solve_5pts.cpp:32-60). Returns (R, t, votes)."""
    Rs, ts = decompose_essential(E)
    _, z0, z1 = _triangulate_pair(Rs, ts, p0, p1)     # (4, N)
    votes = torch.sum((z0 > 0) & (z1 > 0) & mask, dim=-1)
    best = torch.argmax(votes)
    return Rs[best], ts[best], votes[best]


def draw_hypotheses(mask, n_hyp: int = 128, seed: int = 0):
    """(n_hyp, 8) indices of 8 distinct correspondences each, drawn with
    probability proportional to mask + 1e-9 (the JAX package's weights),
    from a generator on the mask's device seeded by `seed`."""
    w = mask.to(torch.float64) + 1e-9
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    return torch.multinomial((w / w.sum()).expand(n_hyp, -1), 8,
                             replacement=False, generator=gen)


def relative_pose_from_hypotheses(idx, p0, p1, mask,
                                  thresh: float = 0.3 / 460.0):
    """`relative_pose_ransac` on a given hypothesis set idx (H, 8): fit each
    minimal 8-point E, score all by Sampson distance, refit the best on its
    inliers, disambiguate by cheirality. Returns (R (3,3), t (3,),
    inliers (N,) bool) with x1 ~ R x0 + t."""
    N = p0.shape[0]
    Es = _eight_point(p0[idx], p1[idx])                 # (H, 3, 3)
    d2 = _sampson_sq(Es, p0, p1)                        # (H, N)
    inl = (d2 < thresh * thresh) & mask[None, :]
    best = torch.argmax(torch.sum(inl, dim=1))
    inliers = inl[best]
    # refit on inliers via the weighted 8-point normal system
    Arows = (_hom(p1)[:, :, None] * _hom(p0)[:, None, :]).reshape(N, 9)
    Aw = Arows * inliers[:, None]
    E2 = torch.linalg.svd(Aw, full_matrices=False)[2][-1].reshape(3, 3)
    E2 = _essential_projection(E2)
    R, t, _ = recover_pose(E2, p0, p1, inliers)
    return R, t, inliers


def relative_pose_ransac(p0, p1, mask, n_hyp: int = 128,
                         thresh: float = 0.3 / 460.0, seed: int = 0,
                         device="cuda"):
    """Relative pose cam0 -> cam1 by essential-matrix RANSAC.

    The reference delegates to cv::findFundamentalMat(RANSAC, 0.3/460, 0.99)
    (solve_5pts.cpp:24-29); here all `n_hyp` minimal 8-point hypotheses,
    drawn by `draw_hypotheses(mask, n_hyp, seed)`, are solved as one
    batched SVD and scored in parallel.

    p0, p1: (N, 2) normalized correspondences; mask: (N,) bool validity.
    Returns (R (3,3), t (3,), inliers (N,) bool) on `device`, with R, t
    mapping cam0 coords to cam1: x1 ~ R x0 + t."""
    dev = resolve_device(device)
    p0 = on_device(p0, dev)
    p1 = on_device(p1, dev, p0.dtype)
    mask = on_device(mask, dev).bool()
    return relative_pose_from_hypotheses(draw_hypotheses(mask, n_hyp, seed),
                                         p0, p1, mask, thresh)


# ---------------------------------------------------------------------------
# Camera-IMU rotation calibration (reference: initial_ex_rotation.cpp)
# ---------------------------------------------------------------------------


def calibrate_ex_rotation(q_cam, q_imu, valid, device="cuda"):
    """Solve R_ic from per-interval camera/IMU rotation pairs.

    q_cam[k]: camera-frame rotation (wxyz) between consecutive frames;
    q_imu[k]: the same interval's IMU rotation; valid: (K,) mask. The
    stacked Qleft(q_cam) - Qright(q_imu) system with Huber angular weights,
    smallest-singular-vector solution (reference: CalibrationExRotation,
    initial_ex_rotation.cpp:22-81).

    Returns (q_ic (4,) wxyz, ok: singular_values[2] > 0.25)."""
    dev = resolve_device(device)
    q_cam = on_device(q_cam, dev)
    q_imu = on_device(q_imu, dev, q_cam.dtype)
    m = on_device(valid, dev).to(q_cam.dtype)
    d = lie.quat_mul(lie.quat_conj(q_cam), q_imu)
    ang = torch.rad2deg(2.0 * torch.atan2(
        torch.linalg.vector_norm(d[:, 1:], dim=-1), torch.abs(d[:, 0])))
    huber = torch.where(ang > 5.0, 5.0 / torch.clamp(ang, min=1e-9),
                        torch.ones_like(ang))
    A = ((huber * m)[:, None, None]
         * (lie.quat_left(q_cam) - lie.quat_right(q_imu))).reshape(-1, 4)
    _, s, Vt = torch.linalg.svd(A, full_matrices=False)
    # q_cam = qn q_imu qn^-1, i.e. qn = q_ic^-1 — invert like the reference
    q = lie.quat_conj(Vt[-1])
    q = q * torch.sign(q[0])
    q = q / torch.linalg.vector_norm(q)
    return q, s[2] > 0.25


# ---------------------------------------------------------------------------
# Global SfM (reference: initial_sfm.cpp construct())
# ---------------------------------------------------------------------------


class SfmResult(NamedTuple):
    q: torch.Tensor        # (NF, 4) frame poses, wxyz, cam-to-world
    p: torch.Tensor        # (NF, 3) camera centers in world (frame l) coords
    pts: torch.Tensor      # (F, 3) triangulated landmarks, world coords
    pts_ok: torch.Tensor   # (F,) bool
    ok: torch.Tensor       # () bool overall success


def _retract_q(q, dq):
    return lie.quat_normalize(lie.quat_mul(q, lie.delta_q(dq)))


def _pnp_gn(q0, p0, pts_w, obs, m, iters: int = 10):
    """Gauss-Newton PnP: refine a camera pose (cam-to-world q, center p)
    minimizing masked reprojection error. pts_w (N,3), obs (N,2), m (N,)."""
    dtype, dev = pts_w.dtype, pts_w.device

    def residual(delta, q, p):
        qq = _retract_q(q, delta[3:6])
        pc = lie.quat_rotate(lie.quat_conj(qq), pts_w - (p + delta[0:3]))
        z = pc[:, 2]
        z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        return ((pc[:, :2] / z[:, None] - obs) * m[:, None]).reshape(-1)

    zero = torch.zeros(6, dtype=dtype, device=dev)
    eye = torch.eye(6, dtype=dtype, device=dev)
    q, p = q0, p0
    for _ in range(iters):
        r = residual(zero, q, p)
        J = jacfwd(residual)(zero, q, p)
        dx = -_solve(J.T @ J + 1e-8 * eye, J.T @ r)
        q, p = _retract_q(q, dx[3:6]), p + dx[0:3]
    return q, p


def _world_cameras(q, p):
    """[R^T | -R^T p] (..., 3, 4) of cam-to-world (q, p)."""
    Rt = lie.quat_to_rot(q).transpose(-1, -2)
    return torch.cat([Rt, -(Rt @ p[..., None])], dim=-1)


def _depth(q, p, X):
    """Depth of world points X in cameras (q, p) (broadcast)."""
    return lie.quat_rotate(lie.quat_conj(q), X - p)[..., 2]


def global_sfm(l: int, q_l_to_last, p_l_to_last, f_pts, f_obs,
               ba_iters: int = 15, device="cuda") -> SfmResult:
    """Windowed mono SfM (reference: GlobalSFM::construct, initial_sfm.cpp).

    Frame l is the gauge (identity); the newest frame's pose relative to l
    is given (from relative_pose_ransac). Pipeline, fixed-shape and masked:
      1. triangulate features seen in (l, last)
      2. PnP each frame l+1..last-1 from current structure, triangulate more
         (forward chain), then PnP l-1..0 (backward chain)
      3. triangulate everything remaining
      4. full bundle adjustment (GN, frame l fixed, the newest frame's
         position fixed: the scale gauge)

    l: int seed frame index. q_l_to_last, p_l_to_last: relative pose of
    the newest frame in l coords. f_pts: (F, NF, 2) normalized
    observations; f_obs: (F, NF) bool. Returns SfmResult on `device`
    (poses cam-to-world in frame-l gauge). Nothing is read back to the
    host."""
    dev = resolve_device(device)
    f_pts = on_device(f_pts, dev)
    dtype = f_pts.dtype
    f_obs = on_device(f_obs, dev).bool()
    F, NF = f_obs.shape

    q = lie.quat_identity(dtype, device=dev).repeat(NF, 1)
    p = torch.zeros((NF, 3), dtype=dtype, device=dev)
    q[NF - 1] = on_device(q_l_to_last, dev, dtype)
    p[NF - 1] = on_device(p_l_to_last, dev, dtype)
    pts = torch.zeros((F, 3), dtype=dtype, device=dev)
    pts_ok = torch.zeros((F,), dtype=torch.bool, device=dev)

    def tri_pair(i, j, q, p, pts, pts_ok):
        """Triangulate all features seen in frames i and j, not yet solved."""
        can = f_obs[:, i] & f_obs[:, j] & ~pts_ok
        new = _dlt_point(_world_cameras(q[i], p[i]),
                         _world_cameras(q[j], p[j]), f_pts[:, i], f_pts[:, j])
        # sanity: in front of both cameras
        good = can & (_depth(q[i], p[i], new) > 0.05) \
            & (_depth(q[j], p[j], new) > 0.05)
        return torch.where(good[:, None], new, pts), pts_ok | good

    def pnp_frame(i, q, p, pts, pts_ok, init_q, init_p):
        m = (f_obs[:, i] & pts_ok).to(dtype)
        qi, pi = _pnp_gn(init_q, init_p, pts, f_pts[:, i], m)
        enough = torch.sum(m) >= 6
        q, p = q.clone(), p.clone()
        q[i] = torch.where(enough, qi, init_q)
        p[i] = torch.where(enough, pi, init_p)
        return q, p

    pts, pts_ok = tri_pair(l, NF - 1, q, p, pts, pts_ok)
    # forward chain l+1 .. NF-2 (seed from previous frame), triangulate vs last
    for i in range(l + 1, NF - 1):
        q, p = pnp_frame(i, q, p, pts, pts_ok, q[i - 1], p[i - 1])
        pts, pts_ok = tri_pair(i, NF - 1, q, p, pts, pts_ok)
    # triangulate everything seen in (l, i)
    for i in range(l + 1, NF - 1):
        pts, pts_ok = tri_pair(l, i, q, p, pts, pts_ok)
    # backward chain l-1 .. 0, triangulate vs l
    for i in range(l - 1, -1, -1):
        q, p = pnp_frame(i, q, p, pts, pts_ok, q[i + 1], p[i + 1])
        pts, pts_ok = tri_pair(i, l, q, p, pts, pts_ok)

    # triangulate any feature with >= 2 solved-frame observations (first/last)
    obs_i = f_obs.to(torch.uint8)
    first = torch.argmax(obs_i, dim=1)
    last = NF - 1 - torch.argmax(torch.flip(obs_i, dims=[1]), dim=1)
    can = ~pts_ok & (torch.sum(obs_i, dim=1) >= 2)
    rows = torch.arange(F, device=dev)
    new = _dlt_point(_world_cameras(q[first], p[first]),
                     _world_cameras(q[last], p[last]),
                     f_pts[rows, first], f_pts[rows, last])
    good = can & (_depth(q[first], p[first], new) > 0.05) \
        & (_depth(q[last], p[last], new) > 0.05)
    pts = torch.where(good[:, None], new, pts)
    pts_ok = pts_ok | good

    # ---- bundle adjustment: frames + points, frame l fixed, frame-last
    # translation fixed (scale gauge), masked GN ----
    fi = torch.arange(F, device=dev).repeat_interleave(NF)
    ii = torch.arange(NF, device=dev).repeat(F)
    live = (f_obs & pts_ok[:, None]).reshape(-1)
    dim = 6 * NF + 3 * F
    free = torch.ones(dim, dtype=dtype, device=dev)
    free[3 * l: 3 * l + 3] = 0.0                          # dq_l
    free[3 * NF + 3 * l: 3 * NF + 3 * l + 3] = 0.0        # dp_l
    free[3 * NF + 3 * (NF - 1): 6 * NF] = 0.0             # dp_last
    free[6 * NF:] = pts_ok.to(dtype).repeat_interleave(3)  # frozen points
    eye = torch.eye(dim, dtype=dtype, device=dev)
    zero = torch.zeros(dim, dtype=dtype, device=dev)
    obs = f_pts.reshape(-1, 2)

    def split(vec):
        return (vec[: 3 * NF].reshape(NF, 3), vec[3 * NF: 6 * NF].reshape(NF, 3),
                vec[6 * NF:].reshape(F, 3))

    for _ in range(ba_iters):
        def res(vec, q_c=q, p_c=p, X_c=pts):
            dq, dp, dX = split(vec)
            qq = _retract_q(q_c, dq)
            pc = lie.quat_rotate(lie.quat_conj(qq[ii]),
                                 (X_c + dX)[fi] - (p_c + dp)[ii])
            z = pc[:, 2]
            z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
            r = pc[:, :2] / z[:, None] - obs
            return torch.where(live[:, None], r, torch.zeros_like(r)).reshape(-1)

        r0 = res(zero)
        J = jacfwd(res)(zero) * free[None, :]
        dx = -_solve(J.T @ J + 1e-6 * eye, J.T @ r0) * free
        dq, dp, dX = split(dx)
        q, p, pts = _retract_q(q, dq), p + dp, pts + dX
    return SfmResult(q=q, p=p, pts=pts, pts_ok=pts_ok,
                     ok=torch.sum(pts_ok) >= 10)


# ---------------------------------------------------------------------------
# Visual-IMU alignment (reference: initial_aligment.cpp:126-293)
# ---------------------------------------------------------------------------


def _tangent_basis(g):
    """Two unit vectors spanning the plane orthogonal to g
    (reference: TangentBasis, initial_aligment.cpp:190-205)."""
    a = g / torch.linalg.vector_norm(g)
    e = torch.eye(3, dtype=g.dtype, device=g.device)
    tmp = torch.where(torch.abs(a[0]) > 0.9, e[2], e[0])
    b = tmp - a * (a @ tmp)
    b = b / torch.linalg.vector_norm(b)
    return b, lie.cross(a, b)


def visual_imu_alignment(p_c, q_c, dp, dv, dt, tic, ric, g_norm: float,
                         refine_iters: int = 4, device="cuda"):
    """Solve velocities, gravity, and metric scale aligning an up-to-scale
    camera trajectory with IMU preintegration (reference: LinearAlignment +
    RefineGravity, initial_aligment.cpp:126-293).

    p_c: (K+1, 3) camera centers (SfM, frame-l gauge, arbitrary scale);
    q_c: (K+1, 4) body-to-reference rotations; dp, dv: (K, 3) IMU
    preintegrated deltas between consecutive frames; dt: (K,) interval
    durations; tic/ric: camera extrinsics; g_norm: |g|. Returns (v (K+1, 3)
    body-frame velocities, g_ref (3,), scale (), ok: scale > 0) on
    `device`."""
    dev = resolve_device(device)
    dp = on_device(dp, dev)
    dtype = dp.dtype
    p_c, q_c, dv, dt, tic = (on_device(x, dev, dtype)
                             for x in (p_c, q_c, dv, dt, tic))
    K = dp.shape[0]
    R = lie.quat_to_rot(q_c)                              # (K+1, 3, 3)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    ng = 3 * (K + 1)

    def build(g_fix=None, basis=None):
        gdim = 3 if basis is None else 2
        m = ng + gdim + 1
        A = torch.zeros((m, m), dtype=dtype, device=dev)
        b = torch.zeros((m,), dtype=dtype, device=dev)
        for k in range(K):
            H = torch.zeros((6, m), dtype=dtype, device=dev)
            z = torch.zeros((6,), dtype=dtype, device=dev)
            Ri_T = R[k].T
            dtk = dt[k]
            # rows 0:3 — position
            H[0:3, 3 * k: 3 * k + 3] = -dtk * I3
            gcols = Ri_T * (dtk * dtk / 2)
            H[0:3, ng: ng + gdim] = gcols if basis is None else gcols @ basis
            H[0:3, m - 1] = Ri_T @ (p_c[k + 1] - p_c[k]) / 100.0
            zp = dp[k] + Ri_T @ R[k + 1] @ tic - tic
            if basis is not None:
                zp = zp - gcols @ g_fix
            z[0:3] = zp
            # rows 3:6 — velocity: -I v_i + Ri^T R_{k+1} v_{k+1} + Ri^T dt g
            H[3:6, 3 * k: 3 * k + 3] = -I3
            H[3:6, 3 * (k + 1): 3 * (k + 1) + 3] = Ri_T @ R[k + 1]
            gcols2 = Ri_T * dtk
            H[3:6, ng: ng + gdim] = (gcols2 if basis is None
                                     else gcols2 @ basis)
            zv = dv[k]
            if basis is not None:
                zv = zv - gcols2 @ g_fix
            z[3:6] = zv
            A = A + H.T @ H
            b = b + H.T @ z
        A = A * 1000.0 + 1e-10 * torch.eye(m, dtype=dtype, device=dev)
        return _solve(A, b * 1000.0)

    x = build()
    g = x[ng: ng + 3]
    # refine gravity on its 2-dim tangent with |g| fixed
    for _ in range(refine_iters):
        g0 = g / torch.linalg.vector_norm(g) * g_norm
        basis = torch.stack(_tangent_basis(g0), dim=1)          # (3, 2)
        x = build(g_fix=g0, basis=basis)
        g = g0 + basis @ x[ng: ng + 2]
    g = g / torch.linalg.vector_norm(g) * g_norm
    # final solve at refined gravity for velocities and scale
    basis = torch.stack(_tangent_basis(g), dim=1)
    x = build(g_fix=g, basis=basis)
    v = x[:ng].reshape(K + 1, 3)
    s = x[-1] / 100.0
    return v, g, s, s > 0
