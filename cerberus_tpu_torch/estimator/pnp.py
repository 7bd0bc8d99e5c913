"""Perspective-n-Point pose solvers (host-side, numpy).

The port's own copy of `cerberus_tpu/estimator/pnp.py` (NumPy only), so
that the port imports nothing of the JAX package.

TPU-native counterpart of the reference's PnP frame-pose initialization
(reference: src/featureTracker/feature_manager.cpp:215-300 solvePoseByPnP /
initFramePoseByPnP, which wraps cv::solvePnP's iterative solver seeded at the
previous frame's pose). Here the same problem is solved with an explicit
Huber-robust Gauss-Newton on SE(3) plus a DLT+RANSAC fallback for recovery
when the seed pose is far off (the reference has no recovery path: a bad seed
simply fails). All math is double-precision numpy — this is a tiny host-side
problem (N <= a few hundred points, 6 dof), not device work.

Conventions: R_wc, t_wc = camera-to-world (camera pose in world frame);
points project via x_cam = R_wc^T (X - t_wc), uv = x_cam[:2] / x_cam[2].
"""

from __future__ import annotations

import numpy as np


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + _skew(w)
    K = _skew(w / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def project(R_wc, t_wc, pts3d):
    """(N,3) world points -> (N,2) normalized-plane + (N,) camera depth."""
    pc = (pts3d - t_wc) @ R_wc  # = R_wc^T (X - t)
    z = pc[:, 2]
    uv = pc[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]
    return uv, z


def solve_pnp_gn(pts3d, pts2d, R_wc, t_wc, iters=10, huber=3.0 / 460.0):
    """Huber-robust Gauss-Newton refinement of a camera pose.

    Matches the role of cv::solvePnP(useExtrinsicGuess=true) in the
    reference's solvePoseByPnP (feature_manager.cpp:215-257). Returns
    (R_wc, t_wc, ok, rms) — ok False when N < 4 or the normal equations are
    singular.
    """
    pts3d = np.asarray(pts3d, float)
    pts2d = np.asarray(pts2d, float)
    n = len(pts3d)
    if n < 4:
        return R_wc, t_wc, False, np.inf
    R, t = R_wc.copy(), t_wc.copy()
    rms = np.inf
    for _ in range(iters):
        pc = (pts3d - t) @ R
        z = np.where(np.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        uv = pc[:, :2] / z[:, None]
        r = (uv - pts2d)  # (N, 2)
        # Huber weights on the 2-vector norm
        e = np.linalg.norm(r, axis=1)
        w = np.where(e <= huber, 1.0, huber / np.maximum(e, 1e-12))
        # jacobian of r wrt [dtheta (right-perturb of R), dt] (cam-to-world)
        # pc = R^T (X - t); d pc/d t = -R^T; d pc/d theta = skew(pc)
        # (right perturbation R <- R expm(theta): d(R e)^T x = skew(R^T x) e)
        inv_z = 1.0 / z
        J = np.zeros((n, 2, 6))
        duv_dpc = np.zeros((n, 2, 3))
        duv_dpc[:, 0, 0] = inv_z
        duv_dpc[:, 1, 1] = inv_z
        duv_dpc[:, 0, 2] = -pc[:, 0] * inv_z ** 2
        duv_dpc[:, 1, 2] = -pc[:, 1] * inv_z ** 2
        dpc_dth = np.stack([_skew(p) for p in pc])          # (N,3,3)
        J[:, :, 0:3] = duv_dpc @ dpc_dth
        J[:, :, 3:6] = duv_dpc @ (-R.T)[None]
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        A = np.einsum("nik,nil->kl", Jw, J)
        b = np.einsum("nik,ni->k", Jw, r)
        try:
            dx = np.linalg.solve(A + 1e-12 * np.eye(6), -b)
        except np.linalg.LinAlgError:
            return R, t, False, np.inf
        R = R @ _exp_so3(dx[0:3])
        t = t + dx[3:6]
        rms = float(np.sqrt(np.mean(np.sum((rw) ** 2, axis=1))))
        if np.linalg.norm(dx) < 1e-10:
            break
    return R, t, True, rms


def dlt_pose(pts3d, pts2d):
    """Direct linear pose from >= 6 points: solve the 3x4 projection matrix
    [R^T | -R^T t] linearly, then project onto SO(3). Seed-free — used as the
    RANSAC model solver for recovery from arbitrary initial poses."""
    n = len(pts3d)
    if n < 6:
        return None
    A = np.zeros((2 * n, 12))
    X = np.concatenate([pts3d, np.ones((n, 1))], axis=1)
    A[0::2, 0:4] = X
    A[0::2, 8:12] = -pts2d[:, 0:1] * X
    A[1::2, 4:8] = X
    A[1::2, 8:12] = -pts2d[:, 1:2] * X
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    P = Vt[-1].reshape(3, 4)
    M = P[:, :3]
    # sign: depths should be positive for the majority
    depths = X @ P[2]
    if np.median(depths) < 0:
        P, M = -P, -M
    # nearest rotation (polar decomposition), scale from svd
    U, S, Vt2 = np.linalg.svd(M)
    Rcw = U @ Vt2
    if np.linalg.det(Rcw) < 0:
        Rcw = U @ np.diag([1, 1, -1.0]) @ Vt2
    scale = np.mean(S)
    tcw = P[:, 3] / max(scale, 1e-12)
    # cam_T_w -> w_T_cam
    R_wc = Rcw.T
    t_wc = -Rcw.T @ tcw
    return R_wc, t_wc


def ransac_pnp(pts3d, pts2d, iters=64, thresh=5.0 / 460.0, seed=0,
               min_inliers=8):
    """RANSAC over 6-point DLT models + GN polish on the inlier set.

    Seed-free global pose recovery (used when GN from the motion-model seed
    diverges, e.g. after severe dead-reckoning corruption). Returns
    (R_wc, t_wc, inlier_mask) or None."""
    pts3d = np.asarray(pts3d, float)
    pts2d = np.asarray(pts2d, float)
    n = len(pts3d)
    if n < max(6, min_inliers):
        return None
    rng = np.random.default_rng(seed)
    best = None
    best_cnt = 0
    for _ in range(iters):
        idx = rng.choice(n, 6, replace=False)
        model = dlt_pose(pts3d[idx], pts2d[idx])
        if model is None:
            continue
        uv, z = project(model[0], model[1], pts3d)
        err = np.linalg.norm(uv - pts2d, axis=1)
        inl = (err < thresh) & (z > 0.05)
        cnt = int(inl.sum())
        if cnt > best_cnt:
            best, best_cnt = (model, inl), cnt
            if cnt > 0.9 * n:
                break
    if best is None or best_cnt < min_inliers:
        return None
    (R, t), inl = best
    R, t, ok, _ = solve_pnp_gn(pts3d[inl], pts2d[inl], R, t, iters=8)
    if not ok:
        return None
    uv, z = project(R, t, pts3d)
    err = np.linalg.norm(uv - pts2d, axis=1)
    inl = (err < thresh) & (z > 0.05)
    return R, t, inl
