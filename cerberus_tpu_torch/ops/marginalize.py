"""Square-root marginalization prior and the window's gauge basis (port of
`cerberus_tpu/ops/marginalize.py`).

`marginalize_old` absorbs frame 0 (its IMU+leg factor, the projection
factors anchored there and the old prior) into a new linear prior on the
dense 222-dim tangent; `marginalize_second_new` drops frame 9's pose from
the prior. Both QR-factorize the column-permuted weighted Jacobian
(`_qr_marginalize`, `torch.linalg.qr` as the JAX package leaves it to
XLA), project the gauge directions out and relabel the frames for the
window slide with a column permutation. The index sets and permutation
matrices are made once per device (`_constants`), so a marginalization on
the card copies nothing from the host and reads nothing back.

The eigendecomposition variants `_prior_from_Hb` and `_schur_drop` (the
reference's eigen square root and Schur drop, marginalization_factor.cpp:
281-305), which no path of the JAX package calls, are ported as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.structured import linearize_rows
from cerberus_tpu_torch.utils import lie

NF = C.NUM_FRAMES
_EIG_EPS = 1e-8  # reference: marginalization_factor.cpp:281-305


def _prior_from_Hb(H, b, dtype):
    """(J, r) with J^T J = H, J^T r = b via eigen square root.

    The eigendecomposition runs on the Jacobi-equilibrated matrix
    D^-1/2 H D^-1/2: the window Hessian mixes scales across ~12 orders of
    magnitude, so eigh's relative roundoff (~1e-16 * lam_max) would
    otherwise produce spurious eigenvalues far above the reference's
    absolute 1e-8 cutoff, and the S^-1/2 in `r` would amplify gradient noise
    along them. After equilibration lam_max ~ n and the cutoff is safely
    above the noise floor."""
    dg = torch.diagonal(H)
    d = torch.sqrt(torch.clamp(dg, min=1e-12))
    Hs = H / (d[:, None] * d[None, :])
    Hs = 0.5 * (Hs + Hs.T)
    lam, V = torch.linalg.eigh(Hs)
    good = lam > _EIG_EPS
    s = torch.where(good, torch.sqrt(torch.clamp(lam, min=_EIG_EPS)), 0.0)
    s_inv = torch.where(good, 1.0 / torch.clamp(s, min=_EIG_EPS), 0.0)
    J = (s[:, None] * V.T) * d[None, :]
    r = s_inv[:, None] * V.T @ (b / d)
    return J.to(dtype), r.to(dtype)


def _schur_drop(H, b, drop_mask):
    """Schur-complement out the dims where drop_mask is True.

    Returns (H_keep, b_keep) with dropped rows/cols zeroed. Uses an eigh
    pseudo-inverse of the dropped block (reference semantics, eps 1e-8),
    equilibrated for the same scale-spread reason as _prior_from_Hb."""
    m = drop_mask.to(H.dtype)
    keep = 1.0 - m
    # A = [H_dd, 0; 0, I] in a mask-partitioned sense
    A = H * m[:, None] * m[None, :] + torch.diag_embed(keep)
    dg = torch.diagonal(A)
    d = torch.sqrt(torch.clamp(dg, min=1e-12))
    As = A / (d[:, None] * d[None, :])
    As = 0.5 * (As + As.T)
    lam, V = torch.linalg.eigh(As)
    lam_inv = torch.where(lam > _EIG_EPS,
                          1.0 / torch.clamp(lam, min=_EIG_EPS), 0.0)
    A_inv = (V * lam_inv[None, :]) @ V.T
    A_inv = A_inv / (d[:, None] * d[None, :])
    A_inv = A_inv * m[:, None] * m[None, :]      # restrict to dropped block
    Hd = H * m[None, :]                          # columns into dropped dims
    H_new = H - Hd @ A_inv @ Hd.T
    b_new = b - Hd @ (A_inv @ b)
    H_new = H_new * keep[:, None] * keep[None, :]
    b_new = b_new * keep
    return H_new, b_new


def frame_indices(i: int, *, device) -> torch.Tensor:
    """Global tangent indices of frame i (segment-major layout)."""
    return torch.as_tensor(fac.frame_tangent_indices(i), device=device)


def _gauge_null_basis(state: fac.WindowState, dim: int) -> torch.Tensor:
    """(dim, 4) basis of the window's gauge freedoms at `state`: global
    translation (3) and rotation about gravity/yaw (1), on the dense tangent,
    with zero rows for the rho/extrinsic/td dims and any appended depths.

    Per frame i: translation columns dp_i = e_d; yaw column dp_i = z x p_i,
    dtheta_i = R_i^T z (right perturbation), dv_i = z x v_i. Built from
    concatenations (no in-place writes), so it runs under `torch.func.vmap`.
    """
    p, q, v = state.p, state.q, state.v                       # (11, 3|4|3)
    dtype, dev = p.dtype, p.device
    zhat = torch.eye(3, dtype=dtype, device=dev)[2].expand(NF, 3)
    z_x_p = lie.cross(zhat, p)
    Ri_T_z = lie.quat_rotate(lie.quat_conj(q), zhat)
    z_x_v = lie.cross(zhat, v)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(NF, 3, 3)
    zero33 = torch.zeros((NF, 3, 3), dtype=dtype, device=dev)
    pose = torch.cat([torch.cat([eye, z_x_p[..., None]], dim=-1),
                      torch.cat([zero33, Ri_T_z[..., None]], dim=-1)], dim=-2)
    sb = torch.cat([torch.cat([zero33, z_x_v[..., None]], dim=-1),
                    torch.zeros((NF, 6, 4), dtype=dtype, device=dev)], dim=-2)
    rest = torch.zeros((dim - fac.RHO_OFF, 4), dtype=dtype, device=dev)
    return torch.cat([pose.reshape(6 * NF, 4), sb.reshape(9 * NF, 4), rest])


def _project_out_gauge(H, b, state: fac.WindowState, keep_mask=None):
    """Project the 4 gauge directions out of (H, b): H <- P H P, b <- P b
    with P = I - N (N^T N)^-1 N^T. `keep_mask` (dim,) restricts the basis to
    the kept dims."""
    P = _gauge_projector(state, H.shape[0], keep_mask)
    return P @ H @ P, P @ b


def _gauge_projector(state: fac.WindowState, dim: int, keep_mask=None,
                     eps: float = 1e-12):
    """P = I - N (N^T N + eps I)^-1 N^T, N the gauge basis (rows outside
    `keep_mask` zeroed); the solver's full-system projection takes
    eps = 1e-10, as the JAX solver's does."""
    dtype, dev = state.p.dtype, state.p.device
    N = _gauge_null_basis(state, dim)
    if keep_mask is not None:
        N = N * keep_mask.to(dtype)[:, None]
    G = N.T @ N + eps * torch.eye(4, dtype=dtype, device=dev)
    # solve_ex: no error check read back to the host
    return torch.eye(dim, dtype=dtype, device=dev) \
        - N @ torch.linalg.solve_ex(G, N.T).result


def _qr_marginalize(J, r, drop_idx, keep_idx, reg: float = 1e-4):
    """Square-root marginalization: column-permute the weighted Jacobian to
    [dropped | kept], QR-factorize [J_perm | r] with sqrt-Tikhonov rows on
    the dropped dims, and return the kept-block triangular factor
    (R22 (K, K), r2 (K,)) in keep_idx column order — the exact linear prior
    after minimizing over the dropped dims. The rows of R carry arbitrary
    signs; (R22, r2) is consistent as a pair (compare R22^T R22 and
    R22^T r2). drop_idx / keep_idx: int64 tensors on J's device."""
    dtype, dev = J.dtype, J.device
    D = drop_idx.shape[0]
    Jp = J.index_select(1, torch.cat([drop_idx, keep_idx]))
    n = Jp.shape[1]
    reg_rows = torch.cat([
        torch.eye(D, dtype=dtype, device=dev) * (reg ** 0.5),
        torch.zeros((D, n - D + 1), dtype=dtype, device=dev)], dim=1)
    A = torch.cat([torch.cat([Jp, r[:, None]], dim=1), reg_rows])
    R = torch.linalg.qr(A, mode="r").R
    return R[D:n, D:n], R[D:n, n]


_CONSTANTS: dict = {}


def _constants(device):
    """Index sets and permutation matrices of both marginalizations, made
    once per device: drop/keep indices, the post-slide column permutations
    (float64; cast at use) and the keep masks."""
    key = torch.device(device)
    if key not in _CONSTANTS:
        D = fac.D_DENSE
        old_drop = fac.frame_tangent_indices(0)
        i = C.WINDOW_SIZE - 1
        new_drop = np.arange(fac.POSE_OFF + 6 * i, fac.POSE_OFF + 6 * i + 6)
        old_keep = np.setdiff1d(np.arange(D), old_drop)
        new_keep = np.setdiff1d(np.arange(D), new_drop)
        mask = lambda keep: np.isin(np.arange(D), keep)
        t = lambda x: torch.as_tensor(x, device=key)
        _CONSTANTS[key] = dict(
            old_drop=t(old_drop), old_keep=t(old_keep),
            old_keep_mask=t(mask(old_keep)),
            old_perm=t(shift_permutation()),
            new_drop=t(new_drop), new_keep=t(new_keep),
            new_keep_mask=t(mask(new_keep)),
            new_perm=t(shift_second_new_permutation()))
    return _CONSTANTS[key]


def _embed_prior(R22, r2, keep_idx, state, keep_mask, perm):
    """Place (R22, r2) into the dense (222, 222) layout (rows 0..K-1, kept
    columns), zero the gauge directions (so the solver's re-anchoring never
    fights the prior) and relabel the frames with the column permutation."""
    dtype, dev = R22.dtype, R22.device
    D, K = fac.D_DENSE, keep_idx.shape[0]
    prior_J = torch.zeros((D, D), dtype=dtype, device=dev)
    prior_J[:K] = prior_J[:K].index_copy(1, keep_idx, R22)
    prior_r = torch.cat([r2, torch.zeros((D - K,), dtype=dtype, device=dev)])
    prior_J = prior_J @ _gauge_projector(state, D, keep_mask)
    return prior_J @ perm.to(dtype), prior_r


def marginalize_old(state: fac.WindowState, data: fac.WindowData):
    """MARGIN_OLD: absorb frame 0 into a new prior (reference:
    estimator.cpp:1248-1376): the existing prior, the IMU+leg factor 0->1
    and every projection factor anchored at frame 0 (whose depths are
    dropped too). The standing calibration prior is left out: absorbing it
    every slide would pin the extrinsics/td to the config. Returns (prior_J,
    prior_r, prior_valid) on the dense tangent, SHIFTED to the post-slide
    frame labels (old frame i -> i-1)."""
    F = state.depth.shape[0]
    dtype, dev = state.p.dtype, state.p.device
    k = _constants(dev)
    anchored0 = data.f_start == 0
    sub = data._replace(
        interval_valid=data.interval_valid
        & (torch.arange(10, device=dev) == 0),
        f_valid=data.f_valid & anchored0,
        calib_w=torch.zeros_like(data.calib_w))
    r, J = linearize_rows(state, sub)
    # zero the depth columns of non-marginalized features so every depth
    # column can sit in the drop group
    dmask = (anchored0 & data.f_valid).to(dtype)
    J = torch.cat([J[:, :fac.D_DENSE], J[:, fac.D_DENSE:] * dmask[None, :]],
                  dim=1)
    drop_idx = torch.cat([k["old_drop"], fac.D_DENSE
                          + torch.arange(F, device=dev)])
    R22, r2 = _qr_marginalize(J, r, drop_idx, k["old_keep"])
    prior_J, prior_r = _embed_prior(R22, r2, k["old_keep"], state,
                                    k["old_keep_mask"], k["old_perm"])
    return prior_J, prior_r, torch.ones((), dtype=torch.bool, device=dev)


def marginalize_second_new(state: fac.WindowState, data: fac.WindowData):
    """MARGIN_SECOND_NEW: drop frame 9's pose from the existing prior only
    (reference: estimator.cpp:1377-1455). The prior residual is evaluated
    at `state`, the new linearization point. Returns (prior_J, prior_r,
    prior_valid) with frame 10 relabelled 9; valid only if the old prior was
    and touched the dropped pose."""
    k = _constants(state.p.device)
    r_here = data.prior_r + data.prior_J @ fac.local_diff(state,
                                                          data.prior_lin)
    R22, r2 = _qr_marginalize(data.prior_J, r_here, k["new_drop"],
                              k["new_keep"])
    prior_J, prior_r = _embed_prior(R22, r2, k["new_keep"], state,
                                    k["new_keep_mask"], k["new_perm"])
    i = C.WINDOW_SIZE - 1
    touched = torch.any(torch.abs(
        data.prior_J[:, fac.POSE_OFF + 6 * i:fac.POSE_OFF + 6 * i + 6]) > 0)
    return prior_J, prior_r, data.prior_valid & touched


def _frame_relabel_permutation(mapping) -> np.ndarray:
    """(222, 222) P with (J P) applying old-frame -> new-frame relabeling.
    mapping: dict old_frame -> new_frame; unmapped old frames vanish.
    Ex/td columns map identically."""
    P = np.zeros((fac.D_DENSE, fac.D_DENSE))
    for old, new in mapping.items():
        P[np.ix_(fac.frame_tangent_indices(old),
                 fac.frame_tangent_indices(new))] = np.eye(fac.PER_FRAME)
    P[fac.EX0_OFF:, fac.EX0_OFF:] = np.eye(13)
    return P


def shift_permutation() -> np.ndarray:
    """Relabel old frame i -> new i-1 (MARGIN_OLD slide); frame-0 columns
    vanish (just marginalized); the new frame 10 has no prior columns."""
    return _frame_relabel_permutation(
        {i: i - 1 for i in range(1, C.NUM_FRAMES)})


def shift_second_new_permutation() -> np.ndarray:
    """Frame 10 -> 9, frames 0..8 identity, frame 9 vanishes."""
    m = {i: i for i in range(C.WINDOW_SIZE - 1)}
    m[C.WINDOW_SIZE] = C.WINDOW_SIZE - 1
    return _frame_relabel_permutation(m)
