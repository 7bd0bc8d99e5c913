"""Packing measurement streams into a WindowData problem (frozen copy of
`cerberus_tpu_torch/estimator/packing.py`).

Bridges the host-side sliding-window bookkeeping (feature slots, interval
buffers) and the fixed-shape problem (ops/factors.WindowData).
`build_window_data` is the part that runs inside the streaming estimator's
per-frame step: given tensors already on the card it copies nothing from
the host and reads nothing back. `pack_window_data` is the eager wrapper
that takes host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from vilo_bench.frozen import config as C
from vilo_bench.frozen import factors as fac
from vilo_bench.frozen.preintegration import ILPreint
from vilo_bench.frozen import lie


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of A (..., n, n), column by column
    (left-looking: column j = (A[j:, j] - L[j:, :j] L[j, :j]) / L[j, j]).
    A non-SPD matrix gives NaN (frozen copy of
    `cerberus_tpu_torch/ops/lane_cholesky.py::cholesky_plain`)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        d = torch.sqrt(s[..., 0])
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return L


def whiten_chol(P: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Cholesky factor L of P (+jitter I); whitening is solve(L, r)."""
    n = P.shape[-1]
    Ps = 0.5 * (P + P.transpose(-1, -2))
    if jitter:
        Ps = Ps + jitter * torch.eye(n, dtype=P.dtype, device=P.device)
    return cholesky_plain(Ps)


def default_free_mask(optimize_leg_bias=True, optimize_extrinsic=False,
                      optimize_td=False, use_imu=True) -> np.ndarray:
    """(222,) bool free mask (reference: estimator.cpp:1065-1105
    SetParameterBlockConstant logic)."""
    m = np.zeros((fac.D_DENSE,), bool)
    m[fac.POSE_OFF: fac.POSE_OFF + 6 * C.NUM_FRAMES] = True
    m[fac.SB_OFF: fac.SB_OFF + 9 * C.NUM_FRAMES] = use_imu
    m[fac.RHO_OFF: fac.RHO_OFF + 4 * C.NUM_FRAMES] = optimize_leg_bias
    m[fac.EX0_OFF: fac.EX0_OFF + 12] = optimize_extrinsic
    m[fac.TD_OFF] = optimize_td
    return m


def pad_features(features: dict, F: int) -> dict:
    """Pad the feature export to the fixed capacity F (numpy, host side)."""
    Fa = features["start"].shape[0]
    if Fa > F:
        raise ValueError(f"too many features {Fa} > {F}")

    def padf(x, fill=0.0):
        x = np.asarray(x)
        out = np.full((F,) + x.shape[1:], fill, dtype=x.dtype)
        out[:Fa] = x
        return out

    return dict(
        start=padf(features["start"]).astype(np.int32),
        pts=padf(features["pts"]), pts_r=padf(features["pts_r"]),
        vel=padf(features["vel"]), vel_r=padf(features["vel_r"]),
        td=padf(features["td"]),
        obs=padf(features["obs"]).astype(bool),
        stereo=padf(features["stereo"]).astype(bool),
        valid=padf(features["valid"]).astype(bool),
    )


def _zero_pre(dtype, device) -> ILPreint:
    """Placeholder ILPreint for invalid intervals (identity dq, identity P
    so the Cholesky stays defined)."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    one = torch.ones((1,), dtype=dtype, device=device)
    return ILPreint(
        dp=z(3), dq=torch.cat([one, z(3)]), dv=z(3), deps=z(4, 3),
        sum_deps=z(3), J=z(31, 31),
        P=torch.eye(31, dtype=dtype, device=device), sum_dt=z(), ba=z(3),
        bg=z(3), rho=z(4), contact_flag=z(4),
        integration_contact=torch.zeros((4,), dtype=torch.bool, device=device),
        ff_min=z(4), ff_max=z(4), ff_window=z(4, C.FOOT_VAR_WINDOW_SIZE),
        ff_idx=torch.zeros((4,), dtype=torch.int32, device=device))


def _stack_preints(pres, valid, *, use_leg_odom: bool, cov_jitter: float):
    """Stack 10 ILPreints into the WindowData preint fields: the whitening
    factor of each interval's covariance (identity for invalid intervals
    and for a factor that comes out NaN) and the validity."""
    s = ILPreint(*(torch.stack(xs) for xs in zip(*pres)))
    dtype, dev = s.P.dtype, s.P.device
    eye = torch.eye(31, dtype=dtype, device=dev)
    pre_P = torch.where(valid[:, None, None], s.P, eye)
    if not use_leg_odom:
        # vision+IMU-only mode: decouple the leg rows (eps 9:21, rho 27:31)
        # and inflate their variance — the reference's own all-feet-airborne
        # mechanism (imu_leg_integration_base.cpp:353-358)
        i = torch.arange(31, device=dev)
        leg = ((i >= 9) & (i < 21)) | (i >= 27)
        keep = (~leg).to(dtype)
        pre_P = pre_P * keep[None, :, None] * keep[None, None, :] \
            + torch.diag(leg.to(dtype) * 1e10)[None]
    pre_L = whiten_chol(pre_P, jitter=cov_jitter)
    bad = torch.isnan(pre_L).any(dim=-1).any(dim=-1)
    pre_L = torch.where(bad[:, None, None], eye, pre_L)
    # sum_dt > 10 s excluded (reference: estimator.cpp:1119)
    valid = valid & (s.sum_dt < 10.0)
    return (s.dp, s.dq, s.dv, s.deps, s.J, pre_L, s.sum_dt, s.ba, s.bg,
            s.rho, valid)


def zero_prior(F: int, dtype, *, device):
    """The 'no prior yet' prior tuple (J, r, lin, valid=False)."""
    return (torch.zeros((fac.D_DENSE, fac.D_DENSE), dtype=dtype,
                        device=device),
            torch.zeros((fac.D_DENSE,), dtype=dtype, device=device),
            fac.WindowState.zero(F, dtype, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def fac_F(feats_pad: dict) -> int:
    return feats_pad["start"].shape[0]


def build_window_data(preints, interval_valid, feats_pad: dict, prior,
                      free_mask, gravity, calib_prior, *,
                      use_leg_odom: bool, cov_jitter: float,
                      dtype) -> fac.WindowData:
    """WindowData on the preintegrations' device.

    Args:
      preints: tuple of 10 ILPreint (zero placeholder for invalid ones).
      interval_valid: (10,) bool.
      feats_pad: pad_features() output (numpy arrays or tensors).
      prior: (J, r, lin_state, valid) — zero_prior() when absent.
      calib_prior: (tic_ref (2,3), qic_ref (2,4), td_ref, w (13,)) or None.
    Every argument that is already a tensor of the right dtype on that
    device is used as it is (no copy)."""
    dev = preints[0].dp.device
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    b = lambda x: torch.as_tensor(x, dtype=torch.bool, device=dev)

    def co(x):  # float leaves to the pack dtype, bools and ints kept
        x = torch.as_tensor(x, device=dev)
        return x.to(dtype) if x.is_floating_point() else x

    pres = tuple(ILPreint(*map(co, p)) for p in preints)
    (pre_dp, pre_dq, pre_dv, pre_deps, pre_J, pre_L, pre_dt, pre_ba,
     pre_bg, pre_rho, valid) = _stack_preints(
        pres, b(interval_valid), use_leg_odom=use_leg_odom,
        cov_jitter=cov_jitter)

    prior_J, prior_r, prior_lin, prior_valid = prior
    prior_lin = fac.WindowState(*map(co, prior_lin))._replace(
        depth=torch.zeros((fac_F(feats_pad),), dtype=dtype, device=dev))

    if calib_prior is None:
        calib_w = torch.zeros((13,), dtype=dtype, device=dev)
        calib_tic = torch.zeros((2, 3), dtype=dtype, device=dev)
        calib_qic = lie.quat_identity(dtype, device=dev).repeat(2, 1)
        calib_td = torch.zeros((), dtype=dtype, device=dev)
    else:
        tic_ref, qic_ref, td_ref, w = calib_prior
        calib_w, calib_tic, calib_qic, calib_td = (
            f(w), f(tic_ref), f(qic_ref), f(td_ref))

    return fac.WindowData(
        pre_dp=pre_dp, pre_dq=pre_dq, pre_dv=pre_dv, pre_deps=pre_deps,
        pre_J=pre_J, pre_L=pre_L, pre_dt=pre_dt, pre_ba=pre_ba,
        pre_bg=pre_bg, pre_rho=pre_rho, interval_valid=valid,
        f_start=torch.as_tensor(feats_pad["start"], dtype=torch.int32,
                                device=dev),
        f_pts=f(feats_pad["pts"]), f_pts_r=f(feats_pad["pts_r"]),
        f_vel=f(feats_pad["vel"]), f_vel_r=f(feats_pad["vel_r"]),
        f_td=f(feats_pad["td"]),
        f_obs=b(feats_pad["obs"]), f_stereo=b(feats_pad["stereo"]),
        f_valid=b(feats_pad["valid"]),
        prior_J=f(prior_J), prior_r=f(prior_r), prior_valid=b(prior_valid),
        prior_lin=prior_lin,
        free_mask=b(free_mask), gravity=f(gravity),
        calib_w=calib_w, calib_tic=calib_tic, calib_qic=calib_qic,
        calib_td=calib_td,
    )


def coerce_preints(preints, dtype, *, device):
    """(tuple of 10 ILPreint with zero placeholders, (10,) valid numpy)."""
    zero = _zero_pre(dtype, device)
    pres = tuple(zero if p is None else p for p in preints)
    valid_np = np.array([p is not None for p in preints])
    return pres, valid_np


def pack_window_data(
    preints: list,
    features: dict,
    prior=None,
    free_mask: np.ndarray | None = None,
    gravity=(0.0, 0.0, 9.805),
    F: int = C.MAX_FEATURES,
    dtype=None,
    cov_jitter: float = 1e-14,
    calib_prior=None,
    use_leg_odom: bool = True,
    device=None,
) -> fac.WindowData:
    """Assemble a WindowData eagerly (host padding, then build_window_data).

    Args:
      preints: list of 10 ILPreint (or None for invalid intervals).
      features: dict with numpy arrays
        start (Fa,), pts (Fa,11,3), pts_r (Fa,11,3), vel (Fa,11,2),
        vel_r (Fa,11,2), td (Fa,11), obs (Fa,11) bool, stereo (Fa,11) bool,
        valid (Fa,) bool  — Fa <= F; padded to F here.
      prior: None or (prior_J (222,222), prior_r (222,), lin_state
        [, valid]).
      calib_prior: None (disabled) or (tic_ref (2,3), qic_ref (2,4), td_ref,
        w (13,)).
      dtype, device: default to the first valid preintegration's.
    """
    first = next((p for p in preints if p is not None), None)
    if dtype is None:
        dtype = first.dp.dtype
    if device is None:
        device = first.dp.device
    pres, valid_np = coerce_preints(preints, dtype, device=device)
    feats_pad = pad_features(features, F)
    if prior is None:
        prior_t = zero_prior(F, dtype, device=device)
    else:
        valid = prior[3] if len(prior) > 3 else True
        prior_t = (prior[0], prior[1], prior[2], valid)
    if free_mask is None:
        free_mask = default_free_mask()
    return build_window_data(
        pres, valid_np, feats_pad, prior_t, free_mask, gravity, calib_prior,
        use_leg_odom=use_leg_odom, cov_jitter=cov_jitter, dtype=dtype)
