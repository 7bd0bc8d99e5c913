"""Packing measurement streams into a WindowData problem (port of the part
of `cerberus_tpu/estimator/packing.py` that `pack_window_data` and
`default_free_mask` need).

This slice packs a window with every interval valid, no marginalization
prior and the calibration prior disabled — what
`data/window_builder.build_window_from_sim` asks for. Placeholder
intervals, priors, `build_window_data` and the vision+IMU-only mode wait
for the streaming estimator's slice.
"""

from __future__ import annotations

import numpy as np
import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.lane_cholesky import cholesky_plain
from cerberus_tpu_torch.ops.preintegration import ILPreint
from cerberus_tpu_torch.utils import lie


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


def pack_window_data(
    preints: list[ILPreint],
    features: dict,
    free_mask: np.ndarray | None = None,
    gravity=(0.0, 0.0, 9.805),
    F: int = C.MAX_FEATURES,
    cov_jitter: float = 1e-14,
) -> fac.WindowData:
    """Assemble a WindowData on the preintegrations' device and dtype.

    Args:
      preints: list of 10 ILPreint, one per interval, all valid.
      features: dict with numpy arrays
        start (Fa,), pts (Fa,11,3), pts_r (Fa,11,3), vel (Fa,11,2),
        vel_r (Fa,11,2), td (Fa,11), obs (Fa,11) bool, stereo (Fa,11) bool,
        valid (Fa,) bool  — Fa <= F; padded to F here.
    """
    dtype, dev = preints[0].dp.dtype, preints[0].dp.device
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    b = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.bool, device=dev)
    s = ILPreint(*(torch.stack(xs) for xs in zip(*preints)))
    pre_L = whiten_chol(s.P, jitter=cov_jitter)
    bad = torch.isnan(pre_L).any(dim=-1).any(dim=-1)
    pre_L = torch.where(bad[:, None, None],
                        torch.eye(31, dtype=dtype, device=dev)[None], pre_L)
    # sum_dt > 10 s excluded (reference: estimator.cpp:1119)
    valid = s.sum_dt < 10.0

    feats = pad_features(features, F)
    if free_mask is None:
        free_mask = default_free_mask()
    prior_lin = fac.WindowState.zero(F, dtype, device=dev)
    return fac.WindowData(
        pre_dp=s.dp, pre_dq=s.dq, pre_dv=s.dv, pre_deps=s.deps, pre_J=s.J,
        pre_L=pre_L, pre_dt=s.sum_dt, pre_ba=s.ba, pre_bg=s.bg,
        pre_rho=s.rho, interval_valid=valid,
        f_start=torch.as_tensor(feats["start"], device=dev),
        f_pts=f(feats["pts"]), f_pts_r=f(feats["pts_r"]),
        f_vel=f(feats["vel"]), f_vel_r=f(feats["vel_r"]), f_td=f(feats["td"]),
        f_obs=b(feats["obs"]), f_stereo=b(feats["stereo"]),
        f_valid=b(feats["valid"]),
        prior_J=torch.zeros((fac.D_DENSE, fac.D_DENSE), dtype=dtype,
                            device=dev),
        prior_r=torch.zeros((fac.D_DENSE,), dtype=dtype, device=dev),
        prior_valid=torch.zeros((), dtype=torch.bool, device=dev),
        prior_lin=prior_lin._replace(depth=torch.zeros_like(prior_lin.depth)),
        free_mask=b(free_mask), gravity=f(gravity),
        calib_w=torch.zeros((13,), dtype=dtype, device=dev),
        calib_tic=torch.zeros((2, 3), dtype=dtype, device=dev),
        calib_qic=lie.quat_identity(dtype, device=dev).repeat(2, 1),
        calib_td=torch.zeros((), dtype=dtype, device=dev),
    )
