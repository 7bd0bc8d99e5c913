"""Build a complete WindowData + ground-truth WindowState from simulator
output (port of `cerberus_tpu/data/window_builder.py`): preintegrates the
keyframe intervals and packs feature tracks with true inverse depths. Used
by `chip_smoke.py` and the tests (the perfect-association path that
bypasses the online feature manager)."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.device import matmul_precision, resolve_device
from cerberus_tpu_torch.estimator.packing import (default_free_mask,
                                                  pack_window_data)
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.preintegration import PreintParams, il_preintegrate


def build_window_from_sim(sim, cfg: EstimatorConfig | None = None,
                          kf_stride=3, start_cam=6, F=C.MAX_FEATURES,
                          dtype=torch.float64, device="cuda"):
    """Returns (WindowData, truth WindowState, n_active_features), with every
    tensor on `device` (the card unless the caller names another)."""
    dev = resolve_device(device)
    cfg = cfg or EstimatorConfig()
    params = PreintParams.from_config(cfg, dtype, device=dev)
    kf_cam = [start_cam + k * kf_stride for k in range(C.NUM_FRAMES)]
    kf_imu = [sim["cam_idx"][i] for i in kf_cam]
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    preints = []
    with matmul_precision("highest"):
        for k in range(10):
            s, e = kf_imu[k], kf_imu[k + 1]
            sl = slice(s, e + 1)
            n = e - s + 1
            mask = np.ones(n, bool)
            mask[0] = False
            pre = il_preintegrate(
                f(np.full(n, 1.0 / 500.0)), f(sim["acc"][sl]),
                f(sim["gyr"][sl]), f(sim["phi"][sl]), f(sim["dphi"][sl]),
                f(sim["contacts"][sl]), torch.as_tensor(mask, device=dev),
                f(np.zeros(3)), f(np.zeros(3)),
                f(np.full((4,), cfg.robot.lower_leg_length)), params)
            preints.append(pre)

    obs_by_lm = {}
    for fi, ci in enumerate(kf_cam):
        for lid, (o0, v0, o1, v1) in sim["features"][ci].items():
            obs_by_lm.setdefault(lid, {})[fi] = (o0, v0, o1, v1)
    lids = [l for l, obs in obs_by_lm.items() if len(obs) >= 4][:F]
    Fa = len(lids)
    feats = dict(
        start=np.zeros(Fa, np.int32), pts=np.zeros((Fa, 11, 3)),
        pts_r=np.zeros((Fa, 11, 3)), vel=np.zeros((Fa, 11, 2)),
        vel_r=np.zeros((Fa, 11, 2)), td=np.zeros((Fa, 11)),
        obs=np.zeros((Fa, 11), bool), stereo=np.zeros((Fa, 11), bool),
        valid=np.ones(Fa, bool),
    )
    true_depth = np.zeros(Fa)
    ric, tic = cfg.ric_tic()
    for n, lid in enumerate(lids):
        frames = sorted(obs_by_lm[lid].keys())
        feats["start"][n] = frames[0]
        for fi in frames:
            o0, v0, o1, v1 = obs_by_lm[lid][fi]
            feats["pts"][n, fi] = o0
            feats["vel"][n, fi] = v0
            feats["obs"][n, fi] = True
            if o1 is not None:
                feats["pts_r"][n, fi] = o1
                feats["vel_r"][n, fi] = v1
                feats["stereo"][n, fi] = True
        k_anchor = kf_imu[frames[0]]
        Rw = sim["R"][k_anchor] @ ric[0]
        tw = sim["R"][k_anchor] @ tic[0] + sim["p"][k_anchor]
        z = (Rw.T @ (sim["landmarks"][lid] - tw))[2]
        true_depth[n] = 1.0 / z

    data = pack_window_data(preints, feats, F=F,
                            gravity=(0, 0, cfg.g_norm),
                            free_mask=default_free_mask(optimize_leg_bias=True))

    depth_full = np.ones(F)
    depth_full[:Fa] = true_depth
    qic = np.stack([np.roll(Rotation.from_matrix(ric[i]).as_quat(), 1)
                    for i in range(2)])
    truth = fac.WindowState(
        p=f(sim["p"][kf_imu]), q=f(sim["q"][kf_imu]), v=f(sim["v"][kf_imu]),
        ba=f(np.tile(sim["acc_bias"], (11, 1))),
        bg=f(np.tile(sim["gyr_bias"], (11, 1))),
        rho=f(np.full((11, 4), cfg.robot.lower_leg_length)),
        tic=f(tic), qic=f(qic), td=f(0.0), depth=f(depth_full),
    )
    return data, truth, Fa
