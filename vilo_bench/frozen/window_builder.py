"""Window problems from simulator output (frozen copy of
`cerberus_tpu_torch/data/window_builder.py`, with the log-depth form of the
preintegration): preintegrates the keyframe intervals and packs feature
tracks with true inverse depths.

Runs in float64 on the device it is given (the CPU of a worker process,
in a run), whatever the configuration serves: the harness casts the
windows to the served type."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from vilo_bench.frozen import config as C
from vilo_bench.frozen import factors as fac
from vilo_bench.frozen.config import EstimatorConfig
from vilo_bench.frozen.packing import default_free_mask, pack_window_data
from vilo_bench.frozen.preintegration import (PreintParams,
                                              il_preintegrate_parallel)

DTYPE = torch.float64


def keyframe_imu_indices(sim, kf_stride: int, start_cam: int) -> list:
    """IMU sample index of each of the window's 11 keyframes."""
    kf_cam = [start_cam + k * kf_stride for k in range(C.NUM_FRAMES)]
    return [int(sim["cam_idx"][i]) for i in kf_cam]


def _interval_inputs(sim, kf_imu, cfg: EstimatorConfig, imu_dt: float,
                     device):
    """The arguments of each of the 10 intervals' preintegration."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=DTYPE, device=device)
    rows = []
    for k in range(C.NUM_FRAMES - 1):
        s, e = kf_imu[k], kf_imu[k + 1]
        sl = slice(s, e + 1)
        n = e - s + 1
        mask = np.ones(n, bool)
        mask[0] = False
        rows.append((
            f(np.full(n, imu_dt)), f(sim["acc"][sl]), f(sim["gyr"][sl]),
            f(sim["phi"][sl]), f(sim["dphi"][sl]), f(sim["contacts"][sl]),
            torch.as_tensor(mask, device=device), f(np.zeros(3)), f(np.zeros(3)),
            f(np.full((4,), cfg.robot.lower_leg_length))))
    return rows


def _features(sim, kf_imu, kf_cam, F: int, cfg: EstimatorConfig):
    """Tracks seen in 4 or more keyframes (the first F), and the true
    inverse depth of each in its anchor frame."""
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
    return feats, true_depth


def build_window(sim, kf_stride: int, start_cam: int, cfg: EstimatorConfig,
                 F: int, imu_dt: float, optimize_leg_bias: bool,
                 device="cpu"):
    """The window problem of one simulated segment, in float64 on `device`.

    Returns (WindowData, truth WindowState) and the number of valid
    feature slots."""
    kf_imu = keyframe_imu_indices(sim, kf_stride, start_cam)
    kf_cam = [start_cam + k * kf_stride for k in range(C.NUM_FRAMES)]
    params = PreintParams.from_config(cfg, DTYPE, device=device)
    ric, tic = cfg.ric_tic()
    qic = np.stack([np.roll(Rotation.from_matrix(ric[i]).as_quat(), 1)
                    for i in range(2)])
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=DTYPE, device=device)
    preints = [il_preintegrate_parallel(*a, params)
               for a in _interval_inputs(sim, kf_imu, cfg, imu_dt, device)]
    feats, true_depth = _features(sim, kf_imu, kf_cam, F, cfg)
    Fa = len(true_depth)
    data = pack_window_data(
        preints, feats, F=F, gravity=(0, 0, cfg.g_norm),
        free_mask=default_free_mask(optimize_leg_bias=optimize_leg_bias))
    depth_full = np.ones(F)
    depth_full[:Fa] = true_depth
    truth = fac.WindowState(
        p=f(sim["p"][kf_imu]), q=f(sim["q"][kf_imu]),
        v=f(sim["v"][kf_imu]),
        ba=f(np.tile(sim["acc_bias"], (11, 1))),
        bg=f(np.tile(sim["gyr_bias"], (11, 1))),
        rho=f(np.full((11, 4), cfg.robot.lower_leg_length)),
        tic=f(tic), qic=f(qic), td=f(0.0), depth=f(depth_full),
    )
    return data, truth, Fa
