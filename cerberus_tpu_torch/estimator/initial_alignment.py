"""Initialization alignment solvers, on torch tensors (port of
`cerberus_tpu/estimator/initial_alignment.py`).

API-parity versions of the reference's initializer helpers
(reference: src/initial/initial_aligment.cpp). The estimator's default init
path runs the full window solver with biases free instead; these
closed-form solvers are provided for users of the reference workflow and
as a cheaper warm start. They take the port's `ILPreint` (or any object
with its `J`, `dq` and `deps` fields) and run on `device` (the card unless
the caller names another).
"""

from __future__ import annotations

import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.device import on_device, resolve_device
from cerberus_tpu_torch.utils import lie


def _rot_residual(q_frames, k, pre, dev, dtype):
    """(J_q (3, 3), r_q (3,)) of interval k: the rotation block's bias
    Jacobian and 2 vec(dq^-1 q_k^-1 q_{k+1})."""
    q_ij = lie.quat_mul(lie.quat_conj(q_frames[k]), q_frames[k + 1])
    J = on_device(pre.J, dev, dtype)
    dq = on_device(pre.dq, dev, dtype)
    return (J[3:6, C.ILO_BG:C.ILO_BG + 3],
            2.0 * lie.quat_mul(lie.quat_conj(dq), q_ij)[1:], J)


def solve_gyroscope_bias(q_frames, preints, device="cuda"):
    """Least-squares gyro bias from rotation residuals across consecutive
    frames (reference: solveGyroscopeBias, initial_aligment.cpp:14-48).

    q_frames: (N+1, 4) frame orientations (wxyz, e.g. from vision PnP);
    preints: list of N ILPreint between consecutive frames (None skips
    one). Returns delta_bg (3,)."""
    dev = resolve_device(device)
    q_frames = on_device(q_frames, dev)
    dtype = q_frames.dtype
    A = torch.zeros((3, 3), dtype=dtype, device=dev)
    b = torch.zeros((3,), dtype=dtype, device=dev)
    for k, pre in enumerate(preints):
        if pre is None:
            continue
        tmp_A, tmp_b, _ = _rot_residual(q_frames, k, pre, dev, dtype)
        A = A + tmp_A.T @ tmp_A
        b = b + tmp_A.T @ tmp_b
    return torch.linalg.solve_ex(
        A + 1e-12 * torch.eye(3, dtype=dtype, device=dev), b).result


def solve_gyro_leg_bias(q_frames, p_frames, preints, device="cuda"):
    """Joint gyro-bias + per-leg rho from rotation and epsilon residuals
    (reference: solveGyroLegBias, initial_aligment.cpp:50-123; the reference
    keeps the call commented at estimator.cpp:751 — provided for parity).

    Returns (delta_bg (3,), delta_rho (4,))."""
    dev = resolve_device(device)
    q_frames = on_device(q_frames, dev)
    dtype = q_frames.dtype
    p_frames = on_device(p_frames, dev, dtype)
    A = torch.zeros((7, 7), dtype=dtype, device=dev)
    b = torch.zeros((7,), dtype=dtype, device=dev)
    for k, pre in enumerate(preints):
        if pre is None:
            continue
        Jq, rq, J = _rot_residual(q_frames, k, pre, dev, dtype)
        deps = on_device(pre.deps, dev, dtype)
        Ak = torch.zeros((3 + 12, 7), dtype=dtype, device=dev)
        rk = torch.zeros((3 + 12,), dtype=dtype, device=dev)
        Ak[0:3, 0:3] = Jq
        rk[0:3] = rq
        rel_p = lie.quat_rotate(lie.quat_conj(q_frames[k]),
                                p_frames[k + 1] - p_frames[k])
        for j in range(4):
            r = C.ILO_EPS + 3 * j
            Ak[3 + 3 * j:6 + 3 * j, 0:3] = J[r:r + 3, C.ILO_BG:C.ILO_BG + 3]
            Ak[3 + 3 * j:6 + 3 * j, 3 + j] = J[r:r + 3, C.ILO_RHO + j]
            rk[3 + 3 * j:6 + 3 * j] = rel_p - deps[j]
        A = A + Ak.T @ Ak
        b = b + Ak.T @ rk
    x = torch.linalg.solve_ex(
        A + 1e-9 * torch.eye(7, dtype=dtype, device=dev), b).result
    return x[0:3], x[3:7]
