"""Gauge basis of the window (port of the part of
`cerberus_tpu/ops/marginalize.py` that the window solve needs).

Only `frame_indices` and `_gauge_null_basis` are ported; the QR/eigen
marginalization (`marginalize_old`, `marginalize_second_new`, `_schur_drop`,
`_prior_from_Hb`) waits for the streaming estimator's slice.
"""

from __future__ import annotations

import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.utils import lie

NF = C.NUM_FRAMES


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
