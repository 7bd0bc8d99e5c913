"""Closed-form quadruped leg kinematics and derivatives (frozen copy
of `cerberus_tpu_torch/kinematics/leg.py`).

Kinematic chain of one leg (3 DoF), foot position in the robot body frame:

    q = (q0, q1, q2) = (hip roll about +x, hip pitch about +y, knee pitch about +y)
    rho_opt = (lc,)  — calf (lower-leg) length, the online-calibrated parameter
    rho_fix = (ox, oy, d, lu) — body offsets x/y, hip motor offset, thigh length

    p_bf(q) = [ox, oy, 0] + Rx(q0) @ ( [0, d, 0] + [-lu*sin(q1), 0, -lu*cos(q1)]
                                        + [-lc*sin(q1+q2), 0, -lc*cos(q1+q2)] )

Every derivative (jac = d fk/dq, dfk_drho, dJ_dq, dJ_drho) is a
`torch.func.jacfwd` of `leg_fk`, as the JAX package takes them with
`jax.jacfwd`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def leg_fk(q, rho_opt, rho_fix):
    """Foot position in body frame. q: (..., 3), rho_opt: (..., 1), rho_fix: (..., 4)."""
    ox, oy, d, lu = rho_fix[..., 0], rho_fix[..., 1], rho_fix[..., 2], rho_fix[..., 3]
    lc = rho_opt[..., 0]
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s12, c12 = torch.sin(q1 + q2), torch.cos(q1 + q2)
    s0, c0 = torch.sin(q0), torch.cos(q0)
    # sagittal-plane foot position relative to hip pitch axis (pre hip-roll)
    px = -lu * s1 - lc * s12
    pz = -(lu * c1 + lc * c12)
    # apply hip roll Rx(q0) to (px, d, pz): x invariant
    return torch.stack([ox + px, oy + d * c0 - pz * s0, d * s0 + pz * c0],
                       dim=-1)


leg_jac = jacfwd(leg_fk, argnums=0)          # (3, 3) d fk / d q
leg_dfk_drho = jacfwd(leg_fk, argnums=1)     # (3, 1) d fk / d rho_opt


def _jac_flat(q, rho_opt, rho_fix):
    # column-major flatten to match the reference's 9-vector layout
    # (Eigen default storage, A1Kinematics.cpp:69-107): element k = J[k%3, k//3]
    return leg_jac(q, rho_opt, rho_fix).T.reshape(-1)


leg_dJ_dq = jacfwd(_jac_flat, argnums=0)     # (9, 3)
leg_dJ_drho = jacfwd(_jac_flat, argnums=1)   # (9, 1)


def _bundle(q, rho_opt, rho_fix):
    return (leg_jac(q, rho_opt, rho_fix), leg_dfk_drho(q, rho_opt, rho_fix),
            leg_dJ_dq(q, rho_opt, rho_fix), leg_dJ_drho(q, rho_opt, rho_fix))


def all_legs_fk_jac(phi, rho, rho_fix):
    """Vectorized FK bundle over legs (and any leading batch dims).

    Args:
      phi: (..., NUM_OF_LEG, 3) joint angles.
      rho: (..., NUM_OF_LEG, RHO_OPT_SIZE) optimized params.
      rho_fix: (NUM_OF_LEG, RHO_FIX_SIZE) or broadcastable.

    Returns dict with fk (...,L,3), J (...,L,3,3), dfk_drho (...,L,3,R),
    dJ_dq (...,L,9,3), dJ_drho (...,L,9,R).
    """
    lead = torch.broadcast_shapes(phi.shape[:-1], rho.shape[:-1],
                                  rho_fix.shape[:-1])
    q = phi.expand(lead + phi.shape[-1:]).reshape(-1, phi.shape[-1])
    r = rho.expand(lead + rho.shape[-1:]).reshape(-1, rho.shape[-1])
    f = rho_fix.expand(lead + rho_fix.shape[-1:]).reshape(-1, rho_fix.shape[-1])
    J, dfk, dJq, dJr = vmap(_bundle)(q, r, f)
    R = rho.shape[-1]
    return {
        "fk": leg_fk(phi, rho, rho_fix),
        "J": J.reshape(lead + (3, 3)),
        "dfk_drho": dfk.reshape(lead + (3, R)),
        "dJ_dq": dJq.reshape(lead + (9, 3)),
        "dJ_drho": dJr.reshape(lead + (9, R)),
    }
