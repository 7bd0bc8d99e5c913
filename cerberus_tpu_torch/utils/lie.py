"""Quaternion / SO(3) utilities on torch tensors.

Port of `cerberus_tpu/utils/lie.py`: the same formulas, term for term, so the
two agree to roundoff. Quaternions are (..., 4) tensors in **wxyz** order
(scalar first). Every function broadcasts over leading dimensions, makes its
constants on the input's device and dtype, and uses no in-place op, so it runs
unchanged under `torch.func.vmap` and `torch.func.jacfwd`.
"""

from __future__ import annotations

import math

import torch


def quat_identity(dtype=torch.float64, *, device):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def cross(a, b):
    """a x b over the last axis (written out so it broadcasts like jnp.cross)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both (..., 4) wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by unit quaternion(s) q (..., 4)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_to_rot(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Shepperd's branchless method (max-trace selection)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidate constructions, each valid where its pivot is largest
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cases = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(cases, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(qs, -2, idx)[..., 0, :]
    # canonical sign: w >= 0
    return quat_normalize(q * torch.sign(q[..., :1] + 1e-30))


def delta_q(theta):
    """Small-angle rotation vector (..., 3) -> unit quaternion (..., 4).

    First-order form q = normalize([1, theta/2]) matching the reference's
    Utility::deltaQ (utility.h:28-38)."""
    half = theta / 2.0
    w = torch.ones_like(half[..., :1])
    return quat_normalize(torch.cat([w, half], dim=-1))


def so3_exp_quat(theta):
    """Exact exponential map: rotation vector (..., 3) -> quaternion (..., 4)."""
    angle = torch.linalg.vector_norm(theta, dim=-1, keepdim=True)
    half = angle / 2.0
    small = angle < 1e-8
    sinc = torch.where(small, 0.5 - angle**2 / 48.0,
                       torch.sin(half) / torch.clamp(angle, min=1e-30))
    w = torch.cos(half)
    return torch.cat([w, sinc * theta], dim=-1)


def quat_log(q):
    """Unit quaternion (..., 4) -> rotation vector (..., 3)."""
    q = q * torch.sign(q[..., :1] + 1e-30)  # w >= 0 branch
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-12, 2.0 / torch.clamp(w, min=1e-12),
                        angle / torch.clamp(vn, min=1e-30))
    return scale * q[..., 1:]


def skew(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def _eye3(q):
    return torch.eye(3, dtype=q.dtype, device=q.device)


def quat_left(q):
    """Left-multiplication matrix: quat_mul(q, p) == quat_left(q) @ p."""
    w = q[..., 0]
    v = q[..., 1:]
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom = torch.cat(
        [v[..., None], w[..., None, None] * _eye3(q) + skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_right(p):
    """Right-multiplication matrix: quat_mul(q, p) == quat_right(p) @ q."""
    w = p[..., 0]
    v = p[..., 1:]
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom = torch.cat(
        [v[..., None], w[..., None, None] * _eye3(p) - skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def rot_to_ypr(R):
    """Rotation matrix -> yaw/pitch/roll in degrees (reference: Utility::R2ypr)."""
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) / math.pi * 180.0


def _stack33(entries, shape):
    return torch.stack(entries, dim=-1).reshape(shape + (3, 3))


def ypr_to_rot(ypr_deg):
    """yaw/pitch/roll degrees (..., 3) -> rotation matrix (reference: Utility::ypr2R)."""
    y, p, r = (ypr_deg[..., i] / 180.0 * math.pi for i in range(3))
    cy, sy, cp, sp = torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero, one = torch.zeros_like(y), torch.ones_like(y)
    Rz = _stack33([cy, -sy, zero, sy, cy, zero, zero, zero, one], y.shape)
    Ry = _stack33([cp, zero, sp, zero, one, zero, -sp, zero, cp], y.shape)
    Rx = _stack33([one, zero, zero, zero, cr, -sr, zero, sr, cr], y.shape)
    return Rz @ Ry @ Rx


def g_to_rot(g):
    """Gravity-aligning rotation with zeroed yaw (reference: Utility::g2R).

    Returns R0 such that R0 @ normalize(g) == [0, 0, 1] and yaw(R0) == 0.
    """
    ng1 = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    # rotation taking ng1 to ng2
    v = cross(ng1, ng2.expand_as(ng1))
    c = torch.sum(ng1 * ng2, dim=-1)
    s = torch.linalg.vector_norm(v, dim=-1)
    axis = v / torch.clamp(s, min=1e-12)[..., None]
    angle = torch.atan2(s, c)
    R0 = quat_to_rot(so3_exp_quat(axis * angle[..., None]))
    yaw = rot_to_ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    return ypr_to_rot(torch.stack([-yaw, zero, zero], dim=-1)) @ R0


def rot_x(a):
    """Rotation about x by angle a (...,) -> (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return _stack33([one, zero, zero, zero, c, -s, zero, s, c], a.shape)


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return _stack33([c, zero, s, zero, one, zero, -s, zero, c], a.shape)


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return _stack33([c, -s, zero, s, c, zero, zero, zero, one], a.shape)
