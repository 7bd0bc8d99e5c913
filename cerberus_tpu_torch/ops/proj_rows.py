"""Projection residuals and their local Jacobians of every (feature slot,
frame) pair of a window: the rows that `ops/structured.py` assembles the
projection part of the normal equations from.

`proj_rows(st, data)` returns r (F, 11, 4) and J (F, 11, 4, 26) of one
window, the Huber step not yet applied: per pair the residuals [mono x, y |
stereo x, y] and their derivatives with respect to the pair's 26-dim local
tangent [pose_anchor(6), pose_j(6), ex0(6), ex1(6), inverse depth(1),
td(1)]. It goes through the custom op `cerberus_tpu_torch::proj_rows`,
which takes a leading batch axis and has a vmap rule, so that under
`torch.func.vmap` (the LM loop's assembly of a batch) one call covers the
whole batch:

- on CUDA tensors the op launches the hand-written kernel
  `csrc/proj_rows.cu` (f32 or f64), once for the batch, or raises on what
  the kernel does not take; the source says what bounds it;
- on CPU tensors the op runs `proj_rows_plain`, the same function through
  `torch.func.jacrev` (the JAX package's route), vmapped over the batch.

There is no fallback from the card to the plain version.

`LAUNCHES` counts the kernel's launches by (dtype, B, F). Under a
profiler each launch also adds its B x F x 11 pairs to the counter
`proj.kernel_pairs` (`utils/profiling.count`), and the kernel itself adds
the pairs that read their values, those with a camera's mask on, to the
counter `proj.kernel_read_pairs` (`utils/profiling.accumulator`, on the
device): what a reader needs to count the bytes the launches moved.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch import Tensor
from torch.func import jacrev, vmap

from cerberus_tpu_torch import _build
from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.utils import lie, profiling

NF = C.NUM_FRAMES
# per projection pair local tangent: [pose_i(6), pose_j(6), ex0(6), ex1(6),
# depth(1), td(1)]
PROJ_TAN = 26

LAUNCHES = collections.Counter()   # (dtype, B, F) -> launches

_ENTRY = {torch.float32: "proj_rows_f32", torch.float64: "proj_rows_f64"}
# the op's arguments, in its order (and the kernel's)
_ARGS = ("p", "q", "tic", "qic", "td", "depth", "f_start", "f_pts", "f_pts_r",
         "f_vel", "f_vel_r", "f_td", "f_obs", "f_stereo", "f_valid")


def _inputs(st: fac.WindowState, data: fac.WindowData) -> tuple:
    """The op's arguments of one window, in its order."""
    return (st.p, st.q, st.tic, st.qic, st.td, st.depth, data.f_start,
            data.f_pts, data.f_pts_r, data.f_vel, data.f_vel_r, data.f_td,
            data.f_obs, data.f_stereo, data.f_valid)


def proj_rows(st: fac.WindowState, data: fac.WindowData):
    """r (F, 11, 4) and J (F, 11, 4, 26) of one window (or of each window,
    under `torch.func.vmap`): the kernel on CUDA tensors, `proj_rows_plain`
    on CPU tensors."""
    r, J = proj_rows_op(*(x[None] for x in _inputs(st, data)))
    return r[0], J[0]


def proj_rows_plain(p, q, tic, qic, td, depth, f_start, f_pts, f_pts_r,
                    f_vel, f_vel_r, f_td, f_obs, f_stereo, f_valid):
    """One window's r (F, 11, 4) and J (F, 11, 4, 26) by `torch.func.jacrev`
    of the residual under a 26-dim local perturbation, vmapped over the
    slots and frames."""
    dtype, dev = p.dtype, p.device
    zero26 = torch.zeros((PROJ_TAN,), dtype=dtype, device=dev)
    frames = torch.arange(NF, device=dev)
    z1 = torch.zeros(1, dtype=dtype, device=dev)

    def per_feature(f_pts, f_pts_r, f_vel, f_vel_r, f_td, f_obs, f_stereo,
                    f_valid, start, depth_f):
        Ei = (frames == start).to(dtype)                   # (11,) one-hot
        pts_i0 = Ei @ f_pts
        vel_i0 = Ei @ f_vel
        td_i0 = Ei @ f_td
        obs_i = (Ei @ f_obs.to(dtype)) > 0.5
        p_i0 = Ei @ p
        q_i0 = Ei @ q                                      # exact row select

        def per_frame(j, pts_j0, vel_j0, td_j0, p_j0, q_j0, obs_j, stereo_j,
                      pts_jr0, vel_jr0):
            def res26(delta):
                p_i, q_i = fac.retract_pose(p_i0, q_i0, delta[0:6])
                p_j, q_j = fac.retract_pose(p_j0, q_j0, delta[6:12])
                tic0, qic0 = fac.retract_pose(tic[0], qic[0], delta[12:18])
                tic1, qic1 = fac.retract_pose(tic[1], qic[1], delta[18:24])
                inv_dep = depth_f + delta[24]
                td_ = td + delta[25]
                pts_i_td = pts_i0 - (td_ - td_i0) * torch.cat([vel_i0, z1])
                pts_j_td = pts_j0 - (td_ - td_j0) * torch.cat([vel_j0, z1])
                pts_cam_i = pts_i_td / inv_dep
                pts_imu_i = lie.quat_rotate(qic0, pts_cam_i) + tic0
                pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
                pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
                pts_cam_j = lie.quat_rotate(lie.quat_conj(qic0),
                                            pts_imu_j - tic0)
                zj = pts_cam_j[2]
                zj = torch.where(torch.abs(zj) < 1e-6,
                                 torch.full_like(zj, 1e-6), zj)
                r_mono = fac.PROJ_SQRT_INFO * (pts_cam_j[:2] / zj
                                               - pts_j_td[:2])
                mono_ok = obs_j & obs_i & (j != start) & f_valid
                r_mono = fac._zero_where(mono_ok, r_mono)
                pts_jr_td = pts_jr0 - (td_ - td_j0) * torch.cat([vel_jr0, z1])
                pts_cam_jr = lie.quat_rotate(lie.quat_conj(qic1),
                                             pts_imu_j - tic1)
                zr = pts_cam_jr[2]
                zr = torch.where(torch.abs(zr) < 1e-6,
                                 torch.full_like(zr, 1e-6), zr)
                r_st = fac.PROJ_SQRT_INFO * (pts_cam_jr[:2] / zr
                                             - pts_jr_td[:2])
                st_ok = stereo_j & obs_i & f_valid
                r_st = fac._zero_where(st_ok, r_st)
                return torch.cat([r_mono, r_st])

            # reverse mode: 4 output cotangents instead of 26 input tangents
            J, r = jacrev(fac.with_value(res26), has_aux=True)(zero26)
            return r, J

        return vmap(per_frame)(frames, f_pts, f_vel, f_td, p, q, f_obs,
                               f_stereo, f_pts_r, f_vel_r)

    return vmap(per_feature)(f_pts, f_pts_r, f_vel, f_vel_r, f_td, f_obs,
                             f_stereo, f_valid, f_start, depth)


@torch.library.custom_op("cerberus_tpu_torch::proj_rows", mutates_args=(),
                         device_types="cpu")
def proj_rows_op(p: Tensor, q: Tensor, tic: Tensor, qic: Tensor, td: Tensor,
                 depth: Tensor, f_start: Tensor, f_pts: Tensor,
                 f_pts_r: Tensor, f_vel: Tensor, f_vel_r: Tensor,
                 f_td: Tensor, f_obs: Tensor, f_stereo: Tensor,
                 f_valid: Tensor) -> tuple[Tensor, Tensor]:
    """r (B, F, 11, 4) and J (B, F, 11, 4, 26) of B windows, every
    argument with a leading batch axis (`_inputs` of each window); on the
    CPU the plain version, vmapped over the batch."""
    return vmap(proj_rows_plain)(p, q, tic, qic, td, depth, f_start, f_pts,
                                 f_pts_r, f_vel, f_vel_r, f_td, f_obs,
                                 f_stereo, f_valid)


@proj_rows_op.register_vmap
def _proj_rows_vmap(info, in_dims, *args):
    """A vmapped call is one call over the vmapped axis and the op's own
    batch axis together (an argument vmap does not map is repeated)."""
    n = info.batch_size
    flat = []
    for x, d in zip(args, in_dims):
        x = x.expand((n,) + x.shape) if d is None else x.movedim(d, 0)
        flat.append(x.reshape((-1,) + x.shape[2:]))
    r, J = proj_rows_op(*flat)
    return (r.reshape((n, -1) + r.shape[1:]),
            J.reshape((n, -1) + J.shape[1:])), (0, 0)


_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("proj_rows")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_double] \
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.proj_rows_error_string.argtypes = [ctypes.c_int]
        lib.proj_rows_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@proj_rows_op.register_kernel("cuda")
def _proj_rows_cuda(p, q, tic, qic, td, depth, f_start, f_pts, f_pts_r,
                    f_vel, f_vel_r, f_td, f_obs, f_stereo, f_valid):
    """One launch of csrc/proj_rows.cu over the batch, on the current
    stream, without synchronising; raises on what the kernel does not
    take."""
    dtype = p.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    if depth.ndim != 2:
        raise ValueError(f"depth: want (B, F), got {tuple(depth.shape)}")
    B, F = depth.shape
    args = (p, q, tic, qic, td, depth, f_start, f_pts, f_pts_r, f_vel,
            f_vel_r, f_td, f_obs, f_stereo, f_valid)
    shapes = ((B, NF, 3), (B, NF, 4), (B, 2, 3), (B, 2, 4), (B,), (B, F),
              (B, F), (B, F, NF, 3), (B, F, NF, 3), (B, F, NF, 2),
              (B, F, NF, 2), (B, F, NF), (B, F, NF), (B, F, NF), (B, F))
    types = (dtype,) * 6 + (torch.int32,) + (dtype,) * 5 + (torch.bool,) * 3
    for name, x, shape, t in zip(_ARGS, args, shapes, types):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != t:
            raise TypeError(f"{name}: want {t}, got {x.dtype}")
        if x.device != p.device:
            raise ValueError(f"{name} on {x.device} but p on {p.device}")
    args = [x.contiguous() for x in args]
    r = torch.empty((B, F, NF, 4), dtype=dtype, device=p.device)
    J = torch.empty((B, F, NF, 4, PROJ_TAN), dtype=dtype, device=p.device)
    if B * F == 0:
        return r, J
    lib = _library()
    reads = profiling.accumulator("proj.kernel_read_pairs", p.device)
    err = getattr(lib, _ENTRY[dtype])(
        *(x.data_ptr() for x in args), fac.PROJ_SQRT_INFO, r.data_ptr(),
        J.data_ptr(), None if reads is None else reads.data_ptr(), B, F,
        p.device.index, torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("proj_rows launch failed: "
                           + lib.proj_rows_error_string(err).decode())
    LAUNCHES[(dtype, B, F)] += 1
    profiling.count("proj.kernel_pairs", B * F * NF)
    return r, J
