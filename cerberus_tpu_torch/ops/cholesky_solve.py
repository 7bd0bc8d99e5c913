"""Batched damped SPD solve x = -(H + diag(lam diag(H) + 1e-12))^-1 b.

Port of `cerberus_tpu/ops/pallas_kernels.py::cholesky_solve`. The damping is
not Jacobi-equilibrated (unlike `ops/solver._damped_solve_schur`), exactly
as in the JAX function. On a CUDA tensor `cholesky_solve` launches the
hand-written kernel `csrc/cholesky_solve.cu` (f32, the type the TPU
kernel's tests use; one thread block per system, a blocked factor in tiles,
in shared memory up to n = 320 and streamed from a global workspace above,
so any n; the source says what bounds it). On a CPU tensor it runs
`cholesky_solve_plain`, the same function in plain torch ops. There is no
fallback from the card to the plain version: a CUDA tensor the kernel does
not take raises.

No path of the port calls it, as no path of the JAX package calls the TPU
kernel; `LAUNCHES` counts its launches all the same.
"""

from __future__ import annotations

import ctypes

import torch

from cerberus_tpu_torch import _build
from cerberus_tpu_torch.ops.lane_cholesky import (lane_cholesky_solve_plain,
                                                  launch_args)

LAUNCHES = 0

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("cholesky_solve")
        fn = lib.damped_cholesky_solve_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.damped_cholesky_error_string.argtypes = [ctypes.c_int]
        lib.damped_cholesky_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _lam_vector(lam, H: torch.Tensor) -> torch.Tensor:
    """lam as a (B,) tensor of H's dtype and device (a scalar broadcasts)."""
    lam = torch.as_tensor(lam, dtype=H.dtype, device=H.device)
    return lam.expand(H.shape[0]).contiguous() if lam.ndim == 0 else lam


def cholesky_solve(H: torch.Tensor, b: torch.Tensor, lam) -> torch.Tensor:
    """x = -(H + diag(lam diag(H) + 1e-12))^-1 b for B SPD systems.

    H: (B, n, n), b: (B, n), lam: (B,) or a scalar. CUDA tensors: f32,
    contiguous, any n whose two vectors fit a block's shared memory
    (`lane_cholesky.tile_plan`); the kernel is launched on the current
    stream without synchronising. CPU tensors: any float dtype, through
    the plain version."""
    if H.ndim != 3 or H.shape[1] != H.shape[2] or tuple(b.shape) != tuple(H.shape[:2]):
        raise ValueError(f"want H (B, n, n) and b (B, n), got {tuple(H.shape)} "
                         f"and {tuple(b.shape)}")
    if H.device != b.device:
        raise ValueError(f"H on {H.device} but b on {b.device}")
    lam = _lam_vector(lam, H)
    if tuple(lam.shape) != (H.shape[0],):
        raise ValueError(f"want lam (B,) or a scalar, got {tuple(lam.shape)}")
    if H.device.type == "cpu":
        return cholesky_solve_plain(H, b, lam)
    if H.device.type != "cuda":
        raise ValueError(f"no kernel for device {H.device}")
    if H.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 H and b, got {H.dtype} "
                        f"and {b.dtype}")
    if not (H.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous H and b")
    Bn, n = b.shape
    work, plan = launch_args(n, H.dtype, Bn, H.device)
    x = torch.empty_like(b)
    lib = _library()
    err = lib.damped_cholesky_solve_f32(
        H.data_ptr(), b.data_ptr(), lam.data_ptr(), x.data_ptr(),
        None if work is None else work.data_ptr(), Bn, n, *plan,
        H.device.index,
        torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cholesky_solve launch failed: "
                           + lib.damped_cholesky_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return x


def damp(H: torch.Tensor, lam) -> torch.Tensor:
    """H + diag(lam diag(H) + 1e-12), the system the kernel factors."""
    lam = _lam_vector(lam, H)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam[:, None] * d + 1e-12)


def cholesky_solve_plain(H: torch.Tensor, b: torch.Tensor, lam) -> torch.Tensor:
    """The kernel's function in plain torch ops: the damping, then the
    port's own column Cholesky solve (`lane_cholesky_solve_plain`) of
    -b. Independent of `torch.linalg`."""
    return lane_cholesky_solve_plain(damp(H, lam), -b)
