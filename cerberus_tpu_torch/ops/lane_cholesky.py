"""Batched Cholesky solve x = A^-1 b of B independent SPD systems.

Port of `cerberus_tpu/ops/lane_cholesky.py::lane_cholesky_solve`. On a CUDA
tensor `lane_cholesky_solve` launches the hand-written kernel
`csrc/lane_cholesky.cu` (f32 or f64, one thread block per system, the factor
resident in shared memory; the source says what bounds it). On a CPU tensor
it runs `lane_cholesky_solve_plain`, the same function in plain torch ops.
There is no fallback from the card to the plain version: a CUDA tensor the
kernel does not take raises.

`LAUNCHES` counts the kernel's launches and `LAUNCHES_BY_DTYPE` splits them
by dtype, so a run can show that its solves went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from cerberus_tpu_torch import _build

LAUNCHES = 0
LAUNCHES_BY_DTYPE = {torch.float32: 0, torch.float64: 0}

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90

_ENTRY = {torch.float32: "lane_cholesky_solve_f32",
          torch.float64: "lane_cholesky_solve_f64"}


def smem_bytes(n: int, dtype=torch.float32) -> int:
    """Shared memory the kernel's block needs for an n x n system: the whole
    matrix in f32 (n <= 240), the packed lower triangle in f64 (n <= 238)."""
    if dtype == torch.float64:
        return (n * (n + 1) // 2 + 2 * n) * 8
    return (n * n + 2 * n) * 4


_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("lane_cholesky")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lane_cholesky_error_string.argtypes = [ctypes.c_int]
        lib.lane_cholesky_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def lane_cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a batch of SPD systems. A: (B, n, n), b: (B, n).

    CUDA tensors: f32 or f64 (both the same), contiguous, n with
    smem_bytes(n, dtype) <= SMEM_LIMIT (n <= 240 in f32, n <= 238 in f64);
    the kernel is launched on the current stream without synchronising.
    CPU tensors: any float dtype, through the plain version."""
    if A.ndim != 3 or A.shape[1] != A.shape[2] or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"want A (B, n, n) and b (B, n), got {tuple(A.shape)} "
                         f"and {tuple(b.shape)}")
    if A.device != b.device:
        raise ValueError(f"A on {A.device} but b on {b.device}")
    if A.device.type == "cpu":
        return lane_cholesky_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    if A.dtype not in _ENTRY or b.dtype != A.dtype:
        raise TypeError(f"the kernel takes float32 or float64 A and b of one "
                        f"dtype, got {A.dtype} and {b.dtype}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous A and b")
    Bn, n = b.shape
    if smem_bytes(n, A.dtype) > SMEM_LIMIT:
        raise ValueError(f"n = {n} needs {smem_bytes(n, A.dtype)} B of shared "
                         f"memory in {A.dtype}, more than the {SMEM_LIMIT} B "
                         f"a block may use")
    x = torch.empty_like(b)
    lib = _library()
    err = getattr(lib, _ENTRY[A.dtype])(
        A.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, n, A.device.index,
        torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lane_cholesky_solve launch failed: "
                           + lib.lane_cholesky_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[A.dtype] += 1
    return x


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of A (..., n, n), column by column
    (left-looking: column j = (A[j:, j] - L[j:, :j] L[j, :j]) / L[j, j]).
    A non-SPD matrix gives NaN, as LAPACK's factor does in JAX."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        d = torch.sqrt(s[..., 0])
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return L


def lane_cholesky_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops: `cholesky_plain`, then
    forward substitution L y = b and back substitution L^T x = y, one
    unknown at a time. Independent of `torch.linalg`, so it can hold the
    kernel to account."""
    L = cholesky_plain(A)
    n = A.shape[-1]
    y = torch.zeros_like(b)
    for j in range(n):
        y[..., j] = (b[..., j] - (L[..., j, :j] * y[..., :j]).sum(-1)) \
            / L[..., j, j]
    x = torch.zeros_like(b)
    for j in reversed(range(n)):
        x[..., j] = (y[..., j] - (L[..., j + 1:, j] * x[..., j + 1:]).sum(-1)) \
            / L[..., j, j]
    return x
