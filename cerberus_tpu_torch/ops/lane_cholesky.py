"""Batched Cholesky solve x = A^-1 b of B independent SPD systems.

Port of `cerberus_tpu/ops/lane_cholesky.py::lane_cholesky_solve`. On a CUDA
tensor `lane_cholesky_solve` launches the hand-written kernel
`csrc/lane_cholesky.cu` (f32 or f64, one thread block per system, a blocked
factor in tiles; the source says what bounds it). On a CPU tensor it runs
`lane_cholesky_solve_plain`, the same function in plain torch ops. There is
no fallback from the card to the plain version: a CUDA tensor the kernel
does not take raises.

`tile_plan` is the kernels' layout (tile width, padded n, resident or
streamed tiles, shared memory), shared with `ops/cholesky_solve.py`.

`LAUNCHES` counts the kernel's launches and `LAUNCHES_BY_DTYPE` splits them
by dtype, so a run can show that its solves went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cerberus_tpu_torch import _build

LAUNCHES = 0
LAUNCHES_BY_DTYPE = {torch.float32: 0, torch.float64: 0}

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90

_ENTRY = {torch.float32: "lane_cholesky_solve_f32",
          torch.float64: "lane_cholesky_solve_f64"}
# tile width of csrc/blocked_cholesky.cuh per dtype: 32-wide f64 tiles would
# not hold the f64 triangle at n = 222 in shared memory
_NB = {torch.float32: 32, torch.float64: 16}


class TilePlan(NamedTuple):
    """Layout of one system in csrc/blocked_cholesky.cuh."""
    nb: int              # tile width
    n_pad: int           # n rounded up to a multiple of nb
    resident: bool       # all tiles in shared memory, else in a workspace
    panel_in_smem: bool  # streamed: two panels (nt tiles each) in shared memory
    smem_bytes: int      # dynamic shared memory of one block
    work_elems: int      # workspace elements per system (0 when resident)


@functools.lru_cache(maxsize=None)
def tile_plan(n: int, dtype=torch.float32) -> TilePlan:
    """The kernels' layout of an n x n system of `dtype` (f32 or f64): the
    lower triangle as nt(nt+1)/2 tiles of nb x nb, resident in shared memory
    when they fit beside the two nt*nb vectors (right-hand side and the
    diagonal's reciprocals), else streamed from a global workspace with two
    panels (nt tiles each: the one being solved and the next) in shared
    memory when they fit."""
    nb = _NB[dtype]
    es = torch.empty((), dtype=dtype).element_size()
    nt = -(-n // nb)
    tri = nt * (nt + 1) // 2 * nb * nb
    vectors = 2 * nt * nb * es
    if tri * es + vectors <= SMEM_LIMIT:
        return TilePlan(nb, nt * nb, True, False, tri * es + vectors, 0)
    panel = 2 * nt * nb * nb * es
    if panel + vectors <= SMEM_LIMIT:
        return TilePlan(nb, nt * nb, False, True, panel + vectors, tri)
    return TilePlan(nb, nt * nb, False, False, vectors, tri)


def smem_bytes(n: int, dtype=torch.float32) -> int:
    """Shared memory the kernel's block needs for an n x n system."""
    return tile_plan(n, dtype).smem_bytes


def launch_args(n: int, dtype, batch: int, device):
    """(workspace tensor or None, the plan's C arguments) for one launch of
    a kernel of csrc/blocked_cholesky.cuh; raises where even the vectors
    exceed a block's shared memory."""
    plan = tile_plan(n, dtype)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"n = {n} needs {plan.smem_bytes} B of shared memory "
                         f"in {dtype}, more than the {SMEM_LIMIT} B a block "
                         f"may use")
    work = None if plan.resident else torch.empty(
        (batch, plan.work_elems), dtype=dtype, device=device)
    return work, (plan.nb, int(plan.resident), int(plan.panel_in_smem),
                  plan.smem_bytes)


_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("lane_cholesky")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lane_cholesky_error_string.argtypes = [ctypes.c_int]
        lib.lane_cholesky_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def lane_cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a batch of SPD systems. A: (B, n, n), b: (B, n).

    CUDA tensors: f32 or f64 (both the same), contiguous, any n whose two
    vectors fit a block's shared memory (`tile_plan`); the kernel is
    launched on the current stream without synchronising.
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
    work, plan = launch_args(n, A.dtype, Bn, A.device)
    x = torch.empty_like(b)
    lib = _library()
    err = getattr(lib, _ENTRY[A.dtype])(
        A.data_ptr(), b.data_ptr(), x.data_ptr(),
        None if work is None else work.data_ptr(), Bn, n, *plan,
        A.device.index, torch.cuda.current_stream(A.device).cuda_stream)
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
