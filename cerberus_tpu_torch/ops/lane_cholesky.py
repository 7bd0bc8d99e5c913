"""Batched Cholesky solve x = A^-1 b of B independent SPD systems.

Port of `cerberus_tpu/ops/lane_cholesky.py::lane_cholesky_solve`. On a CUDA
tensor `lane_cholesky_solve` launches the hand-written kernel
`csrc/lane_cholesky.cu` (f32 or f64, a blocked factor in tiles; the sources
say what bounds it): one thread block per system, or, for a few f64
systems too large for one block's shared memory, one thread-block cluster
per system (`csrc/cluster_cholesky.cuh`). On a CPU tensor it runs
`lane_cholesky_solve_plain`, the same function in plain torch ops. There is
no fallback from the card to the plain version: a CUDA tensor the kernel
does not take raises.

`tile_plan` is the one-block layout (tile width, padded n, resident or
streamed tiles, shared memory), shared with `ops/cholesky_solve.py`;
`solve_plan` picks between it and the cluster layout (`cluster_plan`: tile
width, cluster size, each rank's shared memory) for a batch.

`LAUNCHES` counts the kernel's launches by (dtype, n), and
`LAUNCHES_BY_SHAPE` the same launches by (dtype, B, n), so a run can show
that its solves went through the kernel at the shapes it expects.

`lane_cholesky_solve_ref` is the library route (`torch.linalg`), which the
caller picks explicitly (`solve_window_batched(lane_chol=False)`); nothing
falls back to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from cerberus_tpu_torch import _build

LAUNCHES = collections.Counter()   # (dtype, n) -> launches
LAUNCHES_BY_SHAPE = collections.Counter()   # (dtype, B, n) -> launches

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90
SM_COUNT = 132         # SMs of an H100 SXM
# the f64 cluster body's tile width, and its cluster sizes in the order
# solve_plan tries them: the fastest at (1, 382) first, then smaller
# clusters for larger batches (csrc/DESIGN.md)
CLUSTER_NB = 16
CLUSTER_SIZES = (16, 8, 4)

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


class ClusterPlan(NamedTuple):
    """Layout of one system over a cluster in csrc/cluster_cholesky.cuh:
    block-column J of the tile triangle lives in rank J % cluster."""
    nb: int                 # tile width
    n_pad: int              # n rounded up to a multiple of nb
    cluster: int            # blocks (ranks) per system
    rank_bytes: tuple       # shared memory each rank's data takes
    smem_bytes: int         # dynamic shared memory of every block (rank 0's)
    work_elems: int         # staged panels' workspace elements per system


@functools.lru_cache(maxsize=None)
def cluster_plan(n: int, cluster: int) -> ClusterPlan:
    """The f64 cluster layout of an n x n system in CLUSTER_NB-wide tiles
    over `cluster` ranks: each rank's own block-columns, a panel buffer (the
    nt - 1 tiles below a diagonal tile and nb entries of y), one tile (the
    next diagonal tile's panel tile) and two nt*nb vectors (right-hand
    side, the diagonal's reciprocals). Every block gets rank 0's bytes (it
    keeps the most tiles), so that the layout is the same in every rank.
    The panels pass between ranks through a global workspace of two
    staged panels per system (the nt - 1 tiles below a diagonal tile and
    y_K each)."""
    nb = CLUSTER_NB
    nt = -(-n // nb)
    panel = (nt - 1) * nb * nb + nb
    shared = panel + nb * nb + 2 * nt * nb
    rank_bytes = tuple(8 * (len(cluster_tiles(nt, cluster, r)) * nb * nb
                            + shared) for r in range(cluster))
    return ClusterPlan(nb, nt * nb, cluster, rank_bytes, rank_bytes[0],
                       2 * panel)


def cluster_tiles(nt: int, cluster: int, rank: int) -> list:
    """The tiles (I, J) that rank keeps, in its storage order: its
    block-columns J = rank, rank + cluster, ..., each from (J, J) down."""
    return [(I, J) for J in range(rank, nt, cluster) for I in range(J, nt)]


@functools.lru_cache(maxsize=None)
def solve_plan(n: int, dtype, batch: int):
    """The kernel's layout for `batch` systems of n x n `dtype`: the
    cluster body (a ClusterPlan) for f64 systems that one block would
    stream (n > 224) when the batch's clusters fit the card at once
    (batch * cluster <= SM_COUNT): the first of CLUSTER_SIZES whose ranks
    fit a block's shared memory; else tile_plan's one block per system.
    f32, and f64 systems resident in one block, stay on tile_plan."""
    one = tile_plan(n, dtype)
    if dtype != torch.float64 or one.resident:
        return one
    for c in CLUSTER_SIZES:
        p = cluster_plan(n, c)
        if p.smem_bytes <= SMEM_LIMIT and batch * c <= SM_COUNT:
            return p
    return one


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
        fn = lib.lane_cholesky_solve_cluster_f64
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
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
    launched on the current stream without synchronising, with the layout
    of `solve_plan` (a cluster per system for a few large f64 systems).
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
    x = _launch(A, b, solve_plan(n, A.dtype, Bn))
    LAUNCHES[(A.dtype, n)] += 1
    LAUNCHES_BY_SHAPE[(A.dtype, Bn, n)] += 1
    return x


def _launch(A: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """x from one launch of the kernel on checked CUDA A and b, with the
    layout `plan` (a TilePlan or a ClusterPlan of these shapes); raises
    with CUDA's error string when the launch is refused, such as a cluster
    that the card cannot place."""
    Bn, n = b.shape
    x = torch.empty_like(b)
    lib = _library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if isinstance(plan, ClusterPlan):
        work = torch.empty((Bn, plan.work_elems), dtype=A.dtype,
                           device=A.device)
        err = lib.lane_cholesky_solve_cluster_f64(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(), Bn, n,
            plan.nb, plan.cluster, plan.smem_bytes, A.device.index, stream)
    else:
        work, args = launch_args(n, A.dtype, Bn, A.device)
        err = getattr(lib, _ENTRY[A.dtype])(
            A.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if work is None else work.data_ptr(), Bn, n, *args,
            A.device.index, stream)
    if err != 0:
        raise RuntimeError("lane_cholesky_solve launch failed: "
                           + lib.lane_cholesky_error_string(err).decode())
    return x


def lane_cholesky_solve_ref(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library's solve of the same systems: `torch.linalg.cholesky_ex`
    (no error check read back to the host) and `torch.cholesky_solve`, on
    any device. The counterpart of the JAX package's
    `lane_cholesky_solve_ref`: the op the kernel replaces, for a caller that
    asks for it by name. A system that is not SPD gives what the library
    gives (a partial factor), not necessarily NaN."""
    L = torch.linalg.cholesky_ex(A).L
    return torch.cholesky_solve(b[..., None], L)[..., 0]


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
