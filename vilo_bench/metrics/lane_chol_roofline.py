"""The lane Cholesky kernel's share of its roofline: the least time one
launch at (batch, n) can take on an H100 (`roofline.cholesky_solve_bound`)
over the kernel's mean device time a launch in the traced batch, in %.
Layer: the damped Schur solve and its kernel (csrc/lane_cholesky.cu)."""

from vilo_bench import roofline

KERNEL = "blocked_cholesky::solve_kernel"


def read(r):
    if r.trace is None:
        return None
    ks = [k for k in r.trace.kernels if KERNEL in k.name]
    if not ks:
        return None
    mean_ms = sum(k.dur for k in ks) / len(ks) * 1e-3
    bound_ms, _ = roofline.cholesky_solve_bound(r.batch, r.n, r.dtype)
    return 100.0 * bound_ms / mean_ms
