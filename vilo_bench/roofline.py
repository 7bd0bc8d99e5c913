"""Published peaks of one NVIDIA H100 SXM and the least time a kernel can
take (copied from `chip_smoke.py`).

Peaks from NVIDIA's data sheet at the full 700 W power limit: HBM
bandwidth; float32 outside the tensor cores; float64 on the tensor cores
(DMMA, full float64 precision), the card's fastest float64 rate."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 67e12

FLOP_PER_S = {"float32": F32_FLOP_PER_S, "float64": F64_FLOP_PER_S}
BYTES = {"float32": 4, "float64": 8}


def bound(bytes_moved, flops, flop_rate):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the type's peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cholesky_solve_bound(batch: int, n: int, dtype: str):
    """(bound_ms, bound_by) of one batched Cholesky solve of `batch` SPD
    systems of size n: the lower triangle of A and b read, x written, once
    each; n^3/3 + 2 n^2 operations a system."""
    es = BYTES[dtype]
    bytes_moved = es * (batch * n * (n + 1) // 2 + 2 * batch * n)
    flops = batch * (n ** 3 / 3 + 2 * n * n)
    return bound(bytes_moved, flops, FLOP_PER_S[dtype])
