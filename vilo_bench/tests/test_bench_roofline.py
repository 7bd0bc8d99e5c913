"""The copied bound reproduces the kernel table's bounds (PERF.md)."""

import pytest

from vilo_bench import roofline


@pytest.mark.parametrize("batch,dtype,ms,by", [
    (128, "float32", 0.00716, "operations"),
    (1024, "float32", 0.0572, "operations"),
    (1, "float64", 0.0000602, "bytes"),
])
def test_bound_reproduces_the_kernel_table(batch, dtype, ms, by):
    bound_ms, bound_by = roofline.cholesky_solve_bound(batch, 222, dtype)
    assert bound_ms == pytest.approx(ms, rel=5e-3)
    assert bound_by == by
