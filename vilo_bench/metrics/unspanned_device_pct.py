"""Share of the device time of the kernels launched inside the program's
`lm_solve` span that were launched outside all eleven stage spans
(`stages.STAGES`), in %, in the traced batch. The stage spans partition the
solve, so this reads near 0; it rises where new work lands outside them,
and then the stage metrics no longer add up to the solve. It also reads
`lane_chol`, `prior_calib` and `robust_cost`, which no other metric names.
Layer: the device."""

from vilo_bench import stages
from vilo_bench import trace as tr


def read(r):
    if r.trace is None:
        return None
    staged = stages.launched_in_any(r.trace, stages.STAGES)
    solve = tr.launched_in(r.trace, "lm_solve")
    if staged is None or not solve:
        return None
    ids = {k.corr for k in staged}
    total = sum(k.dur for k in solve)
    outside = sum(k.dur for k in solve if k.corr not in ids)
    return 100.0 * outside / total if total > 0 else None
