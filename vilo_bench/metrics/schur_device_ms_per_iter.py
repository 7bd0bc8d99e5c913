"""Device milliseconds per LM iteration of the kernels launched inside the
program's `schur_reduce` spans (equilibration, damping, the Schur
complement on depth and its right-hand side) and `back_substitute` spans
(the depth step and the unscaling), one each an iteration, in the traced
batch: the damped Schur solve around the lane kernel, which
`lane_chol_roofline` reads. Layer: the damped Schur solve and lane
kernel."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "schur_reduce", "back_substitute")
