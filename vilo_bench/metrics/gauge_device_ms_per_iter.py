"""Device milliseconds per LM iteration of the kernels launched inside the
program's `gauge_project` spans (the rank-4 gauge projection of each
window's blocks, one an assembly), in the traced batch. Layer: the
assembly."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "gauge_project")
