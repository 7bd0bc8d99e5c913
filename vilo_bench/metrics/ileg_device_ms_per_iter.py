"""Device milliseconds per LM iteration of the kernels launched inside the
program's `ileg_factor` spans (the IMU+leg factor's rows and their
placement contraction, one an assembly), in the traced batch. Layer: the
assembly."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "ileg_factor")
