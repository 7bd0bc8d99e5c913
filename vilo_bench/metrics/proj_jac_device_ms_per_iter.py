"""Device milliseconds per LM iteration of the kernels launched inside the
program's `proj_jacobians` spans (one an assembly: the projection residuals
and their Jacobians over every feature slot and frame, one launch of the
projection rows' kernel, `csrc/proj_rows.cu`, for the batch), in the
traced batch. Read to tell the Jacobian arithmetic from the rest of
the assembly. Layer: the assembly."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "proj_jacobians")
