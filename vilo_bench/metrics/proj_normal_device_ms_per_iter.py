"""Device milliseconds per LM iteration of the kernels launched inside the
program's `proj_normal` spans (two an assembly: the Huber weights, the
one-hot widening of the projection rows to `A79`, their normal-equation
contractions and the placement), in the traced batch. Read because the
widening's tensors are the largest of the assembly. Layer: the
assembly."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "proj_normal")
