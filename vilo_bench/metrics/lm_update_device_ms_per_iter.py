"""Device milliseconds per LM iteration of the kernels launched inside the
program's `lm_update` spans (the LM state's set-up, the step clip and
retraction, the masked accept, lambda and cost update, and under the
profiler the work counters) and its `reanchor` span (the gauge re-fix
after the loop), in the traced batch. Layer: the fleet entry and LM loop
dispatch."""

from vilo_bench import stages


def read(r):
    return stages.device_ms_per_iter(r, "lm_update", "reanchor")
