"""Host milliseconds per LM iteration that the program spends in its own
code inside its `lm_solve` span (the LM loop of `solve_window_batched`),
outside CUDA runtime and driver calls, in the traced batch. Where the card
sets the pace the host waits in its launches on a full queue; that wait is
left out, so this reads the host's cost to issue an iteration, not the
card's pace. Read under the profiler, which slows the host's own work.
Layer: the fleet entry and LM loop dispatch."""

from vilo_bench import trace as tr

SPAN = "lm_solve"


def read(r):
    if r.trace is None or not r.trace.spans(SPAN):
        return None
    return tr.host_own_us(r.trace, SPAN) * 1e-3 / r.iters
