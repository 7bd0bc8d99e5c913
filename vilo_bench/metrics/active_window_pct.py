"""Share of the window-iterations of the traced batch's solve in which the
window had not yet converged, in %: the program's counters
`lm.active_window_iterations` over `lm.window_iterations`
(`utils/profiling.counters()`). The LM loop runs every iteration on every
window, a converged one under a mask, so 100 minus this is the share that
compacting converged windows out of the batch could save. Layer: the fleet
entry and LM loop dispatch."""

from vilo_bench import stages


def read(r):
    return stages.counter_pct(r, "lm.active_window_iterations",
                              "lm.window_iterations")
