"""Share of the active window-iterations of the traced batch's solve whose
candidate step was accepted, in %: the program's counters
`lm.accepted_steps` over `lm.active_window_iterations`
(`utils/profiling.counters()`). A rejected step's assembly is work thrown
away. Layer: the fleet entry and LM loop dispatch."""

from vilo_bench import stages


def read(r):
    return stages.counter_pct(r, "lm.accepted_steps",
                              "lm.active_window_iterations")
