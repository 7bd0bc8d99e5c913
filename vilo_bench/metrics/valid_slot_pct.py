"""Share of the feature slots of the traced batch's windows that hold a
valid feature, in %: the program's counters `assemble.valid_slots` over
`assemble.slots` (`utils/profiling.counters()`). The assembly computes
every slot, so 100 minus this bounds what skipping empty slots could save
of the projection stages. Layer: the assembly."""

from vilo_bench import stages


def read(r):
    return stages.counter_pct(r, "assemble.valid_slots", "assemble.slots")
