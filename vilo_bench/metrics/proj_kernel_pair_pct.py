"""Share of the traced batch's projection pairs that the projection rows'
kernel computed, in %: the program's counter `proj.kernel_pairs` over
`assemble.slots` x 11 frames x the `proj_jacobians` spans (one an
assembly) in the traced batch. 100 when every assembly of every window
went through the kernel in one launch. None where the program keeps no
such counter (a program without the kernel). Layer: the assembly."""

from vilo_bench import stages

FRAMES = 11


def read(r):
    if r.trace is None:
        return None
    c = stages.counters()
    if not c or "proj.kernel_pairs" not in c or not c.get("assemble.slots"):
        return None
    lo, hi = r.window
    n = sum(1 for a, b in r.trace.spans("proj_jacobians")
            if lo <= a and b <= hi)
    if not n:
        return None
    return 100.0 * c["proj.kernel_pairs"] / (c["assemble.slots"] * FRAMES
                                             * n)
