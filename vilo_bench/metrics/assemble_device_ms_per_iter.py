"""Device milliseconds per LM iteration of the kernels launched inside the
program's `assemble` spans (matched to their host launch by correlation
id) in the traced batch. Layer: the assembly (ops/structured.py and
ops/factors.py under vmap)."""

from vilo_bench import trace as tr


def read(r):
    if r.trace is None:
        return None
    ks = tr.launched_in(r.trace, "assemble")
    if not ks:
        return None
    return sum(k.dur for k in ks) * 1e-3 / r.iters
