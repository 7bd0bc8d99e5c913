"""CUDA kernels launched per LM iteration: the kernels of the traced batch
over the solve's iterations. A count; layer: the fleet entry and LM loop
dispatch."""


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.window
    n = sum(1 for k in r.trace.kernels if lo <= k.ts <= hi)
    return n / r.iters if n else None
