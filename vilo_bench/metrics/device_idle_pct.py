"""Share of the traced batch (from the call to the synchronised result) in
which no operation ran on the device, in %. Layer: the device."""

from vilo_bench import trace as tr


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - tr.busy_us(r.trace, lo, hi) / (hi - lo))
