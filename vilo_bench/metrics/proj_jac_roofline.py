"""The projection rows' kernel (`csrc/proj_rows.cu`) against its roofline,
in %: the least time the bytes it moved in the traced batch take on an H100
over the device time of every kernel launched inside the program's
`proj_jacobians` spans, so that any helper launch there counts against it.
The bytes: every pair it computed (the program's counter
`proj.kernel_pairs`) writes 108 values, 4 residuals and 104 Jacobian
entries; a pair with a camera's mask on (the counter
`proj.kernel_read_pairs`, which the kernel keeps itself) also reads 11
values and two mask bytes, and a pair with both off reads none of its
values; over `roofline.HBM_BYTES_PER_S`. Bytes only: a kernel that writes
its outputs cannot read above 100. None where the program keeps no such
counters (a program without the kernel). Layer: the assembly."""

from vilo_bench import roofline, stages

PAIR_WRITTEN = 108    # 4 + 104 values, every pair
PAIR_READ = 11        # 3 + 3 + 2 + 2 + 1 values, a pair with a mask on
PAIR_MASK_BYTES = 2   # obs, stereo


def read(r):
    if r.trace is None:
        return None
    c = stages.counters()
    if not c or not c.get("proj.kernel_pairs") \
            or "proj.kernel_read_pairs" not in c:
        return None
    ks = stages.launched_in_any(r.trace, ("proj_jacobians",))
    if not ks:
        return None
    es = roofline.BYTES[r.dtype]
    moved = (c["proj.kernel_pairs"] * PAIR_WRITTEN * es
             + c["proj.kernel_read_pairs"] * (PAIR_READ * es
                                              + PAIR_MASK_BYTES))
    bound_us = moved / roofline.HBM_BYTES_PER_S * 1e6
    return 100.0 * bound_us / sum(k.dur for k in ks)
