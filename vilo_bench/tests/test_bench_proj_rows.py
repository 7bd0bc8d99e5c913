"""The projection rows' metrics on a small synthetic chrome trace and
hand-set counters: `proj_kernel_pair_pct` reads 100 when every assembly's
pairs went through the kernel; `proj_jac_roofline` reads the bytes' least
time (every pair's writes, the reads of the pairs with a mask on) over the
device time of every kernel launched in `proj_jacobians`, under 100 for a
launch at the bound's time beside a helper launch; both read None without
the program's counters (the parent of the change that added them)."""

import sys
import types

import pytest

from vilo_bench import harness, roofline
from vilo_bench import trace as tr
from vilo_bench.entries import fleet as FLEET


B, F, ASSEMBLIES = 4096, 160, 13
PAIRS = B * F * 11


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events(kernel_us, helper_us=0.0):
    """One traced batch of one solve: 13 assemblies, each a
    `proj_jacobians` span that launches the rows' kernel (and a helper
    kernel when helper_us > 0), and a kernel launched outside it."""
    ev = [X("user_annotation", "vilo_bench.batch", 0, 10 ** 6)]
    corr = 0
    for a in range(ASSEMBLIES):
        t0 = 1000 + 1000 * a
        ev.append(X("user_annotation", "proj_jacobians", t0, 100))
        for dur in ([kernel_us] + ([helper_us] if helper_us else [])):
            corr += 1
            ev.append(X("cuda_runtime", "cudaLaunchKernel", t0 + corr % 50,
                        1, corr=corr))
            ev.append(X("kernel", f"k{corr}", 50_000 + 10_000 * corr, dur,
                        corr=corr))
    corr += 1
    ev.append(X("cuda_runtime", "cudaLaunchKernel", 900, 1, corr=corr))
    ev.append(X("kernel", "outside", 900_000, 5_000.0, corr=corr))
    return ev


def reading(evs, dtype="float32"):
    return FLEET.Reading(tr.from_events(evs), (0.0, 10.0 ** 6), 12, B,
                         222, dtype)


def read(name, r):
    return harness.metric_reader(name)(r)


@pytest.fixture
def program_counters(monkeypatch):
    values = {}
    mod = types.ModuleType("cerberus_tpu_torch.utils.profiling")
    mod.counters = lambda: dict(values)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return values


def bound_us(dtype, read_pairs):
    es = roofline.BYTES[dtype]
    return (PAIRS * 108 * es + read_pairs * (11 * es + 2)) \
        / roofline.HBM_BYTES_PER_S * 1e6


def test_every_pair_through_the_kernel_reads_100(program_counters):
    program_counters.update({"proj.kernel_pairs": ASSEMBLIES * PAIRS,
                             "assemble.slots": B * F})
    assert read("proj_kernel_pair_pct", reading(events(1000.0))) \
        == pytest.approx(100.0)
    program_counters["proj.kernel_pairs"] = PAIRS     # one assembly of 13
    assert read("proj_kernel_pair_pct", reading(events(1000.0))) \
        == pytest.approx(100.0 / ASSEMBLIES)


@pytest.mark.parametrize("read_share", [1.0, 0.15])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_roofline_counts_every_kernel_in_the_span(program_counters, dtype,
                                                  read_share):
    """At read_share 0.15 (a cell whose masks are mostly off) the bound is
    the writes and the reads of the pairs that read: a launch at the time
    of every pair's reads would read under 100."""
    read_pairs = round(read_share * PAIRS)
    program_counters.update({"proj.kernel_pairs": ASSEMBLIES * PAIRS,
                             "proj.kernel_read_pairs":
                                 ASSEMBLIES * read_pairs,
                             "assemble.slots": B * F})
    at_bound = bound_us(dtype, read_pairs)
    if read_share < 1:
        assert read("proj_jac_roofline",
                    reading(events(bound_us(dtype, PAIRS)), dtype)) < 100.0
    assert read("proj_jac_roofline", reading(events(at_bound), dtype)) \
        == pytest.approx(100.0)
    # a helper launch in the span counts against the kernel
    got = read("proj_jac_roofline",
               reading(events(at_bound, at_bound / 4), dtype))
    assert got == pytest.approx(80.0) and got < 100.0
    assert read("proj_jac_roofline", reading(events(2 * at_bound), dtype)) \
        == pytest.approx(50.0)


def test_nothing_to_read_without_the_counter(program_counters, monkeypatch):
    r = reading(events(1000.0))
    program_counters.update({"assemble.slots": B * F})   # the parent's
    for name in ("proj_jac_roofline", "proj_kernel_pair_pct"):
        assert read(name, r) is None
        assert read(name, r._replace(trace=None)) is None
    # the pairs without the reads: no bytes to count
    program_counters["proj.kernel_pairs"] = ASSEMBLIES * PAIRS
    assert read("proj_jac_roofline", r) is None
    monkeypatch.delitem(sys.modules, "cerberus_tpu_torch.utils.profiling")
    for name in ("proj_jac_roofline", "proj_kernel_pair_pct"):
        assert read(name, r) is None
