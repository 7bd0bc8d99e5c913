"""The trace reduction on a small synthetic chrome trace: kernels
attributed to the span their host launch lies in, the busy union of
overlapping device operations, the idle gaps and what each metric reader
makes of them."""

import pytest

from vilo_bench import harness
from vilo_bench import trace as tr
from vilo_bench.entries import fleet as FLEET


KERNEL = "void blocked_cholesky::solve_kernel<float, 32, Undamped<float> >"


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("user_annotation", "vilo_bench.batch", 0, 100),
    X("user_annotation", "lm_solve", 5, 60),
    X("user_annotation", "assemble", 10, 20),
    X("user_annotation", "assemble", 50, 10),
    X("cpu_op", "aten::mul", 11, 2),
    X("cpu_op", "aten::bmm", 36, 8),
    X("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
    X("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=2),
    X("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=3),
    X("cuda_runtime", "cudaLaunchKernel", 40, 10, corr=4),   # a full queue
    X("kernel", "kA", 20, 10, corr=1),
    X("gpu_memcpy", "Memcpy DtoD", 25, 10, corr=7),
    X("kernel", "kB", 40, 5, corr=2),
    X("kernel", KERNEL, 60, 10, corr=3),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
]


@pytest.fixture
def trace():
    return tr.from_events(EVENTS)


def test_kernels_are_attributed_by_their_launch(trace):
    assert [k.name for k in tr.launched_in(trace, "assemble")] == ["kA", KERNEL]
    assert trace.spans("vilo_bench.batch") == [(0.0, 100.0)]


def test_busy_is_the_union_of_device_operations(trace):
    assert tr.merged([(20, 30), (25, 35), (40, 45)], 0, 100) == [(20, 35), (40, 45)]
    assert tr.busy_us(trace, 0, 100) == 30.0
    assert tr.busy_us(trace, 22, 62) == 13 + 5 + 2
    assert tr.idle_gaps(trace, 0, 100) == [(0, 20), (35, 40), (45, 60), (70, 100)]


def test_breakdown_names_gaps_by_the_host(trace):
    bd = tr.breakdown(trace, 0, 100, top=2, skip=("vilo_bench.batch",))
    assert [n for n, _ in bd["device_ops"]] == ["kA", "Memcpy DtoD"]
    assert [s for _, s in bd["device_ops"]] == pytest.approx([10e-6, 10e-6])
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx([30e-6, 20e-6])
    assert bd["idle_gaps"][0][0] == "no host op"
    assert tr.host_activity(trace, 12, skip=("vilo_bench.batch",)) \
        == "assemble/aten::mul"


def test_metric_readers(trace):
    r = FLEET.Reading(trace, (0.0, 100.0), 2, 128, 222, "float32")
    read = lambda name: harness.metric_reader(name)(r)
    assert read("kernels_per_iter") == 1.5
    assert read("assemble_device_ms_per_iter") == pytest.approx(0.01)
    assert read("device_idle_pct") == pytest.approx(70.0)
    # 60 us of lm_solve less 13 us in runtime calls, over 2 iterations
    assert tr.host_own_us(trace, "lm_solve") == 47.0
    assert read("dispatch_ms_per_iter") == pytest.approx(0.0235)
    assert read("lane_chol_roofline") == pytest.approx(71.55, rel=1e-3)


def test_readers_return_nothing_without_a_trace():
    r = FLEET.Reading(None, (0.0, 0.0), 12, 128, 222, "float32")
    for name in ("kernels_per_iter", "assemble_device_ms_per_iter",
                 "device_idle_pct", "dispatch_ms_per_iter",
                 "lane_chol_roofline"):
        assert harness.metric_reader(name)(r) is None
