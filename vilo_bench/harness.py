"""One run of one cell: CUDA start, the entry's set-up, the measured window
of closed-loop requests, the per-layer readings of a traced request and the
check against the plain reference.

Everything about a cell is data: its configuration file (`configs/`), its
traffic file (`workloads/<traffic>.json`, with the limits of the numbers
its check compares), its per-layer metrics (`metrics/<name>.py`, each with
`read(reading) -> float | None`) and its entry, all found by the names in
BENCHMARK.json (`spec.py`).

The entry is the module `entries/<entry>.py` that the configuration's
`"entry"` names (`fleet` where it names none). It holds what one request
is, and it alone imports the program; it imports nothing of this module
or of `run.py`. It has

    setup(cell, seed, device, simulation, parts, **kw) -> run

which builds the program and the cell's inputs on `device` from the seed
(the traffic's segments come from `simulation`, a `scene.Simulation` that
`run.py` starts before torch is imported) and adds the seconds of its
stages to the dict `parts`; `kw` are the caller's, for the entry (the tests
plant faults through them). The object it returns has

- `windows`: the windows one request solves;
- `note`: text appended to the `setup_parts` line;
- `request(k) -> (record, bad)`: request k of the run, waited for (k = -1
  warms up every shape); `record.seconds` is its time from the call to the
  synchronised result, `record.dispatch_s` from the call to its return;
  `bad` counts its non-finite windows, an integer tensor;
- `reading(trace, window)`: what the per-layer readers are given for the
  traced request, from its trace and its (start, end) in us;
- `checked_numbers(records, refs) -> dict`: after the window, every number
  its check can compare, against the reference in each type of `refs` (the
  prefixes of the traffic's limits, `f64.q_gap`); it frees the timed path's
  state first."""

from __future__ import annotations

import importlib.util
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from vilo_bench import spec
from vilo_bench import trace as tr
from vilo_bench.spec import Cell

ROOT = spec.ROOT
BATCH_SPAN = "vilo_bench.batch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cerberus_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the process must not hold,
    compared whole (`cerberus_tpu_torch` is not `cerberus_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_reader(name: str, root=ROOT):
    """The `read` function of `root`/metrics/<name>.py."""
    path = Path(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vilo_bench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_entry(path):
    """The entry module at `path` (`entries/<entry>.py`)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"vilo_bench.entries.{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def references(limits: dict) -> list:
    """The reference types that a cell's limits name."""
    return sorted({k.split(".")[0] for k in limits})


def verdict(numbers: dict, limits: dict, failed: int) -> bool:
    """Correct when no window failed and every number compared is finite
    and within its limit."""
    return failed == 0 and all(
        limits.get(k) is not None and math.isfinite(v) and v <= limits[k]
        for k, v in numbers.items())


def read_trace(prof) -> tr.Trace:
    """The profiler's chrome trace, written to a temporary file (TMPDIR),
    read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="vilo_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tr.load(path)
    finally:
        os.remove(path)


def device_info(device, chips) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, simulation=None, **kw) -> dict:
    """One run of `cell` through its entry. Returns the result dict (its
    keys in the order they are printed) or raises. `simulation`: the run's
    segments, already started (`scene.Simulation`); `kw` go to the entry's
    `setup`."""
    device = torch.device(device)
    traffic = cell.traffic
    parts = {}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    parts["cuda_start_s"] = time.perf_counter() - t
    run = load_entry(cell.entry).setup(cell, seed, device, simulation,
                                       parts, **kw)
    t = time.perf_counter()
    run.request(-1)
    parts["warm_solve_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    parts["setup_s"] = setup_s
    print("setup_parts " + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
          + f" {run.note}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records, bad, prof = [], [], None
    t_win = time.perf_counter()
    k = 0
    while True:
        if trace and k == 1:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(BATCH_SPAN):
                    r, nb = run.request(k)
        else:
            r, nb = run.request(k)
        records.append(r)
        bad.append(nb)
        k += 1
        elapsed = time.perf_counter() - t_win
        if elapsed >= seconds and (not trace or k >= 2):
            break
    dev = device_info(device, cell.chips)
    attempted = run.windows * len(records)
    failed = int(torch.stack(bad).sum())

    metrics = {}
    if trace:
        T = read_trace(prof)
        spans = T.spans(BATCH_SPAN)
        lo, hi = spans[0] if spans else (0.0, 0.0)
        reading = run.reading(T, (lo, hi))
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.root)(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_us(T, lo, hi) * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
        bd = tr.breakdown(T, lo, hi, skip=(BATCH_SPAN,))
        del T
    else:
        e2e = {"windows_per_s": (attempted / elapsed, "windows/s"),
               "peak_mem_gib": (dev["memory_peak_bytes"] / 2 ** 30, "GiB"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
        bd = None
    log(f"window: {len(records)} batches of {run.windows} in {elapsed:.3f} "
        f"s; batch s {statistics.median(r.seconds for r in records):.3f} "
        f"(median), dispatch s "
        f"{statistics.median(r.dispatch_s for r in records):.3f}")

    limits = traffic["limits"]
    gaps = run.checked_numbers(records, references(limits))
    numbers = {k: gaps[k] for k in limits}
    correct = verdict(numbers, limits, failed)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    checks["failed_windows"] = {"value": failed, "limit": 0}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if bd is not None:
        result["breakdown"] = bd
    result["checks"] = checks
    return result
