"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the per-layer readings of a traced batch.

Everything about a cell is data: its configuration file (`configs/`), its
traffic file (`workloads/<traffic>.json`, with the limits of the numbers
its check compares) and its per-layer metrics (`metrics/<name>.py`, each
with `read(reading) -> float | None`), all found by the names in
BENCHMARK.json (`spec.py`). The program under test is reached only through
`Program`."""

from __future__ import annotations

import importlib.util
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from vilo_bench import fleet, scene, spec
from vilo_bench import trace as tr
from vilo_bench.spec import Cell
from vilo_bench.frozen import factors as ffac
from vilo_bench.frozen import solver as ref_solver

ROOT = spec.ROOT
BATCH_SPAN = "vilo_bench.batch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cerberus_tpu")
STATE_FIELDS = ("p", "q", "v", "ba", "bg", "rho", "depth")
REF_BLOCK = 256          # windows per reference solve
CHECK_PER_BATCH = 64     # windows of each batch whose answers are checked
CHECK_MAX = 256          # at most this many a run, drawn from the seed
# the plain reference's types, by the prefix of the numbers compared
# against it (`f64.q_gap`)
REFERENCES = {"f64": torch.float64, "f32": torch.float32}


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


class Reading(NamedTuple):
    """What a per-layer metric reader is given."""
    trace: tr.Trace | None   # the traced batch
    window: tuple            # (start, end) of the traced batch, us
    iters: int               # LM iterations a solve
    batch: int               # windows a batch
    n: int                   # size of each reduced (Schur) system
    dtype: str               # "float32" | "float64"


class Program:
    """The system under test: `cerberus_tpu_torch.parallel.fleet.solve_fleet`
    on the production options (float32 matmuls without TF32, the lane
    kernel: the fleet entry's own), with the windows in the program's
    types."""

    def __init__(self, cfg: dict):
        from cerberus_tpu_torch.ops import factors as pfac
        from cerberus_tpu_torch.ops import lane_cholesky
        from cerberus_tpu_torch.ops.solver import (SolveOptions,
                                                   solve_window_batched)
        from cerberus_tpu_torch.parallel.fleet import solve_fleet
        for a, b in ((pfac.WindowState, ffac.WindowState),
                     (pfac.WindowData, ffac.WindowData)):
            if a._fields != b._fields:
                raise ValueError(f"{a.__name__} fields differ from the "
                                 f"generator's: {a._fields}")
        self.pfac = pfac
        self.lane_cholesky = lane_cholesky
        self.opts = SolveOptions(**cfg["solver"])
        self.solve_fleet = solve_fleet
        self.solve_window_batched = solve_window_batched
        self.D = pfac.D_DENSE

    def load_kernel(self):
        """Build (first run in a checkout) or load the lane kernel."""
        self.lane_cholesky._library()

    def state(self, s: ffac.WindowState):
        return self.pfac.WindowState(*s)

    def data(self, d: ffac.WindowData):
        return self.pfac.WindowData(**{
            k: self.state(v) if k == "prior_lin" else v
            for k, v in d._asdict().items()})

    def solve(self, states, datas, truths):
        """(states, cost0, cost) of one fleet step."""
        out = self.solve_fleet(states, datas, truths, mesh=None,
                               opts=self.opts)
        return out.states, out.cost0, out.cost


def to_device(tree, dtype, device):
    """Float leaves cast to `dtype` on `device`; bools and ints kept."""
    return ffac.map_tensors(
        lambda x: x.to(device=device, dtype=dtype) if x.is_floating_point()
        else x.to(device), tree)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs(NamedTuple):
    seg_datas: ffac.WindowData      # (n_seg, ...) served dtype, on device
    datas: object                   # (B, ...) program WindowData
    truths: ffac.WindowState        # (B, ...) frozen type
    n_valid: list


def make_inputs(cfg, traffic, seed, device, program, batch=None,
                simulation=None, parts=None) -> Inputs:
    """The cell's windows on `device`: the segments (simulated by
    `simulation`, or by a new `scene.Simulation`), built into window
    problems on `device`, cast to the served type and replicated to the
    batch. Adds the seconds of each stage to `parts`."""
    parts = {} if parts is None else parts
    dtype = fleet.DTYPES[cfg["dtype"]]
    B = batch or traffic["batch"]
    t = time.perf_counter()
    sims = (simulation or scene.Simulation(cfg, traffic, seed)).result()
    parts["simulation_wait_s"] = time.perf_counter() - t
    t = time.perf_counter()
    seg_datas, seg_truths, n_valid = scene.build_windows(cfg, traffic, sims,
                                                         device)
    parts["window_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    seg_datas = to_device(seg_datas, dtype, device)
    seg_truths = to_device(seg_truths, dtype, device)
    n_seg = len(n_valid)
    datas = program.data(fleet.replicate(seg_datas, B, n_seg))
    truths = fleet.replicate(seg_truths, B, n_seg)
    parts["inputs_to_device_s"] = time.perf_counter() - t
    return Inputs(seg_datas, datas, truths, n_valid)


class Batch(NamedTuple):
    k: int
    seconds: float        # call to synchronised result
    dispatch_s: float     # call to return
    rows: torch.Tensor    # checked rows
    init: ffac.WindowState
    out: ffac.WindowState
    cost: torch.Tensor


def run_batch(program, inputs: Inputs, traffic, seed, k, device,
              solve=None) -> tuple:
    """One closed-loop request: batch k's fresh initial states, one fleet
    solve, wait for it. Returns (Batch of the checked rows, count of
    non-finite windows as a device tensor)."""
    solve = solve or program.solve
    B = inputs.truths.p.shape[0]
    init = fleet.perturbed(inputs.truths, traffic, seed, k)
    t0 = time.perf_counter()
    st, _, cost = solve(program.state(init), inputs.datas,
                        program.state(inputs.truths))
    t1 = time.perf_counter()
    sync(device)
    t2 = time.perf_counter()
    bad = ~torch.isfinite(cost)
    for f in STATE_FIELDS:
        x = getattr(st, f)
        bad |= ~torch.isfinite(x.reshape(B, -1)).all(dim=1)
    rows = fleet.sample_rows(B, CHECK_PER_BATCH, seed, k)
    r = rows.to(device)
    pick = lambda t: ffac.map_tensors(lambda x: x[r], t)
    out = pick(ffac.WindowState(*st))
    return Batch(k, t2 - t0, t1 - t0, rows, pick(init), out, cost[r]), \
        bad.sum()


def reference_gaps(cfg, batches, inputs: Inputs, seed, device,
                   dtype) -> dict:
    """The checked windows solved by the plain reference in `dtype` (TF32
    off) from the same inputs. Returns each number's gap per window, as a
    float64 tensor on the CPU: `<field>_gap`, the largest absolute gap of
    an entry of that state field (p, q, v, biases, calf lengths, inverse
    depths); `state_gap`, the largest over the fields; `cost_gap`, the
    relative gap of the solved cost."""
    B = inputs.truths.p.shape[0]
    n_seg = len(inputs.n_valid)
    rows = torch.cat([b.rows for b in batches])
    cat = lambda xs: ffac.map_tensors(lambda *ls: torch.cat(ls), *xs)
    init, out = cat([b.init for b in batches]), cat([b.out for b in batches])
    cost = torch.cat([b.cost for b in batches])
    if rows.numel() > CHECK_MAX:
        g = torch.Generator()
        g.manual_seed(fleet.batch_seed(seed, 10 ** 6))
        keep = torch.randperm(rows.numel(), generator=g)[
            :CHECK_MAX].sort().values
        rows = rows[keep]
        kd = keep.to(device)
        init = ffac.map_tensors(lambda x: x[kd], init)
        out = ffac.map_tensors(lambda x: x[kd], out)
        cost = cost[kd]
    seg = (rows * n_seg // B).to(device)
    datas = ffac.map_tensors(
        lambda x: (x[seg].to(dtype) if x.is_floating_point() else x[seg]),
        inputs.seg_datas)
    init = ffac.map_tensors(lambda x: x.to(dtype), init)
    opts = ref_solver.SolveOptions(**cfg["solver"])
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        parts = []
        for i in range(0, rows.numel(), REF_BLOCK):
            blk = lambda t: ffac.map_tensors(lambda x: x[i:i + REF_BLOCK], t)
            parts.append(ref_solver.solve_windows(blk(init), blk(datas),
                                                  opts))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    ref_st = cat([p[0] for p in parts])
    ref_cost = torch.cat([p[1].cost for p in parts]).double()
    n = rows.numel()
    gap = lambda f: (getattr(out, f).double() - getattr(ref_st, f).double()
                     ).abs().reshape(n, -1).amax(dim=1).cpu()
    gaps = {f"{f}_gap": gap(f) for f in STATE_FIELDS}
    gaps["state_gap"] = torch.stack(list(gaps.values())).amax(dim=0)
    gaps["cost_gap"] = ((cost.double() - ref_cost).abs()
                        / ref_cost.abs().clamp(min=1e-300)).cpu()
    return gaps


def checked_numbers(cfg, batches, inputs: Inputs, seed, device,
                    refs) -> dict:
    """Every number the check can compare, against the reference in each
    type of `refs` (keys of REFERENCES): `<ref>.<gap>`, the largest gap
    over the checked windows, and `<ref>.<gap>_median`, their median."""
    out = {}
    for r in refs:
        for k, v in reference_gaps(cfg, batches, inputs, seed, device,
                                   REFERENCES[r]).items():
            out[f"{r}.{k}"] = float(v.max())
            out[f"{r}.{k}_median"] = float(v.median())
    return out


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
             t_start: float, program: Program | None = None,
             solve=None, simulation=None) -> dict:
    """One run of `cell`. Returns the result dict (its keys in the order
    they are printed) or raises. `simulation`: the run's segments, already
    started (`scene.Simulation`); `solve` replaces the program's fleet step
    (the tests plant faults through it)."""
    device = torch.device(device)
    cfg, traffic = cell.cfg, cell.traffic
    parts = {}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    parts["cuda_start_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program = program or Program(cfg)
    if device.type == "cuda":
        program.load_kernel()
    parts["kernel_load_s"] = time.perf_counter() - t
    inputs = make_inputs(cfg, traffic, seed, device, program,
                         simulation=simulation, parts=parts)
    t = time.perf_counter()
    run_batch(program, inputs, traffic, seed, -1, device, solve)
    parts["warm_solve_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    parts["setup_s"] = setup_s
    print("setup_parts " + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
          + f" valid_slots={inputs.n_valid}", flush=True)

    B = inputs.truths.p.shape[0]
    iters = cfg["solver"]["max_iters"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    batches, bad, prof = [], [], None
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
                    b, nb = run_batch(program, inputs, traffic, seed, k,
                                      device, solve)
        else:
            b, nb = run_batch(program, inputs, traffic, seed, k, device,
                              solve)
        batches.append(b)
        bad.append(nb)
        k += 1
        elapsed = time.perf_counter() - t_win
        if elapsed >= seconds and (not trace or k >= 2):
            break
    dev = device_info(device, cell.chips)
    attempted = B * len(batches)
    failed = int(torch.stack(bad).sum())

    metrics = {}
    if trace:
        T = read_trace(prof)
        spans = T.spans(BATCH_SPAN)
        lo, hi = spans[0] if spans else (0.0, 0.0)
        reading = Reading(T, (lo, hi), iters, B, program.D, cfg["dtype"])
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
    log(f"window: {len(batches)} batches of {B} in {elapsed:.3f} s; "
        f"batch s {statistics.median(b.seconds for b in batches):.3f} "
        f"(median), dispatch s "
        f"{statistics.median(b.dispatch_s for b in batches):.3f}")

    inputs = inputs._replace(datas=None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limits = traffic["limits"]
    gaps = checked_numbers(cfg, batches, inputs, seed, device,
                           references(limits))
    n = min(sum(b.rows.numel() for b in batches), CHECK_MAX)
    log(f"gaps to the reference over {n} windows "
        f"({time.perf_counter() - t:.1f} s): "
        + " ".join(f"{k}={v:.3e}" for k, v in gaps.items()))
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
