"""The fleet entry: one request is one batched fleet solve of the cell's
windows, `cerberus_tpu_torch.parallel.fleet.solve_fleet`, from fresh
perturbations, checked against the plain reference's solve of the same
windows. The entry of every configuration that names none (see
`harness.py` for the interface).

`Program` is the only code of the benchmark that imports the program."""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch

from vilo_bench import fleet, scene, trace as tr
from vilo_bench.frozen import factors as ffac
from vilo_bench.frozen import solver as ref_solver

STATE_FIELDS = ("p", "q", "v", "ba", "bg", "rho", "depth")
REF_BLOCK = 256          # windows per reference solve
CHECK_PER_BATCH = 64     # windows of each batch whose answers are checked
CHECK_MAX = 256          # at most this many a run, drawn from the seed
# the plain reference's types, by the prefix of the numbers compared
# against it (`f64.q_gap`)
REFERENCES = {"f64": torch.float64, "f32": torch.float32}


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


def setup(cell, seed, device, simulation, parts, program=None,
          solve=None) -> "Fleet":
    """The program, its kernel and the cell's windows on `device`.
    `program`: one already built; `solve` replaces the program's fleet
    step (the tests plant faults through it)."""
    t = time.perf_counter()
    program = program or Program(cell.cfg)
    if device.type == "cuda":
        program.load_kernel()
    parts["kernel_load_s"] = time.perf_counter() - t
    inputs = make_inputs(cell.cfg, cell.traffic, seed, device, program,
                         simulation=simulation, parts=parts)
    return Fleet(cell, seed, device, program, inputs, solve)


class Fleet:
    """A run's fleet: requests are `run_batch` calls on its inputs."""

    def __init__(self, cell, seed, device, program, inputs, solve):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.seed, self.device = seed, device
        self.program, self.inputs, self.solve = program, inputs, solve
        self.windows = inputs.truths.p.shape[0]
        self.note = f"valid_slots={inputs.n_valid}"

    def request(self, k):
        return run_batch(self.program, self.inputs, self.traffic, self.seed,
                         k, self.device, self.solve)

    def reading(self, trace, window) -> Reading:
        return Reading(trace, window, self.cfg["solver"]["max_iters"],
                       self.windows, self.program.D, self.cfg["dtype"])

    def checked_numbers(self, batches, refs) -> dict:
        """Frees the timed path's batch of program windows, then solves the
        checked windows again by the reference."""
        self.inputs = self.inputs._replace(datas=None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        gaps = checked_numbers(self.cfg, batches, self.inputs, self.seed,
                               self.device, refs)
        n = min(sum(b.rows.numel() for b in batches), CHECK_MAX)
        print(f"gaps to the reference over {n} windows "
              f"({time.perf_counter() - t:.1f} s): "
              + " ".join(f"{k}={v:.3e}" for k, v in gaps.items()),
              file=sys.stderr, flush=True)
        return gaps
