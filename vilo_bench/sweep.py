"""Batch-size sweep of one fleet cell's configuration and traffic on the card
(through the fleet entry, `entries/fleet.py`): for
each batch size, a warm-up batch, `--timed` closed-loop batches (windows/s
over them, peak memory) and one traced batch (device idle share, busy
seconds, the top device operations). One JSON line per batch size.

    python3 -m vilo_bench.sweep --workload fleet-f32-dense --batches 1024 2048 4096

Used once to choose each cell's batch size; the runs of the benchmark do
not call it."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vilo_bench import harness, spec
from vilo_bench import trace as tr
from vilo_bench.entries import fleet as entry


def sweep_one(cell, program, seed, B, timed, device):
    inputs = entry.make_inputs(cell.cfg, cell.traffic, seed, device,
                               program, batch=B)
    t = time.perf_counter()
    entry.run_batch(program, inputs, cell.traffic, seed, -1, device)
    warm_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    batches = [entry.run_batch(program, inputs, cell.traffic, seed, k,
                               device)[0] for k in range(timed)]
    elapsed = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device)
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(harness.BATCH_SPAN):
            entry.run_batch(program, inputs, cell.traffic, seed, timed,
                            device)
    T = harness.read_trace(prof)
    lo, hi = T.spans(harness.BATCH_SPAN)[0]
    busy = tr.busy_us(T, lo, hi)
    bd = tr.breakdown(T, lo, hi, top=6, skip=(harness.BATCH_SPAN,))
    return {"batch": B, "windows_per_s": B * timed / elapsed,
            "batch_s": [b.seconds for b in batches],
            "dispatch_s": [b.dispatch_s for b in batches],
            "warm_s": warm_s, "peak_gib": peak / 2 ** 30,
            "traced_s": (hi - lo) * 1e-6, "idle_pct": 100 * (1 - busy / (hi - lo)),
            "kernels": sum(1 for k in T.kernels if lo <= k.ts <= hi),
            "top_ops": bd["device_ops"], "top_gaps": bd["idle_gaps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timed", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda:0")
    if cell.entry.name != "fleet.py":
        ap.error(f"{cell.name} does not run the fleet entry")
    program = entry.Program(cell.cfg)
    program.load_kernel()
    for B in args.batches:
        try:
            row = sweep_one(cell, program, args.seed, B, args.timed,
                            device)
        except torch.cuda.OutOfMemoryError as e:
            row = {"batch": B, "oom": str(e).splitlines()[0]}
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
