"""The readings that the limits of `correct` are set from, at a cell's own
size on the card: the program's gaps to the plain reference over many
seeds (the lower readings), and the control's over a few (the upper
readings). The control is the program with the next lower precision
switched on: TF32 matmuls (`gemm_precision="high"`) for a float32
configuration, the whole solve in float32 for a float64 one. Each seed
runs `--batches` closed-loop batches, as many as a run's window holds,
and compares as many windows as a run does, against the reference in each
type of `--references` (those the cell's limits name, unless given): every
number the fleet entry's `checked_numbers` makes (`entries/fleet.py`, which
every cell runs through). One JSON line per seed.

    python3 -m vilo_bench.control --workload fleet-f32-dense --seeds 1 2 3 --control-seeds 4 5 6

The benchmark's runs do not call it."""

import argparse
import gc
import json
import sys


def control_solve(entry, program, cfg):
    """The program's fleet step in the precision below the configuration's:
    (states, cost0, cost) in the configuration's dtype."""
    import torch

    if cfg["dtype"] == "float32":
        def solve(st, datas, truths):
            out, info = program.solve_window_batched(
                st, datas, program.opts, gemm_precision="high")
            return out, info.cost0, info.cost
        return solve
    f32 = lambda t: entry.to_device(t, torch.float32, t[0].device)

    def solve(st, datas, truths):
        # `datas` come in float32 (see `main`); a cast of them is no copy
        out, cost0, cost = program.solve(f32(st), f32(datas), f32(truths))
        up = lambda x: x.to(torch.float64)
        return (program.state(entry.ffac.map_tensors(up, out)), up(cost0),
                up(cost))
    return solve


def main(argv=None) -> int:
    import torch

    from vilo_bench import harness, spec
    from vilo_bench.entries import fleet as entry
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--references", nargs="+",
                    choices=sorted(entry.REFERENCES),
                    help="default: those the cell's limits name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = spec.load_cell(args.workload)
    if cell.entry.name != "fleet.py":
        ap.error(f"{cell.name} does not run the fleet entry")
    refs = args.references or harness.references(cell.traffic["limits"])
    device = torch.device("cuda:0")
    program = entry.Program(cell.cfg)
    program.load_kernel()
    ctl = control_solve(entry, program, cell.cfg)
    runs = [(s, "program", None) for s in args.seeds] + \
        [(s, "control", ctl) for s in args.control_seeds]
    for seed, kind, solve in runs:
        # a fresh allocator for each seed, as a run's process has: what
        # came before (other seeds, other callers) holds no segment
        gc.collect()
        torch.cuda.empty_cache()
        inputs = entry.make_inputs(cell.cfg, cell.traffic, seed, device,
                                   program)
        if solve is not None and cell.cfg["dtype"] == "float64":
            # the control solves in float32: hold the batch in float32 alone
            inputs = inputs._replace(datas=entry.to_device(
                inputs.datas, torch.float32, device))
        entry.run_batch(program, inputs, cell.traffic, seed, -1, device,
                        solve)
        batches, bad = [], []
        for k in range(args.batches):
            b, nb = entry.run_batch(program, inputs, cell.traffic, seed, k,
                                    device, solve)
            batches.append(b)
            bad.append(int(nb))
        inputs = inputs._replace(datas=None)
        torch.cuda.empty_cache()
        row = {"workload": cell.name, "seed": seed, "kind": kind,
               "failed": sum(bad), "batch_s": [b.seconds for b in batches]}
        row["windows"] = sum(b.rows.numel() for b in batches)
        row["numbers"] = entry.checked_numbers(cell.cfg, batches, inputs,
                                               seed, device, refs)
        print(json.dumps(row), flush=True)
        del inputs, batches
    return 0


if __name__ == "__main__":
    sys.exit(main())
