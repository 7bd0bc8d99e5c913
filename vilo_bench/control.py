"""The readings that the limits of `correct` are set from, at a cell's own
size on the card: the program's gaps to the plain reference over many
seeds (the lower readings), and the control's over a few (the upper
readings). The control is the program with the next lower precision
switched on: TF32 matmuls (`gemm_precision="high"`) for a float32
configuration, the whole solve in float32 for a float64 one. Each seed
runs `--batches` closed-loop batches, as many as a run's window holds,
and compares as many windows as a run does, against the reference in each
type of `--references` (those the cell's limits name, unless given): every
number `harness.checked_numbers` makes. One JSON line per seed.

    python3 -m vilo_bench.control --workload fleet-f32-dense --seeds 1 2 3 --control-seeds 4 5 6

The benchmark's runs do not call it."""

import argparse
import json
import sys


def control_solve(program, cfg):
    """The program's fleet step in the precision below the configuration's:
    (states, cost0, cost) in the configuration's dtype."""
    import torch

    from vilo_bench import harness
    if cfg["dtype"] == "float32":
        def solve(st, datas, truths):
            out, info = program.solve_window_batched(
                st, datas, program.opts, gemm_precision="high")
            return out, info.cost0, info.cost
        return solve
    f32 = lambda t: harness.to_device(t, torch.float32, t[0].device)
    cache = {}

    def solve(st, datas, truths):
        if cache.get("key") is not datas:
            cache.update(key=datas, d32=f32(datas))
        out, cost0, cost = program.solve(f32(st), cache["d32"], f32(truths))
        up = lambda x: x.to(torch.float64)
        return (program.state(harness.ffac.map_tensors(up, out)), up(cost0),
                up(cost))
    return solve


def main(argv=None) -> int:
    import torch

    from vilo_bench import harness, spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--references", nargs="+",
                    choices=sorted(harness.REFERENCES),
                    help="default: those the cell's limits name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = spec.load_cell(args.workload)
    refs = args.references or harness.references(cell.traffic["limits"])
    device = torch.device("cuda:0")
    program = harness.Program(cell.cfg)
    program.load_kernel()
    ctl = control_solve(program, cell.cfg)
    runs = [(s, "program", None) for s in args.seeds] + \
        [(s, "control", ctl) for s in args.control_seeds]
    for seed, kind, solve in runs:
        inputs = harness.make_inputs(cell.cfg, cell.traffic, seed, device,
                                     program)
        harness.run_batch(program, inputs, cell.traffic, seed, -1, device,
                          solve)
        batches, bad = [], []
        for k in range(args.batches):
            b, nb = harness.run_batch(program, inputs, cell.traffic, seed, k,
                                      device, solve)
            batches.append(b)
            bad.append(int(nb))
        inputs = inputs._replace(datas=None)
        torch.cuda.empty_cache()
        row = {"workload": cell.name, "seed": seed, "kind": kind,
               "failed": sum(bad), "batch_s": [b.seconds for b in batches]}
        row["windows"] = sum(b.rows.numel() for b in batches)
        row["numbers"] = harness.checked_numbers(cell.cfg, batches, inputs,
                                                 seed, device, refs)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
