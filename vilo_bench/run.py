"""Run one cell of the benchmark once and print its result line.

    python3 -m vilo_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics. The last
line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and last
`checks`: each number compared beside its limit); the last lines of
standard error repeat the checks. The cell's configuration names the entry
that runs its requests (`entries/`, see `harness.py`); one that is not
there raises before anything starts. Exits non-zero, printing no result, when
there is no CUDA device or fewer than the cell asks for, or when the
process holds the JAX package or JAX once the window has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from vilo_bench import scene, spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    # the segments are simulated by worker processes while this one
    # imports torch and the program; they import this module again, so its
    # top imports nothing heavy
    simulation = scene.Simulation(cell.cfg, cell.traffic, args.seed)
    try:
        import torch

        from vilo_bench import harness
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_dev < cell.chips:
            harness.log(f"needs {cell.chips} CUDA device(s); found {n_dev}")
            return 2
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START,
                                  simulation=simulation)
    finally:
        simulation.close()
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the process holds forbidden modules: {found}")
        return 3
    for name, c in result["checks"].items():
        if isinstance(c, dict):
            harness.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    harness.log(f"correct = {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
