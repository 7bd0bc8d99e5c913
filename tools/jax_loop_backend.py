#!/usr/bin/env python3
"""The JAX package's loop back-end on the street keyframe stream, on the CPU,
with the port's (on the CPU too) beside it: the reference numbers for
chip_smoke.py's `loop back-end street` phase.

    python3 tools/jax_loop_backend.py [--budget-s 300] [--keyframes 889]

The stream is chip_smoke.StreetStream: the street circuit of
`evals/long_run.py --loop` (SimConfig(path="street", speed=0.75, seed=77)),
keyframes 0.27 m apart, rendered 640x480 left images, odometry with a
seeded random walk. The JAX package's LoopCloser (defaults: a 512-node pool,
2,048 padded edges, optimized by its one-hot assembly) takes keyframes
until `--budget-s` seconds have passed or `--keyframes` are in, then
finish(); the port's LoopCloser (device="cpu") takes the same keyframes.
Prints one JSON line: for each package loops found and rejected, sequence
gating, rollbacks, pruned edges, optimizes, nodes, corrected and odometric
keyframe ATE (`score` after 4-DoF alignment) and wall seconds; and whether
every count is equal. Needs JAX (forced onto the CPU, x64).
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cerberus_tpu.data.replay import score  # noqa: E402
from cerberus_tpu.loop.closer import LoopCloser as JaxCloser  # noqa: E402
from chip_smoke import STREET_KEYFRAMES, StreetStream  # noqa: E402
from cerberus_tpu_torch.loop.closer import LoopCloser as PortCloser  # noqa: E402

COUNTS = ("loops_found", "loops_rejected", "seq_gated", "kf_skipped",
          "rollbacks", "pruned_edges", "optimizes", "nodes", "Nc")


def run(closer, records, truth, budget_s=None):
    """Feed records (stopping once budget_s has passed), then finish().
    Returns (numbers, keyframes fed)."""
    t0 = time.perf_counter()
    fed, kept = 0, []
    for k, rec in enumerate(records):
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            break
        if closer.add_keyframe(*rec) >= 0:
            kept.append(k)
        fed += 1
    closer.finish()
    wall = time.perf_counter() - t0
    pg = closer.pg
    gt = truth[kept]
    c, o = score(closer.corrected(), gt), score(closer.odometric(), gt)
    nums = dict(loops_found=closer.loops_found,
                loops_rejected=closer.loops_rejected,
                seq_gated=closer.seq_gated, kf_skipped=closer.kf_skipped,
                nodes=pg.n, Nc=pg.Nc, best_sim=closer.best_sim, **pg.stats,
                corrected_ate_m=c["ate_rmse"], odometric_ate_m=o["ate_rmse"],
                corrected_drift_pct=c["drift_pct"],
                odometric_drift_pct=o["drift_pct"], wall_s=wall)
    return nums, fed, closer.corrected()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget-s", type=float, default=300.0,
                    help="seconds of the JAX package's run (then finish())")
    ap.add_argument("--keyframes", type=int, default=STREET_KEYFRAMES)
    args = ap.parse_args()
    assert jax.devices()[0].platform == "cpu"
    stream = StreetStream(STREET_KEYFRAMES)
    records = []

    def recorded():
        for k in range(args.keyframes):
            records.append(stream.record(k))
            yield records[-1]

    jax_nums, fed, jax_p = run(JaxCloser(), recorded(), stream.truth,
                               args.budget_s)
    port_nums, _, port_p = run(PortCloser(device="cpu"), records[:fed],
                               stream.truth)
    print(json.dumps(dict(
        keyframes=fed, of=STREET_KEYFRAMES, jax=jax_nums, port=port_nums,
        counts_equal=all(jax_nums[k] == port_nums[k] for k in COUNTS),
        max_abs_dp_corrected_m=float(np.abs(jax_p - port_p).max()),
        platform="cpu", x64=True)))


if __name__ == "__main__":
    main()
