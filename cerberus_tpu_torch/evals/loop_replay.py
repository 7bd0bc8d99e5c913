"""Offline loop-back-end replay (port of the JAX repo's
`evals/loop_replay.py`): re-run the LoopCloser over a recorded keyframe
stream (`long_run --loop-record`) under different weighting and gating,
scoring corrected against odometric ATE on ground truth — a parameter
sweep in seconds instead of an estimator run each.

The records are plain NumPy, so a stream pickled by either package's
`LoopCloser(record=True)` replays here. The pose graph optimizes on the
card unless `--device cpu` is given.

    python -m cerberus_tpu_torch.evals.loop_replay RECORDS.pkl \
        --duration 470 --path street --speed 0.75 --seed 77 [--sweep] \
        [--out LOOP_SWEEP.json]

The sim arguments must match the run that produced the records (ground
truth is regenerated from the seed).
"""

from __future__ import annotations

import argparse
import json
import pickle
import time

import numpy as np

from cerberus_tpu_torch.data.replay import score
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.loop.closer import LoopCloser

# (name, LoopCloser keywords) of --sweep; the first alone without it
VARIANTS = [
    ("default", {}),
    ("loop_w5", dict(loop_weight=5.0)),
    ("loop_w2", dict(loop_weight=2.0)),
    ("loop_w1", dict(loop_weight=1.0)),
    ("seq300_loop5", dict(seq_weight=300.0, loop_weight=5.0)),
    ("seq300_loop2", dict(seq_weight=300.0, loop_weight=2.0)),
    ("huber", dict(robust_kind="huber")),
    ("huber_loop2", dict(robust_kind="huber", loop_weight=2.0)),
    ("min_matches20", dict(min_matches=20)),
    ("min_matches20_loop2", dict(min_matches=20, loop_weight=2.0)),
    ("strongsim", dict(min_sim=0.7)),
]


def run_variant(records, gt_of_t, device="cuda", **kw):
    """The records through a LoopCloser(**kw) on `device`, scored against
    gt_of_t(keyframe times)."""
    closer = LoopCloser(device=device, **kw)
    for rec in records:
        closer.add_keyframe_precomputed(rec)
    closer.finish()
    gt = gt_of_t(closer.times())
    m_c = score(closer.corrected(), gt)
    m_o = score(closer.odometric(), gt)
    return dict(loops=closer.loops_found, rejected=closer.loops_rejected,
                rollbacks=closer.pg.stats["rollbacks"],
                pruned=closer.pg.stats["pruned_edges"],
                nodes=closer.pg.n,
                corrected_ate=round(m_c["ate_rmse"], 4),
                corrected_drift=round(m_c["drift_pct"], 4),
                odometric_ate=round(m_o["ate_rmse"], 4),
                odometric_drift=round(m_o["drift_pct"], 4))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("records")
    ap.add_argument("--duration", type=float, required=True)
    ap.add_argument("--path", default="street")
    ap.add_argument("--speed", type=float, default=0.75)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pose graph optimizes; no fallback when "
                         "the card is missing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with open(args.records, "rb") as f:
        records = pickle.load(f)
    print(f"{len(records)} keyframe records", flush=True)

    sim = simulate(SimConfig(duration=args.duration, speed=args.speed,
                             path=args.path, seed=args.seed))

    def gt_of_t(ts):
        return np.column_stack([np.interp(ts, sim["t"], sim["p"][:, i])
                                for i in range(3)])

    results = {}
    for name, kw in (VARIANTS if args.sweep else VARIANTS[:1]):
        t0 = time.time()
        r = run_variant(records, gt_of_t, device=dev, **kw)
        r["wall_s"] = round(time.time() - t0, 1)
        results[name] = r
        print(name, json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
