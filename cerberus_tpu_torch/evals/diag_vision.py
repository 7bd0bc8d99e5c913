"""Full-VILO accuracy against the truth (port of the JAX repo's
`evals/diag_vision.py`): the streaming estimator fed its first camera
frames, each NON_LINEAR solve's result compared with the truth, and the
final window's cost at the estimate against its cost at the truth: does
the solver's cost prefer the truth (a model mismatch) or the estimate
(noise-optimal)? With vision, then without (no features).

  * `run`: the feed. An estimator with `debug` on (its `last_debug`
    entry cost breakdown) fed every IMU sample and the first `max_frames`
    camera frames (`diag_util.feed`), `record` called after each frame;
  * `record`: one NON_LINEAR frame's row (window position error, cost0 /
    cost / accepted, the debug entry / exit breakdown, rho, bg, the
    extrinsic drift, the median inverse-depth error);
  * `cost_at_truth`: the final window's robust cost and its (ileg, proj,
    prior) split at the estimate and at the aligned truth
    (`window_residuals`' rows: 310 ileg, 44 F projection, then the
    marginalization and calibration priors).

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results. The JAX
script's knobs: `DIAG_DUR` (simulated seconds, default 3.0) and
`DIAG_FRAMES` (camera frames fed, default 20).

    DIAG_FRAMES=14 python -m cerberus_tpu_torch.evals.diag_vision \
        [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator, _quat_to_rot_np
from cerberus_tpu_torch.evals import diag_util


def record(est, sim, k, vision=True):
    """The row of camera sample k once the estimator is NON_LINEAR, else
    None."""
    if est.solver_flag != Estimator.NON_LINEAR:
        return None
    t = sim["t"]
    errs = []
    for i in range(11):
        ki = int(round(est.headers[i] * diag_util.IMU_HZ))
        if ki < len(t):
            errs.append(np.linalg.norm(est.p[i] - sim["p"][ki]))
    info = getattr(est, "last_info", None)
    rec = dict(t=t[k], newest_err=errs[-1], mean_err=np.mean(errs),
               cost0=float(info.cost0) if info else np.nan,
               cost=float(info.cost) if info else np.nan,
               accepted=int(info.accepted) if info else -1)
    dbg = getattr(est, "last_debug", None)
    if dbg:
        rec["entry"] = tuple(round(x, 1) for x in dbg["entry"])
        if "exit" in dbg:
            rec["exit"] = tuple(round(x, 1) for x in dbg["exit"])
    rec["rho"] = tuple(np.round(est.rho[10], 4))
    rec["bg"] = tuple(np.round(est.bg[10], 4))
    ric0, tic0 = est.cfg.ric_tic()
    rec["ex_deg"] = round(float(np.degrees(np.arccos(np.clip(
        (np.trace(_quat_to_rot_np(est.qic[0]) @ ric0[0].T) - 1) / 2,
        -1, 1)))), 3)
    rec["ex_dt"] = round(float(np.linalg.norm(est.tic[0] - tic0[0])), 4)
    if vision:
        ric, tic = est.cfg.ric_tic()
        lm = sim["landmarks"]
        derr = []
        for s in np.nonzero(est.fm.active)[0]:
            if est.fm.depth[s] <= 0:
                continue
            sf = int(est.fm.start[s])
            ki_anchor = int(round(est.headers[sf] * diag_util.IMU_HZ))
            if ki_anchor >= len(t):
                continue
            lid = int(est.fm.ids[s])
            Rw = sim["R"][ki_anchor] @ ric[0]
            tw = sim["R"][ki_anchor] @ tic[0] + sim["p"][ki_anchor]
            z_true = (Rw.T @ (lm[lid] - tw))[2]
            if z_true > 0.1:
                derr.append(abs(1 / est.fm.depth[s] - z_true))
        rec["depth_err_med"] = float(np.median(derr)) if derr else np.nan
        rec["n_depths"] = len(derr)
    return rec


def run(vision=True, duration=3.0, seed=5, speed=0.5, max_frames=20,
        device="cuda", cfg=None, sim=None):
    """(estimator, simulation, rows): a new f64 estimator with `debug` on,
    fed the first `max_frames` camera frames of the simulation (made from
    duration, seed and speed unless given), features withheld when
    `vision` is False."""
    if sim is None:
        sim = simulate(SimConfig(duration=duration, speed=speed, seed=seed))
    est = Estimator(cfg or EstimatorConfig(), dtype=torch.float64,
                    device=device)
    est.debug = True
    records = []

    def on_frame(k):
        rec = record(est, sim, k, vision)
        if rec is not None:
            records.append(rec)

    diag_util.feed(est, sim, max_frames, vision=vision, on_frame=on_frame)
    return est, sim, records


def cost_at_truth(est, sim):
    """((cost at the estimate, (ileg, proj, prior)), (cost at the aligned
    truth, (ileg, proj, prior))) of the current window."""
    data, feats, slots, depths = est._pack()
    st_est = est._window_state(est.fm.depth_vector(slots))
    st_tru, _, _ = diag_util.truth_state(est, sim, slots)
    F = est.F
    s = 310 + F * 44

    def breakdown(r):
        return (float(np.sum(r[:310] ** 2)) / 2,
                float(np.sum(r[310:s] ** 2)) / 2,
                float(np.sum(r[s:] ** 2)) / 2)

    r_est, c_est = diag_util.residuals_at(st_est, data, F)
    r_tru, c_tru = diag_util.residuals_at(st_tru, data, F)
    return (c_est, breakdown(r_est)), (c_tru, breakdown(r_tru))


def print_rows(recs):
    for r in recs:
        print({k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dur = float(os.environ.get("DIAG_DUR", "3.0"))
    nframes = int(os.environ.get("DIAG_FRAMES", "20"))
    print("=== vision ON ===")
    est, sim, recs = run(vision=True, duration=dur, max_frames=nframes,
                         device=dev)
    print_rows(recs)
    (ce, be), (ct, bt) = cost_at_truth(est, sim)
    print(f"final window: cost(est)={ce:.3f} [ileg={be[0]:.2f} "
          f"proj={be[1]:.2f} prior={be[2]:.2f}]")
    print(f"              cost(tru)={ct:.3f} [ileg={bt[0]:.2f} "
          f"proj={bt[1]:.2f} prior={bt[2]:.2f}]")
    print("=== vision OFF ===")
    _, _, recs2 = run(vision=False, duration=dur, max_frames=nframes,
                      device=dev)
    print_rows(recs2)
    res = dict(vision_on=recs, vision_off=recs2,
               cost_est=dict(cost=ce, ileg=be[0], proj=be[1], prior=be[2]),
               cost_tru=dict(cost=ct, ileg=bt[0], proj=bt[1], prior=bt[2]),
               duration=dur, frames=nframes, device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
