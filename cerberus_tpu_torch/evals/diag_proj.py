"""The projection model at the truth (port of the JAX repo's
`evals/diag_proj.py`): (a) a perfect-association window evaluated at the
exact truth (the model's consistency), (b) the streaming estimator's final
window after its first 20 camera frames, evaluated at the truth aligned to
the estimate's frame 0, with the projection cost broken down per feature,
per anchor frame, and into mono and stereo rms in pixels.

  * `perfect_assoc`: (a), `_proj_residuals` of `build_window_from_sim`'s
    window (kf_stride=1, start_cam=2) at its truth;
  * `drive`: the estimator fed every IMU sample and the first `max_frames`
    camera frames (`diag_util.feed`);
  * `final_window`: (b), from the estimator's state and the simulation.

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results.

    python -m cerberus_tpu_torch.evals.diag_proj [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cerberus_tpu_torch.config import MAX_FEATURES, EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.ops import factors as fac

PX = 1.5   # normalized residual -> px (sqrt information 460 / 1.5)


def make_sim(duration=3.0, speed=0.5, seed=5):
    return simulate(SimConfig(duration=duration, speed=speed, seed=seed))


def perfect_assoc(sim, cfg=None, device="cuda", F=MAX_FEATURES):
    """(a): proj cost, nonzero rows and rms px at the exact truth of the
    window's F feature slots."""
    data, truth, _ = build_window_from_sim(sim, cfg or EstimatorConfig(),
                                           kf_stride=1, start_cam=2, F=F,
                                           dtype=torch.float64,
                                           device=device)
    r = fac._proj_residuals(truth, data).cpu().numpy()  # (F, 11, 4)
    n_rows = int((np.abs(r) > 0).sum())
    return dict(cost=float(0.5 * (r ** 2).sum()), n_rows=n_rows,
                rms_px=float(np.sqrt((r ** 2).sum() / max(n_rows, 1)) * PX))


def drive(sim, cfg=None, device="cuda", max_frames=20):
    """A new f64 estimator fed the first `max_frames` camera frames."""
    est = Estimator(cfg or EstimatorConfig(), dtype=torch.float64,
                    device=device)
    diag_util.feed(est, sim, max_frames)
    return est


def final_window(est, sim):
    """(b): the projection cost of each window feature at aligned truth
    (true inverse depths), the 12 costliest, the sums per anchor frame, and
    the mono / stereo rms px."""
    data, feats, slots, depths = est._pack()
    st_tru, d_true, _ = diag_util.truth_state(est, sim, slots)
    r = fac._proj_residuals(st_tru, data).cpu().numpy()[: len(slots)]
    per_feat = 0.5 * (r ** 2).sum(axis=(1, 2))
    starts = est.fm.start[slots]
    obs_counts = est.fm.obs[slots].sum(axis=1)
    order = np.argsort(-per_feat)
    rows = [dict(slot=int(slots[n]), cost=float(per_feat[n]),
                 start=int(starts[n]), nobs=int(obs_counts[n]),
                 d_est=float(est.fm.depth[slots[n]]), d_tru=float(d_true[n]))
            for n in order[:12]]
    anchors = {sf: dict(n=int((starts == sf).sum()),
                        cost_sum=float(per_feat[starts == sf].sum()))
               for sf in range(11) if (starts == sf).sum()}
    rms = lambda x: float(np.sqrt((x ** 2).sum()
                                  / max((np.abs(x) > 0).sum(), 1)) * PX)
    return dict(total=float(per_feat.sum()), n_features=len(slots),
                worst=rows, anchors=anchors, rms_mono_px=rms(r[:, :, 0:2]),
                rms_stereo_px=rms(r[:, :, 2:4]), per_feature=per_feat)


def print_final_window(b):
    print("(b) streaming final window @ aligned truth: total proj cost",
          b["total"])
    print("worst 12 features: [cost, anchor_frame, n_obs, inv_depth_est, "
          "inv_depth_true]")
    for w in b["worst"]:
        print(f"  slot={w['slot']} cost={w['cost']:9.2f} start={w['start']} "
              f"nobs={w['nobs']} d_est={w['d_est']:.4f} "
              f"d_tru={w['d_tru']:.4f}")
    for sf, a in b["anchors"].items():
        print(f"anchor={sf}: n={a['n']} cost_sum={a['cost_sum']:10.2f}")
    print(f"rms mono px={b['rms_mono_px']:.3f} "
          f"stereo px={b['rms_stereo_px']:.3f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sim = make_sim()
    a = perfect_assoc(sim, device=dev)
    print(f"(a) perfect assoc @ truth: proj cost={a['cost']:.1f} over "
          f"{a['n_rows']} nonzero rows, rms_px={a['rms_px']:.3f}")
    b = final_window(drive(sim, device=dev), sim)
    print_final_window(b)
    res = dict(perfect_assoc=a, final_window=b, device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
