"""EKF slip tuning, round 2 (port of the JAX repo's
`evals/diag_ekf_slip2.py`): the foot anchor's random walk in contact (the
process noise that MODELS slip) x the leg-velocity measurement noise, on
diag_ekf_slip's two simulations, with the slip gate at 11.34 and no
force-variance inflation.

  * `VARIANTS` / `variant_cfg`: the six (foot walk, velocity noise) pairs,
    named as the script prints them (`fw0.001_vn0.1`);
  * `diag_ekf_slip.make_sims` and `diag_util.ekf_run`: the simulations and
    the run.

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results. The JAX
script's knob: the duration in seconds as the first positional argument
(default 60). `variants=` of `run` (names) picks a subset.

    python -m cerberus_tpu_torch.evals.diag_ekf_slip2 0.6 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.evals.diag_ekf_slip import make_sims

VARIANTS = [(f"fw{fw:g}_vn{vn:g}", fw, vn)
            for fw in (1e-4, 1e-3, 3e-3) for vn in (5e-2, 0.1)]


def variant_cfg(fw, vn):
    n = dataclasses.replace(EstimatorConfig().noise,
                            ekf_slip_gate_chi2=11.34,
                            ekf_force_var_rescale=0.0,
                            ekf_foot_walk_contact=fw, ekf_meas_vel_n=vn)
    return dataclasses.replace(EstimatorConfig(), noise=n)


def run(dur=60.0, device="cuda", variants=None):
    """{name: {slip: score, clean: score}} over VARIANTS, or those whose
    names are in `variants`."""
    sim_slip, sim_clean = make_sims(dur)
    res = dict(duration=dur, samples=len(sim_slip["t"]))
    for name, fw, vn in VARIANTS:
        if variants and name not in variants:
            continue
        cfg = variant_cfg(fw, vn)
        t0 = time.time()
        m_s = diag_util.ekf_run(cfg, sim_slip, device)
        m_c = diag_util.ekf_run(cfg, sim_clean, device)
        print(f"{name}: slip {m_s['drift_pct']:.3f}% "
              f"ate {m_s['ate_rmse']:.4f} | clean {m_c['drift_pct']:.3f}% "
              f"| {time.time()-t0:.0f}s", flush=True)
        res[name] = dict(slip={k: float(v) for k, v in m_s.items()},
                         clean={k: float(v) for k, v in m_c.items()})
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("duration", nargs="?", type=float, default=60.0)
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = dict(run(args.duration, dev), device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
