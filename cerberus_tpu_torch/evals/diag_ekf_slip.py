"""EKF contact / slip model A/B (port of the JAX repo's
`evals/diag_ekf_slip.py`): the legged EKF's drift on the slip-realistic
and the slip-free simulations (config 1, seed 21, 0.4 m/s) for
combinations of the slip-innovation gate (chi^2) and the foot-force
variance inflation.

  * `make_sims`: the two simulations;
  * `variant_cfg`: the EstimatorConfig of one (gate, variance) variant;
  * `run`: the variants, each through `diag_util.ekf_run` on both (the
    run and its score: LeggedEKF with a 4-sample filter window over
    every sample, positions scored in the plane).

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results. The JAX
script's knobs: the duration in seconds as the first positional argument
(default 60), and `EKF_VARIANTS` (comma-separated names; default all six).

    EKF_VARIANTS=gate11_var25 python -m \
        cerberus_tpu_torch.evals.diag_ekf_slip 0.6 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals import diag_util

VARIANTS_ALL = [("gate0_var0", 0.0, 0.0), ("gate11_var0", 11.34, 0.0),
                ("gate0_var25", 0.0, 25.0), ("gate11_var25", 11.34, 25.0),
                ("gate5_var25", 5.0, 25.0), ("gate20_var100", 20.0, 100.0)]


def make_sims(dur=60.0):
    """(slip-realistic simulation, the same without foot slip)."""
    sim_slip = simulate(SimConfig(duration=dur, speed=0.4, seed=21))
    sim_clean = simulate(SimConfig(duration=dur, speed=0.4, seed=21,
                                   foot_slip_sigma=0.0,
                                   foot_slip_forward_bias=0.0))
    return sim_slip, sim_clean


def variant_cfg(gate, var):
    n = dataclasses.replace(EstimatorConfig().noise, ekf_slip_gate_chi2=gate,
                            ekf_force_var_rescale=var)
    return dataclasses.replace(EstimatorConfig(), noise=n)


def run(dur=60.0, device="cuda", variants=None):
    """{name: {slip: score, clean: score}} over the variants named in
    `variants` (comma-separated; default: `EKF_VARIANTS`, else all six)."""
    names = os.environ.get("EKF_VARIANTS") if variants is None else variants
    sim_slip, sim_clean = make_sims(dur)
    res = dict(duration=dur, samples=len(sim_slip["t"]))
    for name, gate, var in VARIANTS_ALL:
        if names and name not in names.split(","):
            continue
        cfg = variant_cfg(gate, var)
        t0 = time.time()
        m_s = diag_util.ekf_run(cfg, sim_slip, device)
        m_c = diag_util.ekf_run(cfg, sim_clean, device)
        print(f"{name}: slip {m_s['drift_pct']:.3f}% ate "
              f"{m_s['ate_rmse']:.4f} | clean {m_c['drift_pct']:.3f}% | "
              f"{time.time()-t0:.0f}s", flush=True)
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
