"""Self-consistency check of the simulator (port of the JAX repo's
`evals/diag_simcheck.py`): midpoint dead reckoning of the NOISE-FREE IMU
signals must reproduce the true trajectory; leg-odometry velocity from the
true joints must match the true body velocity during stance.

NumPy only: it touches no device, so it has no `--device` (`--out FILE`
writes the results; without it no file is written). The port's simulator
gives the JAX package's sequence bit for bit, so the numbers are the JAX
script's exactly.

    python -m cerberus_tpu_torch.evals.diag_simcheck [--out simcheck.json]
"""

from __future__ import annotations

import argparse

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import (SimConfig, _fk_np, _jac_np,
                                               simulate)
from cerberus_tpu_torch.evals.diag_util import write_out


def qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def qrot(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return R @ v


def make_sim(duration=4.0, speed=0.5, seed=5):
    """The noise-free-contact sequence of the check (no foot slip, no late
    contact) and its EstimatorConfig."""
    est_cfg = EstimatorConfig()
    cfg = SimConfig(duration=duration, speed=speed, seed=seed,
                    foot_slip_sigma=0.0, foot_slip_forward_bias=0.0,
                    late_contact_frac=0.0)
    return simulate(cfg, est_cfg), est_cfg


def dead_reckoning(sim):
    """Midpoint integration of acc_true / gyr_true from the true initial
    state: rows (t, |p err|, |v err|, |q err|) every 500 samples (1 s), and
    the largest |q err| of those rows."""
    t = sim["t"]
    dt = t[1] - t[0]
    g = sim["gravity"]
    acc, gyr = sim["acc_true"], sim["gyr_true"]
    q = sim["q"][0].copy()
    p = sim["p"][0].copy()
    v = sim["v"][0].copy()
    rows, max_qerr = [], 0.0
    for k in range(1, len(t)):
        un_gyr = 0.5 * (gyr[k - 1] + gyr[k])
        th = un_gyr * dt
        dq = np.concatenate([[1.0], th / 2])
        dq /= np.linalg.norm(dq)
        q_new = qmul(q, dq)
        q_new /= np.linalg.norm(q_new)
        a0 = qrot(q, acc[k - 1]) - g
        a1 = qrot(q_new, acc[k]) - g
        a = 0.5 * (a0 + a1)
        p = p + v * dt + 0.5 * a * dt * dt
        v = v + a * dt
        q = q_new
        if k % 500 == 0:
            qe = min(np.linalg.norm(q - sim["q"][k]),
                     np.linalg.norm(q + sim["q"][k]))
            max_qerr = max(max_qerr, qe)
            rows.append(dict(t=float(t[k]),
                             p_err=float(np.linalg.norm(p - sim["p"][k])),
                             v_err=float(np.linalg.norm(v - sim["v"][k])),
                             q_err=float(qe)))
    return rows, float(max_qerr)


def leg_velocity_errors(sim, est_cfg):
    """|v_leg - v_body| of every stance leg every 50 samples: the
    body velocity from the true joint angles and rates through the leg's
    forward kinematics and Jacobian."""
    robot = est_cfg.robot
    rho_fix = robot.rho_fix()
    R_br = np.asarray(robot.R_br, float)
    p_br = np.asarray(robot.p_br, float)
    errs = []
    for k in range(0, len(sim["t"]), 50):
        Rk = sim["R"][k]
        w = sim["gyr_true"][k]
        for j in range(4):
            if sim["contacts"][k, j] < 0.5:
                continue
            phi = sim["phi_true"][k, 3 * j:3 * j + 3]
            dphi = sim["dphi_true"][k, 3 * j:3 * j + 3]
            fk = _fk_np(phi, sim["rho"][j], rho_fix[j])
            J = _jac_np(phi, sim["rho"][j], rho_fix[j])
            v_leg = -R_br @ J @ dphi - np.cross(w, p_br + R_br @ fk)
            v_body_true = Rk.T @ sim["v"][k]
            errs.append(np.linalg.norm(v_leg - v_body_true))
    return np.array(errs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the results to this JSON file")
    args = ap.parse_args(argv)
    sim, est_cfg = make_sim()
    rows, max_qerr = dead_reckoning(sim)
    for r in rows:
        print(f"t={r['t']:.1f} |p_err|={r['p_err']:.5f} "
              f"|v_err|={r['v_err']:.5f} |q_err|={r['q_err']:.6f}")
    errs = leg_velocity_errors(sim, est_cfg)
    leg = dict(med=float(np.median(errs)),
               p90=float(np.percentile(errs, 90)), max=float(errs.max()),
               n=len(errs))
    print(f"leg-odom velocity err: med={leg['med']:.5f} "
          f"p90={leg['p90']:.5f} max={leg['max']:.5f}")
    res = dict(dead_reckoning=rows, max_q_err=max_qerr, leg_odom_vel_err=leg)
    write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
