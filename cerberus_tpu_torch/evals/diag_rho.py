"""Single-window calf-length (rho) observability check (port of the JAX
repo's `evals/diag_rho.py`): simulate with a true calf length of 0.215 m,
preintegrate and linearize at 0.21, solve one window with rho free, and see
whether rho moves toward the truth. Also checks the accumulated
preintegration Jacobian's d(eps)/d(rho) column against a forward finite
difference.

  * part 1 (`fd_check`): one 200-sample interval through `il_preintegrate`
    at rho = 0.21 and 0.21 + 1e-5;
  * part 2 (`window_solve`): `build_window_from_sim(kf_stride=3,
    start_cam=6)` at F = MAX_FEATURES, then `solve_window` of 30 LM
    iterations from rho = 0.21 with perturbed positions and speeds and zero
    biases: on the card, one f64 lane-Cholesky launch at (1, 222) per
    iteration.

f64 on the card unless `--device cpu` is given; with no card and no
`--device cpu` it raises. `--out FILE` writes the results.

    python -m cerberus_tpu_torch.evals.diag_rho [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals.diag_util import add_device, write_out
from cerberus_tpu_torch.ops.preintegration import (PreintParams,
                                                   il_preintegrate)
from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window

TRUE_LEN = 0.215
NOM_LEN = 0.21
FD_EPS = 1e-5   # forward-difference step in rho (m)


def configs():
    """(nominal config: calf 0.21, true config: calf 0.215)."""
    cfg_nom = EstimatorConfig()
    robot_true = dataclasses.replace(cfg_nom.robot, lower_leg_length=TRUE_LEN)
    return cfg_nom, EstimatorConfig(robot=robot_true)


def make_sim(duration=8.0, speed=0.5, seed=24):
    return simulate(SimConfig(duration=duration, speed=speed, seed=seed),
                    configs()[1])


def fd_check(sim, device="cuda"):
    """J[ILO_EPS + 3j, ILO_RHO + j] (the analytic d(eps_j)/d(rho_j)) and its
    forward difference over samples 0..200, the legs' displacement at 0.21
    and 0.215, and the true body displacement in the start frame."""
    dev = resolve_device(device)
    s, e = 0, 200
    params = PreintParams.from_config(configs()[0], torch.float64,
                                      device=dev)
    sl = slice(s, e + 1)
    n = e - s + 1
    dt = np.full(n, 1 / 500)
    mask = np.ones(n, bool)
    mask[0] = False
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=dev)
    zero = torch.zeros(3, dtype=torch.float64, device=dev)

    def preint_at(rho_val):
        rho = torch.full((4,), rho_val, dtype=torch.float64, device=dev)
        return il_preintegrate(f(dt), f(sim["acc"][sl]), f(sim["gyr"][sl]),
                               f(sim["phi"][sl]), f(sim["dphi"][sl]),
                               f(sim["contacts"][sl]),
                               torch.as_tensor(mask, device=dev), zero, zero,
                               rho, params)

    p0 = preint_at(NOM_LEN)
    p1 = preint_at(NOM_LEN + FD_EPS)
    deps0 = p0.deps.cpu().numpy()
    fd = (p1.deps.cpu().numpy() - deps0) / FD_EPS  # (4, 3)
    J = p0.J.cpu().numpy()
    Jcol = np.stack([J[C.ILO_EPS + 3 * j:C.ILO_EPS + 3 * j + 3,
                       C.ILO_RHO + j] for j in range(4)])
    return dict(J_col=Jcol, fd=fd, deps_nom=deps0,
                deps_true=preint_at(TRUE_LEN).deps.cpu().numpy(),
                truth=sim["R"][s].T @ (sim["p"][e] - sim["p"][s]))


def window_solve(sim, device="cuda", max_iters=30, F=C.MAX_FEATURES):
    """One window solve with rho free from 0.21 (truth: 0.215): cost0,
    cost, accepted steps, frame 5's rho and its error in mm, and every
    frame's position error."""
    data, truth, _ = build_window_from_sim(sim, configs()[0], kf_stride=3,
                                           start_cam=6, F=F,
                                           dtype=torch.float64,
                                           device=device)
    dev, dt = truth.p.device, truth.p.dtype
    # the window builder linearizes at the nominal calf; the truth is 0.215
    truth = truth._replace(rho=torch.full((11, 4), TRUE_LEN, dtype=dt,
                                          device=dev))
    rng = np.random.default_rng(0)
    a = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    init = truth._replace(
        rho=torch.full((11, 4), NOM_LEN, dtype=dt, device=dev),
        p=truth.p + a(rng.normal(size=(11, 3)) * 0.01),
        v=truth.v + a(rng.normal(size=(11, 3)) * 0.02),
        ba=torch.zeros_like(truth.ba), bg=torch.zeros_like(truth.bg))
    st, info = solve_window(init, data, SolveOptions(max_iters=max_iters))
    rho5 = st.rho[5].cpu().numpy()
    return dict(cost0=float(info.cost0), cost=float(info.cost),
                accepted=int(info.accepted), rho_frame5=rho5,
                rho_err_mm=(rho5 - TRUE_LEN) * 1000,
                pos_err=np.linalg.norm(st.p.cpu().numpy()
                                       - truth.p.cpu().numpy(), axis=1),
                iters=max_iters)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sim = make_sim()
    fd = fd_check(sim, dev)
    for j in range(4):
        print(f"leg {j}: J d(eps)/d(rho) = {fd['J_col'][j]}, "
              f"FD = {fd['fd'][j]}")
    print("deps@0.21 :", fd["deps_nom"])
    print("deps@0.215:", fd["deps_true"])
    print("truth     :", fd["truth"])
    sol = window_solve(sim, dev)
    print("cost0 -> cost:", sol["cost0"], sol["cost"], "accepted",
          sol["accepted"])
    print("rho solved (frame 5):", sol["rho_frame5"])
    print("rho err mm:", sol["rho_err_mm"])
    print("pos err:", sol["pos_err"])
    res = dict(fd_check=fd, window_solve=sol, device=dev.type)
    write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
