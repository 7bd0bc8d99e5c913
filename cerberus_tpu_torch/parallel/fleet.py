"""Fleet-scale batched VILO: many windows solved per step (port of
`cerberus_tpu/parallel/fleet.py`).

BASELINE.json config 5 ('Pod-scale batched VILO: thousands of perturbed
windows'): build a batch of window problems from trajectory segments and
Monte-Carlo perturbations (initial-state noise, calibration perturbations)
and solve them all in one batched step — on a card, one launch of the f32
lane-Cholesky kernel per LM iteration for the whole batch. Used for
throughput benchmarking, covariance studies and calibration sensitivity
sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.solver import SolveOptions
from cerberus_tpu_torch.parallel.batched import batched_solve
from cerberus_tpu_torch.utils import lie


class FleetResult(NamedTuple):
    states: fac.WindowState       # (B, ...) solved
    cost0: torch.Tensor           # (B,)
    cost: torch.Tensor            # (B,)
    traj_err: torch.Tensor        # (B,) max aligned trajectory error vs truth


def build_fleet(n_segments: int = 4, n_perturb: int = 8, seed: int = 0,
                cfg: EstimatorConfig | None = None, F: int = 96,
                dtype=torch.float32, sim_duration: float = 12.0,
                p_sigma: float = 0.03, v_sigma: float = 0.05,
                rho_sigma: float = 0.003, device="cuda"):
    """Build B = n_segments * n_perturb window problems on `device` (the
    card unless the caller names another). Returns (states, datas, truths),
    each with a leading batch axis.

    Segments come from different stretches of simulated trajectories
    (varied seeds/paths); each segment is replicated with Monte-Carlo
    initial-state and calibration perturbations, drawn from
    np.random.default_rng(seed) in the JAX package's order."""
    dev = resolve_device(device)
    cfg = cfg or EstimatorConfig()
    rng = np.random.default_rng(seed)
    datas, truths = [], []
    paths = ["arc", "line", "figure8"]
    for s in range(n_segments):
        sim = simulate(SimConfig(duration=sim_duration,
                                 speed=0.4 + 0.1 * (s % 3), seed=seed + s,
                                 path=paths[s % 3], n_landmarks=350))
        data, truth, _ = build_window_from_sim(
            sim, cfg, kf_stride=2, start_cam=2 + 3 * (s % 3), F=F,
            dtype=dtype, device=dev)
        datas.append(data)
        truths.append(truth)

    def noise(shape, sigma):
        return torch.as_tensor(rng.normal(size=shape) * sigma, dtype=dtype,
                               device=dev)

    def perturb(t: fac.WindowState):
        return t._replace(
            p=t.p + noise((11, 3), p_sigma),
            v=t.v + noise((11, 3), v_sigma),
            rho=t.rho + noise((11, 4), rho_sigma),
            ba=torch.zeros_like(t.ba), bg=torch.zeros_like(t.bg))

    all_states, all_datas, all_truths = [], [], []
    for d, t in zip(datas, truths):
        for _ in range(n_perturb):
            all_states.append(perturb(t))
            all_datas.append(d)
            all_truths.append(t)
    stack = lambda xs: fac.map_tensors(lambda *ls: torch.stack(ls), *xs)
    return stack(all_states), stack(all_datas), stack(all_truths)


def _traj_err(st: fac.WindowState, truth: fac.WindowState):
    """(B,) max over frames of the position error after aligning each
    trajectory's first frame (position and rotation)."""
    R0 = lie.quat_to_rot(st.q[..., 0, :])
    R0t = lie.quat_to_rot(truth.q[..., 0, :])
    rel = (st.p - st.p[..., :1, :]) @ R0
    rel_t = (truth.p - truth.p[..., :1, :]) @ R0t
    return torch.linalg.vector_norm(rel - rel_t, dim=-1).amax(-1)


def solve_fleet(states, datas, truths, mesh=None,
                opts: SolveOptions = SolveOptions(max_iters=12)) -> FleetResult:
    """One fleet step: solve every window (`batched_solve`, one chunk per
    device of the mesh), score against truth."""
    st, info = batched_solve(states, datas, mesh, opts)
    with record_function("fleet_score"):
        truths = fac.map_tensors(lambda x: x.to(st.p.device), truths)
        return FleetResult(states=st, cost0=info.cost0, cost=info.cost,
                           traj_err=_traj_err(st, truths))
