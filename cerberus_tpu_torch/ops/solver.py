"""Batched Levenberg-Marquardt core for the sliding-window problem (port of
`cerberus_tpu/ops/solver.py`).

Replaces the reference's Ceres DENSE_SCHUR + DOGLEG solve
(reference: estimator.cpp:1221-1236). Each iteration assembles the
Gauss-Newton blocks at the candidate state (ops/structured.py), projects the
4-dim gauge null space out, eliminates the diagonal inverse-depth block in
closed form and solves the 222-dim reduced Schur system with
`ops/lane_cholesky.lane_cholesky_solve`: the hand-written CUDA kernel for
CUDA tensors, its plain torch version for CPU tensors, whatever the batch
size. Gauge freedom (global position + yaw) is re-anchored to frame 0
afterwards (estimator.cpp:903-1000 double2vector).

The port always runs the JAX package's production options (structured
assembly, Schur-on-depth, gauge projection), so `SolveOptions` has no
switches for them. The JAX package's early-exit `while_loop` (and
`solve_window_batched`'s `scan`) is a Python loop of exactly `max_iters`
iterations with a masked accept: once a window has converged its state,
lambda, cost and accept count stay frozen, which gives the JAX loop's
iterates. Nothing in the loop reads a value back to the host.

Profiler spans: `lm_solve` (one solve), `assemble` (max_iters + 1 per
solve) and `solve_step` (max_iters per solve), for torch.profiler
(`chip_smoke.py --profile` reads them); without a profiler the 2 max_iters
+ 2 spans cost under a millisecond of host time a solve.

Matmul precision: the entry points run under `device.full_f32_matmuls()`,
which sets `torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False` for the solve — the counterpart
of the JAX package's `default_matmul_precision("highest")`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap
from torch.profiler import record_function

from cerberus_tpu_torch.device import full_f32_matmuls
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.lane_cholesky import lane_cholesky_solve
from cerberus_tpu_torch.ops.marginalize import _gauge_null_basis
from cerberus_tpu_torch.ops.structured import build_normal_equations_blocks
from cerberus_tpu_torch.utils import lie


class SolveOptions(NamedTuple):
    max_iters: int = 12           # reference: max_num_iterations
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 3.0
    lam_min: float = 1e-8         # floor: with the gauge projected out, the
                                  # remaining near-null dirs (weak depths) must
                                  # not blow up as lam decays over iterations
    lam_max: float = 1e8
    diag_floor: float = 1e-8
    function_tolerance: float = 1e-6  # stop on relative cost decrease
                                      # (Ceres function_tolerance semantics)
    step_clip: float = 1.0        # scale the whole step if any component
                                  # exceeds this (m / rad / unit inverse-depth)


class SolveInfo(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor   # number of accepted steps


def _damped_solve_schur(H_pp, H_pd, h_dd, b_p, b_d, lam, opts: SolveOptions):
    """Solve (H + lam*diag(H)) dx = -b with Jacobi equilibration, for a batch
    of windows (leading axis B; lam (B,)): closed-form elimination of the
    diagonal inverse-depth block, then the dense 222-dim reduced system
    through `lane_cholesky_solve`."""
    D = H_pp.shape[-1]
    d_p = torch.sqrt(torch.clamp(torch.diagonal(H_pp, dim1=-2, dim2=-1),
                                 min=opts.diag_floor))
    d_d = torch.sqrt(torch.clamp(h_dd, min=opts.diag_floor))
    Hs_pp = H_pp / (d_p[:, :, None] * d_p[:, None, :])
    Hs_pd = H_pd / (d_p[:, :, None] * d_d[:, None, :])
    a_dd = h_dd / (d_d * d_d) + lam[:, None] + 1e-12   # scaled depth diagonal
    eye = torch.eye(D, dtype=H_pp.dtype, device=H_pp.device)
    A_pp = Hs_pp + (lam[:, None, None] + 1e-12) * eye

    W = Hs_pd / a_dd[:, None, :]                         # (B, D, F)
    S = A_pp - torch.einsum("bdf,bef->bde", W, Hs_pd)
    rhs = -b_p / d_p + torch.einsum("bdf,bf->bd", W, b_d / d_d)
    y_p = lane_cholesky_solve(S.contiguous(), rhs.contiguous())
    y_d = (-b_d / d_d - torch.einsum("bdf,bd->bf", Hs_pd, y_p)) / a_dd
    return torch.cat([y_p / d_p, y_d / d_d], dim=1)


def _project_gauge_blocks(H_pp, H_pd, b_p, st: fac.WindowState, free_mask):
    """Rank-4 form of the gauge projection P (.) P on one window's block
    system. The gauge basis has support only on pose/speed dims (< D_DENSE),
    so P = blockdiag(P_dense, I_F): depth rows/cols are untouched."""
    D = H_pp.shape[0]
    N = _gauge_null_basis(st, D)
    N = N * free_mask.to(H_pp.dtype)[:, None]
    G = N.T @ N + 1e-10 * torch.eye(4, dtype=H_pp.dtype, device=H_pp.device)
    # solve_ex: the plain 4x4 solve without linalg.solve's error check,
    # which would read a flag back to the host every iteration
    K = torch.linalg.solve_ex(G, N.T).result.T          # N @ G^-1, (D, 4)
    NH = N.T @ H_pp                                      # (4, D)
    NHN = NH @ N                                         # (4, 4)
    H_pp = H_pp - K @ NH - NH.T @ K.T + K @ NHN @ K.T
    H_pd = H_pd - K @ (N.T @ H_pd)
    b_p = b_p - K @ (N.T @ b_p)
    return H_pp, H_pd, b_p


def _assemble_one(st: fac.WindowState, data: fac.WindowData):
    """Gauge-projected Schur blocks and robust cost of one window."""
    F = st.depth.shape[0]
    H_pp, H_pd, h_dd, b_p, b_d, r0 = build_normal_equations_blocks(st, data)
    H_pp, H_pd, b_p = _project_gauge_blocks(H_pp, H_pd, b_p, st,
                                            data.free_mask)
    return (H_pp, H_pd, h_dd, b_p, b_d), fac.robust_cost(r0, F)


def _lm(states: fac.WindowState, datas: fac.WindowData, opts: SolveOptions):
    """The LM iterations over a batch of windows (leading axis B)."""
    B = states.p.shape[0]
    dtype, dev = states.p.dtype, states.p.device
    assemble = vmap(_assemble_one)

    def pick(ok, a, b):
        return torch.where(ok.reshape((B,) + (1,) * (a.ndim - 1)), a, b)

    st = states
    with record_function("assemble"):
        pieces, cost0 = assemble(states, datas)
    cost = cost0
    lam = torch.full((B,), opts.lam0, dtype=dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(opts.max_iters):
        with record_function("solve_step"):
            dx = _damped_solve_schur(*pieces, lam, opts)
        mx = torch.amax(torch.abs(dx), dim=1, keepdim=True)
        dx = dx * torch.clamp(opts.step_clip / torch.clamp(mx, min=1e-30),
                              max=1.0)
        cand = fac.retract(st, dx)
        with record_function("assemble"):
            cand_pieces, new_cost = assemble(cand, datas)
        ok = (new_cost < cost) & ~done
        st = fac.WindowState(*(pick(ok, a, b) for a, b in zip(cand, st)))
        pieces = tuple(pick(ok, a, b) for a, b in zip(cand_pieces, pieces))
        # converged: an accepted step improved cost by < tol * cost
        done2 = done | (ok & (cost - new_cost
                              <= opts.function_tolerance * cost))
        lam = torch.where(done, lam, torch.where(
            ok, torch.clamp(lam / opts.lam_down, min=opts.lam_min),
            torch.clamp(lam * opts.lam_up, max=opts.lam_max)))
        cost = torch.where(ok, new_cost, cost)
        acc = acc + ok.to(torch.int32)
        done = done2
    st = reanchor(states, st)
    return st, SolveInfo(cost0=cost0, cost=cost, lam=lam, accepted=acc)


def solve_window(state: fac.WindowState, data: fac.WindowData,
                 opts: SolveOptions = SolveOptions()):
    """Run LM on one window. Returns (new_state, SolveInfo).

    The same iterations as `solve_window_batched` on a batch of one: every
    iteration launches the Cholesky kernel once (B = 1) on CUDA tensors."""
    one = lambda x: x[None]
    st, info = solve_window_batched(fac.map_tensors(one, state),
                                    fac.map_tensors(one, data), opts)
    first = lambda x: x[0]
    return fac.map_tensors(first, st), SolveInfo(*map(first, info))


def solve_window_batched(states: fac.WindowState, datas: fac.WindowData,
                         opts: SolveOptions = SolveOptions()):
    """Batched LM over B windows (every field with a leading axis B).

    The assembly, gauge projection and cost of each window run under
    `torch.func.vmap`; the reduced Schur systems of all B windows are solved
    by one `lane_cholesky_solve` per iteration, `max_iters` in all.
    Returns (new_states, SolveInfo) with a leading axis B on every field."""
    with full_f32_matmuls(), record_function("lm_solve"):
        return _lm(states, datas, opts)


def reanchor(old: fac.WindowState, new: fac.WindowState) -> fac.WindowState:
    """Re-fix the gauge: keep frame-0 position and yaw at their pre-solve
    values (reference: estimator.cpp:903-1000). Any leading batch dims."""
    R_old = lie.quat_to_rot(old.q[..., 0, :])
    R_new = lie.quat_to_rot(new.q[..., 0, :])
    ypr_old = lie.rot_to_ypr(R_old)
    ypr_new = lie.rot_to_ypr(R_new)
    y_diff = ypr_old[..., 0] - ypr_new[..., 0]
    zero = torch.zeros_like(y_diff)
    rot_diff = lie.ypr_to_rot(torch.stack([y_diff, zero, zero], dim=-1))
    # euler-singularity fallback (pitch near +-90 deg)
    singular = (torch.abs(torch.abs(ypr_old[..., 1]) - 90.0) < 1.0) | \
               (torch.abs(torch.abs(ypr_new[..., 1]) - 90.0) < 1.0)
    R_fallback = R_old @ R_new.transpose(-1, -2)
    rot_diff = torch.where(singular[..., None, None], R_fallback, rot_diff)
    q_diff = lie.rot_to_quat(rot_diff)

    rot_T = rot_diff.transpose(-1, -2)
    p = (new.p - new.p[..., :1, :]) @ rot_T + old.p[..., :1, :]
    q = lie.quat_normalize(lie.quat_mul(q_diff[..., None, :], new.q))
    v = new.v @ rot_T
    return new._replace(p=p, q=q, v=v)
