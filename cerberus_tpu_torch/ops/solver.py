"""Batched Levenberg-Marquardt core for the sliding-window problem (port of
`cerberus_tpu/ops/solver.py`).

Replaces the reference's Ceres DENSE_SCHUR + DOGLEG solve
(reference: estimator.cpp:1221-1236). Each iteration assembles the
Gauss-Newton system at the candidate state and solves its damped,
Jacobi-equilibrated form with `ops/lane_cholesky.lane_cholesky_solve`: the
hand-written CUDA kernel for CUDA tensors, its plain torch version for CPU
tensors, whatever the batch size. Gauge freedom (global position + yaw) is
re-anchored to frame 0 afterwards (estimator.cpp:903-1000 double2vector).

`SolveOptions` picks the path, as in the JAX package:
- structured and schur (the production default): the structured blocks
  (ops/structured.py), the rank-4 gauge projection on them, closed-form
  elimination of the diagonal inverse-depth block and a 222-dim Cholesky
  of the reduced Schur system;
- otherwise the full (222 + F)-dim system: `build_normal_equations`
  (structured) or J^T J, J^T r of the dense `factors.linearize`, the
  full-dim gauge projection, and a Cholesky of all 222 + F dims
  (`_damped_solve`: n = 382 at the estimator's F = 160).
project_gauge=False skips the projection on either path.

The JAX package's early-exit `while_loop` (and `solve_window_batched`'s
`scan`) is a Python loop of exactly `max_iters` iterations with a masked
accept: once a window has converged its state, lambda, cost and accept
count stay frozen, which gives the JAX loop's iterates. Nothing in the loop
reads a value back to the host.

Profiler spans (torch.profiler; `chip_smoke.py --profile` and the
benchmark's per-layer metrics read them): `lm_solve` (one solve),
`assemble` (max_iters + 1 per solve) and `solve_step` (max_iters per
solve) on every path, and inside them stage spans that on the Schur path
partition the solve, each kernel launched in exactly one of them:
- in each assembly (ops/structured.py and here): `proj_jacobians`,
  `proj_normal` (twice), `ileg_factor`, `prior_calib`, `gauge_project`,
  `robust_cost`;
- in each `solve_step`: `schur_reduce`, `lane_chol`, `back_substitute`;
- in `_lm`: `lm_update` (once before the loop, twice an iteration, and
  under a profiler once more for the counters) and `reanchor` (once).
(The full-system paths add `gauge_project`, `robust_cost` and `lane_chol`
and leave their H assembly and equilibration outside stage spans.) A solve
opens 7 (max_iters + 1) + 5 max_iters + 2 stage spans, 153 at 12
iterations; without a profiler each costs about 10 us of host time, about
1.5 ms a solve. Under a profiler `_lm` also counts its work
(`utils/profiling.count`): `lm.window_iterations`,
`lm.active_window_iterations` (windows not yet converged at an
iteration's start), `lm.accepted_steps`, `assemble.slots` and
`assemble.valid_slots`, as device tensors read back by nobody inside the
solve; without one it counts nothing and launches nothing for it.

Matmul precision: `solve_window` runs under
`device.matmul_precision("highest")` (no TF32), the counterpart of the JAX
package's `default_matmul_precision("highest")`; `solve_window_batched` takes the
precision as `gemm_precision` (`device.matmul_precision`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap
from torch.profiler import record_function

from cerberus_tpu_torch.device import matmul_precision
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.lane_cholesky import (lane_cholesky_solve,
                                                  lane_cholesky_solve_ref)
from cerberus_tpu_torch.ops.marginalize import (_gauge_null_basis,
                                                _gauge_projector)
from cerberus_tpu_torch.ops.structured import (build_normal_equations,
                                               build_normal_equations_blocks)
from cerberus_tpu_torch.utils import lie, profiling


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
    structured: bool = True       # factor-sparse H assembly (ops/structured.py)
                                  # False = dense jacfwd J then J^T J
    function_tolerance: float = 1e-6  # stop on relative cost decrease
                                      # (Ceres function_tolerance semantics)
    step_clip: float = 1.0        # scale the whole step if any component
                                  # exceeds this (m / rad / unit inverse-depth)
    project_gauge: bool = True    # project the analytic 4-dim gauge null
                                  # space (global translation + yaw) out of
                                  # (H, b) each iteration so roundoff gradient
                                  # along it can never drive a huge step
    schur: bool = True            # eliminate the (diagonal) inverse-depth
                                  # block in closed form before the dense
                                  # Cholesky — algebraically identical to the
                                  # full solve, O((222+F)^3) -> O(222^3)
                                  # (requires structured=True)


class SolveInfo(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor   # number of accepted steps


def _damped_solve(H, b, lam, opts: SolveOptions, chol=lane_cholesky_solve):
    """Solve (H + lam*diag(H)) dx = -b with Jacobi equilibration, for a batch
    of windows (H (B, n, n), b (B, n), lam (B,)): the full system through
    `chol` (`lane_cholesky_solve` unless the caller names another)."""
    n = H.shape[-1]
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                               min=opts.diag_floor))
    Hs = H / (d[:, :, None] * d[:, None, :])
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    A = Hs + (lam[:, None, None] + 1e-12) * eye
    rhs = (-b / d).contiguous()
    with record_function("lane_chol"):
        x = chol(A.contiguous(), rhs)
    return x / d


def _damped_solve_schur(H_pp, H_pd, h_dd, b_p, b_d, lam, opts: SolveOptions,
                        chol=lane_cholesky_solve):
    """Schur-on-depth version of `_damped_solve`, for a batch of windows
    (leading axis B; lam (B,)): closed-form elimination of the diagonal
    inverse-depth block in the same equilibrated, identically damped system,
    then the dense 222-dim reduced system through `chol`."""
    D = H_pp.shape[-1]
    with record_function("schur_reduce"):
        d_p = torch.sqrt(torch.clamp(torch.diagonal(H_pp, dim1=-2, dim2=-1),
                                     min=opts.diag_floor))
        d_d = torch.sqrt(torch.clamp(h_dd, min=opts.diag_floor))
        Hs_pp = H_pp / (d_p[:, :, None] * d_p[:, None, :])
        Hs_pd = H_pd / (d_p[:, :, None] * d_d[:, None, :])
        a_dd = h_dd / (d_d * d_d) + lam[:, None] + 1e-12  # scaled depth diag
        eye = torch.eye(D, dtype=H_pp.dtype, device=H_pp.device)
        A_pp = Hs_pp + (lam[:, None, None] + 1e-12) * eye

        W = Hs_pd / a_dd[:, None, :]                     # (B, D, F)
        S = A_pp - torch.einsum("bdf,bef->bde", W, Hs_pd)
        rhs = -b_p / d_p + torch.einsum("bdf,bf->bd", W, b_d / d_d)
        S, rhs = S.contiguous(), rhs.contiguous()
    with record_function("lane_chol"):
        y_p = chol(S, rhs)
    with record_function("back_substitute"):
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


def _project_gauge_full(H, b, st: fac.WindowState, data: fac.WindowData):
    """H <- P H P, b <- P b on one window's full (222 + F)-dim system with
    P = I - N (N^T N + 1e-10 I)^-1 N^T: every factor is relative, so H is
    exactly singular along global translation + yaw, and roundoff gradient
    along them would turn into an arbitrarily large cost-neutral step at
    small lam. The basis is masked by [free_mask, f_valid]."""
    P = _gauge_projector(st, H.shape[0],
                         torch.cat([data.free_mask, data.f_valid]), eps=1e-10)
    return P @ H @ P, P @ b


def _assemble_schur(st: fac.WindowState, data: fac.WindowData,
                    opts: SolveOptions):
    """Schur blocks (gauge-projected unless opts says not) and robust cost
    of one window."""
    F = st.depth.shape[0]
    H_pp, H_pd, h_dd, b_p, b_d, r0 = build_normal_equations_blocks(st, data)
    if opts.project_gauge:
        with record_function("gauge_project"):
            H_pp, H_pd, b_p = _project_gauge_blocks(H_pp, H_pd, b_p, st,
                                                    data.free_mask)
    with record_function("robust_cost"):
        return (H_pp, H_pd, h_dd, b_p, b_d), fac.robust_cost(r0, F)


def _assemble_full(st: fac.WindowState, data: fac.WindowData,
                   opts: SolveOptions):
    """The full (222 + F)-dim (H, b), structured or J^T J of the dense
    linearization, gauge-projected unless opts says not, and the robust
    cost of one window."""
    F = st.depth.shape[0]
    if opts.structured:
        H, b, r0 = build_normal_equations(st, data)
    else:
        r, J, r0 = fac.linearize(st, data)
        H = J.T @ J
        b = J.T @ r
    if opts.project_gauge:
        with record_function("gauge_project"):
            H, b = _project_gauge_full(H, b, st, data)
    with record_function("robust_cost"):
        return (H, b), fac.robust_cost(r0, F)


def _lm(states: fac.WindowState, datas: fac.WindowData, opts: SolveOptions,
        chol=lane_cholesky_solve):
    """The LM iterations over a batch of windows (leading axis B), on the
    path `opts` picks; the dense solves go through `chol`."""
    B = states.p.shape[0]
    dtype, dev = states.p.dtype, states.p.device
    if opts.structured and opts.schur:
        assemble = vmap(lambda st, d: _assemble_schur(st, d, opts))

        def solve_step(pieces, lam):
            return _damped_solve_schur(*pieces, lam, opts, chol)
    else:
        assemble = vmap(lambda st, d: _assemble_full(st, d, opts))

        def solve_step(pieces, lam):
            return _damped_solve(*pieces, lam, opts, chol)

    def pick(ok, a, b):
        return torch.where(ok.reshape((B,) + (1,) * (a.ndim - 1)), a, b)

    # the counters' accumulator exists only under a profiler: one add an
    # iteration, never read back inside the loop
    counting = profiling.recording()
    st = states
    with record_function("assemble"):
        pieces, cost0 = assemble(states, datas)
    with record_function("lm_update"):
        cost = cost0
        lam = torch.full((B,), opts.lam0, dtype=dtype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        acc = torch.zeros((B,), dtype=torch.int32, device=dev)
        done_iters = torch.zeros((B,), dtype=torch.int32, device=dev) \
            if counting else None
    for _ in range(opts.max_iters):
        with record_function("solve_step"):
            dx = solve_step(pieces, lam)
        with record_function("lm_update"):
            if counting:
                done_iters += done
            mx = torch.amax(torch.abs(dx), dim=1, keepdim=True)
            dx = dx * torch.clamp(opts.step_clip / torch.clamp(mx, min=1e-30),
                                  max=1.0)
            cand = fac.retract(st, dx)
        with record_function("assemble"):
            cand_pieces, new_cost = assemble(cand, datas)
        with record_function("lm_update"):
            ok = (new_cost < cost) & ~done
            st = fac.WindowState(*(pick(ok, a, b) for a, b in zip(cand, st)))
            pieces = tuple(pick(ok, a, b)
                           for a, b in zip(cand_pieces, pieces))
            # converged: an accepted step improved cost by < tol * cost
            done2 = done | (ok & (cost - new_cost
                                  <= opts.function_tolerance * cost))
            lam = torch.where(done, lam, torch.where(
                ok, torch.clamp(lam / opts.lam_down, min=opts.lam_min),
                torch.clamp(lam * opts.lam_up, max=opts.lam_max)))
            cost = torch.where(ok, new_cost, cost)
            acc = acc + ok.to(torch.int32)
            done = done2
    with record_function("reanchor"):
        st = reanchor(states, st)
    if counting:
        with record_function("lm_update"):
            n = B * opts.max_iters
            profiling.count("lm.window_iterations", n)
            profiling.count("lm.active_window_iterations",
                            n - done_iters.sum())
            profiling.count("lm.accepted_steps", acc.sum())
            profiling.count("assemble.slots", datas.f_valid.numel())
            profiling.count("assemble.valid_slots", datas.f_valid.sum())
    return st, SolveInfo(cost0=cost0, cost=cost, lam=lam, accepted=acc)


def solve_window(state: fac.WindowState, data: fac.WindowData,
                 opts: SolveOptions = SolveOptions()):
    """Run LM on one window under any option set. Returns (new_state,
    SolveInfo).

    The same iterations as `solve_window_batched` on a batch of one: every
    iteration launches the Cholesky kernel once (B = 1) on CUDA tensors, at
    n = 222 on the Schur path and n = 222 + F on the full path."""
    one = lambda x: x[None]
    with matmul_precision("highest"), record_function("lm_solve"):
        st, info = _lm(fac.map_tensors(one, state),
                       fac.map_tensors(one, data), opts)
    first = lambda x: x[0]
    return fac.map_tensors(first, st), SolveInfo(*map(first, info))


def solve_window_batched(states: fac.WindowState, datas: fac.WindowData,
                         opts: SolveOptions = SolveOptions(),
                         lane_chol: bool | None = None,
                         gemm_precision: str = "highest"):
    """Batched LM over B windows (every field with a leading axis B), on the
    production path: opts.structured, schur and project_gauge, else
    ValueError (the JAX package asserts the same).

    The assembly, gauge projection and cost of each window run under
    `torch.func.vmap`; the reduced Schur systems of all B windows are solved
    by one batched Cholesky solve per iteration, `max_iters` in all.

    lane_chol: None = `lane_cholesky_solve` (the kernel on CUDA tensors, its
    plain version on CPU tensors); True = the kernel, and ValueError on CPU
    tensors; False = `lane_cholesky_solve_ref`, the library route. Any batch
    size takes the kernel: the JAX package's `B % LANES == 0` condition is
    its TPU kernel's lane layout, not a change of result.
    gemm_precision: float32 matmul precision of the assembly and the solve,
    "highest" (default, no TF32) or "high" (TF32; see
    `device.matmul_precision`, and check convergence costs before trusting
    results at "high").
    Returns (new_states, SolveInfo) with a leading axis B on every field."""
    if not (opts.structured and opts.schur and opts.project_gauge):
        raise ValueError("solve_window_batched runs the production options "
                         "(structured, schur, project_gauge); solve_window "
                         "takes the others")
    if lane_chol and states.p.device.type != "cuda":
        raise ValueError(f"lane_chol=True needs CUDA tensors: the kernel has "
                         f"no CPU mode (got {states.p.device})")
    chol = lane_cholesky_solve_ref if lane_chol is False \
        else lane_cholesky_solve
    with matmul_precision(gemm_precision), record_function("lm_solve"):
        return _lm(states, datas, opts, chol)


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
