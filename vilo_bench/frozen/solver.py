"""The plain reference of the timed solve: Levenberg-Marquardt over a batch
of windows on the production path (structured assembly, Schur-on-depth,
rank-4 gauge projection, retract and reanchor), with every dense solve done
by `torch.linalg`.

A frozen copy of `cerberus_tpu_torch/ops/solver.py` (`_lm` on the Schur
path, `_damped_solve_schur`, `_project_gauge_blocks`, `_assemble_schur`,
`reanchor`) and of `ops/marginalize.py::_gauge_null_basis`. It imports
nothing of the program: the factors and the assembly are the frozen copies
beside it, and the program's lane Cholesky kernel is replaced by
`torch.linalg.cholesky_ex` and `torch.cholesky_solve`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from vilo_bench.frozen import config as C
from vilo_bench.frozen import factors as fac
from vilo_bench.frozen import lie
from vilo_bench.frozen.structured import build_normal_equations_blocks

NF = C.NUM_FRAMES


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


def library_cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b for a batch of SPD systems, by the library's factor."""
    L = torch.linalg.cholesky_ex(A).L
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _damped_solve_schur(H_pp, H_pd, h_dd, b_p, b_d, lam, opts: SolveOptions,
                        chol=library_cholesky_solve):
    """Schur-on-depth version of `_damped_solve`, for a batch of windows
    (leading axis B; lam (B,)): closed-form elimination of the diagonal
    inverse-depth block in the same equilibrated, identically damped system,
    then the dense 222-dim reduced system through `chol`."""
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
    y_p = chol(S.contiguous(), rhs.contiguous())
    y_d = (-b_d / d_d - torch.einsum("bdf,bd->bf", Hs_pd, y_p)) / a_dd
    return torch.cat([y_p / d_p, y_d / d_d], dim=1)


def _gauge_null_basis(state: fac.WindowState, dim: int) -> torch.Tensor:
    """(dim, 4) basis of the window's gauge freedoms at `state`: global
    translation (3) and rotation about gravity/yaw (1), on the dense tangent,
    with zero rows for the rho/extrinsic/td dims and any appended depths.

    Per frame i: translation columns dp_i = e_d; yaw column dp_i = z x p_i,
    dtheta_i = R_i^T z (right perturbation), dv_i = z x v_i. Built from
    concatenations (no in-place writes), so it runs under `torch.func.vmap`.
    """
    p, q, v = state.p, state.q, state.v                       # (11, 3|4|3)
    dtype, dev = p.dtype, p.device
    zhat = torch.eye(3, dtype=dtype, device=dev)[2].expand(NF, 3)
    z_x_p = lie.cross(zhat, p)
    Ri_T_z = lie.quat_rotate(lie.quat_conj(q), zhat)
    z_x_v = lie.cross(zhat, v)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(NF, 3, 3)
    zero33 = torch.zeros((NF, 3, 3), dtype=dtype, device=dev)
    pose = torch.cat([torch.cat([eye, z_x_p[..., None]], dim=-1),
                      torch.cat([zero33, Ri_T_z[..., None]], dim=-1)], dim=-2)
    sb = torch.cat([torch.cat([zero33, z_x_v[..., None]], dim=-1),
                    torch.zeros((NF, 6, 4), dtype=dtype, device=dev)], dim=-2)
    rest = torch.zeros((dim - fac.RHO_OFF, 4), dtype=dtype, device=dev)
    return torch.cat([pose.reshape(6 * NF, 4), sb.reshape(9 * NF, 4), rest])


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


def _assemble_schur(st: fac.WindowState, data: fac.WindowData,
                    opts: SolveOptions):
    """Schur blocks (gauge-projected unless opts says not) and robust cost
    of one window."""
    F = st.depth.shape[0]
    H_pp, H_pd, h_dd, b_p, b_d, r0 = build_normal_equations_blocks(st, data)
    if opts.project_gauge:
        H_pp, H_pd, b_p = _project_gauge_blocks(H_pp, H_pd, b_p, st,
                                                data.free_mask)
    return (H_pp, H_pd, h_dd, b_p, b_d), fac.robust_cost(r0, F)


def solve_windows(states: fac.WindowState, datas: fac.WindowData,
                  opts: SolveOptions, chol=library_cholesky_solve):
    """The LM iterations over a batch of windows (leading axis B) on the
    production path, exactly `opts.max_iters` of them with a masked accept;
    the dense solves go through `chol`. Returns (states, SolveInfo)."""
    if not (opts.structured and opts.schur and opts.project_gauge):
        raise ValueError("the reference runs the production options "
                         "(structured, schur, project_gauge)")
    B = states.p.shape[0]
    dtype, dev = states.p.dtype, states.p.device
    assemble = vmap(lambda st, d: _assemble_schur(st, d, opts))

    def solve_step(pieces, lam):
        return _damped_solve_schur(*pieces, lam, opts, chol)

    def pick(ok, a, b):
        return torch.where(ok.reshape((B,) + (1,) * (a.ndim - 1)), a, b)

    st = states
    pieces, cost0 = assemble(states, datas)
    cost = cost0
    lam = torch.full((B,), opts.lam0, dtype=dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(opts.max_iters):
        dx = solve_step(pieces, lam)
        mx = torch.amax(torch.abs(dx), dim=1, keepdim=True)
        dx = dx * torch.clamp(opts.step_clip / torch.clamp(mx, min=1e-30),
                              max=1.0)
        cand = fac.retract(st, dx)
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

