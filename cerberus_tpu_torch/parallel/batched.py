"""Batched and pooled window solving over a list of devices (port of
`cerberus_tpu/parallel/batched.py`).

1. `batched_solve` — data parallel: each device solves its chunk of the
   batch with `solve_window_batched` (one f32 lane-Cholesky kernel launch
   per LM iteration on a card); the chunks are concatenated on the first
   device. No communication inside the solve.

2. `pooled_calibration_step` — a cross-window reduction: every window
   contributes normal equations for a shared calibration block (the four
   per-leg calf lengths); each device sums its chunk's, the first device
   sums the devices' (the JAX package's `psum`) and solves once. With a
   `torch.distributed` group (`mesh.init_distributed`), every process
   pools its own windows and the processes' sums are all-reduced before
   the solve, which each process then makes alike.
   Each window's contribution needs only J_s, the sum of its eleven
   per-frame rho column blocks: four forward-mode products along those
   summed directions (`ops.factors.linearize_directions`), not the dense J.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window_batched
from cerberus_tpu_torch.parallel.mesh import gather_batch, shard_batch


def batched_solve(states, datas, mesh=None,
                  opts: SolveOptions = SolveOptions()):
    """Solve a batch of windows (every field with a leading batch axis);
    with a mesh (`make_mesh`), one chunk per device. Returns (states,
    SolveInfo) with the batch axis, on the first device of the mesh (or
    where the inputs lie)."""
    if mesh is None:
        return solve_window_batched(states, datas, opts)
    outs = [solve_window_batched(s, d, opts)
            for s, d in zip(shard_batch(states, mesh),
                            shard_batch(datas, mesh))]
    return (gather_batch([o[0] for o in outs], mesh[0]),
            gather_batch([o[1] for o in outs], mesh[0]))


def _rho_directions(F, dtype, device):
    """(D_DENSE + F, 4): direction c moves rho_c of every frame by one."""
    D = torch.zeros((fac.tangent_dim(F), 4), dtype=dtype, device=device)
    for i in range(fac.NF):
        D[fac.RHO_OFF + 4 * i: fac.RHO_OFF + 4 * (i + 1)] += torch.eye(
            4, dtype=dtype, device=device)
    return D


def _local_normal_equations(states, datas):
    """Sum over a chunk's windows of J_s^T J_s (4, 4) and J_s^T r (4,)."""
    F = states.depth.shape[-1]
    dirs = _rho_directions(F, states.p.dtype, states.p.device)

    def per_window(state, data):
        r, J_s = fac.linearize_directions(state, data, dirs)
        return J_s.T @ J_s, J_s.T @ r

    H, b = vmap(per_window)(states, datas)
    return H.sum(0), b.sum(0)


def pooled_calibration_step(states, datas, mesh=None, damping: float = 1e-6,
                            group=None):
    """One Gauss-Newton step on a shared per-leg kinematic calibration (rho,
    4 dims) pooled across a batch of windows.

    One robot, many independent data segments: each window's residuals
    constrain the same physical calf lengths, so the shared normal
    equations are the sum of the per-window contributions (the same delta
    applies to every frame's rho). With a mesh, each device sums its chunk
    and the first device sums the devices'. With a process group (`group`,
    from `mesh.init_distributed`), H and b are then summed over the
    group's processes (an all-reduce; nccl wants them on the card, gloo on
    the CPU), so the step pools every process's windows.

    Returns (new_states with rho shifted by the shared step, dx_rho (4,),
    H (4,4), b (4,)), on the first device of the mesh (or where the inputs
    lie). Call after batched_solve."""
    if mesh is None:
        H, b = _local_normal_equations(states, datas)
    else:
        parts = [_local_normal_equations(s, d)
                 for s, d in zip(shard_batch(states, mesh),
                                 shard_batch(datas, mesh))]
        H = sum(h.to(mesh[0]) for h, _ in parts)
        b = sum(v.to(mesh[0]) for _, v in parts)
        states = fac.map_tensors(lambda x: x.to(mesh[0]), states)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(H, group=group)
        dist.all_reduce(b, group=group)
    eye = torch.eye(4, dtype=H.dtype, device=H.device)
    dx = -torch.linalg.solve_ex(H + damping * eye, b).result
    return states._replace(rho=states.rho + dx[None, None, :]), dx, H, b
