"""The port on the card, what chip_smoke.py does not check: the kernel's
wrapper refuses what the kernel does not take, and the LM loop never waits
for the device. (chip_smoke.py holds the kernel to its plain version and the
card's solve to the CPU's.) Every test here needs a CUDA device and skips
without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is missing (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cerberus_tpu_torch.ops import lane_cholesky as lc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(seed, B, n, device):
    """SPD systems as tests/test_lane_cholesky.py makes them, f32."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, n + 5, n)).astype(np.float32)
    A = np.einsum("bij,bik->bjk", J, J) + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    return torch.as_tensor(A, device=device), torch.as_tensor(b, device=device)


def test_kernel_rejects_what_it_does_not_take(cuda):
    A, b = _spd(3, 2, 8, cuda)
    with pytest.raises(TypeError):
        lc.lane_cholesky_solve(A.double(), b.double())
    with pytest.raises(ValueError):
        lc.lane_cholesky_solve(A.transpose(1, 2), b)
    n = 241                                 # factor above 227 KB
    with pytest.raises(ValueError):
        lc.lane_cholesky_solve(torch.eye(n, device=cuda)[None],
                               torch.ones((1, n), device=cuda))


@pytest.fixture
def small_batch(cuda):
    """A small window (F = 24), 3 perturbed windows, f32 on the card."""
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.ops import factors as fac

    sim = simulate(SimConfig(duration=4.0, speed=0.5, seed=3, n_landmarks=200))
    data, truth, _ = build_window_from_sim(sim, kf_stride=2, start_cam=2,
                                           F=24, device=cuda,
                                           dtype=torch.float32)
    B = 3
    rng = np.random.default_rng(0)
    states = fac.map_tensors(lambda x: torch.stack([x] * B), truth)
    states = states._replace(p=states.p + torch.as_tensor(
        rng.normal(size=(B, 11, 3)) * 0.02, dtype=torch.float32, device=cuda))
    datas = fac.map_tensors(lambda x: x.expand((B,) + x.shape), data)
    return states, datas


def test_lm_loop_never_waits_for_the_device(small_batch):
    """No operation of a solve reads back from or waits for the card: CUDA's
    sync debug mode raises on any that does. (A first call has made the
    placement matrices, which are copied to the card once.)"""
    from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window_batched

    states, datas = small_batch
    opts = SolveOptions(max_iters=2)
    solve_window_batched(states, datas, opts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solve_window_batched(states, datas, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
