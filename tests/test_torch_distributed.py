"""The pooled calibration step across processes (parallel/mesh.py::
init_distributed and batched.pooled_calibration_step(group=)) on the CPU,
as tests/test_multihost.py drives the JAX package across hosts, cut to
tier-1 size.

Two processes join a gloo group (init_distributed at a free localhost
port); each builds the same four windows — tests/test_torch_parallel.py's
window (5 s, seed 3, 200 landmarks, F = 48), each a different calf-length
and position offset — and pools only its half, and the all-reduce gives
each process every window's H and b. Both must return the H, b and dx of
one process pooling all four windows, and those equal the JAX package's
pooled_calibration_step without a mesh.

Tolerance: 1e-10 relative to scale — the same sums taken in another
order (two partial sums, then the all-reduce), and the port's J_s from
forward-mode products where the JAX package sums the dense J's columns
(tests/test_torch_parallel.py holds the one-process step at 1e-10).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.window_builder import build_window_from_sim
from cerberus_tpu.parallel import batched as jbatched
from torch_port_util import assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B = 4
TIMEOUT_S = 240   # per process: simulate + build + one pooled step

WINDOWS = textwrap.dedent("""
    import torch
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.ops import factors as fac

    def windows(B):
        sim = simulate(SimConfig(duration=5.0, speed=0.5, seed=3,
                                 n_landmarks=200))
        data, truth, _ = build_window_from_sim(sim, kf_stride=2, start_cam=2,
                                               F=48, device="cpu")
        perts = [truth._replace(rho=truth.rho + 0.004 * (1 + b),
                                p=truth.p + 0.01 * b) for b in range(B)]
        states = fac.map_tensors(lambda *xs: torch.stack(xs), *perts)
        datas = fac.map_tensors(lambda x: torch.stack([x] * B), data)
        return states, datas
""")

RANK = WINDOWS + textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    from cerberus_tpu_torch.parallel import pooled_calibration_step
    from cerberus_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    rank, world, port, out, B = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], int(sys.argv[5]))
    states, datas = windows(B)
    mine = slice(rank * B // world, (rank + 1) * B // world)
    half = lambda t: fac.map_tensors(lambda x: x[mine], t)
    group = init_distributed(f"localhost:{port}", world, rank, device="cpu")
    assert dist.get_backend(group) == "gloo"
    assert dist.get_world_size(group) == world
    new, dx, H, b = pooled_calibration_step(half(states), half(datas),
                                            group=group)
    dist.destroy_process_group()
    np.savez(out, H=H.numpy(), b=b.numpy(), dx=dx.numpy(),
             rho=new.rho.numpy())
    print("RANK_OK", rank)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both processes' results, started together, each with a timeout of
    its own."""
    tmp = tmp_path_factory.mktemp("dist")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), port,
         str(tmp / f"rank{r}.npz"), str(B)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _one_process():
    """The port's step over all B windows in this process (no group)."""
    from cerberus_tpu_torch.parallel import pooled_calibration_step
    scope = {}
    exec(WINDOWS, scope)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states, datas = scope["windows"](B)
        new, dx, H, b = pooled_calibration_step(states, datas)
    finally:
        torch.set_num_threads(n)
    return dict(H=H.numpy(), b=b.numpy(), dx=dx.numpy(), rho=new.rho.numpy())


def _jax():
    sim = simulate(SimConfig(duration=5.0, speed=0.5, seed=3,
                             n_landmarks=200))
    data, truth, _ = build_window_from_sim(sim, jConfig(), kf_stride=2,
                                           start_cam=2, F=48)
    perts = [truth._replace(rho=truth.rho + 0.004 * (1 + b),
                            p=truth.p + 0.01 * b) for b in range(B)]
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *perts)
    datas = jax.tree.map(lambda x: jnp.stack([x] * B), data)
    new, dx, H, b = jax.jit(jbatched.pooled_calibration_step)(states, datas)
    return dict(H=np.asarray(H), b=np.asarray(b), dx=np.asarray(dx),
                rho=np.asarray(new.rho))


def test_gloo_ranks_equal_one_process_and_jax(ranks):
    one, ref = _one_process(), _jax()
    for k in ("H", "b", "dx", "rho"):
        for r, got in enumerate(ranks):
            # each rank shifts the rho of its own windows
            want = one[k][r * B // WORLD:(r + 1) * B // WORLD] \
                if k == "rho" else one[k]
            assert_rel(f"pooled_calibration_step gloo rank {r}/{WORLD}.{k} "
                       f"vs one process", got[k], want, 1e-10)
        assert_rel(f"pooled_calibration_step one process.{k} vs JAX",
                   one[k], ref[k], 1e-10)
    np.testing.assert_array_equal(ranks[0]["dx"], ranks[1]["dx"])


def test_init_distributed_without_a_group():
    """One process and no coordinator: nothing to join (None), as the JAX
    package's init_distributed is a no-op there; more processes need a
    coordinator; the default device is the card."""
    from cerberus_tpu_torch.parallel.mesh import init_distributed

    assert init_distributed(device="cpu") is None
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_distributed()
