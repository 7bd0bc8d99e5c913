"""What the measurement drivers (`profile_inloop`, `profile_batched`,
`profile_solver`, `profile_streaming`, `bench_klt`, `multichip_scaling`)
share: the device and dtype rule, the benchmark window, the perturbed
batch, and a timer.

The JAX drivers time a jitted program with a forced value fetch; here each
timed program returns one scalar tensor, and a rep ends with `float()` of
it, which waits for the card (`.item()`), timed with `time.perf_counter()`.
The timer also counts the lane-Cholesky kernel's launches of each program
by (dtype, B, n) (`lane_cholesky.LAUNCHES_BY_SHAPE`), so a run shows
which shapes its solves put on the kernel.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops import lane_cholesky as lc

# the benchmark sequence of the JAX drivers (and bench.py)
BENCH_SIM = SimConfig(duration=10.0, speed=0.5, seed=3)


def device_and_dtype(device: str):
    """(torch device, dtype): float32 on the card, float64 on the CPU, as
    the JAX drivers pick float32 on the accelerator. The card is taken
    unless device says "cpu"; without one this raises (no fallback)."""
    dev = resolve_device(device)
    return dev, (torch.float32 if dev.type == "cuda" else torch.float64)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_problem(dev, dtype):
    """(data, truth): the JAX drivers' window, the 10 s simulated sequence
    (seed 3) at full width (F = 160, the default EstimatorConfig), on dev
    in dtype."""
    data, truth, _ = build_window_from_sim(simulate(BENCH_SIM),
                                           EstimatorConfig(), dtype=dtype,
                                           device=dev)
    return data, truth


def broadcast(tree, B):
    """Every tensor of tree with a leading axis of B copies."""
    return fac.map_tensors(
        lambda x: x.expand((B,) + x.shape).contiguous(), tree)


def make_batch(problem, B):
    """(states, datas) of B windows, as the JAX drivers' `make_batch`:
    window i's positions and speeds moved by numpy `default_rng(i)` normals
    times 0.03 m and 0.05 m/s, every window on the same data."""
    data, truth = problem
    dtype, dev = truth.p.dtype, truth.p.device

    def perturb(i):
        r = np.random.default_rng(i)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return truth._replace(p=truth.p + t(r.normal(size=(11, 3)) * 0.03),
                              v=truth.v + t(r.normal(size=(11, 3)) * 0.05))

    states = fac.map_tensors(lambda *xs: torch.stack(xs),
                             *[perturb(i) for i in range(B)])
    return states, broadcast(data, B)


def nudge(tree, eps):
    """tree with eps added to every floating tensor."""
    return fac.map_tensors(
        lambda a: a + eps if a.is_floating_point() else a, tree)


def launches_since(before: collections.Counter) -> dict:
    """The lane kernel's launches since `before` (a copy of
    LAUNCHES_BY_SHAPE), as {"float32 B=128 n=222": count}."""
    now = collections.Counter(lc.LAUNCHES_BY_SHAPE)
    now.subtract(before)
    return {f"{str(dt).split('.')[-1]} B={B} n={n}": k
            for (dt, B, n), k in sorted(now.items(), key=str) if k}


class Timer:
    """Median wall time of timed programs, reps each after one warm call.

    Each program returns one scalar tensor; a rep ends with `float()` of
    it. `launches[tag]` holds the program's calls (warm call included) and
    the lane kernel's launches over them by shape."""

    def __init__(self, reps: int, verbose: bool = True):
        self.reps = reps
        self.verbose = verbose
        self.launches = {}

    def ms(self, tag, fn, *args, vary=None, per=None):
        """Median ms of fn(*args) over self.reps reps; rep i runs
        fn(*vary(args, i)) when vary is given (the JAX drivers' input
        variation). per=(count, unit) adds a "<ms/count> <unit>" note to the
        printed line."""
        before = collections.Counter(lc.LAUNCHES_BY_SHAPE)
        float(fn(*args))                     # warm-up
        ts = []
        for i in range(self.reps):
            xs = vary(args, i) if vary is not None else args
            t0 = time.perf_counter()
            float(fn(*xs))
            ts.append(time.perf_counter() - t0)
        ms = float(np.median(ts)) * 1e3
        self.launches[tag] = dict(calls=self.reps + 1,
                                  by_shape=launches_since(before))
        if self.verbose:
            extra = f", {ms / per[0] * 1e3:.1f} {per[1]}" if per else ""
            print(f"{tag}: {ms:.2f} ms{extra}", flush=True)
        return ms
