#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cerberus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed with its elapsed seconds:
  1. environment: torch and CUDA versions, the card's name and power limit;
     fails without a CUDA device (there is no CPU fallback);
  2. build: the kernel source cerberus_tpu_torch/csrc/lane_cholesky.cu, by
     nvcc into build/cerberus_tpu_torch/;
  3. kernels: each kernel against its plain torch version on the card, f32,
     at several shapes and at the main path's, timed with CUDA events beside
     its plain version, one library call computing the same function, and
     the least time the card could take;
  4. main path: the batched full-width window solve — 128 windows of the
     10 s simulated sequence (11 frames, F = 160, 222-dim reduced system),
     12 LM iterations, f32 — with every kernel launch counted, the results
     checked, cross-checked against the CPU, and timed; the single-window
     path (solve_window, B = 1) likewise counted and timed;
  5. with --profile: one batched solve under torch.profiler, its host time
     split by the solver's spans (assemble, solve_step) and the device time
     of its kernels.

Ends with a JSON line of the kernels' numbers, then the result line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero without the result line. It writes nothing outside build/.
"""

import sys

sys.dont_write_bytecode = True

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cerberus_tpu_torch import _build  # noqa: E402
from cerberus_tpu_torch.data.simulator import SimConfig, simulate  # noqa: E402
from cerberus_tpu_torch.data.window_builder import build_window_from_sim  # noqa: E402
from cerberus_tpu_torch.ops import factors as fac  # noqa: E402
from cerberus_tpu_torch.ops import lane_cholesky as lc  # noqa: E402
from cerberus_tpu_torch.ops.solver import (SolveOptions, solve_window,  # noqa: E402
                                           solve_window_batched)

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

BATCH = 128          # windows in the main path's batched solve
ITERS = 12           # LM iterations (reference max_num_iterations)
CHECK_WINDOWS = 8    # windows cross-checked against the CPU
TOL = 2e-3           # kernel vs plain, max |dx| / max |x| (f32)

KERNEL = dict(name="lane_cholesky_solve", route="cuda",
              source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
              replaces="cerberus_tpu/ops/lane_cholesky.py:45")


def phase(name, t0, **numbers):
    extra = "".join(f" {k}={v}" for k, v in numbers.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f} s{extra}", flush=True)


def spd(seed, B, n, device):
    """SPD systems as tests/test_lane_cholesky.py makes them."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, n + 5, n)).astype(np.float32)
    A = np.einsum("bij,bik->bjk", J, J) + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    return torch.as_tensor(A, device=device), torch.as_tensor(b, device=device)


def cuda_ms(fn, reps):
    """Median device time of fn() over reps, with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_s(fn, reps):
    """Median wall time of fn(i) over reps; fn synchronises."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def environment():
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase("environment", t0, device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    return dev, smi


def build():
    t0 = time.perf_counter()
    lib = _build.build("lane_cholesky")
    phase("build", t0, library=lib.name)


def check_kernel(dev):
    """The kernel against its plain version; numbers at the main path's
    shape (B = 128 windows, n = 222)."""
    t0 = time.perf_counter()
    for n in (16, 37, 222):
        for B in (1, 64, 128, 130):
            A, b = spd(1000 * n + B, B, n, dev)
            x = lc.lane_cholesky_solve(A, b)
            torch.cuda.synchronize()
            xp = lc.lane_cholesky_solve_plain(A, b)
            torch.cuda.synchronize()
            err = float((x - xp).abs().max() / xp.abs().max())
            if not err < TOL:
                raise AssertionError(f"lane_cholesky_solve n={n} B={B}: "
                                     f"relative error {err} >= {TOL}")
    B, n = BATCH, 222
    A, b = spd(7, B, n, dev)
    x = lc.lane_cholesky_solve(A, b)
    xp = lc.lane_cholesky_solve_plain(A, b)
    torch.cuda.synchronize()
    max_abs = float((x - xp).abs().max())

    def library():
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    # the lower triangle of A (all a Cholesky solve reads) and b in, x out
    bytes_moved = 4 * (B * n * (n + 1) // 2 + 2 * B * n)
    flops = B * (n ** 3 / 3 + 2 * n * n)              # factor + 2 solves
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    numbers = dict(
        max_abs_err=max_abs,
        ms=cuda_ms(lambda: lc.lane_cholesky_solve(A, b), 50),
        plain_ms=cuda_ms(lambda: lc.lane_cholesky_solve_plain(A, b), 20),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=cuda_ms(library, 20))
    phase("kernel", t0, **numbers)
    return numbers


def main_path_problem(dev):
    """The main path's input, as bench.py sets it up: the 10 s simulated
    sequence's full-width window (F = 160), BATCH states perturbed from
    numpy seeds 0..BATCH-1, f32 on the card. Returns (states, datas, opts)
    with a leading axis BATCH."""
    t0 = time.perf_counter()
    sim = simulate(SimConfig(duration=10.0, speed=0.5, seed=3))
    phase("simulate", t0)

    t0 = time.perf_counter()
    data, truth, Fa = build_window_from_sim(sim, device=dev,
                                            dtype=torch.float32)
    torch.cuda.synchronize()
    phase("build_window_from_sim", t0, active_features=Fa,
          F=data.f_valid.shape[0])

    def perturb(seed):
        r = np.random.default_rng(seed)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        return truth._replace(
            p=truth.p + f32(r.normal(size=(11, 3)) * 0.03),
            v=truth.v + f32(r.normal(size=(11, 3)) * 0.05),
            ba=torch.zeros_like(truth.ba), bg=torch.zeros_like(truth.bg))

    states = fac.map_tensors(lambda *xs: torch.stack(xs),
                             *[perturb(i) for i in range(BATCH)])
    datas = fac.map_tensors(
        lambda x: x.expand((BATCH,) + x.shape).contiguous(), data)
    return states, datas, SolveOptions(max_iters=ITERS)


def count_launches(label, solve, *args):
    """Run one solve with the launch count set to 0 just before it; the
    count, read just after, must be one launch per LM iteration."""
    t0 = time.perf_counter()
    lc.LAUNCHES = 0
    out = solve(*args)
    torch.cuda.synchronize()
    launches = lc.LAUNCHES
    phase(label, t0, iters=ITERS, launches=launches)
    if launches != ITERS:
        raise AssertionError(f"{label}: {launches} kernel launches, "
                             f"want {ITERS}")
    return out, launches


def main_path(dev):
    """The batched full-width window solve, then the single-window path:
    launches counted, results checked and cross-checked against the CPU,
    then timed. Returns (launches per path, the batched solve's seconds)."""
    states, datas, opts = main_path_problem(dev)
    (st, info), batched_launches = count_launches(
        "solve_window_batched", solve_window_batched, states, datas, opts)
    cost0, cost = info.cost0.cpu().numpy(), info.cost.cpu().numpy()
    if not (np.isfinite(cost).all() and (cost <= cost0).all()):
        raise AssertionError(f"costs not finite or not reduced: {cost0} {cost}")
    if not all(torch.isfinite(x).all() for x in st):
        raise AssertionError("non-finite state after the solve")
    print(f"cost0 median {np.median(cost0):.6g} -> cost median "
          f"{np.median(cost):.6g}, accepted steps median "
          f"{np.median(info.accepted.cpu().numpy())}")

    one_state = fac.map_tensors(lambda x: x[0], states)
    one_data = fac.map_tensors(lambda x: x[0], datas)
    _, single_launches = count_launches("solve_window", solve_window,
                                        one_state, one_data, opts)

    # cross-check windows 0..7: solve_window on the card and
    # solve_window_batched on CPU tensors (the plain version), both f32.
    # Tolerances (cost rtol 1e-3, p atol 1e-3 m): f32 sums in another order
    # on the card and on the CPU, compounded over 12 LM iterations whose
    # accept decisions compare those sums.
    t0 = time.perf_counter()
    head = lambda x: x[:CHECK_WINDOWS]
    cpu_st, cpu_info = solve_window_batched(
        fac.map_tensors(lambda x: head(x).cpu(), states),
        fac.map_tensors(lambda x: head(x).cpu(), datas), opts)
    runs = {"batched on the card": (fac.map_tensors(head, st),
                                    fac.map_tensors(head, info))}
    one = [solve_window(fac.map_tensors(lambda x: x[i], states),
                        fac.map_tensors(lambda x: x[i], datas), opts)
           for i in range(CHECK_WINDOWS)]
    runs["solve_window on the card"] = (
        fac.map_tensors(lambda *xs: torch.stack(xs), *[o[0] for o in one]),
        fac.map_tensors(lambda *xs: torch.stack(xs), *[o[1] for o in one]))
    for label, (s, i) in runs.items():
        np.testing.assert_allclose(i.cost.cpu().numpy(),
                                   cpu_info.cost.numpy(), rtol=1e-3,
                                   err_msg=label)
        np.testing.assert_allclose(s.p.cpu().numpy(), cpu_st.p.numpy(),
                                   atol=1e-3, rtol=0, err_msg=label)
    phase("cross-check vs CPU", t0, windows=CHECK_WINDOWS)

    t0 = time.perf_counter()

    def batched(i):
        sts = states._replace(p=states.p + 1e-7 * i)
        solve_window_batched(sts, datas, opts)
        torch.cuda.synchronize()

    batched_s = host_s(batched, 5)

    def single(i):
        solve_window(one_state._replace(p=one_state.p + 1e-7 * i), one_data,
                     opts)
        torch.cuda.synchronize()

    latency_ms = host_s(single, 5) * 1e3
    phase("timing", t0, windows_solved_per_s=BATCH / batched_s,
          single_window_latency_ms=latency_ms)
    launches = {"solve_window_batched": batched_launches,
                "solve_window": single_launches}
    return launches, batched_s, (states, datas, opts)


def profile_solve(problem, batched_s):
    """One batched solve under torch.profiler. Host time per span (the
    spans of ops/solver.py, summed over their calls) and the device time of
    the solve's kernels, all from this one profiled call; the busy share is
    that device time over the unprofiled solve timed in this run."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    states, datas, opts = problem
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_window_batched(states, datas, opts)
        torch.cuda.synchronize()
    events = prof.key_averages()
    spans = {e.key: e for e in events
             if e.key in ("lm_solve", "assemble", "solve_step")
             and e.device_type == torch.autograd.DeviceType.CPU}
    host_ms = {k: spans[k].cpu_time_total / 1e3 for k in spans}
    calls = {k: spans[k].count for k in spans}
    # device-side events only, without the spans' own device ranges (the
    # rule torch.profiler's "Self CUDA time total" uses)
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    rest = host_ms["lm_solve"] - host_ms["assemble"] - host_ms["solve_step"]
    print("profile host ms: " + " ".join(
        f"{k}={host_ms[k]:.3f} ({calls[k]} calls)"
        for k in ("lm_solve", "assemble", "solve_step"))
        + f" rest={rest:.3f}")
    print(f"profile device: kernel_ms={device_ms:.3f} "
          f"kernels={sum(e.count for e in on_device)} "
          f"busy_share_profiled={device_ms / host_ms['lm_solve']:.4f} "
          f"busy_share_unprofiled={device_ms / (batched_s * 1e3):.4f} "
          f"(unprofiled solve {batched_s * 1e3:.3f} ms)")
    print(events.table(sort_by="self_device_time_total", row_limit=10,
                       max_name_column_width=50))
    print(events.table(sort_by="self_cpu_time_total", row_limit=10,
                       max_name_column_width=50))
    phase("profile", t0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one batched solve")
    args = parser.parse_args()
    dev, smi = environment()
    build()
    numbers = check_kernel(dev)
    launches, batched_s, problem = main_path(dev)
    if args.profile:
        profile_solve(problem, batched_s)
    print("kernels: " + " ".join(
        f"{KERNEL['name']}={c} ({path})" for path, c in launches.items()))
    row = dict(KERNEL, launches=launches["solve_window_batched"],
               launches_solve_window=launches["solve_window"], **numbers)
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
