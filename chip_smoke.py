#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cerberus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed with its elapsed seconds:
  1. environment: torch and CUDA versions, the card's name and power limit,
     whether OpenCV is importable (the device tracker does not need it) and,
     if it is, PinholeCamera's undistortion against OpenCV's; fails without
     a CUDA device (there is no CPU fallback);
  2. build: the kernel sources cerberus_tpu_torch/csrc/*.cu, one nvcc each,
     all started together, into build/cerberus_tpu_torch/, with each
     kernel's registers, shared memory and spills as ptxas reports them;
  3. kernels: each kernel against its plain torch version on the card at
     tile-aligned and ragged n, resident and streamed tiles, and a batch
     with one system that is not SPD (its x NaN, the others as alone); then
     at its paths' shapes, timed with CUDA events beside its plain version,
     one library call computing the same function, and the least time the
     card could take (cuda_ms says how):
       - lane_cholesky_solve f32 (the batched solve's and solve_window's)
         and f64 (the streaming estimator's);
       - cholesky_solve, f32 (on no path of the port, as its TPU original);
  4. batched path: the batched full-width window solve — 128 windows of the
     10 s simulated sequence (11 frames, F = 160, 222-dim reduced system),
     12 LM iterations, f32 — with every kernel launch counted, the results
     checked, cross-checked against the CPU, and timed; the single-window
     path (solve_window, B = 1) likewise counted and timed;
  5. streaming path: the per-frame streaming estimator at full width
     (default EstimatorConfig: 11-frame window, F = 160, 12 LM iterations,
     f64, stereo, leg odometry, online rho, extrinsic estimation) replaying
     two simulated sequences, 20 camera frames each, with the end-to-end
     tests' gates, the f64 kernel's launches counted per solve, and the
     first 14 frames cross-checked against the port on the CPU;
  6. tracker check: the device tracker's frame programs (_first_frame,
     track_frame) on the card against the same functions on the CPU, on 3
     rendered 640x480 stereo pairs of sequence A with equal inputs;
  7. ekf check: the legged EKF on the card against the same filter on the
     CPU over sequence A's 1,500 samples (f64), each timed per sample;
  8. image replay A: the image pipeline at full width — sequence A's 20
     camera frames rendered at 640x480 stereo (prerendered, outside the
     timed loop) -> the device tracker (120 slots, 4 levels, 21x21 patches,
     10 iterations) on its own stream and worker thread -> the f64
     streaming estimator (default EstimatorConfig) with contacts from the
     legged EKF on the card (contact source 0) — with the gates, the f64
     kernel's launches counted, tracker, render and EKF times, and tracks
     alive per frame;
  9. keyframes -> pose graph: streaming A's keyframes (keyframe_callback)
     fed a pose graph on the card, the gates of
     tests/test_posegraph.py::test_estimator_feeds_posegraph;
 10. loop back-end street: the loop closer at full width (LoopCloser
     defaults) on StreetStream's 889 keyframes of the street circuit, the
     pose graph's optimize on the card; gates, counts and times; the guard
     decisions replayed on the CPU; optimize_pose_graph of the final graph
     (Nc = 1024) card vs CPU;
 11. fleet: build_fleet(4 segments x 32 perturbations) = 128 windows at
     F = 96, f32, through solve_fleet (the f32 kernel's launches counted),
     tests/test_fleet.py's gates, 8 windows against the CPU, windows per
     second; the pooled calibration step against the CPU;
 12. sfm check: the initial SfM and alignment functions card vs CPU at the
     estimator's window (11 frames, F = 160, 128 hypotheses) and
     tests/test_initial_sfm.py's gates on the card;
 13. with --profile: one batched solve, one streaming step, one image
     replay frame and one pose-graph optimize under torch.profiler, host
     time split by the code's spans and the device time of their kernels.

Ends with a line of each kernel's launches per path, the card's name and
power limit, a JSON line of the kernels' numbers, then the result line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero without the result line. It writes nothing outside build/.
"""

import sys

sys.dont_write_bytecode = True

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import re  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cerberus_tpu_torch import _build  # noqa: E402
from cerberus_tpu_torch.config import EstimatorConfig  # noqa: E402
from cerberus_tpu_torch import convert  # noqa: E402
from cerberus_tpu_torch.data.replay import replay, replay_images  # noqa: E402
from cerberus_tpu_torch.data.simulator import (ImageRenderer,  # noqa: E402
                                               PrerenderedFrames, SimConfig,
                                               simulate)
from cerberus_tpu_torch.data.window_builder import build_window_from_sim  # noqa: E402
from cerberus_tpu_torch.estimator import estimator as E  # noqa: E402
from cerberus_tpu_torch.frontend.device_tracker import (DeviceTracker,  # noqa: E402
                                                        _first_frame)
from cerberus_tpu_torch.frontend.ekf import LeggedEKF  # noqa: E402
from cerberus_tpu_torch.frontend.tracker import PinholeCamera  # noqa: E402
from cerberus_tpu_torch.ops import klt  # noqa: E402
from cerberus_tpu_torch.ops import cholesky_solve as cs  # noqa: E402
from cerberus_tpu_torch.ops import factors as fac  # noqa: E402
from cerberus_tpu_torch.ops import lane_cholesky as lc  # noqa: E402
from cerberus_tpu_torch.ops.solver import (SolveOptions, solve_window,  # noqa: E402
                                           solve_window_batched)
from cerberus_tpu_torch.data.replay import score  # noqa: E402
from cerberus_tpu_torch.estimator import initial_alignment as ialign  # noqa: E402
from cerberus_tpu_torch.estimator import initial_sfm as isfm  # noqa: E402
from cerberus_tpu_torch.loop.closer import LoopCloser, _yaw_of_quat  # noqa: E402
from cerberus_tpu_torch.loop.posegraph import (PoseGraph,  # noqa: E402
                                               optimize_pose_graph)
from cerberus_tpu_torch.parallel import pooled_calibration_step  # noqa: E402
from cerberus_tpu_torch.parallel.fleet import build_fleet, solve_fleet  # noqa: E402
from cerberus_tpu_torch.utils import lie  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth,
# float32 and float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

BATCH = 128          # windows in the batched solve
ITERS = 12           # LM iterations (reference max_num_iterations)
CHECK_WINDOWS = 8    # windows cross-checked against the CPU
TOL = 2e-3           # f32 kernels vs plain, max |dx| / max |x|
TOL_F64 = 1e-10      # f64 kernel vs plain, max |dx| / max |x|
LANE_N = {torch.float32: (1, 16, 31, 33, 37, 222, 238, 240, 241, 321, 384),
          torch.float64: (1, 16, 31, 33, 37, 222, 224, 225, 238, 239)}
LANE_B = (1, 2, 128, 130)
TIMED_CALLS = 50     # kernel or library calls between one event pair
STREAM_FRAMES = 20   # camera frames per streaming sequence
CHECK_FRAMES = 14    # frames of sequence A cross-checked against the CPU
SEQ_A = SimConfig(duration=3.0, speed=0.5, seed=5)   # sequence A
TRACK_PAIRS = 3      # rendered stereo pairs of the tracker check
TRACK_POS_TOL = 1e-2  # px, tracker card vs CPU, points kept by both
TRACK_AGREE = 0.98   # share of slots whose flags must agree, card vs CPU
EKF_TOL = 1e-9       # EKF card vs CPU, relative, f64
ATE_GATE = 0.0041    # m: 2x the JAX package's 0.00204 on the image replay

# the loop back-end's street stream (StreetStream): the circuit of
# evals/long_run.py --loop, keyframes 0.27 m apart along it (over the loop
# closer's 0.25 m gate by more than 3 sigma of the odometric step noise, so
# that it drops almost none), 2.2 laps; the odometry's random walk drifts
# 0.186 % of the distance (the JAX package's 470 s street run: 0.187 %)
STREET = SimConfig(path="street", speed=0.75, seed=77)
KF_SPACING = 0.27
STREET_KEYFRAMES = 889
ODO_SIGMA_P = 0.006     # m per keyframe step and horizontal axis
ODO_SIGMA_YAW = 2e-4    # rad per keyframe step
KF_PIX_NOISE = 0.5      # px (focal 460) on the keyframes' observations

CPU_REPLAY_S = 150   # s: budget of the loop stream's replay on the CPU
PG_TOL = 1e-9        # optimize_pose_graph card vs CPU, relative, f64
FLEET_SEGMENTS, FLEET_PERTURB = 4, 32   # B = 128 windows, F = 96, f32
SFM_TOL = 1e-9       # initial SfM card vs CPU, relative, f64

# kernel rows: (name, dtype) -> what the JSON line says of it
KERNELS = {
    ("lane_cholesky_solve[f32]", torch.float32): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45"),
    ("lane_cholesky_solve[f64]", torch.float64): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45"),
    ("cholesky_solve", torch.float32): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/cholesky_solve.cu",
        replaces="cerberus_tpu/ops/pallas_kernels.py:53"),
}


class StreetStream:
    """A keyframe stream of a street circuit, as the estimator's
    keyframe_callback feeds the loop closer, made without simulating the
    IMU: numpy only, from a seed.

    Keyframe k lies `spacing * k` metres along the circuit of `sim_cfg`
    (the simulator's `_path_street`) at the body height, level, heading
    along the path. Landmarks follow the simulator's rule: `n_landmarks`
    points at uniform places along one lap, offset uniformly within the
    corridor's half-width and from -body_height to 2.5 m in height. The
    odometry is a random walk on the true relative motion: each step's
    translation gets N(0, sigma_p) per horizontal axis in the previous
    keyframe's frame and its yaw N(0, sigma_yaw), so the odometric frame
    drifts from the truth. A record carries, as keyframe_callback gives
    them: t, the odometric position and orientation (a yaw quaternion),
    the visible landmarks' ids and {id: (normalized left-camera
    observation with `pix_noise` px of noise, world point in that
    keyframe's drifted odometric frame)}, and the rendered 640x480 left
    image (ImageRenderer over the keyframe poses). `truth` holds the true
    positions."""

    def __init__(self, n, sim_cfg=STREET, spacing=KF_SPACING, seed=None,
                 sigma_p=ODO_SIGMA_P, sigma_yaw=ODO_SIGMA_YAW,
                 pix_noise=KF_PIX_NOISE):
        from cerberus_tpu_torch.data.simulator import _path_street, _rotz
        c = sim_cfg
        rng = np.random.default_rng(c.seed if seed is None else seed)
        self.cfg = EstimatorConfig()
        self.n = n
        self.t = spacing * np.arange(n) / c.speed
        x, y, *_, yaw = _path_street(self.t, c)
        self.truth = np.stack([x, y, np.full(n, c.body_height)], -1)
        W, H, r = c.street_w, c.street_h, c.street_corner_r
        lap = 2 * (W - 2 * r) + 2 * (H - 2 * r) + 2 * np.pi * r
        lx, ly, *_ = _path_street(rng.uniform(0, lap, c.n_landmarks)
                                  / c.speed, c)
        hw = c.corridor_halfwidth
        self.lm = np.stack([lx, ly, np.full(c.n_landmarks, c.body_height)],
                           -1) + np.stack([
                               rng.uniform(-hw, hw, c.n_landmarks),
                               rng.uniform(-hw, hw, c.n_landmarks),
                               rng.uniform(-c.body_height, 2.5,
                                           c.n_landmarks)], -1)
        # odometry: the true relative motion with a random walk
        p_odo, yaw_odo = [self.truth[0]], [yaw[0]]
        for k in range(1, n):
            Rt = _rotz(yaw[k - 1])
            rel = Rt.T @ (self.truth[k] - self.truth[k - 1])
            rel[:2] += rng.normal(size=2) * sigma_p
            dyaw = yaw[k] - yaw[k - 1] + rng.normal() * sigma_yaw
            p_odo.append(p_odo[-1] + _rotz(yaw_odo[-1]) @ rel)
            yaw_odo.append(yaw_odo[-1] + dyaw)
        self.p_odo, self.yaw_odo = np.array(p_odo), np.array(yaw_odo)
        self.yaw = yaw
        self.pix_sigma = pix_noise / 460.0
        self._noise = np.random.default_rng(rng.integers(2 ** 31))
        self.renderer = ImageRenderer(
            dict(landmarks=self.lm, p=self.truth, R=_rotz(yaw)), self.cfg)

    def __len__(self):
        return self.n

    def __iter__(self):
        for k in range(self.n):
            yield self.record(k)

    def record(self, k):
        """(t, p, q, ids, obs, img) of keyframe k, for
        LoopCloser.add_keyframe."""
        Rwc, twc = self.renderer.camera_pose(k, 0)
        pc = (self.lm - twc) @ Rwc
        z = pc[:, 2]
        vis = (z > 0.5) & (z < 12.0)
        uv = pc[:, :2] / np.maximum(z, 1e-6)[:, None]
        vis &= (np.abs(uv[:, 0]) < 0.6) & (np.abs(uv[:, 1]) < 0.45)
        uv = uv + self._noise.normal(size=uv.shape) * self.pix_sigma
        # the true world -> keyframe k's odometric frame
        d = self.yaw_odo[k] - self.yaw[k]
        cd, sd = np.cos(d), np.sin(d)
        Rd = np.array([[cd, -sd, 0.0], [sd, cd, 0.0], [0.0, 0.0, 1.0]])
        t_d = self.p_odo[k] - Rd @ self.truth[k]
        world = self.lm @ Rd.T + t_d
        ids = [int(i) for i in np.nonzero(vis)[0]]
        obs = {i: (uv[i].copy(), world[i].copy()) for i in ids}
        q = np.array([np.cos(self.yaw_odo[k] / 2), 0.0, 0.0,
                      np.sin(self.yaw_odo[k] / 2)])
        return (float(self.t[k]), self.p_odo[k].copy(), q, ids, obs,
                self.renderer.render(k, 0))


def phase(name, t0, **numbers):
    extra = "".join(f" {k}={v}" for k, v in numbers.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f} s{extra}", flush=True)


def spd(seed, B, n, device, dtype=torch.float32):
    """SPD systems as tests/test_lane_cholesky.py makes them."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, n + 5, n))
    A = np.swapaxes(J, 1, 2) @ J + 0.5 * np.eye(n)      # J^T J
    b = rng.normal(size=(B, n))
    if dtype == torch.float32:     # made in f32, as that test makes them
        J32 = J.astype(np.float32)
        A = np.swapaxes(J32, 1, 2) @ J32 + 0.5 * np.eye(n, dtype=np.float32)
    return (torch.as_tensor(A, dtype=dtype, device=device),
            torch.as_tensor(b, dtype=dtype, device=device))


def spd_pallas(seed, B, n, device, pad=0):
    """SPD systems as tests/test_pallas_kernels.py makes them, f32, each with
    its own damping lam from 1e-3 to 1e-1 (log-spaced), so that a kernel
    that drops the damping or damps every system alike is off by far more
    than TOL. pad > 0 zeroes the last pad rows and columns of H and entries
    of b, as the TPU kernel pads n to a multiple of 128: only the 1e-12 term
    keeps those pivots nonzero. Returns (H, b, lam)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    H = A @ np.swapaxes(A, 1, 2) + n * np.eye(n, dtype=np.float32)  # A A^T
    b = rng.normal(size=(B, n)).astype(np.float32)
    if pad:
        H[:, n - pad:, :] = 0.0
        H[:, :, n - pad:] = 0.0
        b[:, n - pad:] = 0.0
    lam = np.geomspace(1e-3, 1e-1, B).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (H, b, lam))


_SLEEP_CYCLES_PER_MS = []


def device_sleep(ms):
    """Hold the current stream busy for about ms (torch.cuda._sleep spins a
    kernel for a count of clock cycles, calibrated here once)."""
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def cuda_ms(fn, calls=TIMED_CALLS, reps=5):
    """Device time of one fn() call: the median over reps of `calls` calls
    made back to back between one pair of CUDA events, over calls. Each rep
    queues its calls behind a device-side sleep longer than their enqueue
    takes, so the device runs them without waiting for the host, and the
    host's time per call (Python checks, ctypes, allocation) is not
    counted. Returns (ms per call, host ms per call to enqueue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        device_sleep(2 * host_ms + 1)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)), host_ms / calls


def one_call_ms(fn, reps=20):
    """The earlier way to time a kernel: the median over reps of one
    call between a pair of CUDA events, host enqueue included."""
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


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def bound(bytes_moved, flops, flop_rate):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the type's peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts():
    lc.LAUNCHES = 0
    for k in lc.LAUNCHES_BY_DTYPE:
        lc.LAUNCHES_BY_DTYPE[k] = 0
    cs.LAUNCHES = 0


def read_counts():
    """Launches since reset_counts(), per kernel row."""
    return {"lane_cholesky_solve[f32]": lc.LAUNCHES_BY_DTYPE[torch.float32],
            "lane_cholesky_solve[f64]": lc.LAUNCHES_BY_DTYPE[torch.float64],
            "cholesky_solve": cs.LAUNCHES}


def check_undistort():
    """Say whether OpenCV imports here (the device tracker does not need
    it); if it does, hold PinholeCamera's NumPy undistortion to
    cv2.undistortPoints with a nonzero rad-tan distortion (1e-9)."""
    try:
        import cv2
    except ImportError:
        print("cv2 absent: the device tracker and PinholeCamera do not need it")
        return
    cam = PinholeCamera(458.6, 457.3, 367.2, 248.4,
                        dist=(-0.28, 0.07, 1e-4, -2e-4))
    pts = np.random.default_rng(0).uniform([0, 0], [640, 480], size=(400, 2))
    want = cv2.undistortPoints(pts.reshape(-1, 1, 2), cam.K,
                               cam.dist).reshape(-1, 2)
    err = float(np.abs(cam.undistort_normalize(pts) - want).max())
    print(f"cv2 {cv2.__version__} importable; PinholeCamera vs "
          f"cv2.undistortPoints max |d| {err:.3e}")
    if not err <= 1e-9:
        raise AssertionError(f"PinholeCamera undistortion off by {err}")


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
    check_undistort()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase("environment", t0, device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    return dev, smi


def build():
    t0 = time.perf_counter()
    names = ("lane_cholesky", "cholesky_solve")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    phase("build", t0, libraries=",".join(lib.name for lib in libs))
    # ptxas -v: registers, static shared memory and spills of each kernel
    # (its dynamic shared memory is the tile plan's, printed per shape)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if re.search(r"Compiling entry|registers|spill|smem", line):
                print(f"ptxas {name}: {line.strip()}")


def lane_numbers(dev, dtype, B, n):
    """Error, times and bound of lane_cholesky_solve at (B, n)."""
    A, b = spd(7, B, n, dev, dtype)
    x = lc.lane_cholesky_solve(A, b)
    xp = lc.lane_cholesky_solve_plain(A, b)
    torch.cuda.synchronize()

    def library():
        L = torch.linalg.cholesky_ex(A).L
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    es = A.element_size()
    # the lower triangle of A (all a Cholesky solve reads) and b in, x out
    bound_ms, bound_by = bound(
        es * (B * n * (n + 1) // 2 + 2 * B * n), B * (n ** 3 / 3 + 2 * n * n),
        F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S)
    return timed(dict(max_abs_err=float((x - xp).abs().max()),
                      bound_ms=bound_ms, bound_by=bound_by, shape=[B, n],
                      plan=lc.tile_plan(n, dtype)._asdict()),
                 lambda: lc.lane_cholesky_solve(A, b),
                 lambda: lc.lane_cholesky_solve_plain(A, b), library)


def timed(nums, kernel, plain, library):
    """nums with the kernel's, the plain version's and the library call's
    times (cuda_ms), the kernel's host enqueue time per call, its time
    taken one call at a time (one_call_ms) and its share of its bound."""
    ms, enqueue_ms = cuda_ms(kernel)
    nums.update(ms=ms, plain_ms=cuda_ms(plain, calls=2, reps=3)[0],
                library_ms=cuda_ms(library)[0], enqueue_ms=enqueue_ms,
                one_call_ms=one_call_ms(kernel),
                bound_share=nums["bound_ms"] / ms)
    return nums


def damping_is_seen(H, b, lam, xp, pad):
    """The inputs can tell the kernel's damping apart: without the lam term,
    or with lam[0] for every system, the plain version moves by more than
    5 TOL; on padded systems, without the 1e-12 term it is not finite."""
    B = H.shape[0]
    for what, x in (("no lam", cs.cholesky_solve_plain(H, b, 0.0)),
                    ("lam[0] for all",
                     cs.cholesky_solve_plain(H, b, lam[:1].expand(B)))):
        if not rel_err(x, xp) > 5 * TOL:
            raise AssertionError(f"cholesky_solve inputs B={B}: {what} moves "
                                 f"x by only {rel_err(x, xp)}")
    if pad:
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        x = lc.lane_cholesky_solve_plain(
            H + torch.diag_embed(lam[:, None] * d), -b)
        if torch.isfinite(x).all():
            raise AssertionError("cholesky_solve padded inputs: finite "
                                 "without the 1e-12 term")


def cholesky_solve_numbers(dev, B, n, pad=0, time_it=True):
    """Error, times and bound of cholesky_solve at (B, n), f32 (no times
    unless time_it)."""
    H, b, lam = spd_pallas(900 + n + B, B, n, dev, pad)
    x = cs.cholesky_solve(H, b, lam)
    xp = cs.cholesky_solve_plain(H, b, lam)
    torch.cuda.synchronize()
    damping_is_seen(H, b, lam, xp, pad)
    Hd = cs.damp(H, lam)

    def library():
        L = torch.linalg.cholesky_ex(Hd).L
        return torch.cholesky_solve(-b[..., None], L)[..., 0]

    # H's lower triangle, b and lam in, x out; the damping is n adds and
    # multiplies per system
    bound_ms, bound_by = bound(
        4 * (B * n * (n + 1) // 2 + 2 * B * n + B),
        B * (n ** 3 / 3 + 2 * n * n + 2 * n), F32_FLOP_PER_S)
    nums = dict(max_abs_err=float((x - xp).abs().max()),
                rel_err=rel_err(x, xp), bound_ms=bound_ms, bound_by=bound_by,
                shape=[B, n], plan=lc.tile_plan(n, torch.float32)._asdict())
    if not time_it:
        return nums
    return timed(nums, lambda: cs.cholesky_solve(H, b, lam),
                 lambda: cs.cholesky_solve_plain(H, b, lam), library)


def check_lane(dev, dtype, tol):
    """lane_cholesky_solve against its plain version at every n of
    LANE_N[dtype] and B of LANE_B, then on a batch whose middle system is
    not SPD: its x must hold NaN, as the plain version's does, and the
    others must agree as before."""
    label = "f32" if dtype == torch.float32 else "f64"
    worst = 0.0
    for n in LANE_N[dtype]:
        for B in LANE_B:
            A, b = spd(1000 * n + B, B, n, dev, dtype)
            err = rel_err(lc.lane_cholesky_solve(A, b),
                          lc.lane_cholesky_solve_plain(A, b))
            if not err < tol:
                raise AssertionError(f"lane_cholesky_solve {label} n={n} "
                                     f"B={B}: relative error {err} >= {tol}")
            worst = max(worst, err)
    for n in (37, 222):
        A, b = spd(3000 + n, 3, n, dev, dtype)
        A[1, n // 2, n // 2] = -1.0
        x, xp = lc.lane_cholesky_solve(A, b), lc.lane_cholesky_solve_plain(A, b)
        if not (torch.isnan(x[1]).any() and torch.isnan(xp[1]).any()):
            raise AssertionError(f"lane_cholesky_solve {label} n={n}: a "
                                 f"system that is not SPD gave no NaN")
        err = rel_err(x[[0, 2]], xp[[0, 2]])
        if not err < tol:
            raise AssertionError(f"lane_cholesky_solve {label} n={n}: beside "
                                 f"a system not SPD, relative error {err}")
    return worst


def check_kernels(dev):
    """Every kernel against its plain version at several shapes, then its
    numbers at its paths' shapes. Returns {row name: numbers}."""
    t0 = time.perf_counter()
    worst = check_lane(dev, torch.float32, TOL)
    phase("kernel lane_cholesky_solve[f32] checks", t0, max_rel_err=worst,
          n=list(LANE_N[torch.float32]), B=list(LANE_B))
    f32 = lane_numbers(dev, torch.float32, BATCH, 222)
    phase("kernel lane_cholesky_solve[f32]", t0, **f32)
    f32_single = lane_numbers(dev, torch.float32, 1, 222)
    phase("kernel lane_cholesky_solve[f32] at B=1", t0, **f32_single)

    t0 = time.perf_counter()
    worst = check_lane(dev, torch.float64, TOL_F64)
    phase("kernel lane_cholesky_solve[f64] checks", t0, max_rel_err=worst,
          n=list(LANE_N[torch.float64]), B=list(LANE_B))
    f64 = lane_numbers(dev, torch.float64, 1, 222)
    phase("kernel lane_cholesky_solve[f64]", t0, **f64)
    f64_batch = lane_numbers(dev, torch.float64, BATCH, 222)
    phase("kernel lane_cholesky_solve[f64] at B=128", t0, **f64_batch)

    t0 = time.perf_counter()
    per_shape = {}
    # (B, n, zero padding): the TPU kernel's tests' shapes, the batched
    # path's, n = 222 padded to 256 as the TPU kernel pads it, n either side
    # of 384 (streamed tiles), and n = 1800 (its panel too large for shared
    # memory; checked, not timed)
    for B, n, pad in ((3, 128, 0), (2, 222, 0), (128, 222, 0), (3, 256, 0),
                      (3, 384, 0), (2, 256, 34), (3, 383, 0), (3, 385, 0),
                      (2, 1800, 0)):
        nums = cholesky_solve_numbers(dev, B, n, pad, time_it=n < 1000)
        if not nums["rel_err"] < TOL:
            raise AssertionError(f"cholesky_solve B={B} n={n} pad={pad}: "
                                 f"relative error {nums['rel_err']} >= {TOL}")
        per_shape[(B, n, pad)] = nums
        phase(f"kernel cholesky_solve B={B} n={n} pad={pad}", t0, **nums)
    chol = dict(per_shape[(BATCH, 222, 0)])
    del chol["rel_err"]
    return {"lane_cholesky_solve[f32]": f32, "lane_cholesky_solve[f64]": f64,
            "cholesky_solve": chol}


def batched_problem(dev):
    """The batched path's input, as bench.py sets it up: the 10 s simulated
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
    """Run one solve with the launch counts set to 0 just before it; the
    f32 kernel's count, read just after, must be one launch per LM
    iteration, and no other kernel may launch."""
    t0 = time.perf_counter()
    reset_counts()
    out = solve(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    phase(label, t0, iters=ITERS, launches=counts)
    if counts != {"lane_cholesky_solve[f32]": ITERS,
                  "lane_cholesky_solve[f64]": 0, "cholesky_solve": 0}:
        raise AssertionError(f"{label}: launches {counts}, want {ITERS} "
                             f"of lane_cholesky_solve[f32] only")
    return out, counts


def batched_path(dev):
    """The batched full-width window solve, then the single-window path:
    launches counted, results checked and cross-checked against the CPU,
    then timed. Returns (launches per path, the batched solve's seconds,
    the problem)."""
    states, datas, opts = batched_problem(dev)
    (st, info), batched_counts = count_launches(
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
    _, single_counts = count_launches("solve_window", solve_window,
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

    batched_s = host_s(batched, 3)

    def single(i):
        solve_window(one_state._replace(p=one_state.p + 1e-7 * i), one_data,
                     opts)
        torch.cuda.synchronize()

    latency_ms = host_s(single, 3) * 1e3
    phase("timing", t0, windows_solved_per_s=BATCH / batched_s,
          single_window_latency_ms=latency_ms)
    counts = {"solve_window_batched": batched_counts,
              "solve_window": single_counts}
    return counts, batched_s, (states, datas, opts)


class FrameClock:
    """Host time of each input_image call of an estimator made while it was
    in the NON_LINEAR phase (the frame's fetch of the previous step, host
    work and dispatch of its own step), read after a sync: of the whole
    card for the streaming replays, as since PR 4; of the estimator's
    stream (the current one) alone for the image replay, whose tracker and
    EKF run on streams of their own and whose tracker's next frame is in
    flight on the worker thread by design."""

    def __init__(self, est, whole_device=True):
        self.ms = []
        inner = est.input_image
        sync = (torch.cuda.synchronize if whole_device
                else lambda: torch.cuda.current_stream().synchronize())

        def timed(t, feats):
            streaming = est.solver_flag == est.NON_LINEAR
            t0 = time.perf_counter()
            inner(t, feats)
            sync()
            if streaming:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        est.input_image = timed


def run_sequence(label, sim_cfg, dev, frames=STREAM_FRAMES,
                 keyframe_callback=None):
    """Replay `frames` camera frames of the sequence at full width on `dev`
    with the launch counts reset just before (keyframe_callback, if given,
    set on the estimator); returns (replay output, launches per kernel row,
    frames per second, median ms per NON_LINEAR frame)."""
    sim = simulate(sim_cfg)
    est = E.Estimator(EstimatorConfig(), device=dev)
    est.keyframe_callback = keyframe_callback
    clock = FrameClock(est) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    reset_counts()
    out = replay(sim, est=est, max_frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    fps = frames / wall
    ms = float(np.median(clock.ms)) if clock and clock.ms else float("nan")
    st = est.stats
    phase(label, t0, frames=frames, frames_per_s=fps,
          median_ms_per_nonlinear_frame=ms, ate_rmse=out["ate_rmse"],
          drift_pct=out["drift_pct"], keyframes=st["keyframes"],
          solves=st["solves"], init_solves=st["init_solves"],
          reboots=st["reboots"], launches=counts)
    return out, counts, fps, ms


def check_launches(label, out, counts):
    """The f64 kernel launches once per LM iteration of every solve the
    estimator made (ITERS per streaming solve, INIT_ITERS per
    initialization solve), and no other kernel launches."""
    st = out["estimator"].stats
    want = ITERS * st["solves"] + E.INIT_ITERS * st["init_solves"]
    if counts != {"lane_cholesky_solve[f32]": 0,
                  "lane_cholesky_solve[f64]": want, "cholesky_solve": 0}:
        raise AssertionError(f"{label}: launches {counts}, want {want} of "
                             f"lane_cholesky_solve[f64] only ({ITERS} x "
                             f"{st['solves']} solves + {E.INIT_ITERS} x "
                             f"{st['init_solves']} initialization solves)")


def streaming_path(dev):
    """Sequences A and B of tests/test_estimator_e2e.py at full width on the
    card with that test's gates, then the first CHECK_FRAMES frames of A on
    the card and on the CPU. Returns (launches per path, numbers)."""
    seq_a = SEQ_A
    # keyframes -> pose graph (tests/test_posegraph.py::
    # test_estimator_feeds_posegraph): A's keyframes stream into a pose
    # graph on the card
    pg = PoseGraph(min_overlap=5, min_gap=8, device=dev)
    out, counts_a, fps, ms = run_sequence(
        "streaming A", seq_a, dev,
        keyframe_callback=lambda t, p, q, ids, obs: pg.add_keyframe(
            p, _yaw_of_quat(q), ids))
    est = out["estimator"]
    check_launches("streaming A", out, counts_a)
    gates = {"solver_flag == NON_LINEAR": est.solver_flag == est.NON_LINEAR,
             "solves >= 5": est.stats["solves"] >= 5,
             "ate_rmse < 0.015": out["ate_rmse"] < 0.015,
             "drift_pct < 10": out["drift_pct"] < 10.0,
             "|rho - 0.21| < 0.02": bool(np.all(np.abs(est.rho - 0.21)
                                                < 0.02))}
    if not all(gates.values()):
        raise AssertionError(f"streaming A gates: {gates}")
    keyframes_to_pose_graph(pg, est)
    numbers = dict(frames_per_s=fps, median_ms_per_nonlinear_frame=ms,
                   ate_rmse=out["ate_rmse"], drift_pct=out["drift_pct"],
                   keyframes=est.stats["keyframes"],
                   solves=est.stats["solves"],
                   launches=counts_a["lane_cholesky_solve[f64]"])

    out_b, counts_b, _, _ = run_sequence(
        "streaming B", SimConfig(duration=3.0, speed=0.15, seed=7), dev)
    check_launches("streaming B", out_b, counts_b)
    est_b = out_b["estimator"]
    gates = {"keyframes < 20": est_b.stats["keyframes"] < STREAM_FRAMES,
             "ate_rmse < 0.15": out_b["ate_rmse"] < 0.15}
    if not all(gates.values()):
        raise AssertionError(f"streaming B gates: {gates}")

    # the first CHECK_FRAMES frames of A, on the card and on the CPU (the
    # port's plain versions): f64 both, so every discrete decision must
    # come out the same and positions agree to 1e-6 m
    t0 = time.perf_counter()
    card, counts_c, _, _ = run_sequence("streaming A, first frames", seq_a,
                                        dev, CHECK_FRAMES)
    check_launches("streaming A, first frames", card, counts_c)
    cpu, _, _, _ = run_sequence("streaming A, first frames on the CPU", seq_a,
                                torch.device("cpu"), CHECK_FRAMES)
    np.testing.assert_array_equal(card["est_t"], cpu["est_t"])
    np.testing.assert_allclose(card["est_p"], cpu["est_p"], rtol=0,
                               atol=1e-6, err_msg="card vs CPU est_p")
    sc, sp = card["estimator"].stats, cpu["estimator"].stats
    if sc["solves"] != sp["solves"] or sc["keyframes"] != sp["keyframes"]:
        raise AssertionError(f"card vs CPU counts: {sc} vs {sp}")
    phase("cross-check streaming vs CPU", t0, frames=CHECK_FRAMES,
          published=len(cpu["est_t"]), solves=sc["solves"],
          max_abs_dp=float(np.abs(card["est_p"] - cpu["est_p"]).max()))
    launches = {"streaming A": counts_a, "streaming B": counts_b}
    return launches, numbers


def rendered_pairs(sim, n):
    """The first n camera frames of `sim` as 640x480 stereo pairs (uint8),
    with the renderer (its focal length and principal point)."""
    r = ImageRenderer(sim, EstimatorConfig())
    return [r.render_stereo(int(k)) for k in sim["cam_idx"][:n]], r


def tracker_check(dev, sim):
    """_first_frame on frame 0, then track_frame on frames 1.. from equal
    inputs (the CPU's tracks and detections of the frame before), on the
    card and on the CPU: the same slots kept, positions kept by both within
    TRACK_POS_TOL px, stereo flags equal on >= TRACK_AGREE of the slots,
    the detections' ok sets equal but for at most 2 points."""
    t0 = time.perf_counter()
    pairs, _ = rendered_pairs(sim, TRACK_PAIRS)
    cfg = EstimatorConfig()
    N, md = cfg.max_cnt, cfg.min_dist
    args = dict(levels=4, half=10, iters=10, min_dist=md, fb_thresh=0.5,
                stereo=True)
    on = lambda d: lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
    cpu = torch.device("cpu")
    worst = dict(max_abs_dp=0.0, min_flag_agree=1.0, det_differ=0)

    def compare(label, got, want, ok_keys, pt_keys, exact=()):
        g = {k: v.cpu().numpy() for k, v in got.items() if k != "pyr0"}
        w = {k: v.numpy() for k, v in want.items() if k != "pyr0"}
        for k in exact:
            if not np.array_equal(g[k], w[k]):
                raise AssertionError(f"tracker check {label}: {k} differs, "
                                     f"card vs CPU")
        for ok, pt in zip(ok_keys, pt_keys):
            agree = float(np.mean(g[ok] == w[ok]))
            both = g[ok] & w[ok]
            dp = float(np.abs(g[pt][both] - w[pt][both]).max()) \
                if both.any() else 0.0
            worst["max_abs_dp"] = max(worst["max_abs_dp"], dp)
            worst["min_flag_agree"] = min(worst["min_flag_agree"], agree)
            if not (agree >= TRACK_AGREE and dp <= TRACK_POS_TOL):
                raise AssertionError(f"tracker check {label}: {ok} agree "
                                     f"{agree}, {pt} max |d| {dp} px")
        gd = set(map(tuple, g["det_pts"][g["det_ok"]].tolist()))
        wd = set(map(tuple, w["det_pts"][w["det_ok"]].tolist()))
        worst["det_differ"] = max(worst["det_differ"], len(gd ^ wd))
        if len(gd ^ wd) > 2:
            raise AssertionError(f"tracker check {label}: detections differ "
                                 f"by {len(gd ^ wd)} of {len(wd)}")
        return w

    card, host = (_first_frame(on(d)(pairs[0][0]), on(d)(pairs[0][1]),
                               max_new=N, **args) for d in (dev, cpu))
    torch.cuda.synchronize()
    ref = compare("_first_frame", card, host, ("r_ok",), ("r_pts",))
    kept = []
    for k in range(1, TRACK_PAIRS):
        n = int(ref["det_ok"].sum())
        pts = np.zeros((N, 2), np.float32)
        pts[:n] = ref["det_pts"][ref["det_ok"]]
        valid = np.arange(N) < n
        prio = np.where(valid, np.arange(N) % 3, -1).astype(np.int32)
        card, host = (klt.track_frame(
            tuple(klt.build_pyramid(on(d)(pairs[k - 1][0]), 4)),
            on(d)(pairs[k][0]), on(d)(pairs[k][1]), on(d)(pts),
            on(d)(valid), on(d)(pts), on(d)(prio), det_stereo=32, **args)
            for d in (dev, cpu))
        torch.cuda.synchronize()
        w = compare(f"track_frame {k}", card, host, ("keep", "r_ok"),
                    ("pts", "r_pts"), exact=("keep",))
        kept.append(int(w["keep"].sum()))
        # the next frame tracks what this one kept and detected, as the
        # device tracker does
        nxt = np.concatenate([w["pts"][w["keep"]],
                              w["det_pts"][w["det_ok"]]])[:N]
        ref = dict(det_pts=nxt, det_ok=np.ones(len(nxt), bool))
    phase("tracker check", t0, pairs=TRACK_PAIRS, slots=N, kept=kept,
          **worst)


def ekf_samples(ekf, sim, n):
    """Feed samples 0..n-1 as the replay does (init, then update_filter +
    get_contacts per sample); returns (contacts (n-1, 4), ms per sample)."""
    ekf.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    contacts = []
    t0 = time.perf_counter()
    for k in range(1, n):
        ekf.update_filter(sim["t"][k], sim["acc"][k], sim["gyr"][k],
                          sim["phi"][k], dphi=sim["dphi"][k],
                          foot_force=sim["foot_forces"][k])
        contacts.append(ekf.get_contacts())
    return np.array(contacts), (time.perf_counter() - t0) * 1e3 / (n - 1)


def ekf_check(dev, sim):
    """The legged EKF over sequence A's samples on the card and on the CPU
    (f64): every sample's contacts and the final state, P included, within
    EKF_TOL relative. Returns the ms per sample on each."""
    t0 = time.perf_counter()
    n = len(sim["t"])
    card = LeggedEKF(EstimatorConfig(), filter_window=4, device=dev)
    c_card, ms_card = ekf_samples(card, sim, n)
    host = LeggedEKF(EstimatorConfig(), filter_window=4, device="cpu")
    c_cpu, ms_cpu = ekf_samples(host, sim, n)
    errs = {"contacts": float(np.abs(c_card - c_cpu).max())}
    got = convert.ekf_state_to_numpy(card.state)
    for name, a, b in zip(got._fields, got,
                          convert.ekf_state_to_numpy(host.state)):
        if a.dtype.kind == "f":
            errs[name] = float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                          1e-300))
    if not (max(errs.values()) <= EKF_TOL
            and np.array_equal(c_card > 0.5, c_cpu > 0.5)):
        raise AssertionError(f"ekf check: card vs CPU {errs}")
    phase("ekf check", t0, samples=n, max_rel_err=max(errs.values()),
          ekf_ms_per_sample_card=ms_card, ekf_ms_per_sample_cpu=ms_cpu)
    return dict(ekf_ms_per_sample_card=ms_card, ekf_ms_per_sample_cpu=ms_cpu)


def image_setup(dev, sim, frames):
    """The image path's parts at full width on `dev`: the first `frames`
    camera frames prerendered (640x480 stereo), the default estimator, the
    device tracker and the legged EKF (filter window 4)."""
    cfg = EstimatorConfig()
    r = ImageRenderer(sim, cfg)
    frames_src = PrerenderedFrames(r, sorted(sim["cam_idx"])[:frames])
    cam = PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
    tracker = DeviceTracker(cam, cam, max_cnt=cfg.max_cnt,
                            min_dist=cfg.min_dist, flow_back=cfg.flow_back,
                            levels=4, half=10, iters=10, det_stereo=32,
                            device=dev)
    return (frames_src, E.Estimator(cfg, device=dev), tracker,
            LeggedEKF(cfg, filter_window=4, device=dev))


def image_replay(dev, sim):
    """Sequence A's image replay at full width, pipelined, on the card:
    gates, launches, times. Returns (launches, numbers)."""
    frames_src, est, tracker, ekf = image_setup(dev, sim, STREAM_FRAMES)
    clock = FrameClock(est, whole_device=False)
    alive, ekf_ms = [], [0.0]
    track = tracker.track

    def counted_track(t, img0, img1):
        out = track(t, img0, img1)
        alive.append(len(out))
        return out

    tracker.track = counted_track
    for name in ("update_filter", "get_contacts"):
        inner = getattr(ekf, name)

        def timed(*a, _inner=inner, **kw):
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            ekf_ms[0] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(ekf, name, timed)
    t0 = time.perf_counter()
    reset_counts()
    out = replay_images(sim, est=est, tracker=tracker, renderer=frames_src,
                        ekf=ekf, max_frames=STREAM_FRAMES,
                        pipeline_frontend=True)
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    st = est.stats
    nums = dict(frames=STREAM_FRAMES, frames_per_s=STREAM_FRAMES / wall,
                median_ms_per_nonlinear_frame=float(np.median(clock.ms)),
                track_ms_per_frame=out["track_ms_per_frame"],
                render_ms_per_frame=out["render_ms_per_frame"],
                ekf_ms_per_sample=ekf_ms[0] / (len(sim["t"]) - 1),
                ate_rmse=out["ate_rmse"], drift_pct=out["drift_pct"],
                keyframes=st["keyframes"], solves=st["solves"],
                init_solves=st["init_solves"], reboots=st["reboots"],
                f64_launches=counts["lane_cholesky_solve[f64]"],
                tracks_alive=alive, prerender_s=frames_src.prerender_s)
    phase("image replay A", t0, launches=counts, **nums)
    check_launches("image replay A", out, counts)
    gates = {"solver_flag == NON_LINEAR": est.solver_flag == est.NON_LINEAR,
             "reboots == 0": st["reboots"] == 0,
             f"ate_rmse <= {ATE_GATE}": out["ate_rmse"] <= ATE_GATE,
             "a f64 launch per LM iteration": counts[
                 "lane_cholesky_solve[f64]"] > 0,
             "tracker frames": out["tracker"].stats["frames"]
             == STREAM_FRAMES}
    if not all(gates.values()):
        raise AssertionError(f"image replay A gates: {gates}")
    return counts, nums


def keyframes_to_pose_graph(pg, est):
    """The pose graph fed by streaming A's keyframe_callback: gates of
    tests/test_posegraph.py::test_estimator_feeds_posegraph."""
    t0 = time.perf_counter()
    gates = {"NON_LINEAR": est.solver_flag == est.NON_LINEAR,
             "pg.n >= 5": pg.n >= 5,
             "edges >= pg.n - 1": len(pg.edges) >= pg.n - 1}
    pg.optimize(iters=4)
    gates["finite after optimize(iters=4)"] = bool(
        np.isfinite(pg.p[:pg.n]).all() and np.isfinite(pg.yaw[:pg.n]).all())
    phase("keyframes -> pose graph", t0, nodes=pg.n, edges=len(pg.edges),
          loop_edges=pg.n_loop_edges, stats=pg.stats)
    if not all(gates.values()):
        raise AssertionError(f"keyframes -> pose graph gates: {gates}")


class GuardLog:
    """Wraps a PoseGraph's optimize and _optimize_once: the host time of
    each (the device's GN and the one fetch are inside _optimize_once), and
    per optimize call (nodes, loop edges in, rollbacks, pruned edges and
    device optimizes it added, the node positions after)."""

    def __init__(self, pg):
        self.calls, self.once_s, self.optimize_s = [], [], 0.0
        opt, once = pg.optimize, pg._optimize_once

        def timed_once(*a, **kw):
            t = time.perf_counter()
            once(*a, **kw)
            self.once_s.append(time.perf_counter() - t)

        def logged(*a, **kw):
            before = dict(pg.stats)
            loops = pg.n_loop_edges
            t = time.perf_counter()
            opt(*a, **kw)
            self.optimize_s += time.perf_counter() - t
            self.calls.append((pg.n, loops) + tuple(
                pg.stats[k] - before[k] for k in
                ("rollbacks", "pruned_edges", "optimizes")))
            self.positions.append(pg.p[:pg.n].copy())

        self.positions = []
        pg._optimize_once, pg.optimize = timed_once, logged


def loop_backend(dev):
    """The loop back-end at full width on the card (LoopCloser defaults:
    640x480 left images, 23x23 patches, 12x16 tiny images, exclude_last 40,
    min_sim 0.5, optimize_every 10, seq/loop weights 100/10, Cauchy, a
    512-node pool that grows) fed StreetStream's 889 keyframes (2.2 laps of
    the street circuit): gates, counts, times. Then the recorded stream
    replayed on the CPU for CPU_REPLAY_S, every guard decision compared, and
    the final graph's optimize_pose_graph on the card against the CPU.
    Returns (launches, numbers, the final pose graph)."""
    t0 = time.perf_counter()
    stream = StreetStream(STREET_KEYFRAMES)
    phase("street stream set-up", t0, keyframes=len(stream),
          landmarks=len(stream.lm))
    t0 = time.perf_counter()
    reset_counts()
    closer = LoopCloser(EstimatorConfig(), record=True, device=dev)
    log = GuardLog(closer.pg)
    refused, kept, make_s, add_s = 0, [], 0.0, 0.0
    for k in range(len(stream)):
        t = time.perf_counter()
        rec = stream.record(k)
        t1 = time.perf_counter()
        node = closer.add_keyframe(*rec)
        add_s += time.perf_counter() - t1
        make_s += t1 - t
        refused += node == -1
        if node >= 0:
            kept.append(k)
    t = time.perf_counter()
    closer.finish()
    add_s += time.perf_counter() - t
    wall = time.perf_counter() - t0
    counts = read_counts()
    pg = closer.pg
    gt = stream.truth[kept]
    corr, odo = score(closer.corrected(), gt), score(closer.odometric(), gt)
    finite = bool(np.isfinite(pg.p[:pg.n]).all()
                  and np.isfinite(pg.yaw[:pg.n]).all())
    nums = dict(keyframes=len(stream), nodes=pg.n, Nc=pg.Nc,
                refused_for_capacity=refused, skipped=closer.kf_skipped,
                loops_found=closer.loops_found,
                loops_rejected=closer.loops_rejected,
                seq_gated=closer.seq_gated, best_sim=closer.best_sim,
                **pg.stats, corrected_ate_m=corr["ate_rmse"],
                odometric_ate_m=odo["ate_rmse"],
                corrected_drift_pct=corr["drift_pct"],
                odometric_drift_pct=odo["drift_pct"],
                ms_per_device_optimize=1e3 * float(np.mean(log.once_s)),
                device_optimizes=len(log.once_s),
                ms_per_optimize_call=1e3 * log.optimize_s
                / max(len(log.calls), 1),
                optimize_share=log.optimize_s / wall,
                host_ms_per_keyframe=1e3 * (add_s - log.optimize_s)
                / len(stream),
                make_ms_per_keyframe=1e3 * make_s / len(stream),
                phase_s=wall, launches=counts)
    phase("loop back-end street", t0, **nums)
    gates = {"no keyframe refused for capacity": refused == 0,
             "loops_found >= 1": closer.loops_found >= 1,
             "corrected ATE < odometric ATE":
                 corr["ate_rmse"] < odo["ate_rmse"],
             "node pool grown to 1024": pg.Nc == 1024,
             "every state finite": finite}
    if not all(gates.values()):
        raise AssertionError(f"loop back-end street gates: {gates}")
    nums["guard"] = loop_replay_on_cpu(closer, log)
    nums["optimize_check"] = optimize_check(pg, dev)
    return nums.pop("launches"), nums, pg


def loop_replay_on_cpu(closer, log):
    """The card's recorded keyframes through a LoopCloser on the CPU for
    CPU_REPLAY_S seconds: every optimize call's guard decisions (rollbacks,
    prunes, device optimizes) and counts compared with the card's, and the
    node positions after each. Differences are printed, not hidden."""
    t0 = time.perf_counter()
    cpu = LoopCloser(EstimatorConfig(), device="cpu")
    cpu_log = GuardLog(cpu.pg)
    fed = 0
    for rec in closer.records:
        if time.perf_counter() - t0 > CPU_REPLAY_S:
            break
        cpu.add_keyframe_precomputed(rec)
        fed += 1
    n = len(cpu_log.calls)
    differ = [(i, a, b) for i, (a, b) in
              enumerate(zip(log.calls[:n], cpu_log.calls)) if a != b]
    dp = max((float(np.abs(a - b).max()) for a, b in
              zip(log.positions[:n], cpu_log.positions)
              if a.shape == b.shape), default=0.0)
    nums = dict(keyframes_replayed=fed, of=len(closer.records),
                optimize_calls_compared=n,
                guard_decisions_differ=len(differ),
                max_abs_dp_after_optimize=dp,
                cpu_ms_per_device_optimize=1e3 * float(np.mean(
                    cpu_log.once_s)) if cpu_log.once_s else None)
    phase("loop back-end guard replay on the CPU", t0, **nums)
    for i, a, b in differ:
        print(f"guard decision differs at optimize call {i}: card "
              f"(nodes, loop edges, +rollbacks, +pruned, +optimizes) {a}, "
              f"CPU {b}")
    return nums


def optimize_check(pg, dev):
    """optimize_pose_graph of the final graph (Nc = 1024, the padded edge
    pool) on the card and on the CPU, 8 iterations each, timed: PG_TOL."""
    t0 = time.perf_counter()
    args = (pg.p, pg.yaw) + pg.padded_edges()
    kw = dict(robust_scale=pg.robust_scale, robust_kind=pg.robust_kind)

    def run(device):
        t = time.perf_counter()
        p, yaw = optimize_pose_graph(*args, **kw, device=device)
        out = torch.cat([p, yaw[:, None]], 1).cpu().numpy()
        return out, (time.perf_counter() - t) * 1e3

    run(dev)
    card, card_ms = run(dev)
    host, cpu_ms = run("cpu")
    err = float(np.abs(card - host).max() / np.abs(host).max())
    nums = dict(Nc=pg.Nc, edges=len(args[2]), card_ms=card_ms,
                cpu_ms=cpu_ms, max_rel_err=err)
    phase("loop back-end optimize check", t0, **nums)
    if not err <= PG_TOL:
        raise AssertionError(f"optimize_pose_graph card vs CPU: {err}")
    return nums


def fleet(dev):
    """BASELINE config 5 at one card's batch: build_fleet(4 segments x 32
    perturbations) = 128 windows at F = 96, f32, solved for ITERS LM
    iterations through solve_fleet with the launches counted; gates of
    tests/test_fleet.py; 8 windows cross-checked against the CPU; timed;
    then the pooled calibration step from a common rho offset, against the
    CPU. Returns (launches, numbers)."""
    t0 = time.perf_counter()
    states, datas, truths = build_fleet(n_segments=FLEET_SEGMENTS,
                                        n_perturb=FLEET_PERTURB, device=dev)
    torch.cuda.synchronize()
    B = states.p.shape[0]
    phase("build_fleet", t0, windows=B, F=datas.f_valid.shape[-1])
    opts = SolveOptions(max_iters=ITERS)
    t0 = time.perf_counter()
    reset_counts()
    res = solve_fleet(states, datas, truths, None, opts)
    torch.cuda.synchronize()
    counts = read_counts()
    cost0, cost = res.cost0.cpu().numpy(), res.cost.cpu().numpy()
    err = res.traj_err.cpu().numpy()
    phase("solve_fleet", t0, launches=counts,
          median_traj_err_m=float(np.median(err)),
          cost_reduced=int((cost < cost0).sum()))
    if counts != {"lane_cholesky_solve[f32]": ITERS,
                  "lane_cholesky_solve[f64]": 0, "cholesky_solve": 0}:
        raise AssertionError(f"fleet: launches {counts}, want {ITERS} of "
                             f"lane_cholesky_solve[f32] only")
    gates = {"every cost < cost0": bool(np.all(cost < cost0)),
             "median traj_err < 0.02 m": float(np.median(err)) < 0.02,
             "finite": bool(np.isfinite(cost).all())}
    if not all(gates.values()):
        raise AssertionError(f"fleet gates: {gates}")

    t0 = time.perf_counter()
    head = lambda x: x[:CHECK_WINDOWS].cpu()
    cpu = solve_fleet(*(fac.map_tensors(head, x)
                        for x in (states, datas, truths)), None, opts)
    np.testing.assert_allclose(cost[:CHECK_WINDOWS], cpu.cost.numpy(),
                               rtol=1e-3, err_msg="fleet cost card vs CPU")
    np.testing.assert_allclose(res.states.p[:CHECK_WINDOWS].cpu().numpy(),
                               cpu.states.p.numpy(), rtol=0, atol=1e-3,
                               err_msg="fleet p card vs CPU")
    phase("fleet cross-check vs CPU", t0, windows=CHECK_WINDOWS)

    def solve(i):
        solve_fleet(states._replace(p=states.p + 1e-7 * i), datas, truths,
                    None, opts)
        torch.cuda.synchronize()

    fleet_s = host_s(solve, 3)
    nums = dict(windows=B, windows_solved_per_s=B / fleet_s,
                median_traj_err_m=float(np.median(err)),
                max_traj_err_m=float(err.max()))

    # pooled calibration from a common 4 mm calf-length offset
    t0 = time.perf_counter()
    off = truths._replace(rho=truths.rho + 0.004)
    new, dx, H, b = pooled_calibration_step(off, datas)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    _, dx_c, H_c, b_c = pooled_calibration_step(
        fac.map_tensors(lambda x: x.cpu(), off),
        fac.map_tensors(lambda x: x.cpu(), datas))
    cpu_ms = (time.perf_counter() - t1) * 1e3
    e0 = float((off.rho - truths.rho).abs().mean())
    e1 = float((new.rho - truths.rho).abs().mean())
    errs = {k: float((a.cpu() - c).abs().max() / c.abs().max())
            for k, a, c in (("H", H, H_c), ("b", b, b_c), ("dx", dx, dx_c))}
    nums.update(pooled_rho_err_before=e0, pooled_rho_err_after=e1,
                pooled_card_ms=card_ms, pooled_cpu_ms=cpu_ms,
                pooled_rel_err=errs)
    phase("fleet", t0, **nums)
    if not (e1 < e0 and max(errs.values()) < TOL):
        raise AssertionError(f"pooled calibration: rho error {e0} -> {e1}, "
                             f"card vs CPU {errs}")
    return counts, nums


def sfm_inputs(seed=5, NF=11, F=160, K=10):
    """Equal inputs for the initial-SfM check at the estimator's window (11
    frames, F = 160): tests/test_initial_sfm.py's constructions at that
    size. Returns a dict of numpy arrays and the truths for the gates."""
    rng = np.random.default_rng(seed)
    f64 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)
    rot = lambda v: lie.quat_to_rot(lie.so3_exp_quat(f64(v))).numpy()
    quat = lambda v: lie.so3_exp_quat(f64(v)).numpy()
    out = {}
    # relative pose: F points, 0.15 px noise
    X = rng.uniform([-3, -3, 4], [3, 3, 12], size=(F, 3))
    R, t = rot(rng.normal(size=3) * 0.2), np.array([0.4, -0.1, 0.15])
    pc0, pc1 = X, X @ R.T + t
    n = 0.15 / 460.0
    out["p0"] = pc0[:, :2] / pc0[:, 2:] + rng.normal(size=(F, 2)) * n
    out["p1"] = pc1[:, :2] / pc1[:, 2:] + rng.normal(size=(F, 2)) * n
    out["mask"] = (pc0[:, 2] > 0) & (pc1[:, 2] > 0)
    out["R"], out["t"] = R, t
    # ex rotation: K rotation pairs
    q_ic = quat([0.2, -0.5, 0.15])
    qb = np.stack([quat(rng.normal(size=3) * 0.2) for _ in range(K)])
    qi = lie.quat_conj(f64(q_ic))
    out["q_imu"] = qb
    out["q_cam"] = lie.quat_mul(qi, lie.quat_mul(f64(qb), f64(q_ic))).numpy()
    out["q_ic"] = q_ic
    # global SfM window: NF frames on an arc, F points
    ts = np.linspace(0, 1, NF)
    centers = np.stack([2.0 * ts, 0.3 * np.sin(2 * ts), 0 * ts], -1)
    Rs = np.stack([rot([0.02 * k, 0.03 * k, 0.1 * k]) for k in range(NF)])
    Xw = rng.uniform([-4, -4, 3], [8, 4, 10], size=(F, 3))
    f_pts, f_obs = np.zeros((F, NF, 2)), np.zeros((F, NF), bool)
    for i in range(NF):
        pc = (Xw - centers[i]) @ Rs[i]
        ok = pc[:, 2] > 0.5
        f_pts[ok, i] = pc[ok, :2] / pc[ok, 2:3]
        f_obs[:, i] = ok
    out["f_pts"] = f_pts + rng.normal(size=f_pts.shape) * (0.3 / 460.0)
    out["f_obs"] = f_obs
    out["q_rel"] = lie.rot_to_quat(f64(Rs[0].T @ Rs[-1])).numpy()
    out["p_rel"] = Rs[0].T @ (centers[-1] - centers[0])
    out["p_gt"], out["X_gt"] = (centers - centers[0]) @ Rs[0], \
        (Xw - centers[0]) @ Rs[0]
    # visual-IMU alignment: K intervals of 0.3 s, scale 2.7
    dt, g_w, s_true = np.full(K, 0.3), np.array([0.0, 0.0, 9.805]), 2.7
    q = [np.array([1.0, 0, 0, 0])]
    for _ in range(K):
        q.append(lie.quat_mul(f64(q[-1]), f64(quat(
            rng.normal(size=3) * 0.15))).numpy())
    q = np.stack(q)
    v = rng.normal(size=(K + 1, 3)) * 0.5
    p = np.zeros((K + 1, 3))
    dp, dv = np.zeros((K, 3)), np.zeros((K, 3))
    Rb = lie.quat_to_rot(f64(q)).numpy()
    for k in range(K):
        a_w = (v[k + 1] - v[k]) / dt[k]
        p[k + 1] = p[k] + v[k] * dt[k] + 0.5 * a_w * dt[k] ** 2
        dp[k] = Rb[k].T @ (p[k + 1] - p[k] - v[k] * dt[k]
                           + 0.5 * g_w * dt[k] ** 2)
        dv[k] = Rb[k].T @ (v[k + 1] - v[k] + g_w * dt[k])
    tic = np.array([0.1, 0.02, -0.03])
    out["align"] = ((p + np.einsum("kij,j->ki", Rb, tic)) / s_true, q, dp,
                    dv, dt, tic, np.eye(3))
    out["g_w"], out["s_true"] = g_w, s_true
    # gyro / leg bias: K preintegrations' rotation and leg blocks
    from cerberus_tpu_torch.ops.preintegration import ILPreint
    out["preints"] = [ILPreint(*(f64(x) for x in (
        np.zeros(3), quat(rng.normal(size=3) * 0.1), np.zeros(3),
        rng.normal(size=(4, 3)) * 0.05, np.zeros(3),
        rng.normal(size=(31, 31)) * 0.1, np.eye(31), 0.1, np.zeros(3),
        np.zeros(3), np.full(4, 0.21), np.ones(4), np.ones(4), np.zeros(4),
        np.zeros(4), np.zeros((4, 1)), np.zeros(4)))) for _ in range(K)]
    out["q_frames"] = np.stack([quat(rng.normal(size=3) * 0.3)
                                for _ in range(K + 1)])
    out["p_frames"] = rng.normal(size=(K + 1, 3))
    return out


def sfm_check(dev):
    """The initial SfM and alignment on the card and on the CPU on equal
    inputs at the estimator's window (sfm_inputs): relative_pose on one
    hypothesis set (128, drawn on the CPU), calibrate_ex_rotation,
    global_sfm, visual_imu_alignment, solve_gyroscope_bias and
    solve_gyro_leg_bias within SFM_TOL relative (R, t and quaternions up to
    sign); then tests/test_initial_sfm.py's accuracy gates on the card's
    results, the relative pose from the card's own draw. Returns (launches,
    numbers)."""
    t0 = time.perf_counter()
    x = sfm_inputs()
    reset_counts()
    idx = isfm.draw_hypotheses(torch.as_tensor(x["mask"]), 128, 0)
    cpu = torch.device("cpu")

    def run(d):
        t = time.perf_counter()
        on = lambda a: torch.as_tensor(np.asarray(a), device=d)
        rel = isfm.relative_pose_from_hypotheses(
            idx.to(d), on(x["p0"]), on(x["p1"]), on(x["mask"]))
        ex = isfm.calibrate_ex_rotation(x["q_cam"], x["q_imu"],
                                        np.ones(len(x["q_cam"]), bool),
                                        device=d)
        sfm = isfm.global_sfm(0, x["q_rel"], x["p_rel"], x["f_pts"],
                              x["f_obs"], device=d)
        al = isfm.visual_imu_alignment(*x["align"], 9.805, device=d)
        gb = ialign.solve_gyroscope_bias(x["q_frames"], x["preints"],
                                         device=d)
        glb = ialign.solve_gyro_leg_bias(x["q_frames"], x["p_frames"],
                                         x["preints"], device=d)
        out = {"R": rel[0], "t": rel[1], "inliers": rel[2], "q_ic": ex[0],
               "ex_ok": ex[1], "sfm_q": sfm.q, "sfm_p": sfm.p,
               "sfm_pts": sfm.pts, "sfm_pts_ok": sfm.pts_ok,
               "sfm_ok": sfm.ok, "v": al[0], "g": al[1], "s": al[2],
               "al_ok": al[3], "bg": gb, "bg2": glb[0], "rho": glb[1]}
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return out, (time.perf_counter() - t) * 1e3

    run(dev)
    card, card_ms = run(dev)
    counts = read_counts()
    host, cpu_ms = run(cpu)
    for k in ("inliers", "ex_ok", "sfm_pts_ok", "sfm_ok", "al_ok"):
        if not np.array_equal(card[k], host[k]):
            raise AssertionError(f"sfm check: {k} differs, card vs CPU")
    sign = np.sign(np.sum(card["sfm_q"] * host["sfm_q"], axis=1))[:, None]
    card["sfm_q"] = card["sfm_q"] * sign
    ok = host["sfm_pts_ok"]
    card["sfm_pts"], host["sfm_pts"] = card["sfm_pts"][ok], host["sfm_pts"][ok]
    errs = {k: float(np.abs(card[k] - host[k]).max()
                     / max(np.abs(host[k]).max(), 1e-300))
            for k in card if card[k].dtype.kind == "f"}
    # the accuracy gates, on the card's results
    Re, te, inl = (a.cpu().numpy() for a in isfm.relative_pose_ransac(
        x["p0"], x["p1"], x["mask"], seed=0, device=dev))
    ang = np.degrees(np.arccos(np.clip((np.trace(Re @ x["R"].T) - 1) / 2,
                                       -1, 1)))
    cos = abs(te @ x["t"]) / np.linalg.norm(te) / np.linalg.norm(x["t"])
    gates = {"relative pose (own draw) < 1 deg": ang < 1.0,
             "translation cos > 0.995": cos > 0.995,
             "ex rotation |q . q_ic| > 0.9999":
                 abs(float(card["q_ic"] @ x["q_ic"])) > 0.9999,
             "sfm ok": bool(card["sfm_ok"]),
             "sfm positions < 0.05 m": float(np.linalg.norm(
                 card["sfm_p"] - x["p_gt"], axis=1).max()) < 0.05,
             "sfm points median < 0.05 m": float(np.median(np.linalg.norm(
                 card["sfm_pts"] - x["X_gt"][ok], axis=1))) < 0.05,
             "sfm points >= 0.8 F": ok.sum() >= 0.8 * len(ok),
             "scale within 2 %": abs(float(card["s"]) - x["s_true"])
             < 0.02 * x["s_true"],
             "gravity within 0.05": float(np.linalg.norm(
                 card["g"] - x["g_w"])) < 0.05}
    phase("sfm check", t0, card_ms=card_ms, cpu_ms=cpu_ms,
          max_rel_err=max(errs.values()), worst=max(errs, key=errs.get),
          own_draw_inliers=int(inl.sum()), of=len(inl))
    if not (max(errs.values()) <= SFM_TOL and all(gates.values())):
        raise AssertionError(f"sfm check: card vs CPU {errs}, gates {gates}")
    return counts, dict(card_ms=card_ms, cpu_ms=cpu_ms,
                        max_rel_err=max(errs.values()))


def profile_spans(label, fn, spans, total):
    """Run fn() once under torch.profiler; print host ms per span (summed
    over its calls), the device time of the kernels, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return report_spans(label, prof.key_averages(), spans, total)


def report_spans(label, events, spans, total):
    """Print host ms per span, kernel time and count, the device's busy
    share over `total` (a span's name, or a number of ms) and the top
    kernels and host ops. Returns (host ms per span, kernel ms)."""
    by_key = {e.key: e for e in events
              if e.key in spans and e.device_type
              == torch.autograd.DeviceType.CPU}
    host_ms = {k: by_key[k].cpu_time_total / 1e3 for k in by_key}
    calls = {k: by_key[k].count for k in by_key}
    # device-side events only, without the spans' own device ranges (the
    # rule torch.profiler's "Self CUDA time total" uses)
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    total_ms = host_ms[total] if isinstance(total, str) else total
    print(f"profile {label} host ms: " + " ".join(
        f"{k}={host_ms.get(k, 0.0):.3f} ({calls.get(k, 0)} calls)"
        for k in spans))
    print(f"profile {label} device: kernel_ms={device_ms:.3f} "
          f"kernels={sum(e.count for e in on_device)} "
          f"busy_share_profiled={device_ms / total_ms:.4f}")
    print(events.table(sort_by="self_device_time_total", row_limit=8,
                       max_name_column_width=50))
    print(events.table(sort_by="self_cpu_time_total", row_limit=8,
                       max_name_column_width=50))
    return host_ms, device_ms


def profile_image_frame(dev, sim, frame=13):
    """One frame of the image replay under torch.profiler: the work between
    the estimator's (frame-1)-th and frame-th input_image calls — the EKF
    and estimator samples, the tracker's frame, the estimator's frame —
    run sequentially (pipeline_frontend=False) on the card. The frame before
    it is timed unprofiled in the same run."""
    from torch.profiler import ProfilerActivity, profile

    frames_src, est, tracker, ekf = image_setup(dev, sim, frame + 1)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    inner, calls, marks = est.input_image, [0], {}

    def hooked(t, feats):
        inner(t, feats)
        calls[0] += 1
        if calls[0] in (frame - 2, frame - 1, frame):
            torch.cuda.synchronize()
            marks[calls[0]] = time.perf_counter()
        if calls[0] == frame - 1:
            prof.start()
        elif calls[0] == frame:
            prof.stop()

    est.input_image = hooked
    replay_images(sim, est=est, tracker=tracker, renderer=frames_src,
                  ekf=ekf, max_frames=frame + 1, pipeline_frontend=False)
    unprofiled_ms = (marks[frame - 1] - marks[frame - 2]) * 1e3
    profiled_ms = (marks[frame] - marks[frame - 1]) * 1e3
    spans = ("ekf_step", "track_frame", "tracker_host", "preint_fold",
             "build_window_data", "lm_solve", "assemble", "solve_step",
             "reproj_gate", "marginalize")
    _, device_ms = report_spans("image frame", prof.key_averages(), spans,
                                profiled_ms)
    print(f"profile image frame: profiled {profiled_ms:.3f} ms, the frame "
          f"before unprofiled {unprofiled_ms:.3f} ms, busy_share_unprofiled"
          f"={device_ms / unprofiled_ms:.4f}, estimator "
          f"{'NON_LINEAR' if est.solver_flag == est.NON_LINEAR else 'INITIAL'}")


def profile_pose_graph(pg, unprofiled_ms):
    """One optimize_pose_graph of the loop back-end's final graph (8
    iterations at its Nc) under torch.profiler: host ms of its assembly and
    LU spans and the device time of their kernels."""
    args = (pg.p, pg.yaw) + pg.padded_edges()
    dev = torch.device("cuda")
    args = tuple(torch.as_tensor(np.asarray(a), device=dev) for a in args)

    def one():
        p, yaw = optimize_pose_graph(*args, robust_kind=pg.robust_kind,
                                     device=dev)
        return torch.cat([p, yaw[:, None]], 1).cpu()

    one()
    _, device_ms = profile_spans(f"pose graph optimize (Nc={pg.Nc})", one,
                                 ("posegraph_assemble", "posegraph_solve"),
                                 unprofiled_ms)
    print(f"profile pose graph optimize: unprofiled {unprofiled_ms:.3f} ms, "
          f"busy_share_unprofiled={device_ms / unprofiled_ms:.4f}")


def profile_runs(problem, batched_s, dev):
    """One batched solve, then one streaming step (mode 'old', the first
    step of a short full-width replay, with the fold of interval 9), each
    under torch.profiler; the step is also timed unprofiled."""
    t0 = time.perf_counter()
    states, datas, opts = problem
    _, device_ms = profile_spans(
        "batched", lambda: solve_window_batched(states, datas, opts),
        ("lm_solve", "assemble", "solve_step"), "lm_solve")
    print(f"profile batched: busy_share_unprofiled="
          f"{device_ms / (batched_s * 1e3):.4f} "
          f"(unprofiled solve {batched_s * 1e3:.3f} ms)")

    rec = {}
    step = E._streaming_step

    def spy(*args, **kw):
        rec.setdefault("call", (args, kw))
        return step(*args, **kw)

    E._streaming_step = spy
    try:
        replay(simulate(SEQ_A), est=E.Estimator(EstimatorConfig(), device=dev),
               max_frames=12)
    finally:
        E._streaming_step = step
    args, kw = rec["call"]

    def one_step():
        out = step(*args, **kw)
        torch.cuda.synchronize()
        return out

    one_step()
    step_s = host_s(lambda i: one_step(), 3)
    spans = ("preint_fold", "build_window_data", "lm_solve", "assemble",
             "solve_step", "reproj_gate", "marginalize")
    host_ms, device_ms = profile_spans("streaming step", one_step, spans,
                                       "lm_solve")
    print(f"profile streaming step: unprofiled {step_s * 1e3:.3f} ms, "
          f"busy_share_unprofiled={device_ms / (step_s * 1e3):.4f}")
    profile_image_frame(dev, simulate(SEQ_A))
    phase("profile", t0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one batched solve, one "
                             "streaming step, one image replay frame and "
                             "one pose-graph optimize")
    args = parser.parse_args()
    dev, smi = environment()
    build()
    numbers = check_kernels(dev)
    launches, batched_s, problem = batched_path(dev)
    stream_launches, stream = streaming_path(dev)
    launches.update(stream_launches)
    print("streaming: " + json.dumps(stream))
    sim_a = simulate(SEQ_A)
    tracker_check(dev, sim_a)
    image = ekf_check(dev, sim_a)
    launches["image replay A"], nums = image_replay(dev, sim_a)
    image.update(nums)
    print("image replay: " + json.dumps(image))
    launches["loop back-end street"], loop, loop_pg = loop_backend(dev)
    print("loop back-end: " + json.dumps(loop))
    launches["fleet"], fleet_nums = fleet(dev)
    print("fleet: " + json.dumps(fleet_nums))
    launches["sfm check"], sfm = sfm_check(dev)
    print("sfm: " + json.dumps(sfm))
    if args.profile:
        profile_runs(problem, batched_s, dev)
        profile_pose_graph(loop_pg, loop["optimize_check"]["card_ms"])
    print("kernels: " + " ".join(
        f"{name}={counts[name]} ({path})"
        for name, _ in KERNELS for path, counts in launches.items()))
    main_path = {"lane_cholesky_solve[f32]": "solve_window_batched",
                 "lane_cholesky_solve[f64]": "image replay A",
                 "cholesky_solve": "solve_window_batched"}
    rows = []
    for (name, dtype), meta in KERNELS.items():
        rows.append(dict(
            name=name, **meta, launches=launches[main_path[name]][name],
            launches_by_path={p: c[name] for p, c in launches.items()},
            **numbers[name]))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
