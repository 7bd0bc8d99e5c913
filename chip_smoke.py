#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cerberus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed with its elapsed seconds:
  1. environment: torch and CUDA versions, the card's name and power limit,
     whether OpenCV is importable (the device tracker does not need it) and,
     if it is, PinholeCamera's undistortion against OpenCV's; fails without
     a CUDA device (there is no CPU fallback);
  2. build: the kernel sources cerberus_tpu_torch/csrc/*.cu, one nvcc each,
     and the native sensor sync native/sensor_sync.cpp with g++, all
     started together, into build/cerberus_tpu_torch/, with each kernel's
     registers, shared memory and spills as ptxas reports them;
  3. kernels: each kernel against its plain torch version on the card at
     tile-aligned and ragged n, resident and streamed tiles, the f64 cluster
     body (one thread-block cluster per system: f64, n > 224, a batch of at
     most 132 / cluster) at B = 1, 2, 4, 8 and 9 and n = 225-384, and a
     batch with one system that is not SPD (its x NaN, the others as
     alone); two launches of the cluster body on one input give equal
     bits; then
     at its paths' shapes, timed with CUDA events beside its plain version,
     one library call computing the same function, and the least time the
     card could take (cuda_ms says how):
       - lane_cholesky_solve f32 (the batched solve's and solve_window's;
         B = 512 and 1,024, the measurement drivers' sweep; n = 382 at
         B = 128, profile_solver's full system) and f64 (the streaming
         estimator's; n = 382, the solver's full-system paths, through the
         cluster body: its row names the body and the cluster size, with
         the bound of the cluster's own SMs beside the card's);
       - cholesky_solve, f32 (on no path of the port, as its TPU original);
  4. batched path: the batched full-width window solve — 128 windows of the
     10 s simulated sequence (11 frames, F = 160, 222-dim reduced system),
     12 LM iterations, f32 — with every kernel launch counted, the results
     checked, cross-checked against the CPU, and timed; the single-window
     path (solve_window, B = 1) likewise counted and timed;
  4b. solver options: solve_window on window 0 of that problem in f64
     under the six option sets (structured, schur, project_gauge) of
     OPTION_SETS: the Schur paths through the f64 kernel at n = 222, the
     full (222 + F)-dim paths at n = 382, 12 launches a solve, counted by
     n; ms per solve; the full paths held to the Schur path (TFT 1e-8 m,
     FxT 1e-6 m), FxT and TFF to the CPU (1e-8 m, 4 iterations); then the
     batched solve (B = 128, f32) with lane_chol=False (the library's
     Cholesky, no kernel launch) and gemm_precision="high" (TF32) beside
     the default, windows per second each (timed in turns); the library
     route held to the kernel on the cross-check's 8 windows (cost rtol
     1e-3, p 1e-3 m), each route's whole-batch difference reported beside
     the kernel's own spread under a 1e-7 m nudge of the states;
  5. streaming path: the per-frame streaming estimator at full width
     (default EstimatorConfig: 11-frame window, F = 160, 12 LM iterations,
     f64, stereo, leg odometry, online rho, extrinsic estimation) replaying
     two simulated sequences, 20 camera frames each, with the end-to-end
     tests' gates, the f64 kernel's launches counted per solve, and the
     first 14 frames cross-checked against the port on the CPU; those 14
     frames' estimator then checkpointed (save_estimator), loaded into a
     fresh estimator on the card (load_estimator), and frames 15-20 run on
     both: positions equal within 1e-12 m;
  6. tracker check: the device tracker's frame programs (_first_frame,
     track_frame) on the card against the same functions on the CPU, on 3
     rendered 640x480 stereo pairs of sequence A with equal inputs;
  7. ekf check: the legged EKF on the card against the same filter on the
     CPU over sequence A's first 300 samples (f64), each timed per sample;
  8. image replay A: the image pipeline at full width — sequence A's 20
     camera frames rendered at 640x480 stereo (prerendered, outside the
     timed loop) -> the device tracker (120 slots, 4 levels, 21x21 patches,
     10 iterations) on its own stream and worker thread -> the f64
     streaming estimator (default EstimatorConfig) with contacts from the
     legged EKF on the card (contact source 0) — with the gates, the f64
     kernel's launches counted, tracker, render and EKF times, and tracks
     alive per frame;
  8b. native sync check: sequence A's 1,500 samples through the native
     SensorSync (g++) and PySensorSync, every camera interval extracted
     from both: equal, exact;
  8c. bag -> dataset: sequence A written as an A1 rosbag (BagWriter: 500 Hz
     IMU and joint states, 100 Hz mocap, 640x480 stereo at every camera
     frame) and converted (convert_rosbag) to a schema-v1 dataset under
     build/chip_smoke/; the bag's size, messages per topic, seconds;
  8d. bag replay CLI: `python -m cerberus_tpu_torch.data.replay --dataset
     DIR --images --csv ... --metrics ... --max-frames 20` in-process
     (load_dataset + ImageLoader -> DeviceTracker -> the default f64
     estimator on the card with the native sync), with the gates
     (NON_LINEAR, 0 reboots, ate_rmse <= 2x the JAX CLI's on the same
     dataset), the f64 kernel's launches counted, the CSV and the metrics
     stream read back, frames per second and ms per frame;
  9. keyframes -> pose graph: streaming A's keyframes (keyframe_callback)
     fed a pose graph on the card, the gates of
     tests/test_posegraph.py::test_estimator_feeds_posegraph;
 10. loop back-end street: the loop closer at full width (LoopCloser
     defaults) on StreetStream's 889 keyframes of the street circuit, the
     pose graph's optimize on the card; gates, counts and times; the guard
     decisions replayed on the CPU for 30 s; optimize_pose_graph of the
     final graph (Nc = 1024) card vs CPU;
 11. fleet: build_fleet(4 segments x 32 perturbations) = 128 windows at
     F = 96, f32, through solve_fleet (the f32 kernel's launches counted),
     tests/test_fleet.py's gates, 8 windows against the CPU, windows per
     second; the pooled calibration step against the CPU; then the same
     step under a one-process nccl group (init_distributed, group=)
     against the step without one: equal;
 12. sfm check: the initial SfM and alignment functions card vs CPU at the
     estimator's window (11 frames, F = 160, 128 hypotheses) and
     tests/test_initial_sfm.py's gates on the card;
 12b. measurement drivers, while the children run: the port's
     `evals/profile_inloop.py` (the full, no_chol and asm_once loops at
     B = 128, the production solve at B = 128, 512 and 1,024),
     `profile_batched.py`, `profile_solver.py` (B = SOLVER_B),
     `profile_streaming.py`, `bench_klt.py` (16 streams) and
     `multichip_scaling.py --devices 1` through their `main` with
     `--device cuda`, cut to DRIVER_REPS reps; every result key present,
     every measured time finite and > 0, dense1 a number, the f32 kernel's
     launches per timed program exact (12 a solve, 1 a damped solve, it a
     solve of it iterations, none in no_chol, the stages and the tracker);
     profile_inloop's full variant on 2 windows and bench_klt's tracks of
     2 streams against the CPU;
 12c. diagnostics, after 12b and while the children run: the port's
     `evals/diag_simcheck.py`, `diag_rho.py` (F = 160, 30 LM iterations:
     the f64 kernel at (1, 222) once an iteration, exactly),
     `diag_ekf_slip.py`, `diag_ekf_slip2.py`, `diag_tracker.py` (90
     frames, both trackers) and `diag_loop.py` through their functions on
     the card at DIAG_SIZES, launches counted per call, each held to the
     JAX package's numbers at the same sizes (JAX_DIAGNOSTICS: counts
     equal, f64 numbers within 1e-6 relative, the trackers' errors within
     0.05 px); the five streaming diagnostics run in the `estimator
     branches` child (13c);
 13. run configs, in a process of its own (below): `python -m
     cerberus_tpu_torch.evals.run_configs --configs C --duration 2`
     in-process for C = 1..6 (the legged EKF alone; IMU + leg; full VILO;
     rho from a 0.215 m calf; the fleet, f32; the image pipeline with the
     OpenCV and the device tracker), then `evals.long_run` in feature mode
     on the Go1 and without leg odometry (3 s each): launches counted per
     call, the end-to-end tests' gates;
 14. long run loop, in a process of its own (below): `python -m
     cerberus_tpu_torch.evals.long_run --images --tracker device --loop
     --prerender --path figure8 --speed 1.0 --duration 28` in-process —
     420 prerendered 640x480 stereo frames -> DeviceTracker -> the default
     f64 estimator, pipelined -> LoopCloser (defaults, pose graph on the
     card) on the estimator's own keyframes, 1.1 laps of the figure-eight;
     gates: no reboot, a loop found, corrected keyframe ATE below the
     odometric one, the f64 kernel once per LM iteration, ATE and
     corrected ATE at most 2x the JAX package's on the same run; frames
     per second, ms per NON_LINEAR frame, tracker ms, prerender seconds,
     loops, optimizes;
 15. with --profile: one batched solve, one streaming step, one image
     replay frame and one pose-graph optimize under torch.profiler, host
     time split by the code's spans and the device time of their kernels.

 13b. robustness, in a process of its own: `python -m
     cerberus_tpu_torch.evals.robustness --duration 3 --cases C` in-process
     for each of the battery's 12 cases (the matched baseline, noise
     densities x0.25 / x4, td mis-set +/-20 ms and estimated, extrinsic
     rotation errors 1 / 3 deg, 2 x 1 s IMU hangs, contact-flag corruption,
     150 landmarks, a fast untuned gait, foot slip x3; the default f64
     EstimatorConfig); 13c. estimator branches, in another: `--cases none
     --branches B` for stereo -> mono mid-run, IMU off and on again (a
     restart), vision only, the PnP recovery from an accelerometer fault
     and a reboot from a gyro spike (failure_detection, `_rebase_world`),
     3 s each. Launches counted per call; gates: the f64 kernel once per
     LM iteration of every solve, reboots as the JAX package's, drift and
     ATE at most 2x its (in a run with a step on a placeholder interval:
     that step where the JAX package's came, and the frames before it),
     td nearer 0 and within 2 ms of its, mono in mono, stale IMU intervals
     as its; then, in the `estimator branches` process, the streaming
     diagnostics (`diag_vision.py`'s 20-frame feed with vision on, analysed
     by it, `diag_obs.py` and `diag_proj.py`, then with vision off;
     `diag_ex.py`'s three variants at 14 frames; `diag_dropout.py` at 3 s),
     the f64 kernel once per LM iteration of every solve, held to
     JAX_DIAGNOSTICS as 12c (diag_dropout up to its first step on a
     placeholder interval);

Phases 13, 13b, 13c and 14 are host-bound with the card idle most of the
time, and each takes minutes: each runs in a child process (CHILDREN)
started after the build, which makes no launch until the kernels phase has
ended (the long run prerenders meanwhile), beside phases 4-12c; their
output is printed when they are collected, after phase 12c.

Ends with a line of each kernel's launches per path, the card's name and
power limit, a JSON line of the kernels' numbers, then the result line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero without the result line. It writes nothing outside build/.
"""

import sys

sys.dont_write_bytecode = True

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import re  # noqa: E402
from collections import Counter  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cerberus_tpu_torch import _build  # noqa: E402
from cerberus_tpu_torch import native  # noqa: E402
from cerberus_tpu_torch.config import EstimatorConfig  # noqa: E402
from cerberus_tpu_torch import convert  # noqa: E402
from cerberus_tpu_torch.data import replay as replay_mod  # noqa: E402
from cerberus_tpu_torch.data.log_adapter import (A1_TOPICS,  # noqa: E402
                                                 convert_rosbag)
from cerberus_tpu_torch.data.replay import replay, replay_images  # noqa: E402
from cerberus_tpu_torch.data.rosbag import (BagWriter, ImageMsg,  # noqa: E402
                                            ImuMsg, JointStateMsg,
                                            PoseStampedMsg)
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
from cerberus_tpu_torch.evals import (bench_klt, measure,  # noqa: E402
                                      multichip_scaling, profile_batched,
                                      profile_inloop, profile_solver,
                                      profile_streaming)
from cerberus_tpu_torch.loop.closer import LoopCloser, _yaw_of_quat  # noqa: E402
from cerberus_tpu_torch.loop.posegraph import (PoseGraph,  # noqa: E402
                                               optimize_pose_graph)
from cerberus_tpu_torch.parallel import pooled_calibration_step  # noqa: E402
from cerberus_tpu_torch.parallel.fleet import build_fleet, solve_fleet  # noqa: E402
from cerberus_tpu_torch.parallel.mesh import init_distributed  # noqa: E402
from cerberus_tpu_torch.utils import lie  # noqa: E402
from cerberus_tpu_torch.utils.checkpoint import (load_estimator,  # noqa: E402
                                                 save_estimator)
from cerberus_tpu_torch.utils.metrics import read_metrics  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth,
# float32 outside the tensor cores, float64 on the tensor cores (DMMA,
# full float64 precision; 34e12 outside them): the card's fastest rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 67e12
F64_FMA_FLOP_PER_S = 34e12   # float64 outside the tensor cores

BATCH = 128          # windows in the batched solve
ITERS = 12           # LM iterations (reference max_num_iterations)
CHECK_WINDOWS = 8    # windows cross-checked against the CPU
TOL = 2e-3           # f32 kernels vs plain, max |dx| / max |x|
TOL_F64 = 1e-10      # f64 kernel vs plain, max |dx| / max |x|
LANE_N = {torch.float32: (1, 16, 31, 33, 37, 222, 238, 240, 241, 321, 382,
                          384),
          torch.float64: (1, 16, 31, 33, 37, 222, 224, 225, 238, 239, 382,
                          384)}
LANE_B = (1, 2, 128, 130)
# (B, n) also checked: the measurement drivers' sweep at B = 512 and 1,024
# and the f64 cluster body's batches and a ragged n
LANE_WIDE = {torch.float32: ((512, 222), (1024, 222)),
             torch.float64: ((4, 384), (1, 383), (8, 382), (9, 382))}
TIMED_CALLS = 50     # kernel or library calls between one event pair
STREAM_FRAMES = 20   # camera frames per streaming sequence
CHECK_FRAMES = 14    # frames of sequence A cross-checked against the CPU
SEQ_A = SimConfig(duration=3.0, speed=0.5, seed=5)   # sequence A
TRACK_PAIRS = 3      # rendered stereo pairs of the tracker check
TRACK_POS_TOL = 1e-2  # px, tracker card vs CPU, points kept by both
TRACK_AGREE = 0.98   # share of slots whose flags must agree, card vs CPU
EKF_TOL = 1e-9       # EKF card vs CPU, relative, f64
EKF_SAMPLES = 300    # samples of the EKF check (run configs' config 1
#                      drives the filter on the card for 2,000 more)
ATE_GATE = 0.0041    # m: 2x the JAX package's 0.00204 on the image replay
BAG_ATE_GATE = 0.0040  # m: 2x the JAX CLI's 0.00200 on the same dataset
#                        (tools/jax_bag_replay.py, JAX on the CPU, f64)

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

CPU_REPLAY_S = 30    # s: budget of the loop stream's replay on the CPU
PG_TOL = 1e-9        # optimize_pose_graph card vs CPU, relative, f64
# the logged-data path: sequence A recorded as an A1 bag (A1_TOPICS), stamps
# at sim time + BAG_EPOCH (a nonzero epoch like a real bag's, as
# tests/test_rosbag.py::_sim_to_bag writes them), mocap at 500 / MOCAP_STRIDE
# Hz, converted to a schema-v1 dataset and replayed by the CLI
BAG_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
BAG_EPOCH = 1000.0
MOCAP_STRIDE = 5
SYNC_CUT_OFFSET = 7e-4   # s: interval ends off the sample clock (lerped)
CKPT_TOL = 1e-12     # m: a resumed checkpoint vs the estimator it saved
FLEET_SEGMENTS, FLEET_PERTURB = 4, 32   # B = 128 windows, F = 96, f32
SFM_TOL = 1e-9       # initial SfM card vs CPU, relative, f64
# the solver's option sets, (structured, schur, project_gauge) by name; x:
# schur has no effect when structured is False (JAX solver.py:145)
OPTION_SETS = {"TTT": (True, True, True), "TTF": (True, True, False),
               "TFT": (True, False, True), "TFF": (True, False, False),
               "FxT": (False, True, True), "FxF": (False, True, False)}
OPTIONS_CPU_ITERS = 4   # LM iterations of the option sets' CPU cross-check
NUDGE_SAMPLES = 4       # kernel solves nudged by 1e-7 i m: the f32 spread
#                         that lane_chol=False's worst window is held to

# the long run with loop closure (`long run loop`): the port's
# `evals/long_run.py` in-process on 28 s of the figure-eight at 1.0 m/s,
# 420 camera frames (1.1 laps of ~24 m: the start is revisited with the
# same heading at t = 25 s, more than the closer's exclude_last = 40 nodes
# later), rendered 640x480 stereo -> DeviceTracker -> the default f64
# estimator -> LoopCloser (defaults) on the estimator's own keyframes. At
# 0.75 m/s the first revisit comes after 500 frames, more than fit the
# script's time limit at 1.9-2.7 s a frame; at 1.25 and 1.5 m/s the JAX
# package finds no loop on this path
LONG_RUN_ARGV = ["--images", "--tracker", "device", "--loop", "--prerender",
                 "--path", "figure8", "--speed", "1.0", "--duration", "28",
                 "--seed", "77"]
# the JAX package's numbers on the same run (`python evals/long_run.py
# --platform cpu` with LONG_RUN_ARGV, JAX on the CPU, f64: 3 loops found,
# odometric keyframe ATE 0.068 m); gates at 2x
JAX_LONG_RUN = dict(ate_rmse_m=0.0515, corrected_ate_m=0.048)
# `run configs`: the port's `evals/run_configs.py` in-process, one config a
# call, then `evals/long_run.py` in feature mode on the Go1 and without
# leg odometry
RUN_CONFIGS_S = "2"
LONG_RUN_FEATURES = {"long run go1": ["--robot", "go1", "--duration", "3"],
                     "long run no-leg": ["--no-leg", "--duration", "3"]}
FLEET_CONFIG_ITERS = 8   # LM iterations of run_configs' config 5
# `robustness` and `estimator branches`: the port's `evals/robustness.py`
# in-process, one run a call, its 12 cases and its 5 branch runs at 3 s
# each (the JAX battery's 60 s cut for the time limit; 3 s is the shortest
# run on which corrupt_contacts can place a burst, and both IMU dropout
# windows begin after initialization), in two processes of their own, to
# leave the host's 8 cores to the long run (its frame took 2,080 ms beside
# three such processes in one call, 1,787 ms beside two in another)
ROBUSTNESS_S = "3.0"
ROBUSTNESS_CHILDREN = {
    "robustness": ("baseline_matched", "noise_x0.25", "noise_x4",
                   "td_init_+20ms", "td_init_-20ms", "extrinsic_rot_1deg",
                   "extrinsic_rot_3deg", "imu_dropout_2x1s",
                   "contact_corruption", "low_texture_150lm",
                   "fast_untuned_gait", "slip_x3"),
    "estimator branches": ("mono_swap", "imu_off_on", "vision_only",
                           "pnp_recovery", "reboot")}
TD_GATE_MS = 2.0   # final td within this of the JAX package's
# `diagnostics`: the port's eleven `evals/diag_*.py` on the card through
# their functions, at these sizes (each beside the JAX script's own):
#   diag_simcheck, diag_rho (F = 160, 30 LM iterations), diag_tracker
#     (90 frames): the JAX scripts' sizes;
#   diag_proj, diag_obs, diag_vision: their 20 frames of the 3 s sequence,
#     one feed (vision on, debug on) analysed by all three, then vision off;
#   diag_ex: DIAG_FRAMES=14 of its 8 s sequence (JAX: every frame, 120);
#   diag_dropout: 3 s (JAX: 60 s; the shortest run whose two IMU windows
#     both begin after initialization);
#   diag_ekf_slip / diag_ekf_slip2: 0.6 s = 300 samples of each
#     simulation (JAX: 60 s), one variant each (JAX: 6 each);
#   diag_loop: long run loop's figure-eight, 1.0 m/s for 28 s, seed 77
#     (JAX: the street circuit, 0.75 m/s for 180 s, seed 77: simulating it
#     and rendering its 2,700 stereo pairs takes ~5 min of one core, more
#     than the main process has before the long run ends)
# The five streaming ones run in the `estimator branches` child after its
# runs, the rest in the main process after `measurement drivers`.
DIAG_SIZES = {
    "diag_simcheck": {}, "diag_rho": {}, "diag_tracker": {"max_frames": 90},
    "diag_vision": {"DIAG_DUR": "3.0", "DIAG_FRAMES": "20"},
    "diag_ex": {"DIAG_DUR": "8.0", "DIAG_FRAMES": "14"},
    "diag_dropout": {"duration": 3.0},
    "diag_ekf_slip": {"duration": 0.6, "EKF_VARIANTS": "gate11_var25"},
    "diag_ekf_slip2": {"duration": 0.6, "variant": "fw0.001_vn0.1"},
    "diag_loop": {"path": "figure8", "speed": 1.0, "duration": 28.0,
                  "seed": 77}}
DIAG_REL = 1e-6      # f64 diagnostics' numbers vs the JAX package's, relative
DIAG_TRACK_PX = 0.05  # the trackers' error p50 / p90 vs the JAX package's
# the JAX package's numbers on the same runs (`python3
# tools/jax_robustness.py --duration 3`: JAX on the CPU, f64, the default
# EstimatorConfig; unrounded drift % and ATE, reboots, final td in ms,
# stale IMU intervals, the sample time of the first adopted step on a
# placeholder interval and the scores of the frames published before it);
# the gates hold drift and ATE to 2x these
JAX_ROBUSTNESS = {
    'baseline_matched': dict(drift_pct=0.33141602318768965,
        ate_rmse=0.002345470427763148, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'noise_x0.25': dict(drift_pct=0.4092960947676626,
        ate_rmse=0.002953856522133233, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'noise_x4': dict(drift_pct=0.10456158998766452,
        ate_rmse=0.001632927212493455, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'td_init_+20ms': dict(drift_pct=9.5442636887108,
        ate_rmse=0.08764556294144644, reboots=0,
        td_final_ms=15.589214637363748, stale_imu_intervals=0,
        placeholder_at=1.206, before_placeholder=dict(frames=8,
        drift_pct=25.56978497129529, ate_rmse=0.029862846696006178)),
    'td_init_-20ms': dict(drift_pct=3.468928960064655,
        ate_rmse=0.01994795581712572, reboots=0,
        td_final_ms=-9.561004513277323, stale_imu_intervals=0,
        placeholder_at=None),
    'extrinsic_rot_1deg': dict(drift_pct=0.317057611322108,
        ate_rmse=0.0026353600232570736, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'extrinsic_rot_3deg': dict(drift_pct=0.38342447562758575,
        ate_rmse=0.004225481944526546, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'imu_dropout_2x1s': dict(drift_pct=61.28393580546801,
        ate_rmse=0.547489970109644, reboots=0, stale_imu_intervals=28,
        placeholder_at=0.99, before_placeholder=dict(frames=5,
        drift_pct=0.9913933078816961, ate_rmse=0.0008448972262636574)),
    'contact_corruption': dict(drift_pct=23.646079529766414,
        ate_rmse=0.07872019584854746, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'low_texture_150lm': dict(drift_pct=0.6135288659746181,
        ate_rmse=0.004574841088153949, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'fast_untuned_gait': dict(drift_pct=0.5103748201033846,
        ate_rmse=0.009402337660653536, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'slip_x3': dict(drift_pct=1.2191227787267933, ate_rmse=0.00830120796066368,
        reboots=0, stale_imu_intervals=0, placeholder_at=None),
    'mono_swap': dict(drift_pct=0.5216150205450912,
        ate_rmse=0.0037525557325563488, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'imu_off_on': dict(drift_pct=67.3096969433514, ate_rmse=0.5296875750892349,
        reboots=1, stale_imu_intervals=0, placeholder_at=None),
    'vision_only': dict(drift_pct=1.2644530752274539,
        ate_rmse=0.008431069423626982, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'pnp_recovery': dict(drift_pct=4.033810778460326,
        ate_rmse=0.027918993236279385, reboots=0, stale_imu_intervals=0,
        placeholder_at=None),
    'reboot': dict(drift_pct=23.08712558069847, ate_rmse=0.16856662300746816,
        reboots=1, stale_imu_intervals=0, placeholder_at=None),
}
# the JAX package's numbers at DIAG_SIZES (`python3
# tools/jax_diagnostics.py`, JAX on the CPU, f64, then `--digest`: each
# result's diag_digest, unrounded); diag_dropout's only up to its first
# adopted step on a placeholder interval (`_` keys: reported, not held)
JAX_DIAGNOSTICS = {
    'diag_simcheck':
        {'p_err': [2.193168531434215e-05, 5.280561752838686e-05,
                   0.00010125658253964564],
         'v_err': [2.1735572443886324e-05, 4.313199346805085e-05,
                   6.430739295976617e-05],
         'q_err': [7.100563634469333e-06, 7.109981804470286e-06,
                   7.1193915959350686e-06],
         'max_q_err': 7.1193915959350686e-06,
         'leg_med': 3.595552130076124e-05,
         'leg_p90': 0.003881836203151709,
         'leg_max': 0.005950701044109361,
         'leg_n': 96},
    'diag_rho':
        {'J_col': [0.13570508249482885, -0.011253091226625106,
                   0.15862052491361006, 0.1848313219476181,
                   -0.014924945337170181, 0.20184840069869078,
                   0.1281148846154681, -0.02023774782025961,
                   0.14319894319681403, 0.10948397421430091,
                   -0.028482315436497353, 0.12471842629718195],
         'fd': [0.13570508249627355, -0.011253091226730292, 0.15862052491280587,
                0.18483132195046267, -0.014924945337425886, 0.20184840069711188,
                0.1281148846177249, -0.02023774782035706, 0.14319894319997448,
                0.10948397421162158, -0.02848231543651179,
                0.12471842629757644],
         'deps_nom': [0.10291900606918504, -0.0025086854170235182,
                      -0.06090034625152343, 0.07222059858658905,
                      -0.0028163132789882066, -0.0016924796241373195,
                      0.0762319815352458, 0.0033242944875995837,
                      -0.0013028328876919194, 0.09785837925362448,
                      0.0036791118954346102, -0.06062996422313454],
         'deps_true': [0.10359753148165919, -0.002564950873156644,
                       -0.060107243626955374, 0.07314475519632717,
                       -0.002890938005674058, -0.0006832376206438522,
                       0.07687255595832314, 0.003223105748498286,
                       -0.0005868381717077965, 0.09840579912469602,
                       0.0035367003182521246, -0.060006372091648615],
         'truth': [0.199981472907602, 0.002499869794378995,
                   0.0021460938542303214],
         'cost0': 6975.890402058822,
         'cost': 501.58251342524807,
         'accepted': 30,
         'rho_frame5': [0.2099966053522448, 0.21226464279210328,
                        0.21322727228032742, 0.2099965646100941],
         'pos_err': [0.006658835893774586, 0.007332439676232777,
                     0.00733992490426528, 0.007272644008775308,
                     0.00854948926633093, 0.009438449545629,
                     0.010423740845650654, 0.011042186432921042,
                     0.011414202012696608, 0.012043559594113233,
                     0.012315694535893831]},
    'diag_proj':
        {'a_cost': 508.1791621280566,
         'a_n_rows': 4450,
         'a_rms_px': 0.7168605445651299,
         'b_total': 443.4743555274906,
         'b_n_features': 108,
         'b_worst_slots': [69, 13, 57, 29, 72, 14, 17, 64, 74, 10, 60, 56],
         'b_worst_cost': [11.878594450000865, 11.737326011753831,
                          11.06855831093458, 10.221841514593608,
                          9.340212765847838, 9.323459870098194,
                          8.682132926208514, 8.356001444938356,
                          8.297422341189701, 7.939286461436541,
                          7.256609821761528, 6.7531399438347535],
         'b_worst_d_tru': [0.15795112295628252, 0.17879798229639227,
                           0.7582585890532701, 0.46614287872686355,
                           0.4149625434478363, 0.5587265273067062,
                           0.14577275084644264, 0.199896502947429,
                           0.18120625949805633, 0.17464539046315677,
                           0.18330646244436527, 0.22633159462964111],
         'b_anchor_n': {'0': 104, '1': 1, '2': 1, '5': 1, '6': 1},
         'b_rms_mono': 0.6896388284952701,
         'b_rms_stereo': 0.705600668782574},
    'diag_obs':
        {'checked': 1096,
         'bad': [],
         'headers': [0.528, 0.594, 0.66, 0.726, 0.792, 0.858, 0.924, 0.99,
                     1.122, 1.188, 1.254],
         'keyframes': 16},
    'diag_vision':
        {'on_t': [0.66, 0.726, 0.792, 0.858, 0.924, 0.99, 1.056, 1.122, 1.188,
                  1.254],
         'on_accepted': [1, 1, 12, 12, 12, 4, 12, 12, 12, 12],
         'on_newest_err': [0.2990215751692713, 0.29839337257301746,
                           0.2984894634606607, 0.29794420474878086,
                           0.29810192262081125, 0.29761963558763693,
                           0.29819950180047267, 0.29762938919627435,
                           0.2973685982398139, 0.29688107888240156],
         'on_mean_err': [0.29967372829158845, 0.29961661896465636,
                         0.2995552639350778, 0.2992392369253039,
                         0.2992516702178509, 0.2988949255894362,
                         0.29912288989396923, 0.29902667279659456,
                         0.2987948351484491, 0.29847854528914913],
         'on_cost_drop': [1.600694588432816e-06, 1.600694588432816e-06,
                          178.35535544719312, 158.6176327418613,
                          160.8523306708414, 140.67390473305397,
                          151.29461197131423, 140.52643123918108,
                          166.80120390552088, 4.508286080316964],
         'on_entry_ileg_proj': [[4.7, 609.2], [4.5, 571.8], [4.1, 562.2],
                                [4.0, 568.5], [4.2, 581.1], [4.0, 597.7],
                                [3.3, 602.9], [3.9, 433.7], [4.3, 510.9]],
         'on_rho': [0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.2096,
                    0.2101, 0.21, 0.2103, 0.2092, 0.2103, 0.21, 0.2105, 0.209,
                    0.2105, 0.21, 0.2105, 0.209, 0.2105, 0.21, 0.2105, 0.2088,
                    0.2108, 0.21, 0.2105, 0.2086, 0.211, 0.21, 0.2105, 0.2085,
                    0.2111, 0.21, 0.2104, 0.2083, 0.2113, 0.21, 0.2104],
         'on_bg': [0.0023, -0.0011, 0.0015, 0.0023, -0.0011, 0.0015, 0.0023,
                   -0.0009, 0.0017, 0.0024, -0.0012, 0.0016, 0.0026, -0.0012,
                   0.002, 0.0026, -0.0012, 0.002, 0.0023, -0.0012, 0.0018,
                   0.002, -0.0012, 0.0015, 0.0018, -0.0014, 0.0017, 0.002,
                   -0.0016, 0.0017],
         'on_ex_deg': [0.0, 0.0, 0.172, 0.166, 0.162, 0.147, 0.096, 0.157,
                       0.169, 0.173],
         'on_ex_dt': [0.0, 0.0, 0.0046, 0.0045, 0.0073, 0.0093, 0.0079, 0.0087,
                      0.0092, 0.0093],
         'on_n_depths': [119, 121, 121, 118, 117, 114, 113, 111, 111, 108],
         'on_depth_err_med': [0.14278249842966861, 0.14278249842966861,
                              0.132326170783859, 0.11683702641571125,
                              0.11024885199127965, 0.11429328325407595,
                              0.12861503254606443, 0.13035281297978774,
                              0.14133679321739834, 0.14485601425834593],
         'off_t': [0.66, 0.726, 0.792, 0.858, 0.924, 0.99, 1.056, 1.122, 1.188,
                   1.254],
         'off_accepted': [2, 2, 12, 1, 12, 12, 12, 1, 12, 12],
         'off_newest_err': [0.29911792304416324, 0.29859554927264886,
                            0.2984901302326398, 0.2977705471829215,
                            0.2975248814618947, 0.2971657136142313,
                            0.2970332558859962, 0.29621801163094935,
                            0.29679466907904073, 0.296814974316777],
         'off_mean_err': [0.29956614134644244, 0.2995186528217593,
                          0.2993665888161527, 0.29916035353455667,
                          0.2987813188901412, 0.29857422611712076,
                          0.29840149807588967, 0.29812001923408543,
                          0.2980934236509915, 0.29797226282029715],
         'off_cost_drop': [3.932774433379471e-05, 3.932774433379471e-05,
                           0.4174214125622209, 1.9379947602260472e-06,
                           3.834965813801056, 0.2080307617754764,
                           0.3461533370118479, 1.904354319126611e-06,
                           2.4271748871493104, 0.41271922255238325],
         'off_entry_ileg_proj': [[1.9, 0.0], [2.0, 0.0], [1.9, 0.0], [2.2, 0.0],
                                 [2.2, 0.0], [1.9, 0.0], [1.5, 0.0], [1.9, 0.0],
                                 [2.3, 0.0]],
         'off_rho': [0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.21, 0.2098,
                     0.2101, 0.21, 0.21, 0.2098, 0.2101, 0.21, 0.21, 0.2097,
                     0.2102, 0.21, 0.21, 0.2096, 0.2103, 0.21, 0.2099, 0.2095,
                     0.2105, 0.21, 0.2099, 0.2095, 0.2105, 0.21, 0.2099, 0.2094,
                     0.2106, 0.2101, 0.2099, 0.2093, 0.2106, 0.2101, 0.2098],
         'off_bg': [0.0013, -0.0039, 0.0155, 0.0013, -0.0039, 0.0155, 0.0012,
                    -0.0039, 0.0155, 0.0012, -0.0039, 0.0155, 0.0012, -0.0012,
                    0.0149, 0.0013, 0.0002, 0.0144, 0.0018, 0.0006, 0.0135,
                    0.0018, 0.0006, 0.0135, 0.004, 0.0001, 0.0116, 0.0044,
                    -0.0004, 0.0098],
         'off_ex_deg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         'off_ex_dt': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         'est_ileg': 4.855218896947997,
         'est_proj': 510.9469493586922,
         'tru_ileg': 7.331024921799353,
         'tru_proj': 443.4743555274911,
         'cost_est_less_tru': 43.26453397762907,
         'prior_est_less_tru': -14.563255492927187},
    'diag_ex':
        {'ex=True,vision=True ate': 0.0007206219068110643,
         'ex=True,vision=True drift_pct': 1.0390904677133732,
         'ex=True,vision=True dist': 0.09955743965030953,
         'ex=True,vision=True dtic': [0.003598659417245902,
                                      0.00451262552611271],
         'ex=True,vision=True dang_deg': [0.11330533849170964,
                                          0.10020296153939313],
         'ex=True,vision=True keyframes': 12,
         'ex=True,vision=True inv_depths': [0.17086464523890854,
                                            0.06104392121723233,
                                            0.811583343081235],
         'ex=True,vision=True inv_n': 157,
         'ex=False,vision=True ate': 0.0008337915785724177,
         'ex=False,vision=True drift_pct': 1.3443361152574718,
         'ex=False,vision=True dist': 0.09955743965030953,
         'ex=False,vision=True dtic': [0.0, 0.0],
         'ex=False,vision=True dang_deg': [0.0, 0.0],
         'ex=False,vision=True keyframes': 12,
         'ex=False,vision=True inv_depths': [0.17049758582672012,
                                             0.06342906428392373,
                                             0.8106291008901795],
         'ex=False,vision=True inv_n': 157,
         'ex=True,vision=False ate': 0.0010268223102216391,
         'ex=True,vision=False drift_pct': 1.7448019709322937,
         'ex=True,vision=False dist': 0.09955743965030953,
         'ex=True,vision=False dtic': [0.0, 0.0],
         'ex=True,vision=False dang_deg': [0.0, 0.0],
         'ex=True,vision=False keyframes': 14,
         'ex=True,vision=False inv_depths': None,
         'ex=True,vision=False inv_n': None},
    'diag_dropout':
        {'reboots': 0,
         'stale_intervals': 28,
         'placeholder_at': 0.99,
         'failure_reasons_before': [],
         'err_before': [0.0, 0.0010532648605160579, 0.0, 0.0010532648605160579],
         'before_frames': 5,
         'before_drift_pct': 0.9913933078816961,
         'before_ate': 0.0008448972262636574,
         '_drift_pct': 61.28393580546801,
         '_ate': 0.547489970109644,
         '_failure_reasons': []},
    'diag_ekf_slip':
        {'samples': 300,
         'gate11_var25 slip drift_pct': 0.45337806028398847,
         'gate11_var25 slip ate_rmse': 0.00515002436920191,
         'gate11_var25 slip distance': 0.23839999990066668,
         'gate11_var25 slip final_err': 0.001080853295266673,
         'gate11_var25 clean drift_pct': 0.8613791100869176,
         'gate11_var25 clean ate_rmse': 0.005043445411101788,
         'gate11_var25 clean distance': 0.23839999990066668,
         'gate11_var25 clean final_err': 0.002053527797591575},
    'diag_ekf_slip2':
        {'samples': 300,
         'fw0.001_vn0.1 slip drift_pct': 1.7279780248833227,
         'fw0.001_vn0.1 slip ate_rmse': 0.0032921982977711095,
         'fw0.001_vn0.1 slip distance': 0.23839999990066668,
         'fw0.001_vn0.1 slip final_err': 0.004119499609605384,
         'fw0.001_vn0.1 clean drift_pct': 2.110343085768047,
         'fw0.001_vn0.1 clean ate_rmse': 0.0036007332028379223,
         'fw0.001_vn0.1 clean distance': 0.23839999990066668,
         'fw0.001_vn0.1 clean final_err': 0.00503105791437475},
    'diag_tracker':
        {'frames': 90,
         'cv err_p50': 1.701189406771681,
         'cv err_p90': 9.972601059882926,
         '_cv n_feat_p50': 120.0,
         '_cv len_p50': 11.0,
         '_cv births': 468,
         'device err_p50': 1.4724918768554993,
         'device err_p90': 9.604263812837138,
         '_device n_feat_p50': 93.5,
         '_device len_p50': 4.0,
         '_device births': 749},
    'diag_loop':
        {'keyframes': 104,
         'skipped': 316,
         'cand': 1,
         'few_matches': 0,
         'few_world': 0,
         'pnp_fail': 1,
         'pnp_ok': 7,
         'loops_found': 7,
         'n_loop_edges': 7,
         'match_p50': 39.0,
         'match_p90': 51.9,
         'world_p50': 39.0,
         'world_p90': 51.9,
         'best_sim': 0.865774929523468,
         'pnp_err_p50': 0.0016982652068665586},
}

# kernel rows: (name, dtype) -> what the JSON line says of it
KERNELS = {
    ("lane_cholesky_solve[f32]", torch.float32): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45"),
    ("lane_cholesky_solve[f64]", torch.float64): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45"),
    # the same kernel's launches at n = 382 (a subset of the row above):
    # the full (222 + F)-dim system of the solver's dense path, F = 160
    ("lane_cholesky_solve[f64] n=382", torch.float64): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45"),
    ("cholesky_solve", torch.float32): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/cholesky_solve.cu",
        replaces="cerberus_tpu/ops/pallas_kernels.py:53"),
    # the f32 kernel's launches at the measurement drivers' shapes (subsets
    # of the f32 row): the sweep's B = 512 and 1024 at n = 222, and n = 382
    # (any B), profile_solver's full (222 + F)-dim system
    **{(name, torch.float32): dict(
        route="cuda", source="cerberus_tpu_torch/csrc/lane_cholesky.cu",
        replaces="cerberus_tpu/ops/lane_cholesky.py:45")
       for name in ("lane_cholesky_solve[f32] B=512",
                    "lane_cholesky_solve[f32] B=1024",
                    "lane_cholesky_solve[f32] n=382")},
}
# the shapes those rows are timed at (kernels phase)
F32_PATH_SHAPES = {"lane_cholesky_solve[f32] B=512": (512, 222),
                   "lane_cholesky_solve[f32] B=1024": (1024, 222),
                   "lane_cholesky_solve[f32] n=382": (BATCH, 382)}


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
    b = rng.normal(size=(B, n))
    if dtype == torch.float32:     # made in f32, as that test makes them
        J = J.astype(np.float32)
    A = np.swapaxes(J, 1, 2) @ J + 0.5 * np.eye(n, dtype=J.dtype)  # J^T J
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
    lc.LAUNCHES.clear()
    lc.LAUNCHES_BY_SHAPE.clear()
    cs.LAUNCHES = 0


def read_counts():
    """Launches since reset_counts(), per kernel row."""
    by_dtype = Counter()
    for (dtype, _), k in lc.LAUNCHES.items():
        by_dtype[dtype] += k
    f32 = lambda B, n: lc.LAUNCHES_BY_SHAPE[(torch.float32, B, n)]
    return {"lane_cholesky_solve[f32]": by_dtype[torch.float32],
            "lane_cholesky_solve[f64]": by_dtype[torch.float64],
            "lane_cholesky_solve[f64] n=382": lc.LAUNCHES[(torch.float64, 382)],
            "cholesky_solve": cs.LAUNCHES,
            "lane_cholesky_solve[f32] B=512": f32(512, 222),
            "lane_cholesky_solve[f32] B=1024": f32(1024, 222),
            "lane_cholesky_solve[f32] n=382": lc.LAUNCHES[(torch.float32, 382)]}


def only(want):
    """read_counts()'s rows with the launches of `want` and 0 elsewhere."""
    return {name: want.get(name, 0) for name, _ in KERNELS}


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
          count=torch.cuda.device_count(), cpu_count=os.cpu_count())
    return dev, smi


def build():
    """The kernels with nvcc and the native sensor sync with g++, one
    compiler each, all started together; a failed build raises."""
    t0 = time.perf_counter()
    names = ("lane_cholesky", "cholesky_solve")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        native_lib = pool.submit(_build.build_native)
        libs = list(pool.map(_build.build, names)) + [native_lib.result()]
    phase("build", t0, libraries=",".join(lib.name for lib in libs))
    # ptxas -v: registers, static shared memory and spills of each kernel
    # (its dynamic shared memory is the tile plan's, printed per shape)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if re.search(r"Compiling entry|registers|spill|smem", line):
                print(f"ptxas {name}: {line.strip()}")


def lane_numbers(dev, dtype, B, n):
    """Error, times and bound of lane_cholesky_solve at (B, n); the body
    (one block, or a cluster per system) and, for a cluster, the bound of
    its own SMs (cluster / lc.SM_COUNT of the f64 FMA rate)."""
    A, b = spd(7, B, n, dev, dtype)
    x = lc.lane_cholesky_solve(A, b)
    xp = lc.lane_cholesky_solve_plain(A, b)
    torch.cuda.synchronize()

    def library():
        L = torch.linalg.cholesky_ex(A).L
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    es = A.element_size()
    # the lower triangle of A (all a Cholesky solve reads) and b in, x out
    flops = B * (n ** 3 / 3 + 2 * n * n)
    bound_ms, bound_by = bound(
        es * (B * n * (n + 1) // 2 + 2 * B * n), flops,
        F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S)
    plan = lc.solve_plan(n, dtype, B)
    body = {}
    if isinstance(plan, lc.ClusterPlan):
        body = dict(body="cluster", cluster=plan.cluster,
                    cluster_bound_ms=flops / (F64_FMA_FLOP_PER_S * B
                                              * plan.cluster / lc.SM_COUNT)
                    * 1e3)
    else:
        body = dict(body="one block")
    return timed(dict(max_abs_err=float((x - xp).abs().max()),
                      bound_ms=bound_ms, bound_by=bound_by, shape=[B, n],
                      **body, plan=plan._asdict()),
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
    LANE_N[dtype] and B of LANE_B and at LANE_WIDE[dtype], then on a batch
    whose middle system is not SPD: its x must hold NaN, as the plain
    version's does, and the others must agree as before (at n = 382 in f64
    a cluster batch); then two launches on one input at the f64 full
    system (the cluster body): equal bits."""
    label = "f32" if dtype == torch.float32 else "f64"
    worst = 0.0
    shapes = [(B, n) for n in LANE_N[dtype] for B in LANE_B]
    for B, n in shapes + list(LANE_WIDE[dtype]):
        A, b = spd(1000 * n + B, B, n, dev, dtype)
        err = rel_err(lc.lane_cholesky_solve(A, b),
                      lc.lane_cholesky_solve_plain(A, b))
        if not err < tol:
            raise AssertionError(f"lane_cholesky_solve {label} n={n} "
                                 f"B={B}: relative error {err} >= {tol}")
        worst = max(worst, err)
    for n in (37, 222, 382):
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
    A, b = spd(4000, 1, 382, dev, dtype)
    x1, x2 = lc.lane_cholesky_solve(A, b), lc.lane_cholesky_solve(A, b)
    if not torch.equal(x1, x2):
        raise AssertionError(f"lane_cholesky_solve {label} n=382: two "
                             f"launches on one input differ by "
                             f"{float((x1 - x2).abs().max())}")
    return worst


def check_kernels(dev):
    """Every kernel against its plain version at several shapes, then its
    numbers at its paths' shapes. Returns {row name: numbers}."""
    t0 = time.perf_counter()
    worst = check_lane(dev, torch.float32, TOL)
    phase("kernel lane_cholesky_solve[f32] checks", t0, max_rel_err=worst,
          n=list(LANE_N[torch.float32]), B=list(LANE_B),
          also=list(LANE_WIDE[torch.float32]))
    f32 = lane_numbers(dev, torch.float32, BATCH, 222)
    phase("kernel lane_cholesky_solve[f32]", t0, **f32)
    f32_single = lane_numbers(dev, torch.float32, 1, 222)
    phase("kernel lane_cholesky_solve[f32] at B=1", t0, **f32_single)
    # the measurement drivers' shapes: the sweep's batches, and the full
    # (222 + F)-dim system of profile_solver's assembly+chol and dense1
    f32_paths = {}
    for name, (B, n) in F32_PATH_SHAPES.items():
        f32_paths[name] = lane_numbers(dev, torch.float32, B, n)
        phase(f"kernel {name}", t0, **f32_paths[name])

    t0 = time.perf_counter()
    worst = check_lane(dev, torch.float64, TOL_F64)
    phase("kernel lane_cholesky_solve[f64] checks", t0, max_rel_err=worst,
          n=list(LANE_N[torch.float64]), B=list(LANE_B),
          also=list(LANE_WIDE[torch.float64]),
          cluster_shapes=[[B, n] for B in LANE_B
                          for n in LANE_N[torch.float64]
                          if isinstance(lc.solve_plan(n, torch.float64, B),
                                        lc.ClusterPlan)])
    f64 = lane_numbers(dev, torch.float64, 1, 222)
    phase("kernel lane_cholesky_solve[f64]", t0, **f64)
    f64_batch = lane_numbers(dev, torch.float64, BATCH, 222)
    phase("kernel lane_cholesky_solve[f64] at B=128", t0, **f64_batch)
    f64_full = lane_numbers(dev, torch.float64, 1, 382)
    phase("kernel lane_cholesky_solve[f64] n=382", t0, **f64_full)

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
            "lane_cholesky_solve[f64] n=382": f64_full,
            "cholesky_solve": chol, **f32_paths}


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
    if counts != only({"lane_cholesky_solve[f32]": ITERS}):
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


def solve_counted(label, want_n, solve, *args):
    """One solve with the launch counts set to 0 just before it; every
    launch read just after must be of the f64 kernel at n = want_n, one per
    LM iteration (ITERS); host-synchronised ms of the call."""
    t0 = time.perf_counter()
    reset_counts()
    out = solve(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    by_n = dict(lc.LAUNCHES)
    if by_n != {(torch.float64, want_n): ITERS} or counts["cholesky_solve"]:
        raise AssertionError(f"{label}: launches by (dtype, n) {by_n}, "
                             f"{counts}, want {ITERS} of float64 at n = "
                             f"{want_n} only")
    return out, counts, ms


def solver_options(problem):
    """solve_window on the card under the six option sets of OPTION_SETS,
    on the batched problem's window 0 in f64 (F = 160): launches counted
    (ITERS f64 launches at n = 222 on the Schur paths, n = 222 + F = 382 on
    the full-system paths), ms per solve, the full paths held to the Schur
    path (tests/test_structured.py's tolerances), FxT and TFF against the
    CPU. Then the batched solve's switches at B = 128, f32: lane_chol=False
    (the library route) against the kernel, gemm_precision="high" against
    "highest", windows per second each. Returns (launches per path,
    numbers)."""
    t_phase = time.perf_counter()
    states, datas, opts = problem
    first = lambda x: (x[0].double() if x.is_floating_point() else x[0])
    st0, d0 = fac.map_tensors(first, states), fac.map_tensors(first, datas)
    F = d0.f_valid.shape[0]
    launches, res, nums = {}, {}, {}
    for name, (s, c, g) in OPTION_SETS.items():
        o = SolveOptions(max_iters=ITERS, structured=s, schur=c,
                         project_gauge=g)
        n = 222 if s and c else 222 + F
        res[name], launches[f"solve_window {name}"], first_ms = solve_counted(
            f"solve_window {name}", n, solve_window, st0, d0, o)
        t0 = time.perf_counter()
        solve_window(st0._replace(p=st0.p + 1e-9), d0, o)
        torch.cuda.synchronize()
        nums[name] = dict(n=n, first_ms=first_ms,
                          ms=(time.perf_counter() - t0) * 1e3,
                          cost0=float(res[name][1].cost0),
                          cost=float(res[name][1].cost))
        phase(f"solve_window {name}", t_phase, **nums[name],
              launches=launches[f"solve_window {name}"])
    for name, (st, info) in res.items():
        if not (all(torch.isfinite(x).all() for x in st)
                and float(info.cost) <= float(info.cost0)):
            raise AssertionError(f"solve_window {name}: not finite or cost "
                                 f"{float(info.cost0)} -> {float(info.cost)}")
    # the full system against the Schur path: test_structured.py's
    # test_schur_full_solve_matches_nonschur (TFT) and
    # test_structured_solver_matches_dense (FxT)
    ref_st, ref_info = res["TTT"]
    for name, p_atol, cost_rtol in (("TFT", 1e-8, 1e-9), ("FxT", 1e-6, 1e-6)):
        st, info = res[name]
        dp = float((st.p - ref_st.p).abs().max())
        dc = abs(float(info.cost) / float(ref_info.cost) - 1)
        nums[name].update(max_abs_dp_vs_TTT=dp, cost_rel_vs_TTT=dc)
        if not (dp <= p_atol and dc <= cost_rtol):
            raise AssertionError(f"solve_window {name} vs TTT: |dp| {dp} "
                                 f"(atol {p_atol}), cost {dc} (rtol "
                                 f"{cost_rtol})")

    # FxT and TFF card vs CPU at OPTIONS_CPU_ITERS iterations
    t0 = time.perf_counter()
    cpu = lambda x: x.cpu()
    st_c, d_c = fac.map_tensors(cpu, st0), fac.map_tensors(cpu, d0)
    for name in ("FxT", "TFF"):
        s, c, g = OPTION_SETS[name]
        o = SolveOptions(max_iters=OPTIONS_CPU_ITERS, structured=s, schur=c,
                         project_gauge=g)
        card_st, _ = solve_window(st0, d0, o)
        t1 = time.perf_counter()
        cpu_st, _ = solve_window(st_c, d_c, o)
        dp = float((card_st.p.cpu() - cpu_st.p).abs().max())
        nums[name].update(cpu_ms_at_4_iters=(time.perf_counter() - t1) * 1e3,
                          max_abs_dp_vs_cpu=dp)
        if not dp <= 1e-8:
            raise AssertionError(f"solve_window {name} card vs CPU: {dp} m")
    phase("solver options vs CPU", t0, iters=OPTIONS_CPU_ITERS,
          **{k: nums[k]["max_abs_dp_vs_cpu"] for k in ("FxT", "TFF")})

    # the batched solve's switches, B = 128, f32, each counted once, then
    # timed twice in turns (kernel, library, high, high, library, kernel),
    # the i-th timed solve with the states nudged by 1e-7 i m, as
    # batched_path's timing does; windows/s from the median of the two.
    # The kernel's nudged solves, with more up to NUDGE_SAMPLES, measure
    # how far rounding alone moves the f32 solve
    t0 = time.perf_counter()
    B = states.p.shape[0]
    runs = {"kernel": {}, "library": dict(lane_chol=False),
            "high": dict(gemm_precision="high")}
    out = {}
    for label, kw in runs.items():
        reset_counts()
        out[label] = solve_window_batched(states, datas, opts, **kw)
        torch.cuda.synchronize()
        launches[f"solve_window_batched {label}"] = read_counts()
    nudge = lambda i: states._replace(p=states.p + 1e-7 * i)
    nudged, secs = [], {label: [] for label in runs}
    order = list(runs) + list(reversed(runs))
    for i, label in enumerate(order, 1):
        t1 = time.perf_counter()
        res_i = solve_window_batched(nudge(i), datas, opts, **runs[label])
        torch.cuda.synchronize()
        secs[label].append(time.perf_counter() - t1)
        if label == "kernel":
            nudged.append(res_i)
    for i in range(len(order) + 1,
                   len(order) + 1 + NUDGE_SAMPLES - len(nudged)):
        nudged.append(solve_window_batched(nudge(i), datas, opts))
    ab = {label: B / float(np.median(t)) for label, t in secs.items()}
    want = {"kernel": only({"lane_cholesky_solve[f32]": ITERS}),
            "library": only({}),
            "high": only({"lane_cholesky_solve[f32]": ITERS})}
    for label in runs:
        if launches[f"solve_window_batched {label}"] != want[label]:
            raise AssertionError(f"solve_window_batched {label}: launches "
                                 f"{launches[f'solve_window_batched {label}']}"
                                 f", want {want[label]}")
    ref_st, ref_info = out["kernel"]
    lib_st, lib_info = out["library"]
    hi_st, hi_info = out["high"]
    c0, c = hi_info.cost0.cpu().numpy(), hi_info.cost.cpu().numpy()
    if not (np.isfinite(c).all() and (c <= c0).all()
            and all(torch.isfinite(x).all() for x in hi_st)):
        raise AssertionError("gemm_precision='high': not finite or cost "
                             "not reduced")
    ref_c = ref_info.cost.cpu().numpy()

    def spread(run):
        """(median, max) relative cost and max |dp| of a run against the
        kernel's, over all B windows"""
        st, info = run
        rel = np.abs(info.cost.cpu().numpy() / ref_c - 1)
        return (float(np.median(rel)), float(rel.max()),
                float((st.p - ref_st.p).abs().max()))

    nums["batched"] = dict(windows=B, kernel_windows_per_s=ab["kernel"],
                           library_windows_per_s=ab["library"],
                           high_windows_per_s=ab["high"])
    for label, run in (("library", out["library"]), ("high", out["high"])):
        nums["batched"].update(zip(
            (f"{label}_median_cost_rel", f"{label}_max_cost_rel",
             f"{label}_max_abs_dp"), spread(run)))
    nudge_spread = np.array([spread(run) for run in nudged])
    nums["batched"].update(nudge_samples=len(nudged), **dict(zip(
        ("kernel_nudged_median_cost_rel", "kernel_nudged_max_cost_rel",
         "kernel_nudged_max_abs_dp"), nudge_spread.max(axis=0).tolist())))
    # lane_chol=False against the kernel at the cross-check vs CPU's
    # tolerances (cost rtol 1e-3, p atol 1e-3 m): f32 sums in another order,
    # compounded over ITERS iterations whose accept decisions compare them.
    # The cross-check's windows and p hold at those tolerances; over the
    # batch, cost holds in its median, and its worst window to 3x the
    # worst that a 1e-7 m nudge moves the kernel's own solve
    head = lambda x: x[:CHECK_WINDOWS].cpu().numpy()
    np.testing.assert_allclose(head(lib_info.cost), head(ref_info.cost),
                               rtol=1e-3, err_msg="lane_chol=False vs the "
                               "kernel")
    np.testing.assert_allclose(lib_st.p.cpu().numpy(), ref_st.p.cpu().numpy(),
                               atol=1e-3, rtol=0,
                               err_msg="lane_chol=False vs the kernel")
    worst_limit = 3 * nums["batched"]["kernel_nudged_max_cost_rel"]
    nums["batched"]["library_max_cost_rel_limit"] = worst_limit
    if not (nums["batched"]["library_median_cost_rel"] <= 1e-3
            and nums["batched"]["library_max_cost_rel"] <= worst_limit):
        raise AssertionError(
            "lane_chol=False vs the kernel over the batch: median relative "
            f"cost difference {nums['batched']['library_median_cost_rel']} "
            f"(limit 1e-3), worst {nums['batched']['library_max_cost_rel']} "
            f"(limit {worst_limit})")
    phase("solver options batched A/B", t0, **nums["batched"])
    nums["phase_s"] = time.perf_counter() - t_phase
    phase("solver options", t_phase)
    return launches, nums


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
    if counts != only({"lane_cholesky_solve[f64]": want}):
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
    counts_ck = checkpoint_round_trip(card["estimator"], simulate(seq_a), dev)
    launches = {"streaming A": counts_a, "streaming B": counts_b,
                "checkpoint round trip": counts_ck}
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
    """The legged EKF over sequence A's first EKF_SAMPLES samples on the
    card and on the CPU (f64): every sample's contacts and the final state,
    P included, within EKF_TOL relative. Returns the ms per sample on
    each."""
    t0 = time.perf_counter()
    n = EKF_SAMPLES
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


def native_sync_check(sim):
    """Sequence A's samples pushed into the native SensorSync and into
    PySensorSync at once; each camera frame's interval, cut
    SYNC_CUT_OFFSET after the frame (off the sample clock, so both ends
    interpolate), extracted from both when the stream reaches it, and once
    just before it does (both None). Every extract must be equal, exact."""
    t0 = time.perf_counter()
    nat, py = native.SensorSync(), E.PySensorSync()
    cuts = sorted(float(sim["t"][int(k)]) + SYNC_CUT_OFFSET
                  for k in sim["cam_idx"])
    prev, i, rows, none_checks = -1e18, 0, 0, 0
    for k in range(len(sim["t"])):
        if i < len(cuts) and sim["t"][k] >= cuts[i]:
            # one sample short of the cut: neither has the interval yet
            a, b = nat.extract(prev, cuts[i]), py.extract(prev, cuts[i])
            if a is not None or b is not None:
                raise AssertionError(f"native sync check: cut {i} extracted "
                                     f"before the stream reached it")
            none_checks += 1
        row = (sim["t"][k], sim["acc"][k], sim["gyr"][k], sim["phi"][k],
               sim["dphi"][k], sim["contacts"][k])
        nat.push(*row)
        py.push(*row)
        while i < len(cuts) and sim["t"][k] >= cuts[i]:
            a, b = nat.extract(prev, cuts[i]), py.extract(prev, cuts[i])
            if a is None or b is None or not np.array_equal(a, b):
                raise AssertionError(f"native sync check: cut {i} native "
                                     f"{None if a is None else a.shape} vs "
                                     f"Python {None if b is None else b.shape}")
            rows += len(a)
            prev, i = cuts[i], i + 1
    if i != len(cuts):
        raise AssertionError(f"native sync check: {i} of {len(cuts)} cuts")
    phase("native sync check", t0, samples=len(sim["t"]), extracts=i,
          rows=rows, not_yet_reached=none_checks, equal="exact")


def write_sequence_bag(sim, path, renderer):
    """Sequence `sim` as the A1 robot records it, on A1_TOPICS: 500 Hz IMU
    and joint states (position[0:12], velocity[0:12] with the planned
    contacts in velocity[12:16], foot forces in effort[12:16]; reference
    main.cpp:262-278), mocap at 500 / MOCAP_STRIDE Hz (orientation xyzw),
    and the renderer's stereo pair at every camera frame, stamped at sim
    time + BAG_EPOCH. Returns the messages per topic."""
    counts = Counter()
    cams = set(int(k) for k in sim["cam_idx"])
    with BagWriter(str(path)) as w:
        def put(key, msg):
            w.write(A1_TOPICS[key], msg)
            counts[A1_TOPICS[key]] += 1

        for k in range(len(sim["t"])):
            t = float(sim["t"][k]) + BAG_EPOCH
            put("imu", ImuMsg(stamp=t, acc=sim["acc"][k], gyr=sim["gyr"][k]))
            put("leg", JointStateMsg(
                stamp=t, position=np.concatenate([sim["phi"][k], np.zeros(4)]),
                velocity=np.concatenate([sim["dphi"][k], sim["contacts"][k]]),
                effort=np.concatenate([np.zeros(12), sim["foot_forces"][k]])))
            if k % MOCAP_STRIDE == 0:
                q = sim["q"][k]
                put("mocap", PoseStampedMsg(stamp=t, p=sim["p"][k],
                                            q=np.array([q[1], q[2], q[3],
                                                        q[0]])))
            if k in cams:
                im0, im1 = renderer.render_stereo(k)
                put("image0", ImageMsg(stamp=t, data=im0))
                put("image1", ImageMsg(stamp=t, data=im1))
    return dict(counts)


def bag_to_dataset(sim, out_dir=BAG_DIR):
    """Write sequence A's bag (640x480 stereo from ImageRenderer) and
    convert it to a schema-v1 dataset, both under out_dir. Returns the
    dataset's directory."""
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    bag, ds_dir = out_dir / "sequence_a.bag", out_dir / "sequence_a"
    counts = write_sequence_bag(sim, bag, ImageRenderer(sim,
                                                        EstimatorConfig()))
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ds = convert_rosbag(str(bag), str(ds_dir))
    phase("bag -> dataset", t0, bag_bytes=bag.stat().st_size,
          messages=counts, write_s=write_s,
          convert_s=time.perf_counter() - t1, samples=len(ds["t"]),
          images=len(ds["image_paths"]), mocap=len(ds["mocap_t"]))
    return ds_dir


def bag_replay_cli(ds_dir, dev):
    """The dataset replayed by the command line on the card, in-process:
    `python -m cerberus_tpu_torch.data.replay --dataset DIR --images --csv
    ... --metrics ... --max-frames 20` (ImageLoader at the renderer's focal
    length, DeviceTracker, the default f64 estimator on the card) with the
    estimator's native sync required (use_native=True) and its frames
    timed. Gates, launches, the CSV and the metrics read back. Returns
    (launches, numbers)."""
    csv, metrics = BAG_DIR / "replay.csv", BAG_DIR / "metrics.jsonl"
    argv = ["--dataset", str(ds_dir), "--images", "--csv", str(csv),
            "--metrics", str(metrics), "--max-frames", str(STREAM_FRAMES),
            "--device", dev.type]
    clocks = []

    class CardEstimator(E.Estimator):
        def __init__(self, *a, **kw):
            super().__init__(*a, use_native=True, **kw)
            clocks.append(FrameClock(self, whole_device=False))

    inner = replay_mod.Estimator
    replay_mod.Estimator = CardEstimator
    t0 = time.perf_counter()
    reset_counts()
    try:
        out = replay_mod._main(argv)
        torch.cuda.synchronize()
    finally:
        replay_mod.Estimator = inner
    counts = read_counts()
    wall = time.perf_counter() - t0
    est = out["estimator"]
    st = est.stats
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
    recs = read_metrics(str(metrics))
    solve_recs = [r for r in recs if r["kind"] == "solve"]
    nums = dict(frames=STREAM_FRAMES, frames_per_s=STREAM_FRAMES / wall,
                median_ms_per_nonlinear_frame=float(np.median(clocks[0].ms)),
                track_ms_per_frame=out["track_ms_per_frame"],
                image_read_ms_per_frame=out["render_ms_per_frame"],
                ate_rmse=out["ate_rmse"], drift_pct=out["drift_pct"],
                keyframes=st["keyframes"], solves=st["solves"],
                init_solves=st["init_solves"], reboots=st["reboots"],
                f64_launches=counts["lane_cholesky_solve[f64]"],
                csv_rows=rows.shape[0], metrics_records=len(recs))
    phase("bag replay CLI", t0, launches=counts, **nums)
    check_launches("bag replay CLI", out, counts)
    gates = {"solver_flag == NON_LINEAR": est.solver_flag == est.NON_LINEAR,
             "reboots == 0": st["reboots"] == 0,
             f"ate_rmse <= {BAG_ATE_GATE}": out["ate_rmse"] <= BAG_ATE_GATE,
             "native sync": isinstance(est.sync, native.SensorSync),
             "tracker frames": out["tracker"].stats["frames"]
             == STREAM_FRAMES,
             "CSV: 20 columns, a row per published frame":
             rows.shape == (len(out["est_t"]), 20)
             and bool(np.isfinite(rows).all()),
             "metrics: a solve record per solve":
             len(solve_recs) == st["solves"] > 0}
    if not all(gates.values()):
        raise AssertionError(f"bag replay CLI gates: {gates}")
    return counts, nums


def checkpoint_round_trip(est, sim, dev):
    """save_estimator of `est` (streaming A's first CHECK_FRAMES frames on
    the card), load_estimator into a fresh Estimator on the card, then the
    next frames up to STREAM_FRAMES into both: every published pose and
    the final window's positions within CKPT_TOL. Returns the launches."""
    t0 = time.perf_counter()
    BAG_DIR.mkdir(parents=True, exist_ok=True)
    path = BAG_DIR / "streaming_a_checkpoint.npz"
    save_estimator(est, str(path))
    twin = load_estimator(E.Estimator(EstimatorConfig(), device=dev,
                                      use_native=True), str(path))
    feats = {int(k): f for k, f in zip(sim["cam_idx"], sim["features"])}
    solves0 = est.stats["solves"]
    worst = 0.0
    reset_counts()
    for k in sorted(feats)[CHECK_FRAMES:STREAM_FRAMES]:
        for e in (est, twin):
            e.input_image(sim["t"][k], feats[k])
        worst = max(worst, float(np.abs(est.pose[0] - twin.pose[0]).max()))
    for e in (est, twin):
        e.flush()
    torch.cuda.synchronize()
    counts = read_counts()
    worst = max(worst, float(np.abs(est.p - twin.p).max()))
    solves = (est.stats["solves"] - solves0, twin.stats["solves"])
    phase("checkpoint round trip", t0, bytes=path.stat().st_size,
          frames=STREAM_FRAMES - CHECK_FRAMES, solves=solves,
          max_abs_dp=worst, launches=counts)
    if not (worst <= CKPT_TOL and solves[0] == solves[1] > 0
            and twin.solver_flag == twin.NON_LINEAR):
        raise AssertionError(f"checkpoint round trip: |dp| {worst}, "
                             f"solves {solves}")
    return counts


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
    if counts != only({"lane_cholesky_solve[f32]": ITERS}):
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
    nums["distributed"] = distributed_pooled_step(dev, off, datas)
    return counts, nums


def distributed_pooled_step(dev, states, datas):
    """pooled_calibration_step under a one-process nccl group
    (init_distributed at a free localhost port) against the same step
    without a group, just before it: H, b and dx must be equal (an
    all-reduce over one process is a copy)."""
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = init_distributed(f"localhost:{port}", 1, 0, device=dev)
    try:
        backend = torch.distributed.get_backend(group)
        _, dx, H, b = pooled_calibration_step(states, datas)
        _, dx_g, H_g, b_g = pooled_calibration_step(states, datas,
                                                    group=group)
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    diffs = {k: float((a - c).abs().max()) for k, a, c in
             (("H", H_g, H), ("b", b_g, b), ("dx", dx_g, dx))}
    nums = dict(backend=backend, world_size=1, max_abs_diff=diffs)
    phase("distributed pooled step", t0, **nums)
    if backend != "nccl" or max(diffs.values()) != 0.0:
        raise AssertionError(f"distributed pooled step: {nums}")
    return nums


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


# the measurement drivers (`measurement drivers`): the port's
# `evals/profile_*.py`, `bench_klt.py` and `multichip_scaling.py` through
# their `main`, on the card, cut in reps only (and multichip_scaling to the
# one card)
DRIVER_REPS = "2"
SOLVER_B = "128"        # profile_solver's B (environment variable B): its
#                         default; dense1 there peaks at 11.2 GB on the card
KLT_B = "16"            # bench_klt's streams (KLT_BATCH), its default
INLOOP_BATCHES = "128,512,1024"
FULL_VS_CPU_TOL = 1e-3  # m: profile_inloop's full variant, card f32 vs CPU f64
KLT_CHECK_B = 2         # bench_klt streams held to the CPU
KLT_POS_TOL = 1e-3      # px
# each driver's result keys: the JAX driver's, and the port's device name
# and launches per timed program
DRIVER_KEYS = {
    "profile_inloop": {"platform", "dtype", "batch", "F", "variant_full_ms",
                       "variant_no_chol_ms", "variant_asm_once_ms",
                       "inloop_cholesky_ms_per_iter",
                       "inloop_assembly_ms_per_iter", "batch_sweep", "note"},
    "profile_batched": {"platform", "dtype", "batch", "reps",
                        "null_roundtrip_ms", "full_solve_ms", "per_window_us",
                        "assembly_ms_per_iter", "schur_cholesky_ms_per_iter",
                        "retract_ms_per_iter", "extrapolated_12it_ms",
                        "residual_overhead_ms", "note"},
    "profile_solver": {"platform", "B", "F", "solve12_ms", "solve1_ms",
                       "assembly_ms", "assembly+chol_ms", "cost_ms",
                       "gaugeQR_ms", "dense1_ms"},
    "profile_streaming": {"platform", "F", "null_roundtrip_ms",
                          "preint_scan_S48_ms", "assembly_ms", "solve_1it_ms",
                          "solve_2it_ms", "solve_4it_ms", "solve_8it_ms",
                          "solve_12it_ms", "per_iter_ms", "marg_old_ms",
                          "_device_estimates"},
    "bench_klt": {"metric", "value", "unit", "point_tracks_per_s", "batch",
                  "points", "resolution", "levels", "platform",
                  "batch_latency_ms", "note"},
    "multichip_scaling": {"rows", "note", "solver"}}
PORT_KEYS = {"device_name", "_launches"}
# the times each driver measures (> 0); the differences derived from them
# (in-loop Cholesky, stage times less the null roundtrip, the residual)
# need only be finite
MEASURED = {
    "profile_inloop": ("variant_full_ms", "variant_no_chol_ms",
                       "variant_asm_once_ms"),
    "profile_batched": ("null_roundtrip_ms", "full_solve_ms",
                        "per_window_us"),
    "profile_solver": ("solve12_ms", "solve1_ms", "assembly_ms",
                       "assembly+chol_ms", "cost_ms", "gaugeQR_ms",
                       "dense1_ms"),
    "profile_streaming": ("null_roundtrip_ms", "preint_scan_S48_ms",
                          "assembly_ms", "solve_1it_ms", "solve_2it_ms",
                          "solve_4it_ms", "solve_8it_ms", "solve_12it_ms",
                          "marg_old_ms"),
    "bench_klt": ("value", "point_tracks_per_s", "batch_latency_ms"),
    "multichip_scaling": ()}


def rows_of(by_shape):
    """A driver's launches of one timed program ({"float32 B=128 n=222":
    k}, `evals.measure.launches_since`) as read_counts()'s rows."""
    counts = only({})
    for key, k in by_shape.items():
        dt, B, n = key.split()
        B, n = int(B[2:]), int(n[2:])
        if dt == "float32":
            counts["lane_cholesky_solve[f32]"] += k
            if n == 222 and B in (512, 1024):
                counts[f"lane_cholesky_solve[f32] B={B}"] += k
            if n == 382:
                counts["lane_cholesky_solve[f32] n=382"] += k
        else:
            counts["lane_cholesky_solve[f64]"] += k
            if n == 382:
                counts["lane_cholesky_solve[f64] n=382"] += k
    return counts


def driver_launches_per_call(name, res):
    """{timed program: {shape: launches per call}} that the driver's
    result says it ran: ITERS per 12-iteration solve, one per single
    damped solve, it per solve of it iterations, none elsewhere."""
    f32 = lambda B, n: f"float32 B={B} n={n}"
    if name == "profile_inloop":
        B = res["batch"]
        want = {f"variant_{v}": {} if v == "no_chol" else {f32(B, 222): ITERS}
                for v in profile_inloop.VARIANTS}
        want.update({f"prod_B{r['batch']}": {f32(r["batch"], 222): ITERS}
                     for r in res["batch_sweep"]})
        return want
    if name == "profile_batched":
        B = res["batch"]
        return {"null_roundtrip": {}, "full_solve_12it": {f32(B, 222): ITERS},
                "assembly_x1": {}, "schur_cholesky_x1": {f32(B, 222): 1},
                "retract_x1": {}}
    if name == "profile_solver":
        B, n = res["B"], 222 + res["F"]
        return {"solve12": {f32(B, 222): ITERS}, "solve1": {f32(B, 222): 1},
                "assembly": {}, "assembly+chol": {f32(B, n): 1}, "cost": {},
                "gaugeQR": {}, "dense1": {f32(B, n): 1}}
    if name == "profile_streaming":
        return {"null": {}, "preint": {}, "assembly": {}, "marg_old": {},
                **{f"solve_{it}it": {f32(1, 222): it}
                   for it in profile_streaming.SOLVE_ITERS}}
    if name == "bench_klt":
        return {"klt": {}}
    return {str(r["n"]): {f32(r["batch"], 222): ITERS} for r in res["rows"]}


def path_name(name, tag):
    """The kernels line's path of a driver's timed program."""
    tag = {"variant_full": "full", "variant_no_chol": "no_chol",
           "variant_asm_once": "asm_once"}.get(tag, tag)
    if tag.startswith("prod_B"):
        tag = f"sweep B={tag[6:]}"
    if name == "multichip_scaling":
        tag = f"n={tag}"
    return f"{name} {tag}" if tag != "klt" else name


def untimed_launches(name, res):
    """Launches a driver makes outside its timed programs: profile_batched
    solves once more for the dx its retract stage takes (the JAX driver's
    :312)."""
    if name == "profile_batched":
        return rows_of({f"float32 B={res['batch']} n=222": 1})
    return only({})


def check_driver(name, res, counts):
    """Gates on one driver's result: every key present, every measured
    time finite and > 0 and every number finite, dense1 a number, and the
    lane kernel's launches of every timed program exactly as its solves
    make them (calls x per call) and, with its untimed_launches, as the
    counts read around the call (in this process; multichip_scaling's
    solves run in a child process).
    Returns the launches per path."""
    missing = (DRIVER_KEYS[name] | PORT_KEYS) - set(res)
    if missing:
        raise AssertionError(f"{name}: result keys missing: {missing}")
    nums = {k: v for k, v in res.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}
    nums.update({f"{k}.{i}.{kk}": vv for k in ("batch_sweep", "rows")
                 for i, row in enumerate(res.get(k, ()))
                 for kk, vv in row.items() if isinstance(vv, (int, float))})
    bad = [k for k, v in nums.items() if not np.isfinite(v)]
    bad += [k for k in MEASURED[name] if not (isinstance(res[k], float)
                                              and res[k] > 0)]
    bad += [f"rows.{i}" for i, row in enumerate(res.get("rows", ()))
            if "error" in row or not row["latency_ms"] > 0]
    bad += [f"batch_sweep.{i}" for i, row in enumerate(
        res.get("batch_sweep", ())) if not row["ms"] > 0]
    if bad:
        raise AssertionError(f"{name}: not a finite time > 0: {bad}")
    want = driver_launches_per_call(name, res)
    got = res["_launches"]
    if set(got) != set(want):
        raise AssertionError(f"{name}: timed programs {sorted(got)}, want "
                             f"{sorted(want)}")
    paths, total = {}, untimed_launches(name, res)
    for tag, per_call in want.items():
        expect = {shape: k * got[tag]["calls"] for shape, k in
                  per_call.items()}
        if got[tag]["by_shape"] != expect:
            raise AssertionError(f"{name} {tag}: launches "
                                 f"{got[tag]['by_shape']}, want {expect} "
                                 f"({got[tag]['calls']} calls)")
        paths[path_name(name, tag)] = rows_of(got[tag]["by_shape"])
        total = {k: total[k] + paths[path_name(name, tag)][k] for k in total}
    if name == "multichip_scaling":
        total = only({})
    if counts != total:
        raise AssertionError(f"{name}: launches counted {counts}, the "
                             f"driver's programs account for {total}")
    return paths


def measurement_drivers(dev, children):
    """The port's measurement drivers on the card, each through its `main`
    with `--device cuda`, cut in reps (DRIVER_REPS) only but for
    multichip_scaling's one mesh size (`--devices 1`: one card); each
    driver's launches counted around its call and per timed program (its
    `_launches`), its result gated (check_driver). profile_inloop's full
    variant on the first two windows, card (f32) against the CPU (f64),
    within FULL_VS_CPU_TOL; bench_klt's tracks of KLT_CHECK_B streams card
    against CPU on the same images. Runs while the children run, and says
    how many still do at its start and end. Returns (launches per path,
    numbers)."""
    t_phase = time.perf_counter()
    running = lambda: sum(p.poll() is None for p in children.values())
    print(f"[measurement drivers] children still running: {running()}",
          flush=True)
    problem = measure.bench_problem(dev, torch.float32)
    argv = ["--device", "cuda", "--reps", DRIVER_REPS]
    runs = {
        "profile_inloop": lambda: profile_inloop.main(
            argv + ["--batches", INLOOP_BATCHES], problem=problem),
        "profile_batched": lambda: profile_batched.main(argv,
                                                        problem=problem),
        "profile_solver": lambda: profile_solver.main(argv, problem=problem),
        "profile_streaming": lambda: profile_streaming.main(
            argv, problem=problem),
        "bench_klt": lambda: bench_klt.main(argv),
        "multichip_scaling": lambda: multichip_scaling.main(
            argv + ["--devices", "1"])}
    env = {"B": SOLVER_B, "KLT_BATCH": KLT_B}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    launches, results = {}, {}
    try:
        for name, run in runs.items():
            t0 = time.perf_counter()
            reset_counts()
            res = run()
            torch.cuda.synchronize()
            counts = read_counts()
            launches.update(check_driver(name, res, counts))
            results[name] = {k: v for k, v in res.items()
                             if k != "_launches"}
            phase(f"measurement drivers: {name}", t0, launches=counts)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    t0 = time.perf_counter()
    states, datas = measure.make_batch(problem, 2)
    on_cpu = lambda t: fac.map_tensors(
        lambda x: x.cpu().double() if x.is_floating_point() else x.cpu(), t)
    card = profile_inloop.variant_loop("full", states, datas)[0].p[:, 0, 0]
    cpu = profile_inloop.variant_loop("full", on_cpu(states),
                                      on_cpu(datas))[0].p[:, 0, 0]
    full_dp = float((card.cpu().double() - cpu).abs().max())
    inputs = bench_klt.make_inputs(KLT_CHECK_B, dev)
    klt_card = bench_klt.track_batch(*inputs)
    klt_cpu = bench_klt.track_batch(*(x.cpu() for x in inputs))
    status_equal = torch.equal(klt_card.status.cpu(), klt_cpu.status)
    kept = klt_cpu.status
    klt_dp = float((klt_card.pts.cpu() - klt_cpu.pts)[kept].abs().max())
    phase("measurement drivers vs CPU", t0, full_p00_max_abs_dp=full_dp,
          klt_tracked=int(kept.sum()), of=kept.numel(),
          klt_max_abs_dp=klt_dp, klt_status_equal=status_equal)
    if not (full_dp <= FULL_VS_CPU_TOL and status_equal
            and klt_dp <= KLT_POS_TOL and bool(kept.any())):
        raise AssertionError(f"measurement drivers vs CPU: full variant "
                             f"p[0, 0] {full_dp} m, klt {klt_dp} px, status "
                             f"equal {status_equal}")
    results["vs_cpu"] = dict(full_p00_max_abs_dp=full_dp,
                             klt_max_abs_dp=klt_dp)
    phase("measurement drivers", t_phase, cuts=f"reps={DRIVER_REPS},"
          f"profile_solver_B={SOLVER_B},multichip_devices=1",
          children_still_running=running())
    return launches, results


def long_run_loop(dev):
    """The port's long run with loop closure on the card, in-process:
    `python -m cerberus_tpu_torch.evals.long_run` with LONG_RUN_ARGV
    (prerendered 640x480 stereo -> DeviceTracker -> the default f64
    estimator, pipelined -> LoopCloser on the estimator's keyframes, its
    pose graph on the card), with the estimator's NON_LINEAR frames timed
    (FrameClock) and the pose graph's optimizes logged (GuardLog). Gates:
    no reboot, a loop found, corrected keyframe ATE below the odometric
    one on the same keyframes, the f64 kernel once per LM iteration, and
    ATE and corrected ATE at most 2x the JAX package's on the same run.
    Returns (launches, numbers)."""
    from cerberus_tpu_torch.evals import long_run

    made = {"frames": 0}

    class CardEstimator(long_run.Estimator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["clock"], made["est"] = FrameClock(self, False), self
            timed = self.input_image

            def counted(t, feats):
                made["frames"] += 1
                timed(t, feats)

            self.input_image = counted

    class CardCloser(long_run.LoopCloser):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["log"], made["closer"] = GuardLog(self.pg), self

    inner = long_run.Estimator, long_run.LoopCloser
    long_run.Estimator, long_run.LoopCloser = CardEstimator, CardCloser
    t0 = time.perf_counter()
    reset_counts()
    try:
        res = long_run.main(LONG_RUN_ARGV + ["--device", dev.type])
        torch.cuda.synchronize()
    finally:
        long_run.Estimator, long_run.LoopCloser = inner
    counts = read_counts()
    est, closer, log, loop = made["est"], made["closer"], made["log"], \
        res["loop"]
    st = est.stats
    ms = made["clock"].ms
    nums = dict(frames=made["frames"],
                frames_per_s=made["frames"] / res["wall_s"],
                median_ms_per_nonlinear_frame=float(np.median(ms)),
                median_ms_by_100_frames=[float(np.median(ms[i:i + 100]))
                                         for i in range(0, len(ms), 100)],
                track_ms_per_frame=res["track_ms_per_frame"],
                prerender_s=res["prerender_s"], ate_rmse_m=res["ate_rmse_m"],
                drift_pct=res["drift_pct"], distance_m=res["distance_m"],
                keyframes=st["keyframes"], solves=st["solves"],
                init_solves=st["init_solves"], reboots=st["reboots"],
                f64_launches=counts["lane_cholesky_solve[f64]"],
                **{("loop_nodes" if k == "keyframes" else k): v
                   for k, v in loop.items()},
                seq_gated=closer.seq_gated,
                ms_per_device_optimize=1e3 * float(np.mean(log.once_s))
                if log.once_s else None,
                device_optimizes=len(log.once_s),
                ms_per_optimize_call=1e3 * log.optimize_s
                / max(len(log.calls), 1),
                phase_s=time.perf_counter() - t0)
    phase("long run loop", t0, launches=counts, **nums)
    check_launches("long run loop", {"estimator": est}, counts)
    gates = {"reboots == 0": st["reboots"] == 0,
             "solves > 0": st["solves"] > 0,
             "loops_found >= 1": loop["loops_found"] >= 1,
             "corrected_ate_m < odometric_kf_ate_m":
                 loop["corrected_ate_m"] < loop["odometric_kf_ate_m"]}
    for name, got in (("ate_rmse_m", res["ate_rmse_m"]),
                      ("corrected_ate_m", loop["corrected_ate_m"])):
        gates[f"{name} <= 2 x JAX's {JAX_LONG_RUN[name]}"] = \
            got <= 2 * JAX_LONG_RUN[name]
    if not all(gates.values()):
        raise AssertionError(f"long run loop gates: {gates}")
    return counts, nums


def _child_setup():
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def long_run_loop_child():
    """`long run loop` in a process of its own (start_child): it simulates
    and prerenders its frames at once, then waits for the parent's release
    (the kernels phase has ended, so none of its launches overlaps the
    kernels' timings) before it replays them; prints its phase line, then
    its launches and numbers as one JSON line."""
    from cerberus_tpu_torch.evals import long_run

    class ThenWait(long_run.PrerenderedFrames):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sys.stdin.readline()

    long_run.PrerenderedFrames = ThenWait
    counts, nums = long_run_loop(_child_setup())
    print(json.dumps({"launches": {"long run loop": counts},
                      "numbers": nums}), flush=True)


def run_configs_child():
    """`run configs` in a process of its own (start_child), once the
    parent releases it: its phase lines, then its launches per path and
    numbers as one JSON line."""
    sys.stdin.readline()
    launches, nums = run_configs(_child_setup())
    print(json.dumps({"launches": launches, "numbers": nums}), flush=True)


def robustness_child(name):
    """ROBUSTNESS_CHILDREN[name] (robustness) in a process of its own
    (start_child), once the parent releases it, and after `estimator
    branches` the streaming diagnostics (diagnostics_streaming): its phase
    lines, then its launches per run and numbers as one JSON line."""
    sys.stdin.readline()
    dev = _child_setup()
    torch.set_num_threads(1)   # host-bound Python; the card does the work
    launches, nums = robustness(dev, name)
    if name == "estimator branches":
        diag_launches, nums["diagnostics"] = diagnostics_streaming(dev)
        launches.update(diag_launches)
    print(json.dumps({"launches": launches, "numbers": nums}), flush=True)


# phases that run in processes of their own beside the parent's, each
# host-bound with the card idle most of the time: name -> the call that
# runs it
CHILDREN = {"long run loop": "long_run_loop_child()",
            "run configs": "run_configs_child()",
            **{name: f"robustness_child({name!r})"
               for name in ROBUSTNESS_CHILDREN}}


def child_log(name):
    return BAG_DIR / (name.replace(" ", "_") + ".log")


def start_child(name):
    """Start phase `name` of CHILDREN in a child process; it makes no
    launch before release_child. Its output goes to child_log(name);
    finish_child collects it."""
    log_path = child_log(name)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.{CHILDREN[name]}"],
            cwd=Path(__file__).resolve().parent,
            env=dict(os.environ, OMP_NUM_THREADS="2"),
            stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT)
    print(f"[{name}] started in process {proc.pid}", flush=True)
    return proc


def release_child(name, proc):
    """Let a child of start_child make its launches."""
    proc.stdin.write(b"kernels done\n")
    proc.stdin.close()
    print(f"[{name}] released", flush=True)


def finish_child(name, proc):
    """Wait for a child of start_child, print its output, and return its
    (launches per path, numbers); a failed child raises."""
    t0 = time.perf_counter()
    rc = proc.wait()
    text = child_log(name).read_text()
    print(f"[{name}] waited {time.perf_counter() - t0:.3f} s for process "
          f"{proc.pid}, exit code {rc}; its output:", flush=True)
    print(text.rstrip(), flush=True)
    if rc != 0:
        raise AssertionError(f"{name}: exit code {rc}")
    out = json.loads(text.strip().splitlines()[-1])
    return out["launches"], out["numbers"]


def run_configs(dev):
    """The port's configuration matrix on the card, in-process:
    `python -m cerberus_tpu_torch.evals.run_configs --configs C --duration
    RUN_CONFIGS_S` for C = 1..6, one call each with its launches counted,
    then `python -m cerberus_tpu_torch.evals.long_run` in feature mode for
    each of LONG_RUN_FEATURES. Gates: solves > 0 and no reboot in every
    replay, the f64 kernel once per LM iteration of each (config 5: the
    f32 kernel once per iteration), config 1's slip-free drift < 20 %,
    config 4's calf length (rho) closer to the true 0.215 m than to its
    0.21 start, every config 5 window's cost dropping, config 6 with both
    trackers. Returns (launches per path, numbers)."""
    from cerberus_tpu_torch.evals import long_run
    from cerberus_tpu_torch.evals import run_configs as rc

    ests = []

    def capture(Est):
        class CardEstimator(Est):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                ests.append(self)
        return CardEstimator

    inner = rc.Estimator, long_run.Estimator
    rc.Estimator, long_run.Estimator = capture(rc.Estimator), \
        capture(long_run.Estimator)
    runs = [(f"run configs {c}", rc.main,
             ["--configs", c, "--duration", RUN_CONFIGS_S])
            for c in "123456"]
    runs += [(label, long_run.main, argv)
             for label, argv in LONG_RUN_FEATURES.items()]
    launches, results, gates, made = {}, {}, {}, {}
    try:
        for label, main, argv in runs:
            t0 = time.perf_counter()
            first = len(ests)
            reset_counts()
            res = main(argv + ["--device", dev.type])
            torch.cuda.synchronize()
            counts = read_counts()
            mine = ests[first:]
            if label == "run configs 5":
                want = only({"lane_cholesky_solve[f32]": FLEET_CONFIG_ITERS})
            else:
                want = only({"lane_cholesky_solve[f64]": sum(
                    ITERS * e.stats["solves"]
                    + E.INIT_ITERS * e.stats["init_solves"] for e in mine)})
            res = {k: v for k, v in res.items() if k != "_meta"}
            phase(label, t0, launches=counts, estimators=len(mine),
                  result=json.dumps(res))
            gates[f"{label}: launches {counts} == {want}"] = counts == want
            gates[f"{label}: solves > 0, no reboot"] = all(
                e.stats["solves"] > 0 and e.stats["reboots"] == 0
                for e in mine)
            launches[label], results[label], made[label] = counts, res, mine
    finally:
        rc.Estimator, long_run.Estimator = inner
    no_slip = results["run configs 1"]["1_ekf_only"]["no_slip"]["drift_pct"]
    rho = float(np.mean(made["run configs 4"][0].rho[10]))   # unrounded
    gates.update({
        "config 1: no-slip drift_pct < 20": no_slip < 20.0,
        "config 4: rho nearer 0.215 than 0.21": abs(rho - 0.215) < 0.005,
        "config 5: every window's cost drops":
            results["run configs 5"]["5_fleet"]["all_converged"],
        "config 6: both trackers": set(results["run configs 6"]) == {
            "6_image_vilo_cv", "6_image_vilo_device"}})
    results["config 4 rho_final (unrounded)"] = rho
    if not all(gates.values()):
        raise AssertionError(f"run configs gates: "
                             f"{[g for g, ok in gates.items() if not ok]}")
    return launches, results


def robustness(dev, name):
    """Runs ROBUSTNESS_CHILDREN[name] of the port's robustness battery on
    the card, in-process: `python -m cerberus_tpu_torch.evals.robustness
    --duration ROBUSTNESS_S --cases C` for each case C (the default f64
    EstimatorConfig) or `--cases none --branches B` for each branch run B,
    one call each with its launches counted. Gates, per run: no error and
    solves > 0; the f64 kernel once per LM iteration (ITERS a solve, across
    restarts, INIT_ITERS an initialization solve) and nothing else;
    reboots equal to the JAX package's (JAX_ROBUSTNESS), at least one on
    `reboot`; drift % and ATE at most 2x the JAX package's; the td cases'
    final td nearer 0 than their +/-20 ms start and within TD_GATE_MS of
    the JAX package's; `mono_swap` ending NON_LINEAR in mono; the stale
    IMU intervals of `imu_dropout_2x1s` > 0 and equal to the JAX
    package's. In a run that adopts a step whose newest interval is a
    placeholder (robustness.watch: a stale IMU, or an interval dropped when
    td grew), what follows is roundoff in either package: there the first
    such step must come where the JAX package's came, and the drift and ATE
    gates hold the frames published before it. Returns (launches per run,
    numbers)."""
    from cerberus_tpu_torch.evals import robustness as rb

    branch = name == "estimator branches"
    launches, results, gates = {}, {}, {}
    for run in ROBUSTNESS_CHILDREN[name]:
        label = f"{name}: {run}"
        argv = (["--cases", "none", "--branches", run] if branch
                else ["--cases", run])
        t0 = time.perf_counter()
        reset_counts()
        res = rb.main(argv + ["--duration", ROBUSTNESS_S,
                              "--device", dev.type])
        torch.cuda.synchronize()
        counts = read_counts()
        entry, n = res[run], res["_meta"]["estimator"][run]
        jax = JAX_ROBUSTNESS[run]
        want = only({"lane_cholesky_solve[f64]": ITERS * n["solves_all"]
                     + E.INIT_ITERS * n["init_solves"]})
        nums = dict(entry, **n, frames_per_s=n["frames"] / entry["wall_s"])
        phase(label, t0, launches=counts, result=json.dumps(nums))
        g = {"no error, solves > 0": "error" not in entry
             and entry["solves"] > 0,
             f"launches {counts} == {want}": counts == want,
             f"reboots == JAX's {jax['reboots']}":
                 entry["reboots"] == jax["reboots"]}
        if "error" not in entry and jax["placeholder_at"] is None:
            g["no placeholder step, as JAX"] = n["placeholder_at"] is None
            for k in ("drift_pct", "ate_rmse"):
                g[f"{k} <= 2 x JAX's {jax[k]:.6g}"] = entry[k] <= 2 * jax[k]
        elif "error" not in entry:
            # past its first step on a placeholder interval the answer is
            # roundoff in either package: the run is held up to there
            jb, b = jax["before_placeholder"], n.get("before_placeholder")
            g[f"first placeholder step adopted at JAX's "
              f"{jax['placeholder_at']:.4f} s"] = \
                n["placeholder_at"] is not None and \
                abs(n["placeholder_at"] - jax["placeholder_at"]) < 1e-9
            if b is not None:
                g[f"{b['frames']} frames before it, as JAX's"] = \
                    b["frames"] == jb["frames"]
                for k in ("drift_pct", "ate_rmse"):
                    g[f"{k} before it <= 2 x JAX's {jb[k]:.6g}"] = \
                        b[k] <= 2 * jb[k]
        if "td_final_ms" in jax:
            td, td0 = entry.get("td_final_ms", np.inf), \
                (20.0 if "+" in run else -20.0)
            g["|td_final| < |td_init|"] = abs(td) < abs(td0)
            g[f"td_final within {TD_GATE_MS} ms of JAX's "
              f"{jax['td_final_ms']:.4f}"] = \
                abs(td - jax["td_final_ms"]) <= TD_GATE_MS
        if run == "reboot":
            g["reboots >= 1"] = entry["reboots"] >= 1
        if run == "mono_swap":
            g["NON_LINEAR, mono"] = entry.get("solver_flag") == \
                "NON_LINEAR" and entry.get("stereo") is False
        if run == "imu_dropout_2x1s":
            g[f"stale IMU intervals {n['stale_imu_intervals']} > 0, == "
              f"JAX's {jax['stale_imu_intervals']}"] = \
                0 < n["stale_imu_intervals"] == jax["stale_imu_intervals"]
        gates.update({f"{label}: {k}": ok for k, ok in g.items()})
        launches[label], results[label] = counts, nums
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"{name} gates: {failed}")
    return launches, results


# the diagnostics (`diagnostics`): the port's eleven `evals/diag_*.py` on
# the card, held to the JAX package's numbers at the same sizes
# (JAX_DIAGNOSTICS, from tools/jax_diagnostics.py) through diag_digest


def _rows(rows, key):
    return [float(r[key]) for r in rows]


def diag_digest(name, res):
    """The numbers of diagnostic `name`'s result (the port's, or the JAX
    package's from tools/jax_diagnostics.py, as JSON) that the gates hold:
    {key: value}. Ints, strings and lists of them are held equal; floats
    and lists of floats within DIAG_REL of the largest |JAX value| of the
    key, or within DIAG_ABS[key]; keys beginning with `_` are reported
    only."""
    res = json.loads(json.dumps(res, default=lambda x: x.tolist()
                                if hasattr(x, "tolist") else str(x)))
    d = {}
    if name == "diag_simcheck":
        rows = res["dead_reckoning"]
        for k in ("p_err", "v_err", "q_err"):
            d[k] = _rows(rows, k)
        d["max_q_err"] = res["max_q_err"]
        leg = res["leg_odom_vel_err"]
        d.update(leg_med=leg["med"], leg_p90=leg["p90"], leg_max=leg["max"],
                 leg_n=leg["n"])
    elif name == "diag_rho":
        fd, sol = res["fd_check"], res["window_solve"]
        for k in ("J_col", "fd", "deps_nom", "deps_true", "truth"):
            d[k] = np.ravel(fd[k]).tolist()
        d.update(cost0=sol["cost0"], cost=sol["cost"],
                 accepted=sol["accepted"], rho_frame5=sol["rho_frame5"],
                 pos_err=sol["pos_err"])
    elif name == "diag_proj":
        a, b = res["perfect_assoc"], res["final_window"]
        d.update(a_cost=a["cost"], a_n_rows=a["n_rows"], a_rms_px=a["rms_px"],
                 b_total=b["total"], b_n_features=b["n_features"],
                 b_worst_slots=[w["slot"] for w in b["worst"]],
                 b_worst_cost=[w["cost"] for w in b["worst"]],
                 b_worst_d_tru=[w["d_tru"] for w in b["worst"]],
                 b_anchor_n={k: v["n"] for k, v in b["anchors"].items()},
                 b_rms_mono=b["rms_mono_px"], b_rms_stereo=b["rms_stereo_px"])
    elif name == "diag_obs":
        d.update(checked=res["checked"],
                 bad=[list(b[:3]) for b in res["bad"]],
                 headers=res["headers"], keyframes=res["keyframes"])
    elif name == "diag_vision":
        for tag in ("on", "off"):
            rows = res[f"vision_{tag}"]
            d[f"{tag}_t"] = _rows(rows, "t")
            d[f"{tag}_accepted"] = [r["accepted"] for r in rows]
            for k in ("newest_err", "mean_err"):
                d[f"{tag}_{k}"] = _rows(rows, k)
            # a cost with a marginalization prior carries each package's
            # QR constant: the drops are held
            d[f"{tag}_cost_drop"] = [r["cost0"] - r["cost"] for r in rows]
            d[f"{tag}_entry_ileg_proj"] = [list(r["entry"][:2])
                                           for r in rows if "entry" in r]
            for k in ("rho", "bg", "ex_deg", "ex_dt"):
                d[f"{tag}_{k}"] = np.ravel([r[k] for r in rows]).tolist()
            if tag == "on":
                d["on_n_depths"] = [r["n_depths"] for r in rows]
                d["on_depth_err_med"] = _rows(rows, "depth_err_med")
        ce, ct = res["cost_est"], res["cost_tru"]
        d.update(est_ileg=ce["ileg"], est_proj=ce["proj"],
                 tru_ileg=ct["ileg"], tru_proj=ct["proj"],
                 cost_est_less_tru=ce["cost"] - ct["cost"],
                 prior_est_less_tru=ce["prior"] - ct["prior"])
    elif name == "diag_ex":
        for v, r in res.items():
            if not v.startswith("ex="):
                continue
            d.update({f"{v} {k}": r[k] for k in (
                "ate", "drift_pct", "dist", "dtic", "dang_deg",
                "keyframes")})
            inv = r["inv_depths"]
            d[f"{v} inv_depths"] = None if inv is None else \
                [inv["med"], inv["min"], inv["max"]]
            d[f"{v} inv_n"] = None if inv is None else inv["n"]
    elif name == "diag_dropout":
        cut = res["placeholder_at"]
        cut = np.inf if cut is None else cut
        d.update(reboots=res["reboots"],
                 stale_intervals=res["stale_intervals"],
                 placeholder_at=res["placeholder_at"],
                 failure_reasons_before=[list(f) for f in
                                         res["failure_reasons"]
                                         if f[0] < cut])
        d["err_before"] = [e for rows in res["err_around"].values()
                           for t, e in rows if t < cut]
        b = res.get("before_placeholder")
        if b is not None:
            d.update(before_frames=b["frames"],
                     before_drift_pct=b["drift_pct"],
                     before_ate=b["ate_rmse"])
        # past the placeholder step: roundoff in either package
        d.update(_drift_pct=res["drift_pct"], _ate=res["ate"],
                 _failure_reasons=res["failure_reasons"])
    elif name in ("diag_ekf_slip", "diag_ekf_slip2"):
        d["samples"] = res["samples"]
        for v, r in res.items():
            if isinstance(r, dict):
                for sim in ("slip", "clean"):
                    for k in ("drift_pct", "ate_rmse", "distance",
                              "final_err"):
                        d[f"{v} {sim} {k}"] = r[sim][k]
    elif name == "diag_tracker":
        d["frames"] = res["frames"]
        for tr in ("cv", "device"):
            r = res[tr]
            d.update({f"{tr} err_p50": r["err_p50"],
                      f"{tr} err_p90": r["err_p90"],
                      f"_{tr} n_feat_p50": r["n_feat_p50"],
                      f"_{tr} len_p50": r["len_p50"],
                      f"_{tr} births": r["births"]})
    elif name == "diag_loop":
        d.update({k: res[k] for k in (
            "keyframes", "skipped", "cand", "few_matches", "few_world",
            "pnp_fail", "pnp_ok", "loops_found", "n_loop_edges",
            "match_p50", "match_p90", "world_p50", "world_p90", "best_sim",
            "pnp_err_p50")})
    else:
        raise ValueError(name)
    return d


# absolute tolerances of digest keys: the tracker errors (px), and the
# diag_vision rows' fields the script rounds (one unit of its rounding)
DIAG_ABS = {"cv err_p50": DIAG_TRACK_PX, "cv err_p90": DIAG_TRACK_PX,
            "device err_p50": DIAG_TRACK_PX,
            "device err_p90": DIAG_TRACK_PX,
            **{f"{tag}_{k}": tol for tag in ("on", "off")
               for k, tol in (("rho", 1e-4), ("bg", 1e-4), ("ex_deg", 1e-3),
                              ("ex_dt", 1e-4), ("entry_ileg_proj", 0.1))}}


def _flat(x):
    """A digest value as a flat list (None as NaN)."""
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [float("nan") if x is None else x]


def diag_failures(name, got):
    """The keys of `got` (diag_digest of the port's result) that miss
    JAX_DIAGNOSTICS[name]: a list of strings."""
    want = JAX_DIAGNOSTICS[name]
    bad = [f"{k}: missing" for k in want if k not in got]
    for k, w in want.items():
        if k.startswith("_") or k not in got:
            continue
        g = got[k]
        if isinstance(w, dict) or w is None or g is None:
            ok = g == w
        else:
            gg, gw = _flat(g), _flat(w)
            if len(gg) != len(gw):
                ok = False
            elif any(isinstance(v, str) for v in gw) or all(
                    isinstance(v, int) for v in gw):
                ok = gg == gw
            else:
                gg, gw = np.asarray(gg, float), np.asarray(gw, float)
                scale = float(np.nanmax(np.abs(gw))) if \
                    np.isfinite(gw).any() else 0.0
                tol = DIAG_ABS.get(k, DIAG_REL * scale + 1e-12)
                ok = bool(np.all((np.abs(gg - gw) <= tol)
                                 | (np.isnan(gg) & np.isnan(gw))))
        if not ok:
            bad.append(f"{k}: {g} vs JAX's {w}")
    return bad


def diag_call(label, fn, want_launches):
    """fn() with the launches counted; want_launches(result) -> the
    launches the gate expects. Returns (result, counts, gate failures)."""
    t0 = time.perf_counter()
    reset_counts()
    res = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    want = only(want_launches(res))
    phase(label, t0, launches=counts)
    return res, counts, ([] if counts == want
                         else [f"{label}: launches {counts} != {want}"])


def solve_launches(est):
    """The f64 kernel once per LM iteration of every solve of est: those
    adopted, the one dispatched and not yet adopted (a feed that ends
    without `flush`), the initialization solves."""
    solves = est.stats["solves"] + (est._pending is not None)
    return {"lane_cholesky_solve[f64]": ITERS * solves
            + E.INIT_ITERS * est.stats["init_solves"]}


def run_diagnostics(runs):
    """runs: (name, label, fn, want_launches, make_result): each call
    counted (diag_call); after a diagnostic's last call (make_result not
    None) its result made from its calls' results, digested and gated
    (diag_failures). Returns (launches per label, {name: digest, ok and
    seconds of all its calls}, failures)."""
    launches, numbers, failed, outs, secs = {}, {}, [], {}, Counter()
    for name, label, fn, want, make in runs:
        t0 = time.perf_counter()
        res, counts, bad = diag_call(f"diagnostics: {label}", fn, want)
        launches[f"diagnostics: {label}"] = counts
        failed += bad
        outs.setdefault(name, []).append(res)
        if make is not None:
            got = diag_digest(name, make(outs[name]))
            miss = diag_failures(name, got)
            failed += [f"{name}: {m}" for m in miss]
            numbers[name] = dict(digest=got, ok=not miss)
            print(f"[diagnostics: {name}] "
                  f"{'matches' if not miss else 'MISSES'} the JAX "
                  f"package's numbers ({len(got)} keys)"
                  + (f": {miss[:5]}" if miss else ""), flush=True)
        secs[name] += time.perf_counter() - t0
    for name, nums in numbers.items():
        nums["seconds"] = secs[name]
    return launches, numbers, failed


def report_diagnostics(label, t_phase, numbers, **extra):
    """The phase line with each module's seconds; the digests to
    build/chip_smoke/<label>.json."""
    path = BAG_DIR / (label.replace(" ", "_").replace("(", "")
                      .replace(")", "") + ".json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(numbers, indent=1))
    phase(label, t_phase, modules=len(numbers), **extra,
          seconds=json.dumps({k: round(v["seconds"], 3)
                              for k, v in numbers.items()}), digests=path)
    return {k: dict(ok=v["ok"], seconds=v["seconds"])
            for k, v in numbers.items()}


def diagnostics(dev, children):
    """The six diagnostics of the main process, after `measurement
    drivers`, while the children run: diag_simcheck (no device),
    diag_rho (its 30-iteration solve: one f64 launch at (1, 222) an
    iteration, exactly), the EKF pair (DIAG_SIZES), diag_tracker (90
    frames, both trackers) and diag_loop (DIAG_SIZES' stream), each
    through its module's functions on the card, launches counted per call
    and its numbers held to JAX_DIAGNOSTICS. Returns (launches per path,
    numbers)."""
    from cerberus_tpu_torch.evals import (diag_ekf_slip, diag_ekf_slip2,
                                          diag_loop, diag_rho, diag_simcheck,
                                          diag_tracker)
    t_phase = time.perf_counter()
    running = lambda: sum(p.poll() is None for p in children.values())
    print(f"[diagnostics] children still running: {running()}", flush=True)
    none = lambda res: {}
    first = lambda outs: outs[0]
    rho = {}

    def rho_run():
        sim = diag_rho.make_sim()
        res = dict(fd_check=diag_rho.fd_check(sim, dev))
        before = lc.LAUNCHES_BY_SHAPE[(torch.float64, 1, 222)]
        res["window_solve"] = diag_rho.window_solve(sim, dev)
        torch.cuda.synchronize()
        rho.update(at_222=lc.LAUNCHES_BY_SHAPE[(torch.float64, 1, 222)]
                   - before, iters=res["window_solve"]["iters"])
        return res

    ekf = DIAG_SIZES["diag_ekf_slip"]
    ekf2 = DIAG_SIZES["diag_ekf_slip2"]
    loop = DIAG_SIZES["diag_loop"]
    runs = [
        ("diag_simcheck", "diag_simcheck", lambda: diag_simcheck.main([]),
         none, first),
        ("diag_rho", "diag_rho", rho_run,
         lambda res: {"lane_cholesky_solve[f64]":
                      res["window_solve"]["iters"]}, first),
        ("diag_ekf_slip", "diag_ekf_slip", lambda: diag_ekf_slip.run(
            ekf["duration"], dev, ekf["EKF_VARIANTS"]), none, first),
        ("diag_ekf_slip2", "diag_ekf_slip2", lambda: diag_ekf_slip2.run(
            ekf2["duration"], dev, [ekf2["variant"]]), none, first),
        ("diag_tracker", "diag_tracker", lambda: diag_tracker.run(
            max_frames=DIAG_SIZES["diag_tracker"]["max_frames"],
            device=dev), none, first),
        ("diag_loop", "diag_loop", lambda: diag_loop.run(
            loop["duration"], loop["speed"], loop["seed"], loop["path"],
            device=dev), none, first)]
    launches, numbers, failed = run_diagnostics(runs)
    n, iters = rho["at_222"], rho["iters"]
    if not n == iters <= 30:
        failed.append(f"diag_rho: {n} f64 launches at (1, 222) in a solve "
                      f"of {iters} LM iterations (want one an iteration, "
                      f"at most 30)")
    summary = report_diagnostics("diagnostics", t_phase, numbers,
                                 children_still_running=running(),
                                 rho_launches_at_1_222=n)
    if failed:
        raise AssertionError(f"diagnostics gates: {failed}")
    return launches, summary


def diagnostics_streaming(dev):
    """The five streaming diagnostics, in the `estimator branches` child
    after its runs: one feed of diag_vision (vision on, debug on: 20
    frames) analysed by diag_vision, diag_obs and diag_proj (with diag_proj's
    perfect-association window), diag_vision's vision-off feed, diag_ex's
    three variants (DIAG_FRAMES=14) and diag_dropout (3 s); the f64
    kernel once per LM iteration of every solve of each, and the numbers
    held to JAX_DIAGNOSTICS (diag_dropout's up to its first step on a
    placeholder interval). Returns (launches per path, numbers)."""
    from cerberus_tpu_torch.evals import (diag_dropout, diag_ex, diag_obs,
                                          diag_proj, diag_vision)
    t_phase = time.perf_counter()
    vis = DIAG_SIZES["diag_vision"]
    dur, frames = float(vis["DIAG_DUR"]), int(vis["DIAG_FRAMES"])
    ex = DIAG_SIZES["diag_ex"]
    drop = DIAG_SIZES["diag_dropout"]["duration"]
    feeds = {}

    def vision(on):
        def fn():
            feeds[on] = diag_vision.run(vision=on, duration=dur,
                                        max_frames=frames, device=dev)
            return feeds[on]
        return fn

    est_of = lambda res: solve_launches(res[0])

    def vision_result(outs):
        (est, sim, on), (_, _, off) = outs
        (ce, be), (ct, bt) = diag_vision.cost_at_truth(est, sim)
        return dict(vision_on=on, vision_off=off,
                    cost_est=dict(cost=ce, ileg=be[0], proj=be[1],
                                  prior=be[2]),
                    cost_tru=dict(cost=ct, ileg=bt[0], proj=bt[1],
                                  prior=bt[2]))

    def proj_result(outs):
        est, sim, _ = feeds[True]
        return dict(perfect_assoc=outs[0],
                    final_window=diag_proj.final_window(est, sim))

    def obs_result(outs):
        est, sim, _ = feeds[True]
        return diag_obs.check_observations(est, sim, frames_fed=frames)

    def ex_run(est_ex, on):
        def fn():
            if "ex" not in feeds:
                feeds["ex"] = diag_ex.make_sim(float(ex["DIAG_DUR"]))
            return diag_ex.replay_variant(feeds["ex"], est_ex, on,
                                          int(ex["DIAG_FRAMES"]), dev)
        return fn

    def ex_result(outs):
        return {f"ex={a},vision={b}": diag_ex.extrinsic_drift(*o)
                for (a, b), o in zip(diag_ex.VARIANTS, outs)}

    runs = [("diag_vision", "diag_vision on", vision(True), est_of, None),
            ("diag_vision", "diag_vision off", vision(False), est_of,
             vision_result),
            ("diag_obs", "diag_obs", lambda: None, lambda res: {},
             obs_result),
            ("diag_proj", "diag_proj (a)",
             lambda: diag_proj.perfect_assoc(feeds[True][1], device=dev),
             lambda res: {}, proj_result)]
    runs += [("diag_ex", f"diag_ex ex={a} vision={b}", ex_run(a, b),
              est_of, ex_result if (a, b) == diag_ex.VARIANTS[-1] else None)
             for a, b in diag_ex.VARIANTS]
    runs.append(("diag_dropout", "diag_dropout",
                 lambda: diag_dropout.drive(diag_dropout.make_sim(drop), dev),
                 lambda res: {"lane_cholesky_solve[f64]":
                              ITERS * (res[2]["all"] + res[0].stats["solves"])
                              + E.INIT_ITERS * res[0].stats["init_solves"]},
                 lambda outs: diag_dropout.summary(*outs[0], drop)))
    launches, numbers, failed = run_diagnostics(runs)
    summary = report_diagnostics("diagnostics (streaming)", t_phase,
                                 numbers)
    if failed:
        raise AssertionError(f"diagnostics (streaming) gates: {failed}")
    return launches, summary


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
    t_script = time.perf_counter()
    dev, smi = environment()
    build()
    children = {name: start_child(name) for name in CHILDREN}
    try:
        numbers = check_kernels(dev)
        for name, proc in children.items():
            release_child(name, proc)
        launches = main_phases(args, dev, children)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    phase("script", t_script)
    print("kernels: " + " ".join(
        f"{name}={counts[name]} ({path})"
        for name, _ in KERNELS for path, counts in launches.items()))
    main_path = {"lane_cholesky_solve[f32]": "solve_window_batched",
                 "lane_cholesky_solve[f64]": "long run loop",
                 "lane_cholesky_solve[f64] n=382": "solve_window TFT",
                 "cholesky_solve": "solve_window_batched",
                 "lane_cholesky_solve[f32] B=512": "profile_inloop sweep B=512",
                 "lane_cholesky_solve[f32] B=1024":
                     "profile_inloop sweep B=1024",
                 "lane_cholesky_solve[f32] n=382":
                     "profile_solver assembly+chol"}
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


def main_phases(args, dev, children):
    """Every phase after the kernels', then the children's (CHILDREN,
    running meanwhile) collected. Returns the launches per path."""
    launches, batched_s, problem = batched_path(dev)
    option_launches, options = solver_options(problem)
    launches.update(option_launches)
    print("solver options: " + json.dumps(options))
    stream_launches, stream = streaming_path(dev)
    launches.update(stream_launches)
    print("streaming: " + json.dumps(stream))
    sim_a = simulate(SEQ_A)
    tracker_check(dev, sim_a)
    image = ekf_check(dev, sim_a)
    launches["image replay A"], nums = image_replay(dev, sim_a)
    image.update(nums)
    print("image replay: " + json.dumps(image))
    native_sync_check(sim_a)
    launches["bag replay CLI"], bag = bag_replay_cli(bag_to_dataset(sim_a),
                                                     dev)
    print("bag replay CLI: " + json.dumps(bag))
    launches["loop back-end street"], loop, loop_pg = loop_backend(dev)
    print("loop back-end: " + json.dumps(loop))
    launches["fleet"], fleet_nums = fleet(dev)
    print("fleet: " + json.dumps(fleet_nums))
    launches["sfm check"], sfm = sfm_check(dev)
    print("sfm: " + json.dumps(sfm))
    driver_launches, drivers = measurement_drivers(dev, children)
    launches.update(driver_launches)
    print("measurement drivers: " + json.dumps(drivers))
    diag_launches, diag = diagnostics(dev, children)
    launches.update(diag_launches)
    print("diagnostics: " + json.dumps(diag))
    for name, proc in children.items():
        child_launches, nums = finish_child(name, proc)
        launches.update(child_launches)
        print(f"{name}: " + json.dumps(nums))
    if args.profile:
        profile_runs(problem, batched_s, dev)
        profile_pose_graph(loop_pg, loop["optimize_check"]["card_ms"])
    return launches


if __name__ == "__main__":
    main()
