"""The BASELINE.json evaluation configurations, as JSON (port of the JAX
repo's `evals/run_configs.py`):

  1. IMU + leg-kinematics EKF only (slip-realistic and slip-free)
  2. IMU + contact-preintegration window, no vision
  3. Full VILO: stereo + IMU + leg factors
  4. Online kinematic calibration (rho recovery from a 0.215 m calf)
  5. Fleet-scale batched VILO (perturbed windows; on every card present)
  6. The image pipeline with the OpenCV and with the device tracker

Everything runs on the card unless `--device cpu` is given (no fallback
without a card): the estimator and the EKF in f64, the fleet in f32 on the
card and f64 on the CPU. `--out FILE` merges the results into FILE; without
it no file is written.

    python -m cerberus_tpu_torch.evals.run_configs --duration 8 \
        [--configs 1,2,3,4,5,6] [--out results.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.replay import replay, replay_images, score
from cerberus_tpu_torch.data.simulator import (ImageRenderer, SimConfig,
                                               simulate)
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator
from cerberus_tpu_torch.evals.long_run import make_tracker
from cerberus_tpu_torch.frontend.ekf import LeggedEKF


def run_ekf(sim, cfg, dev):
    """The legged EKF alone over the whole sequence; (planar score against
    ground truth, final gyro bias)."""
    ekf = LeggedEKF(cfg, filter_window=4, device=dev)
    ekf.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    ps = []
    for k in range(1, len(sim["t"])):
        ekf.update_filter(sim["t"][k], sim["acc"][k], sim["gyr"][k],
                          sim["phi"][k], dphi=sim["dphi"][k],
                          foot_force=sim["foot_forces"][k])
        ps.append(ekf.get_state()[0:3])
    ps = np.array(ps)
    gt = sim["p"][1:len(ps) + 1] - sim["p"][0]
    # height is ground-referenced in the EKF; compare planar
    return score(ps[:, :2], gt[:, :2]), ekf.state.bg.cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev.type}", flush=True)

    want = set(int(c) for c in args.configs.split(","))
    results = {}
    cfg = EstimatorConfig()

    if 1 in want:
        # EKF-only is proprioceptive dead-reckoning (the reference's kf_lib
        # baseline, main.cpp:174-190): the slip-realistic sim, and the
        # slip-free control that isolates filter correctness
        t0 = time.time()
        m, _ = run_ekf(simulate(SimConfig(duration=args.duration, speed=0.4,
                                          seed=21)), cfg, dev)
        m0, bg0 = run_ekf(simulate(SimConfig(
            duration=args.duration, speed=0.4, seed=21,
            foot_slip_sigma=0.0, foot_slip_forward_bias=0.0)), cfg, dev)
        results["1_ekf_only"] = dict(
            drift_pct=m["drift_pct"], ate_rmse=m["ate_rmse"],
            distance=m["distance"],
            no_slip=dict(drift_pct=m0["drift_pct"], ate_rmse=m0["ate_rmse"],
                         bg_z_est=round(float(bg0[2]), 5)),
            wall_s=round(time.time() - t0, 1))
        print("config 1:", results["1_ekf_only"], flush=True)

    if 2 in want:
        sim = simulate(SimConfig(duration=args.duration, speed=0.5, seed=22))
        est = Estimator(cfg, device=dev)
        sim2 = dict(sim)
        sim2["features"] = [{} for _ in sim["features"]]   # no vision
        t0 = time.time()
        out = replay(sim2, est=est)
        results["2_imu_leg_only"] = dict(drift_pct=out["drift_pct"],
                                         ate_rmse=out["ate_rmse"],
                                         distance=out["distance"],
                                         solves=est.stats["solves"],
                                         wall_s=round(time.time() - t0, 1))
        print("config 2:", results["2_imu_leg_only"], flush=True)

    if 3 in want:
        sim = simulate(SimConfig(duration=args.duration, speed=0.5, seed=23))
        est = Estimator(cfg, device=dev)
        t0 = time.time()
        out = replay(sim, est=est)
        results["3_full_vilo"] = dict(drift_pct=out["drift_pct"],
                                      ate_rmse=out["ate_rmse"],
                                      distance=out["distance"],
                                      solves=est.stats["solves"],
                                      wall_s=round(time.time() - t0, 1))
        print("config 3:", results["3_full_vilo"], flush=True)

    if 4 in want:
        # the true calf length differs from the estimator's nominal 0.21
        true_len = 0.215
        robot = dataclasses.replace(cfg.robot, lower_leg_length=true_len)
        sim = simulate(SimConfig(duration=args.duration, speed=0.5, seed=24),
                       EstimatorConfig(robot=robot))
        est = Estimator(cfg, device=dev)   # starts at 0.21
        t0 = time.time()
        out = replay(sim, est=est)
        rho_final = float(np.mean(est.rho[10]))   # newest frame
        results["4_rho_calibration"] = dict(
            rho_true=true_len, rho_init=0.21, rho_final=round(rho_final, 5),
            rho_err_mm=round(abs(rho_final - true_len) * 1000, 2),
            drift_pct=out["drift_pct"],
            solves=est.stats["solves"], reboots=est.stats["reboots"],
            wall_s=round(time.time() - t0, 1))
        print("config 4:", results["4_rho_calibration"], flush=True)

    if 5 in want:
        from cerberus_tpu_torch.ops.solver import SolveOptions
        from cerberus_tpu_torch.parallel.fleet import build_fleet, solve_fleet
        from cerberus_tpu_torch.parallel.mesh import make_mesh

        on_card = dev.type == "cuda"
        t0 = time.time()
        states, datas, truths = build_fleet(
            n_segments=2, n_perturb=8 if on_card else 4, F=64,
            dtype=torch.float32 if on_card else torch.float64,
            sim_duration=args.duration, device=dev)
        mesh = (make_mesh(device=dev)
                if on_card and torch.cuda.device_count() > 1 else None)
        res = solve_fleet(states, datas, truths, mesh,
                          SolveOptions(max_iters=8))
        results["5_fleet"] = dict(
            batch=int(res.cost.shape[0]),
            median_traj_err=float(np.median(res.traj_err.cpu().numpy())),
            all_converged=bool(torch.all(res.cost < res.cost0)),
            wall_s=round(time.time() - t0, 1))
        print("config 5:", results["5_fleet"], flush=True)

    if 6 in want:
        # the image pipeline end to end, rendered stereo -> KLT front end ->
        # estimator, for both front ends: the device-vs-OpenCV drift delta
        # is the front end's parity signal
        for name in ("cv", "device"):
            sim = simulate(SimConfig(duration=args.duration, speed=0.5,
                                     seed=26))
            est = Estimator(cfg, device=dev)
            renderer = ImageRenderer(sim, cfg)
            tracker = make_tracker(name, renderer, cfg, dev)
            t0 = time.time()
            out = replay_images(sim, est=est, renderer=renderer,
                                tracker=tracker)
            results[f"6_image_vilo_{name}"] = dict(
                drift_pct=out["drift_pct"], ate_rmse=out["ate_rmse"],
                distance=out["distance"], solves=est.stats["solves"],
                reboots=est.stats["reboots"],
                track_ms=round(out["track_ms_per_frame"], 1),
                render_ms=round(out["render_ms_per_frame"], 1),
                wall_s=round(time.time() - t0, 1))
            print(f"config 6 ({name}):", results[f"6_image_vilo_{name}"],
                  flush=True)

    for k, v in results.items():
        v.setdefault("platform", dev.type)
    existing = {}
    if args.out and os.path.exists(args.out):
        try:   # merge: configs can run in separate invocations
            with open(args.out) as f:
                existing = json.load(f)
        except (json.JSONDecodeError, OSError):
            existing = {}
    results["_meta"] = dict(platform=dev.type, dtype="float64",
                            duration_s=args.duration,
                            durations={**existing.get("_meta", {}).get(
                                "durations", {}),
                                **{k: args.duration for k in results}})
    if args.out:
        existing.update(results)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    print(json.dumps({"wrote": args.out, "configs": sorted(results)}))
    return results


if __name__ == "__main__":
    main()
