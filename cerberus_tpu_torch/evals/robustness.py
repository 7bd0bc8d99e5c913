"""Adversarial robustness battery (port of the JAX repo's
`evals/robustness.py`): the full VILO estimator under deliberate model
mismatch, scored by drift % and ATE, with reboots counted.

The 12 cases, in the JAX driver's order: the matched baseline; estimator
noise densities x0.25 / x4 against the simulator's; td mis-initialized
+/-20 ms (estimate_td on); camera extrinsic rotation error 1 / 3 deg
(estimate_extrinsic on); IMU sensor-hang dropouts (2 x 1 s frozen
samples); contact-flag corruption bursts; a low-texture world (150
landmarks); a gait and speed outside the tuning set; foot slip x3. Each
replays the street simulation (seed 31) for `--duration` seconds.

`--branches` adds runs of the estimator's swap, restart and recovery
branches, each driven through its normal entry points (`input_imu_leg`,
`input_image`, `change_sensor_type`, via `replay`): `mono_swap` (stereo ->
mono at the midpoint), `imu_off_on` (IMU off at a third, on again at the
midpoint: a restart), `vision_only` (no IMU, no leg odometry), and
`pnp_recovery` (a 0.4 s +/-25 m/s^2 accelerometer fault at the midpoint)
and `reboot` (a 0.05 s gyro spike of 40 rad/s at the midpoint:
failure_detection fires and the estimator restarts with pose continuity).

The estimator runs in f64 on the card unless `--device cpu` is given; with
no card and no `--device cpu` it raises. `--out FILE` writes the results;
without it no file is written. The numbers are not rounded.

    python -m cerberus_tpu_torch.evals.robustness --duration 60 \
        [--cases baseline_matched,td_init_+20ms] [--branches mono_swap] \
        [--out robustness.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.replay import replay, score
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.estimator import Estimator

BRANCHES = ("mono_swap", "imu_off_on", "vision_only", "pnp_recovery",
            "reboot")


def _rot(ax, ang):
    ax = np.asarray(ax, float) / np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def perturb_extrinsics(cfg, deg):
    """Rotate both body_T_cam rotations by `deg` about a fixed skew axis —
    the estimator starts that far from the truth the sim projected with."""
    R_err = _rot([0.41, -0.62, 0.67], np.deg2rad(deg))

    def tw(T):
        T = np.array(T, float)
        T[:3, :3] = T[:3, :3] @ R_err
        return tuple(map(tuple, T))
    return dataclasses.replace(
        cfg, body_T_cam0=tw(cfg.body_T_cam0), body_T_cam1=tw(cfg.body_T_cam1),
        estimate_extrinsic=True)


def scale_noise(cfg, f):
    """Mis-set the estimator's IMU/joint noise densities by factor f while
    the sim keeps generating data at the true densities."""
    n = dataclasses.replace(
        cfg.noise, acc_n=cfg.noise.acc_n * f, acc_n_z=cfg.noise.acc_n_z * f,
        gyr_n=cfg.noise.gyr_n * f, acc_w=cfg.noise.acc_w * f,
        gyr_w=cfg.noise.gyr_w * f, joint_angle_n=cfg.noise.joint_angle_n * f,
        joint_velocity_n=cfg.noise.joint_velocity_n * f)
    return dataclasses.replace(cfg, noise=n)


def imu_dropout(sim, windows):
    """Freeze acc/gyr over the given (t0, t1) windows — a hung IMU driver
    repeating its last sample (worse than missing data: it is confidently
    wrong while the body keeps moving)."""
    sim = dict(sim)
    acc = np.array(sim["acc"])
    gyr = np.array(sim["gyr"])
    t = sim["t"]
    for t0, t1 in windows:
        i = np.where((t >= t0) & (t < t1))[0]
        if len(i):
            acc[i] = acc[i[0]]
            gyr[i] = gyr[i[0]]
    return dict(sim, acc=acc, gyr=gyr)


def corrupt_contacts(sim, rng, n_bursts=10, burst_s=0.3):
    """Invert the contact flags in random bursts (impact transients /
    mis-detected touchdown — the failure mode of contact source 1)."""
    sim = dict(sim)
    contacts = np.array(sim["contacts"])
    t = sim["t"]
    for _ in range(n_bursts):
        t0 = rng.uniform(t[0] + 2.0, t[-1] - burst_s)
        i = np.where((t >= t0) & (t < t0 + burst_s))[0]
        leg = rng.integers(0, 4, size=2)
        contacts[np.ix_(i, leg)] = 1.0 - contacts[np.ix_(i, leg)]
    return dict(sim, contacts=contacts)


def make_cases(dur, base_cfg=None):
    """The 12 cases, in order: dicts of name, cfg, sim_cfg and sim_fn (a
    function of the simulated sequence, or None). contact_corruption draws
    its bursts from one default_rng(77) when its sim_fn runs."""
    base_cfg = base_cfg or EstimatorConfig()
    base_sim_cfg = SimConfig(duration=dur, speed=0.5, path="street", seed=31)

    def case(name, cfg=None, sim_cfg=None, sim_fn=None):
        return dict(name=name, cfg=cfg or base_cfg,
                    sim_cfg=sim_cfg or base_sim_cfg, sim_fn=sim_fn)

    rng = np.random.default_rng(77)
    return [
        case("baseline_matched"),
        case("noise_x0.25", cfg=scale_noise(base_cfg, 0.25)),
        case("noise_x4", cfg=scale_noise(base_cfg, 4.0)),
        case("td_init_+20ms", cfg=dataclasses.replace(
            base_cfg, td=0.020, estimate_td=True)),
        case("td_init_-20ms", cfg=dataclasses.replace(
            base_cfg, td=-0.020, estimate_td=True)),
        case("extrinsic_rot_1deg", cfg=perturb_extrinsics(base_cfg, 1.0)),
        case("extrinsic_rot_3deg", cfg=perturb_extrinsics(base_cfg, 3.0)),
        case("imu_dropout_2x1s", sim_fn=lambda s: imu_dropout(
            s, [(dur * 0.3, dur * 0.3 + 1.0), (dur * 0.7, dur * 0.7 + 1.0)])),
        case("contact_corruption", sim_fn=lambda s: corrupt_contacts(s, rng)),
        case("low_texture_150lm", sim_cfg=dataclasses.replace(
            base_sim_cfg, n_landmarks=150)),
        case("fast_untuned_gait", sim_cfg=dataclasses.replace(
            base_sim_cfg, speed=1.2, gait_freq=3.0)),
        case("slip_x3", sim_cfg=dataclasses.replace(
            base_sim_cfg, foot_slip_sigma=0.012,
            foot_slip_forward_bias=0.0045)),
    ]


def branch_inputs(name, dur, base_cfg=None, sim_config=SimConfig,
                  simulate_fn=simulate):
    """(cfg, sim, switches) of branch run `name` over `dur` seconds:
    switches are (t, use_imu, use_stereo), applied by `drive` before the
    first camera frame at or after t. sim_config, simulate_fn and base_cfg
    may be another package's (its SimConfig, simulate and
    EstimatorConfig()), so that the same runs drive its estimator."""
    cfg = base_cfg if base_cfg is not None else EstimatorConfig()
    half = dur / 2
    if name == "mono_swap":
        return cfg, simulate_fn(sim_config(duration=dur, speed=0.5,
                                           seed=51)), [(half, True, False)]
    if name == "imu_off_on":
        return cfg, simulate_fn(sim_config(duration=dur, speed=0.5,
                                           seed=51)), \
            [(dur / 3, False, True), (half, True, True)]
    if name == "vision_only":
        cfg = dataclasses.replace(cfg, use_imu=False, use_leg_odom=False,
                                  optimize_leg_bias=False,
                                  estimate_extrinsic=False,
                                  estimate_td=False)
        return cfg, simulate_fn(sim_config(duration=dur, speed=0.5,
                                           seed=52)), []
    sim = dict(simulate_fn(sim_config(duration=dur, speed=0.5, seed=43)))
    i0 = int(np.searchsorted(sim["t"], half))   # the fault's first sample
    if name == "pnp_recovery":
        # +/-25 m/s^2 square wave for 200 samples (0.4 s)
        acc = sim["acc"].copy()
        fault = 25.0 * np.sign(np.sin(np.arange(200) * 0.3))
        n = len(acc[i0:i0 + 200])
        acc[i0:i0 + n, 0] += fault[:n]
        acc[i0:i0 + n, 2] -= 0.5 * fault[:n]
        sim["acc"] = acc
        return dataclasses.replace(cfg, pnp_fallback=True), sim, []
    if name == "reboot":
        # 25 samples (0.05 s) of +40 rad/s about z: the dead-reckoned yaw
        # turns 115 deg, more than the solve takes back, and
        # failure_detection's 50 deg check fires
        gyr = sim["gyr"].copy()
        gyr[i0:i0 + 25, 2] += 40.0
        sim["gyr"] = gyr
        return cfg, sim, []
    raise ValueError(f"unknown branch {name!r}; want one of {BRANCHES}")


def drive(est, sim, switches=(), replay_fn=None):
    """replay_fn(sim, est=est) (default: this module's replay) with each
    (t, use_imu, use_stereo) of switches applied through
    est.change_sensor_type before the first camera frame at or after t.
    Returns replay_fn's dict."""
    todo = sorted(switches)
    if todo:
        image = est.input_image

        def input_image(t, feats):
            while todo and t >= todo[0][0]:
                _, use_imu, use_stereo = todo.pop(0)
                est.change_sensor_type(use_imu, use_stereo)
            image(t, feats)

        est.input_image = input_image
    return (replay_fn or replay)(sim, est=est)


def watch(est):
    """Watch est through a run: a dict whose "all" counts its solves
    across restarts (its stats restart at every clear_state) and whose
    "placeholder_at" is the newest sample's time when est first adopted a
    step whose newest interval was a placeholder (the IMU on but interval
    9 neither preintegrated nor folded in the step: a stale IMU, or an
    interval closed with no sample), None if it never did. From such a step
    on, frame 10's speed has no information and the answer is roundoff."""
    seen = {"all": 0, "placeholder_at": None}
    clear, process, finish = (est.clear_state, est._process_image,
                              est._finish_pending)
    marked = []

    def clear_state():
        seen["all"] += est.stats.get("solves", 0)
        clear()

    def process_image(t, feats):
        before = est._pending
        process(t, feats)
        pend = est._pending
        if pend is not None and pend is not before and est.cfg.use_imu \
                and est.preints[9] is None:
            marked.append(pend)

    def finish_pending():
        if est._pending is not None and seen["placeholder_at"] is None \
                and any(est._pending is m for m in marked):
            seen["placeholder_at"] = float(est.sync.latest_time())
        finish()

    est.clear_state, est._process_image, est._finish_pending = \
        clear_state, process_image, finish_pending
    return seen


def before_placeholder(out, t_cut):
    """Frames, drift % and ATE of a replay's (`out`) frames published
    before t_cut."""
    m = np.asarray(out["est_t"]) < t_cut
    got = score(np.asarray(out["est_p"])[m], np.asarray(out["gt_p"])[m])
    return dict(frames=int(m.sum()), drift_pct=float(got["drift_pct"]),
                ate_rmse=float(got["ate_rmse"]))


def run_one(est, sim, switches=(), branch=False, replay_fn=None):
    """One replay of `sim` through `est` (drive); returns (its entry, what
    the estimator counted: frames fed, solves across restarts,
    initialization solves, keyframes, stale IMU intervals, placeholder_at
    (watch) and, if set, the drift % and ATE of the frames published
    before it). A crash is a result: the entry then holds `error`."""
    t0 = time.time()
    cfg = est.cfg
    seen = watch(est)
    extra = {}
    try:
        out = drive(est, sim, switches, replay_fn)
        entry = dict(
            drift_pct=float(out["drift_pct"]),
            ate_rmse=float(out["ate_rmse"]),
            distance=float(out["distance"]),
            reboots=est.stats["reboots"], solves=est.stats["solves"],
            ok=bool(out["drift_pct"] < 1.0),
            wall_s=round(time.time() - t0, 1))
        if cfg.estimate_td:
            entry["td_final_ms"] = float(est.td) * 1e3
        if branch:
            entry.update(
                frames=len(out["est_t"]),
                solver_flag=("NON_LINEAR" if est.solver_flag
                             == est.NON_LINEAR else "INITIAL"),
                use_imu=bool(est.cfg.use_imu), stereo=bool(est.cfg.stereo),
                failure_reasons=[[float(t), r] for t, r in
                                 est.stats.get("failure_reasons", [])])
        if seen["placeholder_at"] is not None:
            extra["before_placeholder"] = before_placeholder(
                out, seen["placeholder_at"])
    except Exception as e:  # a crash is a result, not a harness error
        entry = dict(error=f"{type(e).__name__}: {e}",
                     reboots=est.stats.get("reboots", 0), ok=False,
                     wall_s=round(time.time() - t0, 1))
    counts = dict(frames=len(sim["cam_idx"]),
                  solves_all=seen["all"] + est.stats.get("solves", 0),
                  init_solves=est.stats.get("init_solves", 0),
                  keyframes=est.stats.get("keyframes", 0),
                  stale_imu_intervals=est.stats.get("stale_imu_intervals", 0),
                  placeholder_at=seen["placeholder_at"], **extra)
    return entry, counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--out", default=None,
                    help="write the results to this JSON file")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all 12; "
                         "a name of none, such as `none`: no case)")
    ap.add_argument("--branches", default="",
                    help=f"comma-separated branch runs of {BRANCHES}, "
                         f"after the cases (default: none)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the estimator runs (f64); no fallback when "
                         "the card is missing")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev.type}", flush=True)

    dur = args.duration
    cases = make_cases(dur)
    if args.cases:
        want = set(args.cases.split(","))
        cases = [c for c in cases if c["name"] in want]
    branches = [b for b in args.branches.split(",") if b]
    unknown = set(branches) - set(BRANCHES)
    if unknown:
        raise ValueError(f"unknown branches {sorted(unknown)}")

    counts = {}
    results = {"_meta": dict(
        platform=dev.type, dtype="float64", duration_s=dur,
        note="full VILO (injected ideal features), street sim seed 31; "
             "estimator model deliberately mismatched per case",
        estimator=counts)}

    def run(name, cfg, sim, switches=(), branch=False):
        results[name], counts[name] = run_one(
            Estimator(cfg, device=dev), sim, switches, branch)
        print(f"{name}: {results[name]}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    for c in cases:
        sim = simulate(c["sim_cfg"])
        run(c["name"], c["cfg"],
            sim if c["sim_fn"] is None else c["sim_fn"](sim))
    for b in branches:
        run(b, *branch_inputs(b, dur), branch=True)

    n_ok = sum(1 for k, v in results.items()
               if not k.startswith("_") and v.get("ok"))
    n = sum(1 for k in results if not k.startswith("_"))
    print(f"robustness: {n_ok}/{n} runs < 1% drift"
          + (f" -> {args.out}" if args.out else ""), flush=True)
    return results


if __name__ == "__main__":
    main()
