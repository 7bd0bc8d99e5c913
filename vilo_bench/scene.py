"""The window problems of a cell's traffic, made from the run's seed.

Following `cerberus_tpu_torch/parallel/fleet.py::build_fleet`, segment s
is simulated with seed `seed + s` on its own path and speed and built into
one window problem. Each is simulated only as long as one window needs
(`sim_duration_s`), with the landmarks scattered along `landmark_span_s` of
path, the scene of the longer simulation `build_fleet` runs. This module
imports neither torch nor the program at its top: a run starts the
simulation's worker processes first, which need NumPy alone, imports
torch and the program while they run, and builds the windows on the card."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

from vilo_bench.frozen import config as C
from vilo_bench.frozen.config import EstimatorConfig, NoiseConfig, RobotModel
from vilo_bench.frozen.simulator import SimConfig, simulate

# the window layout the program is built for; a configuration that states
# another is refused, not run as this one
LAYOUT = {"num_frames": C.NUM_FRAMES, "num_legs": 4,
          "rho_states_per_frame": 4}


def check_layout(cfg: dict):
    for k, v in LAYOUT.items():
        if cfg[k] != v:
            raise ValueError(f"{k} = {cfg[k]}: the program's window has {v}")


def estimator_config(cfg: dict) -> EstimatorConfig:
    """The estimator settings a configuration file states."""
    est = cfg["estimator"]
    tup = lambda m: tuple(tuple(r) for r in m)
    robot = est["robot"]
    return EstimatorConfig(
        robot=RobotModel(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in robot.items() if k != "R_br"},
                         R_br=tup(robot["R_br"])),
        noise=NoiseConfig(**est["noise"]),
        contact_sensor_type=est["contact_sensor_type"],
        g_norm=est["g_norm"],
        image_width=est["image_width"], image_height=est["image_height"],
        body_T_cam0=tup(est["body_T_cam0"]),
        body_T_cam1=tup(est["body_T_cam1"]))


def sim_config(cfg: dict, traffic: dict, seed: int, s: int) -> SimConfig:
    seg = traffic["segments"][s]
    return SimConfig(duration=traffic["sim_duration_s"],
                     imu_rate=cfg["imu_rate_hz"], cam_rate=cfg["cam_rate_hz"],
                     speed=seg["speed"], path=seg["path"], seed=seed + s,
                     n_landmarks=traffic["n_landmarks"],
                     landmark_span=traffic["landmark_span_s"])


def build_windows(cfg: dict, traffic: dict, sims: list, device):
    """The simulated segments built into window problems in float64 on
    `device`: (WindowData, truth WindowState) with a leading segment axis,
    and each window's count of valid feature slots."""
    import torch

    from vilo_bench.frozen import factors as fac
    from vilo_bench.frozen.window_builder import build_window
    est = estimator_config(cfg)
    parts = [build_window(sim, traffic["kf_stride"], seg["start_cam"], est,
                          cfg["max_features"], 1.0 / cfg["imu_rate_hz"],
                          cfg["estimator"]["optimize_leg_bias"], device)
             for sim, seg in zip(sims, traffic["segments"])]
    stack = lambda xs: fac.map_tensors(lambda *ls: torch.stack(ls), *xs)
    return (stack([p[0] for p in parts]), stack([p[1] for p in parts]),
            [p[2] for p in parts])


class Simulation:
    """The traffic's segments, simulated in NumPy by up to `workers`
    spawned processes (0: in this process, when `result` is called).
    `result()` waits for them, stops the workers and returns the
    simulations."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, workers: int = 4):
        check_layout(cfg)
        self.est = estimator_config(cfg)
        self.jobs = [sim_config(cfg, traffic, seed, s)
                     for s in range(len(traffic["segments"]))]
        self.pool = self.futures = None
        if workers:
            self.pool = ProcessPoolExecutor(
                min(workers, len(self.jobs)),
                mp_context=multiprocessing.get_context("spawn"))
            self.futures = [self.pool.submit(simulate, j, self.est)
                            for j in self.jobs]

    def result(self) -> list:
        if self.pool is None:
            return [simulate(j, self.est) for j in self.jobs]
        try:
            return [f.result() for f in self.futures]
        finally:
            self.pool.shutdown(wait=True)

    def close(self):
        """Stop the workers without waiting for their simulations."""
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
