#!/usr/bin/env python3
"""The JAX package's image replay of sequence A on the CPU: the reference
numbers that chip_smoke.py's `image replay A` gate is set from.

    python3 tools/jax_image_replay.py

Sequence A (SimConfig(duration=3.0, speed=0.5, seed=5)), 20 camera frames
rendered at 640x480 stereo, the JAX package's DeviceTracker (120 slots,
min_dist 10, 4 levels, 21x21 patches, 10 iterations) and
LeggedEKF(cfg, filter_window=4) as contact source (the default
contact_sensor_type 0), the default EstimatorConfig in f64, the JAX
Estimator built with use_native=False (the port has only the Python sensor
sync), pipeline_frontend=False. Needs JAX (forced onto the CPU, x64) and
prints one JSON line: ate_rmse, drift_pct, solves, reboots, published
NON_LINEAR frames, tracking and render ms per frame and the wall time.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cerberus_tpu.config import EstimatorConfig  # noqa: E402
from cerberus_tpu.data import SimConfig, simulate  # noqa: E402
from cerberus_tpu.data.replay import replay_images  # noqa: E402
from cerberus_tpu.data.simulator import ImageRenderer  # noqa: E402
from cerberus_tpu.estimator.estimator import Estimator  # noqa: E402
from cerberus_tpu.frontend import LeggedEKF  # noqa: E402
from cerberus_tpu.frontend.device_tracker import DeviceTracker  # noqa: E402
from cerberus_tpu.frontend.tracker import PinholeCamera  # noqa: E402


def main():
    assert jax.devices()[0].platform == "cpu"
    t0 = time.perf_counter()
    cfg = EstimatorConfig()
    sim = simulate(SimConfig(duration=3.0, speed=0.5, seed=5))
    r = ImageRenderer(sim, cfg)
    cam = PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
    tracker = DeviceTracker(cam, cam, max_cnt=cfg.max_cnt,
                            min_dist=cfg.min_dist, flow_back=cfg.flow_back)
    est = Estimator(cfg, use_native=False)
    out = replay_images(sim, est=est, tracker=tracker, renderer=r,
                        ekf=LeggedEKF(cfg, filter_window=4), max_frames=20,
                        pipeline_frontend=False)
    st = est.stats
    print(json.dumps(dict(
        ate_rmse=out["ate_rmse"], drift_pct=out["drift_pct"],
        solves=st["solves"], reboots=st["reboots"],
        keyframes=st["keyframes"], published=len(out["est_t"]),
        track_ms_per_frame=out["track_ms_per_frame"],
        render_ms_per_frame=out["render_ms_per_frame"],
        wall_s=time.perf_counter() - t0, platform="cpu", x64=True)))


if __name__ == "__main__":
    main()
