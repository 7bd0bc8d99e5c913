#!/usr/bin/env python3
"""The JAX package's command-line replay of sequence A's bag on the CPU: the
reference number that chip_smoke.py's `bag replay CLI` gate is set from.

    python3 tools/jax_bag_replay.py

Writes the bag exactly as chip_smoke.py does (`chip_smoke.bag_to_dataset`:
SimConfig(duration=3.0, speed=0.5, seed=5) on the A1 topics, 500 Hz IMU and
joint states, 100 Hz mocap, 640x480 stereo at every camera frame) under
build/jax_bag_replay/, converts it with the JAX package's convert_rosbag as
well and checks that both datasets are equal (imu_leg.csv and mocap.csv
parsed, whose t column the packages format apart; the rest byte for
byte), then runs the JAX package's CLI on its dataset:

    python -m cerberus_tpu.data.replay --dataset DIR --images \\
        --tracker device --max-frames 20 --platform cpu

(the port's CLI defaults to the device tracker; the JAX package's DeviceTracker
is the same algorithm). JAX is forced onto the CPU in f64. Prints the CLI's
JSON line, then one JSON line with the wall time.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import filecmp  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from cerberus_tpu.data.log_adapter import convert_rosbag  # noqa: E402
from cerberus_tpu.data.replay import _main  # noqa: E402
from cerberus_tpu_torch.data.simulator import simulate  # noqa: E402


def main():
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "jax_bag_replay"
    port_ds = chip_smoke.bag_to_dataset(simulate(chip_smoke.SEQ_A), out_dir)
    jax_ds = out_dir / "sequence_a_jax"
    convert_rosbag(str(out_dir / "sequence_a.bag"), str(jax_ds))
    for name in ("meta.json", "imu_leg.csv", "mocap.csv", "cam.csv"):
        if name in ("imu_leg.csv", "mocap.csv"):
            # the port writes their t column "%.9f", the JAX package
            # "%.9g": at this 1000 s epoch both parse to the same stamps
            same = np.array_equal(
                np.loadtxt(port_ds / name, delimiter=","),
                np.loadtxt(jax_ds / name, delimiter=","))
        else:
            same = filecmp.cmp(port_ds / name, jax_ds / name, shallow=False)
        if not same:
            raise SystemExit(f"{name} differs between the packages' "
                             f"convert_rosbag")
    t1 = time.perf_counter()
    sys.argv = ["replay", "--dataset", str(jax_ds), "--images",
                "--tracker", "device", "--max-frames",
                str(chip_smoke.STREAM_FRAMES), "--platform", "cpu"]
    _main()
    assert jax.devices()[0].platform == "cpu"
    print(json.dumps(dict(cli_s=time.perf_counter() - t1,
                          wall_s=time.perf_counter() - t0, x64=True)))


if __name__ == "__main__":
    main()
