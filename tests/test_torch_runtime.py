"""The port's runtime surface against the JAX package on the CPU: the
reference-style YAML loader (config.load_yaml), the replay command line
(data/replay.py::_main), utils/profiling.py and utils/viz.py.

Inputs: reference-style A1 and Go1 YAML files (the `%YAML:1.0` directive,
`!!opencv-matrix` extrinsics) written into tmp_path; the CLI's synthetic run
`--sim 1.6 --path arc --seed 5 --max-frames 12` with the default
EstimatorConfig cut to max_features = 48, max_num_iterations = 4 in both
packages (its module-level EstimatorConfig swapped for the test).

Tolerances: none. load_yaml's configs are equal field by field; the CLI's
JSON line has the JAX package's keys (`device` in place of `platform`),
equal solve and reboot counts, and numbers equal to the port's own replay
of the same run; draw_tracks' overlay equals the JAX package's pixel for
pixel.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import cerberus_tpu.config as jconfig
from cerberus_tpu.config import load_yaml as jload_yaml
from cerberus_tpu.data.replay import _main as jmain
from cerberus_tpu.utils import viz as jviz
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.config import load_yaml as tload_yaml
from cerberus_tpu_torch.data import replay as treplay_mod
from cerberus_tpu_torch.data.simulator import SimConfig, simulate
from cerberus_tpu_torch.estimator.estimator import Estimator
from cerberus_tpu_torch.utils import profiling, viz
from cerberus_tpu_torch.utils.metrics import MetricsLogger

KW = dict(max_features=48, max_num_iterations=4)

A1_YAML = """%YAML:1.0

#common parameters
imu: 1
num_of_cam: 2
imu_topic: "/hardware_a1/imu"
leg_topic: "/hardware_a1/joint_foot"
image0_topic: "/camera_forward/infra1/image_rect_raw"
image1_topic: "/camera_forward/infra2/image_rect_raw"
output_path: "/home/user/output/"
image_width: 640
image_height: 480
use_leg_odom: 1
optimize_leg_bias: 1
contact_sensor_type: 1
lower_leg_length: 0.21
robot_type: "a1"

estimate_extrinsic: 0
body_T_cam0: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [ 0.0, 0.0, 1.0, 0.2293,
           -1.0, 0.0, 0.0, 0.0325,
           0.0, -1.0, 0.0, 0.0138,
           0., 0., 0., 1. ]
body_T_cam1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [ 0.0, 0.0, 1.0, 0.2293,
           -1.0, 0.0, 0.0, -0.0175,
           0.0, -1.0, 0.0, 0.0138,
           0., 0., 0., 1. ]

max_cnt: 150
min_dist: 20
F_threshold: 1.0
flow_back: 1
max_solver_time: 0.08
max_num_iterations: 8
keyframe_parallax: 10.0

acc_n: 0.4
gyr_n: 0.03
acc_w: 0.001
gyr_w: 0.0001
g_norm: 9.805
joint_angle_n: 0.00001
joint_velocity_n: 0.00001
leg_bias_c_n: 0.000001
leg_bias_nc_n: 0.0001
v_n_min_xy: 0.0001
v_n_max: 1000.0

estimate_td: 1
td: 0.003
"""

GO1_YAML = (A1_YAML.replace('"a1"', '"go1"')
            .replace("contact_sensor_type: 1", "contact_sensor_type: 2")
            .replace("lower_leg_length: 0.21", "lower_leg_length: 0.2165")
            .replace("num_of_cam: 2", "num_of_cam: 1")
            .replace("imu: 1", "imu: 0")
            .replace("v_n_force_thres_ratio", "unused"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("robot,text", [("a1", A1_YAML), ("go1", GO1_YAML)])
def test_load_yaml_matches_jax(tmp_path, robot, text):
    """Every field of the loaded EstimatorConfig (robot model and noise
    included) equals the JAX package's."""
    path = tmp_path / f"{robot}.yaml"
    path.write_text(text)
    t, j = tload_yaml(str(path)), jload_yaml(str(path))
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert td == jd
    assert t.robot.name == robot and t.td == 0.003
    assert t.body_T_cam1[1][3] == -0.0175
    assert t.stereo == (robot == "a1") and t.use_imu == (robot == "a1")
    assert t.robot.lower_leg_length == (0.2165 if robot == "go1" else 0.21)
    print(f"PORT_DIFF load_yaml[{robot}] {len(td)} fields equal (exact)")


ARGV = ["--sim", "1.6", "--path", "arc", "--seed", "5", "--max-frames", "12"]


def test_cli_matches_jax(monkeypatch, capsys, tmp_path):
    """The port's CLI on the CPU prints the JAX CLI's JSON keys (device for
    platform) with equal counts; its numbers are the port's replay of the
    same run, rounded to 5 decimals as the JAX CLI rounds them; the CSV and
    metrics stream it was asked for are written."""
    monkeypatch.setattr(treplay_mod, "EstimatorConfig",
                        lambda: tConfig(**KW))
    csv, metrics = tmp_path / "out.csv", tmp_path / "m.jsonl"
    out = treplay_mod._main(ARGV + ["--device", "cpu", "--csv", str(csv),
                                    "--metrics", str(metrics)])
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    jcls = jconfig.EstimatorConfig
    monkeypatch.setattr(jconfig, "EstimatorConfig", lambda: jcls(**KW))
    monkeypatch.setattr(sys, "argv", ["replay"] + ARGV)
    jmain()
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert set(port) - {"device"} == set(jax_line) - {"platform"}
    assert port["device"] == "cpu" and jax_line["platform"] == "cpu"
    assert (port["solves"], port["reboots"]) == (jax_line["solves"],
                                                 jax_line["reboots"])
    assert port["solves"] >= 1
    for k in ("ate_rmse", "drift_pct", "distance", "final_err"):
        assert abs(port[k] - jax_line[k]) <= 1e-5, k

    sim = simulate(SimConfig(duration=1.6, speed=0.5, path="arc", seed=5))
    ref = treplay_mod.replay(sim, est=Estimator(tConfig(**KW), device="cpu"),
                             max_frames=12)
    np.testing.assert_array_equal(out["est_p"], ref["est_p"])
    for k in ("ate_rmse", "drift_pct", "distance", "final_err"):
        assert out[k] == ref[k] and port[k] == round(ref[k], 5), k
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape == (len(out["est_t"]), 20)
    assert len(metrics.read_text().splitlines()) == port["solves"]
    print(f"PORT_DIFF replay CLI keys {sorted(port)} vs JAX's; numbers equal "
          f"the port's replay (exact)")


def test_cli_refuses_what_it_cannot_run(monkeypatch):
    """No --dataset/--sim, an unknown device, or a dataset without tracks
    and without --images: the CLI stops; with no card it raises for
    --device cuda (the default) instead of falling back."""
    with pytest.raises(SystemExit):
        treplay_mod._main([])
    with pytest.raises(SystemExit):
        treplay_mod._main(ARGV + ["--device", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            treplay_mod._main(ARGV)


def test_profiling_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with torch.profiler.record_function("probe_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert any(e.key == "probe_span" for e in prof.key_averages())
    assert "probe_span" in (tmp_path / "trace" / "trace.json").read_text()


def test_viz_outputs_match_jax(tmp_path):
    """draw_tracks' overlay equals the JAX package's; plot_trajectory and
    plot_metrics write their PNGs (plot_metrics returns None without solve
    records)."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(48, 64)).astype(np.uint8)
    pts = rng.uniform([0, 0], [64, 48], size=(12, 2))
    cnt = rng.integers(1, 30, size=12)
    pred = rng.uniform([0, 0], [64, 48], size=(4, 2))
    np.testing.assert_array_equal(viz.draw_tracks(img, pts, cnt, pred),
                                  jviz.draw_tracks(img, pts, cnt, pred))
    est_p = np.cumsum(rng.normal(size=(20, 3)) * 0.01, axis=0)
    out = viz.plot_trajectory(est_p, est_p + 0.001,
                              str(tmp_path / "traj.png"),
                              extra={"shifted": est_p + 0.01})
    assert (tmp_path / "traj.png").stat().st_size > 1000 and out
    log = MetricsLogger(str(tmp_path / "m.jsonl"))
    for k in range(5):
        log.log("solve", t=0.1 * k, cost0=10.0 - k, cost=5.0 - k,
                solve_ms=100.0 + k)
    log.log("reboot", t=0.25, count=1)
    log.close()
    assert viz.plot_metrics(str(tmp_path / "m.jsonl"),
                            str(tmp_path / "m.png")) == str(tmp_path / "m.png")
    assert (tmp_path / "m.png").stat().st_size > 1000
    empty = MetricsLogger(str(tmp_path / "e.jsonl"))
    empty.close()
    assert viz.plot_metrics(str(tmp_path / "e.jsonl"),
                            str(tmp_path / "e.png")) is None
