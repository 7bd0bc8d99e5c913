"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points put tensors on the card unless told
otherwise."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None            # any `import jax` now raises
    sys.modules["cerberus_tpu"] = None   # so does the JAX package
    import importlib, pkgutil
    import torch
    import cerberus_tpu_torch
    for m in pkgutil.walk_packages(cerberus_tpu_torch.__path__,
                                   "cerberus_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.ops import factors as fac
    from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window_batched
    sim = simulate(SimConfig(duration=2.0, speed=0.5, seed=3, n_landmarks=80))
    data, truth, Fa = build_window_from_sim(sim, kf_stride=1, start_cam=2,
                                            F=8, device="cpu")
    B = 2
    states = fac.map_tensors(lambda x: torch.stack([x] * B), truth)
    states = states._replace(p=states.p + 0.01 * torch.arange(B)[:, None, None])
    datas = fac.map_tensors(lambda x: x.expand((B,) + x.shape), data)
    st, info = solve_window_batched(states, datas, SolveOptions(max_iters=1))
    assert torch.isfinite(info.cost).all() and (info.cost <= info.cost0).all()
    from cerberus_tpu_torch.data.replay import replay
    from cerberus_tpu_torch.estimator.estimator import Estimator
    from cerberus_tpu_torch.ops.cholesky_solve import cholesky_solve
    out = replay(sim, max_frames=2, device="cpu")
    assert out["estimator"].frame_count == 2
    assert out["estimator"].solver_flag == Estimator.INITIAL
    H = torch.eye(3, dtype=torch.float64)[None] * 2.0
    x = cholesky_solve(H, torch.ones((1, 3), dtype=torch.float64), 0.0)
    assert torch.allclose(x, torch.full((1, 3), -0.5, dtype=torch.float64))
    import dataclasses
    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.data.replay import replay_images
    from cerberus_tpu_torch.data.simulator import ImageRenderer
    from cerberus_tpu_torch.frontend import LeggedEKF
    from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
    from cerberus_tpu_torch.frontend.tracker import PinholeCamera
    short = simulate(SimConfig(duration=0.3, speed=0.5, seed=5))
    cfg = dataclasses.replace(EstimatorConfig(), image_width=160,
                              image_height=120, max_features=16,
                              max_num_iterations=1)
    cam = PinholeCamera(115.0, 115.0, 80.0, 60.0, size=(160, 120))
    out = replay_images(
        short, cfg=cfg, renderer=ImageRenderer(short, cfg, focal=115.0),
        tracker=DeviceTracker(cam, cam, max_cnt=16, min_dist=8, device="cpu"),
        ekf=LeggedEKF(cfg, filter_window=4, device="cpu"), max_frames=2,
        device="cpu")
    assert out["tracker"].stats["frames"] == 2
    assert out["estimator"].frame_count == 2
    import numpy as np
    from cerberus_tpu_torch.estimator import initial_sfm
    from cerberus_tpu_torch.loop import PoseGraph
    from cerberus_tpu_torch.loop.closer import LoopCloser
    from cerberus_tpu_torch.parallel import make_mesh, pooled_calibration_step
    from cerberus_tpu_torch.parallel.fleet import build_fleet, solve_fleet
    pg = PoseGraph(min_overlap=5, min_gap=8, capacity_nodes=8, device="cpu")
    for k in range(12):
        pg.add_keyframe(np.array([0.5 * k, 0.0, 0.0]), 0.0,
                        range(100, 130) if k in (0, 11) else ())
    pg.optimize(iters=2)
    assert pg.n_loop_edges == 1 and pg.stats["optimizes"] >= 1
    assert LoopCloser(device="cpu").pg.device == torch.device("cpu")
    turns = np.array([[0.9, 0.3, 0.1, 0.0], [0.9, 0.0, 0.3, 0.2],
                      [0.9, 0.2, 0.0, 0.3]])
    turns /= np.linalg.norm(turns, axis=1, keepdims=True)
    q, ok = initial_sfm.calibrate_ex_rotation(turns, turns, np.ones(3, bool),
                                              device="cpu")
    assert torch.allclose(q, torch.tensor([1.0, 0, 0, 0], dtype=q.dtype))
    states, datas, truths = build_fleet(n_segments=1, n_perturb=2, F=8,
                                        sim_duration=2.0, device="cpu")
    res = solve_fleet(states, datas, truths, make_mesh(2, device="cpu"),
                      SolveOptions(max_iters=1))
    assert torch.isfinite(res.cost).all()
    new, dx, H, b = pooled_calibration_step(states, datas)
    assert torch.isfinite(dx).all()
    import os, tempfile
    from cerberus_tpu_torch import native
    from cerberus_tpu_torch.data import replay as replay_mod
    from cerberus_tpu_torch.data.log_adapter import (A1_TOPICS,
                                                     convert_rosbag)
    from cerberus_tpu_torch.data.rosbag import (BagWriter, ImuMsg,
                                                JointStateMsg)
    from cerberus_tpu_torch.ops.preintegration import (PreintParams,
                                                       imu_preintegrate)
    from cerberus_tpu_torch.utils.checkpoint import (load_estimator,
                                                     save_estimator)
    from cerberus_tpu_torch.utils.metrics import MetricsLogger, read_metrics
    tmp = tempfile.mkdtemp()
    est = out["estimator"]
    assert isinstance(est.sync, native.SensorSync)
    save_estimator(est, os.path.join(tmp, "est.npz"))
    back = load_estimator(Estimator(est.cfg, device="cpu"),
                          os.path.join(tmp, "est.npz"))
    assert back.frame_count == est.frame_count
    bag = os.path.join(tmp, "a1.bag")
    with BagWriter(bag) as w:
        for k in range(300):
            t = 1000.0 + 0.002 * k
            w.write(A1_TOPICS["imu"], ImuMsg(stamp=t, acc=np.array([0, 0, 9.8]),
                                             gyr=np.zeros(3)))
            w.write(A1_TOPICS["leg"], JointStateMsg(
                stamp=t, position=np.zeros(16), velocity=np.zeros(16),
                effort=np.zeros(16)))
    ds = convert_rosbag(bag, os.path.join(tmp, "ds"))
    assert len(ds["t"]) == 300
    log = MetricsLogger(os.path.join(tmp, "m.jsonl"))
    log.log("solve", t=0.0, cost=1.0)
    log.close()
    assert read_metrics(os.path.join(tmp, "m.jsonl"))[0]["kind"] == "solve"
    cli = replay_mod._main(["--sim", "0.4", "--path", "arc", "--device",
                            "cpu", "--max-frames", "2"])
    assert cli["estimator"].frame_count == 2
    params = PreintParams.from_config(EstimatorConfig(), device="cpu")
    z = torch.zeros((4, 3), dtype=torch.float64)
    pre = imu_preintegrate(torch.full((4,), 0.002, dtype=torch.float64), z,
                           z, torch.tensor([False, True, True, True]),
                           z[0], z[0], params)
    assert float(pre.sum_dt) == 0.006
    from cerberus_tpu_torch.evals import robustness
    res = robustness.main(["--device", "cpu", "--cases", "td_init_+20ms",
                           "--branches", "mono_swap", "--duration", "0.4"])
    assert res["_meta"]["platform"] == "cpu"
    assert set(res) == {"_meta", "td_init_+20ms", "mono_swap"}
    assert not any("error" in v for k, v in res.items() if k != "_meta")
    from cerberus_tpu_torch.evals import (bench_klt, measure,
                                          multichip_scaling, profile_batched,
                                          profile_inloop, profile_solver,
                                          profile_streaming)
    torch.set_num_threads(1)   # the drivers' pieces: many small ops
    sts, dts = measure.make_batch((data, truth), 2)
    for variant in profile_inloop.VARIANTS:
        assert torch.isfinite(profile_inloop.make_solver(variant, 1)(sts, dts))
    *pieces, cost = profile_batched.assemble_once(sts, dts)
    dx = profile_batched.schur_once(*pieces, torch.full((2,), 1e-4,
                                                        dtype=torch.float64))
    assert torch.isfinite(profile_batched.scalar_of(
        profile_batched.retract_once(sts, dx)))
    for name, fn in dict(profile_solver.PROGRAMS,
                         dense1=profile_solver.dense1).items():
        if name != "solve12":
            assert torch.isfinite(fn(sts, dts)).all(), name
    dev = torch.device("cpu")
    P = profile_streaming.preint(PreintParams.from_config(
        EstimatorConfig(), device="cpu"))(*profile_streaming.preint_inputs(
            dev, torch.float64, S=8))
    assert torch.isfinite(P).all()
    st1 = truth._replace(p=truth.p + 0.02)
    for fn in (profile_streaming.assembly, profile_streaming.solve(1),
               profile_streaming.marg_old):
        assert torch.isfinite(fn(st1, data)).all()
    res = bench_klt.track_batch(*bench_klt.make_inputs(2, dev, H=64, W=96,
                                                       N=8), levels=2)
    assert res.pts.shape == (2, 8, 2) and bool(res.status.any())
    st2 = multichip_scaling.solve_on_mesh(sts, dts, make_mesh(2, device="cpu"),
                                          SolveOptions(max_iters=1))
    assert torch.isfinite(st2.p).all()
    from cerberus_tpu_torch.evals import diag_ekf_slip, diag_rho
    assert diag_ekf_slip.main(["0.01", "--device", "cpu"])["samples"] == 5
    fd = diag_rho.fd_check(simulate(SimConfig(duration=0.5, seed=24)), "cpu")
    assert np.isfinite(fd["J_col"]).all() and np.isfinite(fd["fd"]).all()
    assert not any(name == "jax" or name.startswith(("jax.", "jaxlib"))
                   or name.startswith("cerberus_tpu.")
                   for name, mod in sys.modules.items() if mod is not None)
    print("NO_JAX_OK", Fa)
""")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout


def test_chip_smoke_fails_without_cuda():
    """Without a card the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_default_to_cuda():
    """Without device=, an entry point that makes tensors asks for the card
    and raises when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cerberus_tpu_torch import convert
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.device import resolve_device
    from cerberus_tpu_torch.ops import factors as fac

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_window_from_sim({"cam_idx": np.arange(40)})
    st = fac.WindowState.zero(4, device="cpu")
    st_np, _ = convert.window_to_numpy(st, st)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.window_from_numpy(st_np, None)
    from cerberus_tpu_torch.data.replay import replay
    from cerberus_tpu_torch.estimator.estimator import Estimator
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator()
    with pytest.raises(RuntimeError, match="CUDA"):
        replay({"t": np.zeros(1)})
    assert resolve_device("cpu") == torch.device("cpu")


def test_loop_sfm_parallel_entry_points_default_to_cuda():
    """The loop back-end's, the initial SfM's and the parallel modules'
    entry points ask for the card too: without device= each raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cerberus_tpu_torch.estimator import initial_alignment as al
    from cerberus_tpu_torch.estimator import initial_sfm as sfm
    from cerberus_tpu_torch.loop import PoseGraph, optimize_pose_graph
    from cerberus_tpu_torch.loop.closer import LoopCloser
    from cerberus_tpu_torch.parallel import make_mesh
    from cerberus_tpu_torch.parallel.fleet import build_fleet

    z3, z = np.zeros((2, 3)), np.zeros(2)
    q = np.tile([1.0, 0, 0, 0], (2, 1))
    for make in (PoseGraph, LoopCloser, build_fleet, make_mesh,
                 lambda: optimize_pose_graph(z3, z, [0], [1], z3[:1], z[:1],
                                             z[:1], [True]),
                 lambda: sfm.relative_pose_ransac(z3[:, :2], z3[:, :2],
                                                  [True, True]),
                 lambda: sfm.calibrate_ex_rotation(q, q, [True, True]),
                 lambda: sfm.global_sfm(0, q[0], z3[0], np.zeros((4, 2, 2)),
                                        np.ones((4, 2), bool)),
                 lambda: sfm.visual_imu_alignment(z3, q, z3[:1], z3[:1],
                                                  z[:1], z3[0], np.eye(3),
                                                  9.8),
                 lambda: al.solve_gyroscope_bias(q, []),
                 lambda: al.solve_gyro_leg_bias(q, z3, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_runtime_entry_points_default_to_cuda():
    """The replay command line and init_distributed ask for the card too:
    without --device / device= each raises where there is none, and the
    native sync has no device to ask for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cerberus_tpu_torch.data.replay import _main
    from cerberus_tpu_torch.parallel.mesh import init_distributed

    for make in (lambda: _main(["--sim", "0.4", "--max-frames", "1"]),
                 lambda: init_distributed("localhost:1", 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_image_entry_points_default_to_cuda():
    """The image pipeline's entry points ask for the card too: the EKF, the
    device tracker and replay_images raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cerberus_tpu_torch.data.replay import replay_images
    from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
    from cerberus_tpu_torch.frontend.ekf import EKFParams, LeggedEKF
    from cerberus_tpu_torch.frontend.tracker import PinholeCamera
    from cerberus_tpu_torch.config import EstimatorConfig

    cam = PinholeCamera(460.0, 460.0, 320.0, 240.0)
    for make in (LeggedEKF, lambda: DeviceTracker(cam, cam),
                 lambda: EKFParams.from_config(EstimatorConfig()),
                 lambda: replay_images({"t": np.zeros(1)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


DIAGNOSTICS = ("diag_dropout", "diag_ekf_slip", "diag_ekf_slip2", "diag_ex",
               "diag_loop", "diag_obs", "diag_proj", "diag_rho",
               "diag_tracker", "diag_vision")


def test_diag_entry_points_default_to_cuda():
    """The diagnostics ask for the card too: without --device cpu each
    `main` raises where there is none, before any work; diag_simcheck,
    which touches no device, has no --device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    for name in DIAGNOSTICS:
        mod = importlib.import_module(f"cerberus_tpu_torch.evals.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    from cerberus_tpu_torch.evals import diag_simcheck
    with pytest.raises(SystemExit):
        diag_simcheck.main(["--device", "cpu"])
