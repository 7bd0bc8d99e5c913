"""The port on the card, what chip_smoke.py does not check: the kernels'
wrappers refuse what the kernels do not take; neither the LM loop, the
streaming estimator's per-frame step, the tracker's frame program nor the
EKF step ever waits for the device; the tracker's and the EKF's fetches
wait for their own streams only; the device tracker runs without OpenCV;
the pose graph's Gauss-Newton queues without a wait and agrees with the
CPU at 512 and 1024 nodes; the fleet solve reaches the lane kernel.
(chip_smoke.py holds the kernels to their plain versions and the card's
solve, replays, tracker and EKF to the CPU's.) Every test here but the last
needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is missing (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cerberus_tpu_torch.ops import cholesky_solve as cs
from cerberus_tpu_torch.ops import lane_cholesky as lc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(seed, B, n, device):
    """SPD systems as tests/test_lane_cholesky.py makes them, f32."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, n + 5, n)).astype(np.float32)
    A = np.einsum("bij,bik->bjk", J, J) + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    return torch.as_tensor(A, device=device), torch.as_tensor(b, device=device)


def test_kernel_rejects_what_it_does_not_take(cuda):
    A, b = _spd(3, 2, 8, cuda)
    with pytest.raises(TypeError):
        lc.lane_cholesky_solve(A.half(), b.half())
    with pytest.raises(TypeError):
        lc.lane_cholesky_solve(A.double(), b)       # mixed dtypes
    with pytest.raises(ValueError):
        lc.lane_cholesky_solve(A.transpose(1, 2), b)
    with pytest.raises(ValueError):
        lc.lane_cholesky_solve(A, b[:, :5])
    x = lc.lane_cholesky_solve(                     # the largest f64 n
        torch.eye(238, dtype=torch.float64, device=cuda)[None],
        torch.ones((1, 238), dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones_like(x))


def _rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n,dtype", [(241, torch.float32),
                                     (239, torch.float64)])
def test_kernel_solves_above_the_old_limits(cuda, n, dtype):
    """The first n the column kernel refused (its factor or packed triangle
    over 227 KB) now solves: f32 n = 241 resident in tiles, f64 n = 239
    streamed from the workspace. Gates: f32 2e-3, f64 1e-10 relative."""
    A, b = _spd(5, 2, n, cuda)
    A, b = A.to(dtype), b.to(dtype)
    err = _rel_err(lc.lane_cholesky_solve(A, b),
                   lc.lane_cholesky_solve_plain(A, b))
    assert err < (2e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 16, 31, 33, 37, 222, 238, 240, 321])
@pytest.mark.parametrize("B", [1, 2, 130])
def test_kernel_matches_plain(cuda, dtype, n, B):
    """Tile-aligned and ragged n, resident and streamed tiles, against the
    plain version (f32 2e-3, f64 1e-10 relative)."""
    A, b = _spd(100 * n + B, B, n, cuda)
    A, b = A.to(dtype), b.to(dtype)
    err = _rel_err(lc.lane_cholesky_solve(A, b),
                   lc.lane_cholesky_solve_plain(A, b))
    assert err < (2e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [37, 222, 238])
def test_kernel_not_spd_gives_nan_alone(cuda, dtype, n):
    """A system that is not SPD gives NaN in its x, as the plain version and
    LAPACK do; the other systems of the batch are solved as alone."""
    A, b = _spd(7 * n, 3, n, cuda)
    A, b = A.to(dtype), b.to(dtype)
    A[1, n // 2, n // 2] = -1.0
    x = lc.lane_cholesky_solve(A, b)
    xp = lc.lane_cholesky_solve_plain(A, b)
    assert torch.isnan(x[1]).any() and torch.isnan(xp[1]).any()
    keep = [0, 2]
    assert _rel_err(x[keep], xp[keep]) < (2e-3 if dtype == torch.float32
                                          else 1e-10)


@pytest.mark.parametrize("B,n", [(3, 383), (3, 385), (1, 1800)])
def test_cholesky_solve_streamed_matches_plain(cuda, B, n):
    """The damped kernel with its tiles streamed from the workspace: the
    panel in shared memory (n = 383, 385), and in global memory too
    (n = 1800); SPD systems as tests/test_pallas_kernels.py makes them."""
    rng = np.random.default_rng(n)
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", M, M) + n * np.eye(n, dtype=np.float32)
    H = torch.as_tensor(H, device=cuda)
    b = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                        device=cuda)
    lam = torch.as_tensor(np.geomspace(1e-3, 1e-1, B).astype(np.float32),
                          device=cuda)
    err = _rel_err(cs.cholesky_solve(H, b, lam),
                   cs.cholesky_solve_plain(H, b, lam))
    assert err < 2e-3


def test_cholesky_solve_rejects_what_it_does_not_take(cuda):
    A, b = _spd(4, 2, 8, cuda)
    with pytest.raises(TypeError):
        cs.cholesky_solve(A.half(), b.half(), 1e-4)
    with pytest.raises(TypeError):
        cs.cholesky_solve(A.double(), b, 1e-4)     # mixed dtypes
    with pytest.raises(TypeError):
        cs.cholesky_solve(A.double(), b.double(), 1e-4)   # f32 only
    with pytest.raises(ValueError):
        cs.cholesky_solve(A.transpose(1, 2), b, 1e-4)
    with pytest.raises(ValueError):
        cs.cholesky_solve(A, b[:, :5], 1e-4)
    with pytest.raises(ValueError):
        cs.cholesky_solve(A, b, torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        cs.cholesky_solve(A, b.cpu(), 1e-4)


@pytest.fixture
def small_batch(cuda):
    """A small window (F = 24), 3 perturbed windows, f32 on the card."""
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.ops import factors as fac

    sim = simulate(SimConfig(duration=4.0, speed=0.5, seed=3, n_landmarks=200))
    data, truth, _ = build_window_from_sim(sim, kf_stride=2, start_cam=2,
                                           F=24, device=cuda,
                                           dtype=torch.float32)
    B = 3
    rng = np.random.default_rng(0)
    states = fac.map_tensors(lambda x: torch.stack([x] * B), truth)
    states = states._replace(p=states.p + torch.as_tensor(
        rng.normal(size=(B, 11, 3)) * 0.02, dtype=torch.float32, device=cuda))
    datas = fac.map_tensors(lambda x: x.expand((B,) + x.shape), data)
    return states, datas


def test_lm_loop_never_waits_for_the_device(small_batch):
    """No operation of a solve reads back from or waits for the card: CUDA's
    sync debug mode raises on any that does. (A first call has made the
    placement matrices, which are copied to the card once.)"""
    from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window_batched

    states, datas = small_batch
    opts = SolveOptions(max_iters=2)
    solve_window_batched(states, datas, opts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solve_window_batched(states, datas, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_streaming_step_never_waits_for_the_device(cuda):
    """One per-frame step of the streaming estimator (preintegration fold,
    window build, LM solve, reprojection gate, QR marginalization, prior
    shift, splice re-preintegration) under CUDA's sync debug mode, in both
    marginalization modes, with its inputs already on the card. (A first
    call per mode has made the per-device constants.)"""
    import dataclasses

    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.data.replay import replay
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.estimator import estimator as E

    rec = {}
    step = E._streaming_step

    def spy(*args, **kw):
        if "args" not in rec:
            est = rec["est"]
            rec["args"] = args
            rec["raw8"] = est._dev_raw(est._pad_buffer(
                E._merge_buffers(est.buffers[8], est.buffers[9])))
        return step(*args, **kw)

    cfg = dataclasses.replace(EstimatorConfig(), max_features=32,
                              max_num_iterations=2)
    rec["est"] = est = E.Estimator(cfg, device=cuda)
    E._streaming_step = spy
    try:
        replay(simulate(SimConfig(duration=1.6, speed=0.5, seed=5)), est=est,
               max_frames=12)
    finally:
        E._streaming_step = step
    args = list(rec["args"])
    for mode in ("old", "new"):
        args[9] = rec["raw8"] if mode == "new" else None   # the splice
        kw = dict(max_iters=2, mode=mode, use_leg_odom=True,
                  marg_td_info=False)
        E._streaming_step(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = E._streaming_step(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.isfinite(out["st"].p).all()
        assert torch.isfinite(out["prior"][0]).all()


def _frames(n, W=160, H=120):
    """n stereo pairs (uint8) of sequence A at W x H, from the port's
    renderer (NumPy only)."""
    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.data.simulator import (ImageRenderer, SimConfig,
                                                   simulate)

    sim = simulate(SimConfig(duration=1.0, speed=0.5, seed=5))
    r = ImageRenderer(sim, EstimatorConfig(image_width=W, image_height=H),
                      focal=460.0 * W / 640)
    return [r.render_stereo(int(k)) for k in sim["cam_idx"][:n]], r


def test_track_frame_never_waits_for_the_device(cuda):
    """_first_frame and track_frame on the card under CUDA's sync debug
    mode: the tracker's frame program never reads back (its one fetch is
    the caller's)."""
    from cerberus_tpu_torch.frontend.device_tracker import _first_frame
    from cerberus_tpu_torch.ops import klt

    frames, _ = _frames(2)
    # the uploads (from pageable host memory) are the caller's, before
    (a0, b0), (a1, b1) = [[torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                           for a in pair] for pair in frames]
    N = 40
    args = dict(levels=4, half=10, iters=10, min_dist=8, fb_thresh=0.5,
                stereo=True)
    prio = torch.arange(N, dtype=torch.int32, device=cuda) % 3

    def both():
        first = _first_frame(a0, b0, max_new=N, **args)
        pts = first["det_pts"]
        return klt.track_frame(first["pyr0"], a1, b1, pts, first["det_ok"],
                               pts, prio, det_stereo=16, **args)

    both()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = both()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(out["keep"].sum()) > 5


def test_ekf_step_never_waits_for_the_device(cuda):
    """One ekf_step with its inputs on the card under CUDA's sync debug
    mode (a first call has run the same step)."""
    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.frontend import ekf

    params = ekf.EKFParams.from_config(EstimatorConfig(), device=cuda)
    f64 = lambda *v: torch.tensor(v, dtype=torch.float64, device=cuda)
    phi = f64(*([0.0, 0.8, -1.6] * 4))
    s = ekf.ekf_init(f64(0.0, 0.0, 0.3), f64(1.0, 0.0, 0.0, 0.0), phi, params)
    x = (f64(0.002), f64(0.1, 0.0, 9.8), f64(0.0, 0.01, 0.0), phi,
         f64(*([0.1] * 12)), f64(80.0, 5.0, 90.0, 3.0))
    ekf.ekf_step(s, *x, params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ekf.ekf_step(s, *x, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out.P).all() and torch.isfinite(out.p).all()


def _busy_default_stream(seconds):
    """Queue a kernel that spins for about `seconds` on the default stream;
    returns an event recorded after it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    end.synchronize()
    cycles_per_s = 10 ** 6 / (start.elapsed_time(end) / 1e3)
    torch.cuda._sleep(int(seconds * cycles_per_s))
    done = torch.cuda.Event()
    done.record()
    return done


def test_fetches_do_not_wait_for_other_streams(cuda):
    """The tracker's per-frame fetch and the EKF's per-sample fetch wait
    for their own streams only: with the default stream busy for 3 s (the
    estimator's step in a replay), a frame is tracked and 20 EKF samples
    are filtered and read before that work ends."""
    import time

    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
    from cerberus_tpu_torch.frontend.ekf import LeggedEKF
    from cerberus_tpu_torch.frontend.tracker import PinholeCamera

    frames, r = _frames(3)
    cam = PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
    tracker = DeviceTracker(cam, cam, max_cnt=40, min_dist=8, device=cuda)
    tracker.track(0.0, *frames[0])
    tracker.track(1 / 15, *frames[1])
    kf = LeggedEKF(EstimatorConfig(), filter_window=4, device=cuda)
    phi = np.array([0.0, 0.8, -1.6] * 4)
    acc, gyr = np.array([0.1, 0.0, 9.8]), np.zeros(3)
    kf.init_filter(0.0, acc, gyr, phi)
    kf.update_filter(0.002, acc, gyr, phi, foot_force=np.full(4, 80.0))
    kf.get_contacts()
    torch.cuda.synchronize()
    busy = _busy_default_stream(3.0)
    t0 = time.perf_counter()
    feats = tracker.track(2 / 15, *frames[2])
    for i in range(20):
        kf.update_filter(0.004 + 0.002 * i, acc, gyr, phi,
                         foot_force=np.full(4, 80.0))
        contacts = kf.get_contacts()
    elapsed = time.perf_counter() - t0
    still_busy = not busy.query()
    torch.cuda.synchronize()
    assert still_busy, f"the default stream finished first ({elapsed:.3f} s)"
    assert len(feats) > 5 and contacts.shape == (4,)


def _pose_graph_inputs(N, n_loops=40, seed=0):
    """A drifting chain of N - 8 nodes on a circle, padded to N nodes and
    2048 edges as PoseGraph pads them, with n_loops noisy loop edges under
    the robust loss. Returns numpy arrays."""
    from cerberus_tpu_torch.loop.posegraph import PoseGraph

    rng = np.random.default_rng(seed)
    pg = PoseGraph(capacity_nodes=N, auto_detect=False, device="cpu")
    n = N - 8
    ang = np.linspace(0, 4 * np.pi, n)
    for k in range(n):
        pg.add_keyframe(np.array([10 * np.cos(ang[k]), 10 * np.sin(ang[k]),
                                  0.0]) + rng.normal(size=3) * 0.05 * k / n,
                        ang[k] + np.pi / 2 + rng.normal() * 0.01)
    for _ in range(n_loops):
        i = int(rng.integers(0, n // 2))
        j = i + n // 2
        pg.add_loop_edge(i, j, rel_p=rng.normal(size=3) * 0.1,
                         rel_yaw=float(rng.normal() * 0.05), weight=10.0)
    return (pg.p, pg.yaw) + pg.padded_edges()


def test_optimize_pose_graph_never_waits_for_the_device(cuda):
    """The pose graph's Gauss-Newton iterations queue on the card with no
    read-back or wait until the caller's one fetch."""
    from cerberus_tpu_torch.loop.posegraph import optimize_pose_graph

    args = [torch.as_tensor(a, device=cuda) for a in _pose_graph_inputs(512)]
    optimize_pose_graph(*args, iters=2, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, yaw = optimize_pose_graph(*args, iters=4, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = torch.cat([p, yaw[:, None]], 1).cpu()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("N", [512, 1024])
def test_optimize_pose_graph_card_matches_cpu(cuda, N):
    """The same call on the card and on the CPU: 1e-9 relative (f64)."""
    from cerberus_tpu_torch.loop.posegraph import optimize_pose_graph

    args = _pose_graph_inputs(N)
    kw = dict(iters=8, robust_kind="cauchy")
    pc, yc = optimize_pose_graph(*args, **kw, device=cuda)
    ph, yh = optimize_pose_graph(*args, **kw, device="cpu")
    for a, b in ((pc, ph), (yc, yh)):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) < 1e-9
    assert float((ph - torch.as_tensor(args[0])).abs().max()) > 1e-3


def test_solve_fleet_reaches_the_lane_kernel(cuda):
    """solve_fleet on the card launches the f32 lane-Cholesky kernel once
    per LM iteration for the whole batch, never its plain version."""
    from cerberus_tpu_torch.ops.solver import SolveOptions
    from cerberus_tpu_torch.parallel.fleet import build_fleet, solve_fleet

    states, datas, truths = build_fleet(n_segments=1, n_perturb=3, F=16,
                                        sim_duration=4.0, device=cuda)
    plain = lc.lane_cholesky_solve_plain
    lc.lane_cholesky_solve_plain = None      # any call would raise
    before = lc.LAUNCHES_BY_DTYPE[torch.float32]
    try:
        res = solve_fleet(states, datas, truths, None,
                          SolveOptions(max_iters=3))
    finally:
        lc.lane_cholesky_solve_plain = plain
    torch.cuda.synchronize()
    assert lc.LAUNCHES_BY_DTYPE[torch.float32] - before == 3
    assert torch.isfinite(res.cost).all() and (res.cost <= res.cost0).all()


def test_device_tracker_without_opencv(cuda, monkeypatch):
    """With cv2 unimportable the device tracker runs on the card (its
    PinholeCamera undistorts in NumPy), while the OpenCV tracker refuses
    to be made."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker
    from cerberus_tpu_torch.frontend.tracker import (FeatureTracker,
                                                     PinholeCamera)

    frames, r = _frames(3)
    cam = PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
    tracker = DeviceTracker(cam, cam, max_cnt=40, min_dist=8, device=cuda)
    feats = [tracker.track(k / 15, *f) for k, f in enumerate(frames)]
    assert len(set(feats[0]) & set(feats[2])) > 5
    with pytest.raises(ImportError, match="OpenCV"):
        FeatureTracker(cam, cam)


def test_pinhole_camera_without_opencv(monkeypatch):
    """PinholeCamera needs no OpenCV; the OpenCV-only parts raise a clear
    ImportError and never switch to another tracker. Runs on the CPU too."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    from cerberus_tpu_torch.frontend.tracker import (FeatureTracker,
                                                     FisheyeCamera,
                                                     PinholeCamera)

    cam = PinholeCamera(460.0, 460.0, 320.0, 240.0, dist=(-0.28, 0.07, 1e-4,
                                                          -2e-4))
    out = cam.undistort_normalize(np.array([[320.0, 240.0], [400.0, 300.0]]))
    assert np.allclose(out[0], 0.0) and np.all(np.isfinite(out))
    assert out[1, 0] > (400.0 - 320.0) / 460.0    # barrel: pushed outward
    with pytest.raises(ImportError, match="OpenCV"):
        FeatureTracker(cam, cam)
    with pytest.raises(ImportError, match="OpenCV"):
        FisheyeCamera(460.0, 460.0, 320.0, 240.0).undistort_normalize(
            np.ones((1, 2)))
