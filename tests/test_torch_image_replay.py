"""The port's image pipeline against the JAX package on the CPU: the
renderer, the replay with the legged EKF as contact source (`replay(ekf=)`)
and the whole image replay (`replay_images`: rendered stereo -> the device
tracker -> the f64 estimator with EKF contacts).

Inputs: sequence A's simulator, SimConfig(speed=0.5, seed=5), cut in time to
what the frames replayed need (1.6 s for 14 frames of `replay`, 1.2 s for
14 frames of `replay_images`), with max_features = 48 and
max_num_iterations = 4; the JAX Estimator is built with use_native=False,
so both sides run the same Python sensor sync. contact_sensor_type is the
default, 0: contacts from LeggedEKF(cfg, filter_window=4).

Tolerances, and why:
  * ImageRenderer and PrerenderedFrames: bit-identical uint8 images (the
    same NumPy code and generators);
  * replay(ekf=): per-frame position within 1e-8 m, equal counts, the EKF's
    final state within 1e-10 relative — tests/test_torch_streaming.py's
    replay gate, with the EKF's f64 differences (~1e-12) feeding contacts;
  * replay_images (pipeline_frontend=False, 320x240 images): equal solve,
    keyframe and reboot counts, equal published frames, per-frame position
    within 1e-6 m. The f32 tracker puts ulp differences into the observed
    points (tests/test_torch_klt.py); the largest position difference
    measured here is 6.3e-9 m.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data import simulator as jsim
from cerberus_tpu.data.replay import replay as jreplay
from cerberus_tpu.data.replay import replay_images as jreplay_images
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu.frontend import LeggedEKF as jEKF
from cerberus_tpu.frontend.device_tracker import DeviceTracker as jTracker
from cerberus_tpu.frontend.tracker import PinholeCamera as jCam
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data import simulator as tsim
from cerberus_tpu_torch.data.replay import replay as treplay
from cerberus_tpu_torch.data.replay import replay_images as treplay_images
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.frontend import LeggedEKF as tEKF
from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker as tTracker
from cerberus_tpu_torch.frontend.tracker import PinholeCamera as tCam
from torch_port_util import assert_close, assert_rel

KW = dict(max_features=48, max_num_iterations=4)
FRAMES = 14


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: one intra-op
    thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(est):
    return {k: est.stats[k] for k in ("solves", "keyframes", "reboots")}


def test_image_renderer_bit_identical():
    sim = simulate(SimConfig(duration=1.0, speed=0.5, seed=5))
    jr = jsim.ImageRenderer(sim, jConfig())
    tr = tsim.ImageRenderer(sim, tConfig())
    cams = [int(k) for k in sim["cam_idx"][:3]]
    for k in cams:
        for a, b in zip(tr.render_stereo(k), jr.render_stereo(k)):
            assert a.dtype == np.uint8 and a.shape == (480, 640)
            np.testing.assert_array_equal(a, b)
    # a second pair of renderers, each frame once, through the cache
    jp = jsim.PrerenderedFrames(jsim.ImageRenderer(sim, jConfig()), cams)
    tp = tsim.PrerenderedFrames(tsim.ImageRenderer(sim, tConfig()), cams)
    for k in cams:
        for a, b in zip(tp.render_stereo(k), jp.render_stereo(k)):
            np.testing.assert_array_equal(a, b)
    assert (tp.f, tp.cx, tp.cy, tp.W, tp.H) == (jp.f, jp.cx, jp.cy, jp.W,
                                               jp.H)


def test_replay_ekf_contact_source_matches_jax(tmp_path):
    """tests/test_estimator_e2e.py::test_replay_ekf_contact_source, cut to
    fit the CPU: contacts from each package's LeggedEKF."""
    sim = simulate(SimConfig(duration=1.6, speed=0.5, seed=5))
    jcfg = dataclasses.replace(jConfig(), **KW)
    tcfg = dataclasses.replace(tConfig(), **KW)
    assert tcfg.contact_sensor_type == 0
    jekf, tekf = jEKF(jcfg, filter_window=4), tEKF(tcfg, filter_window=4,
                                                     device="cpu")
    jout = jreplay(sim, est=jest.Estimator(jcfg, use_native=False),
                   max_frames=FRAMES, ekf=jekf)
    tout = treplay(sim, est=test.Estimator(tcfg, device="cpu"),
                   max_frames=FRAMES, ekf=tekf,
                   csv_path=str(tmp_path / "port.csv"))
    jest_, test_ = jout["estimator"], tout["estimator"]
    assert test_.solver_flag == test_.NON_LINEAR
    assert _counts(test_) == _counts(jest_)
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    assert len(tout["est_t"]) >= 3
    assert_close("replay(ekf=).est_p", tout["est_p"], jout["est_p"], 0, 1e-8)
    assert_rel("replay(ekf=).ekf_state", tekf.get_state(), jekf.get_state(),
               1e-10)
    # the CSV's EKF columns hold the filter's position and velocity
    rows = np.loadtxt(tmp_path / "port.csv", delimiter=",", skiprows=1,
                      ndmin=2)
    assert rows.shape == (len(tout["est_t"]), 20)
    assert np.abs(rows[:, 7:13]).max() > 0


def test_replay_images_matches_jax():
    """rendered stereo (320x240) -> DeviceTracker -> estimator with
    LeggedEKF contacts, sequentially (pipeline_frontend=False) in both
    packages."""
    sim = simulate(SimConfig(duration=1.2, speed=0.5, seed=5))
    size = dict(image_width=320, image_height=240)
    outs = {}
    for pkg, Config, Est, Cam, Tracker, EKF, run in (
            ("jax", jConfig, lambda c: jest.Estimator(c, use_native=False),
             jCam, jTracker, jEKF, jreplay_images),
            ("port", tConfig, lambda c: test.Estimator(c, device="cpu"),
             tCam, tTracker, tEKF, treplay_images)):
        cfg = dataclasses.replace(Config(), **KW, **size)
        cam = Cam(460.0, 460.0, 160.0, 120.0, size=(320, 240))
        extra = {} if pkg == "jax" else dict(device="cpu")
        tracker = Tracker(cam, cam, max_cnt=cfg.max_cnt,
                          min_dist=cfg.min_dist, **extra)
        outs[pkg] = run(sim, est=Est(cfg), tracker=tracker,
                        ekf=EKF(cfg, filter_window=4, **extra),
                        max_frames=FRAMES, pipeline_frontend=False)
    jout, tout = outs["jax"], outs["port"]
    est = tout["estimator"]
    assert est.solver_flag == est.NON_LINEAR
    assert _counts(est) == _counts(jout["estimator"])
    assert est.stats["reboots"] == 0 and est.stats["solves"] >= 2
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    assert len(tout["est_t"]) >= 3
    assert_close("replay_images.est_p", tout["est_p"], jout["est_p"], 0, 1e-6)
    assert tout["tracker"].stats["frames"] == FRAMES
    assert tout["track_ms_per_frame"] > 0 and tout["render_ms_per_frame"] > 0


def test_replay_images_defaults_to_the_device_tracker():
    """With no tracker given, replay_images tracks on the estimator's device
    with a DeviceTracker of the config's settings: the same run as one given
    that tracker explicitly."""
    sim = simulate(SimConfig(duration=0.4, speed=0.5, seed=5))
    cfg = dataclasses.replace(tConfig(), image_width=160, image_height=120,
                              max_features=16, max_num_iterations=1,
                              max_cnt=24)
    outs = []
    for explicit in (False, True):
        renderer = tsim.ImageRenderer(sim, cfg, focal=115.0)
        tracker = None
        if explicit:
            cam = tCam(115.0, 115.0, 80.0, 60.0, size=(160, 120))
            tracker = tTracker(cam, cam, max_cnt=cfg.max_cnt,
                               min_dist=cfg.min_dist,
                               flow_back=cfg.flow_back, device="cpu")
        outs.append(treplay_images(
            sim, est=test.Estimator(cfg, device="cpu"), renderer=renderer,
            tracker=tracker, ekf=tEKF(cfg, filter_window=4, device="cpu"),
            max_frames=3, pipeline_frontend=False))
    default, given = outs
    tracker = default["tracker"]
    assert isinstance(tracker, tTracker)
    assert tracker.device == torch.device("cpu")
    assert (tracker.max_cnt, tracker.min_dist) == (24, cfg.min_dist)
    assert tracker.stats["frames"] == 3
    np.testing.assert_array_equal(tracker.ids, given["tracker"].ids)
    np.testing.assert_array_equal(tracker.prev_pts, given["tracker"].prev_pts)
    assert len(tracker.ids) > 0
    assert _counts(default["estimator"]) == _counts(given["estimator"])
