"""The port's long-run script (cerberus_tpu_torch/evals/long_run.py) and the
three parameters it needs (replay_images(use_prediction=),
PrerenderedFrames(memmap_path=, progress=), FeatureTracker(use_clahe=))
against the JAX package on the CPU.

Inputs: simulated figure-eight walks (seed 77 as the script's default, or
sequence A, seed 5), cut to the frames a CPU test can afford; the default
EstimatorConfig cut to max_features = 32, max_num_iterations = 4 in both
packages (the scripts' module-level EstimatorConfig swapped for the test),
and 320x240 images where images are rendered. Both packages' loop closers
run on a 16-node pose graph, with the principal point of the 320x240
images (the JAX package's one-hot optimize at its default 512-node pool
costs ~1 s a Gauss-Newton iteration on a CPU).

Tolerances, and why:
  * PrerenderedFrames (in RAM, spilled to disk, JAX's): exact uint8 — the
    same renderer and generators;
  * FeatureTracker(use_clahe=False): exact — both packages run OpenCV;
  * long_run --loop: the result's keys equal the JAX script's, and its
    numbers (rounded by both to 4 decimals: drift, ATE, the loop block)
    and counts; the keyframe records equal (t, ids, `ok`) and within
    1e-8 m (p_odo, so odometric(), and corrected()); with --images
    --no-predict (replay_images(use_prediction=False), 18 frames at
    320x240, serial front end), descriptors within 1e-6 and the tiny
    images `g` exact. The f32 tracker puts ulp differences into the
    observed points (tests/test_torch_image_replay.py: positions within
    1e-6 m), which round the same way here.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import cerberus_tpu.config as jconfig
import cerberus_tpu.loop.closer as jcloser_mod
from cerberus_tpu.data import simulator as jsim
from cerberus_tpu.frontend import tracker as jtr
from cerberus_tpu.loop.posegraph import PoseGraph as jPoseGraph
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data import simulator as tsim
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.evals import long_run as lr
from cerberus_tpu_torch.frontend import tracker as ttr
from cerberus_tpu_torch.loop.posegraph import PoseGraph as tPoseGraph
from torch_port_util import assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_features=32, max_num_iterations=4)
SMALL = dict(image_width=320, image_height=240)
made = {}   # the port script's estimator and tracker of the last run
make_tracker = lr.make_tracker


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: one intra-op
    thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_eval(name):
    """The JAX repo's evals/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_evals_{name}", os.path.join(ROOT, "evals", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_closer(Closer, PoseGraph, closers, **dev):
    """A LoopCloser class whose instances run a 16-node pose graph with the
    config's principal point, each appended to `closers`."""

    class Small(Closer):
        def __init__(self, cfg=None, **kw):
            super().__init__(cfg, **kw)
            self.cx = self.cfg.image_width / 2.0
            self.cy = self.cfg.image_height / 2.0
            self.pg = PoseGraph(capacity_nodes=16, capacity_edges=32,
                                auto_detect=False, seq_weight=100.0, **dev)
            closers.append(self)

    return Small


def test_prerendered_frames_spill_to_disk(tmp_path, capsys):
    """memmap_path spills the frames to an .npy file with the in-RAM
    frames' bytes, which equal the JAX package's; progress prints a line
    every 500 frames."""
    sim = tsim.simulate(tsim.SimConfig(duration=0.5, speed=0.5, seed=5))
    cams = [int(k) for k in sim["cam_idx"][:3]]
    ram = tsim.PrerenderedFrames(tsim.ImageRenderer(sim), cams)
    disk = tsim.PrerenderedFrames(tsim.ImageRenderer(sim), cams,
                                  memmap_path=str(tmp_path / "port.npy"),
                                  progress=True)
    assert capsys.readouterr().out == "prerender 0/3\n"
    jdisk = jsim.PrerenderedFrames(jsim.ImageRenderer(sim), cams,
                                   memmap_path=str(tmp_path / "jax.npy"))
    assert isinstance(disk.buf, np.memmap) and disk.buf.dtype == np.uint8
    for k in cams:
        for a, b, c in zip(disk.render_stereo(k), ram.render_stereo(k),
                           jdisk.render_stereo(k)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    disk.buf.flush()
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), ram.buf)
    assert disk.prerender_s > 0


def test_feature_tracker_without_clahe_matches_jax():
    """use_clahe=False: no equalisation (clahe None) and the JAX package's
    ids and observations on 3 rendered stereo pairs, exact."""
    pytest.importorskip("cv2")
    sim = tsim.simulate(tsim.SimConfig(duration=1.0, speed=0.5, seed=5))
    r = tsim.ImageRenderer(sim, tConfig(image_width=160, image_height=120),
                           focal=115.0)
    frames = [r.render_stereo(int(k)) for k in sim["cam_idx"][:3]]
    make = lambda mod, clahe: mod.FeatureTracker(
        mod.PinholeCamera(r.f, r.f, r.cx, r.cy), mod.PinholeCamera(
            r.f, r.f, r.cx, r.cy), max_cnt=40, min_dist=8, use_clahe=clahe)
    jt, tt, eq = make(jtr, False), make(ttr, False), make(ttr, True)
    assert tt.clahe is None and eq.clahe is not None
    differ = 0
    for k, (im0, im1) in enumerate(frames):
        jout, tout = jt.track(k / 15.0, im0, im1), tt.track(k / 15.0, im0,
                                                            im1)
        eout = eq.track(k / 15.0, im0, im1)
        assert list(tout) == list(jout) and len(tout) > 0
        for fid in jout:
            for a, b in zip(tout[fid], jout[fid]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        differ += any(fid not in eout or not np.array_equal(
            tout[fid][0], eout[fid][0]) for fid in tout)
    assert differ > 0   # the equalised tracker sees other images


def _run_both(monkeypatch, capsys, tmp_path, argv, size=None):
    """The JAX script (--platform cpu) and the port's (--device cpu) on the
    same arguments, both with --loop-record: (JAX result, port result, JAX
    records, port records, JAX closer, port closer); the port's estimator
    and tracker are kept in `made`."""
    size = size or {}
    made.clear()
    monkeypatch.setattr(lr, "Estimator", lambda *a, **kw: made.setdefault(
        "est", test.Estimator(*a, **kw)))
    monkeypatch.setattr(lr, "make_tracker", lambda *a, **kw: made.setdefault(
        "tracker", make_tracker(*a, **kw)))
    jcls = jconfig.EstimatorConfig
    monkeypatch.setattr(jconfig, "EstimatorConfig",
                        lambda **kw: jcls(**{**KW, **size, **kw}))
    monkeypatch.setattr(lr, "EstimatorConfig",
                        lambda **kw: tConfig(**{**KW, **size, **kw}))
    closers = {"jax": [], "port": []}
    monkeypatch.setattr(jcloser_mod, "LoopCloser", small_closer(
        jcloser_mod.LoopCloser, jPoseGraph, closers["jax"]))
    monkeypatch.setattr(lr, "LoopCloser", small_closer(
        lr.LoopCloser, tPoseGraph, closers["port"], device="cpu"))
    jpkl, tpkl = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    monkeypatch.setattr(sys, "argv", ["long_run"] + argv + [
        "--platform", "cpu", "--loop-record", str(jpkl)])
    jax_eval("long_run").main()
    jres = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tres = lr.main(argv + ["--device", "cpu", "--loop-record", str(tpkl)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == tres
    with open(jpkl, "rb") as f:
        jrec = pickle.load(f)
    with open(tpkl, "rb") as f:
        trec = pickle.load(f)
    return jres, tres, jrec, trec, closers["jax"][0], closers["port"][0]


def _assert_loops_equal(name, jres, tres, jrec, trec, jc, tc):
    assert set(tres) == set(jres)
    assert set(tres["loop"]) == set(jres["loop"])
    assert tres["platform"] == "cpu" and tres["dtype"] == jres["dtype"]
    for k in ("solves", "reboots", "keyframes", "distance_m", "drift_pct",
              "ate_rmse_m", "final_err_m"):
        assert tres[k] == jres[k], k
    assert tres["loop"] == jres["loop"]
    assert len(trec) == len(jrec) >= 3
    for a, b in zip(trec, jrec):
        assert a["t"] == b["t"]
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["ok"], b["ok"])
    assert_close(f"{name}.p_odo", [r["p_odo"] for r in trec],
                 [r["p_odo"] for r in jrec], 0, 1e-8)
    assert_close(f"{name}.odometric", tc.odometric(), jc.odometric(), 0,
                 1e-8)
    assert_close(f"{name}.corrected", tc.corrected(), jc.corrected(), 0,
                 1e-8)


def test_long_run_loop_matches_jax(monkeypatch, capsys, tmp_path):
    """`long_run --loop` on ideal features: the estimator's keyframes reach
    the loop closer as they reach the JAX script's."""
    argv = ["--loop", "--duration", "1.6", "--loop-kf-dist", "0"]
    jres, tres, jrec, trec, jc, tc = _run_both(monkeypatch, capsys,
                                               tmp_path, argv)
    assert tres["images"] is False and "loop" in tres
    assert all(r["g"] is None for r in trec)
    _assert_loops_equal("long_run --loop", jres, tres, jrec, trec, jc, tc)


def test_long_run_loop_images_matches_jax(monkeypatch, capsys, tmp_path):
    """`long_run --images --tracker device --loop --no-predict` (320x240,
    serial front end): replay_images(use_prediction=False) gives the
    estimator no predict_callback, so no seed reaches the tracker; the
    keyframes' images reach the loop closer, whose descriptors equal the
    JAX script's."""
    argv = ["--loop", "--images", "--tracker", "device", "--no-predict",
            "--no-pipeline-frontend", "--duration", "1.2",
            "--loop-kf-dist", "0"]
    jres, tres, jrec, trec, jc, tc = _run_both(monkeypatch, capsys,
                                               tmp_path, argv, SMALL)
    assert tres["tracker"] == "device" and tres["track_ms_per_frame"] > 0
    assert made["est"].predict_callback is None
    assert made["tracker"].predict_pts is None
    assert made["tracker"].stats["frames"] == 18
    _assert_loops_equal("long_run --images --loop", jres, tres, jrec, trec,
                        jc, tc)
    assert all(r["g"] is not None for r in trec)
    assert sum(int(r["ok"].sum()) for r in trec) > 0
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a["g"], b["g"])
    assert_close("long_run --images --loop.descs",
                 np.concatenate([r["descs"] for r in trec]),
                 np.concatenate([r["descs"] for r in jrec]), 0, 1e-6)


def test_go1_and_no_leg_configs_match_jax():
    """--robot go1 and --no-leg build the JAX script's configs."""
    go1 = dataclasses.replace(jconfig.EstimatorConfig(), robot=jconfig.GO1,
                              contact_sensor_type=2, optimize_leg_bias=False)
    assert dataclasses.asdict(lr.robot_config("go1")) == \
        dataclasses.asdict(go1)
    assert dataclasses.asdict(lr.robot_config("a1")) == \
        dataclasses.asdict(jconfig.EstimatorConfig())


def test_retained_images_across_threads():
    """RetainedImages keeps the newest `depth` frames and gives each once.
    Stress: a renderer thread adds (and evicts) while 16 threads take, with
    a short switch interval: no thread raises, no frame is given twice, at
    most `depth` are held."""
    import threading

    images = lr.RetainedImages(depth=4)
    for k in range(6):
        images.put(k / 15.0, k)
    assert images.take(0.0) is None and images.take(1 / 15.0) is None
    assert images.take(5 / 15.0) == 5 and images.take(5 / 15.0) is None
    n, taken, errors = 20000, [], []

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:   # noqa: BLE001 -- asserted below
                errors.append(e)
        return run

    def render():
        for k in range(10, n):
            images.put(k / 15.0, k)

    def take(offset):
        while writer.is_alive():
            for k in range(10 + offset, n, 16):
                img = images.take(k / 15.0)
                if img is not None:
                    taken.append(img)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writer = threading.Thread(target=guarded(render))
        readers = [threading.Thread(target=guarded(lambda o=o: take(o)))
                   for o in range(16)]
        writer.start()
        for th in readers:
            th.start()
        for th in [writer] + readers:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and taken
    assert len(taken) == len(set(taken)) and len(images._imgs) <= 4
