"""The port's logged-data path against the JAX package on the CPU: the
schema-v1 dataset (data/log_adapter.py: write_dataset, load_dataset,
ImageLoader), the streaming replay of a logged dataset with its CSV and
metrics stream (utils/metrics.py and the estimator's hooks), and estimator
checkpoints (utils/checkpoint.py) carried between the packages.

Inputs: sequence A's simulator cut to what the frames replayed need,
SimConfig(duration=1.6, speed=0.5, seed=5) (24 camera frames), written as a
dataset with 100 Hz mocap and its ideal tracks as features.npz (the
features path, tests/test_log_adapter.py's layout); for the image path
SimConfig(duration=1.2, ...) rendered at 320x240 into cam0/cam1 PNGs. The
estimator runs max_features = 48, max_num_iterations = 4, 14 camera
frames; the JAX Estimator is built with use_native=False, the port's runs
its native sync (the intervals are bit-identical, tests/test_torch_native.py).

Tolerances, and why:
  * dataset files and loaded arrays: equal (the same NumPy code), but
    the t column of imu_leg.csv and mocap.csv, which the port writes at
    1e-9 s and the JAX package at 9 significant digits: held to the
    stamps within 1e-9 s;
  * the features-path replay: per-frame position within 1e-8 m and equal
    counts, as tests/test_torch_streaming.py holds the replay of the live
    simulation;
  * metrics: the same records, kinds and fields; values within 1e-8
    relative (wall-clock fields excepted), but for the window costs
    `cost0` and `cost`: each carries the marginalization prior's constant
    0.5 |r_perp|^2, the part of the prior's residual outside the range of
    its (gauge-projected, rank-deficient) J, which the QR leaves to its
    basis — the packages' priors agree in information form to 1e-11 and
    their constants differ by up to ~0.2 of ~256 here. So the cost drop
    cost0 - cost is held within 1e-8 of cost0, and the offset of cost0
    equals the offset of cost within the same;
  * the CSV: the same rows and columns, values within 1e-8 (both written
    "%.9g" by the same C code; positions differ at ~1e-13);
  * checkpoints: a checkpoint saved by either package and loaded by the
    other continues for two frames within 1e-8 m of the same checkpoint
    loaded by the JAX package; the port's own checkpoint resumes exactly
    (1e-12 m) where it was saved, and saving leaves the saver's own
    replay unchanged (1e-12 m against the same replay without a save);
  * the ImageLoader path: replay_images at 320x240, pipeline_frontend=False,
    within 1e-6 m with equal counts, as tests/test_torch_image_replay.py.
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data import log_adapter as jla
from cerberus_tpu.data import simulator as jsim
from cerberus_tpu.data.replay import replay as jreplay
from cerberus_tpu.data.replay import replay_images as jreplay_images
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu.frontend.device_tracker import DeviceTracker as jTracker
from cerberus_tpu.frontend.tracker import PinholeCamera as jCam
from cerberus_tpu.utils import checkpoint as jck
from cerberus_tpu.utils import metrics as jmetrics
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data import log_adapter as tla
from cerberus_tpu_torch.data import simulator as tsim
from cerberus_tpu_torch.data.replay import _proprio_tick
from cerberus_tpu_torch.data.replay import replay as treplay
from cerberus_tpu_torch.data.replay import replay_images as treplay_images
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.frontend.device_tracker import DeviceTracker as tTracker
from cerberus_tpu_torch.frontend.tracker import PinholeCamera as tCam
from cerberus_tpu_torch.utils import checkpoint as tck
from cerberus_tpu_torch.utils import metrics as tmetrics
from torch_port_util import assert_close, assert_rel

KW = dict(max_features=48, max_num_iterations=4)
FRAMES = 14
WALL = {"wall_s", "solve_ms", "block_ms"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(est):
    return {k: est.stats[k] for k in ("solves", "keyframes", "reboots",
                                      "dispatches")}


def _features_npz(sim, path):
    """The sim's ideal tracks in the features.npz schema
    (tests/test_log_adapter.py::_features_npz)."""
    frames = sim["features"]
    K = max(len(f) for f in frames)
    n = len(frames)
    ids = np.full((n, K), -1, np.int64)
    pts, pts_r = np.zeros((n, K, 3)), np.zeros((n, K, 3))
    vel, vel_r = np.zeros((n, K, 2)), np.zeros((n, K, 2))
    for fi, frame in enumerate(frames):
        for k, (fid, (o0, v0, o1, v1)) in enumerate(frame.items()):
            ids[fi, k] = fid
            pts[fi, k], vel[fi, k] = o0, v0
            if o1 is not None:
                pts_r[fi, k], vel_r[fi, k] = o1, v1
    np.savez(path, t=sim["cam_t"], ids=ids, pts=pts, vel=vel, pts_r=pts_r,
             vel_r=vel_r)


def _write(mod, out, sim):
    mocap = np.column_stack([sim["t"][::5], sim["p"][::5]])
    mod.write_dataset(out, sim["t"], sim["acc"], sim["gyr"], sim["phi"],
                      sim["dphi"], sim["contacts"], mocap=mocap)
    _features_npz(sim, os.path.join(out, "features.npz"))


@pytest.fixture(scope="module")
def sim16():
    return simulate(SimConfig(duration=1.6, speed=0.5, seed=5))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, sim16):
    root = tmp_path_factory.mktemp("logged")
    _write(tla, str(root / "port"), sim16)
    _write(jla, str(root / "jax"), sim16)
    return root


@pytest.fixture(scope="module")
def replays(dataset):
    """Both packages' replay of the port-written dataset, 14 frames, with a
    CSV and a metrics stream each (loggers closed and detached after)."""
    ds = tla.load_dataset(str(dataset / "port"))
    outs = {}
    for name, Config, make, run, metrics in (
            ("jax", jConfig, lambda c: jest.Estimator(c, use_native=False),
             jreplay, jmetrics),
            ("port", tConfig, lambda c: test.Estimator(c, device="cpu"),
             treplay, tmetrics)):
        est = make(dataclasses.replace(Config(), **KW))
        est.metrics = metrics.MetricsLogger(str(dataset / f"{name}.jsonl"))
        out = run(ds, est=est, max_frames=FRAMES,
                  csv_path=str(dataset / f"{name}.csv"))
        est.metrics.close()
        est.metrics = None
        outs[name] = out
    return ds, outs["jax"], outs["port"]


def test_write_and_load_dataset_match_jax(dataset, sim16):
    """The files: meta.json byte-equal; imu_leg.csv and mocap.csv parsed
    equal but for their t column, which the port writes at 1e-9 s ("%.9f",
    as cam.csv) and the JAX package at 9 significant digits ("%.9g"): the
    port's t is held to the simulator's stamps within 1e-9 s. Then every
    loaded array equal (at these stamps both formats parse alike)."""
    sim = sim16
    stamps = {"imu_leg.csv": sim["t"], "mocap.csv": sim["t"][::5]}
    assert filecmp.cmp(dataset / "port" / "meta.json",
                       dataset / "jax" / "meta.json", shallow=False)
    for name, t in stamps.items():
        got = np.loadtxt(dataset / "port" / name, delimiter=",", ndmin=2)
        want = np.loadtxt(dataset / "jax" / name, delimiter=",", ndmin=2)
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:], err_msg=name)
        np.testing.assert_allclose(got[:, 0], t, rtol=0, atol=1e-9,
                                   err_msg=name)
    tds = tla.load_dataset(str(dataset / "port"))
    jds = jla.load_dataset(str(dataset / "jax"))
    assert tds.keys() == jds.keys()
    for k in tds:
        if k == "features":
            assert len(tds[k]) == len(jds[k])
            for tf, jf in zip(tds[k], jds[k]):
                assert tf.keys() == jf.keys()
                for fid in tf:
                    for a, b in zip(tf[fid], jf[fid]):
                        assert (a is None) == (b is None)
                        if a is not None:
                            np.testing.assert_array_equal(a, b)
        elif k == "meta":
            assert tds[k] == jds[k]
        else:
            np.testing.assert_array_equal(tds[k], jds[k], err_msg=k)
    print(f"PORT_DIFF write_dataset/load_dataset {len(tds['t'])} samples, "
          f"{len(tds['features'])} feature frames: equal (exact)")


def test_bad_schema_rejected(tmp_path):
    os.makedirs(tmp_path / "bad")
    with open(tmp_path / "bad" / "meta.json", "w") as f:
        json.dump({"version": 99}, f)
    with pytest.raises(ValueError, match="version"):
        tla.load_dataset(str(tmp_path / "bad"))


def test_replay_on_logged_dataset_matches_jax(replays):
    _, jout, tout = replays
    est = tout["estimator"]
    assert est.solver_flag == est.NON_LINEAR and est.use_native
    assert _counts(est) == _counts(jout["estimator"])
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    assert len(tout["est_t"]) >= 3
    assert_close("replay(dataset).est_p", tout["est_p"], jout["est_p"], 0,
                 1e-8)
    assert_close("replay(dataset).ate_rmse", tout["ate_rmse"],
                 jout["ate_rmse"], 0, 1e-8)


def test_metrics_match_jax(dataset, replays):
    """The estimator's metrics hooks: one `solve` record per solve with the
    JAX package's fields (cost0, cost, accepted, solve_ms, block_ms,
    dispatches, features, keyframe, td)."""
    trec = tmetrics.read_metrics(str(dataset / "port.jsonl"))
    jrec = jmetrics.read_metrics(str(dataset / "jax.jsonl"))
    assert [r["kind"] for r in trec] == [r["kind"] for r in jrec]
    assert len(trec) == replays[2]["estimator"].stats["solves"] >= 3
    for i, (a, b) in enumerate(zip(trec, jrec)):
        assert a.keys() == b.keys(), (a.keys(), b.keys())
        tol = 1e-8 * b["cost0"]
        assert_close(f"metrics[{i}].cost0 - cost", a["cost0"] - a["cost"],
                     b["cost0"] - b["cost"], 0, tol)
        assert_close(f"metrics[{i}] prior constant (cost0 vs cost offset)",
                     a["cost0"] - b["cost0"], a["cost"] - b["cost"], 0, tol)
        for k in a.keys() - WALL - {"kind", "cost0", "cost"}:
            if isinstance(b[k], (bool, int)):
                assert a[k] == b[k], (i, k)
            else:
                assert_rel(f"metrics[{i}].{k}", a[k], b[k], 1e-8)


def test_csv_matches_jax(dataset, replays):
    t = np.loadtxt(dataset / "port.csv", delimiter=",", skiprows=1, ndmin=2)
    j = np.loadtxt(dataset / "jax.csv", delimiter=",", skiprows=1, ndmin=2)
    assert (dataset / "port.csv").read_text().splitlines()[0] == \
        (dataset / "jax.csv").read_text().splitlines()[0]
    assert t.shape == j.shape == (len(replays[2]["est_t"]), 20)
    assert_close("replay CSV", t, j, 1e-8, 1e-8)


def _continue(est, ds, frames):
    """Feed camera frames `frames` (indices into the sorted camera list)
    to est; returns the pose after each and, after a flush, the window."""
    cams = sorted(int(k) for k in ds["cam_idx"])
    feats = {int(k): f for k, f in zip(ds["cam_idx"], ds["features"])}
    poses = []
    for k in [cams[i] for i in frames]:
        est.input_image(ds["t"][k], feats[k])
        poses.append(np.array(est.pose[0]))
    est.flush()
    return np.array(poses + [np.array(est.pose[0])]), np.array(est.p)


def test_checkpoint_between_packages(dataset, replays):
    """Each package saves its estimator after the replay's 14 frames; each
    file is loaded by the other package (and the JAX package's by itself)
    and two more frames run. Runs last in this module: saving consumes the
    JAX estimator's sync."""
    ds, jout, tout = replays
    nxt = range(FRAMES, FRAMES + 2)
    jpath, tpath = str(dataset / "jax.npz"), str(dataset / "port.npz")
    jout["estimator"].flush()
    jck.save_estimator(jout["estimator"], jpath)
    tck.save_estimator(tout["estimator"], tpath)
    jcfg = dataclasses.replace(jConfig(), **KW)
    tcfg = dataclasses.replace(tConfig(), **KW)
    runs = {}
    for name, path in (("jax<-jax", jpath), ("jax<-port", tpath)):
        est = jck.load_estimator(jest.Estimator(jcfg, use_native=False), path)
        runs[name] = _continue(est, ds, nxt)
    for name, path in (("port<-jax", jpath), ("port<-port", tpath)):
        est = tck.load_estimator(test.Estimator(tcfg, device="cpu"), path)
        runs[name] = _continue(est, ds, nxt)
    ref = runs["jax<-jax"]
    for name in ("jax<-port", "port<-jax"):
        assert_close(f"checkpoint {name} poses", runs[name][0], ref[0], 0,
                     1e-8)
        assert_close(f"checkpoint {name} window p", runs[name][1], ref[1], 0,
                     1e-8)
    # the port's own checkpoint resumes exactly where the saver goes on
    saver = _continue(tout["estimator"], ds, nxt)
    assert_close("checkpoint port<-port vs the saver", runs["port<-port"][0],
                 saver[0], 0, 1e-12)
    assert_close("checkpoint port<-port vs the saver (window)",
                 runs["port<-port"][1], saver[1], 0, 1e-12)


@pytest.mark.parametrize("use_native", [True, False])
def test_save_leaves_the_saver_unchanged(dataset, tmp_path, use_native):
    """save_estimator flushes the step in flight and refills the sync; the
    saver goes on as if it had not been saved: the port's replay of 20
    frames with a save 10 samples after frame 14 (rows not yet closed into
    an interval) equals the same replay without one
    (every pose and the final window, 1e-12 m), with the native sync and
    with PySensorSync (whose extract consumes the rows it returns)."""
    ds = tla.load_dataset(str(dataset / "port"))
    cams = sorted(int(k) for k in ds["cam_idx"])[:20]
    assert len(cams) == 20
    runs = {}
    for name in ("saved", "unsaved"):
        est = test.Estimator(dataclasses.replace(tConfig(), **KW),
                             device="cpu", use_native=use_native)
        poses = []
        for k in range(cams[-1] + 1):
            _proprio_tick(est, None, ds, k)
            if k in cams:
                est.input_image(ds["t"][k], ds["features"][cams.index(k)])
                poses.append(np.array(est.pose[0]))
            # mid-interval: 10 samples after frame 14 are not yet closed
            if name == "saved" and k == cams[FRAMES - 1] + 10:
                tck.save_estimator(est, str(tmp_path / "mid.npz"))
        est.flush()
        assert est.stats["solves"] >= 6
        runs[name] = (np.array(poses + [np.array(est.pose[0])]),
                      np.array(est.p))
    assert len(np.load(tmp_path / "mid.npz")["pending_rows"]) == 11
    assert_close("save_estimator: saver vs unsaved (poses)",
                 runs["saved"][0], runs["unsaved"][0], 0, 1e-12)
    assert_close("save_estimator: saver vs unsaved (window)",
                 runs["saved"][1], runs["unsaved"][1], 0, 1e-12)


def test_image_loader_replay_matches_jax(tmp_path):
    """A dataset of 320x240 stereo PNGs (ImageRenderer's frames, cam.csv),
    loaded with each package's load_dataset + ImageLoader and replayed by
    replay_images with the package's DeviceTracker, sequentially."""
    sim = simulate(SimConfig(duration=1.2, speed=0.5, seed=5))
    size = dict(image_width=320, image_height=240)
    r = tsim.ImageRenderer(sim, tConfig(**size))
    paths, out = [], str(tmp_path / "ds")
    os.makedirs(os.path.join(out, "cam0"))
    os.makedirs(os.path.join(out, "cam1"))
    for i, k in enumerate(sim["cam_idx"]):
        rel = (f"cam0/{i:06d}.png", f"cam1/{i:06d}.png")
        for side, im in zip(rel, r.render_stereo(int(k))):
            tla._write_png_gray(os.path.join(out, side), im)
        paths.append(rel)
    tla.write_dataset(out, sim["t"], sim["acc"], sim["gyr"], sim["phi"],
                      sim["dphi"], sim["contacts"], cam_t=sim["cam_t"],
                      image_paths=paths,
                      mocap=np.column_stack([sim["t"], sim["p"]]))
    outs = {}
    for pkg, la, Config, Est, Cam, Tracker, run in (
            ("jax", jla, jConfig, lambda c: jest.Estimator(c,
                                                           use_native=False),
             jCam, jTracker, jreplay_images),
            ("port", tla, tConfig, lambda c: test.Estimator(c, device="cpu"),
             tCam, tTracker, treplay_images)):
        cfg = dataclasses.replace(Config(), **KW, **size)
        ds = la.load_dataset(out)
        loader = la.ImageLoader(ds, r.f, cfg.image_width / 2.0,
                                cfg.image_height / 2.0)
        cam = Cam(loader.f, loader.f, loader.cx, loader.cy,
                  size=(loader.W, loader.H))
        extra = {} if pkg == "jax" else dict(device="cpu")
        tracker = Tracker(cam, cam, max_cnt=cfg.max_cnt,
                          min_dist=cfg.min_dist, **extra)
        outs[pkg] = run(ds, est=Est(cfg), tracker=tracker, renderer=loader,
                        max_frames=FRAMES, pipeline_frontend=False)
    jout, tout = outs["jax"], outs["port"]
    est = tout["estimator"]
    assert est.solver_flag == est.NON_LINEAR
    assert _counts(est) == _counts(jout["estimator"])
    assert est.stats["reboots"] == 0 and est.stats["solves"] >= 2
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    assert_close("replay_images(ImageLoader).est_p", tout["est_p"],
                 jout["est_p"], 0, 1e-6)
    assert tout["tracker"].stats["frames"] == FRAMES
    assert (jsim.ImageRenderer(sim, jConfig(**size)).f == r.f)
