"""The port's rosbag codec and container (cerberus_tpu_torch/data/rosbag.py)
and bag / EuRoC converters (data/log_adapter.py) against the JAX package's.

Inputs: messages made from a numpy seed; a short simulated sequence
(SimConfig(duration=2.0, speed=0.5, path="arc", seed=5)) packed into a bag
on the reference A1 topics as tests/test_rosbag.py::_sim_to_bag packs it;
a synthetic EuRoC tree as tests/test_rosbag.py::test_convert_euroc makes it.

Tolerances: none but the sample clock. Bags are compared byte for byte
(plain, recorder-style, bz2 chunks), each package's reader decodes the
other's bag to equal messages, and the converters' datasets are equal file
by file and array by array (the same NumPy code on the same bytes) — but
for the t column of imu_leg.csv and mocap.csv, which the port writes at
1e-9 s ("%.9f", as cam.csv) where the JAX package keeps 9 significant
digits ("%.9g"): the port's t is held to the source's stamps within 1e-9
s, the rest of those files' parsed columns to JAX's exactly. A bag
stamped at a Unix epoch (1.6e9 s) converts and replays.
"""

import bz2
import dataclasses
import filecmp
import os
import struct

import numpy as np
import pytest
import torch

from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data import log_adapter as jla
from cerberus_tpu.data import rosbag as jbag
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data import log_adapter as tla
from cerberus_tpu_torch.data import rosbag as tbag
from cerberus_tpu_torch.data.replay import replay
from cerberus_tpu_torch.estimator.estimator import Estimator

TOPICS = {"/hardware_a1/imu": "sensor_msgs/Imu",
          "/hardware_a1/joint_foot": "sensor_msgs/JointState",
          "/mocap_node/Robot_1/pose": "geometry_msgs/PoseStamped",
          "/camera_forward/infra1/image_rect_raw": "sensor_msgs/Image"}


def _messages(mod, seed=0):
    """(topic, msg, callerid, latching) of every message type, built by
    `mod` (either package's rosbag) from one numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(30):
        t = 1000.0 + 0.002 * k
        out.append(("/hardware_a1/imu", mod.ImuMsg(
            stamp=t, acc=rng.normal(size=3), gyr=rng.normal(size=3)),
            "/imu_node", False))
        out.append(("/hardware_a1/joint_foot", mod.JointStateMsg(
            stamp=t, position=rng.normal(size=16),
            velocity=rng.normal(size=16), effort=rng.normal(size=16),
            name=[f"j{i}" for i in range(16)]), "/leg_node", False))
        if k % 10 == 0:
            out.append(("/mocap_node/Robot_1/pose", mod.PoseStampedMsg(
                stamp=t, p=rng.normal(size=3),
                q=np.array([0.1, 0.2, 0.3, 0.9])), "", k == 0))
            out.append(("/camera_forward/infra1/image_rect_raw", mod.ImageMsg(
                stamp=t, data=rng.integers(0, 255, size=(12, 16)).astype(
                    np.uint8)), "/cam", False))
    return out


def _write(mod, path, **kw):
    with mod.BagWriter(str(path), **kw) as w:
        for topic, msg, callerid, latching in _messages(mod):
            w.write(topic, msg, callerid=callerid, latching=latching)


def _bz2(mod, src, dst):
    """Recompress src's chunk records with bz2 (rosbag record --bz2), with
    `mod`'s record helpers, as tests/test_rosbag.py::test_bag_bz2_chunk."""
    raw = open(src, "rb").read()
    body = b""
    for header, data in mod._iter_records(raw, len(mod.MAGIC)):
        if header.get("op", b"\x00")[0] == mod.OP_CHUNK:
            body += mod._record({"op": bytes([mod.OP_CHUNK]),
                                 "compression": b"bz2",
                                 "size": struct.pack("<I", len(data))},
                                bz2.compress(data))
        else:
            body += mod._record(header, data)
    with open(dst, "wb") as f:
        f.write(mod.MAGIC + body)


def _decoded(mod, path):
    """Every message of the bag, decoded by `mod`'s reader, as comparable
    tuples: (topic, stamp, {field: numpy value})."""
    out = []
    for topic, stamp, msg in mod.read_messages(str(path), TOPICS):
        fields = {k: np.asarray(v) for k, v in vars(msg).items()}
        out.append((topic, stamp, fields))
    return out


def _assert_same_messages(a, b):
    assert len(a) == len(b) > 0
    for (t1, s1, f1), (t2, s2, f2) in zip(a, b):
        assert t1 == t2 and s1 == s2 and f1.keys() == f2.keys()
        for k in f1:
            np.testing.assert_array_equal(f1[k], f2[k], err_msg=k)


def test_message_codecs_bytes_equal():
    for (_, tm, _, _), (_, jm, _, _) in zip(_messages(tbag), _messages(jbag)):
        assert tm.serialize() == jm.serialize()
        back = type(tm).deserialize(jm.serialize())
        assert back.serialize() == jm.serialize()


@pytest.mark.parametrize("style", ["plain", "recorder_style", "bz2"])
def test_bag_bytes_equal_and_readers_agree(tmp_path, style):
    """The same messages written by both packages' BagWriter (one chunk;
    recorder-style chunks of 25 with index and chunk-info records; the
    plain bag's chunk recompressed with bz2) give the same bytes; each
    package's reader decodes the other's bag to the same messages."""
    kw = dict(recorder_style=True, chunk_msgs=25) \
        if style == "recorder_style" else {}
    paths = {}
    for name, mod in (("port", tbag), ("jax", jbag)):
        paths[name] = tmp_path / f"{name}.bag"
        _write(mod, paths[name], **kw)
        if style == "bz2":
            plain = paths[name]
            paths[name] = tmp_path / f"{name}_bz2.bag"
            _bz2(mod, plain, paths[name])
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)
    ref = _decoded(jbag, paths["jax"])
    _assert_same_messages(_decoded(tbag, paths["jax"]), ref)
    _assert_same_messages(_decoded(jbag, paths["port"]), ref)
    _assert_same_messages(_decoded(tbag, paths["port"]), ref)
    # the container-level reader too (every record, no type filter)
    tr, jr = list(tbag.read_bag(str(paths["jax"]))), list(jbag.read_bag(
        str(paths["port"])))
    assert [(m[0], m[2]) for m in tr] == [(m[0], m[2]) for m in jr]
    print(f"PORT_DIFF BagWriter[{style}] {os.path.getsize(paths['port'])} "
          f"bytes equal; {len(ref)} messages decoded equal both ways")


def _sim_to_bag(sim, path, images=0, epoch=1000.0):
    """tests/test_rosbag.py::_sim_to_bag, with the port's BagWriter; the
    stamps are the simulator's clock plus `epoch` seconds."""
    topics = tla.A1_TOPICS
    with tbag.BagWriter(str(path)) as w:
        n = len(sim["t"])
        for k in range(n):
            t = float(sim["t"][k]) + epoch
            w.write(topics["imu"], tbag.ImuMsg(stamp=t, acc=sim["acc"][k],
                                               gyr=sim["gyr"][k]))
            pos = np.concatenate([sim["phi"][k], np.zeros(4)])
            vel = np.concatenate([sim["dphi"][k], sim["contacts"][k]])
            eff = np.concatenate([np.zeros(12), sim["foot_forces"][k]])
            w.write(topics["leg"], tbag.JointStateMsg(
                stamp=t, position=pos, velocity=vel, effort=eff))
            if k % 50 == 0:
                q = sim["q"][k]
                w.write(topics["mocap"], tbag.PoseStampedMsg(
                    stamp=t, p=sim["p"][k],
                    q=np.array([q[1], q[2], q[3], q[0]])))
        rng = np.random.default_rng(0)
        for i in range(images):
            t = float(sim["t"][min(i * 33, n - 1)]) + epoch
            im = rng.integers(0, 255, size=(24, 32)).astype(np.uint8)
            w.write(topics["image0"], tbag.ImageMsg(stamp=t, data=im))
            w.write(topics["image1"], tbag.ImageMsg(stamp=t + 0.001, data=im))


@pytest.fixture(scope="module")
def sim():
    return simulate(SimConfig(duration=2.0, speed=0.5, path="arc", seed=5))


# the files whose t column the port writes "%.9f" and the JAX package
# "%.9g" (9 digits: 10 s steps at a Unix-epoch stamp)
CLOCK_FILES = ("imu_leg.csv", "mocap.csv")


def _assert_datasets_equal(tds, jds, t_dir, j_dir, stamps):
    """The port's dataset against JAX's: every file byte-equal but
    CLOCK_FILES, whose parsed columns are equal but for t, which is held to
    the source's stamps (`stamps`: the expected t and mocap_t) within 1e-9
    s; likewise every loaded array, those made from the sample clock (t,
    mocap_t, the resampled ground truth p, cam_idx) held to the stamps or
    to the loader's own formula on them."""
    assert tds.keys() == jds.keys()
    for k in ("t", "mocap_t"):
        np.testing.assert_allclose(tds[k], stamps[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    for k in tds:
        if k in ("meta",):
            assert tds[k] == jds[k]
        elif k == "image_paths":
            assert [tuple(os.path.relpath(p, t_dir) if p else "" for p in pp)
                    for pp in tds[k]] == [
                tuple(os.path.relpath(p, j_dir) if p else "" for p in pp)
                for pp in jds[k]]
        elif k == "p":
            np.testing.assert_allclose(tds[k], np.column_stack([
                np.interp(stamps["t"], stamps["mocap_t"],
                          tds["mocap_p"][:, i]) for i in range(3)]),
                rtol=0, atol=1e-9, err_msg=k)
        elif k == "cam_idx":
            np.testing.assert_array_equal(tds[k], np.clip(np.searchsorted(
                tds["t"], tds["cam_t"]), 0, len(tds["t"]) - 1), err_msg=k)
        elif k not in ("t", "mocap_t"):
            np.testing.assert_array_equal(tds[k], jds[k], err_msg=k)
    for name in os.listdir(j_dir):
        tf, jf = os.path.join(t_dir, name), os.path.join(j_dir, name)
        if name in CLOCK_FILES:
            got = np.loadtxt(tf, delimiter=",", ndmin=2)
            want = np.loadtxt(jf, delimiter=",", ndmin=2)
            np.testing.assert_array_equal(got[:, 1:], want[:, 1:],
                                          err_msg=name)
            np.testing.assert_allclose(
                got[:, 0], stamps["t" if name == "imu_leg.csv"
                                  else "mocap_t"], rtol=0, atol=1e-9,
                err_msg=name)
        elif os.path.isfile(jf):
            assert filecmp.cmp(tf, jf, shallow=False), name


@pytest.mark.parametrize("robot", ["a1", "go1"])
def test_convert_rosbag_matches_jax(tmp_path, sim, robot):
    """convert_rosbag of one bag: A1 keeps the planned contact flags, Go1
    the foot forces (contact_kind "force"); with 3 stereo images for A1.
    Every array, the image index and the dataset files equal JAX's."""
    bag = tmp_path / f"{robot}.bag"
    _sim_to_bag(sim, bag, images=3 if robot == "a1" else 0)
    kw = dict(topics=tla.A1_TOPICS, robot=robot) if robot == "go1" else {}
    tds = tla.convert_rosbag(str(bag), str(tmp_path / "port"), **kw)
    jds = jla.convert_rosbag(str(bag), str(tmp_path / "jax"), **kw)
    stamps = dict(t=sim["t"] + 1000.0, mocap_t=sim["t"][::50] + 1000.0)
    _assert_datasets_equal(tds, jds, str(tmp_path / "port"),
                           str(tmp_path / "jax"), stamps)
    key = "foot_forces" if robot == "go1" else "contacts"
    src = "foot_forces" if robot == "go1" else "contacts"
    n = len(tds["t"])
    np.testing.assert_allclose(tds[key][:n], sim[src][:n], atol=1e-9)
    assert tds["meta"]["contact_kind"] == ("force" if robot == "go1"
                                           else "flag")
    if robot == "a1":
        assert len(tds["image_paths"]) == 3 and tds["image_paths"][0][1]
    print(f"PORT_DIFF convert_rosbag[{robot}] {n} samples, "
          f"{len(tds.get('image_paths', []))} images: equal (exact)")


def test_convert_euroc_matches_jax(tmp_path):
    root = tmp_path / "euroc"
    imu_dir = root / "mav0" / "imu0"
    cam0 = root / "mav0" / "cam0"
    gt = root / "mav0" / "state_groundtruth_estimate0"
    for d in (imu_dir, cam0 / "data", gt):
        os.makedirs(d)
    t_ns = (1.4e18 + np.arange(400) * 5e6).astype(np.int64)
    rng = np.random.default_rng(2)
    rows = np.column_stack([t_ns, rng.normal(scale=0.1, size=(400, 3)),
                            rng.normal(size=(400, 3)) + [0, 0, 9.8]])
    np.savetxt(imu_dir / "data.csv", rows, delimiter=",",
               header="t,wx,wy,wz,ax,ay,az", fmt="%d" + ",%.9f" * 6)
    with open(cam0 / "data.csv", "w") as f:
        f.write("t,filename\n")
        for k in range(0, 400, 10):
            f.write(f"{t_ns[k]},{k:06d}.png\n")
    gtr = np.column_stack([t_ns[::5], np.cumsum(np.ones((80, 3)) * 1e-3,
                                                axis=0),
                           np.tile([1.0, 0, 0, 0], (80, 1))])
    np.savetxt(gt / "data.csv", gtr, delimiter=",",
               header="t,px,py,pz,qw,qx,qy,qz", fmt="%d" + ",%.9f" * 7)
    tds = tla.convert_euroc(str(root), str(tmp_path / "port"))
    jds = jla.convert_euroc(str(root), str(tmp_path / "jax"))
    assert tds["image_paths"] == jds["image_paths"]   # absolute, in place
    tds.pop("image_paths"), jds.pop("image_paths")
    t0 = t_ns[0].astype(float) * 1e-9
    stamps = dict(t=t_ns.astype(float) * 1e-9 - t0,
                  mocap_t=t_ns[::5].astype(float) * 1e-9 - t0)
    _assert_datasets_equal(tds, jds, str(tmp_path / "port"),
                           str(tmp_path / "jax"), stamps)
    assert len(tds["t"]) == 400 and len(tds["cam_t"]) == 40
    print("PORT_DIFF convert_euroc 400 samples, 40 images: equal (exact)")


def test_unix_epoch_bag_converts_and_replays(tmp_path, sim):
    """A bag stamped at a Unix epoch (1.6e9 s, where a float64 second has a
    spacing of 2.4e-7 s): the converted dataset's sample and mocap clocks
    keep the stamps, and its replay (proprioception only, max_features =
    48, max_num_iterations = 4, 16 frames) goes as the same bag's stamped at
    1000 s: the same frames published and solves. The replay puts the
    window on a 15 Hz keyframe clock that it makes with np.arange from the
    first sample, whose rounding at 1.6e9 s can land a frame one 2 ms
    sample earlier: frame times are held within one sample, positions
    within 2e-3 m (1 mm a sample at 0.5 m/s, twice) and the ATE within
    1e-3 m. With the t column written at 9 significant digits the samples
    share 10 s steps and nothing replays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, epoch in (("epoch", 1.6e9), ("1000s", 1000.0)):
            bag = tmp_path / f"{name}.bag"
            _sim_to_bag(sim, bag, epoch=epoch)
            ds = tla.convert_rosbag(str(bag), str(tmp_path / name))
            stamps = sim["t"] + epoch
            np.testing.assert_allclose(ds["t"], stamps, rtol=0, atol=5e-7)
            np.testing.assert_allclose(ds["mocap_t"], stamps[::50], rtol=0,
                                       atol=5e-7)
            est = Estimator(dataclasses.replace(
                EstimatorConfig(), max_features=48, max_num_iterations=4),
                device="cpu")
            out[name] = replay(ds, est=est, max_frames=16)
            out[name]["est_t"] = np.asarray(out[name]["est_t"]) - epoch
    finally:
        torch.set_num_threads(n)
    got, want = out["epoch"], out["1000s"]
    assert len(got["est_t"]) == len(want["est_t"]) >= 5
    assert got["estimator"].stats["solves"] == \
        want["estimator"].stats["solves"] > 0
    np.testing.assert_allclose(got["est_t"], want["est_t"], rtol=0,
                               atol=2e-3 + 5e-7)
    diff = np.abs(np.asarray(got["est_p"]) - np.asarray(want["est_p"]))
    print(f"PORT_DIFF unix-epoch bag replay vs 1000 s bag "
          f"({len(got['est_t'])} frames) est_p max_abs={diff.max():.3e}, "
          f"ate_rmse {got['ate_rmse']:.6f} vs {want['ate_rmse']:.6f} m")
    assert diff.max() < 2e-3
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 1e-3


def test_write_png_gray_decodes(tmp_path):
    """_write_png_gray's PNG (cv2 where present, else its own encoder)
    decodes to the image it was given."""
    cv2 = pytest.importorskip("cv2")
    im = np.random.default_rng(1).integers(0, 255, size=(24, 32)).astype(
        np.uint8)
    tla._write_png_gray(str(tmp_path / "a.png"), im)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_GRAYSCALE), im)
