"""Real-log ingestion: documented on-disk dataset schema + converters (the
port's own copy of `cerberus_tpu/data/log_adapter.py`; NumPy, and OpenCV
for image datasets).

The reference consumes rosbags via roslaunch replay (reference:
launch/dataset/run_street_bag_vilo.launch, topics README.md:114-128); the
bags themselves are not vendored (bags/put_rosbags_here.txt). This module
defines the framework's bag-independent dataset layout, an offline
converter API, and a loader producing the same dict `simulate()` emits, so
`replay()` / `replay_images()` run identically on logged data.

## Dataset directory schema (version 1)

    dataset/
      meta.json            {"version": 1, "robot": "a1"|"go1",
                            "imu_rate": 500.0, "cam_rate": 15.0,
                            "contact_kind": "flag"|"force"}
      imu_leg.csv          500 Hz fused proprioceptive stream, one row per
                           sample, 35 columns:
                             t, acc[3], gyr[3], phi[12], dphi[12], contact[4]
                           (joint order FL,FR,RL,RR x hip,thigh,calf —
                            reference main.cpp:262-278; contact columns hold
                            flags or raw foot forces per contact_kind)
      mocap.csv            optional ground truth: t, px, py, pz[, qw,qx,qy,qz]
                           (reference: /mocap_node topic, main.cpp:401-425)
      cam.csv              image index: t, path0, path1  (paths relative to
                           the dataset dir; path1 empty for mono)
      cam0/ cam1/          grayscale images referenced by cam.csv
      features.npz         optional precomputed tracks (offline front-end
                           output) with arrays: t (Nf,), ids (Nf, K) int64
                           -1-padded, pts (Nf, K, 3), vel (Nf, K, 2),
                           pts_r / vel_r (right cam; z<=0 marks no stereo)

Either cam.csv+images or features.npz must be present for vision.

The CSV columns of imu_leg.csv are EXACTLY the native SensorSync row layout
(native/sensor_sync.cpp kSampleDoubles) so converted logs stream through the
ring buffer without reshaping.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

SCHEMA_VERSION = 1
IMU_LEG_COLS = 35


def write_dataset(out_dir: str, t, acc, gyr, phi, dphi, contact,
                  cam_t=None, image_paths=None, mocap=None,
                  robot: str = "a1", imu_rate: float = 500.0,
                  cam_rate: float = 15.0, contact_kind: str = "flag"):
    """Write a schema-v1 dataset directory from packed arrays.

    This is the back half of any bag converter: decode your log with
    whatever reader you have (rosbags, a ROS environment, vendor SDK),
    then hand the arrays here.
    """
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(dict(version=SCHEMA_VERSION, robot=robot,
                       imu_rate=imu_rate, cam_rate=cam_rate,
                       contact_kind=contact_kind), f)
    rows = np.column_stack([np.asarray(t)[:, None], acc, gyr, phi, dphi,
                            contact])
    assert rows.shape[1] == IMU_LEG_COLS, rows.shape
    # the t column at 1e-9 s, as cam.csv's: "%.9g" would keep 9 digits of
    # a Unix-epoch stamp (~1.6e9 s), i.e. 10 s steps
    np.savetxt(os.path.join(out_dir, "imu_leg.csv"), rows, delimiter=",",
               fmt=["%.9f"] + ["%.9g"] * (rows.shape[1] - 1))
    if mocap is not None:
        mocap = np.asarray(mocap)
        np.savetxt(os.path.join(out_dir, "mocap.csv"), mocap, delimiter=",",
                   fmt=["%.9f"] + ["%.9g"] * (mocap.shape[1] - 1))
    if cam_t is not None:
        with open(os.path.join(out_dir, "cam.csv"), "w", newline="") as f:
            w = csv.writer(f)
            for i, tc in enumerate(cam_t):
                p0, p1 = image_paths[i] if image_paths else ("", "")
                w.writerow([f"{tc:.9f}", p0, p1])


def load_dataset(path: str) -> dict:
    """Load a schema-v1 dataset into the replay dict format (same keys as
    data.simulator.simulate where applicable; images lazy-loaded)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != SCHEMA_VERSION:
        raise ValueError(f"unsupported dataset version {meta.get('version')}")
    rows = np.loadtxt(os.path.join(path, "imu_leg.csv"), delimiter=",",
                      ndmin=2)
    if rows.shape[1] != IMU_LEG_COLS:
        raise ValueError(f"imu_leg.csv must have {IMU_LEG_COLS} columns, "
                         f"got {rows.shape[1]}")
    out = dict(
        t=rows[:, 0], acc=rows[:, 1:4], gyr=rows[:, 4:7],
        phi=rows[:, 7:19], dphi=rows[:, 19:31],
        contacts=rows[:, 31:35], foot_forces=rows[:, 31:35],
        meta=meta,
    )
    mocap_p = os.path.join(path, "mocap.csv")
    if os.path.exists(mocap_p):
        m = np.loadtxt(mocap_p, delimiter=",", ndmin=2)
        out["mocap_t"] = m[:, 0]
        out["mocap_p"] = m[:, 1:4]
        if m.shape[1] >= 8:
            out["mocap_q"] = m[:, 4:8]
        # ground truth resampled onto the sensor clock for scoring
        out["p"] = np.column_stack([
            np.interp(out["t"], m[:, 0], m[:, 1 + i]) for i in range(3)])
    cam_p = os.path.join(path, "cam.csv")
    if os.path.exists(cam_p):
        cam_t, paths = [], []
        with open(cam_p, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                cam_t.append(float(row[0]))
                paths.append((row[1], row[2] if len(row) > 2 else ""))
        out["cam_t"] = np.asarray(cam_t)
        out["image_paths"] = [
            tuple(os.path.join(path, p) if p else "" for p in pp)
            for pp in paths]
        # nearest sensor-sample index per image (replay keys on cam_idx)
        out["cam_idx"] = np.searchsorted(out["t"], out["cam_t"])
        out["cam_idx"] = np.clip(out["cam_idx"], 0, len(out["t"]) - 1)
    feat_p = os.path.join(path, "features.npz")
    if os.path.exists(feat_p):
        z = np.load(feat_p)
        frames = []
        for fi in range(len(z["t"])):
            frame = {}
            for k in range(z["ids"].shape[1]):
                fid = int(z["ids"][fi, k])
                if fid < 0:
                    continue
                pt_r = z["pts_r"][fi, k]
                frame[fid] = (z["pts"][fi, k], z["vel"][fi, k],
                              pt_r if pt_r[2] > 0 else None,
                              z["vel_r"][fi, k])
            frames.append(frame)
        out["features"] = frames
        if "cam_t" not in out:
            out["cam_t"] = z["t"]
            out["cam_idx"] = np.clip(
                np.searchsorted(out["t"], z["t"]), 0, len(out["t"]) - 1)
    return out


class ImageLoader:
    """Renderer-shaped adapter over on-disk images: replay_images() accepts
    it in place of ImageRenderer (duck-typed: render_stereo + f/cx/cy/W/H)."""

    def __init__(self, ds: dict, focal: float, cx: float, cy: float):
        try:
            import cv2
        except Exception as e:  # pragma: no cover
            raise RuntimeError("image datasets require OpenCV") from e
        self._cv2 = cv2
        self.ds = ds
        self.f, self.cx, self.cy = focal, cx, cy
        first = ds["image_paths"][0][0]
        im = cv2.imread(first, cv2.IMREAD_GRAYSCALE)
        if im is None:
            raise FileNotFoundError(first)
        self.H, self.W = im.shape
        self._by_idx = {int(k): i for i, k in enumerate(ds["cam_idx"])}

    def render_stereo(self, k: int):
        i = self._by_idx[int(k)]
        p0, p1 = self.ds["image_paths"][i]
        im0 = self._cv2.imread(p0, self._cv2.IMREAD_GRAYSCALE)
        im1 = self._cv2.imread(p1, self._cv2.IMREAD_GRAYSCALE) if p1 else None
        return im0, im1


# reference A1 hardware topic set
# (config/a1_config/hardware_a1_vilo_config.yaml:8-23, main.cpp:454-470)
A1_TOPICS = dict(
    imu="/hardware_a1/imu",
    leg="/hardware_a1/joint_foot",
    image0="/camera_forward/infra1/image_rect_raw",
    image1="/camera_forward/infra2/image_rect_raw",
    mocap="/mocap_node/Robot_1/pose",
)

GO1_TOPICS = dict(A1_TOPICS, imu="/hardware_go1/imu",
                  leg="/hardware_go1/joint_foot")


def convert_rosbag(bag_path: str, out_dir: str, topics: dict | None = None,
                   robot: str = "a1", contact_kind: str | None = None,
                   sync_tol: float = 0.003, write_images: bool = True):
    """Offline ROS1 bag -> schema-v1 dataset converter (pure Python, no ROS;
    container+message codecs in data/rosbag.py).

    Mirrors the reference's live ingestion: IMU and joint messages are
    ApproximateTime-paired (main.cpp:462-470 — the reference notes they
    "actually [have] the same time stamp"); the JointState layout is
    position[0:12]/velocity[0:12] joints, velocity[12:16] planned contact
    flags, effort[12:16] foot-force readings (main.cpp:262-278). The stored
    contact[4] column follows contact_kind: "flag" keeps the planned
    contacts (A1, contact_sensor_type 1), "force" keeps foot forces (Go1,
    contact_sensor_type 2, go1 yaml:29).

    topics: override any of the A1_TOPICS keys. Returns the loaded dataset.
    """
    from cerberus_tpu_torch.data.rosbag import read_messages

    tm = dict(GO1_TOPICS if robot == "go1" else A1_TOPICS)
    tm.update(topics or {})
    if contact_kind is None:
        contact_kind = "force" if robot == "go1" else "flag"
    topic_kinds = {tm["imu"]: "sensor_msgs/Imu",
                   tm["leg"]: "sensor_msgs/JointState",
                   tm["mocap"]: "geometry_msgs/PoseStamped"}
    if write_images:
        topic_kinds[tm["image0"]] = "sensor_msgs/Image"
        topic_kinds[tm["image1"]] = "sensor_msgs/Image"

    imu_rows, leg_rows, mocap_rows = [], [], []
    cam0, cam1 = [], []
    os.makedirs(out_dir, exist_ok=True)
    img_idx = [0, 0]
    for topic, stamp, msg in read_messages(bag_path, topic_kinds):
        if topic == tm["imu"]:
            imu_rows.append((msg.stamp, msg.acc, msg.gyr))
        elif topic == tm["leg"]:
            pos = np.asarray(msg.position)
            vel = np.asarray(msg.velocity)
            eff = np.asarray(msg.effort)
            contact = (eff[12:16] if contact_kind == "force"
                       else vel[12:16]) if len(vel) >= 16 else np.zeros(4)
            leg_rows.append((msg.stamp, pos[:12], vel[:12], contact))
        elif topic == tm["mocap"]:
            q = msg.q  # ROS xyzw -> wxyz
            mocap_rows.append((msg.stamp, *msg.p, q[3], q[0], q[1], q[2]))
        else:
            side = 0 if topic == tm["image0"] else 1
            sub = f"cam{side}"
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
            rel = os.path.join(sub, f"{img_idx[side]:06d}.png")
            img_idx[side] += 1
            _write_png_gray(os.path.join(out_dir, rel), msg.data)
            (cam0 if side == 0 else cam1).append((msg.stamp, rel))

    if not imu_rows or not leg_rows:
        raise ValueError(f"bag has no messages on {tm['imu']} / {tm['leg']}")

    # ApproximateTime pairing on the IMU clock
    leg_t = np.array([r[0] for r in leg_rows])
    t, acc, gyr, phi, dphi, contact = [], [], [], [], [], []
    for ts, a, g in imu_rows:
        j = int(np.argmin(np.abs(leg_t - ts)))
        if abs(leg_t[j] - ts) > sync_tol:
            continue
        t.append(ts)
        acc.append(a)
        gyr.append(g)
        phi.append(leg_rows[j][1])
        dphi.append(leg_rows[j][2])
        contact.append(leg_rows[j][3])
    if not t:
        raise ValueError(f"no IMU/joint pairs within {sync_tol}s")

    # stereo pairing within the reference's 3 ms tolerance (main.cpp:105-131)
    cam_t, image_paths = [], []
    if cam0:
        c1t = np.array([r[0] for r in cam1]) if cam1 else None
        for ts, p0 in cam0:
            p1 = ""
            if c1t is not None and len(c1t):
                j = int(np.argmin(np.abs(c1t - ts)))
                if abs(c1t[j] - ts) <= 0.003:
                    p1 = cam1[j][1]
            cam_t.append(ts)
            image_paths.append((p0, p1))

    dt_med = float(np.median(np.diff(t))) if len(t) > 1 else 0.002
    write_dataset(
        out_dir, np.asarray(t), np.asarray(acc), np.asarray(gyr),
        np.asarray(phi), np.asarray(dphi), np.asarray(contact),
        cam_t=np.asarray(cam_t) if cam_t else None,
        image_paths=image_paths or None,
        mocap=np.asarray(mocap_rows) if mocap_rows else None,
        robot=robot, imu_rate=1.0 / max(dt_med, 1e-6),
        cam_rate=(len(cam_t) / (cam_t[-1] - cam_t[0])
                  if len(cam_t) > 1 else 15.0),
        contact_kind=contact_kind)
    return load_dataset(out_dir)


def convert_euroc(euroc_dir: str, out_dir: str, use_groundtruth: bool = True):
    """EuRoC-MAV ASL directory -> schema-v1 dataset (vision+IMU mode: the
    estimator runs with use_leg_odom=False, the reference's VINS-Fusion
    baseline configuration, launch/hardware_a1/hardware_a1_vins.launch).

    Expects the standard layout: mav0/imu0/data.csv (t[ns], gyro xyz,
    acc xyz), mav0/cam{0,1}/data.csv + data/*.png, and optionally
    mav0/state_groundtruth_estimate0/data.csv (t[ns], p, q_wxyz, ...).
    Image paths are referenced in place (absolute), not copied.
    """
    mav = os.path.join(euroc_dir, "mav0")
    imu = np.loadtxt(os.path.join(mav, "imu0", "data.csv"), delimiter=",",
                     skiprows=1, ndmin=2)
    t0 = imu[0, 0] * 1e-9
    t = imu[:, 0] * 1e-9 - t0
    gyr = imu[:, 1:4]
    acc = imu[:, 4:7]
    n = len(t)
    z12 = np.zeros((n, 12))
    z4 = np.zeros((n, 4))

    def read_cam(side):
        p = os.path.join(mav, f"cam{side}", "data.csv")
        if not os.path.exists(p):
            return []
        out = []
        with open(p) as f:
            next(f)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                ts = float(parts[0]) * 1e-9 - t0
                out.append((ts, os.path.abspath(
                    os.path.join(mav, f"cam{side}", "data", parts[1]))))
        return out

    c0, c1 = read_cam(0), read_cam(1)
    cam_t, image_paths = [], []
    c1t = np.array([r[0] for r in c1]) if c1 else None
    for ts, p0 in c0:
        p1 = ""
        if c1t is not None and len(c1t):
            j = int(np.argmin(np.abs(c1t - ts)))
            if abs(c1t[j] - ts) <= 0.003:
                p1 = c1[j][1]
        cam_t.append(ts)
        image_paths.append((p0, p1))

    mocap = None
    gt_p = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if use_groundtruth and os.path.exists(gt_p):
        gt = np.loadtxt(gt_p, delimiter=",", skiprows=1, ndmin=2)
        mocap = np.column_stack([gt[:, 0] * 1e-9 - t0, gt[:, 1:4],
                                 gt[:, 4:8]])

    dt_med = float(np.median(np.diff(t))) if n > 1 else 0.005
    write_dataset(out_dir, t, acc, gyr, z12, z12, z4,
                  cam_t=np.asarray(cam_t) if cam_t else None,
                  image_paths=image_paths or None, mocap=mocap,
                  robot="euroc", imu_rate=1.0 / max(dt_med, 1e-6),
                  cam_rate=(len(cam_t) / (cam_t[-1] - cam_t[0])
                            if len(cam_t) > 1 else 20.0),
                  contact_kind="flag")
    return load_dataset(out_dir)


def _write_png_gray(path: str, img: np.ndarray):
    """Write a grayscale PNG (cv2 when available, else a minimal pure-python
    PNG encoder — 8-bit grayscale, zlib-deflated scanlines)."""
    try:
        import cv2
        cv2.imwrite(path, img)
        return
    except Exception:
        pass
    import struct as _st
    import zlib

    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].astype(np.uint8).tobytes()
                   for r in range(h))

    def chunk(tag, data):
        c = _st.pack(">I", len(data)) + tag + data
        return c + _st.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = _st.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
