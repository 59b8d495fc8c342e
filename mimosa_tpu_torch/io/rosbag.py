"""Minimal pure-Python ROS1 bag (v2.0) reader.

Replaces the reference's rosbag replay input layer (reference
src/mimosa_rosbag.cpp:49-247) without any ROS dependency: sequentially
parses record headers, decompresses chunks (none/bz2/lz4), and
deserializes the three message types the estimator consumes —
sensor_msgs/Imu, sensor_msgs/PointCloud2 (lidar + radar clouds),
nav_msgs/Odometry. Messages are yielded in chunk order; use
``read_sorted`` for global time order (the deterministic-replay
requirement). The port's copy of ``mimosa_tpu/io/rosbag.py``.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator

import numpy as np

from mimosa_tpu_torch.io.pointcloud2 import Field

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_IDX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07


def _parse_header(buf: bytes) -> dict:
    out = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        field = buf[i : i + flen]
        i += flen
        k, _, v = field.partition(b"=")
        out[k.decode()] = v
    return out


def _records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    i = 0
    n = len(buf)
    while i + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        hdr = _parse_header(buf[i : i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i : i + dlen]
        i += dlen
        yield hdr, data


class _Reader:
    """Cursor over a serialized ROS message body."""

    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def u8(self):
        v = self.b[self.i]
        self.i += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.b, self.i)
        self.i += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.b, self.i)
        self.i += 8 * n
        return v if n > 1 else v[0]

    def string(self):
        n = self.u32()
        s = self.b[self.i : self.i + n]
        self.i += n
        return s.decode(errors="replace")

    def raw(self, n):
        s = self.b[self.i : self.i + n]
        self.i += n
        return s

    def header(self):
        seq = self.u32()
        secs = self.u32()
        nsecs = self.u32()
        frame = self.string()
        return dict(seq=seq, stamp=secs + nsecs * 1e-9, frame_id=frame)


def parse_imu(body: bytes) -> dict:
    r = _Reader(body)
    h = r.header()
    quat = r.f64(4)            # x y z w
    r.f64(9)
    gyro = np.asarray(r.f64(3))
    r.f64(9)
    acc = np.asarray(r.f64(3))
    return dict(stamp=h["stamp"], frame_id=h["frame_id"], gyro=gyro, acc=acc,
                quat=np.asarray(quat))


def parse_pointcloud2(body: bytes) -> dict:
    r = _Reader(body)
    h = r.header()
    height = r.u32()
    width = r.u32()
    nf = r.u32()
    fields = []
    for _ in range(nf):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append(Field(name, offset, datatype, count))
    is_bigendian = r.u8()
    point_step = r.u32()
    row_step = r.u32()
    nd = r.u32()
    data = r.raw(nd)
    return dict(stamp=h["stamp"], frame_id=h["frame_id"], height=height,
                width=width, fields=fields, is_bigendian=bool(is_bigendian),
                point_step=point_step, row_step=row_step, data=data)


def parse_odometry(body: bytes) -> dict:
    r = _Reader(body)
    h = r.header()
    child = r.string()
    px, py, pz, qx, qy, qz, qw = r.f64(7)
    pose_cov = np.asarray(r.f64(36)).reshape(6, 6)
    twist = np.asarray(r.f64(6))
    twist_cov = np.asarray(r.f64(36)).reshape(6, 6)
    return dict(stamp=h["stamp"], frame_id=h["frame_id"], child_frame=child,
                p=np.asarray([px, py, pz]),
                q=np.asarray([qw, qx, qy, qz]),   # to w-first
                pose_cov=pose_cov, twist=twist, twist_cov=twist_cov)


_PARSERS = {
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "nav_msgs/Odometry": parse_odometry,
}


class Bag:
    """Sequential ROS1 v2.0 bag reader."""

    def __init__(self, path):
        self.path = path

    def messages(self, topics=None, parse=True):
        """Yield (topic, msg_type, t, payload) in storage order.

        payload is the parsed dict for known types (or raw bytes when
        ``parse`` is False / type unknown).
        """
        conns = {}
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a ROS1 v2.0 bag: {self.path}")
            raw = f.read()

        def handle(hdr, data):
            op = hdr["op"][0]
            if op == _OP_CONN:
                sub = _parse_header(data)
                cid = struct.unpack("<I", hdr["conn"])[0]
                conns[cid] = dict(topic=hdr["topic"].decode(),
                                  type=sub.get("type", b"").decode())
            elif op == _OP_MSG:
                cid = struct.unpack("<I", hdr["conn"])[0]
                secs, nsecs = struct.unpack("<II", hdr["time"])
                c = conns.get(cid, {})
                topic = c.get("topic", "?")
                mtype = c.get("type", "?")
                if topics and topic not in topics:
                    return None
                if parse and mtype in _PARSERS:
                    return topic, mtype, secs + nsecs * 1e-9, \
                        _PARSERS[mtype](data)
                return topic, mtype, secs + nsecs * 1e-9, data
            return None

        for hdr, data in _records(raw):
            op = hdr["op"][0]
            if op == _OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "bz2":
                    payload = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame
                        payload = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise RuntimeError(
                            "bag uses lz4 chunks but lz4 is unavailable") \
                            from e
                else:
                    payload = data
                for h2, d2 in _records(payload):
                    out = handle(h2, d2)
                    if out is not None:
                        yield out
            else:
                out = handle(hdr, data)
                if out is not None:
                    yield out

    def read_sorted(self, topics=None):
        """All matching messages sorted by receipt time (deterministic
        replay order, ref mimosa_rosbag single-threaded dispatch)."""
        return sorted(self.messages(topics), key=lambda m: m[2])

    def topic_info(self):
        info = {}
        for topic, mtype, t, _ in self.messages(parse=False):
            d = info.setdefault(topic, dict(type=mtype, count=0,
                                            t0=t, t1=t))
            d["count"] += 1
            d["t1"] = max(d["t1"], t)
            d["t0"] = min(d["t0"], t)
        return info
