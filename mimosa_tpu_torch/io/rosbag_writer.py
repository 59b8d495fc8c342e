"""Minimal ROS1 bag (v2.0) writer — enough to record sensor streams and
results that the reader (io/rosbag.py) and any rosbag tool can replay.

Covers the reference's result-bag recorder role
(ref launch/enwide_rosbag.launch:26) and lets the synthetic generator
produce real .bag files so the production CLI path
(bag -> decode -> sequencer -> TUM) is testable without datasets. The
port's copy of ``mimosa_tpu/io/rosbag_writer.py``: the same bytes for the
same data.
"""

from __future__ import annotations

import struct

import numpy as np

from mimosa_tpu_torch.io.pointcloud2 import Field, structured_view

_OUSTER_FIELDS = [Field("x", 0, 7), Field("y", 4, 7), Field("z", 8, 7),
                  Field("intensity", 16, 7), Field("t", 20, 6),
                  Field("reflectivity", 24, 4), Field("ring", 26, 4)]
_OUSTER_STEP = 32


def _field(name: bytes, value: bytes) -> bytes:
    body = name + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) \
        + data


def _stamp(t: float) -> bytes:
    s = int(t)
    return struct.pack("<II", s, int(round((t - s) * 1e9)))


def _header(t: float, frame: str = "") -> bytes:
    fb = frame.encode()
    return struct.pack("<I", 0) + _stamp(t) + struct.pack("<I", len(fb)) + fb


def serialize_imu(t, acc, gyro):
    b = _header(t, "imu")
    b += struct.pack("<4d", 0, 0, 0, 1) + struct.pack("<9d", *([0.0] * 9))
    b += struct.pack("<3d", *gyro) + struct.pack("<9d", *([0.0] * 9))
    b += struct.pack("<3d", *acc) + struct.pack("<9d", *([0.0] * 9))
    return b


def serialize_ouster_cloud(t, points, intensity, t_rel_s, ring=None):
    """points [N,3] f32, t_rel_s [N] seconds -> PointCloud2 (ouster layout)."""
    n = len(points)
    data = np.zeros(n * _OUSTER_STEP, np.uint8)
    v = structured_view(data, _OUSTER_FIELDS, _OUSTER_STEP)
    pts = np.nan_to_num(np.asarray(points, np.float32))
    v["x"], v["y"], v["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    v["intensity"] = np.asarray(intensity, np.float32)
    v["t"] = np.clip(np.asarray(t_rel_s) * 1e9, 0, 2**32 - 1).astype(
        np.uint32)
    v["ring"] = (np.zeros(n) if ring is None else ring).astype(np.uint16)

    b = _header(t, "os_lidar")
    b += struct.pack("<II", 1, n)
    b += struct.pack("<I", len(_OUSTER_FIELDS))
    for f in _OUSTER_FIELDS:
        nb = f.name.encode()
        b += struct.pack("<I", len(nb)) + nb
        b += struct.pack("<IBI", f.offset, f.datatype, f.count)
    b += struct.pack("<B", 0)
    b += struct.pack("<II", _OUSTER_STEP, _OUSTER_STEP * n)
    b += struct.pack("<I", len(data)) + data.tobytes()
    b += struct.pack("<B", 1)
    return b


def serialize_radar_rio(t, points_r, doppler, snr_db=None, noise_db=None):
    """Radar cloud in the rio point layout (x,y,z,snr_db,noise_db,
    v_doppler_mps — ref include/mimosa/radar/point.hpp:16-27). Takes points
    in the remapped radar frame the estimator consumes and writes the raw
    sensor axes (decode applies x,y,z <- y,-x,z, so we store the inverse)."""
    points_r = np.asarray(points_r, np.float32)
    n = len(points_r)
    doppler = np.asarray(doppler, np.float32)
    snr_db = (np.full(n, 20.0, np.float32) if snr_db is None
              else np.asarray(snr_db, np.float32))
    noise_db = (np.zeros(n, np.float32) if noise_db is None
                else np.asarray(noise_db, np.float32))
    raw = np.empty((n, 6), np.float32)
    raw[:, 0] = -points_r[:, 1]
    raw[:, 1] = points_r[:, 0]
    raw[:, 2] = points_r[:, 2]
    raw[:, 3] = snr_db
    raw[:, 4] = noise_db
    raw[:, 5] = doppler
    names = ["x", "y", "z", "snr_db", "noise_db", "v_doppler_mps"]
    b = _header(t, "radar")
    b += struct.pack("<II", 1, n)
    b += struct.pack("<I", len(names))
    for off, nm in zip(range(0, 24, 4), names):
        nb = nm.encode()
        b += struct.pack("<I", len(nb)) + nb
        b += struct.pack("<IBI", off, 7, 1)         # FLOAT32
    b += struct.pack("<B", 0)
    b += struct.pack("<II", 24, 24 * n)
    data = raw.tobytes()
    b += struct.pack("<I", len(data)) + data
    b += struct.pack("<B", 1)
    return b


def serialize_odometry(t, q_wxyz, p, cov6=None):
    b = _header(t, "odom")
    b += struct.pack("<I", 4) + b"base"
    q = np.asarray(q_wxyz, float)
    b += struct.pack("<7d", p[0], p[1], p[2], q[1], q[2], q[3], q[0])
    cov = np.zeros((6, 6)) if cov6 is None else np.asarray(cov6)
    b += struct.pack("<36d", *cov.reshape(-1))
    b += struct.pack("<6d", *([0.0] * 6))
    b += struct.pack("<36d", *np.zeros(36))
    return b


class BagWriter:
    """Append-only uncompressed ROS1 v2.0 bag writer."""

    _TYPES = {
        "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
        "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
        "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    }

    def __init__(self, path):
        self.f = open(path, "wb")
        self.f.write(b"#ROSBAG V2.0\n")
        self.f.write(_record({b"op": b"\x03",
                              b"index_pos": struct.pack("<Q", 0),
                              b"conn_count": struct.pack("<I", 0),
                              b"chunk_count": struct.pack("<I", 0)},
                             b"\x20" * 4096))
        self._conns = {}
        self._chunk = b""

    def _conn(self, topic, mtype):
        key = (topic, mtype)
        if key not in self._conns:
            cid = len(self._conns)
            self._conns[key] = cid
            self._chunk += _record(
                {b"op": b"\x07", b"conn": struct.pack("<I", cid),
                 b"topic": topic.encode()},
                _field(b"type", mtype.encode())
                + _field(b"md5sum", self._TYPES.get(mtype, "x").encode())
                + _field(b"message_definition", b""))
        return self._conns[key]

    def write(self, topic, mtype, t, body: bytes):
        cid = self._conn(topic, mtype)
        self._chunk += _record(
            {b"op": b"\x02", b"conn": struct.pack("<I", cid),
             b"time": _stamp(t)}, body)
        if len(self._chunk) > 4 * 1024 * 1024:
            self._flush()

    def _flush(self):
        if not self._chunk:
            return
        self.f.write(_record(
            {b"op": b"\x05", b"compression": b"none",
             b"size": struct.pack("<I", len(self._chunk))}, self._chunk))
        self._chunk = b""

    def close(self):
        self._flush()
        self.f.close()


def write_synthetic_bag(path, data, imu_topic="/imu", lidar_topic="/points",
                        radar_frames=None, radar_topic="/radar"):
    """Record a synthetic dataset (io/synthetic.generate output) as a bag.
    ``radar_frames``: optional io/synthetic.generate_radar output, written
    in the rio point layout."""
    w = BagWriter(path)
    events = [(t, "imu", k) for k, t in enumerate(data["imu"]["ts"])]
    for k, sc in enumerate(data["scans"]):
        # bag receipt time after the scan completes (sensor driver behavior)
        events.append((sc["ts_header"] + sc["t_rel"].max() + 0.01, "scan", k))
    for k, fr in enumerate(radar_frames or []):
        events.append((fr["ts"] + 0.005, "radar", k))
    events.sort(key=lambda e: e[0])
    imu = data["imu"]
    for t_rx, kind, k in events:
        if kind == "imu":
            w.write(imu_topic, "sensor_msgs/Imu", imu["ts"][k],
                    serialize_imu(imu["ts"][k], imu["acc"][k],
                                  imu["gyro"][k]))
        elif kind == "radar":
            fr = radar_frames[k]
            w.write(radar_topic, "sensor_msgs/PointCloud2", t_rx,
                    serialize_radar_rio(fr["ts"], fr["points"],
                                        fr["doppler"], fr.get("snr_db")))
        else:
            sc = data["scans"][k]
            pts = np.where(sc["valid"][:, None], sc["points"], np.nan)
            w.write(lidar_topic, "sensor_msgs/PointCloud2", t_rx,
                    serialize_ouster_cloud(sc["ts_header"], pts,
                                           sc.get("intensity",
                                                  np.zeros(len(pts))),
                                           sc["t_rel"]))
    w.close()
    return path
