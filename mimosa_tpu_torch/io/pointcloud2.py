"""PointCloud2-style binary decoding with point-format auto-detection.

Replaces the reference's PCL ingestion (reference include/mimosa/lidar/
utils.hpp:49-181 ``decodePointType``/``toPcl`` and the 10 registered point
structs in include/mimosa/lidar/point.hpp:18-178). A cloud arrives as raw
bytes + field descriptors (name, offset, datatype, count) + point_step —
exactly sensor_msgs/PointCloud2 — and decodes into columnar numpy arrays
(x, y, z, intensity, t_rel seconds, ring) with per-format timestamp
semantics:

| format            | match (beyond x,y,z)                  | time field |
|-------------------|---------------------------------------|------------|
| ouster            | intensity,u32 t,reflectivity,u16 ring | t ns rel   |
| ouster_odyssey    | u32 t,reflectivity,near_ir            | t ns rel   |
| ouster_r8         | intensity,u32 t,reflectivity,u8 ring  | t ns rel   |
| hesai             | intensity,f64 timestamp,u16 ring      | abs unix s |
| livox             | intensity,tag,line,f64 timestamp      | abs ns     |
| livox_custom2     | u32 t,intensity,tag,line              | t ns rel   |
| velodyne          | intensity,u16 ring,f32 time           | rel s      |
| velodyne_anybotics| intensity,f32 ring,f32 time           | rel s      |
| rslidar           | intensity,u16 ring,f64 timestamp      | abs unix s |
| internal          | intensity,u32 t,u32 idx,range         | t ns rel   |

The port's copy of ``mimosa_tpu/io/pointcloud2.py`` (pure numpy). The fused
C++ decode + filter pass is ``mimosa_tpu_torch.native.decode_filtered``
(same output contract); this module is its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# sensor_msgs/PointField datatype codes
_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
           5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    offset: int
    datatype: int   # PointField code
    count: int = 1


def _sig(fields):
    return {f.name: _DTYPES[f.datatype] for f in fields}


_FORMATS = [
    ("ouster", {"intensity": np.float32, "t": np.uint32,
                "reflectivity": np.uint16, "ring": np.uint16}),
    ("ouster_r8", {"intensity": np.float32, "t": np.uint32,
                   "reflectivity": np.uint16, "ring": np.uint8}),
    ("ouster_odyssey", {"t": np.uint32, "reflectivity": np.uint16,
                        "near_ir": np.uint16}),
    ("hesai", {"intensity": np.float32, "timestamp": np.float64,
               "ring": np.uint16}),
    ("livox", {"intensity": np.float32, "tag": np.uint8, "line": np.uint8,
               "timestamp": np.float64}),
    ("livox_custom2", {"t": np.uint32, "intensity": np.float32,
                       "tag": np.uint8, "line": np.uint8}),
    ("velodyne", {"intensity": np.float32, "ring": np.uint16,
                  "time": np.float32}),
    ("velodyne_anybotics", {"intensity": np.float32, "ring": np.float32,
                            "time": np.float32}),
    ("rslidar", {"intensity": np.float32, "ring": np.uint16,
                 "timestamp": np.float64}),
    ("internal", {"intensity": np.float32, "t": np.uint32,
                  "idx": np.uint32, "range": np.float32}),
    # radar formats (ref include/mimosa/radar/point.hpp:16-39)
    ("radar_rio", {"snr_db": np.float32, "noise_db": np.float32,
                   "v_doppler_mps": np.float32}),
    ("radar_mmwave_res", {"intensity": np.float32, "velocity": np.float32,
                          "doppler_residual": np.float32}),
    ("radar_mmwave", {"intensity": np.float32, "velocity": np.float32}),
]


def detect_format(fields) -> str:
    """Field-matching format detection (ref lidar/utils.hpp:49-88)."""
    sig = _sig(fields)
    for name, req in _FORMATS:
        if all(k in sig and sig[k] == np.dtype(v) for k, v in req.items()):
            return name
    raise ValueError(f"unknown point format with fields {sorted(sig)}")


def structured_view(data: bytes | np.ndarray, fields, point_step: int):
    """Zero-copy structured-array view of the raw cloud buffer."""
    names, formats, offsets = [], [], []
    for f in fields:
        names.append(f.name)
        base = _DTYPES[f.datatype]
        formats.append((base, (f.count,)) if f.count > 1 else base)
        offsets.append(f.offset)
    dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                   "itemsize": point_step})
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.view(np.uint8).reshape(-1)
    n = len(buf) // point_step
    return buf[: n * point_step].view(dt)


def decode(data, fields, point_step, header_stamp=0.0, fmt=None,
           use_reflectivity=False):
    """Decode raw cloud bytes into columnar arrays.

    Returns dict(points [N,3] f32, intensity [N] f32, t_rel [N] f64 seconds
    relative to header_stamp, ring [N] i32 (-1 if absent), fmt).
    ``use_reflectivity`` prefers the reflectivity field over intensity when
    both exist (ref lidar/manager use_reflectivity_as_intensity).
    """
    fmt = fmt or detect_format(fields)
    v = structured_view(data, fields, point_step)
    n = len(v)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)

    names = v.dtype.names
    if use_reflectivity and "reflectivity" in names:
        inten = v["reflectivity"].astype(np.float32)
    elif "intensity" in names:
        inten = v["intensity"].astype(np.float32)
    elif fmt == "ouster_odyssey":
        inten = v["reflectivity"].astype(np.float32)
    else:
        inten = np.zeros(n, np.float32)

    if fmt in ("ouster", "ouster_r8", "ouster_odyssey", "livox_custom2",
               "internal"):
        t_rel = v["t"].astype(np.float64) * 1e-9
    elif fmt == "livox":
        t_rel = v["timestamp"].astype(np.float64) * 1e-9 - header_stamp
    elif fmt in ("hesai", "rslidar"):
        t_rel = v["timestamp"].astype(np.float64) - header_stamp
    elif fmt in ("velodyne", "velodyne_anybotics"):
        t_rel = v["time"].astype(np.float64)
    else:
        t_rel = np.zeros(n)

    if "ring" in v.dtype.names:
        ring = v["ring"].astype(np.int32)
    elif "line" in v.dtype.names:
        ring = v["line"].astype(np.int32)
    else:
        ring = np.full(n, -1, np.int32)

    return dict(points=pts, intensity=inten, t_rel=t_rel, ring=ring, fmt=fmt)


def time_base(fmt, header_stamp=0.0):
    """Per-format time decode base: (t_scale, t_offset) such that
    ``t_rel = raw * t_scale - t_offset`` reproduces :func:`decode`'s
    header-relative seconds (the native fused decode takes these as
    scalars instead of branching per format)."""
    if fmt in ("ouster", "ouster_r8", "ouster_odyssey", "livox_custom2",
               "internal"):
        return 1e-9, 0.0
    if fmt == "livox":
        return 1e-9, float(header_stamp)
    if fmt in ("hesai", "rslidar"):
        return 1.0, float(header_stamp)
    if fmt in ("velodyne", "velodyne_anybotics"):
        return 1.0, 0.0
    return 0.0, 0.0


def decode_radar(data, fields, point_step):
    """Decode a radar cloud (rio / mmWave formats). Returns dict(points
    [N,3], doppler [N], snr_db [N]). The rio format gets the reference's
    axis remap x,y,z <- y,-x,z and snr as intensity
    (ref src/radar/manager.cpp:111-134)."""
    fmt = detect_format(fields)
    v = structured_view(data, fields, point_step)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    if fmt == "radar_rio":
        pts = np.stack([v["y"], -np.asarray(v["x"]), v["z"]],
                       -1).astype(np.float32)
        return dict(points=pts, doppler=v["v_doppler_mps"].astype(np.float64),
                    snr_db=v["snr_db"].astype(np.float64), fmt=fmt)
    if fmt in ("radar_mmwave", "radar_mmwave_res"):
        return dict(points=xyz, doppler=v["velocity"].astype(np.float64),
                    snr_db=v["intensity"].astype(np.float64), fmt=fmt)
    raise ValueError(f"not a radar format: {fmt}")


def point_filters(points, intensity, ring, range_min=0.2, range_max=100.0,
                  intensity_min=0.0, intensity_max=1e10, point_skip=1,
                  ring_skip=1, t_rel=None, t_rel_max=None, livox_tag=None):
    """Per-point validity chain (ref lidar/manager.cpp:244-335): finite,
    range window, intensity window, index/ring skip divisors, and the
    Livox tag gate ``(tag & 0x30) in {0x00, 0x10}`` when tags are given."""
    n = len(points)
    finite = np.isfinite(points).all(-1)
    if livox_tag is not None:
        t30 = np.asarray(livox_tag).astype(np.int32) & 0x30
        finite = finite & ((t30 == 0x10) | (t30 == 0x00))
    rng = np.linalg.norm(np.nan_to_num(points), axis=-1)
    ok = (finite & (rng >= range_min) & (rng <= range_max)
          & (intensity >= intensity_min) & (intensity <= intensity_max))
    if point_skip > 1:
        ok &= (np.arange(n) % point_skip) == 0
    if ring_skip > 1:
        ok &= (np.maximum(ring, 0) % ring_skip) == 0
    if t_rel is not None and t_rel_max is not None:
        ok &= t_rel <= t_rel_max
    return ok
