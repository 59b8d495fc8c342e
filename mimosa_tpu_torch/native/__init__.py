"""The host scan pack in C++, loaded with ctypes.

The port's copy of ``mimosa_tpu/native/``: ``decode.cc`` and ``pack.inc``
are the same sources. :func:`pack_scan` (the int16 xyz codec) and
:func:`pack_range` (the int16 range-image codec) are one fused pass each:
point skip, pad or truncate, quantize with the subtractive per-lane
dither, and the scan's end time over the full-density valid lanes.
:func:`decode_filtered` decodes and filters a raw PointCloud2 buffer in
one pass, and :func:`ring_sort` orders a cloud's points ring by ring (the
bag replay's organize-by-ring).

The library is built with g++ at first use into ``build/mimosa_tpu_torch/``
(named by a hash of the sources, the flags and the host CPU, since it is
built with ``-march=native``), with OpenMP where the compiler
has it and serially otherwise; both give the same bits. A failed build or
load raises: the Sequencer has no quiet numpy path. The numpy versions
(:func:`pack_scan_numpy`, :func:`pack_range_numpy`,
:func:`ring_sort_numpy`) are the plain twins that the tests hold the
library against, bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "decode.cc", _HERE / "pack.inc")
BUILD_DIR = _HERE.parents[1] / "build" / "mimosa_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib = None
# "openmp" or "serial": how the library this process loaded was built
build_mode = None

_DITHER_SALTS = (0xA511E9B3, 0x63D83595, 0x1B873593)
_F32, _F64 = 7, 8            # the sources' dtype codes
_DT = {np.dtype(np.float32): _F32, np.dtype(np.float64): _F64}


def _compile(so, openmp):
    flags = list(GXX_FLAGS) + (["-fopenmp"] if openmp else [])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *flags, str(SOURCES[0]), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return proc.stdout + proc.stderr
    os.replace(tmp, so)
    return None


def _host_cpu():
    """The host CPU's identity: its model and feature flags, which
    ``-march=native`` compiles for (a library built on another CPU may
    hold instructions this one does not have)."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        info = []
    keep = [ln for ln in info if ln.split(":")[0].strip()
            in ("model name", "flags", "Features", "CPU part")]
    return "\n".join(dict.fromkeys(keep)) or (platform.machine() + " "
                                              + platform.processor())


def build():
    """Compile the pack (cached by a hash of its sources, its flags and the
    host CPU) and load it; raises RuntimeError when neither build works."""
    global _lib, build_mode
    with _LOCK:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)
                                + " ".join(GXX_FLAGS).encode()
                                + _host_cpu().encode()).hexdigest()
        libs = {mode: BUILD_DIR / f"libmimosa_pack-{digest[:16]}-{mode}.so"
                for mode in ("openmp", "serial")}
        mode = next((m for m, p in libs.items() if p.exists()), None)
        if mode is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            err = _compile(libs["openmp"], openmp=True)
            mode = "openmp"
            if err is not None:
                # a toolchain without OpenMP builds the serial loop, which
                # gives the same bits
                err = _compile(libs["serial"], openmp=False)
                mode = "serial"
            if err is not None:
                raise RuntimeError(f"g++ could not build the scan pack:\n"
                                   f"{err}")
        lib = ctypes.CDLL(str(libs[mode]))
        p, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                            ctypes.c_double)
        tail = [i32, f64, f64, f64, i32, p, p]   # ncol, res x3, dither, out, t
        lib.mimosa_pack_scan.argtypes = [p, i32, p, i32, p, p, i32, i64, i64,
                                         i64] + tail
        lib.mimosa_pack_range.argtypes = [p, i32, p, i32, p, p, i32, p, i64,
                                          i64, i64] + tail
        lib.mimosa_pack_scan.restype = lib.mimosa_pack_range.restype = i64
        lib.mimosa_decode_filtered.argtypes = [p, i64, i64, p, p, f64, f64,
                                               f64, f64, f64, f64, i64, i64,
                                               i64, p, p, p, p]
        lib.mimosa_ring_sort.argtypes = [p, i64, i32, p, p]
        lib.mimosa_decode_filtered.restype = lib.mimosa_ring_sort.restype = \
            i64
        _lib, build_mode = lib, mode
        return lib


def _dither01(idx, salt):
    """Deterministic per-lane dither in [-0.5, 0.5): bit-identical to the
    C++ dither01 (Knuth multiplicative hash + xorshift finalizer)."""
    h = (idx.astype(np.uint64) * np.uint64(2654435761)).astype(np.uint32) \
        ^ np.uint32(salt)
    h ^= h >> np.uint32(16)
    h = (h.astype(np.uint64) * np.uint64(2246822519)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    return h.astype(np.float64) / 4294967296.0 - 0.5


def _inputs(points, t_rel, valid, intensity, with_intensity, skip=1):
    """Contiguous f32/f64 arrays (other types go to f64) and a byte mask,
    checked against the lengths the C++ reads."""
    def real(a):
        a = np.ascontiguousarray(a)
        return a if a.dtype in _DT else a.astype(np.float64)

    points, t_rel = real(points), real(t_rel)
    vd = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    inten = real(intensity) if (intensity is not None
                                and with_intensity) else None
    n = len(points)
    if points.shape != (n, 3) or t_rel.shape != (n,) or any(
            a is not None and a.shape != (n,) for a in (vd, inten)):
        raise ValueError("expected points [N,3] and t_rel, valid, intensity "
                         "[N]")
    if skip < 1:
        raise ValueError(f"skip must be >= 1, got {skip}")
    return points, t_rel, vd, inten


def _ptr(a):
    return None if a is None else a.ctypes.data


def _out(out, n_out, ncol):
    """The int16 [n_out, ncol] array a pack writes: ``out`` (a row of a
    bulk chunk's slab, checked) or a new one."""
    if out is None:
        return np.empty((n_out, ncol), np.int16)
    if out.dtype != np.int16 or out.shape != (n_out, ncol) \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous int16 [{n_out}, "
                         f"{ncol}] array, got {out.dtype} {out.shape}")
    return out


def pack_scan(points, t_rel, valid, intensity, skip, n_out, ncol,
              pos_res, t_res, int_res, dither=True, out=None):
    """Fused int16 xyz pack of one scan: every ``skip``-th point, padded or
    truncated to ``n_out`` rows of (x, y, z, t[, intensity]) quantized at
    the given resolutions, with ``t == -32768`` marking invalid lanes and,
    with ``dither``, a per-lane subtractive dither of +-0.5 LSB on the
    positions. Returns (out int16 [n_out, ncol], t_end): t_end is the
    largest t over the valid finite lanes of the full-density input.
    ``out`` (optional) receives the pack in place: the bulk scheduler packs
    a chunk's scans into the rows of one slab."""
    if ncol not in (4, 5):
        raise ValueError(f"pack_scan packs 4 or 5 columns, not {ncol}")
    lib = build()
    points, t_rel, vd, inten = _inputs(points, t_rel, valid, intensity,
                                       ncol > 4, skip)
    out = _out(out, n_out, ncol)
    t_end = ctypes.c_double(0.0)
    lib.mimosa_pack_scan(
        _ptr(points), _DT[points.dtype], _ptr(t_rel), _DT[t_rel.dtype],
        _ptr(vd), _ptr(inten), 0 if inten is None else _DT[inten.dtype],
        len(points), skip, n_out, ncol, pos_res, t_res, int_res,
        1 if dither else 0, _ptr(out), ctypes.addressof(t_end))
    return out, float(t_end.value)


def pack_range(points, t_rel, valid, intensity, skip, n_out, ncol,
               r_res, t_res, int_res, dither=True, beam=None, out=None):
    """Fused int16 range-image pack (the range_transfer codec): rows of
    (range, t[, intensity]), the range |p| for a radial beam model or
    s = dot(p - offset, dir) with ``beam`` (f32 [n_out, 6]: unit direction
    then offset of each packed lane, the affine Ouster model), quantized
    along the ray with the x-axis dither salt. Sentinel, t_end and ``out``
    as :func:`pack_scan`."""
    if ncol not in (2, 3):
        raise ValueError(f"pack_range packs 2 or 3 columns, not {ncol}")
    lib = build()
    points, t_rel, vd, inten = _inputs(points, t_rel, valid, intensity,
                                       ncol > 2, skip)
    out = _out(out, n_out, ncol)
    bm = None
    if beam is not None:
        bm = np.ascontiguousarray(beam, np.float32)
        if bm.shape != (n_out, 6):
            raise ValueError(f"beam must be [{n_out}, 6], got {bm.shape}")
    t_end = ctypes.c_double(0.0)
    lib.mimosa_pack_range(
        _ptr(points), _DT[points.dtype], _ptr(t_rel), _DT[t_rel.dtype],
        _ptr(vd), _ptr(inten), 0 if inten is None else _DT[inten.dtype],
        _ptr(bm), len(points), skip, n_out, ncol, r_res, t_res, int_res,
        1 if dither else 0, _ptr(out), ctypes.addressof(t_end))
    return out, float(t_end.value)


def _ok_lanes(points, t_rel, valid):
    finite = np.isfinite(points).all(-1)
    return (finite if valid is None else (np.asarray(valid, bool) & finite)) \
        & np.isfinite(t_rel)


def pack_scan_numpy(points, t_rel, valid, intensity, skip, n_out, ncol,
                    pos_res, t_res, int_res, dither=True):
    """The plain twin of :func:`pack_scan`: f64 math and the same
    multiply-by-reciprocal quantization as the C++, so the same bits."""
    points, t_rel, _, _ = _inputs(points, t_rel, None, None, False)
    inv_pos, inv_t = 1.0 / pos_res, 1.0 / t_res
    inv_int = 1.0 / int_res if int_res > 0 else 0.0
    ok = _ok_lanes(points, t_rel, valid)
    t_end = float(t_rel[ok].max()) if ok.any() else 0.0
    pts_s, t_s, ok_s = points[::skip], t_rel[::skip], ok[::skip]
    k = min(len(pts_s), n_out)
    out = np.zeros((n_out, ncol), np.int16)
    out[:, 3] = -32768
    p = np.nan_to_num(pts_s[:k].astype(np.float64), posinf=0.0, neginf=0.0)
    q = p * inv_pos
    if dither:
        lane = np.arange(k, dtype=np.uint64)   # packed row index
        q = q + np.stack([_dither01(lane, s) for s in _DITHER_SALTS],
                         axis=-1)
    out[:k, :3] = np.where(ok_s[:k, None],
                           np.clip(np.round(q), -32767, 32767),
                           0).astype(np.int16)
    t_fin = np.nan_to_num(t_s[:k].astype(np.float64), posinf=0.0,
                          neginf=0.0)
    tq = np.clip(np.round(t_fin * inv_t), 0, 65534) - 32767
    out[:k, 3] = np.where(ok_s[:k], tq, -32768).astype(np.int16)
    if ncol > 4:
        iv = np.zeros(len(points)) if intensity is None else \
            np.nan_to_num(np.asarray(intensity, np.float64))
        iq = np.clip(np.round(iv[::skip][:k] * inv_int), 0, 32767)
        out[:k, 4] = np.where(ok_s[:k], iq, 0).astype(np.int16)
    return out, t_end


def pack_range_numpy(points, t_rel, valid, intensity, skip, n_out, ncol,
                     r_res, t_res, int_res, dither=True, beam=None):
    """The plain twin of :func:`pack_range` (f64 range math, the same
    quantization expressions as the C++: a divide can differ by one ulp at
    a rounding boundary, and one LSB can decide convergence on a marginal
    scene)."""
    points, t_rel, _, _ = _inputs(points, t_rel, None, None, False)
    inv_r, inv_t = 1.0 / r_res, 1.0 / t_res
    inv_int = 1.0 / int_res if int_res > 0 else 0.0
    ok = _ok_lanes(points, t_rel, valid)
    t_end = float(t_rel[ok].max()) if ok.any() else 0.0
    pts_s, t_s, ok_s = points[::skip], t_rel[::skip], ok[::skip]
    k = min(len(pts_s), n_out)
    out = np.zeros((n_out, ncol), np.int16)
    out[:, 1] = -32768
    p = np.nan_to_num(pts_s[:k].astype(np.float64), posinf=0.0, neginf=0.0)
    if beam is not None:
        bm = np.ascontiguousarray(beam, np.float32).astype(np.float64)
        r = np.einsum("ij,ij->i", p - bm[:k, 3:6], bm[:k, 0:3])
    else:
        r = np.sqrt(np.einsum("ij,ij->i", p, p))
    qr = r * inv_r
    if dither:
        qr = qr + _dither01(np.arange(k, dtype=np.uint64), _DITHER_SALTS[0])
    qr = np.clip(np.round(qr), 0, 65534) - 32767
    out[:k, 0] = np.where(ok_s[:k], qr, 0).astype(np.int16)
    t_fin = np.nan_to_num(t_s[:k].astype(np.float64), posinf=0.0,
                          neginf=0.0)
    tq = np.clip(np.round(t_fin * inv_t), 0, 65534) - 32767
    out[:k, 1] = np.where(ok_s[:k], tq, -32768).astype(np.int16)
    if ncol > 2:
        iv = np.zeros(len(points)) if intensity is None else \
            np.nan_to_num(np.asarray(intensity, np.float64))
        iq = np.clip(np.round(iv[::skip][:k] * inv_int), 0, 32767)
        out[:k, 2] = np.where(ok_s[:k], iq, 0).astype(np.int16)
    return out, t_end


# the sources' field dtype codes, by numpy dtype (0: the field is absent)
_FIELD_CODE = {np.dtype(np.int8): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int16): 3, np.dtype(np.uint16): 4,
               np.dtype(np.int32): 5, np.dtype(np.uint32): 6,
               np.dtype(np.float32): 7, np.dtype(np.float64): 8}
# each point format's time field
_TIME_FIELD = {"ouster": "t", "ouster_r8": "t", "ouster_odyssey": "t",
               "livox_custom2": "t", "internal": "t", "livox": "timestamp",
               "hesai": "timestamp", "rslidar": "timestamp",
               "velodyne": "time", "velodyne_anybotics": "time"}


def decode_filtered(data, fields, point_step, max_out, t_scale=1e-9,
                    t_offset=0.0, range_min=0.2, range_max=100.0,
                    intensity_min=0.0, intensity_max=1e18, point_skip=1,
                    ring_skip=1):
    """Fused decode + filter of a raw PointCloud2 buffer into dense arrays
    (``fields``: a list of ``io.pointcloud2.Field``). A point is kept when
    it is finite, its range lies in [range_min, range_max], its intensity
    (where the cloud has one) in [intensity_min, intensity_max], its index
    is a multiple of ``point_skip`` and its ring (where the cloud has one)
    of ``ring_skip``; its time is ``raw * t_scale - t_offset``. Returns
    (xyz [k,3] f32, intensity [k] f32, t_rel [k] f64, ring [k] i32, -1
    without a ring field) with k <= max_out."""
    from mimosa_tpu_torch.io import pointcloud2 as pc2

    by_name = {f.name: f for f in fields}
    sel = [by_name.get("x"), by_name.get("y"), by_name.get("z"),
           by_name.get("intensity"),
           by_name.get(_TIME_FIELD[pc2.detect_format(fields)]),
           by_name.get("ring") or by_name.get("line")]
    if point_step < 1:
        raise ValueError(f"point_step must be >= 1, got {point_step}")
    for f in sel:
        if f is not None and f.offset + np.dtype(
                pc2._DTYPES[f.datatype]).itemsize > point_step:
            raise ValueError(f"field {f.name} at offset {f.offset} does not "
                             f"fit a {point_step}-byte point")
    buf = np.ascontiguousarray(
        np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
        else data.view(np.uint8).reshape(-1))
    offsets = np.asarray([f.offset if f else 0 for f in sel], np.int64)
    codes = np.asarray([_FIELD_CODE[np.dtype(pc2._DTYPES[f.datatype])]
                        if f else 0 for f in sel], np.int32)
    lib = build()
    xyz = np.empty((max_out, 3), np.float32)
    inten = np.empty(max_out, np.float32)
    t = np.empty(max_out, np.float64)
    ring = np.empty(max_out, np.int32)
    k = lib.mimosa_decode_filtered(
        _ptr(buf), len(buf) // point_step, point_step, _ptr(offsets),
        _ptr(codes), t_scale, t_offset, range_min, range_max, intensity_min,
        intensity_max, point_skip, ring_skip, max_out, _ptr(xyz),
        _ptr(inten), _ptr(t), _ptr(ring))
    return xyz[:k], inten[:k], t[:k], ring[:k]


def ring_sort(rings, n_rings):
    """Ring-major stable permutation of point indices (the reference's
    organize_pointcloud_by_ring, src/lidar/manager.cpp:205-242): points
    ordered by ring ascending, in arrival order within a ring; rings
    outside [0, n_rings) count as the last ring. Returns idx (int64 [n])
    such that arrays[idx] is ring-major. One counting-sort pass."""
    if n_rings < 1:
        raise ValueError(f"n_rings must be >= 1, got {n_rings}")
    lib = build()
    rings = np.ascontiguousarray(np.asarray(rings, np.int32))
    idx = np.empty(len(rings), np.int64)
    scratch = np.empty(n_rings + 1, np.int64)
    lib.mimosa_ring_sort(_ptr(rings), len(rings), n_rings, _ptr(idx),
                         _ptr(scratch))
    return idx


def ring_sort_numpy(rings, n_rings):
    """The plain twin of :func:`ring_sort` (a stable argsort)."""
    r = np.asarray(rings, np.int32)
    r = np.where((r < 0) | (r >= n_rings), n_rings - 1, r)
    return np.argsort(r, kind="stable").astype(np.int64)
