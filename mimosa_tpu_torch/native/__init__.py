"""The host scan pack in C++, loaded with ctypes.

The port's copy of ``mimosa_tpu/native/``: ``decode.cc`` and ``pack.inc``
are the same sources. :func:`pack_scan` (the int16 xyz codec) and
:func:`pack_range` (the int16 range-image codec) are one fused pass each:
point skip, pad or truncate, quantize with the subtractive per-lane
dither, and the scan's end time over the full-density valid lanes.

The library is built with g++ at first use into ``build/mimosa_tpu_torch/``
(named by a hash of the sources, the flags and the host CPU, since it is
built with ``-march=native``), with OpenMP where the compiler
has it and serially otherwise; both give the same bits. A failed build or
load raises: the Sequencer has no quiet numpy path. The numpy versions
(:func:`pack_scan_numpy`, :func:`pack_range_numpy`) are the plain twins
that the tests hold the library against, bit for bit.
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


def pack_scan(points, t_rel, valid, intensity, skip, n_out, ncol,
              pos_res, t_res, int_res, dither=True):
    """Fused int16 xyz pack of one scan: every ``skip``-th point, padded or
    truncated to ``n_out`` rows of (x, y, z, t[, intensity]) quantized at
    the given resolutions, with ``t == -32768`` marking invalid lanes and,
    with ``dither``, a per-lane subtractive dither of +-0.5 LSB on the
    positions. Returns (out int16 [n_out, ncol], t_end): t_end is the
    largest t over the valid finite lanes of the full-density input."""
    if ncol not in (4, 5):
        raise ValueError(f"pack_scan packs 4 or 5 columns, not {ncol}")
    lib = build()
    points, t_rel, vd, inten = _inputs(points, t_rel, valid, intensity,
                                       ncol > 4, skip)
    out = np.empty((n_out, ncol), np.int16)
    t_end = ctypes.c_double(0.0)
    lib.mimosa_pack_scan(
        _ptr(points), _DT[points.dtype], _ptr(t_rel), _DT[t_rel.dtype],
        _ptr(vd), _ptr(inten), 0 if inten is None else _DT[inten.dtype],
        len(points), skip, n_out, ncol, pos_res, t_res, int_res,
        1 if dither else 0, _ptr(out), ctypes.addressof(t_end))
    return out, float(t_end.value)


def pack_range(points, t_rel, valid, intensity, skip, n_out, ncol,
               r_res, t_res, int_res, dither=True, beam=None):
    """Fused int16 range-image pack (the range_transfer codec): rows of
    (range, t[, intensity]), the range |p| for a radial beam model or
    s = dot(p - offset, dir) with ``beam`` (f32 [n_out, 6]: unit direction
    then offset of each packed lane, the affine Ouster model), quantized
    along the ray with the x-axis dither salt. Sentinel and t_end as
    :func:`pack_scan`."""
    if ncol not in (2, 3):
        raise ValueError(f"pack_range packs 2 or 3 columns, not {ncol}")
    lib = build()
    points, t_rel, vd, inten = _inputs(points, t_rel, valid, intensity,
                                       ncol > 2, skip)
    out = np.empty((n_out, ncol), np.int16)
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
