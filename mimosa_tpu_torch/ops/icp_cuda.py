"""The fused point-to-plane ICP reduction: CUDA kernel for Hopper + wrapper.

Replaces ``mimosa_tpu/ops/icp_pallas.py::linearize_pallas``; the kernel
source and its design note are in ``csrc/icp_linearize.cu``. It is built
with ``nvcc`` for ``sm_90a`` into ``build/mimosa_tpu_torch/`` at first use
and bound through a plain C interface with ``ctypes``.

:func:`linearize` has the meaning of ``lidar.geometric.linearize_with`` (the
plain PyTorch version, which it calls for tensors on the CPU): rotation
degeneracy is judged with ``loc_count_thresh_rot`` and the 4-DoF projection
applies when configured. For CUDA tensors it launches the kernel or raises;
it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.core.eigh3 import eigh3
from mimosa_tpu_torch.lidar import geometric as geo

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "icp_linearize.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mimosa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches made through :func:`linearize` (one per call on the card)
LAUNCHES = 0

_NSUMS = 45
_MAX_GRID = 1024
_lib = None
# (seconds, compiler output) of the build this process loaded
build_info = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the ICP kernel")
    return path


def build():
    """Compile the kernel (cached by source hash) and load it."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libicp_linearize-{digest[:16]}.so"
    t0 = time.perf_counter()
    log = "cached"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        log = (proc.stdout + proc.stderr).strip()
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icp_partials.argtypes = [p, p, p, p, p, p, i, f, f, f, f, p, i, p]
    lib.icp_finalize.argtypes = [p, i, p, p]
    lib.icp_loc_counts.argtypes = [p, p, p, p, p, p, p, i, f, f, f, p, i, p]
    for fn in (lib.icp_partials, lib.icp_finalize, lib.icp_loc_counts,
               lib.icp_threads_per_block, lib.icp_num_sums):
        fn.restype = i
    if lib.icp_num_sums() != _NSUMS:
        raise RuntimeError("kernel sum layout does not match the wrapper")
    _lib = lib
    build_info = (time.perf_counter() - t0, log)
    return lib


def _check(code, what):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _check_inputs(points_b, normal, mean, found, valid, q, t):
    n = points_b.shape[0]
    dev = points_b.device
    for name, x, shape, dtypes in (
            ("points_b", points_b, (n, 3), (torch.float32,)),
            ("normal", normal, (n, 3), (torch.float32,)),
            ("mean", mean, (n, 3), (torch.float32,)),
            ("found", found, (n,), (torch.bool, torch.uint8)),
            ("valid", valid, (n,), (torch.bool, torch.uint8)),
            ("q", q, (4,), (torch.float32,)),
            ("t", t, (3,), (torch.float32,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, points on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {x.dtype}, expected one of "
                            f"{dtypes}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _unpack_index(device):
    """Gather indices into the 45 sums: H [6,6] from its 21-entry upper
    triangle at 0, and the rotation and translation blocks [2,3,3] from
    theirs at 27 and 33 (row-major upper triangles, mirrored)."""
    def sym(n, base):
        iu = torch.triu_indices(n, n, device=device)
        pos = base + torch.arange(iu.shape[1], device=device)
        idx = torch.empty((n, n), dtype=torch.int64, device=device)
        idx[iu[0], iu[1]] = pos
        idx[iu[1], iu[0]] = pos
        return idx
    return sym(6, 0), torch.stack([sym(3, 27), sym(3, 33)])


def _grid(lib, n):
    """Blocks to launch: one thread per point up to _MAX_GRID blocks, past
    which each thread's grid-stride loop takes several points."""
    return max(1, min(_MAX_GRID, -(-n // lib.icp_threads_per_block())))


def _launch_sums(points_b, normal, mean, found, valid, rt, cfg):
    """The reduction's two launches: ``out[45]`` f32 on the device."""
    lib = build()
    n = points_b.shape[0]
    grid = _grid(lib, n)
    partials = torch.empty((grid, _NSUMS), dtype=torch.float32,
                           device=points_b.device)
    out = torch.empty(_NSUMS, dtype=torch.float32, device=points_b.device)
    stream = torch.cuda.current_stream(points_b.device).cuda_stream
    _check(lib.icp_partials(
        points_b.data_ptr(), normal.data_ptr(), mean.data_ptr(),
        valid.data_ptr(), found.data_ptr(), rt.data_ptr(), n, cfg.sigma ** 2,
        cfg.huber_delta, cfg.s_gate_min, cfg.max_p2p_dist,
        partials.data_ptr(), grid, stream), "icp_partials")
    _check(lib.icp_finalize(partials.data_ptr(), grid, out.data_ptr(),
                            stream), "icp_finalize")
    return out


def _launch_loc_counts(points_b, normal, mean, found, valid, rt, vecs, cfg):
    """The localizability count launch: ``int32[6]`` on the device."""
    lib = build()
    n = points_b.shape[0]
    grid = _grid(lib, n)
    loc = torch.zeros(6, dtype=torch.int32, device=points_b.device)
    _check(lib.icp_loc_counts(
        points_b.data_ptr(), normal.data_ptr(), mean.data_ptr(),
        valid.data_ptr(), found.data_ptr(), rt.data_ptr(), vecs.data_ptr(),
        n, cfg.s_gate_min, cfg.max_p2p_dist, cfg.loc_proj_cutoff,
        loc.data_ptr(), grid,
        torch.cuda.current_stream(points_b.device).cuda_stream),
        "icp_loc_counts")
    return loc


def linearize(matches, points_b, valid, q, t, cfg: geo.GeometricConfig,
              g_dir=None) -> geo.ICPResult:
    """ICP linearization against fixed correspondences ``matches`` =
    (normal, mean, found): the kernel for CUDA tensors, the plain version
    (``geo.linearize_with``) for CPU tensors."""
    global LAUNCHES
    if points_b.device.type == "cpu":
        return geo.linearize_with(matches, points_b, valid, q, t, cfg,
                                  g_dir=g_dir)
    if points_b.device.type != "cuda":
        raise ValueError(f"unsupported device {points_b.device}")
    normal, mean, found = matches
    _check_inputs(points_b, normal, mean, found, valid, q, t)
    R = lie.quat_to_mat(q)
    rt = torch.cat([R.reshape(9), t]).contiguous()
    with torch.cuda.device(points_b.device):
        out = _launch_sums(points_b, normal, mean, found, valid, rt, cfg)
        LAUNCHES += 1
        h_idx, blocks_idx = _unpack_index(points_b.device)
        H = out[h_idx]
        b = out[21:27]
        lam, V = eigh3(out[blocks_idx])
        counts = out[39:43].to(torch.int32)
        mean_abs = out[43] / torch.clamp(out[44], min=1.0)
        loc = _launch_loc_counts(points_b, normal, mean, found, valid, rt,
                                 V.contiguous(), cfg)
    cnt_r, cnt_t = loc[:3], loc[3:]
    if cfg.use_4dof and g_dir is not None:
        H, b = geo.four_dof_projection(H, b, R, g_dir)
    return geo.ICPResult(H, b, counts[0], counts, mean_abs, cnt_r, cnt_t,
                         lam[0], lam[1], V[0], V[1],
                         cnt_r < cfg.loc_count_thresh_rot,
                         cnt_t < cfg.loc_count_thresh)
