"""The point-to-plane ICP linearization: CUDA kernel for Hopper + wrapper.

Replaces ``mimosa_tpu/ops/icp_pallas.py::linearize_pallas`` and the XLA
tail of that wrapper; the kernel source and its design note are in
``csrc/icp_linearize.cu``. It is built with ``nvcc`` for ``sm_90a`` into
``build/mimosa_tpu_torch/`` at first use and bound through a plain C
interface with ``ctypes``.

:func:`linearize` has the meaning of ``lidar.geometric.linearize_with`` (the
plain PyTorch version, which it calls for tensors on the CPU): rotation
degeneracy is judged with ``loc_count_thresh_rot`` and the 4-DoF projection
applies when configured. For CUDA tensors it makes one launch of one
thread-block cluster, which writes the whole result into three small
buffers (f32, int32, uint8), and returns the result as views of them; it
never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "icp_linearize.cu"
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.FLAGS + ("-Xptxas", "-v")

# kernel launches: one per :func:`launch`; a captured CUDA graph adds the
# launches it recorded at each replay (``graph/captured.py``). Launches
# recorded inside a conditional node of a graph run only where its
# predicate holds on the device, so that body adds them to a device counter
# (:func:`body_counter`), which :func:`launches` folds in when asked.
LAUNCHES = 0
_BODY_COUNTERS = {}     # device index -> int64 0-d tensor

# The kernel's output layout: ICPResult field -> (buffer, offset, shape).
# ``csrc/icp_linearize.cu`` reports the same numbers through icp_layout(),
# checked when the library loads.
F32, I32, U8 = "f32", "i32", "u8"
SIZES = {F32: 85, I32: 10, U8: 6}
LAYOUT = {
    "H": (F32, 0, (6, 6)),
    "b": (F32, 36, (6,)),
    "num_inlier": (I32, 0, ()),
    "status_counts": (I32, 0, (geo.NUM_STATUS,)),
    "mean_abs_res": (F32, 42, ()),
    "loc_counts_rot": (I32, 4, (3,)),
    "loc_counts_trans": (I32, 7, (3,)),
    "eigvals_rot": (F32, 43, (3,)),
    "eigvals_trans": (F32, 46, (3,)),
    "eigvecs_rot": (F32, 49, (3, 3)),
    "eigvecs_trans": (F32, 58, (3, 3)),
    "degenerate_rot": (U8, 0, (3,)),
    "degenerate_trans": (U8, 3, (3,)),
}
# the unweighted rotation and translation blocks the eigenvectors come
# from, beside the result in the f32 buffer
BLOCKS = (F32, 67, (2, 3, 3))
# phase boundaries the optional trace records, as SM clocks of the
# cluster's first CTA (see the kernel source)
TRACE_POINTS = ("entry", "staged", "pass 1", "CTA sums", "cluster sync 1",
                "cluster sums", "eigen + outputs", "pass 2",
                "cluster sync 2", "flags")

_lib = None
# (seconds, compiler output) of the build this process loaded
build_info = None
# devices on which the library's kernel attributes are set
_ready = set()


def _expected_layout():
    return ([SIZES[F32], SIZES[I32], SIZES[U8]]
            + [LAYOUT[f][1] for f in geo.ICPResult._fields] + [BLOCKS[1]])


def build():
    """Compile the kernel (cached by source hash) and load it."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    lib, secs, log = nvcc.build(SOURCE, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icp_linearize.argtypes = [p] * 8 + [i] + [f] * 7 + [p] * 5
    for fn in (lib.icp_linearize, lib.icp_layout, lib.icp_trace_points,
               lib.icp_init):
        fn.restype = i
    lib.icp_layout.argtypes = [i]
    lib.icp_trace_points.argtypes = []
    lib.icp_init.argtypes = []
    want = _expected_layout()
    got = [lib.icp_layout(k) for k in range(len(want) + 1)]
    if got != want + [-1]:
        raise RuntimeError(f"kernel output layout {got[:-1]} does not match "
                           f"the wrapper's {want}")
    if lib.icp_trace_points() != len(TRACE_POINTS):
        raise RuntimeError("kernel trace points do not match the wrapper's")
    _lib = lib
    build_info = (secs, log)
    return lib


def _load(dev):
    """The library, with its kernel attributes set on ``dev`` (once per
    device, outside any launch)."""
    lib = build()
    if dev.index not in _ready:
        with torch.cuda.device(dev):
            code = lib.icp_init()
        if code != 0:
            raise RuntimeError(f"icp_init failed on {dev}: CUDA error {code}")
        _ready.add(dev.index)
    return lib


def body_counter(device):
    """The device's counter of launches made by conditional graph bodies.
    It is made outside any capture (by the body's eager warm-up): a tensor
    made during a capture would live in that graph's memory pool."""
    device = torch.device(device)
    c = _BODY_COUNTERS.get(device.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the conditional-body launch counter must be "
                               "made before the capture")
        c = _BODY_COUNTERS[device.index] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return c


def launches():
    """``LAUNCHES`` with the conditional bodies' launches folded in: each
    device counter is read once (a synchronize) and zeroed."""
    global LAUNCHES
    for c in _BODY_COUNTERS.values():
        LAUNCHES += int(c)
        c.zero_()
    return LAUNCHES


def reset_launches():
    """Set the launch count to 0, the device counters with it."""
    global LAUNCHES
    for c in _BODY_COUNTERS.values():
        c.zero_()
    LAUNCHES = 0


def _check_inputs(points_b, normal, mean, found, valid, q, t, g_dir):
    n = points_b.shape[0]
    dev = points_b.device
    named = [("points_b", points_b, (n, 3), (torch.float32,)),
             ("normal", normal, (n, 3), (torch.float32,)),
             ("mean", mean, (n, 3), (torch.float32,)),
             ("found", found, (n,), (torch.bool, torch.uint8)),
             ("valid", valid, (n,), (torch.bool, torch.uint8)),
             ("q", q, (4,), (torch.float32,)),
             ("t", t, (3,), (torch.float32,))]
    if g_dir is not None:
        named.append(("g_dir", g_dir, (3,), (torch.float32,)))
    for name, x, shape, dtypes in named:
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


def _view(buf, off, shape):
    return buf[off:off + math.prod(shape)].view(shape)


def unpack(f32, i32, u8) -> geo.ICPResult:
    """The ICPResult held by the three output buffers, as views of them."""
    bufs = {F32: f32, I32: i32, U8: u8.view(torch.bool)}
    return geo.ICPResult(**{name: _view(bufs[buf], off, shape)
                            for name, (buf, off, shape) in LAYOUT.items()})


def blocks(f32):
    """The unweighted rotation and translation blocks [2,3,3] in the f32
    buffer (the inputs of the kernel's eigen-analysis)."""
    return _view(f32, *BLOCKS[1:])


def launch(matches, points_b, valid, q, t, cfg: geo.GeometricConfig,
           g_dir=None, trace=None):
    """One launch of the kernel on CUDA tensors; returns its three new
    output buffers, which :func:`unpack` reads. ``trace``, an int64 tensor
    [len(TRACE_POINTS)] on the device, receives the SM clock at each phase
    boundary."""
    global LAUNCHES
    if points_b.device.type != "cuda":
        raise ValueError(f"unsupported device {points_b.device}")
    normal, mean, found = matches
    if not cfg.use_4dof:
        g_dir = None
    _check_inputs(points_b, normal, mean, found, valid, q, t, g_dir)
    if trace is not None and (trace.device != points_b.device
                              or trace.dtype != torch.int64
                              or tuple(trace.shape) != (len(TRACE_POINTS),)):
        raise ValueError("trace must be an int64 tensor "
                         f"[{len(TRACE_POINTS)}] on {points_b.device}")
    dev = points_b.device
    lib = _load(dev)
    f32 = torch.empty(SIZES[F32], dtype=torch.float32, device=dev)
    i32 = torch.empty(SIZES[I32], dtype=torch.int32, device=dev)
    u8 = torch.empty(SIZES[U8], dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.icp_linearize(
            points_b.data_ptr(), normal.data_ptr(), mean.data_ptr(),
            valid.data_ptr(), found.data_ptr(), q.data_ptr(), t.data_ptr(),
            None if g_dir is None else g_dir.data_ptr(), points_b.shape[0],
            cfg.sigma ** 2, cfg.huber_delta, cfg.s_gate_min, cfg.max_p2p_dist,
            cfg.loc_proj_cutoff, cfg.loc_count_thresh_rot,
            cfg.loc_count_thresh, f32.data_ptr(), i32.data_ptr(),
            u8.data_ptr(), None if trace is None else trace.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"icp_linearize launch failed: CUDA error {code}")
    LAUNCHES += 1
    return f32, i32, u8


def linearize(matches, points_b, valid, q, t, cfg: geo.GeometricConfig,
              g_dir=None) -> geo.ICPResult:
    """ICP linearization against fixed correspondences ``matches`` =
    (normal, mean, found): one kernel launch for CUDA tensors, the plain
    version (``geo.linearize_with``) for CPU tensors."""
    if points_b.device.type == "cpu":
        return geo.linearize_with(matches, points_b, valid, q, t, cfg,
                                  g_dir=g_dir)
    return unpack(*launch(matches, points_b, valid, q, t, cfg, g_dir))
