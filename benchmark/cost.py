"""Operations and bytes of the port's hand-written kernels, from their
shapes, and the card's peaks (``peaks.json``): a kernel's roofline share is
the least time the card could take for the work (the larger of bytes over
peak bandwidth and operations over peak rate) over the time it took."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).with_name("peaks.json")

# the ICP linearization's output buffers (``ops/icp_cuda.py::SIZES``):
# 85 f32, 10 int32 and 6 uint8 words, each written once
ICP_OUT_BYTES = 4 * 85 + 4 * 10 + 6
# f32 operations a lane (transform, residual, weight, Jacobian, J^T J and
# J^T r terms) and an inlier's extra ones (its Huber weight and sums)
ICP_FLOPS_POINT = 182
ICP_FLOPS_INLIER = 30


def icp_bytes(n):
    """Bytes the ICP kernel has to move at n lanes: points, normals and
    plane means [n,3] f32 and two byte masks read once; q, t and g_dir
    read once; the three output buffers written once."""
    return n * (3 * 12 + 2) + 4 * (4 + 3 + 3) + ICP_OUT_BYTES


def icp_flops(n, n_inlier):
    return ICP_FLOPS_POINT * n + ICP_FLOPS_INLIER * n_inlier


def peaks(kind):
    """The published peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def roofline(n_bytes, flops, seconds, peak):
    """(share of the roofline in %, the bound: "bytes" or "operations")."""
    t_b = n_bytes / peak["hbm_bytes_per_s"]
    t_f = flops / peak["f32_flop_per_s"]
    return 100.0 * max(t_b, t_f) / seconds, ("bytes" if t_b >= t_f
                                             else "operations")
