"""One-shot voxel-grid downsampling of padded point batches.

Port of ``mimosa_tpu/lidar/downsample.py``: keep one representative point
per voxel, the lane with the smallest index (a scatter-min claim, exact and
order-free), then compact the kept lanes to the front in input order with a
stable sort. Output is a fixed-size [M, 3] tensor plus a validity mask.
"""

from __future__ import annotations

import torch

from mimosa_tpu_torch.mapping.voxel_hash import hash_coords, voxel_coords


def voxel_downsample(points, valid, leaf_size, max_out, table_log2=18):
    """points [N,3], valid [N] -> (out [M,3], out_valid [M], sel_idx [M]).

    Uses a scratch claim table of 2^table_log2 slots; rare hash collisions
    merge distinct voxels (it only drops a point a nearby voxel kept)."""
    n = points.shape[0]
    cap = 1 << table_log2
    h = hash_coords(voxel_coords(points, leaf_size)) & (cap - 1)
    lane = torch.arange(n, dtype=torch.int64, device=points.device)
    claims = torch.full((cap + 1,), n, dtype=torch.int64,
                        device=points.device).scatter_reduce(
        0, torch.where(valid, h, torch.full_like(h, cap)), lane, "amin")
    keep = valid & (claims[h] == lane)
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    sel = order[:max_out]
    out_valid = keep[sel]
    out = torch.where(out_valid[:, None], points[sel],
                      torch.zeros((), dtype=points.dtype,
                                  device=points.device))
    return out, out_valid, torch.where(out_valid, sel, torch.full_like(sel, -1))
