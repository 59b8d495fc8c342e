"""Device-resident incremental voxel-hash map with per-voxel plane moments.

Port of ``mimosa_tpu/mapping/voxel_hash.py``: open-addressing hash of voxel
coords, insertion with a race-free scatter-min claim protocol (winner =
lowest lane), moment accumulation under an exact per-voxel cap, LRU
eviction, closed-form plane refit, and nearest-plane query over a neighbour
stencil.

Arrays are sized ``capacity + 1``: the last row is a write-off slot that
absorbs scatters from masked lanes.

Hash arithmetic matches the JAX package bit for bit: the int32 products
wrap there, so here they are computed in int64 and cut to their low 32
bits (signed), which is the same value without relying on signed overflow.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mimosa_tpu_torch.core.eigh3 import smallest_eigvec3

INT32_MIN = -(2 ** 31)

# stencil neighbour offsets per neighbor_voxel_mode 1/7/19/27
_OFFS27 = [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
           for z in (-1, 0, 1)]


def _stencil(mode: int):
    def l1(o):
        return sum(abs(c) for c in o)
    if mode == 1:
        return ((0, 0, 0),)
    if mode == 7:
        return ((0, 0, 0),) + tuple(o for o in _OFFS27 if l1(o) == 1)
    if mode == 19:
        return tuple(sorted((o for o in _OFFS27 if l1(o) <= 2), key=l1))
    if mode == 27:
        return tuple(sorted(_OFFS27, key=l1))
    raise ValueError(f"neighbor_voxel_mode must be 1/7/19/27, got {mode}")


@dataclasses.dataclass(frozen=True)
class VoxelMapConfig:
    leaf_size: float = 0.5
    capacity_log2: int = 19           # 2^19 = 524288 voxels
    insert_probes: int = 8
    query_probes: int = 4
    neighbor_voxel_mode: int = 7      # 1 / 7 / 19 / 27
    plane_min_points: float = 5.0
    max_points_per_voxel: float = 64.0
    lru_horizon: int = 100            # scans; <=0 disables eviction
    plane_max_thickness: float = 0.08  # max sqrt(min eigenvalue) [m]
    line_eig_ratio: float = 3.0       # invalid if ratio*lam_mid < lam_max

    @property
    def capacity(self) -> int:
        return 1 << self.capacity_log2


class VoxelMap(NamedTuple):
    """All tensors have leading dim capacity+1 (last row = write-off)."""

    coords: torch.Tensor      # [C+1,3] int32 voxel integer coords
    occupied: torch.Tensor    # [C+1] bool
    n: torch.Tensor           # [C+1] accumulated point count
    psum: torch.Tensor        # [C+1,3] sum of points (world frame)
    pssum: torch.Tensor       # [C+1,6] packed xx,xy,xz,yy,yz,zz moments
    last_touch: torch.Tensor  # [C+1] int32 scan index of last insertion
    mean: torch.Tensor        # [C+1,3] plane cache
    normal: torch.Tensor      # [C+1,3] unit plane normal
    plane_valid: torch.Tensor  # [C+1] bool

    @property
    def num_occupied(self):
        """Occupied voxels, the write-off row left out (int32 0-d)."""
        return self.occupied[:-1].sum().to(torch.int32)


def create(cfg: VoxelMapConfig, device=None, dtype=torch.float32) -> VoxelMap:
    c1 = cfg.capacity + 1
    f = dict(dtype=dtype, device=device)
    return VoxelMap(
        coords=torch.full((c1, 3), INT32_MIN, dtype=torch.int32,
                          device=device),
        occupied=torch.zeros(c1, dtype=torch.bool, device=device),
        n=torch.zeros(c1, **f),
        psum=torch.zeros((c1, 3), **f),
        pssum=torch.zeros((c1, 6), **f),
        last_touch=torch.zeros(c1, dtype=torch.int32, device=device),
        mean=torch.zeros((c1, 3), **f),
        normal=torch.zeros((c1, 3), **f),
        plane_valid=torch.zeros(c1, dtype=torch.bool, device=device),
    )


def voxel_coords(points, leaf_size):
    """Integer voxel coordinates (floor), batched: [..., 3] -> int32."""
    return torch.floor(points / leaf_size).to(torch.int32)


def _wrap_int32(x):
    """Low 32 bits of an int64 tensor as a signed int32 value (in int64)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def hash_coords(vc):
    """XOR spatial hash of int32 voxel coords, equal bit for bit to the
    JAX package's wrapping int32 arithmetic; returned as int64."""
    v = vc.to(torch.int64)
    h = (_wrap_int32(v[..., 0] * 73856093)
         ^ _wrap_int32(v[..., 1] * 19349669)
         ^ _wrap_int32(v[..., 2] * 83492791))
    return h


def _slot_of(h, probe, mask):
    return (h + probe) & mask


def _rows_equal(coords, slot, vc):
    return torch.all(coords[slot] == vc, dim=-1)


def find_slots(vmap: VoxelMap, vc, cfg: VoxelMapConfig, probes=None):
    """Probe for existing voxels. Returns (slot [N] int64, found [N] bool);
    slot == capacity (write-off row) where not found."""
    probes = probes or cfg.query_probes
    mask = cfg.capacity - 1
    h = hash_coords(vc)
    slot = torch.full(h.shape, cfg.capacity, dtype=torch.int64,
                      device=h.device)
    found = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for i in range(probes):
        cand = _slot_of(h, i, mask)
        match = vmap.occupied[cand] & _rows_equal(vmap.coords, cand, vc)
        slot = torch.where(match & ~found, cand, slot)
        found = found | match
    return slot, found


def _scatter_add(x, idx, v):
    """x with x[idx] += v, duplicates summed in lane order on both
    devices. On the card ``index_add`` adds with atomics in whatever order
    they land (two runs of one step would differ in the last bits), so
    there the sort-based accumulating ``index_put`` runs. On the CPU
    ``index_add`` is the serial lane-order sum. The CPU's accumulating
    ``index_put`` keeps lane order only on one thread: on more, past
    torch's parallel grain of 32768 lanes, it does not, which moves the
    map's normals by up to 3e-4 at the JAX parity tests' sizes
    (``test_update_planes_matches_jax`` and
    ``test_query_planes_matches_jax`` in ``tests/test_torch_lidar.py``,
    tolerance 1e-4)."""
    if x.device.type == "cpu":
        return x.index_add(0, idx, v)
    return x.index_put((idx,), v, accumulate=True)


def insert(vmap: VoxelMap, points, valid, scan_idx, cfg: VoxelMapConfig,
           return_slots=False):
    """Insert world-frame points [N,3] (mask ``valid``) at scan ``scan_idx``.

    Per probe round, unresolved lanes first match existing voxels, then
    claim empty slots by scatter-min of their lane index; the winner writes
    the voxel coords and every unresolved lane re-checks, so all lanes of
    one voxel resolve together. Lanes unresolved after ``insert_probes``
    rounds are dropped.
    """
    n_pts = points.shape[0]
    cap = cfg.capacity
    mask = cap - 1
    device = points.device
    vc = voxel_coords(points, cfg.leaf_size)
    h = hash_coords(vc)
    lane = torch.arange(n_pts, dtype=torch.int64, device=device)
    cap_t = torch.full_like(lane, cap)

    slot = cap_t.clone()
    resolved = ~valid
    coords, occupied = vmap.coords, vmap.occupied
    for i in range(cfg.insert_probes):
        cand = _slot_of(h, i, mask)
        # 1) match against existing voxels
        occ = occupied[cand]
        take = occ & _rows_equal(coords, cand, vc) & ~resolved
        slot = torch.where(take, cand, slot)
        resolved = resolved | take
        # 2) claim empty slots (winner = lowest lane index); only the
        # write-off row ``cap`` ever sees duplicate writes
        contender = ~resolved & ~occ
        claims = torch.full((cap + 1,), n_pts, dtype=torch.int64,
                            device=device).scatter_reduce(
            0, torch.where(contender, cand, cap_t), lane, "amin")
        winner = contender & (claims[cand] == lane)
        wr_tgt = torch.where(winner, cand, cap_t)
        coords = coords.index_put((wr_tgt,), vc)
        occupied = occupied.index_put(
            (wr_tgt,), torch.ones_like(winner))
        # 3) re-check: same-voxel lanes resolve onto the fresh claim
        take2 = (occupied[cand] & _rows_equal(coords, cand, vc)
                 & ~resolved)
        slot = torch.where(take2, cand, slot)
        resolved = resolved | take2

    # moments under an exact per-voxel cap: each lane's rank within its
    # voxel in this batch (segmented count over the stably sorted slots)
    ok = resolved & valid & (slot < cap)
    key = torch.where(ok, slot, cap_t)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    is_start = torch.ones_like(ok)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    start_idx = torch.cummax(
        torch.where(is_start, lane, torch.zeros_like(lane)), dim=0).values
    rank = torch.empty_like(lane).scatter_(0, order, lane - start_idx)
    ok = ok & (vmap.n[slot] + rank.to(points.dtype)
               < cfg.max_points_per_voxel)
    tgt = torch.where(ok, slot, cap_t)
    w = ok.to(points.dtype)
    p = points
    outer = torch.stack(
        [p[:, 0] * p[:, 0], p[:, 0] * p[:, 1], p[:, 0] * p[:, 2],
         p[:, 1] * p[:, 1], p[:, 1] * p[:, 2], p[:, 2] * p[:, 2]], dim=-1)
    scan = torch.as_tensor(scan_idx, dtype=torch.int32, device=device)
    new = vmap._replace(
        coords=coords,
        occupied=occupied,
        n=_scatter_add(vmap.n, tgt, w),
        psum=_scatter_add(vmap.psum, tgt, p * w[:, None]),
        pssum=_scatter_add(vmap.pssum, tgt, outer * w[:, None]),
        last_touch=vmap.last_touch.scatter_reduce(
            0, tgt, scan.expand(n_pts), "amax"),
    )
    if return_slots:
        # touched slots (cap for dropped lanes): update_planes_at refits
        # only the planes this insert changed
        return new, torch.where(resolved & valid, slot, cap_t)
    return new


def evict_stale(vmap: VoxelMap, scan_idx, cfg: VoxelMapConfig) -> VoxelMap:
    """LRU-horizon eviction: clear voxels not touched within
    ``lru_horizon`` scans."""
    if cfg.lru_horizon <= 0:
        return vmap
    stale = vmap.occupied & (scan_idx - vmap.last_touch > cfg.lru_horizon)
    keep = ~stale
    kf = keep.to(vmap.n.dtype)
    return vmap._replace(
        coords=torch.where(stale[:, None],
                           torch.full_like(vmap.coords, INT32_MIN),
                           vmap.coords),
        occupied=vmap.occupied & keep,
        n=vmap.n * kf,
        psum=vmap.psum * kf[:, None],
        pssum=vmap.pssum * kf[:, None],
        plane_valid=vmap.plane_valid & keep,
    )


def _fit_planes(n_raw, occupied, psum, pssum, cfg):
    """Plane fit from accumulated moments -> (mean, normal, valid)."""
    n = torch.clamp(n_raw, min=1.0)
    mean = psum / n[:, None]
    s = pssum / n[:, None]
    xx, xy, xz, yy, yz, zz = s.unbind(-1)
    mx, my, mz = mean.unbind(-1)
    cov = torch.stack([
        xx - mx * mx, xy - mx * my, xz - mx * mz,
        xy - mx * my, yy - my * my, yz - my * mz,
        xz - mx * mz, yz - my * mz, zz - mz * mz,
    ], dim=-1).reshape(-1, 3, 3)
    lam, nrm = smallest_eigvec3(cov)
    thick_ok = lam[:, 0] <= cfg.plane_max_thickness ** 2
    not_line = cfg.line_eig_ratio * lam[:, 1] >= lam[:, 2]
    valid = occupied & (n_raw >= cfg.plane_min_points) & thick_ok & not_line
    return mean, nrm, valid


def _clear_write_off(valid):
    """``valid`` with the write-off row False, by a mask made on the device
    (``valid[-1] = False`` would copy the Python bool from pageable host
    memory: a sync, and no capture)."""
    return valid & (torch.arange(valid.shape[0], device=valid.device)
                    < valid.shape[0] - 1)


def update_planes(vmap: VoxelMap, cfg: VoxelMapConfig) -> VoxelMap:
    """Refit every voxel's plane from its accumulated moments."""
    mean, nrm, valid = _fit_planes(vmap.n, vmap.occupied, vmap.psum,
                                   vmap.pssum, cfg)
    return vmap._replace(mean=mean, normal=nrm,
                         plane_valid=_clear_write_off(valid))


def update_planes_at(vmap: VoxelMap, slots, cfg: VoxelMapConfig) -> VoxelMap:
    """Refit only the voxels in ``slots`` (cap for dropped lanes); duplicate
    slots recompute identical values, so the scatter is race-free."""
    mean, nrm, valid = _fit_planes(vmap.n[slots], vmap.occupied[slots],
                                   vmap.psum[slots], vmap.pssum[slots], cfg)
    return vmap._replace(
        mean=vmap.mean.index_put((slots,), mean),
        normal=vmap.normal.index_put((slots,), nrm),
        plane_valid=_clear_write_off(
            vmap.plane_valid.index_put((slots,), valid)),
    )


def query_planes(vmap: VoxelMap, points, cfg: VoxelMapConfig):
    """Nearest valid plane for each query point over the neighbour stencil:
    among valid planes in the stencil, the one whose mean is closest.
    Returns (normal [N,3], mean [N,3], found [N] bool)."""
    vc0 = voxel_coords(points, cfg.leaf_size)
    n = points.shape[0]
    best_d2 = torch.full((n,), torch.finfo(points.dtype).max,
                         dtype=points.dtype, device=points.device)
    best_slot = torch.full((n,), cfg.capacity, dtype=torch.int64,
                           device=points.device)
    for off in _stencil(cfg.neighbor_voxel_mode):
        vc = torch.stack([vc0[:, k] + off[k] for k in range(3)], dim=-1)
        slot, found = find_slots(vmap, vc, cfg)
        d = vmap.mean[slot] - points
        d2 = torch.sum(d * d, dim=-1)
        better = vmap.plane_valid[slot] & found & (d2 < best_d2)
        best_d2 = torch.where(better, d2, best_d2)
        best_slot = torch.where(better, slot, best_slot)
    return (vmap.normal[best_slot], vmap.mean[best_slot],
            best_slot < cfg.capacity)
