"""Mesh sharding of the map and the ICP linearization over torch.distributed.

Port of ``mimosa_tpu/parallel/sharded.py``. The JAX package runs one
process over a ``('dp', 'mp')`` mesh of devices with ``shard_map``; here
the idiom is PyTorch's own: SPMD, one process a device, every rank
replaying identical inputs, and a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("dp", "mp")``
over the default process group, whose two sub-groups carry the
collectives:

* **dp** -- points (and radar targets) split over ranks: each rank
  linearizes its rows, and the normal equations are summed over the world;
* **mp** -- the voxel map split over ranks by the hash bits above the slot
  index: each rank holds one sub-table (``create_sharded_map``), a point
  batch is masked to the rank's ownership before its insert (no
  collective), and a query's candidate planes are combined over ``mp`` by
  the least distance to the plane's mean, ties to the lowest mp index.

Every collective goes through ``torch.distributed`` whenever a mesh is
given, a group of one included; on the card they are recorded into the
Sequencer's captured step graphs (``graph/captured.py``). With one dp rank
the rank's combined matches go to the ICP kernel (``ops/icp_cuda.py``),
which then computes the whole result; with more, the reduction is split by
a world ``all_reduce`` between the sums and the eigen-analysis, so it runs
as torch ops around two all-reduces, as the JAX package's runs as XLA ops
around ``psum``.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.core.eigh3 import eigh3
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.mapping import voxel_hash as vh
from mimosa_tpu_torch.ops import icp_cuda
from mimosa_tpu_torch.radar import factor as rad

DIMS = ("dp", "mp")
# the rank code of a point no shard matched (JAX: 2**30)
_NO_WIN = 2 ** 30


def make_mesh(n_mp=None, device_type="cuda"):
    """A ``("dp", "mp")`` DeviceMesh over every rank of the initialized
    default process group, row-major (rank = dp index * n_mp + mp index),
    as the JAX package's ``make_mesh`` reshapes its devices.

    ``n_mp`` defaults to 2 where the world size is even and at least 4,
    else 1. It must be a power of two: ownership is a bitmask of the
    spatial hash (``_owner_ok``), so another mp degree would leave shards
    owning nothing; that is refused before any group is made."""
    if n_mp is not None and (n_mp < 1 or n_mp & (n_mp - 1)):
        raise ValueError(f"n_mp must be a power of two, got {n_mp}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n_mp is None:
        n_mp = 2 if n % 2 == 0 and n >= 4 else 1
    if n % n_mp:
        raise ValueError(f"n_mp={n_mp} does not divide the world size {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // n_mp, n_mp),
                      mesh_dim_names=DIMS)


def _shape(mesh):
    """(n_dp, n_mp, dp index, mp index) of this rank."""
    return (mesh.size(0), mesh.size(1), mesh.get_local_rank("dp"),
            mesh.get_local_rank("mp"))


def _world(mesh):
    """The group of the whole mesh: the default group, which the mesh must
    cover (the world sums run there in one collective)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} ranks of a world of "
                         f"{dist.get_world_size()}")
    return dist.group.WORLD


def create_sharded_map(cfg: vh.VoxelMapConfig, mesh, device=None,
                       dtype=torch.float32) -> vh.VoxelMap:
    """This rank's sub-table: row ``mp index`` of the JAX package's stacked
    map ``[n_mp, C+1, ...]`` (replicated over dp). Total capacity is
    ``n_mp * 2**capacity_log2``."""
    return vh.create(cfg, device, dtype)


def _owner_ok(points, leaf, n_mp, mp_idx, cap_log2):
    """Ownership mask: the point's voxel belongs to mp shard ``mp_idx``.

    The ownership bits sit strictly above the slot index bits (the slot is
    ``hash & (2**cap_log2 - 1)``), else each shard's voxels would crowd
    into the 1/n_mp of its sub-table whose slot bits equal its index. The
    shift is logical (on the hash's unsigned 32 bits), so the selector is
    uniform for negative hashes too."""
    h = vh.hash_coords(vh.voxel_coords(points, leaf))
    if n_mp <= 1:
        return torch.ones(h.shape, dtype=torch.bool, device=h.device)
    assert n_mp & (n_mp - 1) == 0, "n_mp must be a power of two"
    assert cap_log2 + (n_mp - 1).bit_length() <= 32, \
        "not enough hash bits above the slot index for this mp degree"
    own = ((h & 0xFFFFFFFF) >> cap_log2) & (n_mp - 1)
    return own == mp_idx


def sharded_insert(vmap, points, valid, scan_idx, map_cfg: vh.VoxelMapConfig,
                   mesh) -> vh.VoxelMap:
    """Insert a replicated point batch into this rank's sub-table: the
    batch masked to the rank's ownership, then insert, eviction and the
    refit of the touched voxels. No collective."""
    _, n_mp, _, mp_i = _shape(mesh)
    own = _owner_ok(points, map_cfg.leaf_size, n_mp, mp_i,
                    map_cfg.capacity_log2)
    vmap, slots = vh.insert(vmap, points, valid & own, scan_idx, map_cfg,
                            return_slots=True)
    vmap = vh.evict_stale(vmap, scan_idx, map_cfg)
    return vh.update_planes_at(vmap, slots, map_cfg)


def _dp_rows(n, mesh):
    """This rank's slice of ``n`` rows split over dp."""
    n_dp, _, dp_i, _ = _shape(mesh)
    if n % n_dp:
        raise ValueError(f"{n} rows do not split over {n_dp} dp ranks")
    k = n // n_dp
    return slice(dp_i * k, (dp_i + 1) * k)


def _combine(normal, mean, found, p_w, mesh):
    """Each point's plane among the mp shards' candidates: the least
    squared distance to the plane's mean (``all_reduce`` MIN), ties to the
    lowest mp index (a second MIN of the rank code), then the winner's
    normal, mean and flag summed over mp in one packed ``all_reduce``."""
    g = mesh.get_group("mp")
    mp_i = mesh.get_local_rank("mp")
    d = mean - p_w
    d2 = torch.where(found, torch.sum(d * d, dim=-1),
                     torch.finfo(p_w.dtype).max)
    d2min = d2.clone()
    dist.all_reduce(d2min, op=dist.ReduceOp.MIN, group=g)
    is_win = found & (d2 <= d2min)
    code = torch.full(found.shape, _NO_WIN, dtype=torch.int32,
                      device=found.device).masked_fill(is_win, mp_i)
    code_min = code.clone()
    dist.all_reduce(code_min, op=dist.ReduceOp.MIN, group=g)
    wf = (is_win & (code == code_min)).to(p_w.dtype)
    n = wf.shape[0]
    # flat, so each part is a contiguous view (the ICP kernel's layout)
    packed = torch.cat([(normal * wf[:, None]).reshape(-1),
                        (mean * wf[:, None]).reshape(-1), wf])
    dist.all_reduce(packed, group=g)
    return (packed[:3 * n].view(n, 3), packed[3 * n:6 * n].view(n, 3),
            packed[6 * n:] > 0)


def sharded_linearize(vmap, points_b, valid, q, t, g_dir,
                      map_cfg: vh.VoxelMapConfig, cfg: geo.GeometricConfig,
                      mesh) -> geo.ICPResult:
    """Mesh-sharded ICP linearization: points over dp, the map over mp.

    The semantics of ``geo.linearize`` (the gates, the Huber weight, the
    two localizability thresholds, the 4-DoF projection): a fresh match of
    this rank's points against its sub-table, combined over mp
    (:func:`_combine`). With one dp rank the points are replicated over
    mp, so the combined matches give the whole answer on every rank in one
    launch of the ICP kernel (``icp_cuda.linearize``; its plain version on
    the CPU). With more, :func:`_reduce_dp` sums over the world."""
    rows = _dp_rows(points_b.shape[0], mesh)
    pts, vd = points_b[rows], valid[rows]
    p_w = pts @ lie.quat_to_mat(q).T + t
    matches = _combine(*vh.query_planes(vmap, p_w, map_cfg), p_w, mesh)
    if mesh.size(0) == 1:
        return icp_cuda.linearize(matches, pts, vd, q, t, cfg, g_dir=g_dir)
    return _reduce_dp(matches, pts, vd, q, t, g_dir, cfg, mesh)


def _reduce_dp(matches, pts, vd, q, t, g_dir, cfg, mesh):
    """The linearization of this rank's dp rows, summed over the world:
    H, b, the unweighted rotation and translation blocks, the status
    counts, sum |r| m and sum m in one packed ``all_reduce``, the eigen-
    analysis, then the projection counts in a second. Per-point quantities
    are replicated over mp after the combine, so every world sum is
    divided by n_mp (the JAX package's ``allsum``)."""
    n_mp, world = mesh.size(1), _world(mesh)
    dtype = pts.dtype
    R = lie.quat_to_mat(q)
    normal, mean, found = matches
    r = torch.sum(normal * (pts @ R.T + t - mean), dim=-1)
    inlier, in_dist, in_s = geo.inlier_gates(r, pts, vd, found, cfg)
    ar = torch.abs(r)
    w_h = torch.where(ar <= cfg.huber_delta, torch.ones_like(ar),
                      cfg.huber_delta / torch.clamp(ar, min=1e-12))
    w = torch.where(inlier, w_h, torch.zeros_like(ar)) / cfg.sigma ** 2
    nR = normal @ R
    j_rot = lie.cross(pts, nR)
    J = torch.cat([j_rot, nR], dim=-1)
    m = inlier.to(dtype)
    counts = torch.stack([
        inlier.sum(), (vd & ~found).sum(), (vd & found & ~in_dist).sum(),
        (vd & found & in_dist & ~in_s).sum()]).to(dtype)
    sums = torch.cat([((J * w[:, None]).T @ J).reshape(36), J.T @ (w * r),
                      ((j_rot * m[:, None]).T @ j_rot).reshape(9),
                      ((nR * m[:, None]).T @ nR).reshape(9), counts,
                      torch.sum(ar * m).reshape(1), m.sum().reshape(1)])
    dist.all_reduce(sums, group=world)
    sums = sums / n_mp
    H, b = sums[0:36].reshape(6, 6), sums[36:42]
    lam_r, V_r = eigh3(sums[42:51].reshape(3, 3))
    lam_t, V_t = eigh3(sums[51:60].reshape(3, 3))
    counts = sums[60:64].to(torch.int32)
    mean_abs = sums[64] / torch.clamp(sums[65], min=1.0)
    strong = torch.cat([
        (torch.abs(j_rot @ V_r) >= cfg.loc_proj_cutoff) & inlier[:, None],
        (torch.abs(nR @ V_t) >= cfg.loc_proj_cutoff) & inlier[:, None]],
        dim=1).to(dtype).sum(0)
    dist.all_reduce(strong, group=world)
    strong = strong / n_mp
    cnt_r, cnt_t = strong[:3], strong[3:]
    if cfg.use_4dof:
        H, b = geo.four_dof_projection(H, b, R, g_dir)
    return geo.ICPResult(H, b, counts[0], counts, mean_abs,
                         cnt_r.to(torch.int32), cnt_t.to(torch.int32),
                         lam_r, lam_t, V_r, V_t,
                         cnt_r < cfg.loc_count_thresh_rot,
                         cnt_t < cfg.loc_count_thresh)


def sharded_radar_linearize(q_wb, v_w, bg, omega_b, dirs_r, doppler, valid,
                            radar_cfg: rad.RadarConfig, mesh
                            ) -> rad.DopplerResult:
    """The Doppler 9x9 block with the targets split over dp: each rank's
    rows linearized, then H, b, the inlier count and sum |r| summed over
    the world in one packed ``all_reduce`` and divided by n_mp (the
    targets are replicated over mp)."""
    rows = _dp_rows(dirs_r.shape[0], mesh)
    res = rad.linearize(q_wb, v_w, bg, omega_b, dirs_r[rows], doppler[rows],
                        valid[rows], radar_cfg)
    n = res.num_inlier.to(res.H.dtype)
    sums = torch.cat([res.H.reshape(81), res.b, n.reshape(1),
                      (res.mean_abs_res * torch.clamp(n, min=1.0))
                      .reshape(1)])
    dist.all_reduce(sums, group=_world(mesh))
    sums = sums / mesh.size(1)
    return rad.DopplerResult(sums[0:81].reshape(9, 9), sums[81:90],
                             sums[90].to(torch.int32),
                             sums[91] / torch.clamp(sums[90], min=1.0))


def sequencer_fns(mesh, map_cfg: vh.VoxelMapConfig,
                  cfg: geo.GeometricConfig):
    """(linearize_fn, map_update_fn): the mesh's ICP linearization and map
    insert, which ``Sequencer(mesh=...)`` puts into its scan, late-scan,
    initialization and keyframe steps."""
    _world(mesh)

    def linearize_fn(vmap, pts, valid, q, t, g_dir):
        return sharded_linearize(vmap, pts, valid, q, t, g_dir, map_cfg, cfg,
                                 mesh)

    def map_update_fn(vmap, pts, valid, idx):
        return sharded_insert(vmap, pts, valid, idx, map_cfg, mesh)

    return linearize_fn, map_update_fn


def radar_linearize_fn(mesh, radar_cfg: rad.RadarConfig):
    """The dp-split Doppler linearization for ``Sequencer(mesh=...)``'s
    radar steps: (q, v, bg, omega, dirs, doppler, valid) -> DopplerResult."""
    return functools.partial(sharded_radar_linearize, radar_cfg=radar_cfg,
                             mesh=mesh)


def make_sharded_scan_step(mesh, seq_cfg, win_cfg, map_cfg, geo_cfg,
                           photo_cfg=None, marginalize_first=False,
                           append=True):
    """The scan step with the mesh's linearization and insert: the
    single-device ``_scan_step`` (same arguments; ``map`` this rank's
    sub-table). The photometric factor, where configured, runs replicated,
    as in the JAX package."""
    from mimosa_tpu_torch.graph import sequencer as sq

    linearize_fn, map_update_fn = sequencer_fns(mesh, map_cfg, geo_cfg)
    return functools.partial(
        sq._scan_step, seq_cfg=seq_cfg, win_cfg=win_cfg, map_cfg=map_cfg,
        geo_cfg=geo_cfg, photo_cfg=photo_cfg,
        marginalize_first=marginalize_first, append=append,
        linearize_fn=linearize_fn, map_update_fn=map_update_fn)


def make_sharded_radar_step(mesh, seq_cfg, win_cfg, radar_cfg, declare=True):
    """The radar step (declare or attach) with the targets split over dp:
    the single-device ``_radar_step`` on the Sequencer's state."""
    from mimosa_tpu_torch.graph import sequencer as sq

    return functools.partial(
        sq._radar_step, mode="declare" if declare else "attach",
        seq_cfg=seq_cfg, win_cfg=win_cfg, radar_cfg=radar_cfg,
        linearize_fn=radar_linearize_fn(mesh, radar_cfg))


def make_sharded_odom_step(mesh, seq_cfg, win_cfg, odom_cfg, declare=True):
    """The odometry step on the mesh: one relative pose has nothing to
    split, so it runs replicated (the single-device ``_odom_step``); the
    mesh is taken for the signature the JAX package gives it."""
    from mimosa_tpu_torch.graph import sequencer as sq

    return functools.partial(sq._odom_step, declare=declare, seq_cfg=seq_cfg,
                             win_cfg=win_cfg, odom_cfg=odom_cfg)
