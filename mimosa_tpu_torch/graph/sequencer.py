"""Deterministic measurement sequencer: the four-modality streaming
estimator (LiDAR, radar Doppler, external odometry, IMU).

Port of the streaming paths of ``mimosa_tpu/graph/sequencer.py``: a host
event loop (IMU buffering, initialization, same-key collapse, out-of-order
insertion, window sliding) feeding device step functions on torch tensors:

* ``_scan_step``: decode -> deskew -> preintegrate + append -> voxel
  downsample -> correspondence match -> ``n_gn_iters`` Gauss-Newton
  iterations with live ICP relinearization (the CUDA kernel of
  ``ops/icp_cuda.py`` on the card) -> absorb the scan into the prior ->
  keyframe test, map insert, eviction and plane refit -> trajectory and
  debug rows; with ``merge_marginalize`` the window slide runs first in the
  same step. With ``photo_cfg`` (PG-LIO, ``lidar/photometric.py``) the
  scan also builds an intensity frame, the photometric patch factor joins
  every GN iteration and the absorb, and the feature store is tracked and
  topped up at the converged pose. ``append=False`` attaches the scan to
  an existing state (same key, in order or late);
* ``_scan_ooo_step``: a late scan's state inserted mid-window, the two IMU
  segments around it re-integrated, then the scan step's GN (the ICP
  kernel), absorb and keyframe-gated map update on the inserted slot;
* ``_radar_step``: the Doppler factor (``radar/factor.py``) on a declared,
  newest, neighbouring or inserted state;
* ``_odom_step``: the odometry between factor (``odometry/factor.py``)
  from the previous message's state to a declared or the newest state;
* ``_declare_step``: a state from the IMU alone (an odometry anchor);
* ``_marginalize``: Schur-complement slide of the window;
* ``_init_lidar_step`` / ``_init_inertial_step``: state setup, with the
  first-scan map seed, or from the IMU alone for a radar or odometry
  sensor with ``use_to_init``.

Scans travel to the device in one of three codecs, as in the JAX package:
int16 xyz with a subtractive per-lane dither (the default), int16
range-image rows decoded against a resident beam table
(``range_transfer``), or plain f32. The int16 packs come from the port's
C++ pack (``mimosa_tpu_torch/native``).

The steps read nothing back to the host: counts, slots and indices stay
0-d device tensors, inputs go up through pinned memory without a sync, and
the trajectory / debug logs are device rings read once at the end. On the
card each step variant is captured once as a CUDA graph and replayed
(``graph/captured.py``); ``eager=True`` runs it op by op instead.

The offline bulk scheduler (``add_bulk``, ``add_scans_bulk``) runs the
steady-state events of a recorded sequence in chunks: one host pack and
one copy per input slab a chunk, then each event replays its streaming
variant with its inputs taken from rows of the device slabs.

``freeze_map`` is localization mode: the scan steps leave the map and the
keyframe ring as they came in (pass 2 of the two-pass refinement, or
localization against a prior map given as ``init_map``).

The scan step (not the late-scan step) also carries the JAX package's two
optional branches: ``rematch_on_motion`` (points that moved past a quarter
leaf during GN are matched again) and ``rescue_enabled`` (a batched
multi-start search when the scan's inliers collapse, recorded on the card
as a conditional node of the step's graph; debug slot 16 flags the scans
it ran on).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import logging
import typing

import numpy as np
import torch

from mimosa_tpu_torch import native, require_cuda
from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.graph import window as win
from mimosa_tpu_torch.graph.captured import CapturedSteps, cond, flatten, \
    unflatten
from mimosa_tpu_torch.imu import preintegration as pre
from mimosa_tpu_torch.imu.buffer import ImuBuffer, estimate_attitude
from mimosa_tpu_torch.lidar import deskew as dk
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.lidar import photometric as ph
from mimosa_tpu_torch.lidar.downsample import voxel_downsample
from mimosa_tpu_torch.mapping import voxel_hash as vh
from mimosa_tpu_torch.odometry import factor as odo
from mimosa_tpu_torch.ops import icp_cuda
from mimosa_tpu_torch.parallel import sharded
from mimosa_tpu_torch.radar import factor as rad
from mimosa_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("mimosa_tpu_torch.sequencer")

# per-scan debug record: 17 status slots (num_inlier, 4 status counts,
# mean |r|, 3+3 degeneracy flags, 4 photometric slots, rescue flag), the
# upper triangle (21) of the scan's absorbed pose information [6,6], and
# the 9 IMU-factor localizability eigenvalues (rot, pos, vel ascending)
DBG_W = 17 + 21 + 9
_TRIU6 = np.triu_indices(6)
# photometric status counts logged into debug slots 13-15 (OOB,
# MASKED + OCCLUDED, NCC)
PH_SUM_SLOTS = (1, 3, 4, 5)

# the Sequencer's device state, in the order the step functions return it;
# a photometric Sequencer carries its feature store last
STATE = ("window", "vmap", "preints", "fv", "kf_q", "kf_p", "kf_count",
         "traj_q", "traj_p", "debug_rec")
PHOTO_STATE = STATE + ("features",)
# a Sequencer's own step-cache salt where its steps are not shared (a mesh,
# an unhashable configuration): a number never given twice in a process
_INSTANCES = itertools.count()


class EstimatorState(typing.NamedTuple):
    """Host-side snapshot of one optimized state."""

    ts: float
    q: np.ndarray      # [4] body->world rotation, wxyz Hamilton
    p: np.ndarray      # [3] position in world
    v: np.ndarray      # [3] velocity in world
    bg: np.ndarray     # [3] gyro bias
    ba: np.ndarray     # [3] accel bias
    g_dir: np.ndarray  # [3] unit gravity direction in world


def _extract_states(window):
    """All window slots as one [K, 19] row matrix (q, p, v, bg, ba, g_dir),
    so a state query reads the device once."""
    K = window.q.shape[0]
    return torch.cat([window.q, window.p, window.v, window.bg, window.ba,
                      window.g_dir.expand(K, 3)], dim=1)


def _slerp_np(q0, q1, a):
    """Host-side quaternion slerp (wxyz), shortest arc."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + a * (q1 - q0)
    else:
        th = np.arccos(min(max(d, -1.0), 1.0))
        q = (np.sin((1.0 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)
    return q / np.linalg.norm(q)


@dataclasses.dataclass(frozen=True)
class SequencerConfig:
    # shapes (static)
    max_imu_per_segment: int = 256
    max_scan_points: int = 32768
    n_geo_points: int = 8192          # geometric downsample size
    n_map_points: int = 16384         # map-insertion downsample size
    # behavior
    n_gn_iters: int = 3
    geo_leaf: float = 0.5             # geometric downsample leaf [m]
    map_insert_leaf: float = 0.15     # map insertion downsample leaf [m]
    g_mag: float = 9.81
    pose_init_wait_secs: float = 0.5
    gravity_aligned_init: bool = True
    min_imu_between_states: int = 2   # same-key threshold
    max_measurement_latency: float = 0.5
    # fixed lag in seconds (0 = the window slides only when K slots fill)
    lag_secs: float = 0.0
    # keyframe policy
    keyframe_trans_thresh: float = 0.5
    keyframe_rot_thresh: float = 0.2  # rad
    num_initial_keyframes: int = 5
    # IMU noise (continuous densities squared)
    acc_var: float = 1e-3
    gyro_var: float = 1e-5
    int_var: float = 1e-8
    # host IMU buffer
    imu_acc_scale: float = 1.0
    imu_max_buffer_duration: float = 30.0
    # extrinsics T_B_L (lidar in body)
    q_b_l: tuple = (1.0, 0.0, 0.0, 0.0)
    t_b_l: tuple = (0.0, 0.0, 0.0)
    # device-resident logging capacities (static)
    max_keyframes: int = 2048
    max_trajectory: int = 65536
    # transfer codecs: int16 xyz with a subtractive per-lane dither (the
    # default), int16 range-image rows (range_transfer, needs ray_dirs), or
    # plain f32 (quantize_transfer=False)
    quantize_transfer: bool = True
    quant_pos_res: float = 0.0025
    quant_t_res: float = 4e-6
    quant_int_res: float = 0.25
    quant_dither: bool = True
    range_transfer: bool = False
    quant_range_res: float = 0.0015
    point_skip: int = 1               # keep every k-th point at pack time
    geo_skip: int = 1                 # every k-th lane feeds geometry
    refresh_match_on_absorb: bool = False
    merge_marginalize: bool = False
    rematch_on_motion: bool = False
    rescue_enabled: bool = False
    rescue_radius: float = 0.0
    rescue_yaw: float = 0.08
    rescue_min_inlier_frac: float = 0.3
    freeze_map: bool = False


def _scan_ncol(cfg, photo=False):
    """Packed-scan column count: range mode ships (r, t[, i]), the xyz
    modes (x, y, z, t[, i]); the intensity column travels only for a
    photometric Sequencer (``photo``)."""
    return (2 if cfg.range_transfer else 4) + int(photo)


def _t_col(cfg):
    """Column index of the packed point time (whose -32768 sentinel marks
    invalid lanes in the int16 codecs)."""
    return 1 if cfg.range_transfer else 3


def _pad_scan(points, t_abs, valid, n):
    k = min(len(points), n)
    pts = np.zeros((n, 3))
    tp = np.zeros(n)
    vd = np.zeros(n, bool)
    pts[:k] = points[:k]
    tp[:k] = t_abs[:k]
    vd[:k] = valid[:k]
    pts[~np.isfinite(pts).all(-1)] = 0.0
    return pts, tp, vd


# ---------------------------------------------------------------------------
# device step functions
# ---------------------------------------------------------------------------

def _row(x, i):
    """x[i] for a 0-d device index tensor, without reading it back."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _put_row(x, i, v):
    """x with row i replaced by v (out of place)."""
    return x.index_copy(0, i.reshape(1), v.unsqueeze(0))


def _set_segment(preints, i, seg):
    return pre.PreintState(*[_put_row(a, i, s) for a, s in zip(preints, seg)])


def _shift_segments(preints, fv):
    """Drop segment 0 after a marginalization (the freed tail repeats)."""
    preints = pre.PreintState(*[torch.cat([a[1:], a[-1:]]) for a in preints])
    return preints, torch.cat([fv[1:], torch.zeros_like(fv[:1])])


def _map_update(vmap, pts_w, valid, scan_idx, *, map_cfg):
    """Insert + evict + full plane refit (used once, by initialization)."""
    vmap = vh.insert(vmap, pts_w, valid, scan_idx, map_cfg)
    vmap = vh.evict_stale(vmap, scan_idx, map_cfg)
    return vh.update_planes(vmap, map_cfg)


def _map_update_at(vmap, pts_w, valid, scan_idx, *, map_cfg):
    """Insert + evict + refit of the touched voxels only (per scan)."""
    vmap, slots = vh.insert(vmap, pts_w, valid, scan_idx, map_cfg,
                            return_slots=True)
    vmap = vh.evict_stale(vmap, scan_idx, map_cfg)
    return vh.update_planes_at(vmap, slots, map_cfg)


def _keyframe_map_update(vmap, q_new, p_new, points_le, pt_valid,
                         kf_q, kf_p, kf_count, scan_idx, q_bl, t_bl,
                         *, seq_cfg, map_cfg, map_update_fn=None):
    """Keyframe decision + gated map insert + keyframe ring update, all on
    the device (a non-keyframe inserts with every lane masked).
    ``map_update_fn(vmap, pts, valid, scan_idx)`` replaces the insert
    (:func:`_map_update_at`) on a mesh."""
    KF = seq_cfg.max_keyframes
    kf_mask = torch.arange(KF, device=kf_count.device) < kf_count
    dmin = torch.min(torch.where(
        kf_mask, torch.linalg.vector_norm(kf_p - p_new, dim=-1),
        torch.inf))
    dots = torch.abs(kf_q @ q_new)
    amin = torch.min(torch.where(
        kf_mask, 2.0 * torch.acos(torch.clamp(dots, -1.0, 1.0)), torch.inf))
    is_kf = ((kf_count < seq_cfg.num_initial_keyframes)
             | (dmin > seq_cfg.keyframe_trans_thresh)
             | (amin > seq_cfg.keyframe_rot_thresh))

    q_wl, t_wl = lie.se3_compose(q_new, p_new, q_bl, t_bl)
    pts_w = lie.se3_transform(q_wl, t_wl, points_le)
    map_pts, map_valid, _ = voxel_downsample(
        pts_w, pt_valid, seq_cfg.map_insert_leaf, seq_cfg.n_map_points)
    if map_update_fn is None:
        vmap = _map_update_at(vmap, map_pts, map_valid & is_kf, scan_idx,
                              map_cfg=map_cfg)
    else:
        vmap = map_update_fn(vmap, map_pts, map_valid & is_kf, scan_idx)

    kf_slot = torch.where(is_kf, kf_count, KF - 1).to(torch.int64)
    kf_q = _put_row(kf_q, kf_slot, torch.where(is_kf, q_new,
                                               _row(kf_q, kf_slot)))
    kf_p = _put_row(kf_p, kf_slot, torch.where(is_kf, p_new,
                                               _row(kf_p, kf_slot)))
    return vmap, kf_q, kf_p, kf_count + is_kf.to(torch.int32)


def _mul32(h, c):
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a constant c < 2^32,
    in two 16-bit halves of c so no product leaves int64 (torch has no
    wrapping uint32 multiply)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _dither_lanes(n, dtype, device=None):
    """Per-lane position dither [n, 3] in [-0.5, 0.5): bit for bit the
    JAX package's ``_dither_lanes`` and the pack's dither01 (a Knuth
    multiplicative hash of the packed row index with a xorshift finalizer,
    one salt per axis)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    cols = []
    for salt in native._DITHER_SALTS:
        h = _mul32(lane, 2654435761) ^ salt
        h = h ^ (h >> 16)
        h = _mul32(h, 2246822519)
        h = h ^ (h >> 13)
        cols.append(h.to(dtype) / 4294967296.0 - 0.5)
    return torch.stack(cols, dim=-1)


def _decode_scan(scan_f, pt_valid, t_offset, seq_cfg, d, ray_dirs=None,
                 dither=None):
    """Unpack a staged scan into (points [N,3], times [N], intensity [N],
    valid [N]).

    int16 codecs: ``(x + 32767) * res`` in the JAX package's operation
    order, the per-lane dither (``dither``, the resident
    :func:`_dither_lanes` table) removed before scaling, and the sentinel
    ``t == -32768`` as the validity mask, so ``pt_valid`` is unused. The
    range codec rebuilds xyz = range * dir (+ offset for the affine [N,6]
    table) from the resident ``ray_dirs``. The f32 codec ships (x, y, z,
    t) and its own mask. Point times shift from scan-header-relative to the
    IMU-segment base by ``t_offset``. The intensity column follows the
    time column when the pack has one (at ``quant_int_res`` in the int16
    codecs); without it the intensity is zero."""
    tc = _t_col(seq_cfg)
    has_inten = scan_f.shape[1] > tc + 1
    if not seq_cfg.quantize_transfer:
        inten = scan_f[:, tc + 1] if has_inten \
            else torch.zeros_like(scan_f[:, 0])
        return scan_f[:, :3], scan_f[:, tc] + t_offset, inten, pt_valid
    inten = scan_f[:, tc + 1].to(d) * seq_cfg.quant_int_res if has_inten \
        else torch.zeros(scan_f.shape[0], dtype=d, device=scan_f.device)
    if seq_cfg.range_transfer:
        rq = scan_f[:, 0].to(d) + 32767.0
        if seq_cfg.quant_dither:
            rq = rq - dither[:, 0]
        r = rq * seq_cfg.quant_range_res
        pts = r[:, None] * ray_dirs[:, :3]
        if ray_dirs.shape[1] == 6:
            pts = pts + ray_dirs[:, 3:6]
    else:
        q = scan_f[:, :3].to(d)
        if seq_cfg.quant_dither:
            q = q - dither
        pts = q * seq_cfg.quant_pos_res
    t_pts = (scan_f[:, tc].to(d) + 32767.0) * seq_cfg.quant_t_res + t_offset
    return pts, t_pts, inten, scan_f[:, tc] != -32768


def _world_points(pts_b, q, t):
    """Body-frame points [N,3] at pose (q, t) in the world frame, as
    ``geo.match`` places them."""
    return pts_b @ lie.quat_to_mat(q).T + t


def _rematch(vmap, pts_geo, geo_valid, matches, p_da, q, t, map_cfg):
    """Per-point re-association after a GN update (``rematch_on_motion``):
    the points that moved more than a quarter leaf since their last
    association take the match at the new pose (q, t), and ``p_da`` their
    new world position, where any valid point moved. The JAX package
    branches on that condition; here the match runs every time and the
    selection gives the branch's result, invalid lanes included.
    Returns (matches, p_da)."""
    p_now = _world_points(pts_geo, q, t)
    moved = torch.linalg.vector_norm(p_now - p_da, dim=-1) \
        > 0.25 * map_cfg.leaf_size
    sel = moved & (moved & geo_valid).any()
    fresh = vh.query_planes(vmap, p_now, map_cfg)
    matches = tuple(torch.where(sel.reshape(-1, *[1] * (m.ndim - 1)), f, m)
                    for f, m in zip(fresh, matches))
    return matches, torch.where(sel[:, None], p_now, p_da)


# the window fields the rescue changes
_RESCUE_FIELDS = ("q", "p", "v", "bg", "ba", "g_dir", "lin_q", "lin_p")


@functools.lru_cache(maxsize=None)
def _rescue_candidates(rr, ry, dtype, device):
    """The rescue's 13 candidate offsets [dx, dy, dz, yaw] around the
    predicted pose: the centre, 6 axis offsets of ``rr``, 4 diagonals of
    0.7071 ``rr`` and 2 yaw twists of ``ry``; made once per (value,
    device, dtype), by the first call of a step variant (its eager
    warm-up), so a captured step holds no host copy."""
    dg = 0.7071 * rr
    return torch.tensor(
        [[0, 0, 0, 0],
         [rr, 0, 0, 0], [-rr, 0, 0, 0], [0, rr, 0, 0], [0, -rr, 0, 0],
         [0, 0, rr, 0], [0, 0, -rr, 0],
         [dg, dg, 0, 0], [dg, -dg, 0, 0], [-dg, dg, 0, 0], [-dg, -dg, 0, 0],
         [0, 0, 0, ry], [0, 0, 0, -ry]], dtype=dtype, device=device)


def _rescue_search(vmap, pts_geo, geo_valid, g_dir, q_conv, p_conv, q_pre,
                   p_pre, cands, *, map_cfg, geo_cfg):
    """The rescue's multi-start search, batched: the converged pose (row
    0) and the 13 candidates around the predicted one (rows 1-13) are
    matched in one query, each refined by 2 damped pose-only GN steps
    against its own matches (one ICP launch a pose and step, one batched
    6x6 solve a step), matched again and scored by inlier count minus
    mean |r| / sigma. Returns the first best pose (q, t)."""
    q_c = lie.quat_normalize(lie.quat_mul(
        lie.exp_so3(-g_dir * cands[:, 3:4]), q_pre))   # yaw about up
    qs = torch.cat([q_conv[None], q_c])
    ts = torch.cat([p_conv[None], p_pre + cands[:, :3]])
    B, n = qs.shape[0], pts_geo.shape[0]

    def match(qs, ts):
        pw = pts_geo @ lie.quat_to_mat(qs).transpose(1, 2) + ts[:, None]
        normal, mean, found = vh.query_planes(vmap, pw.reshape(-1, 3),
                                              map_cfg)
        return normal.view(B, n, 3), mean.view(B, n, 3), found.view(B, n)

    def linearize(m, qs, ts):
        return [icp_cuda.linearize((m[0][i], m[1][i], m[2][i]), pts_geo,
                                   geo_valid, qs[i], ts[i], geo_cfg,
                                   g_dir=g_dir) for i in range(B)]

    m = match(qs, ts)
    eye = torch.eye(6, dtype=qs.dtype, device=qs.device)
    for _ in range(2):
        res = linearize(m, qs, ts)
        H = torch.stack([r.H for r in res])
        b = torch.stack([r.b for r in res])
        lam = 1e-3 * torch.diagonal(H, dim1=1, dim2=2).sum(-1) / 6.0 + 1e-6
        dx = torch.linalg.solve_ex(H + lam[:, None, None] * eye, -b,
                                   check_errors=False)[0]
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        qs, ts = lie.se3_retract(qs, ts, dx)
    res = linearize(match(qs, ts), qs, ts)
    score = torch.stack([r.num_inlier.to(qs.dtype)
                         - r.mean_abs_res / geo_cfg.sigma for r in res])
    best = torch.argmax(score)
    return _row(qs, best), _row(ts, best)


def _rescue_search_mesh(linearize_fn, vmap, pts_geo, geo_valid, g_dir,
                        q_conv, p_conv, q_pre, p_pre, cands, *, geo_cfg):
    """The rescue's multi-start search on a mesh, in the JAX package's
    sequential form (``lax.map``, since its mesh linearization does not
    batch): each of the 14 poses of :func:`_rescue_search` (the converged
    one, then the 13 candidates) refined by 2 damped pose-only GN steps and
    scored through ``linearize_fn``, which matches afresh on every call
    (3 calls a pose). Returns the first best pose (q, t)."""
    q_c = lie.quat_normalize(lie.quat_mul(
        lie.exp_so3(-g_dir * cands[:, 3:4]), q_pre))   # yaw about up
    qs = torch.cat([q_conv[None], q_c])
    ts = torch.cat([p_conv[None], p_pre + cands[:, :3]])
    eye = torch.eye(6, dtype=qs.dtype, device=qs.device)
    scores, q_f, t_f = [], [], []
    for q, t in zip(qs, ts):
        for _ in range(2):
            res = linearize_fn(vmap, pts_geo, geo_valid, q, t, g_dir)
            lam = 1e-3 * torch.trace(res.H) / 6.0 + 1e-6
            dx = torch.linalg.solve_ex(res.H + lam * eye, -res.b,
                                       check_errors=False)[0]
            dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
            q, t = lie.se3_retract(q, t, dx)
        res = linearize_fn(vmap, pts_geo, geo_valid, q, t, g_dir)
        scores.append(res.num_inlier.to(q.dtype)
                      - res.mean_abs_res / geo_cfg.sigma)
        q_f.append(q)
        t_f.append(t)
    best = torch.argmax(torch.stack(scores))
    return _row(torch.stack(q_f), best), _row(torch.stack(t_f), best)


def _rescue_realign(window, slot, q_b, t_b, p_pre):
    """Translate every active state, values and linearization points, by
    the winner's offset from the predicted position, and set the slot to
    the winner: the relative factors do not see a global translation."""
    delta = t_b - p_pre
    act = window.active[:, None]
    p = torch.where(act, window.p + delta, window.p)
    lin_p = torch.where(act, window.lin_p + delta, window.lin_p)
    return window._replace(
        q=_put_row(window.q, slot, q_b), p=_put_row(p, slot, t_b),
        lin_q=_put_row(window.lin_q, slot, q_b),
        lin_p=_put_row(lin_p, slot, t_b))


def _scan_step(window, vmap, preints, fv, scan_f, pt_valid, imu_f,
               kf_q, kf_p, kf_count, traj_q, traj_p, debug_rec, q_bl, t_bl,
               ray_dirs=None, dither=None, static_mask=None, features=None,
               *, seq_cfg, win_cfg, map_cfg, geo_cfg, photo_cfg=None,
               marginalize_first=False, append=True, linearize_fn=None,
               map_update_fn=None):
    """The per-scan pipeline. ``imu_f`` [M+1, 8]: M IMU rows (acc3, gyro3,
    dt, valid) and a last row of scalars [n_active (count BEFORE the
    append), t_end_rel, traj_idx, scan_idx, t_offset, attach_slot].
    ``scan_f`` / ``pt_valid`` are the staged scan in the configured codec
    (:func:`_decode_scan`).

    ``marginalize_first`` slides the window before the scan (the merged
    marginalization: the host has already counted the slot free).
    ``append=False`` is the same-key path: fewer than
    ``min_imu_between_states`` IMU samples separate the scan end from the
    newest state, so the scan's factors act on that state instead of a new
    one.

    With ``photo_cfg`` the intensity-patch factor joins the GN system (on
    the body pose tangent, projected onto the geometric-degenerate
    directions with ``project_on_degeneracy``) and ``features`` is tracked
    and topped up at the converged pose; the step then also returns the new
    feature store. ``static_mask`` is the resident [R,C] static mask or
    None.

    ``rematch_on_motion`` re-associates moved points after every GN update
    (:func:`_rematch`). ``rescue_enabled`` runs, where the last GN
    iteration's inliers fall below ``rescue_min_inlier_frac`` of the valid
    geometric points, the candidate search (:func:`_rescue_search`), the
    window's realignment to the winner and ``n_gn_iters`` geometric-only
    window GN iterations; the absorb then uses the winner's matches, and
    debug slot 16 is 1.

    On a mesh (``parallel/sharded.py``) ``linearize_fn(vmap, pts, valid, q,
    t, g_dir)`` and ``map_update_fn(vmap, pts, valid, scan_idx)`` replace
    the linearization and the map insert, as in the JAX package: the mesh
    matches afresh on every linearization (each GN iteration, the absorb
    and each call of the rescue, whose candidates then run one after
    another, :func:`_rescue_search_mesh`), and ``rematch_on_motion`` has
    no effect."""
    d = window.p.dtype
    scalars = imu_f[-1]
    imu_f = imu_f[:-1]
    n_active = scalars[0].to(torch.int64)
    t_end = scalars[1]
    traj_idx = scalars[2].to(torch.int64)
    scan_idx = scalars[3].to(torch.int32)

    if marginalize_first:
        window, preints, fv = _marginalize(window, preints, fv,
                                           win_cfg=win_cfg)

    pts, t_pts, intensity, pt_valid = _decode_scan(
        scan_f, pt_valid, scalars[4], seq_cfg, d, ray_dirs, dither)
    accs, gyros, dts = imu_f[:, 0:3], imu_f[:, 3:6], imu_f[:, 6]
    seg_valid = imu_f[:, 7] > 0.5
    imu_ts = torch.cat([torch.zeros_like(dts[:1]), torch.cumsum(dts, 0)[:-1]])

    last = n_active - 1 if append else n_active
    q0, p0, v0, bg, ba = (_row(x, last) for x in (
        window.q, window.p, window.v, window.bg, window.ba))

    # 1) deskew into the scan-end lidar frame (segment-relative times)
    dsk = dk.deskew(pts, t_pts, pt_valid, q0, p0, v0, accs, gyros, imu_ts,
                    bg, ba, window.g_dir * seq_cfg.g_mag, q_bl, t_bl, t_end)

    if append:
        # 2) preintegrate the IMU factor segment last -> new, 3) append the
        # predicted state
        seg = pre.preintegrate(accs, gyros, dts, bg, ba, seq_cfg.acc_var,
                               seq_cfg.gyro_var, int_var=seq_cfg.int_var,
                               valid=seg_valid)
        preints = _set_segment(preints, last, seg)
        fv = fv.index_fill(0, last.reshape(1), True)
        window = win.append_state(window, dsk.q_w_be, dsk.p_w_be,
                                  dsk.v_w_be, bg, ba, t_end)
        slot = n_active
    else:
        slot = scalars[5].to(torch.int64)

    # 4) body-frame points + geometric downsample (geo_skip thins only the
    # geometric and map consumers)
    pts_b = lie.se3_transform(q_bl, t_bl, dsk.points_le)
    geo_in = pt_valid
    if seq_cfg.geo_skip > 1:
        lanes = torch.arange(pts_b.shape[0], device=pts_b.device)
        geo_in = pt_valid & (lanes % seq_cfg.geo_skip == 0)
    pts_geo, geo_valid, _ = voxel_downsample(
        pts_b, geo_in, seq_cfg.geo_leaf, seq_cfg.n_geo_points)

    # 4b) photometric frame (once a scan, from the full deskewed cloud)
    if photo_cfg is not None:
        kw = {}
        if photo_cfg.exact_ouster:
            # the raw points (sensor pixel-id order, point_skip == 1) for
            # the yaw table and the per-point T_Le_Lt for the re-skew
            kw = dict(points_raw=pts, q_le_lt=dsk.q_le_lt,
                      t_le_lt=dsk.t_le_lt)
        frame = ph.make_frame(dsk.points_le, intensity, pt_valid, photo_cfg,
                              static_mask=static_mask, **kw)
        A_bl = lie.pose_tangent_adjoint(q_bl, t_bl)   # body -> lidar tangent

    def photo_block(icp_):
        """Photometric H/b on the body pose tangent at the current pose."""
        q_wl, t_wl = lie.se3_compose(*pose(), q_bl, t_bl)
        pr = ph.linearize(frame, features, q_wl, t_wl, photo_cfg)
        Hb = A_bl.T @ pr.H @ A_bl
        bb = A_bl.T @ pr.b
        if photo_cfg.project_on_degeneracy:
            proj = geo.degenerate_selector(icp_)
            Hb = proj @ Hb @ proj.T
            bb = proj @ bb
        return Hb, bb, pr

    def geo_meas(icp_):
        """ICP measurement block, optionally projected onto the
        non-degenerate eigen-subspace."""
        if not geo_cfg.project_degenerate:
            return icp_.H, icp_.b
        Pp = geo.degeneracy_projector(icp_)
        return Pp @ icp_.H @ Pp.T, Pp @ icp_.b

    def pose():
        return _row(window.q, slot), _row(window.p, slot)

    # 5) GN with live ICP relinearization against correspondences made at
    # the predicted pose (and, with rematch_on_motion, made again for the
    # points that moved past leaf/4 after each update); the IMU Jacobians
    # are made once. lin_iter reads the newest matches.
    q_pre, p_pre = pose()
    mesh = linearize_fn is not None
    rematch = seq_cfg.rematch_on_motion and not mesh
    if mesh:
        matches = ()

        def lin_iter():
            return linearize_fn(vmap, pts_geo, geo_valid, *pose(),
                                window.g_dir)
    else:
        matches = geo.match(vmap, pts_geo, q_pre, p_pre, map_cfg)

        def lin_iter():
            return icp_cuda.linearize(matches, pts_geo, geo_valid, *pose(),
                                      geo_cfg, g_dir=window.g_dir)
    if rematch:
        # each point's world position at its last association
        p_da = _world_points(pts_geo, q_pre, p_pre)

    imu_cache = win.imu_factor_cache(window, preints, win_cfg)
    pidx = win.pose_idx(slot)
    for _ in range(seq_cfg.n_gn_iters):
        icp = lin_iter()
        meas = [(pidx, *geo_meas(icp))]
        if photo_cfg is not None:
            Hb, bb, _ = photo_block(icp)
            meas.append((pidx, Hb, bb))
        H, rhs = win.build_system(window, preints, fv, win_cfg, meas=meas,
                                  imu_cache=imu_cache)
        window = win.apply_update(window, win.solve(H, rhs), win_cfg)
        if rematch:
            matches, p_da = _rematch(vmap, pts_geo, geo_valid, matches, p_da,
                                     *pose(), map_cfg)

    # 5b) tracking-loss rescue, where the last iteration's inliers fell
    # below rescue_min_inlier_frac of the valid geometric points: a
    # conditional node of the captured graph (graph/captured.py::cond)
    rescued = torch.zeros((), dtype=d, device=pts_geo.device)
    if seq_cfg.rescue_enabled:
        n_valid = geo_valid.sum()
        lost = (icp.num_inlier.to(d)
                < seq_cfg.rescue_min_inlier_frac * n_valid.to(d)) \
            & (n_valid > 0)
        cands = _rescue_candidates(
            seq_cfg.rescue_radius or map_cfg.leaf_size, seq_cfg.rescue_yaw,
            d, pts_geo.device)

        def rescue():
            search = (functools.partial(_rescue_search_mesh, linearize_fn)
                      if mesh else functools.partial(_rescue_search,
                                                     map_cfg=map_cfg))
            w2 = _rescue_realign(
                window, slot, *search(
                    vmap, pts_geo, geo_valid, window.g_dir, *pose(), q_pre,
                    p_pre, cands, geo_cfg=geo_cfg),
                p_pre)
            m2 = () if mesh else geo.match(vmap, pts_geo, _row(w2.q, slot),
                                           _row(w2.p, slot), map_cfg)
            # the window GN from the winner's basin, geometric block only
            for _ in range(seq_cfg.n_gn_iters):
                if mesh:
                    icp2 = linearize_fn(vmap, pts_geo, geo_valid,
                                        _row(w2.q, slot), _row(w2.p, slot),
                                        w2.g_dir)
                else:
                    icp2 = icp_cuda.linearize(
                        m2, pts_geo, geo_valid, _row(w2.q, slot),
                        _row(w2.p, slot), geo_cfg, g_dir=w2.g_dir)
                H2, rhs2 = win.build_system(
                    w2, preints, fv, win_cfg, meas=[(pidx, *geo_meas(icp2))],
                    imu_cache=imu_cache)
                w2 = win.apply_update(w2, win.solve(H2, rhs2), win_cfg)
            return (tuple(getattr(w2, k) for k in _RESCUE_FIELDS), m2,
                    torch.ones_like(rescued))

        moved, matches, rescued = cond(
            lost, rescue,
            (tuple(getattr(window, k) for k in _RESCUE_FIELDS), matches,
             rescued))
        window = window._replace(**dict(zip(_RESCUE_FIELDS, moved)))

    # 6) absorb the final scan factor into the prior at converged values
    if seq_cfg.refresh_match_on_absorb and not mesh:
        matches = geo.match(vmap, pts_geo, *pose(), map_cfg)
    icp = lin_iter()
    window = win.rebase_prior(window, win_cfg)
    gH, gb = geo_meas(icp)
    window = win.add_measurement_block(window, pidx, gH, gb, win_cfg)
    Hpose = gH
    ph_rec = torch.zeros(4, dtype=d, device=gH.device)
    if photo_cfg is not None:
        Hb, bb, pr = photo_block(icp)
        window = win.add_measurement_block(window, pidx, Hb, bb, win_cfg)
        Hpose = gH + Hb
        # feature lifecycle, then the top-up at the converged pose, steered
        # along the geometric-degenerate translation directions
        features = ph.update_lifecycle(features, pr.tracked, photo_cfg)
        q_wl, t_wl = lie.se3_compose(*pose(), q_bl, t_bl)
        dirs_b = icp.eigvecs_trans.T          # rows = body-frame directions
        dirs_l = lie.quat_rotate(lie.quat_conj(q_bl).expand(3, 4), dirs_b)
        features = ph.detect_features(frame, features, q_wl, t_wl, photo_cfg,
                                      degen_dirs=(dirs_l,
                                                  icp.degenerate_trans))
        sc = pr.status_counts
        ph_rec = torch.stack([
            pr.num_tracked, sc[PH_SUM_SLOTS[0]],
            sc[PH_SUM_SLOTS[1]] + sc[PH_SUM_SLOTS[2]],
            sc[PH_SUM_SLOTS[3]]]).to(d)

    # 7) keyframe decision + map update + trajectory / debug logging;
    # freeze_map (localization) leaves the map and the keyframes as they are
    q_new, p_new = pose()
    if not seq_cfg.freeze_map:
        vmap, kf_q, kf_p, kf_count = _keyframe_map_update(
            vmap, q_new, p_new, dsk.points_le, geo_in, kf_q, kf_p, kf_count,
            scan_idx, q_bl, t_bl, seq_cfg=seq_cfg, map_cfg=map_cfg,
            map_update_fn=map_update_fn)
    traj_q = _put_row(traj_q, traj_idx, q_new)
    traj_p = _put_row(traj_p, traj_idx, p_new)

    if append:
        # IMU-factor localizability eigenvalues at the converged states
        loc = pre.localizability(
            seg, _row(window.q, last), _row(window.p, last),
            _row(window.v, last), q_new, p_new, _row(window.v, slot), bg,
            ba, window.g_dir, seq_cfg.g_mag)
        loc_eig = torch.cat([loc["eig_rot"], loc["eig_pos"], loc["eig_vel"]])
    else:
        loc_eig = torch.zeros(9, dtype=d, device=gH.device)
    iu = torch.triu_indices(6, 6, device=gH.device)
    rec = torch.cat([
        icp.num_inlier.to(d).reshape(1), icp.status_counts.to(d),
        icp.mean_abs_res.reshape(1), icp.degenerate_rot.to(d),
        icp.degenerate_trans.to(d), ph_rec, rescued.reshape(1),
        Hpose[iu[0], iu[1]], loc_eig])
    debug_rec = _put_row(debug_rec, scan_idx.to(torch.int64), rec)
    out = (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
           debug_rec)
    return out if photo_cfg is None else out + (features,)


def _init_inertial_step(window, traj_q, traj_p, q0, g0, bg, ba, ts,
                        *, win_cfg):
    """State setup: the first state, its priors and trajectory row 0."""
    z3 = torch.zeros_like(bg)
    window = window._replace(g_dir=g0, lin_g=g0)
    window = win.append_state(window, q0, z3, z3, bg, ba, ts)
    window = win.init_priors(window, win_cfg)
    zero = torch.zeros((), dtype=torch.int64, device=bg.device)
    return window, _put_row(traj_q, zero, q0), _put_row(traj_p, zero, z3)


def _init_lidar_step(window, vmap, traj_q, traj_p, kf_q, kf_p, pts, vd,
                     q0, g0, bg, ba, ts, q_bl, t_bl,
                     *, seq_cfg, win_cfg, map_cfg, map_update_fn=None):
    """State setup (:func:`_init_inertial_step`) + keyframe 0 + stationary
    first-scan map seed (not with ``freeze_map``: the map stays as given);
    on a mesh ``map_update_fn`` makes the seed's insert, as in the JAX
    package."""
    window, traj_q, traj_p = _init_inertial_step(
        window, traj_q, traj_p, q0, g0, bg, ba, ts, win_cfg=win_cfg)
    z3 = torch.zeros_like(bg)
    zero = torch.zeros((), dtype=torch.int64, device=bg.device)
    kf_q, kf_p = _put_row(kf_q, zero, q0), _put_row(kf_p, zero, z3)
    if not seq_cfg.freeze_map:
        q_wl, t_wl = lie.se3_compose(q0, z3, q_bl, t_bl)
        ds, ds_valid, _ = voxel_downsample(
            lie.se3_transform(q_wl, t_wl, pts), vd, seq_cfg.map_insert_leaf,
            seq_cfg.n_map_points)
        if map_update_fn is None:
            vmap = _map_update(vmap, ds, ds_valid, zero.to(torch.int32),
                               map_cfg=map_cfg)
        else:
            vmap = map_update_fn(vmap, ds, ds_valid, zero.to(torch.int32))
    return window, vmap, traj_q, traj_p, kf_q, kf_p


def _marginalize(window, preints, fv, *, win_cfg):
    window = win.marginalize_oldest(window, preints, win_cfg)
    return (window, *_shift_segments(preints, fv))


def _scan_state_step(state, scan_f, pt_valid, imu_f, *, resident, **kw):
    """:func:`_scan_step` on the Sequencer's whole state (``STATE``, or
    ``PHOTO_STATE`` with the feature store last); ``resident`` = (q_bl,
    t_bl, ray_dirs, dither, static_mask)."""
    (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
     debug_rec, *features) = state
    return _scan_step(window, vmap, preints, fv, scan_f, pt_valid, imu_f,
                      kf_q, kf_p, kf_count, traj_q, traj_p, debug_rec,
                      *resident, *features, **kw)


def _marginalize_step(state, *, win_cfg):
    """:func:`_marginalize` on the Sequencer's whole state (``STATE`` or
    ``PHOTO_STATE``)."""
    window, vmap, preints, fv, *logs = state
    window, preints, fv = _marginalize(window, preints, fv, win_cfg=win_cfg)
    return (window, vmap, preints, fv, *logs)


# ------------------------------------------- declares, insertions, radar,
# odometry and out-of-order scans
#
# IMU segments travel as [m, 8] rows (acc3, gyro3, dt, valid), m =
# max_imu_per_segment; an insertion takes the two segments around the new
# state stacked as [2m, 8]. Slots, positions and trajectory rows travel as
# floats in a scalar row and become 0-d device indices, so one captured
# graph serves every slot.

def _segment(imu):
    """(accs, gyros, dts, valid) of IMU rows [m, 8]."""
    return imu[:, 0:3], imu[:, 3:6], imu[:, 6], imu[:, 7] > 0.5


def _declare_core(window, preints, fv, accs, gyros, dts, seg_valid,
                  n_active, *, seq_cfg):
    """Preintegrate the segment last -> new at the last state's biases,
    predict and append the new state (with ``ts = 0``, as the JAX package
    does). Returns (window, preints, fv, slot of the new state)."""
    last = n_active - 1
    bg, ba = _row(window.bg, last), _row(window.ba, last)
    seg = pre.preintegrate(accs, gyros, dts, bg, ba, seq_cfg.acc_var,
                           seq_cfg.gyro_var, int_var=seq_cfg.int_var,
                           valid=seg_valid)
    preints = _set_segment(preints, last, seg)
    fv = fv.index_fill(0, last.reshape(1), True)
    qn, pn, vn = pre.predict(seg, _row(window.q, last), _row(window.p, last),
                             _row(window.v, last),
                             window.g_dir * seq_cfg.g_mag)
    window = win.append_state(window, qn, pn, vn, bg, ba, 0.0)
    return window, preints, fv, n_active


def _declare_step(state, imu_f, *, seq_cfg):
    """A state declared from the IMU alone (no factor), on the whole
    state: ``imu_f`` [m+1, 8] is the segment and a scalar row [n_active]."""
    window, vmap, preints, fv, *rest = state
    window, preints, fv, _ = _declare_core(
        window, preints, fv, *_segment(imu_f[:-1]),
        imu_f[-1, 0].to(torch.int64), seq_cfg=seq_cfg)
    return (window, vmap, preints, fv, *rest)


def _insert_preint_segments(preints, fv, pos, seg_a, seg_b):
    """After inserting a state at slot ``pos``: segment pos-1 becomes
    (prev -> new), segment pos becomes (new -> next), later segments shift
    right by one."""
    k1 = fv.shape[0]
    j = torch.arange(k1, device=fv.device)
    take = torch.where(j < pos, j, j - 1)

    def shift(a, new_a, new_b):
        shape = (k1,) + (1,) * (a.ndim - 1)
        return torch.where((j == pos - 1).reshape(shape), new_a,
                           torch.where((j == pos).reshape(shape), new_b,
                                       a.index_select(0, take)))

    preints = pre.PreintState(*[shift(a, na, nb) for a, na, nb
                                in zip(preints, seg_a, seg_b)])
    true = torch.ones_like(fv[0])
    return preints, shift(fv, true, true)


def _insert_ooo_state(window, preints, fv, imu_ab, pos, *, seq_cfg,
                      win_cfg):
    """A late measurement's state inserted at slot ``pos``: segment A
    (prev -> new) and segment B (new -> next) are integrated at the
    previous state's biases (``imu_ab`` [2m, 8] stacks them), the new state
    is predicted from the previous one over A and inserted (``ts = 0``),
    and the IMU chain re-placed around it."""
    m = seq_cfg.max_imu_per_segment
    prev = pos - 1
    bg, ba = _row(window.bg, prev), _row(window.ba, prev)

    def integrate(imu):
        accs, gyros, dts, valid = _segment(imu)
        return pre.preintegrate(accs, gyros, dts, bg, ba, seq_cfg.acc_var,
                                seq_cfg.gyro_var, int_var=seq_cfg.int_var,
                                valid=valid)

    seg_a, seg_b = integrate(imu_ab[:m]), integrate(imu_ab[m:])
    qn, pn, vn = pre.predict(seg_a, _row(window.q, prev), _row(window.p, prev),
                             _row(window.v, prev),
                             window.g_dir * seq_cfg.g_mag)
    window = win.insert_state_at(window, pos, qn, pn, vn, bg, ba, 0.0,
                                 win_cfg)
    preints, fv = _insert_preint_segments(preints, fv, pos, seg_a, seg_b)
    return window, preints, fv


def _gn_absorb(window, preints, fv, idx, lin, *, win_cfg):
    """Two GN iterations with the live factor block ``lin(window)`` ->
    (H, b) on tangent indices ``idx``, then the block absorbed into the
    prior at the converged values: the radar and odometry one-step factor.
    ``build_system`` takes no IMU cache here, so each iteration linearizes
    the IMU chain afresh, as the JAX package's radar and odometry steps
    do."""
    for _ in range(2):
        Hm, bm = lin(window)
        H, rhs = win.build_system(window, preints, fv, win_cfg,
                                  meas=[(idx, Hm, bm)])
        window = win.apply_update(window, win.solve(H, rhs), win_cfg)
    Hm, bm = lin(window)
    window = win.rebase_prior(window, win_cfg)
    return win.add_measurement_block(window, idx, Hm, bm, win_cfg)


# radar pack: Sequencer.RADAR_BULK_PAD target rows (x, y, z in the radar
# frame, NaN where no target; doppler; snr_db, -1e9 where no target) and a
# scalar row [slot, omega (3), traj_idx]


def _radar_step(state, *inputs, mode, seq_cfg, win_cfg, radar_cfg,
                linearize_fn=None):
    """The radar Doppler factor on the whole state. ``inputs`` end with the
    radar pack; its scalar row's slot is the state the factor acts on, and
    ``mode`` says how that state came to be:

    * ``"declare"`` (inputs: IMU segment [m, 8], pack): a new state from the
      IMU at ``slot`` (= the active count), then the factor on it and its
      trajectory row;
    * ``"attach"`` (pack): the newest state (fewer than
      ``min_imu_between_states`` IMU samples since it), and a trajectory
      row;
    * ``"samekey"`` (pack): an existing state next to a late frame, no row;
    * ``"ooo"`` (segments [2m, 8], pack): a state inserted at ``slot`` for
      a late frame (:func:`_insert_ooo_state`), no row.

    The omega of the lever arm is the mean gyro over the frame's exposure;
    the GN is :func:`_gn_absorb` on the [dR, dv, dbg] keys. On a mesh
    ``linearize_fn(q, v, bg, omega, dirs, doppler, valid)`` (the targets
    split over dp, ``parallel/sharded.py``) replaces ``rad.linearize``."""
    window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p, \
        *rest = state
    *imu, rpack = inputs
    scal, tgt = rpack[-1], rpack[:-1]
    slot = scal[0].to(torch.int64)
    if mode == "declare":
        window, preints, fv, _ = _declare_core(
            window, preints, fv, *_segment(imu[0]), slot, seq_cfg=seq_cfg)
    elif mode == "ooo":
        window, preints, fv = _insert_ooo_state(
            window, preints, fv, imu[0], slot, seq_cfg=seq_cfg,
            win_cfg=win_cfg)
    dirs, _, valid = rad.filter_targets(tgt[:, 0:3], tgt[:, 4], radar_cfg)
    omega, doppler = scal[1:4], tgt[:, 3]

    def lin(w):
        args = (_row(w.q, slot), _row(w.v, slot), _row(w.bg, slot), omega,
                dirs, doppler, valid)
        res = rad.linearize(*args, radar_cfg) if linearize_fn is None \
            else linearize_fn(*args)
        return res.H, res.b

    window = _gn_absorb(window, preints, fv, win.rot_vel_bg_idx(slot), lin,
                        win_cfg=win_cfg)
    if mode in ("declare", "attach"):
        traj_idx = scal[4].to(torch.int64)
        traj_q = _put_row(traj_q, traj_idx, _row(window.q, slot))
        traj_p = _put_row(traj_p, traj_idx, _row(window.p, slot))
    return (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
            *rest)


def _odom_step(state, *inputs, declare, seq_cfg, win_cfg, odom_cfg):
    """The external-odometry between factor on the whole state, from the
    state of the previous message to ``slot``, and ``slot``'s trajectory
    row. ``inputs`` end with the odometry pack [3, 7]: row 0 [slot,
    prev_slot, traj_idx], rows 1 and 2 the previous and current sensor
    poses (q wxyz, t); with ``declare`` an IMU segment [m, 8] comes first
    and ``slot`` is a new state declared from it."""
    window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p, \
        *rest = state
    *imu, opack = inputs
    slot, prev_slot, traj_idx = opack[0, 0:3].to(torch.int64).unbind()
    q_meas, t_meas = odo.relative_measurement(
        opack[1, 0:4], opack[1, 4:7], opack[2, 0:4], opack[2, 4:7], odom_cfg)
    if declare:
        window, preints, fv, _ = _declare_core(
            window, preints, fv, *_segment(imu[0]), slot, seq_cfg=seq_cfg)

    def lin(w):
        res = odo.linearize(_row(w.q, prev_slot), _row(w.p, prev_slot),
                            _row(w.q, slot), _row(w.p, slot), q_meas, t_meas,
                            odom_cfg)
        return res.H, res.b

    window = _gn_absorb(window, preints, fv,
                        win.between_pose_idx(prev_slot, slot), lin,
                        win_cfg=win_cfg)
    traj_q = _put_row(traj_q, traj_idx, _row(window.q, slot))
    traj_p = _put_row(traj_p, traj_idx, _row(window.p, slot))
    return (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
            *rest)


def _scan_ooo_step(window, vmap, preints, fv, scan_f, pt_valid, imu_f,
                   kf_q, kf_p, kf_count, debug_rec, q_bl, t_bl,
                   ray_dirs=None, dither=None,
                   *, seq_cfg, win_cfg, map_cfg, geo_cfg, linearize_fn=None,
                   map_update_fn=None):
    """A late scan's state inserted mid-window and defined by the scan:
    insert at ``pos`` with the two IMU segments re-integrated
    (:func:`_insert_ooo_state`), deskew over segment A from the previous
    state, ``n_gn_iters`` GN iterations with live ICP relinearization (the
    kernel) on the inserted slot, absorb, then the keyframe-gated map
    update at the refined pose. ``imu_f`` [2m+1, 8]: segments A and B and a
    scalar row [pos, t_end_rel, -, scan_idx, t_offset]. No trajectory row
    (the scan is older than the trajectory head) and no photometric
    factor, as in the JAX package; the debug row holds the inlier count
    only. Points timestamped before the previous state clamp to its pose
    in the deskew. On a mesh ``linearize_fn`` (which matches afresh on
    every call) and ``map_update_fn`` replace the linearization and the
    map insert, as in :func:`_scan_step`."""
    d = window.p.dtype
    m = seq_cfg.max_imu_per_segment
    scalars = imu_f[-1]
    pos = scalars[0].to(torch.int64)
    t_end = scalars[1]
    scan_idx = scalars[3].to(torch.int32)
    pts, t_pts, _, pt_valid = _decode_scan(
        scan_f, pt_valid, scalars[4], seq_cfg, d, ray_dirs, dither)
    window, preints, fv = _insert_ooo_state(
        window, preints, fv, imu_f[:2 * m], pos, seq_cfg=seq_cfg,
        win_cfg=win_cfg)

    # deskew from the previous state (its slot is below pos, unmoved)
    prev = pos - 1
    accs, gyros, dts, _ = _segment(imu_f[:m])
    imu_ts = torch.cat([torch.zeros_like(dts[:1]), torch.cumsum(dts, 0)[:-1]])
    dsk = dk.deskew(pts, t_pts, pt_valid, _row(window.q, prev),
                    _row(window.p, prev), _row(window.v, prev), accs, gyros,
                    imu_ts, _row(window.bg, prev), _row(window.ba, prev),
                    window.g_dir * seq_cfg.g_mag, q_bl, t_bl, t_end)

    pts_b = lie.se3_transform(q_bl, t_bl, dsk.points_le)
    geo_in = pt_valid
    if seq_cfg.geo_skip > 1:
        lanes = torch.arange(pts_b.shape[0], device=pts_b.device)
        geo_in = pt_valid & (lanes % seq_cfg.geo_skip == 0)
    pts_geo, geo_valid, _ = voxel_downsample(
        pts_b, geo_in, seq_cfg.geo_leaf, seq_cfg.n_geo_points)

    def pose():
        return _row(window.q, pos), _row(window.p, pos)

    def geo_meas(icp_):
        if not geo_cfg.project_degenerate:
            return icp_.H, icp_.b
        Pp = geo.degeneracy_projector(icp_)
        return Pp @ icp_.H @ Pp.T, Pp @ icp_.b

    if linearize_fn is None:
        matches = geo.match(vmap, pts_geo, *pose(), map_cfg)

        def lin_iter():
            return icp_cuda.linearize(matches, pts_geo, geo_valid, *pose(),
                                      geo_cfg, g_dir=window.g_dir)
    else:
        def lin_iter():
            return linearize_fn(vmap, pts_geo, geo_valid, *pose(),
                                window.g_dir)

    imu_cache = win.imu_factor_cache(window, preints, win_cfg)
    pidx = win.pose_idx(pos)
    for _ in range(seq_cfg.n_gn_iters):
        icp = lin_iter()
        H, rhs = win.build_system(window, preints, fv, win_cfg,
                                  meas=[(pidx, *geo_meas(icp))],
                                  imu_cache=imu_cache)
        window = win.apply_update(window, win.solve(H, rhs), win_cfg)
    icp = lin_iter()
    window = win.rebase_prior(window, win_cfg)
    window = win.add_measurement_block(window, pidx, *geo_meas(icp), win_cfg)

    # keyframe-gated map densification, not in localization mode
    if not seq_cfg.freeze_map:
        vmap, kf_q, kf_p, kf_count = _keyframe_map_update(
            vmap, *pose(), dsk.points_le, geo_in, kf_q, kf_p, kf_count,
            scan_idx, q_bl, t_bl, seq_cfg=seq_cfg, map_cfg=map_cfg,
            map_update_fn=map_update_fn)
    rec = torch.cat([icp.num_inlier.to(d).reshape(1),
                     torch.zeros(DBG_W - 1, dtype=d, device=pts.device)])
    debug_rec = _put_row(debug_rec, scan_idx.to(torch.int64), rec)
    return window, vmap, preints, fv, debug_rec, kf_q, kf_p, kf_count


def _scan_ooo_state_step(state, scan_f, pt_valid, imu_f, *, resident, **kw):
    """:func:`_scan_ooo_step` on the Sequencer's whole state; the
    trajectory rings and a photometric feature store pass through."""
    (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
     debug_rec, *features) = state
    q_bl, t_bl, ray_dirs, dither, _ = resident
    window, vmap, preints, fv, debug_rec, kf_q, kf_p, kf_count = \
        _scan_ooo_step(window, vmap, preints, fv, scan_f, pt_valid, imu_f,
                       kf_q, kf_p, kf_count, debug_rec, q_bl, t_bl, ray_dirs,
                       dither, **kw)
    return (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
            debug_rec, *features)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class Sequencer:
    """Host orchestrator of the LiDAR-inertial slice.
    Deterministic: on a given device the same inputs in the same order
    give the same trajectory, bit for bit.

    ``device`` defaults to the first CUDA device and raises where there is
    none; ``device="cpu"`` runs the plain versions on the CPU. On the card
    each step variant is captured as a CUDA graph after one eager warm-up
    and replayed from then on; ``eager=True`` (an instrumentation switch,
    e.g. for timing each stage) runs every step op by op. ``ray_dirs`` is
    the per-lane beam table the range codec needs: [N,3] unit directions
    (p = r * dir) or [N,6] direction + offset (p = s * dir + offset), at
    full sensor density (``point_skip`` is applied here). ``photo_cfg``
    (a :class:`~mimosa_tpu_torch.lidar.photometric.PhotometricConfig`)
    adds the photometric factor; scans then carry an intensity column.
    ``init_map`` (a :class:`~mimosa_tpu_torch.mapping.voxel_hash.VoxelMap`
    of ``map_cfg``'s capacity, on this device and in this dtype, e.g.
    another Sequencer's ``vmap``) is the map to start from instead of an
    empty one: localization against a prior map with ``freeze_map``, or
    pass 2 of the two-pass refinement. Its tensors are copied: the
    captured steps write the map's buffers in place, so no Sequencer shares
    another's.

    ``mesh`` (a ``("dp", "mp")`` DeviceMesh, ``parallel.sharded.make_mesh``)
    runs the same host logic over the mesh's device programs, every rank
    of the process group replaying identical inputs: points and radar
    targets split over dp, the map over mp (``vmap`` is this rank's
    sub-table), the linearization and the map insert of every scan step
    variant, the initialization and the radar steps from
    ``parallel/sharded.py``, their collectives recorded into the captured
    graphs.

    ``step_cache`` is a dict to share among Sequencers of identical
    configurations (repeated replays, a scoreboard): the step functions and,
    on the card, the captured graphs with their static buffers, so a
    Sequencer replays the graphs an earlier one captured. Its keys carry
    the configurations, the device and the dtype; a mesh Sequencer, or one
    whose configuration does not hash, keeps keys of its own. After a
    replay a Sequencer's state tensors are the shared static buffers, so
    before another Sequencer runs a step through them, the last one's state
    is copied out into tensors of its own (``CapturedSteps.run``'s
    ``owner``): interleaved Sequencers give the bits of separate ones."""

    def __init__(self, seq_cfg: SequencerConfig = SequencerConfig(),
                 win_cfg: win.WindowConfig = win.WindowConfig(),
                 map_cfg: vh.VoxelMapConfig = vh.VoxelMapConfig(),
                 geo_cfg: geo.GeometricConfig = geo.GeometricConfig(),
                 photo_cfg: ph.PhotometricConfig = None,
                 *, device=None, dtype=torch.float32, ray_dirs=None,
                 eager=False, init_map=None, mesh=None, step_cache=None):
        if photo_cfg is not None and photo_cfg.exact_ouster \
                and seq_cfg.point_skip != 1:
            raise ValueError(
                "exact_ouster needs the full organized cloud in sensor "
                "index order: set point_skip=1 (geo_skip thins only the "
                "geometric pipeline; point_skip would scramble the pixel-id "
                "fill)")
        self.cfg = seq_cfg
        self.win_cfg = win_cfg
        self.map_cfg = map_cfg
        self.geo_cfg = geo_cfg
        self.photo_cfg = photo_cfg
        self.device = require_cuda() if device is None \
            else torch.device(device)
        self.dtype = dtype
        f = dict(dtype=dtype, device=self.device)
        self._init_codec(ray_dirs)
        self.mesh = mesh
        self._linearize_fn = self._map_update_fn = None
        if mesh is not None:
            self._linearize_fn, self._map_update_fn = sharded.sequencer_fns(
                mesh, map_cfg, geo_cfg)
        self._state_names = STATE if photo_cfg is None else PHOTO_STATE
        self.features = self._static_mask = None
        if photo_cfg is not None:
            self.features = ph.empty_features(photo_cfg, dtype, self.device)
            mask = ph.load_static_mask(photo_cfg)
            if mask is not None:
                self._static_mask = torch.from_numpy(mask).to(self.device)
            # the configuration's constants, made on the device before any
            # step runs (a captured step holds no host copy)
            ph.resident(photo_cfg, torch.zeros((), **f))

        self.imu = ImuBuffer(max_duration=seq_cfg.imu_max_buffer_duration,
                             acc_scale=seq_cfg.imu_acc_scale)
        self.window = win.create(win_cfg, self.device, dtype)
        if init_map is not None:
            self.vmap = self._copy_map(init_map)
        elif mesh is not None:
            self.vmap = sharded.create_sharded_map(map_cfg, mesh,
                                                   self.device, dtype)
        else:
            self.vmap = vh.create(map_cfg, self.device, dtype)
        K = win_cfg.K
        z3 = torch.zeros(3, **f)
        self.preints = pre.PreintState(*[
            a.expand((K - 1,) + a.shape).clone()
            for a in pre.init_preint(z3, z3)])
        self.fv = torch.zeros(K - 1, dtype=torch.bool, device=self.device)
        self.q_bl = torch.tensor(seq_cfg.q_b_l, **f)
        self.t_bl = torch.tensor(seq_cfg.t_b_l, **f)
        self.n_active = 0
        self.initialized = False
        self.scan_idx = 0
        self.last_state_ts = None
        self.state_ts = []           # host mirror of active slot timestamps
        self.counters = {
            "scans": 0, "scans_dropped_ooo": 0, "scans_same_key": 0,
            "scans_no_imu": 0, "init_attempts": 0,
        }
        KF, S = seq_cfg.max_keyframes, seq_cfg.max_trajectory
        self.kf_q = torch.zeros((KF, 4), **f)
        self.kf_p = torch.zeros((KF, 3), **f)
        self.kf_count = torch.zeros((), dtype=torch.int32, device=self.device)
        self.traj_q = torch.zeros((S, 4), **f)
        self.traj_p = torch.zeros((S, 3), **f)
        self.debug_rec = torch.zeros((S, DBG_W), **f)
        self._traj_ts = []           # host: timestamps, index = ring row
        self._traj_src = []          # host: scan_idx per row (-1 = no scan)
        # the radar and odometry configurations (set by the first frame or
        # message) and the odometry anchor: the previous message's slot
        # and sensor pose
        self.radar_cfg = self.odom_cfg = self._odom_prev = None
        self.timers = StageTimer()
        # the bulk scheduler's record: chunks run, events run inside them
        # (and how many of each event code), events it streamed
        self.bulk_counts = dict(chunks=0, in_chunks=0, streamed=0,
                                codes=[0] * 5)
        self._step_kw = dict(seq_cfg=seq_cfg, win_cfg=win_cfg,
                             map_cfg=map_cfg, geo_cfg=geo_cfg)
        if mesh is not None:
            self._step_kw.update(linearize_fn=self._linearize_fn,
                                 map_update_fn=self._map_update_fn)
        # the step functions and the captured graphs, keyed by _ckey
        self._step_cache = {} if step_cache is None else step_cache
        self._cfg_salt = self._salt()
        self.graphs = None
        if not eager and self.device.type == "cuda":
            key = self._ckey("graphs")
            if key not in self._step_cache:
                self._step_cache[key] = CapturedSteps(self.device)
            self.graphs = self._step_cache[key]

    def _salt(self):
        """The step-cache salt: the configurations, dtype, device and range
        codec table, or this Sequencer's own number on a mesh (its steps
        hold the mesh) or where the configuration does not hash."""
        if self.mesh is None:
            salt = (self.cfg, self.win_cfg, self.map_cfg, self.geo_cfg,
                    self.photo_cfg, str(self.dtype), str(self.device),
                    self._ray_dirs_key)
            try:
                hash(salt)
                return salt
            except TypeError:
                pass
        return ("instance", next(_INSTANCES))

    def _ckey(self, *parts):
        """The step-cache key of ``parts`` ("step" and a variant's key,
        which the captured graphs hash too, or "graphs")."""
        return (self._cfg_salt,) + parts

    def _copy_map(self, vmap):
        """A copy of ``vmap`` in new tensors, after checking that it is a
        map of ``map_cfg``'s capacity on this device in this dtype."""
        # the window's device: "cuda" resolved to its index
        want = (self.map_cfg.capacity + 1, self.window.p.device, self.dtype)
        got = (vmap.coords.shape[0], vmap.n.device, vmap.n.dtype)
        if got != want or any(t.shape[0] != want[0] or t.device != want[1]
                              for t in vmap):
            raise ValueError(
                f"init_map holds {got[0]} rows on {got[1]} in {got[2]}; "
                f"this Sequencer needs {want[0]} rows (map_cfg capacity + "
                f"the write-off row) on {want[1]} in {want[2]}")
        return vh.VoxelMap(*[t.clone() for t in vmap])

    def _init_codec(self, ray_dirs):
        """The resident decode tables: the range codec's beam table and the
        int16 codecs' per-lane dither."""
        c, n = self.cfg, self.cfg.max_scan_points
        self._ray_dirs_dev = self._dither_dev = self._beam_table = None
        self._ray_dirs_lanes = 0
        self._ray_dirs_key = None     # the beam table's bytes (step cache)
        if c.range_transfer:
            if ray_dirs is None:
                raise ValueError(
                    "range_transfer needs ray_dirs: the per-lane beam table "
                    "at full sensor density, [N,3] unit directions "
                    "(p = r*dir) or [N,6] dir+offset (p = s*dir + offset), "
                    "e.g. io.synthetic.beam_dirs(lm)[0]")
            if not c.quantize_transfer:
                raise ValueError(
                    "range_transfer requires quantize_transfer=True")
            rd = np.asarray(ray_dirs, np.float32)[::c.point_skip]
            if rd.ndim != 2 or rd.shape[1] not in (3, 6):
                raise ValueError("ray_dirs must be [N,3] or [N,6]")
            out = np.zeros((n, rd.shape[1]), np.float32)
            out[:, 2] = 1.0               # pad lanes: unit z (masked out)
            self._ray_dirs_lanes = min(len(rd), n)
            out[:self._ray_dirs_lanes] = rd[:self._ray_dirs_lanes]
            # the affine table goes to the pack too; the radial pack
            # computes |p|
            self._beam_table = out if rd.shape[1] == 6 else None
            self._ray_dirs_dev = torch.from_numpy(out).to(self.device)
            self._ray_dirs_key = out.tobytes()
        if c.quantize_transfer and c.quant_dither:
            self._dither_dev = _dither_lanes(n, self.dtype, self.device)

    def _put(self, arr, dtype=None):
        """Host numpy -> device tensor. On the card the copy goes through
        a fresh pinned buffer and does not wait for the stream; the pinned
        allocator keeps that buffer until the copy has run, so no later
        scan can refill it while the copy is in flight."""
        t = torch.tensor(np.asarray(arr), dtype=dtype or self.dtype)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ----------------------------------------------------------- step runs
    def _state(self):
        return tuple(getattr(self, k) for k in self._state_names)

    def _run(self, key, inputs=()):
        """Run step variant ``key`` on the Sequencer's state: ("scan",
        marginalize_first, append), ("marginalize",), ("declare",),
        ("scan_ooo",), ("radar", mode, radar_cfg) or ("odom", declare,
        odom_cfg). Replayed from its CUDA graph on the card, eagerly on the
        CPU or with ``eager=True``."""
        ckey = self._ckey("step", *key)
        fn = self._step_cache.get(ckey)
        if fn is None:
            fn = self._step_cache[ckey] = self._step_fn(key)
        if self.graphs is None:
            out = fn(self._state(), *inputs)
        else:
            out = self.graphs.run(key, fn, self._state(), inputs, owner=self)
        for k, v in zip(self._state_names, out):
            setattr(self, k, v)

    def _own_state(self, bufs):
        """Copy every state tensor that is one of ``bufs`` (the static
        buffers of a shared CapturedSteps, about to hold another
        Sequencer's state) into a tensor of this Sequencer's own."""
        held = {id(b) for b in bufs}
        flat, spec = flatten(self._state())
        flat = [t.clone() if id(t) in held else t for t in flat]
        for k, v in zip(self._state_names, unflatten(flat, spec)):
            setattr(self, k, v)

    def _step_fn(self, key):
        """The variant's function of (state, *inputs). It holds the
        resident tensors it needs, not the Sequencer (no reference cycle:
        a Sequencer is freed when its last reference goes)."""
        kind = key[0]
        cfgs = dict(seq_cfg=self.cfg, win_cfg=self.win_cfg)
        resident = (self.q_bl, self.t_bl, self._ray_dirs_dev,
                    self._dither_dev, self._static_mask)
        if kind == "marginalize":
            return functools.partial(_marginalize_step, win_cfg=self.win_cfg)
        if kind == "declare":
            return functools.partial(_declare_step, seq_cfg=self.cfg)
        if kind == "radar":
            return functools.partial(
                _radar_step, mode=key[1], radar_cfg=key[2],
                linearize_fn=None if self.mesh is None
                else sharded.radar_linearize_fn(self.mesh, key[2]), **cfgs)
        if kind == "odom":
            return functools.partial(_odom_step, declare=key[1],
                                     odom_cfg=key[2], **cfgs)
        if kind == "scan_ooo":
            return functools.partial(_scan_ooo_state_step, resident=resident,
                                     **self._step_kw)
        _, marginalize_first, append = key
        return functools.partial(
            _scan_state_step, resident=resident,
            marginalize_first=marginalize_first, append=append,
            photo_cfg=self.photo_cfg, **self._step_kw)

    # ------------------------------------------------------- logged outputs
    @property
    def trajectory(self):
        """[(ts, p [3], q_wxyz [4])] from the device ring (one transfer)."""
        n = len(self._traj_ts)
        if n == 0:
            return []
        q = self.traj_q[:n].cpu().numpy()
        p = self.traj_p[:n].cpu().numpy()
        return [(self._traj_ts[i], p[i], q[i]) for i in range(n)]

    @property
    def num_keyframes(self):
        return int(self.kf_count)

    def debug_records(self):
        """Per-scan debug records [n_scans, 17]: num_inlier, 4 status
        counts, mean |r|, 3+3 degeneracy flags, the photometric slots
        (tracked, OOB, masked + occluded, NCC; zero without ``photo_cfg``)
        and the rescue flag (slot 16: 1 where the tracking-loss rescue ran
        on the scan, 0 elsewhere and without ``rescue_enabled``)."""
        return self.debug_rec[: self.scan_idx, :17].cpu().numpy()

    def imu_localizability_records(self):
        """Per-scan IMU-factor localizability eigenvalues [n_scans, 9]
        (rot[3], pos[3], vel[3], each ascending); zero rows for same-key
        scans (no new IMU factor)."""
        return self.debug_rec[: self.scan_idx, 38:47].cpu().numpy()

    def pose_info_records(self):
        """[n_traj, 6, 6] absorbed pose-information matrix per trajectory
        row (zeros for the init row, which carries no scan registration)."""
        dbg = self.debug_rec[: self.scan_idx, 17:38].cpu().numpy()
        out = np.zeros((len(self._traj_ts), 6, 6), dbg.dtype)
        for row, sc in enumerate(self._traj_src):
            if 0 <= sc < len(dbg):
                h = np.zeros((6, 6), dbg.dtype)
                h[_TRIU6] = dbg[sc]
                out[row] = h + h.T - np.diag(np.diag(h))
        return out

    @property
    def last_icp(self):
        """(num_inlier, status_counts[4], mean_abs_res, degen_rot[3],
        degen_trans[3]) of the newest scan, or None."""
        if self.scan_idx == 0:
            return None
        r = self.debug_rec[self.scan_idx - 1].cpu().numpy()
        return (int(r[0]), r[1:5].astype(np.int64), float(r[5]),
                r[6:9] > 0.5, r[9:12] > 0.5)

    @property
    def last_photo(self):
        """(num_tracked, [tracked, oob, masked+occluded, ncc]) of the newest
        scan, or None (no scan yet, or no ``photo_cfg``)."""
        if self.photo_cfg is None or self.scan_idx == 0:
            return None
        r = self.debug_rec[self.scan_idx - 1].cpu().numpy()
        return (int(r[12]), r[12:16].astype(np.int64))

    def write_tum(self, path):
        """TUM trajectory log: ts x y z qx qy qz qw."""
        with open(path, "w") as f:
            for ts, p, q in self.trajectory:
                f.write(f"{ts:.9f} {p[0]} {p[1]} {p[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")

    # ----------------------------------------------------------- state query
    # The public query interface of the JAX package's Sequencer on the
    # dense window and the trajectory ring. Each reads the device once and
    # answers in numpy; none runs inside a step.

    def _window_rows(self):
        return _extract_states(self.window).cpu().numpy()

    def _mk_state(self, ts, row):
        return EstimatorState(float(ts), row[0:4], row[4:7], row[7:10],
                              row[10:13], row[13:16], row[16:19])

    def current_state(self):
        """Newest optimized state, or None before initialization."""
        if not self.initialized or self.n_active == 0:
            return None
        rows = self._window_rows()
        return self._mk_state(self.state_ts[-1], rows[self.n_active - 1])

    def optimized_values(self):
        """All live window states, oldest first."""
        if not self.initialized or self.n_active == 0:
            return []
        rows = self._window_rows()
        return [self._mk_state(self.state_ts[i], rows[i])
                for i in range(min(self.n_active, len(self.state_ts)))]

    def state_upto(self, ts, grace=4e-3):
        """Newest live state with timestamp <= ts. A ts up to ``grace``
        seconds older than the oldest live state still returns that oldest
        state; beyond that, None."""
        if not self.initialized or self.n_active == 0:
            return None
        i = int(np.searchsorted(np.asarray(self.state_ts[:self.n_active]),
                                ts, side="right")) - 1
        if i < 0:
            if ts >= self.state_ts[0] - grace:
                i = 0
            else:
                return None
        return self._mk_state(self.state_ts[i], self._window_rows()[i])

    def pose_at(self, ts, tol=5e-3, interpolate=False):
        """(q_wxyz, p) at a logged timestamp, searched over the whole
        trajectory ring including marginalized states, unlike
        :meth:`state_upto`, which sees only the live window. Nearest entry
        within ``tol`` seconds; with ``interpolate=True`` an in-range ts is
        answered by slerp / lerp between the bracketing entries. None
        outside the log (or outside tol)."""
        n = len(self._traj_ts)
        if n == 0:
            return None
        ts_arr = np.asarray(self._traj_ts)
        q = self.traj_q[:n].cpu().numpy()
        p = self.traj_p[:n].cpu().numpy()
        if interpolate and ts_arr[0] <= ts <= ts_arr[-1]:
            j = int(np.searchsorted(ts_arr, ts, side="left"))
            if j == 0 or ts_arr[j] == ts:
                return q[j], p[j]
            i = j - 1
            # rows can sit out of ts order (a same-key refresh); an
            # inverted bracket would extrapolate, so fall back to the
            # nearest entry within tol
            if ts_arr[i] <= ts <= ts_arr[j]:
                a = (ts - ts_arr[i]) / max(ts_arr[j] - ts_arr[i], 1e-12)
                return (_slerp_np(np.asarray(q[i], np.float64),
                                  np.asarray(q[j], np.float64),
                                  a).astype(q.dtype),
                        (1.0 - a) * p[i] + a * p[j])
        k = int(np.argmin(np.abs(ts_arr - ts)))
        if abs(ts_arr[k] - ts) > tol:
            return None
        return q[k], p[k]

    def _ensure_log_capacity(self, extra=0):
        """Double the device trajectory / debug rings until ``extra`` more
        rows fit (the captured steps are captured again for the new
        buffers)."""
        while max(self.scan_idx, len(self._traj_ts)) + extra >= \
                self.traj_q.shape[0] - 1:
            self.traj_q, self.traj_p, self.debug_rec = (
                torch.cat([a, torch.zeros_like(a)])
                for a in (self.traj_q, self.traj_p, self.debug_rec))
            logger.info("trajectory/debug log capacity grown to %d rows",
                        self.traj_q.shape[0])

    # ------------------------------------------------------------------ IMU
    def add_imu(self, ts, acc, gyro):
        self.imu.add(float(ts), acc, gyro)

    def add_imu_batch(self, ts, acc, gyro):
        """Bulk time-ordered IMU insert (one vectorized pass)."""
        self.imu.add_batch(ts, acc, gyro)

    # ---------------------------------------------------------------- radar
    RADAR_BULK_PAD = 512              # target rows a frame

    def _imu_rows(self, t0, t1):
        """The IMU segment [t0, t1] as [m, 8] rows (acc3, gyro3, dt,
        valid), m = max_imu_per_segment."""
        out = np.zeros((self.cfg.max_imu_per_segment, 8))
        self.imu.segment_into(t0, t1, out)
        return out

    def add_radar(self, ts, points_r, doppler, snr_db=None,
                  radar_cfg=None):
        """Radar frame: the one-step Doppler factor (declared and defined
        in one step). ``points_r`` [N,3] targets in the radar frame,
        ``doppler`` [N] radial speeds, ``snr_db`` [N]; at most
        ``RADAR_BULK_PAD`` targets are kept. Declares a new state when at
        least ``min_imu_between_states`` IMU samples arrived since the
        newest state, else attaches to the newest state; a frame older than
        the newest state goes to :meth:`_radar_ooo`. Each in-order frame
        logs a trajectory row, declaring or not."""
        rcfg = radar_cfg or self.radar_cfg or rad.RadarConfig()
        self.radar_cfg = rcfg
        self.counters.setdefault("radar_frames", 0)
        self.counters.setdefault("radar_dropped", 0)
        self.counters["radar_frames"] += 1
        self._ensure_log_capacity()
        ts = float(ts)
        if not self.initialized:
            if rcfg.use_to_init:
                self._try_initialize_inertial(ts)
            if not self.initialized:
                self.counters["radar_dropped"] += 1
                return
        if not self.imu.covers(min(self.last_state_ts, ts), ts):
            self.counters["radar_dropped"] += 1
            return

        n_pad = self.RADAR_BULK_PAD
        rpack = np.zeros((n_pad + 1, 5))
        self._radar_rows(rpack, ts, points_r, doppler, snr_db)

        if ts <= self.last_state_ts:
            self._radar_ooo(ts, rpack, rcfg)
            return

        declare = self.imu.count_between(self.last_state_ts, ts) >= \
            self.cfg.min_imu_between_states
        if declare:
            self._enforce_lag(ts)
        if declare and self.n_active == self.win_cfg.K:
            self._marginalize_host()
        rpack[n_pad, 0] = self.n_active if declare else self.n_active - 1
        rpack[n_pad, 4] = len(self._traj_ts)
        if declare:
            self._run(("radar", "declare", rcfg),
                      (self._put(self._imu_rows(self.last_state_ts, ts)),
                       self._put(rpack)))
            self.n_active += 1
            self.last_state_ts = ts
            self.state_ts.append(ts)
        else:
            self._run(("radar", "attach", rcfg), (self._put(rpack),))
        self._traj_ts.append(ts)
        self._traj_src.append(-1)

    def _radar_rows(self, rpack, ts, points_r, doppler, snr_db):
        """Fill a radar pack [RADAR_BULK_PAD + 1, 5] (zeros) with a frame:
        its targets, NaN positions and an SNR of -1e9 padding the rest
        (``filter_targets`` drops them on the device), and the lever arm's
        omega, the mean gyro over the 20 ms exposure, in the scalar row."""
        n_pad = self.RADAR_BULK_PAD
        rpack[:n_pad, 0:3] = np.nan
        rpack[:n_pad, 4] = -1e9
        k = min(len(points_r), n_pad)
        rpack[:k, 0:3] = np.asarray(points_r)[:k]
        rpack[:k, 3] = np.asarray(doppler)[:k]
        rpack[:k, 4] = (np.asarray(snr_db)[:k] if snr_db is not None
                        else 1e9)
        _, rpack[n_pad, 1:4] = self.imu.mean_measurements(
            max(ts - 0.02, self.imu.t_first), ts)

    def _radar_ooo(self, ts, rpack, rcfg):
        """A radar frame older than the newest state: collapsed onto the
        neighbouring state when fewer than ``min_imu_between_states`` IMU
        samples separate them, else a state inserted mid-window with the
        IMU segments around it re-integrated; dropped when older than
        ``max_measurement_latency`` or than the oldest state."""
        self.counters.setdefault("radar_ooo_samekey", 0)
        self.counters.setdefault("radar_ooo_inserted", 0)
        self.counters.setdefault("radar_ooo_dropped", 0)
        if self.last_state_ts - ts > self.cfg.max_measurement_latency or \
                ts <= self.state_ts[0] or self.n_active < 2:
            self.counters["radar_ooo_dropped"] += 1
            return
        pos = bisect.bisect_left(self.state_ts, ts)   # insert index
        prev_ts, next_ts = self.state_ts[pos - 1], self.state_ts[pos]
        min_imu = self.cfg.min_imu_between_states
        near_prev = self.imu.count_between(prev_ts, ts) < min_imu
        near_next = self.imu.count_between(ts, next_ts) < min_imu
        n_pad = self.RADAR_BULK_PAD
        if near_prev or near_next:
            rpack[n_pad, 0] = pos - 1 if near_prev else pos
            self._run(("radar", "samekey", rcfg), (self._put(rpack),))
            self.counters["radar_ooo_samekey"] += 1
            return
        if self.n_active == self.win_cfg.K:
            self._marginalize_host()
            pos -= 1
            if pos < 1:
                self.counters["radar_ooo_dropped"] += 1
                return
            prev_ts = self.state_ts[pos - 1]
        rpack[n_pad, 0] = pos
        imu_ab = np.concatenate([self._imu_rows(prev_ts, ts),
                                 self._imu_rows(ts, next_ts)])
        self._run(("radar", "ooo", rcfg),
                  (self._put(imu_ab), self._put(rpack)))
        self._inserted(pos, ts)
        self.counters["radar_ooo_inserted"] += 1

    def _inserted(self, pos, ts):
        """Host bookkeeping of a state inserted at slot ``pos``."""
        self.n_active += 1
        self.state_ts.insert(pos, ts)
        prev = self._odom_prev
        if prev is not None and prev["slot"] >= pos:
            prev["slot"] += 1

    # ------------------------------------------------------------- odometry
    def add_odometry(self, ts, q_s, t_s, cov6=None, odom_cfg=None):
        """External odometry pose (sensor frame, q wxyz): a relative-pose
        between factor from the previous message's state to this one's,
        dropped when the covariance's D-optimality exceeds
        ``max_d_optimality``. The first message (or one whose anchor state
        left the window) only anchors. Each message that makes a factor
        logs a trajectory row, declaring or not."""
        ocfg = odom_cfg or self.odom_cfg or odo.OdometryConfig()
        self.odom_cfg = ocfg
        self.counters.setdefault("odom_msgs", 0)
        self.counters.setdefault("odom_dropped", 0)
        self.counters["odom_msgs"] += 1
        self._ensure_log_capacity()
        ts = float(ts)
        if cov6 is not None and odo.d_optimality(np.asarray(cov6)) > \
                ocfg.max_d_optimality:
            self.counters["odom_dropped"] += 1
            return
        if not self.initialized and ocfg.use_to_init:
            self._try_initialize_inertial(ts)
        if not self.initialized or ts <= self.last_state_ts or \
                not self.imu.covers(self.last_state_ts, ts):
            self.counters["odom_dropped"] += 1
            return
        declare = self.imu.count_between(self.last_state_ts, ts) >= \
            self.cfg.min_imu_between_states
        anchor = dict(q=np.asarray(q_s), t=np.asarray(t_s))
        if self._odom_prev is None or self._odom_prev["slot"] < 0:
            # anchor only: the first message, or the previous anchor state
            # was marginalized out of the window
            self.counters["odom_anchor"] = \
                self.counters.get("odom_anchor", 0) + 1
            if declare:
                self._enforce_lag(ts)
                if self.n_active == self.win_cfg.K:
                    self._marginalize_host()
                self._declare_plain(ts)
            self._odom_prev = dict(slot=self.n_active - 1, **anchor)
            return
        if declare:
            self._enforce_lag(ts)
        if declare and self.n_active == self.win_cfg.K:
            self._marginalize_host()
        prev = self._odom_prev      # its slot may have shifted
        if prev["slot"] < 0:
            self.counters["odom_anchor"] = \
                self.counters.get("odom_anchor", 0) + 1
            self._odom_prev = dict(slot=self.n_active - 1, **anchor)
            return
        opack = np.zeros((3, 7))
        opack[0, 0:3] = [self.n_active if declare else self.n_active - 1,
                         prev["slot"], len(self._traj_ts)]
        opack[1] = np.concatenate([prev["q"], prev["t"]])
        opack[2] = np.concatenate([anchor["q"], anchor["t"]])
        inputs = (self._put(opack),)
        if declare:
            inputs = (self._put(self._imu_rows(self.last_state_ts, ts)),) \
                + inputs
        self._run(("odom", declare, ocfg), inputs)
        if declare:
            self.n_active += 1
            self.last_state_ts = ts
            self.state_ts.append(ts)
        self._odom_prev = dict(slot=self.n_active - 1, **anchor)
        self._traj_ts.append(ts)
        self._traj_src.append(-1)

    def _declare_plain(self, ts):
        """Declare a new state from the IMU alone (no measurement factor,
        no trajectory row)."""
        imu_f = np.zeros((self.cfg.max_imu_per_segment + 1, 8))
        self.imu.segment_into(self.last_state_ts, ts, imu_f[:-1])
        imu_f[-1, 0] = self.n_active
        self._run(("declare",), (self._put(imu_f),))
        self.n_active += 1
        self.last_state_ts = ts
        self.state_ts.append(ts)

    # ----------------------------------------------------------------- scan
    def stage_scan(self, ts_header, points, t_rel, valid=None,
                   intensity=None):
        """Pack a scan in the configured codec (:func:`_decode_scan`) and
        start its transfer to the device. Returns the handle for
        ``add_scan(ts_header, staged=handle)``. ``intensity`` [N] travels
        only for a photometric Sequencer (zero where not given)."""
        points = np.asarray(points)
        t_rel = np.asarray(t_rel)
        c, n = self.cfg, self.cfg.max_scan_points
        ncol = _scan_ncol(c, self.photo_cfg is not None)
        with self.timers.stage("t_prepare"):
            if c.quantize_transfer:
                scan, vd = np.empty((n, ncol), np.int16), None
            else:
                scan, vd = np.empty((n, ncol)), np.empty(n, bool)
            t_max = self._pack_scan_row(
                dict(points=points, t_rel=t_rel, valid=valid,
                     intensity=intensity), scan, vd)
            # the full-density scan, for the map seed
            raw = (points, t_rel, np.isfinite(points).all(-1)
                   if valid is None else np.asarray(valid, bool))
            return dict(ts_header=float(ts_header),
                        t_end=float(ts_header + t_max),
                        scan_dev=self._put(scan, torch.int16 if vd is None
                                           else None),
                        valid_dev=None if vd is None
                        else self._put(vd, torch.bool), raw=raw)

    def add_scan(self, ts_header, points=None, t_rel=None, valid=None,
                 intensity=None, staged=None):
        """points [N,3] in the lidar frame; t_rel [N] per-point time offsets
        from ts_header [s]; optional per-point intensity (photometric).
        Pass ``staged`` (from :meth:`stage_scan`) instead of raw arrays to
        consume a scan staged ahead of time."""
        self.counters["scans"] += 1
        self._ensure_log_capacity()
        if staged is None:
            staged = self.stage_scan(ts_header, points, t_rel, valid,
                                     intensity)
        ts_header = staged["ts_header"]
        t_end = staged["t_end"]

        if not self.initialized:
            self._try_initialize(ts_header, t_end, *staged["raw"])
            return
        if t_end <= self.last_state_ts:
            self._scan_ooo(staged)
            return
        if not self.imu.covers(self.last_state_ts, t_end):
            self.counters["scans_no_imu"] += 1
            return
        same_key = self.imu.count_between(self.last_state_ts, t_end) < \
            self.cfg.min_imu_between_states

        m = self.cfg.max_imu_per_segment
        imu_pack = np.zeros((m + 1, 8))
        self.imu.segment_into(self.last_state_ts, t_end, imu_pack[:m])
        # rebase timestamps to the segment start on the host in f64: only
        # segment-relative times reach the device in f32
        base = self.last_state_ts
        # the slide runs as its own step, or first inside the scan step
        # (merge_marginalize); same-key attaches to an existing state, so
        # it needs no free slot
        if not same_key:
            self._enforce_lag(t_end)
        do_marg = not same_key and self.n_active == self.win_cfg.K
        if do_marg and not self.cfg.merge_marginalize:
            self._marginalize_host()
        elif do_marg:
            self._slid()
        if same_key:
            imu_pack[m, :6] = [self.n_active - 1, t_end - base,
                               len(self._traj_ts) - 1, self.scan_idx,
                               ts_header - base, self.n_active - 1]
        else:
            imu_pack[m, :6] = [self.n_active, t_end - base,
                               len(self._traj_ts), self.scan_idx,
                               ts_header - base, 0]

        self._run(("scan", do_marg and self.cfg.merge_marginalize,
                   not same_key),
                  (staged["scan_dev"], staged["valid_dev"],
                   self._put(imu_pack)))
        self.scan_idx += 1
        if same_key:
            # the refreshed trajectory row now carries this scan's pose
            if self._traj_src:
                self._traj_src[-1] = self.scan_idx - 1
            self.counters["scans_same_key"] += 1
            return
        self.n_active += 1
        self.last_state_ts = t_end
        self.state_ts.append(t_end)
        self._traj_ts.append(t_end)
        self._traj_src.append(self.scan_idx - 1)

    # -------------------------------------------------------- bulk (offline)
    # The JAX package runs a chunk as one lax.scan with a lax.switch on
    # each event's code. The host knows every code when it packs the
    # chunk, so here a code is the streaming variants it replays:
    #   0 scan             ("scan", True, True)
    #   1 radar declare    ("marginalize",), ("radar", "declare", rcfg)
    #   2 radar attach     ("radar", "attach", rcfg)
    #   3 odometry declare ("marginalize",), ("odom", True, ocfg)
    #   4 odometry attach  ("odom", False, ocfg)

    def add_scans_bulk(self, scans, chunk=32, tail_chunk=None):
        """Offline batch replay of scans (the ``io.synthetic.generate``
        scan layout: ``ts_header``, ``points``, ``t_rel``, optional
        ``valid`` / ``intensity``), all of whose IMU is already in the
        buffer: :meth:`add_bulk` on a scan-only stream."""
        return self.add_bulk(scans, chunk=chunk, tail_chunk=tail_chunk)

    def _pack_scan_row(self, sc, out_row, ptv_row):
        """Pack scan dict ``sc`` (``points``, ``t_rel``, optional ``valid``
        and ``intensity``) in the configured codec into ``out_row`` (and
        its lane mask into ``ptv_row`` in the f32 codec), in place: a row
        of a bulk chunk's slab, or :meth:`stage_scan`'s buffer. The
        intensity column travels only for a photometric Sequencer. Returns
        the largest point time over the valid lanes of the full-density
        scan (0 where none is valid)."""
        c, n = self.cfg, self.cfg.max_scan_points
        photo = self.photo_cfg is not None
        ncol = _scan_ncol(c, photo)
        points, t_rel = np.asarray(sc["points"]), np.asarray(sc["t_rel"])
        valid = sc.get("valid")
        intensity = sc.get("intensity") if photo else None
        if c.quantize_transfer:
            if c.range_transfer:
                # lanes past the beam table would decode as ranges along
                # the unit-z pad direction, so refuse them
                n_lanes = min(-(-len(points) // c.point_skip), n)
                if n_lanes > self._ray_dirs_lanes:
                    raise ValueError(
                        f"range_transfer: scan has {n_lanes} post-skip "
                        f"lanes but the ray_dirs table covers only "
                        f"{self._ray_dirs_lanes}")
                return native.pack_range(
                    points, t_rel, valid, intensity, c.point_skip, n, ncol,
                    c.quant_range_res, c.quant_t_res, c.quant_int_res,
                    dither=c.quant_dither, beam=self._beam_table,
                    out=out_row)[1]
            return native.pack_scan(
                points, t_rel, valid, intensity, c.point_skip, n, ncol,
                c.quant_pos_res, c.quant_t_res, c.quant_int_res,
                dither=c.quant_dither, out=out_row)[1]
        valid = np.isfinite(points).all(-1) if valid is None \
            else np.asarray(valid, bool)
        t_max = t_rel[valid].max() if valid.any() else 0.0
        k = c.point_skip
        if k > 1:
            points, t_rel, valid = points[::k], t_rel[::k], valid[::k]
        pts, tp, vd = _pad_scan(points, t_rel, valid, n)
        out_row[:, :3] = pts
        out_row[:, 3] = np.where(vd, tp, 0.0)
        if photo:
            inten = np.zeros(n)
            if intensity is not None:
                it = np.asarray(intensity)[::k][:n]
                inten[:len(it)] = np.nan_to_num(it)
            out_row[:, 4] = inten
        ptv_row[:] = vd
        return t_max

    def _host_slab(self, shape, dtype):
        """A chunk's host slab (a tensor and its numpy view), pinned on the
        card so that its copy neither waits nor needs a staging buffer. A
        chunk takes a new one: the pinned allocator keeps it until its copy
        has run, so no later chunk refills it while the copy is in
        flight."""
        t = torch.empty(shape, dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        return t, t.numpy()

    def _run_bulk_chunk(self, scans, t_ends):
        """One chunk of steady-state scans (each eligible; ``t_ends`` their
        end times, in order): :meth:`_run_bulk_chunk_mm` with code 0 for
        each."""
        self._run_bulk_chunk_mm(
            [(0, sc, t, None) for sc, t in zip(scans, t_ends)], None, None)

    def _run_bulk_chunk_mm(self, events, rcfg, ocfg):
        """Pack, send and run one chunk. ``events``: (code, message,
        declare / attach time, odometry anchor slot after the event's own
        slide), in dispatch order, each eligible (:meth:`add_bulk`).

        The rings grow for the whole chunk first (a ring grown mid-chunk
        would capture every graph again). Slabs, packed on the host and
        sent with one copy each: the scans [S, n, ncol] (and their masks
        [S, n] in the f32 codec); the IMU [C, m+1, 8], or [C, m+3, 8] when
        the chunk holds odometry: rows [0, m) a declare's segment, row m a
        scan's scalar block, rows m..m+2 (columns 0-6) an odometry event's
        pack (the scalars [slot, anchor slot, trajectory row], then the
        previous and the current sensor pose); the radar frames
        [F, RADAR_BULK_PAD + 1, 5] (NaN positions and an SNR of -1e9 pad
        the targets; the scalar row holds the slot, the mean gyro over
        20 ms and the trajectory row). The layouts are the streaming
        packs, so each row feeds its variant's graph, whose static inputs
        are then filled by copies on the device. The host bookkeeping of
        the whole chunk comes after the replays."""
        C = len(events)
        cfg, K = self.cfg, self.win_cfg.K
        m, n, R = cfg.max_imu_per_segment, cfg.max_scan_points, \
            self.RADAR_BULK_PAD
        codes = [code for code, _, _, _ in events]
        n_scans = codes.count(0)
        n_radar = codes.count(1) + codes.count(2)
        n_odom = C - n_scans - n_radar
        self.counters["scans"] += n_scans
        if n_radar:
            self.counters.setdefault("radar_frames", 0)
            self.counters.setdefault("radar_dropped", 0)
            self.counters["radar_frames"] += n_radar
        if n_odom:
            self.counters.setdefault("odom_msgs", 0)
            self.counters.setdefault("odom_dropped", 0)
            self.counters["odom_msgs"] += n_odom
        self._ensure_log_capacity(C)
        f32 = not cfg.quantize_transfer
        ncol = _scan_ncol(cfg, self.photo_cfg is not None)
        none = (None, None)
        scan_t, scan_np = self._host_slab(
            (n_scans, n, ncol), self.dtype if f32 else torch.int16) \
            if n_scans else none
        ptv_t, ptv_np = self._host_slab((n_scans, n), torch.bool) \
            if n_scans and f32 else none
        imu_t, imu_np = self._host_slab((C, m + (3 if n_odom else 1), 8),
                                        self.dtype)
        imu_np[:] = 0.0
        rad_t, rad_np = self._host_slab((n_radar, R + 1, 5), self.dtype) \
            if n_radar else none
        if n_radar:
            rad_np[:] = 0.0
        scan_idx0, traj_idx0 = self.scan_idx, len(self._traj_ts)
        cursor = self.last_state_ts
        declared = []
        odom_last = None        # (event index, sensor pose) of the last one
        si = ri = 0
        tmr = self.timers.stage
        with tmr("t_bulk_pack"):
            for k, (code, msg, t, aux) in enumerate(events):
                if code in (0, 1, 3):
                    # a declare after its slide: the segment from the newest
                    # state, the new state in slot K - 1
                    self.imu.segment_into(cursor, t, imu_np[k, :m])
                if code == 0:
                    self._pack_scan_row(msg, scan_np[si],
                                        ptv_np[si] if f32 else None)
                    imu_np[k, m, :6] = [K - 1, t - cursor, traj_idx0 + k,
                                        scan_idx0 + si,
                                        float(msg["ts_header"]) - cursor, 0]
                    si += 1
                elif code in (1, 2):
                    self._radar_rows(rad_np[ri], t, msg["points_r"],
                                     msg["doppler"], msg.get("snr_db"))
                    rad_np[ri, R, 0] = K - 1
                    rad_np[ri, R, 4] = traj_idx0 + k
                    ri += 1
                else:
                    prev = odom_last[1] if odom_last is not None \
                        else self._odom_prev
                    pose = dict(q=np.asarray(msg["q"]),
                                t=np.asarray(msg["p"]))
                    imu_np[k, m, :3] = [K - 1, aux, traj_idx0 + k]
                    imu_np[k, m + 1, :7] = np.concatenate([prev["q"],
                                                           prev["t"]])
                    imu_np[k, m + 2, :7] = np.concatenate([pose["q"],
                                                           pose["t"]])
                    odom_last = (k, pose)
                if code in (0, 1, 3):
                    declared.append(t)
                    cursor = t
        with tmr("t_bulk_put"):
            scans, ptvs, imu, rad = (
                None if x is None else x.to(self.device, non_blocking=True)
                for x in (scan_t, ptv_t, imu_t, rad_t))
        with tmr("t_bulk_dispatch"):
            si = ri = 0
            for k, code in enumerate(codes):
                if code == 0:
                    self._run(("scan", True, True),
                              (scans[si], None if ptvs is None else ptvs[si],
                               imu[k, :m + 1]))
                    si += 1
                    continue
                if code in (1, 3):
                    self._run(("marginalize",))
                seg = (imu[k, :m],) if code in (1, 3) else ()
                if code in (1, 2):
                    self._run(("radar", "declare" if code == 1 else "attach",
                               rcfg), seg + (rad[ri],))
                    ri += 1
                else:
                    self._run(("odom", code == 3, ocfg),
                              seg + (imu[k, m:m + 3, :7],))
        # the host bookkeeping of the whole chunk
        self.scan_idx += n_scans
        self.state_ts = (self.state_ts + declared)[len(declared):]
        if declared:
            self.last_state_ts = declared[-1]
        sj = scan_idx0
        for code, _, t, _ in events:
            self._traj_ts.append(t)
            self._traj_src.append(sj if code == 0 else -1)
            sj += code == 0
        if odom_last is not None:
            # the anchor: the chunk's last odometry pose, in the newest slot
            # at its event, shifted by the declares after it
            k0, pose = odom_last
            n_after = sum(1 for c in codes[k0 + 1:] if c in (0, 1, 3))
            self._odom_prev = dict(slot=K - 1 - n_after, **pose)
        elif self._odom_prev is not None:
            self._odom_prev["slot"] -= len(declared)
        b = self.bulk_counts
        b["chunks"] += 1
        b["in_chunks"] += C
        for code in codes:
            b["codes"][code] += 1

    def add_bulk(self, msgs, chunk=32, radar_cfg=None, odom_cfg=None,
                 tail_chunk=None):
        """Offline replay of a recorded four-modality sequence, in chunks.

        ``msgs``: dicts, in any order. ``kind="scan"`` (the default): the
        :meth:`add_scans_bulk` scan layout. ``kind="radar"``: ``ts``,
        ``points_r`` [N,3] in the radar frame, ``doppler`` [N], optional
        ``snr_db`` [N]. ``kind="odom"``: ``ts``, ``q`` [4] wxyz, ``p`` [3]
        (the sensor's pose), optional ``cov6``. All their IMU must be in
        the buffer already. Events run in dispatch order, a scan at its
        end time and a radar frame or an odometry message at its own
        (ties: scans, radar, odometry), the order in which the streaming
        replay releases them.

        The host simulates the streaming decisions from each event on
        (the declare and attach gates, the IMU coverage, the lag and the
        odometry anchor slot) to find the longest run of events that the
        steady-state paths take with a full window. Such a run executes in
        chunks of ``chunk`` events (:meth:`_run_bulk_chunk_mm`), then, with
        ``tail_chunk``, in chunks of that size; what is left of it, and
        every event that needs another path (initialization, the window
        filling, a same-key scan, a late event, missing IMU, a slide the
        lag forces, an odometry anchor set afresh or a message the
        D-optimality gate rejects), goes through :meth:`add_scan`,
        :meth:`add_radar` or :meth:`add_odometry` one by one. Each chunk
        gives the bits of the streaming path with ``merge_marginalize``."""
        rcfg = radar_cfg or self.radar_cfg or rad.RadarConfig()
        self.radar_cfg = rcfg
        ocfg = odom_cfg or self.odom_cfg or odo.OdometryConfig()
        self.odom_cfg = ocfg
        chunk = max(2, int(chunk))
        items = []
        for m_ in msgs:
            kind = m_.get("kind", "scan")
            if kind == "scan":
                items.append((self._scan_t_end(m_), 0, m_))
            elif kind == "radar":
                items.append((float(m_["ts"]), 1, m_))
            elif kind == "odom":
                items.append((float(m_["ts"]), 2, m_))
            else:
                raise ValueError(f"add_bulk got unknown kind={kind!r}")
        items.sort(key=lambda e: (e[0], e[1]))
        K = self.win_cfg.K
        lag = self.cfg.lag_secs
        min_imu = self.cfg.min_imu_between_states
        i = 0
        while i < len(items):
            # the longest eligible run from i: (code, message, time,
            # odometry anchor slot)
            run = []
            cursor = self.last_state_ts
            sim_sts = list(self.state_ts)
            prev_o = self._odom_prev
            sim_oslot = prev_o["slot"] if prev_o is not None else None
            if self.initialized and self.n_active == K:
                j = i
                while j < len(items):
                    t_disp, mkind, m_ = items[j]
                    lag_ok = lag <= 0 or sim_sts[0] >= t_disp - lag
                    if not (t_disp > cursor
                            and self.imu.covers(cursor, t_disp)):
                        break
                    declare = self.imu.count_between(cursor, t_disp) >= \
                        min_imu
                    if mkind == 0:
                        if not declare or not lag_ok:
                            break         # same-key scan or a lag slide
                        run.append((0, m_, t_disp, None))
                    elif mkind == 1:
                        if declare:
                            if not lag_ok:
                                break
                            run.append((1, m_, t_disp, None))
                        else:
                            run.append((2, m_, t_disp, None))
                            j += 1
                            continue
                    else:
                        cov = m_.get("cov6")
                        if cov is not None and odo.d_optimality(
                                np.asarray(cov)) > ocfg.max_d_optimality:
                            break         # add_odometry drops it
                        if sim_oslot is None:
                            break         # the first anchor
                        pslot = sim_oslot - 1 if declare else sim_oslot
                        if pslot < 0 or (declare and not lag_ok):
                            break         # the anchor set afresh, or lag
                        run.append((3 if declare else 4, m_, t_disp, pslot))
                        sim_oslot = K - 1
                        if declare:
                            sim_sts = sim_sts[1:] + [t_disp]
                            cursor = t_disp
                        j += 1
                        continue
                    if sim_oslot is not None:
                        sim_oslot -= 1    # the declare's slide
                    sim_sts = sim_sts[1:] + [t_disp]
                    cursor = t_disp
                    j += 1
            sizes = [chunk] + ([max(2, int(tail_chunk))] if tail_chunk
                               else [])
            for csize in sizes:
                while len(run) >= csize:
                    batch, run = run[:csize], run[csize:]
                    if all(code == 0 for code, _, _, _ in batch):
                        self._run_bulk_chunk([m_ for _, m_, _, _ in batch],
                                             [t for _, _, t, _ in batch])
                    else:
                        self._run_bulk_chunk_mm(batch, rcfg, ocfg)
                    i += csize
            # stream the rest of the run, or the one event that needs
            # another path
            end = max(i + len(run), i + 1)
            while i < min(end, len(items)):
                _, mkind, m_ = items[i]
                if mkind == 1:
                    self.add_radar(m_["ts"], m_["points_r"], m_["doppler"],
                                   m_.get("snr_db"), radar_cfg=rcfg)
                elif mkind == 2:
                    self.add_odometry(m_["ts"], m_["q"], m_["p"],
                                      m_.get("cov6"), odom_cfg=ocfg)
                else:
                    self.add_scan(m_["ts_header"], m_["points"],
                                  m_["t_rel"], m_.get("valid"),
                                  intensity=m_.get("intensity"))
                self.bulk_counts["streamed"] += 1
                i += 1

    # --------------------------------------------------------------- helpers
    def _enforce_lag(self, newest_ts):
        """Fixed-lag marginalization: drop live states older than
        ``newest_ts - lag_secs`` before declaring."""
        lag = self.cfg.lag_secs
        if lag <= 0:
            return
        while self.n_active > 2 and self.state_ts and \
                self.state_ts[0] < newest_ts - lag:
            self._marginalize_host()

    def _marginalize_host(self):
        self._run(("marginalize",))
        self._slid()

    def _slid(self):
        """Host bookkeeping of a window slide: the slots move down one."""
        self.n_active -= 1
        if self.state_ts:
            self.state_ts.pop(0)
        if self._odom_prev is not None:
            self._odom_prev["slot"] -= 1

    @staticmethod
    def _scan_t_end(sc):
        """A scan dict's end time: header + the largest finite point time
        over its valid lanes (``io.synthetic.generate``'s layout)."""
        t_rel = np.asarray(sc["t_rel"])
        vd = sc.get("valid")
        tv = t_rel if vd is None else t_rel[np.asarray(vd, bool)]
        tm = float(np.max(np.where(np.isfinite(tv), tv, -np.inf))) \
            if tv.size else 0.0
        return float(sc["ts_header"] + (tm if np.isfinite(tm) else 0.0))

    def _scan_ooo(self, staged):
        """A scan older than the newest state (a second LiDAR, transport
        jitter): collapsed onto the neighbouring state when fewer than
        ``min_imu_between_states`` IMU samples separate them (the
        same-key scan step, deskewed from the previous state), else a
        state inserted mid-window (:func:`_scan_ooo_step`); dropped when
        older than ``max_measurement_latency`` or than the oldest
        state."""
        self.counters.setdefault("scans_ooo_samekey", 0)
        self.counters.setdefault("scans_ooo_inserted", 0)
        t_end = staged["t_end"]
        ts_header = staged["ts_header"]
        if self.last_state_ts - t_end > self.cfg.max_measurement_latency \
                or t_end <= self.state_ts[0] or self.n_active < 2:
            self.counters["scans_dropped_ooo"] += 1
            logger.warning("scan at %.4f too old (newest state %.4f) — "
                           "dropped", t_end, self.last_state_ts)
            return
        pos = bisect.bisect_left(self.state_ts, t_end)
        prev_ts, next_ts = self.state_ts[pos - 1], self.state_ts[pos]
        min_imu = self.cfg.min_imu_between_states
        near_prev = self.imu.count_between(prev_ts, t_end) < min_imu
        near_next = self.imu.count_between(t_end, next_ts) < min_imu
        m = self.cfg.max_imu_per_segment
        if near_prev or near_next:
            attach = pos - 1 if near_prev else pos
            # refresh the attach state's own trajectory row (rows and states
            # share their declare time); a state with no row (an inserted
            # one) writes the scratch row
            attach_ts = self.state_ts[attach]
            traj_row = self.traj_q.shape[0] - 1
            for row in range(len(self._traj_ts) - 1, -1, -1):
                if self._traj_ts[row] == attach_ts:
                    traj_row = row
                    break
            imu_pack = np.zeros((m + 1, 8))
            self.imu.segment_into(prev_ts, t_end, imu_pack[:m])
            # scalars[0] is the deskew base, scalars[5] the attach slot
            imu_pack[m, :6] = [pos - 1, t_end - prev_ts, traj_row,
                               self.scan_idx, ts_header - prev_ts, attach]
            self._run(("scan", False, False),
                      (staged["scan_dev"], staged["valid_dev"],
                       self._put(imu_pack)))
            self.scan_idx += 1
            if traj_row < len(self._traj_src):
                self._traj_src[traj_row] = self.scan_idx - 1
            self.counters["scans_ooo_samekey"] += 1
            return
        if self.n_active == self.win_cfg.K:
            self._marginalize_host()
            pos -= 1
            if pos < 1:
                self.counters["scans_dropped_ooo"] += 1
                return
            prev_ts, next_ts = self.state_ts[pos - 1], self.state_ts[pos]
        imu_f = np.zeros((2 * m + 1, 8))
        self.imu.segment_into(prev_ts, t_end, imu_f[:m])
        self.imu.segment_into(t_end, next_ts, imu_f[m:2 * m])
        imu_f[2 * m, :6] = [pos, t_end - prev_ts, self.traj_q.shape[0] - 1,
                            self.scan_idx, ts_header - prev_ts, 0]
        self._run(("scan_ooo",), (staged["scan_dev"], staged["valid_dev"],
                                  self._put(imu_f)))
        self.scan_idx += 1
        self._inserted(pos, t_end)
        self.counters["scans_ooo_inserted"] += 1

    def _try_initialize_inertial(self, ts):
        """Initialization from a non-LiDAR sensor (``use_to_init``):
        stationary attitude only; the map is seeded by the first scan's
        keyframe insert instead."""
        self.counters["init_attempts"] += 1
        att = estimate_attitude(self.imu, ts, self.cfg.pose_init_wait_secs,
                                self.cfg.g_mag,
                                self.cfg.gravity_aligned_init)
        if att is None:
            return
        put = self._put
        self.window, self.traj_q, self.traj_p = _init_inertial_step(
            self.window, self.traj_q, self.traj_p, put(att["q_w_b"]),
            put(att["g_dir"]), put(att["bg"]), put(att["ba"]),
            put(np.asarray(ts)), win_cfg=self.win_cfg)
        self.n_active = 1
        self.initialized = True
        self.last_state_ts = ts
        self.state_ts = [ts]
        self._traj_ts.append(ts)
        self._traj_src.append(-1)
        logger.info("initialized (inertial) at ts=%.4f", ts)

    def _try_initialize(self, ts_header, t_end, points, t_abs_rel, valid):
        self.counters["init_attempts"] += 1
        att = estimate_attitude(self.imu, t_end, self.cfg.pose_init_wait_secs,
                                self.cfg.g_mag,
                                self.cfg.gravity_aligned_init)
        if att is None:
            return
        pts, _, vd = _pad_scan(points, ts_header + t_abs_rel, valid,
                               self.cfg.max_scan_points)
        put = self._put
        (self.window, self.vmap, self.traj_q, self.traj_p, self.kf_q,
         self.kf_p) = _init_lidar_step(
            self.window, self.vmap, self.traj_q, self.traj_p, self.kf_q,
            self.kf_p, put(pts), put(vd, torch.bool), put(att["q_w_b"]),
            put(att["g_dir"]), put(att["bg"]), put(att["ba"]),
            put(np.asarray(t_end)), self.q_bl, self.t_bl,
            seq_cfg=self.cfg, win_cfg=self.win_cfg, map_cfg=self.map_cfg,
            map_update_fn=self._map_update_fn)
        self.kf_count = torch.ones((), dtype=torch.int32, device=self.device)
        self.n_active = 1
        self.initialized = True
        self.last_state_ts = t_end
        self.state_ts = [t_end]
        self._traj_ts.append(t_end)
        self._traj_src.append(-1)
        logger.info("initialized at ts=%.4f q=%s", t_end, att["q_w_b"])
