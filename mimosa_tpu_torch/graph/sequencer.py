"""Deterministic measurement sequencer — the geometric LiDAR-inertial slice.

Port of the streaming geometric path of ``mimosa_tpu/graph/sequencer.py``:
a host event loop (IMU buffering, initialization, same-key collapse,
window sliding) feeding device step functions on torch tensors:

* ``_scan_step``: decode -> deskew -> preintegrate + append -> voxel
  downsample -> correspondence match -> ``n_gn_iters`` Gauss-Newton
  iterations with live ICP relinearization (the CUDA kernel of
  ``ops/icp_cuda.py`` on the card) -> absorb the scan into the prior ->
  keyframe test, map insert, eviction and plane refit -> trajectory and
  debug rows;
* ``_marginalize``: Schur-complement slide of the window;
* ``_init_lidar_step``: state setup + first-scan map seed.

The step reads nothing back to the host: counts, slots and indices stay
0-d device tensors, inputs go up through pinned memory without a sync, and
the trajectory / debug logs are device rings read once at the end.

Not ported yet (the constructor refuses these settings): the int16 and
range-image transfer codecs, the photometric factor, rescue and rematch,
merged marginalization, frozen-map localization, radar, odometry,
out-of-order scan insertion and the bulk scheduler.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from mimosa_tpu_torch import require_cuda
from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.graph import window as win
from mimosa_tpu_torch.imu import preintegration as pre
from mimosa_tpu_torch.imu.buffer import ImuBuffer, estimate_attitude
from mimosa_tpu_torch.lidar import deskew as dk
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.lidar.downsample import voxel_downsample
from mimosa_tpu_torch.mapping import voxel_hash as vh
from mimosa_tpu_torch.ops import icp_cuda
from mimosa_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("mimosa_tpu_torch.sequencer")

# per-scan debug record: 17 status slots (num_inlier, 4 status counts,
# mean |r|, 3+3 degeneracy flags, 4 photometric slots, rescue flag), the
# upper triangle (21) of the scan's absorbed pose information [6,6], and
# the 9 IMU-factor localizability eigenvalues (rot, pos, vel ascending)
DBG_W = 17 + 21 + 9


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
    # transfer codecs (the port has the plain f32 codec only)
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


# settings whose code paths are not ported yet, with the value they need
_PORTED_ONLY = dict(quantize_transfer=False, range_transfer=False,
                    merge_marginalize=False, rematch_on_motion=False,
                    rescue_enabled=False, freeze_map=False)


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
                         *, seq_cfg, map_cfg):
    """Keyframe decision + gated map insert + keyframe ring update, all on
    the device (a non-keyframe inserts with every lane masked)."""
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
    vmap = _map_update_at(vmap, map_pts, map_valid & is_kf, scan_idx,
                          map_cfg=map_cfg)

    kf_slot = torch.where(is_kf, kf_count, KF - 1).to(torch.int64)
    kf_q = _put_row(kf_q, kf_slot, torch.where(is_kf, q_new,
                                               _row(kf_q, kf_slot)))
    kf_p = _put_row(kf_p, kf_slot, torch.where(is_kf, p_new,
                                               _row(kf_p, kf_slot)))
    return vmap, kf_q, kf_p, kf_count + is_kf.to(torch.int32)


def _decode_scan(scan_f, t_offset):
    """Unpack a staged f32 scan [N, 4] (x, y, z, t_rel): point times shift
    from scan-header-relative to the IMU-segment base by ``t_offset``."""
    return scan_f[:, :3], scan_f[:, 3] + t_offset


def _scan_step(window, vmap, preints, fv, scan_f, pt_valid, imu_f,
               kf_q, kf_p, kf_count, traj_q, traj_p, debug_rec, q_bl, t_bl,
               *, seq_cfg, win_cfg, map_cfg, geo_cfg, append=True):
    """The per-scan pipeline. ``imu_f`` [M+1, 8]: M IMU rows (acc3, gyro3,
    dt, valid) and a last row of scalars [n_active (count BEFORE the
    append), t_end_rel, traj_idx, scan_idx, t_offset, attach_slot].

    ``append=False`` is the same-key path: fewer than
    ``min_imu_between_states`` IMU samples separate the scan end from the
    newest state, so the scan's factors act on that state instead of a new
    one."""
    d = window.p.dtype
    scalars = imu_f[-1]
    imu_f = imu_f[:-1]
    n_active = scalars[0].to(torch.int64)
    t_end = scalars[1]
    traj_idx = scalars[2].to(torch.int64)
    scan_idx = scalars[3].to(torch.int32)

    pts, t_pts = _decode_scan(scan_f, scalars[4])
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

    def geo_meas(icp_):
        """ICP measurement block, optionally projected onto the
        non-degenerate eigen-subspace."""
        if not geo_cfg.project_degenerate:
            return icp_.H, icp_.b
        Pp = geo.degeneracy_projector(icp_)
        return Pp @ icp_.H @ Pp.T, Pp @ icp_.b

    def pose():
        return _row(window.q, slot), _row(window.p, slot)

    # 5) GN with live ICP relinearization against correspondences made
    # once at the predicted pose; the IMU Jacobians are made once too
    matches = geo.match(vmap, pts_geo, *pose(), map_cfg)

    def lin_iter():
        return icp_cuda.linearize(matches, pts_geo, geo_valid, *pose(),
                                  geo_cfg, g_dir=window.g_dir)

    imu_cache = win.imu_factor_cache(window, preints, win_cfg)
    pidx = win.pose_idx(slot)
    for _ in range(seq_cfg.n_gn_iters):
        icp = lin_iter()
        H, rhs = win.build_system(window, preints, fv, win_cfg,
                                  meas=[(pidx, *geo_meas(icp))],
                                  imu_cache=imu_cache)
        window = win.apply_update(window, win.solve(H, rhs), win_cfg)

    # 6) absorb the final scan factor into the prior at converged values
    if seq_cfg.refresh_match_on_absorb:
        matches = geo.match(vmap, pts_geo, *pose(), map_cfg)
    icp = lin_iter()
    window = win.rebase_prior(window, win_cfg)
    gH, gb = geo_meas(icp)
    window = win.add_measurement_block(window, pidx, gH, gb, win_cfg)

    # 7) keyframe decision + map update + trajectory / debug logging
    q_new, p_new = pose()
    vmap, kf_q, kf_p, kf_count = _keyframe_map_update(
        vmap, q_new, p_new, dsk.points_le, geo_in, kf_q, kf_p, kf_count,
        scan_idx, q_bl, t_bl, seq_cfg=seq_cfg, map_cfg=map_cfg)
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
        icp.degenerate_trans.to(d),
        torch.zeros(5, dtype=d, device=gH.device),   # photometric + rescue
        gH[iu[0], iu[1]], loc_eig])
    debug_rec = _put_row(debug_rec, scan_idx.to(torch.int64), rec)
    return (window, vmap, preints, fv, kf_q, kf_p, kf_count, traj_q, traj_p,
            debug_rec)


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
                     *, seq_cfg, win_cfg, map_cfg):
    """State setup (:func:`_init_inertial_step`) + keyframe 0 + stationary
    first-scan map seed."""
    window, traj_q, traj_p = _init_inertial_step(
        window, traj_q, traj_p, q0, g0, bg, ba, ts, win_cfg=win_cfg)
    z3 = torch.zeros_like(bg)
    zero = torch.zeros((), dtype=torch.int64, device=bg.device)
    kf_q, kf_p = _put_row(kf_q, zero, q0), _put_row(kf_p, zero, z3)
    q_wl, t_wl = lie.se3_compose(q0, z3, q_bl, t_bl)
    ds, ds_valid, _ = voxel_downsample(
        lie.se3_transform(q_wl, t_wl, pts), vd, seq_cfg.map_insert_leaf,
        seq_cfg.n_map_points)
    vmap = _map_update(vmap, ds, ds_valid, zero.to(torch.int32),
                       map_cfg=map_cfg)
    return window, vmap, traj_q, traj_p, kf_q, kf_p


def _marginalize(window, preints, fv, *, win_cfg):
    window = win.marginalize_oldest(window, preints, win_cfg)
    return (window, *_shift_segments(preints, fv))


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class Sequencer:
    """Host orchestrator of the geometric LiDAR-inertial slice.
    Deterministic: the same inputs in the same order give the same
    trajectory (up to f32 summation order in the map's scatter-adds).

    ``device`` defaults to the first CUDA device and raises where there is
    none; ``device="cpu"`` runs the plain versions on the CPU."""

    def __init__(self, seq_cfg: SequencerConfig | None = None,
                 win_cfg: win.WindowConfig = win.WindowConfig(),
                 map_cfg: vh.VoxelMapConfig = vh.VoxelMapConfig(),
                 geo_cfg: geo.GeometricConfig = geo.GeometricConfig(),
                 *, device=None, dtype=torch.float32):
        seq_cfg = seq_cfg or SequencerConfig(quantize_transfer=False)
        for name, need in _PORTED_ONLY.items():
            if getattr(seq_cfg, name) != need:
                raise NotImplementedError(
                    f"SequencerConfig.{name}={getattr(seq_cfg, name)!r} is "
                    f"not ported yet (the port supports {name}={need!r})")
        self.cfg = seq_cfg
        self.win_cfg = win_cfg
        self.map_cfg = map_cfg
        self.geo_cfg = geo_cfg
        self.device = require_cuda() if device is None \
            else torch.device(device)
        self.dtype = dtype
        f = dict(dtype=dtype, device=self.device)

        self.imu = ImuBuffer(max_duration=seq_cfg.imu_max_buffer_duration,
                             acc_scale=seq_cfg.imu_acc_scale)
        self.window = win.create(win_cfg, self.device, dtype)
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
        self.timers = StageTimer()
        self._step_kw = dict(seq_cfg=seq_cfg, win_cfg=win_cfg,
                             map_cfg=map_cfg, geo_cfg=geo_cfg)

    def _put(self, arr, dtype=None):
        """Host numpy -> device tensor. On the card the copy goes through
        pinned memory and does not wait for the stream."""
        t = torch.tensor(np.asarray(arr), dtype=dtype or self.dtype)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

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

    def debug_records(self):
        """Per-scan debug records [n_scans, 17]: num_inlier, 4 status
        counts, mean |r|, 3+3 degeneracy flags, photometric and rescue
        slots (zero in this slice)."""
        return self.debug_rec[: self.scan_idx, :17].cpu().numpy()

    def write_tum(self, path):
        """TUM trajectory log: ts x y z qx qy qz qw."""
        with open(path, "w") as f:
            for ts, p, q in self.trajectory:
                f.write(f"{ts:.9f} {p[0]} {p[1]} {p[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")

    def _ensure_log_capacity(self):
        """Double the device trajectory / debug rings when full."""
        S = self.traj_q.shape[0]
        if max(self.scan_idx, len(self._traj_ts)) < S - 1:
            return
        self.traj_q, self.traj_p, self.debug_rec = (
            torch.cat([a, torch.zeros_like(a)])
            for a in (self.traj_q, self.traj_p, self.debug_rec))
        logger.info("trajectory/debug log capacity grown to %d rows", 2 * S)

    # ------------------------------------------------------------------ IMU
    def add_imu(self, ts, acc, gyro):
        self.imu.add(float(ts), acc, gyro)

    def add_imu_batch(self, ts, acc, gyro):
        """Bulk time-ordered IMU insert (one vectorized pass)."""
        self.imu.add_batch(ts, acc, gyro)

    # ----------------------------------------------------------------- scan
    def stage_scan(self, ts_header, points, t_rel, valid=None):
        """Pad a scan to ``max_scan_points`` lanes of f32 (x, y, z, t_rel)
        and start its transfer to the device. Returns the handle for
        ``add_scan(ts_header, staged=handle)``."""
        points = np.asarray(points)
        t_rel = np.asarray(t_rel)
        with self.timers.stage("t_prepare"):
            if valid is None:
                valid = np.isfinite(points).all(-1)
            valid = np.asarray(valid, bool)
            t_end = float(ts_header
                          + (t_rel[valid].max() if valid.any() else 0.0))
            raw = (points, t_rel, valid)  # full density for the map seed
            k = self.cfg.point_skip
            if k > 1:
                points, t_rel, valid = points[::k], t_rel[::k], valid[::k]
            pts, tp, vd = _pad_scan(points, t_rel, valid,
                                    self.cfg.max_scan_points)
            scan = np.concatenate([pts, np.where(vd, tp, 0.0)[:, None]], 1)
            return dict(ts_header=float(ts_header), t_end=t_end,
                        scan_dev=self._put(scan),
                        valid_dev=self._put(vd, torch.bool), raw=raw)

    def add_scan(self, ts_header, points=None, t_rel=None, valid=None,
                 staged=None):
        """points [N,3] in the lidar frame; t_rel [N] per-point time offsets
        from ts_header [s]. Pass ``staged`` (from :meth:`stage_scan`)
        instead of raw arrays to consume a scan staged ahead of time."""
        self.counters["scans"] += 1
        self._ensure_log_capacity()
        if staged is None:
            staged = self.stage_scan(ts_header, points, t_rel, valid)
        ts_header = staged["ts_header"]
        t_end = staged["t_end"]

        if not self.initialized:
            self._try_initialize(ts_header, t_end, *staged["raw"])
            return
        if t_end <= self.last_state_ts:
            # out-of-order insertion is not ported yet
            self.counters["scans_dropped_ooo"] += 1
            logger.warning("scan at %.4f is older than the newest state "
                           "%.4f — dropped", t_end, self.last_state_ts)
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
        if not same_key:
            self._enforce_lag(t_end)
            if self.n_active == self.win_cfg.K:
                self._marginalize_host()
        if same_key:
            imu_pack[m, :6] = [self.n_active - 1, t_end - base,
                               len(self._traj_ts) - 1, self.scan_idx,
                               ts_header - base, self.n_active - 1]
        else:
            imu_pack[m, :6] = [self.n_active, t_end - base,
                               len(self._traj_ts), self.scan_idx,
                               ts_header - base, 0]

        (self.window, self.vmap, self.preints, self.fv, self.kf_q, self.kf_p,
         self.kf_count, self.traj_q, self.traj_p, self.debug_rec) = _scan_step(
            self.window, self.vmap, self.preints, self.fv,
            staged["scan_dev"], staged["valid_dev"], self._put(imu_pack),
            self.kf_q, self.kf_p, self.kf_count, self.traj_q, self.traj_p,
            self.debug_rec, self.q_bl, self.t_bl, append=not same_key,
            **self._step_kw)
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
        self.window, self.preints, self.fv = _marginalize(
            self.window, self.preints, self.fv, win_cfg=self.win_cfg)
        self.n_active -= 1
        if self.state_ts:
            self.state_ts.pop(0)

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
            seq_cfg=self.cfg, win_cfg=self.win_cfg, map_cfg=self.map_cfg)
        self.kf_count = torch.ones((), dtype=torch.int32, device=self.device)
        self.n_active = 1
        self.initialized = True
        self.last_state_ts = t_end
        self.state_ts = [t_end]
        self._traj_ts.append(t_end)
        self._traj_src.append(-1)
        logger.info("initialized at ts=%.4f q=%s", t_end, att["q_w_b"])
