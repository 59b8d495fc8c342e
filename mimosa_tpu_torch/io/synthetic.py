"""Synthetic LiDAR+IMU dataset generator for end-to-end replays.

Port of ``mimosa_tpu/io/synthetic.py`` (the room and corridor worlds, the
analytic trajectory, the spinning-LiDAR raycast, the IMU stream, and the
radar Doppler frames and odometry poses of the multi-sensor sequences,
and the staggered Ouster layout of ``generate_ouster``) in numpy f64.
The JAX package differentiates the trajectory with ``jax.jacfwd``; here the
derivatives of the sine-of-smoothstep trajectory are written in closed
form, including the JAX convention at the clip's corners (a derivative of
1/2 where the clipped value sits exactly on a bound).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Rect:
    """Finite rectangle: origin o, edges e1, e2 (not necessarily unit)."""

    o: np.ndarray
    e1: np.ndarray
    e2: np.ndarray

    @property
    def normal(self):
        n = np.cross(self.e1, self.e2)
        return n / np.linalg.norm(n)


def room_world(lx=16.0, ly=8.0, lz=4.0):
    """A room with two interior partial walls — fully 6-dof observable."""
    def r(o, e1, e2):
        return Rect(np.asarray(o, float), np.asarray(e1, float),
                    np.asarray(e2, float))
    return [
        r([0, 0, 0], [lx, 0, 0], [0, ly, 0]),          # floor
        r([0, 0, lz], [lx, 0, 0], [0, ly, 0]),         # ceiling
        r([0, 0, 0], [lx, 0, 0], [0, 0, lz]),          # wall y=0
        r([0, ly, 0], [lx, 0, 0], [0, 0, lz]),         # wall y=ly
        r([0, 0, 0], [0, ly, 0], [0, 0, lz]),          # wall x=0
        r([lx, 0, 0], [0, ly, 0], [0, 0, lz]),         # wall x=lx
        r([lx * 0.4, 0, 0], [0, ly * 0.55, 0], [0, 0, lz * 0.8]),  # partition
        r([lx * 0.7, ly, 0], [0, -ly * 0.5, 0], [0, 0, lz * 0.7]),  # partition
    ]


def corridor_world(length=80.0, w=4.0, h=3.0):
    """An 'infinite' corridor (no end caps within lidar range): translation
    along x is geometrically unobservable from its planes."""
    def r(o, e1, e2):
        return Rect(np.asarray(o, float), np.asarray(e1, float),
                    np.asarray(e2, float))
    return [
        r([0, 0, 0], [length, 0, 0], [0, w, 0]),       # floor
        r([0, 0, h], [length, 0, 0], [0, w, 0]),       # ceiling
        r([0, 0, 0], [length, 0, 0], [0, 0, h]),       # wall y=0
        r([0, w, 0], [length, 0, 0], [0, 0, h]),       # wall y=w
    ]


def raycast(world, origins, dirs, max_range=60.0):
    """Vectorized ray-rectangle intersection. origins/dirs [N,3] -> ranges
    [N] (inf where no hit)."""
    n = origins.shape[0]
    best = np.full(n, np.inf)
    for rect in world:
        nrm = rect.normal
        denom = dirs @ nrm
        with np.errstate(divide="ignore", invalid="ignore"):
            # rays parallel to the plane give inf/NaN; the mask drops them
            t = ((rect.o - origins) @ nrm) / denom
            hit = origins + t[:, None] * dirs
            rel = hit - rect.o
            a = rel @ rect.e1 / (rect.e1 @ rect.e1)
            b = rel @ rect.e2 / (rect.e2 @ rect.e2)
        with np.errstate(invalid="ignore"):
            ok = (np.abs(denom) > 1e-9) & (t > 0.05) & (t < max_range) & \
                 (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        best = np.where(ok & (t < best), t, best)
    return best


@dataclasses.dataclass
class TrajectoryConfig:
    t_total: float = 12.0
    t_stationary: float = 1.2   # initial stillness for attitude init
    amp: tuple = (3.0, 1.6, 0.4)
    freq: tuple = (0.10, 0.16, 0.23)
    yaw_rate: float = 0.35
    center: tuple = (6.0, 4.0, 1.5)


def _exp_so3_np(phi):
    """Axis-angle [n,3] -> quaternion [n,4] (same branches as lie.exp_so3)."""
    theta2 = np.sum(phi * phi, axis=-1, keepdims=True)
    theta = np.sqrt(theta2 + 1e-30)
    small = theta2 < 1e-12
    k = np.where(small, 0.5 - theta2 / 48.0, np.sin(0.5 * theta) / theta)
    w = np.where(small, 1.0 - theta2 / 8.0, np.cos(0.5 * theta))
    return np.concatenate([w, k * phi], axis=-1)


def _quat_to_mat_np(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def make_trajectory(tc: TrajectoryConfig):
    """Vectorized pose / velocity / IMU functions of time t [n] (f64)."""
    amp = np.asarray(tc.amp, float)
    om = 2 * np.pi * np.asarray(tc.freq, float)
    ctr = np.asarray(tc.center, float)
    t0 = tc.t_stationary

    def ramp(t):
        """u(t) = (t - t0) w(s), s = clip((t - t0)/2, 0, 1), w the
        smoothstep s^2 (3 - 2s); returns (u, du/dt, d2u/dt2)."""
        t = np.asarray(t, float)
        x = (t - t0) / 2.0
        s = np.clip(x, 0.0, 1.0)
        ds = 0.5 * np.where((x > 0) & (x < 1), 1.0,
                            np.where((x == 0) | (x == 1), 0.5, 0.0))
        w = s * s * (3.0 - 2.0 * s)
        dw = 6.0 * s * (1.0 - s) * ds
        d2w = 6.0 * (1.0 - 2.0 * s) * ds * ds
        on = t > t0
        dt = t - t0
        return (np.where(on, dt * w, 0.0), np.where(on, w + dt * dw, 0.0),
                np.where(on, 2.0 * dw + dt * d2w, 0.0))

    def pos(t):
        u = ramp(t)[0][..., None]
        return ctr + amp * np.sin(om * u)

    def vel(t):
        u, du, _ = (a[..., None] for a in ramp(t))
        return amp * np.cos(om * u) * om * du

    def acc(t):
        u, du, d2u = (a[..., None] for a in ramp(t))
        return amp * (np.cos(om * u) * om * d2u
                      - np.sin(om * u) * (om * du) ** 2)

    def quat(t):
        yaw = tc.yaw_rate * ramp(t)[0]
        z = np.zeros_like(yaw)
        return _exp_so3_np(np.stack([z, z, yaw], axis=-1))

    def imu(t, g_mag=9.81):
        """(specific force in body, body rates), each [n,3]."""
        Rt = np.swapaxes(_quat_to_mat_np(quat(t)), -1, -2)
        f_w = acc(t) - np.asarray([0.0, 0.0, -g_mag])
        yaw_dot = tc.yaw_rate * ramp(t)[1]
        w_w = np.stack([np.zeros_like(yaw_dot), np.zeros_like(yaw_dot),
                        yaw_dot], axis=-1)
        return (np.einsum("nij,nj->ni", Rt, f_w),
                np.einsum("nij,nj->ni", Rt, w_w))

    return dict(pos=pos, vel=vel, acc=acc, quat=quat, imu=imu)


@dataclasses.dataclass
class LidarModel:
    n_rows: int = 16
    n_cols: int = 256
    fov_up: float = 0.30        # rad
    fov_down: float = -0.45
    period: float = 0.1         # s per scan
    max_range: float = 60.0


def beam_dirs(lm: LidarModel):
    alt = np.linspace(lm.fov_down, lm.fov_up, lm.n_rows)
    az = np.linspace(0, 2 * np.pi, lm.n_cols, endpoint=False)
    A, Z = np.meshgrid(az, alt)  # [rows, cols]
    d = np.stack([np.cos(Z) * np.cos(A), np.cos(Z) * np.sin(A), np.sin(Z)],
                 axis=-1)
    return d.reshape(-1, 3), np.broadcast_to(
        az[None, :], (lm.n_rows, lm.n_cols)).reshape(-1)


def generate(world, tc: TrajectoryConfig, lm: LidarModel, imu_rate=200,
             seed=0, imu_noise=0.0, imu_bias=None, range_noise=0.0):
    """The full event stream: dict with 'imu' (ts, acc, gyro arrays),
    'scans' (list of dicts with ts_header, points [N,3] lidar frame,
    t_rel [N], valid [N], intensity [N]) and 'gt' (ts, pos, quat at scan
    ends)."""
    rng = np.random.default_rng(seed)
    traj = make_trajectory(tc)
    bg, ba = (np.zeros(3), np.zeros(3)) if imu_bias is None else imu_bias

    imu_ts = np.arange(0.0, tc.t_total, 1.0 / imu_rate)
    accs, gyros = traj["imu"](imu_ts)
    accs = accs + ba + rng.normal(size=(len(imu_ts), 3)) * imu_noise
    gyros = gyros + bg + rng.normal(size=(len(imu_ts), 3)) * imu_noise * 0.1

    # column c fires at ts_header + c/cols*period from the pose at that
    # time — real rolling-shutter skew
    dirs, az = beam_dirs(lm)
    col_of_beam = (az / (2 * np.pi) * lm.n_cols).astype(int) % lm.n_cols
    t_rel_beam = col_of_beam / lm.n_cols * lm.period

    scans = []
    gt_ts, gt_p, gt_q = [], [], []
    scan_starts = np.arange(tc.t_stationary - 0.2, tc.t_total - lm.period,
                            lm.period)
    for ts0 in scan_starts:
        col_ts = ts0 + np.arange(lm.n_cols) / lm.n_cols * lm.period
        Rb = _quat_to_mat_np(traj["quat"](col_ts))
        R_beam = Rb[col_of_beam]
        o_beam = traj["pos"](col_ts)[col_of_beam]
        d_world = np.einsum("nij,nj->ni", R_beam, dirs)
        rr = raycast(world, o_beam, d_world, lm.max_range)
        if range_noise:
            rr = rr + rng.normal(size=rr.shape) * range_noise
        valid = np.isfinite(rr)
        pts_lidar = dirs * np.where(valid, rr, 0.0)[:, None]
        # world-anchored intensity texture
        hit_w = o_beam + d_world * np.where(valid, rr, 0.0)[:, None]
        inten = np.where(valid, 120.0 + 60.0 * np.sin(1.3 * hit_w[:, 0])
                         * np.cos(0.9 * hit_w[:, 1])
                         + 40.0 * np.sin(1.7 * hit_w[:, 2]), 0.0)
        scans.append(dict(ts_header=ts0, points=pts_lidar.astype(np.float32),
                          t_rel=t_rel_beam.copy(), valid=valid,
                          intensity=np.clip(inten, 0, 255).astype(
                              np.float32)))
        t_end = np.asarray([ts0 + t_rel_beam.max()])
        gt_ts.append(t_end[0])
        gt_p.append(traj["pos"](t_end)[0])
        gt_q.append(traj["quat"](t_end)[0])

    return dict(
        imu=dict(ts=imu_ts, acc=accs, gyro=gyros),
        scans=scans,
        gt=dict(ts=np.asarray(gt_ts), pos=np.asarray(gt_p),
                quat=np.asarray(gt_q)),
    )


def generate_ouster(world, tc: TrajectoryConfig, beam_altitudes,
                    pixel_shift_by_row, n_cols=256, period=0.1,
                    max_range=60.0, imu_rate=200, seed=0,
                    imu_noise=0.0, range_noise=0.0, tex_amp=110.0,
                    beam_azimuths=None, beam_offset_m=0.0):
    """Staggered Ouster-format scans: points in sensor pixel-id order
    (row-major, staggered column fastest), measurement block c fired at
    ts_header + c/cols*period, with per-row destagger shifts: the raw
    layout that the exact Ouster model's pixel-id fill and yaw table take
    (``PhotometricConfig.exact_ouster``). Row v of block c samples the
    azimuth of destaggered column (c + shift[v]) % cols, or the exact
    per-beam azimuth offset where ``beam_azimuths`` (radians, one a row) is
    given; a nonzero ``beam_offset_m`` gives the affine Ouster driver model
    p = s*dir + n*enc (the beams fire from a ring of radius n around the
    encoder axis), which ``config.loader.ouster_ray_dirs`` inverts for the
    range codec. Returns what :func:`generate` returns plus each scan's
    ``ring``; the points are the returns at firing time (motion-skewed) in
    the encoder's (lidar) frame, which :func:`ouster_sensor_frame` turns
    into the Ouster sensor frame. The JAX package's generator, draw for
    draw."""
    rng = np.random.default_rng(seed)
    traj = make_trajectory(tc)
    rows = len(beam_altitudes)
    alt = np.asarray(beam_altitudes)
    shifts = np.asarray(pixel_shift_by_row, int)

    imu_ts = np.arange(0.0, tc.t_total, 1.0 / imu_rate)
    accs, gyros = traj["imu"](imu_ts)
    accs = accs + rng.normal(size=(len(imu_ts), 3)) * imu_noise
    gyros = gyros + rng.normal(size=(len(imu_ts), 3)) * imu_noise * 0.1

    v, c = np.meshgrid(np.arange(rows), np.arange(n_cols), indexing="ij")
    # the encoder angle, the Ouster driver's convention 2*pi*(1 - c/N), as
    # config.loader.ouster_ray_dirs has it
    az_enc = 2.0 * np.pi * (1.0 - c / n_cols)
    if beam_azimuths is not None:
        az_s = az_enc - np.asarray(beam_azimuths)[:, None] \
            * np.ones_like(az_enc)
    else:
        u_dest = (c + shifts[:, None]) % n_cols
        az_s = 2.0 * np.pi * (1.0 - u_dest / n_cols)  # shift-quantized
    t_rel = (c / n_cols * period).reshape(-1)
    ca, sa = np.cos(az_s), np.sin(az_s)
    cal = np.cos(alt)[:, None] * np.ones_like(ca)
    sal = np.sin(alt)[:, None] * np.ones_like(ca)
    dirs = np.stack([cal * ca, cal * sa, sal], -1).reshape(-1, 3)
    # each beam fires from n * enc in the lidar frame, and the driver
    # reports p = s*dir + n*enc with s the range from the beam's origin
    beam_orig = beam_offset_m * np.stack(
        [np.cos(az_enc), np.sin(az_enc), np.zeros_like(az_enc)],
        -1).reshape(-1, 3) if beam_offset_m else None
    ring = v.reshape(-1).astype(np.uint16)
    block = c.reshape(-1)

    scans, gt_ts, gt_p, gt_q = [], [], [], []
    scan_starts = np.arange(tc.t_stationary - 0.2, tc.t_total - period,
                            period)
    for ts0 in scan_starts:
        col_ts = ts0 + np.arange(n_cols) / n_cols * period
        Rb = _quat_to_mat_np(traj["quat"](col_ts))[block]
        o = traj["pos"](col_ts)[block]
        if beam_orig is not None:
            o = o + np.einsum("nij,nj->ni", Rb, beam_orig)
        d_world = np.einsum("nij,nj->ni", Rb, dirs)
        rr = raycast(world, o, d_world, max_range)
        if range_noise:
            rr = rr + rng.normal(size=rr.shape) * range_noise
        valid = np.isfinite(rr)
        pts = dirs * np.where(valid, rr, 0.0)[:, None]
        if beam_orig is not None:
            pts = np.where(valid[:, None], pts + beam_orig, 0.0)
        hit_w = o + d_world * np.where(valid, rr, 0.0)[:, None]
        inten = np.where(
            valid,
            130.0 + tex_amp * np.sin(1.3 * hit_w[:, 0])
            * np.cos(0.9 * hit_w[:, 1])
            + 0.6 * tex_amp * np.sin(1.7 * hit_w[:, 2]), 0.0)
        scans.append(dict(ts_header=ts0, points=pts.astype(np.float32),
                          t_rel=t_rel.copy(), valid=valid, ring=ring,
                          intensity=np.clip(inten, 0, 255).astype(
                              np.float32)))
        t_end = np.asarray([ts0 + t_rel.max()])
        gt_ts.append(t_end[0])
        gt_p.append(traj["pos"](t_end)[0])
        gt_q.append(traj["quat"](t_end)[0])
    return dict(imu=dict(ts=imu_ts, acc=accs, gyro=gyros), scans=scans,
                gt=dict(ts=np.asarray(gt_ts), pos=np.asarray(gt_p),
                        quat=np.asarray(gt_q)))


# the rotation of the Ouster driver's lidar_to_sensor_transform (wxyz): its
# sensor frame is the lidar frame turned 180 degrees about z
OUSTER_Q_SENSOR_LIDAR = (0.0, 0.0, 0.0, 1.0)


def ouster_sensor_frame(data):
    """:func:`generate_ouster`'s stream with each scan's points in the
    Ouster sensor frame, the frame a driver publishes and the exact
    photometric model's column convention (azimuth +pi at column 0)
    assumes: the lidar frame turned 180 degrees about z (the rotation of
    the driver's lidar_to_sensor_transform; its z offset left out). Lane
    order, times and validity are unchanged. Returns (data, q_b_l): a
    Sequencer with ``SequencerConfig(q_b_l=q_b_l)`` maps the points back
    onto the body frame that the generator's trajectory moves."""
    flip = np.asarray([-1.0, -1.0, 1.0], np.float32)
    scans = [dict(sc, points=sc["points"] * flip) for sc in data["scans"]]
    return dict(data, scans=scans), OUSTER_Q_SENSOR_LIDAR


def _quat_mul_np(a, b):
    """Hamilton product of wxyz quaternions [..., 4]."""
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def radar_residuals_np(q_wb, v_w, bg, omega_b, dirs_r, doppler, q_b_r,
                       t_b_r):
    """``radar.factor.residuals`` in numpy f64 for one state: e [N] =
    -(d . v_R) - doppler with v_R = R_BR^T (R_WB^T v_W + (omega - bg) x
    t_BR)."""
    v_b = _quat_to_mat_np(np.asarray(q_wb, float)).T @ v_w
    v_lever = np.cross(omega_b - bg, np.asarray(t_b_r, float))
    v_r = _quat_to_mat_np(np.asarray(q_b_r, float)).T @ (v_b + v_lever)
    return -(dirs_r @ v_r) - doppler


def generate_radar(traj, tc: TrajectoryConfig, rate=20.0, n_targets=96,
                   seed=0, noise=0.02, q_b_r=(1.0, 0, 0, 0),
                   t_b_r=(0.0, 0, 0)):
    """Radar Doppler frames from the analytic trajectory (static world):
    random bearings in the radar frame (forward half space), radial speed
    -(d . v_R) plus noise, ranges uniform in [2, 30] m, SNR 20 dB. The
    JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed + 100)
    ts = np.arange(tc.t_stationary * 0.5, tc.t_total, 1.0 / rate)
    qs, vs, ws = traj["quat"](ts), traj["vel"](ts), traj["imu"](ts)[1]
    frames = []
    for k, t in enumerate(ts):
        dirs = rng.normal(size=(n_targets, 3))
        dirs[:, 0] = np.abs(dirs[:, 0]) + 0.5
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dop = radar_residuals_np(qs[k], vs[k], np.zeros(3), ws[k], dirs,
                                 np.zeros(n_targets), q_b_r, t_b_r)
        dop = dop + rng.normal(size=n_targets) * noise
        ranges = rng.uniform(2.0, 30.0, size=n_targets)
        frames.append(dict(ts=float(t), points=dirs * ranges[:, None],
                           doppler=dop, snr_db=np.full(n_targets, 20.0)))
    return frames


def generate_odometry(traj, tc: TrajectoryConfig, rate=10.0, seed=0,
                      noise_rot=0.002, noise_trans=0.005):
    """External odometry poses (identity extrinsics, covariance 1e-4 I)
    with per-message rotation and translation noise. The JAX package's
    generator, draw for draw."""
    rng = np.random.default_rng(seed + 200)
    ts = np.arange(tc.t_stationary * 0.5, tc.t_total, 1.0 / rate)
    qs, ps = traj["quat"](ts), traj["pos"](ts)
    msgs = []
    for k, t in enumerate(ts):
        dq = _exp_so3_np(rng.normal(size=3) * noise_rot)
        msgs.append(dict(ts=float(t), q=_quat_mul_np(qs[k], dq),
                         t=ps[k] + rng.normal(size=3) * noise_trans,
                         cov=np.eye(6) * 1e-4))
    return msgs


def ate_rmse(est_ts, est_p, gt_ts, gt_p, align=True):
    """APE translation RMSE after optional SE(3) (Umeyama, no scale)
    alignment."""
    gt_interp = np.stack([np.interp(est_ts, gt_ts, gt_p[:, i])
                          for i in range(3)], axis=-1)
    est = np.asarray(est_p)
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt_interp.mean(0)
        E, G = est - mu_e, gt_interp - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        R = (U @ S @ Vt).T
        est = (R @ E.T).T + mu_g
        gt_interp = G + mu_g
    err = np.linalg.norm(est - gt_interp, axis=-1)
    return float(np.sqrt((err ** 2).mean()))
