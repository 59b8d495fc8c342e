"""The benchmark's frozen sensor generator: a torch copy of the port's
``io/synthetic.py`` (``room_world``, ``make_trajectory``, ``beam_dirs``,
``generate``, ``generate_radar``, ``generate_odometry``) and of
``io/synthetic_replay.py::multimodal_events``.

The arithmetic is the original's in float64, run on any torch device: the
scans are raycast on the card in batches, and only their host copies
(what a sensor driver hands over) leave it. Every random draw is numpy's
``default_rng`` in the original's order, so a seed gives the original's
stream; ``tests/test_bench_synth.py`` holds the copy to the original.
This file is frozen with the benchmark: the original may change, the
copy may not. It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64


# ---------------------------------------------------------------- worlds
@dataclasses.dataclass
class World:
    """Finite rectangles: origins o, edges e1, e2, each [R, 3]."""

    o: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor

    def to(self, device):
        return World(*(t.to(device) for t in (self.o, self.e1, self.e2)))


def room_world(lx=16.0, ly=8.0, lz=4.0):
    """A room with two interior partial walls (fully 6-dof observable)."""
    rects = [
        ([0, 0, 0], [lx, 0, 0], [0, ly, 0]),          # floor
        ([0, 0, lz], [lx, 0, 0], [0, ly, 0]),         # ceiling
        ([0, 0, 0], [lx, 0, 0], [0, 0, lz]),          # wall y=0
        ([0, ly, 0], [lx, 0, 0], [0, 0, lz]),         # wall y=ly
        ([0, 0, 0], [0, ly, 0], [0, 0, lz]),          # wall x=0
        ([lx, 0, 0], [0, ly, 0], [0, 0, lz]),         # wall x=lx
        ([lx * 0.4, 0, 0], [0, ly * 0.55, 0], [0, 0, lz * 0.8]),  # partition
        ([lx * 0.7, ly, 0], [0, -ly * 0.5, 0], [0, 0, lz * 0.7]),  # partition
    ]
    o, e1, e2 = (torch.tensor([r[i] for r in rects], dtype=F64)
                 for i in range(3))
    return World(o, e1, e2)


def raycast(world, origins, dirs, max_range=60.0):
    """Ray-rectangle intersection. origins/dirs [..., 3] -> ranges [...]
    (inf where no hit), rectangle by rectangle as the original."""
    best = torch.full(origins.shape[:-1], math.inf, dtype=origins.dtype,
                      device=origins.device)
    for r in range(world.o.shape[0]):
        o, e1, e2 = world.o[r], world.e1[r], world.e2[r]
        n = torch.linalg.cross(e1, e2)
        nrm = n / torch.linalg.vector_norm(n)
        denom = dirs @ nrm
        # rays parallel to the plane give inf/NaN; the mask drops them
        t = ((o - origins) @ nrm) / denom
        hit = origins + t[..., None] * dirs
        rel = hit - o
        a = rel @ e1 / (e1 @ e1)
        b = rel @ e2 / (e2 @ e2)
        ok = ((denom.abs() > 1e-9) & (t > 0.05) & (t < max_range)
              & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
        best = torch.where(ok & (t < best), t, best)
    return best


# ------------------------------------------------------------ trajectory
@dataclasses.dataclass
class TrajectoryConfig:
    t_total: float = 12.0
    t_stationary: float = 1.2   # initial stillness for attitude init
    amp: tuple = (3.0, 1.6, 0.4)
    freq: tuple = (0.10, 0.16, 0.23)
    yaw_rate: float = 0.35
    center: tuple = (6.0, 4.0, 1.5)


def exp_so3(phi):
    """Axis-angle [..., 3] -> quaternion wxyz [..., 4]."""
    theta2 = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w, k * phi], -1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_mul(a, b):
    """Hamilton product of wxyz quaternions [..., 4]."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def make_trajectory(tc: TrajectoryConfig):
    """Pose / velocity / IMU functions of time t [n] (float64 tensors, on
    t's device); the original's closed-form derivatives."""
    t0 = tc.t_stationary

    def consts(t):
        f = dict(dtype=F64, device=t.device)
        return (torch.tensor(tc.amp, **f),
                2 * math.pi * torch.tensor(tc.freq, **f),
                torch.tensor(tc.center, **f))

    def ramp(t):
        """u(t) = (t - t0) w(s), s = clip((t - t0)/2, 0, 1), w the
        smoothstep s^2 (3 - 2s); returns (u, du/dt, d2u/dt2)."""
        x = (t - t0) / 2.0
        s = x.clamp(0.0, 1.0)
        one = torch.ones_like(x)
        ds = 0.5 * torch.where((x > 0) & (x < 1), one,
                               torch.where((x == 0) | (x == 1), 0.5 * one,
                                           0.0 * one))
        w = s * s * (3.0 - 2.0 * s)
        dw = 6.0 * s * (1.0 - s) * ds
        d2w = 6.0 * (1.0 - 2.0 * s) * ds * ds
        on = t > t0
        dt = t - t0
        z = torch.zeros_like(t)
        return (torch.where(on, dt * w, z), torch.where(on, w + dt * dw, z),
                torch.where(on, 2.0 * dw + dt * d2w, z))

    def pos(t):
        amp, om, ctr = consts(t)
        u = ramp(t)[0][..., None]
        return ctr + amp * torch.sin(om * u)

    def vel(t):
        amp, om, _ = consts(t)
        u, du, _ = (a[..., None] for a in ramp(t))
        return amp * torch.cos(om * u) * om * du

    def acc(t):
        amp, om, _ = consts(t)
        u, du, d2u = (a[..., None] for a in ramp(t))
        return amp * (torch.cos(om * u) * om * d2u
                      - torch.sin(om * u) * (om * du) ** 2)

    def quat(t):
        yaw = tc.yaw_rate * ramp(t)[0]
        z = torch.zeros_like(yaw)
        return exp_so3(torch.stack([z, z, yaw], -1))

    def imu(t, g_mag=9.81):
        """(specific force in body, body rates), each [n, 3]."""
        Rt = quat_to_mat(quat(t)).transpose(-1, -2)
        g = torch.tensor([0.0, 0.0, -g_mag], dtype=F64, device=t.device)
        f_w = acc(t) - g
        yaw_dot = tc.yaw_rate * ramp(t)[1]
        z = torch.zeros_like(yaw_dot)
        w_w = torch.stack([z, z, yaw_dot], -1)
        return (torch.einsum("nij,nj->ni", Rt, f_w),
                torch.einsum("nij,nj->ni", Rt, w_w))

    return dict(pos=pos, vel=vel, acc=acc, quat=quat, imu=imu)


# ---------------------------------------------------------------- LiDAR
@dataclasses.dataclass
class LidarModel:
    n_rows: int = 16
    n_cols: int = 256
    fov_up: float = 0.30        # rad
    fov_down: float = -0.45
    period: float = 0.1         # s per scan
    max_range: float = 60.0


def beam_dirs(lm: LidarModel):
    """(unit beam directions [N, 3], azimuth [N]) in numpy float64, row
    major, as the original."""
    alt = np.linspace(lm.fov_down, lm.fov_up, lm.n_rows)
    az = np.linspace(0, 2 * np.pi, lm.n_cols, endpoint=False)
    A, Z = np.meshgrid(az, alt)
    d = np.stack([np.cos(Z) * np.cos(A), np.cos(Z) * np.sin(A), np.sin(Z)],
                 axis=-1)
    return d.reshape(-1, 3), np.broadcast_to(
        az[None, :], (lm.n_rows, lm.n_cols)).reshape(-1)


def arange_count(start, stop, step):
    """len(np.arange(start, stop, step))."""
    return max(0, math.ceil((stop - start) / step))


def arange_at(start, step, k):
    """Values ``k`` (ints, any of them past ``stop``) of ``np.arange(start,
    stop, step)``: numpy fills ``start + k * ((start + step) - start)``
    from the third value on."""
    k = np.asarray(k)
    out = start + k * ((start + step) - start)
    return np.where(k == 1, start + step, out)


class ScanMaker:
    """Raycasts scans of one LiDAR on one device: scan k starts at
    ``t_stationary - 0.2 + k * period`` (the original's ``np.arange``
    values), column c fires at its start + c/cols * period from the pose
    at that time."""

    def __init__(self, world, tc, lm, device):
        self.world, self.tc, self.lm = world.to(device), tc, lm
        self.device = device
        self.traj = make_trajectory(tc)
        dirs, az = beam_dirs(lm)
        col = (az / (2 * np.pi) * lm.n_cols).astype(int) % lm.n_cols
        self.t_rel = col / lm.n_cols * lm.period            # [N] f64, host
        self.t_rel.setflags(write=False)
        self.dirs = torch.from_numpy(dirs).to(device)
        self.col = torch.from_numpy(col).to(device)
        self.col_frac = torch.from_numpy(
            np.arange(lm.n_cols) / lm.n_cols * lm.period).to(device)
        self.start = tc.t_stationary - 0.2

    def ts0(self, k):
        return float(arange_at(self.start, self.lm.period, k))

    def t_end(self, k):
        """End time of scan k (its latest lane; every lane is valid in
        time, so the latest column's)."""
        return self.ts0(k) + float(self.t_rel.max())

    def make(self, ks, noise):
        """Scans ``ks`` with range noise rows ``noise`` ([len(ks), N] host
        float64 or None) -> (points f32 [B,N,3], valid [B,N], intensity f32
        [B,N], gt pos [B,3], gt quat [B,4]) as device tensors."""
        dev, lm = self.device, self.lm
        ts0 = torch.tensor([self.ts0(k) for k in ks], dtype=F64, device=dev)
        col_ts = ts0[:, None] + self.col_frac[None, :]          # [B, cols]
        Rb = quat_to_mat(self.traj["quat"](col_ts.reshape(-1))).reshape(
            len(ks), lm.n_cols, 3, 3)
        pb = self.traj["pos"](col_ts.reshape(-1)).reshape(len(ks), lm.n_cols,
                                                          3)
        R_beam = Rb[:, self.col]                                 # [B,N,3,3]
        o_beam = pb[:, self.col]
        d_world = torch.einsum("bnij,nj->bni", R_beam, self.dirs)
        rr = raycast(self.world, o_beam, d_world, lm.max_range)
        if noise is not None:
            rr = rr + torch.from_numpy(noise).to(dev)
        valid = torch.isfinite(rr)
        r0 = torch.where(valid, rr, torch.zeros_like(rr))
        pts = (self.dirs * r0[..., None]).to(torch.float32)
        hit_w = o_beam + d_world * r0[..., None]
        inten = torch.where(
            valid, 120.0 + 60.0 * torch.sin(1.3 * hit_w[..., 0])
            * torch.cos(0.9 * hit_w[..., 1])
            + 40.0 * torch.sin(1.7 * hit_w[..., 2]), torch.zeros_like(rr))
        inten = inten.clamp(0, 255).to(torch.float32)
        t_end = ts0 + float(self.t_rel.max())
        return (pts, valid, inten, self.traj["pos"](t_end),
                self.traj["quat"](t_end))


def imu_block(traj, rate, i0, i1, rng, imu_noise, imu_bias=None):
    """IMU samples i0..i1-1 (sample i at i / rate, the original's
    ``np.arange(0, t_total, 1 / rate)``) with the original's noise draws
    from ``rng``: (ts, acc, gyro) host float64."""
    ts = arange_at(0.0, 1.0 / rate, np.arange(i0, i1))
    acc, gyro = (a.cpu().numpy() for a in
                 traj["imu"](torch.from_numpy(ts)))
    bg, ba = (np.zeros(3), np.zeros(3)) if imu_bias is None else imu_bias
    acc = acc + ba + rng.normal(size=(len(ts), 3)) * imu_noise
    gyro = gyro + bg + rng.normal(size=(len(ts), 3)) * imu_noise * 0.1
    return ts, acc, gyro


def generate(world, tc: TrajectoryConfig, lm: LidarModel, imu_rate=200,
             seed=0, imu_noise=0.0, imu_bias=None, range_noise=0.0,
             device="cpu", batch=8):
    """The original ``generate``'s stream: 'imu' (ts, acc, gyro), 'scans'
    (ts_header, points [N,3] lidar frame, t_rel [N], valid [N], intensity
    [N]) and 'gt' (ts, pos, quat at scan ends), all host numpy."""
    rng = np.random.default_rng(seed)
    traj = make_trajectory(tc)
    n_imu = arange_count(0.0, tc.t_total, 1.0 / imu_rate)
    ts, acc, gyro = imu_block(traj, imu_rate, 0, n_imu, rng, imu_noise,
                              imu_bias)
    mk = ScanMaker(world, tc, lm, torch.device(device))
    n = arange_count(mk.start, tc.t_total - lm.period, lm.period)
    N = lm.n_rows * lm.n_cols
    scans, gp, gq = [], [], []
    for k0 in range(0, n, batch):
        ks = list(range(k0, min(n, k0 + batch)))
        noise = (rng.normal(size=(len(ks), N)) * range_noise
                 if range_noise else None)
        pts, valid, inten, p, q = (a.cpu().numpy()
                                   for a in mk.make(ks, noise))
        for j, k in enumerate(ks):
            scans.append(dict(ts_header=mk.ts0(k), points=pts[j],
                              t_rel=mk.t_rel.copy(), valid=valid[j],
                              intensity=inten[j]))
        gp.append(p)
        gq.append(q)
    return dict(imu=dict(ts=ts, acc=acc, gyro=gyro), scans=scans,
                gt=dict(ts=np.asarray([mk.t_end(k) for k in range(n)]),
                        pos=np.concatenate(gp), quat=np.concatenate(gq)))


# ---------------------------------------------------- radar and odometry
def radar_doppler(q_wb, v_w, bg, omega_b, dirs_r, q_b_r, t_b_r):
    """Radial speeds -(d . v_R) of targets ``dirs_r`` [N,3] for one state,
    v_R = R_BR^T (R_WB^T v_W + (omega - bg) x t_BR); float64."""
    v_b = quat_to_mat(q_wb).T @ v_w
    v_lever = torch.linalg.cross(omega_b - bg, t_b_r)
    v_r = quat_to_mat(q_b_r).T @ (v_b + v_lever)
    return -(dirs_r @ v_r)


def radar_frames(traj, rate, k0, k1, start, rng, n_targets, noise,
                 q_b_r=(1.0, 0, 0, 0), t_b_r=(0.0, 0, 0)):
    """Frames k0..k1-1 (frame k at ``start + k / rate``): random bearings
    in the radar frame's forward half space, radial speed plus noise,
    ranges uniform in [2, 30] m, SNR 20 dB; the original's draws."""
    ts = arange_at(start, 1.0 / rate, np.arange(k0, k1))
    tt = torch.from_numpy(ts)
    qs, vs, ws = traj["quat"](tt), traj["vel"](tt), traj["imu"](tt)[1]
    qbr = torch.tensor(q_b_r, dtype=F64)
    tbr = torch.tensor(t_b_r, dtype=F64)
    frames = []
    for k, t in enumerate(ts):
        dirs = rng.normal(size=(n_targets, 3))
        dirs[:, 0] = np.abs(dirs[:, 0]) + 0.5
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dop = radar_doppler(qs[k], vs[k], torch.zeros(3, dtype=F64), ws[k],
                            torch.from_numpy(dirs), qbr, tbr).numpy()
        dop = dop + rng.normal(size=n_targets) * noise
        ranges = rng.uniform(2.0, 30.0, size=n_targets)
        frames.append(dict(ts=float(t), points=dirs * ranges[:, None],
                           doppler=dop, snr_db=np.full(n_targets, 20.0)))
    return frames


def generate_radar(traj, tc: TrajectoryConfig, rate=20.0, n_targets=96,
                   seed=0, noise=0.02, q_b_r=(1.0, 0, 0, 0),
                   t_b_r=(0.0, 0, 0)):
    """The original ``generate_radar``: frames from t_stationary / 2 to
    t_total at ``rate``, draws from seed + 100."""
    start = tc.t_stationary * 0.5
    n = arange_count(start, tc.t_total, 1.0 / rate)
    return radar_frames(traj, rate, 0, n, start,
                        np.random.default_rng(seed + 100), n_targets, noise,
                        q_b_r, t_b_r)


def odometry_msgs(traj, rate, k0, k1, start, rng, noise_rot, noise_trans,
                  cov):
    """Messages k0..k1-1 (message k at ``start + k / rate``): the true pose
    with rotation and translation noise; the original's draws."""
    ts = arange_at(start, 1.0 / rate, np.arange(k0, k1))
    tt = torch.from_numpy(ts)
    qs, ps = traj["quat"](tt), traj["pos"](tt)
    msgs = []
    for k, t in enumerate(ts):
        dq = exp_so3(torch.from_numpy(rng.normal(size=3) * noise_rot))
        msgs.append(dict(ts=float(t), q=quat_mul(qs[k], dq).numpy(),
                         t=ps[k].numpy() + rng.normal(size=3) * noise_trans,
                         cov=np.eye(6) * cov))
    return msgs


def generate_odometry(traj, tc: TrajectoryConfig, rate=10.0, seed=0,
                      noise_rot=0.002, noise_trans=0.005):
    """The original ``generate_odometry``: identity extrinsics, covariance
    1e-4 I, draws from seed + 200."""
    start = tc.t_stationary * 0.5
    n = arange_count(start, tc.t_total, 1.0 / rate)
    return odometry_msgs(traj, rate, 0, n, start,
                         np.random.default_rng(seed + 200), noise_rot,
                         noise_trans, 1e-4)


# ------------------------------------------------------------ the events
RADAR_DELAY = 0.06       # a late radar frame's delay [s]


def scan_t_end(sc):
    """A scan dict's end time: header + the largest finite point time over
    its valid lanes."""
    t_rel = np.asarray(sc["t_rel"])
    vd = sc.get("valid")
    tv = t_rel if vd is None else t_rel[np.asarray(vd, bool)]
    tm = float(np.max(np.where(np.isfinite(tv), tv, -np.inf))) \
        if tv.size else 0.0
    return float(sc["ts_header"] + (tm if np.isfinite(tm) else 0.0))


def multimodal_events(scans, radar=(), odom=(), *, late_radar=()):
    """Measurements in arrival order: (arrival time, kind, message) with
    kind "scan", "radar" or "odom". A measurement arrives at its own time
    (a scan at its end), a radar frame with an index in ``late_radar``
    ``RADAR_DELAY`` late. Equal arrival times keep the order scans, radar
    frames, odometry messages."""
    ev = [(scan_t_end(sc), "scan", sc) for sc in scans]
    ev.extend((fr["ts"] + (RADAR_DELAY if j in late_radar else 0.0),
               "radar", fr) for j, fr in enumerate(radar))
    ev.extend((m["ts"], "odom", m) for m in odom)
    order = sorted(range(len(ev)), key=lambda i: ev[i][0])
    return [ev[i] for i in order]
