"""Motion compensation (deskew) of a LiDAR scan via IMU replay.

Port of ``mimosa_tpu/lidar/deskew.py``: the IMU is replayed across the scan
(gravity-free preintegration prefixes + closed-form gravity terms), a fixed
grid of 1024 time buckets gets a closed-form pose each, and every point
blends its two neighbouring bucket poses, then moves into the scan-end
LiDAR frame ``Le``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.imu import preintegration as pre

NUM_BUCKETS = 1024


class DeskewResult(NamedTuple):
    points_le: torch.Tensor   # [N,3] points in scan-end lidar frame
    q_le_lt: torch.Tensor     # [N,4] per-point rotation Le <- Lt
    t_le_lt: torch.Tensor     # [N,3] per-point translation Le <- Lt
    q_w_be: torch.Tensor      # [4] body pose at scan end (world)
    p_w_be: torch.Tensor      # [3]
    v_w_be: torch.Tensor      # [3]


def _clamped_times(ts, t_end):
    """Sample times clamped to t_end and made monotonic, so padded tail
    samples contribute zero integration time."""
    return torch.cummax(torch.minimum(ts, t_end), dim=0).values


def integrate_imu_poses(q0, p0, v0, accs, gyros, ts, bg, ba, gravity,
                        t_end):
    """Body states at each IMU sample time ts [M] (the state at ts[i],
    integrating constant (acc, gyro) over [ts[i], ts[i+1]]), plus the
    state at t_end. Returns (qs [M,4], ps [M,3], vs [M,3], (q_e, p_e, v_e))."""
    dtype = accs.dtype
    ts = _clamped_times(ts, t_end)
    dts = torch.clamp(torch.diff(ts, append=t_end.reshape(1)), min=0.0)
    pref = pre.preintegrate(accs, gyros, dts, bg, ba, 0.0, 0.0, 0.0,
                            return_prefixes=True)
    R0 = lie.quat_to_mat(q0)
    # state i composes samples 0..i-1 -> shift the prefixes right by one
    # (the identity is built on the device: no host copy inside the step)
    qid = lie.quat_identity(dtype, accs.device)[None]
    z3 = torch.zeros((1, 3), dtype=dtype, device=accs.device)
    dq = torch.cat([qid, pref.dq[:-1]])
    dv = torch.cat([z3, pref.dv[:-1]])
    dp = torch.cat([z3, pref.dp[:-1]])
    ti = torch.cat([z3[:, 0], pref.dt[:-1]])[:, None]

    qs = lie.quat_mul(q0.expand(dq.shape), dq)
    vs = v0 + gravity * ti + dv @ R0.T
    ps = p0 + v0 * ti + 0.5 * gravity * ti * ti + dp @ R0.T

    tN = pref.dt[-1]
    q_e = lie.quat_mul(q0, pref.dq[-1])
    v_e = v0 + gravity * tN + R0 @ pref.dv[-1]
    p_e = p0 + v0 * tN + 0.5 * gravity * tN * tN + R0 @ pref.dp[-1]
    return qs, ps, vs, (q_e, p_e, v_e)


def deskew(points, t_pts, valid, q0, p0, v0, accs, gyros, imu_ts, bg, ba,
           gravity, q_b_l, t_b_l, t_end) -> DeskewResult:
    """Deskew ``points`` [N,3] (lidar frame, times ``t_pts`` [N]) into the
    scan-end lidar frame. (q0, p0, v0): body state at ``imu_ts[0]``;
    accs/gyros/imu_ts [M] padded IMU covering the scan; (q_b_l, t_b_l): the
    lidar extrinsics T_B_L; t_end: scan-end time (0-d tensor)."""
    qs, ps, vs, (q_e, p_e, v_e) = integrate_imu_poses(
        q0, p0, v0, accs, gyros, imu_ts, bg, ba, gravity, t_end)

    # bucket poses: closed form within the owning IMU interval
    NB = NUM_BUCKETS
    dtype, device = points.dtype, points.device
    ts_c = _clamped_times(imu_ts, t_end)
    tb = ts_c[0] + torch.linspace(0.0, 1.0, NB, dtype=dtype,
                                  device=device) * (t_end - ts_c[0])
    bi = torch.clamp(torch.searchsorted(ts_c, tb, right=True) - 1,
                     0, ts_c.shape[0] - 1)
    db = torch.clamp(tb - ts_c[bi], min=0.0)[:, None]
    qb_base = qs[bi]
    a_wb = lie.quat_rotate(qb_base, accs[bi] - ba) + gravity
    p_b = ps[bi] + vs[bi] * db + 0.5 * a_wb * db * db
    q_b = lie.quat_mul(qb_base, lie.exp_so3((gyros[bi] - bg) * db))

    # per point: linear blend of the neighbouring buckets (nlerp)
    span = torch.clamp(t_end - ts_c[0], min=1e-9)
    f = torch.clamp((t_pts - ts_c[0]) / span * (NB - 1), 0.0, NB - 1 - 1e-6)
    i0 = f.to(torch.int64)
    a = (f - i0)[:, None]
    # in f32 the clamp bound rounds to NB - 1 (then a = 0): keep i1 in range
    # as the JAX gather's index clamping does
    i1 = torch.clamp(i0 + 1, max=NB - 1)
    p_t = (1.0 - a) * p_b[i0] + a * p_b[i1]
    q_raw = (1.0 - a) * q_b[i0] + a * q_b[i1]
    q_t = q_raw / torch.linalg.vector_norm(q_raw, dim=-1, keepdim=True)

    # T_Le_Lt = (T_W_Be T_B_L)^-1 T_W_Bt T_B_L
    q_w_lt, t_w_lt = lie.se3_compose(q_t, p_t, q_b_l, t_b_l)
    q_w_le, t_w_le = lie.se3_compose(q_e, p_e, q_b_l, t_b_l)
    q_le_w, t_le_w = lie.se3_inverse(q_w_le, t_w_le)
    q_rel, t_rel = lie.se3_compose(q_le_w, t_le_w, q_w_lt, t_w_lt)

    pts_le = lie.se3_transform(q_rel, t_rel, points)
    pts_le = torch.where(valid[:, None], pts_le, torch.zeros_like(pts_le))
    return DeskewResult(pts_le, q_rel, t_rel, q_e, p_e, v_e)
