"""Global batch smoothing of a finished replay (the offline pass 3).

Port of ``mimosa_tpu/graph/refine.py``. The live estimator is a fixed-lag
filter: information older than the window is marginalized, so early poses
never see later observations. This module rebuilds the whole trajectory as
one batch problem and solves it with the window-sharded Gauss-Newton of
``parallel/window_shard.py``:

* states: the trajectory rows (q, p from the device rings; velocities
  seeded by central differences; biases re-estimated from zero);
* measurements: each scan's absorbed pose quadratic, the [6,6] information
  of its ICP (+ photometric) registration that the Sequencer logs in its
  debug ring (``Sequencer.pose_info_records``), as unary pose factors
  anchored at the replay's converged poses; rows without one (declared by
  radar, odometry or the initialization) get a weak anchor;
* the IMU chain: re-preintegrated between consecutive rows from the raw
  IMU stream, batched over the segments.

It runs on the Sequencer's device and in its dtype, op by op: it runs
once, at the end of a replay.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.graph import window as win
from mimosa_tpu_torch.imu import preintegration as pre
from mimosa_tpu_torch.imu.buffer import ImuBuffer
from mimosa_tpu_torch.parallel import window_shard as ws


def smooth(sequencer, imu_ts, imu_acc, imu_gyro, group=None, iters=3,
           max_imu_per_segment=256, max_states=4096,
           weak_sigma_rot=0.2, weak_sigma_pos=0.5):
    """Batch-smooth a finished replay. Returns (ts [K0], q [K0,4],
    p [K0,3]) as float64 numpy: the refined trajectory over the
    Sequencer's K0 rows.

    ``imu_*``: the whole raw IMU stream of the run (host arrays; the
    Sequencer's own buffer keeps only the trailing
    ``imu_max_buffer_duration`` seconds). ``group``: a
    ``torch.distributed`` process group whose ranks split the states
    (``parallel/window_shard.py``; default: one shard, no group). At one
    shard the interior states make one dense [(K-1)*15]^2 matrix; a device
    out of memory raises."""
    s = sequencer
    ts = np.asarray(s._traj_ts, np.float64)
    K0 = len(ts)
    if K0 < 3:
        raise ValueError("nothing to smooth: trajectory too short")
    if K0 > max_states:
        raise ValueError(f"{K0} states > max_states={max_states}; raise "
                         f"the cap or smooth in chunks")
    dtype, dev = s.window.p.dtype, s.window.p.device
    f = dict(dtype=dtype, device=dev)
    q_est = s.traj_q[:K0].cpu().numpy().astype(np.float64)
    p_est = s.traj_p[:K0].cpu().numpy().astype(np.float64)
    H6 = s.pose_info_records().astype(np.float64)           # [K0,6,6]
    # rows without a scan registration get a WEAK anchor at their replay
    # pose: it keeps the batch problem anchored on scan-free stretches,
    # and any real scan information dominates it by orders of magnitude
    weak = np.diag(np.concatenate([
        np.full(3, 1.0 / weak_sigma_rot ** 2),
        np.full(3, 1.0 / weak_sigma_pos ** 2)]))
    no_info = np.abs(H6).max(axis=(1, 2)) < 1e-9
    H6[no_info] = weak

    # pad K to a multiple of the shard count (>= 2 states a shard); pad
    # states repeat the last row with dead IMU segments and zero
    # measurements, and the damping keeps their decoupled blocks solvable
    _, n_wp = ws.shards(group)
    K = max(2 * n_wp, -(-K0 // n_wp) * n_wp)
    pad = K - K0

    def padded(a):
        return np.concatenate([a, np.tile(a[-1:], (pad,) + (1,) *
                                          (a.ndim - 1))], axis=0)

    q0 = torch.tensor(padded(q_est), **f)
    p0 = torch.tensor(padded(p_est), **f)
    # central-difference velocity seed
    v_est = np.zeros_like(p_est)
    v_est[1:-1] = (p_est[2:] - p_est[:-2]) / \
        np.maximum(ts[2:] - ts[:-2], 1e-3)[:, None]
    v_est[0] = v_est[1]
    v_est[-1] = v_est[-2]
    v0 = torch.tensor(padded(v_est), **f)
    bg0 = torch.zeros((K, 3), **f)
    ba0 = torch.zeros((K, 3), **f)
    g_dir = s.window.g_dir.to(**f).clone()

    # re-preintegrate the IMU chain between consecutive rows
    buf = ImuBuffer(max_duration=float(ts[-1] - ts[0]) + 10.0,
                    acc_scale=s.cfg.imu_acc_scale)
    buf.add_batch(np.asarray(imu_ts, np.float64), np.asarray(imu_acc),
                  np.asarray(imu_gyro))
    M = max_imu_per_segment
    accs = np.zeros((K - 1, M, 3), np.float32)
    gyrs = np.zeros((K - 1, M, 3), np.float32)
    dts = np.zeros((K - 1, M), np.float32)
    seg_ok = np.zeros((K - 1, M), bool)
    fv = np.zeros(K - 1, bool)
    for i in range(K0 - 1):
        _, a, g, dt, vd, nn = buf.segment(ts[i], ts[i + 1], M)
        accs[i], gyrs[i], dts[i], seg_ok[i] = a, g, dt, vd
        fv[i] = nn >= 2

    z3 = torch.zeros(3, **f)
    cfg = s.cfg

    def preint_one(a, g, dt, vd):
        return pre.preintegrate(a, g, dt, z3, z3, cfg.acc_var, cfg.gyro_var,
                                int_var=cfg.int_var, valid=vd)

    preints = pre.PreintState(*vmap(preint_one)(
        torch.tensor(accs, **f), torch.tensor(gyrs, **f),
        torch.tensor(dts, **f), torch.tensor(seg_ok, device=dev)))
    fv = torch.tensor(fv, device=dev)

    # pose-measurement quadratics: each row anchored at its replay pose
    # with the scan's own information (pad rows carry none: their IMU
    # segments are dead too, so they stay decoupled and the damping pins
    # their dx at 0)
    SD = win.SD
    H6p = torch.tensor(np.concatenate([H6, np.zeros((pad, 6, 6))]), **f)
    q_meas, p_meas = q0, p0
    wcfg = win.WindowConfig(K=K, damping=1e-6,
                            sigma_bg_rw=s.win_cfg.sigma_bg_rw,
                            sigma_ba_rw=s.win_cfg.sigma_ba_rw,
                            g_mag=cfg.g_mag,
                            init_sigma_rot=s.win_cfg.init_sigma_rot,
                            init_sigma_pos=s.win_cfg.init_sigma_pos,
                            init_sigma_vel=0.5,
                            init_sigma_bg=s.win_cfg.init_sigma_bg,
                            init_sigma_ba=s.win_cfg.init_sigma_ba,
                            init_sigma_grav=s.win_cfg.init_sigma_grav)

    def meas_fn(q, p, v, bg, ba, g):
        r = lie.se3_local(q_meas, p_meas, q, p)                 # [K,6]
        H = torch.zeros((K, SD, SD), **f)
        H[:, :6, :6] = H6p
        b = torch.zeros((K, SD), **f)
        b[:, :6] = torch.einsum("kij,kj->ki", H6p, r)
        return H, b

    q, p, _, _, _, _ = ws.batch_adjust(q0, p0, v0, bg0, ba0, g_dir, preints,
                                       fv, meas_fn, wcfg, iters=iters,
                                       group=group)
    return (ts, q[:K0].cpu().numpy().astype(np.float64),
            p[:K0].cpu().numpy().astype(np.float64))
