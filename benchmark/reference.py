"""The plain reference and the comparison that decides ``correct``.

The reference is the rig's true motion: the configuration's trajectory
(``synth.make_trajectory``, closed form, float64), evaluated at the time
of every state the window answered with. It takes nothing from the
program but the answers it judges: their times, rotations and positions.

The numbers, each compared where ``limits/<cell>.json`` gives it a limit
and printed beside the comparison otherwise:

* ``missing_states``: timed measurements without their state. In a stream
  cell, an event answered with no state, or a scan whose answer is not a
  state at its end time; in a bulk cell, a scan of the window whose end
  time has no trajectory row. Exact: its limit is 0.
* ``rel_pos_gap_m`` / ``rel_pos_rms_m``: over each pair of consecutive
  answers, the gap between the program's displacement and the true one,
  both in the earlier state's body frame; the widest gap of the window /
  the root mean square of the gaps. Blind to the choice of world frame
  (the estimator starts at the origin, the reference at the scene's own
  coordinates), they see every layer that moves a state: deskew,
  preintegration, registration, the window solve, the radar and odometry
  factors, late inserts.
* ``rel_rot_gap_rad`` / ``rel_rot_rms_rad``: the same for the relative
  rotation (the angle of the program's relative rotation against the true
  one).

Always printed, never compared: the ATE after an SE(3) alignment, the
body-frame velocity gap and the bias magnitudes (the generator's biases are
zero).

The control, :func:`truth` with ``precision="bfloat16"``, is the reference
put in the program's place and held in the precision below float32, the
precision the configuration states."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import synth


def truth(cfg, ts, precision="float64"):
    """(q wxyz [n,4], p [n,3], v [n,3]) of the true motion at times ``ts``,
    float64 numpy; held in ``precision`` where it is not float64."""
    tc = synth.TrajectoryConfig(**cfg["sensors"]["trajectory"])
    traj = synth.make_trajectory(tc)
    t = torch.as_tensor(np.asarray(ts, float), dtype=torch.float64)
    out = [traj["quat"](t), traj["pos"](t), traj["vel"](t)]
    if precision != "float64":
        dt = getattr(torch, precision)
        out = [x.to(dt).to(torch.float64) for x in out]
    return [x.numpy() for x in out]


def _mat(q):
    return synth.quat_to_mat(torch.as_tensor(q, dtype=torch.float64)).numpy()


def _conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qmul(a, b):
    return synth.quat_mul(torch.as_tensor(a), torch.as_tensor(b)).numpy()


def _rel(q, p):
    """Relative rotations (unit quaternions) and displacements of
    consecutive states, in the earlier state's body frame."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    dq = _qmul(_conj(q[:-1]), q[1:])
    dp = np.einsum("nji,nj->ni", _mat(q[:-1]), p[1:] - p[:-1])
    return dq, dp


def rel_gaps(q, p, q_true, p_true):
    """(displacement gaps [m], rotation gaps [rad]) of the consecutive
    pairs."""
    dq, dp = _rel(np.asarray(q, float), np.asarray(p, float))
    dqt, dpt = _rel(q_true, p_true)
    e = _qmul(_conj(dqt), dq)
    return (np.linalg.norm(dp - dpt, axis=-1),
            2.0 * np.arctan2(np.linalg.norm(e[:, 1:], axis=-1),
                             np.abs(e[:, 0])))


def ate(p, p_true):
    """RMSE of the positions after the SE(3) alignment onto the truth."""
    p, g = np.asarray(p, float), np.asarray(p_true, float)
    if len(p) < 3 or not np.isfinite(p).all():
        return math.inf
    mp, mg = p.mean(0), g.mean(0)
    U, _, Vt = np.linalg.svd((p - mp).T @ (g - mg))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    return float(np.sqrt((np.linalg.norm((p - mp) @ R.T + mg - g,
                                         axis=-1) ** 2).mean()))


def stream_states(window):
    """The answers of a stream window as (missing, ts, q, p, v, bg, ba):
    one row an answered event, in order."""
    missing, rows = 0, []
    for (kind, t), row in zip(window.events, window.answers):
        if row is None or (kind == "scan" and abs(row[0] - t) > 1e-6):
            missing += 1
        if row is not None:
            rows.append(row)
    a = np.asarray(rows, float).reshape(-1, 17)
    return (missing, a[:, 0], a[:, 1:5], a[:, 5:8], a[:, 8:11],
            a[:, 11:14], a[:, 14:17])


def bulk_states(window, trajectory):
    """The states a bulk window logged, as (missing, ts, q, p)."""
    rows = trajectory[window.first_row:]
    logged = {round(t, 6) for t, _, _ in trajectory}
    missing = sum(1 for kind, t in window.events
                  if kind == "scan" and round(t, 6) not in logged)
    ts = np.asarray([r[0] for r in rows], float)
    p = np.asarray([r[1] for r in rows], float).reshape(-1, 3)
    q = np.asarray([r[2] for r in rows], float).reshape(-1, 4)
    return missing, ts, q, p


def judge(cfg, missing, ts, q, p, precision="float64"):
    """The numbers of one window's answers against the reference (or the
    control, held in ``precision``); inf where an answer is not finite."""
    out = dict(missing_states=missing)
    gp = gr = np.zeros(1)
    if len(ts) >= 2:
        qt, pt, _ = truth(cfg, ts, precision)
        gp, gr = rel_gaps(q, p, qt, pt)
    for name, g in (("pos", gp), ("rot", gr)):
        unit = "m" if name == "pos" else "rad"
        ok = np.isfinite(g).all()
        out[f"rel_{name}_gap_{unit}"] = float(g.max()) if ok else math.inf
        out[f"rel_{name}_rms_{unit}"] = \
            float(np.sqrt((g ** 2).mean())) if ok else math.inf
    return out


def printed(cfg, ts, q, p, v=None, bg=None, ba=None):
    """The numbers printed beside the comparison, not compared."""
    qt, pt, vt = truth(cfg, ts)
    out = dict(ate_m=ate(p, pt))
    if v is not None and len(v):
        vb = np.einsum("nji,nj->ni", _mat(q), v)
        vbt = np.einsum("nji,nj->ni", _mat(qt), vt)
        out["vel_gap_mps"] = float(np.linalg.norm(vb - vbt, axis=-1).max())
        out["bg_max"] = float(np.linalg.norm(bg, axis=-1).max())
        out["ba_max"] = float(np.linalg.norm(ba, axis=-1).max())
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers ``limits`` names:
    each finite and at most its limit."""
    rows = [(k, numbers[k], lim) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
