"""Trajectory evaluation metrics — the evo-equivalents the reference uses.

Implements the exact metric setup of the reference's evaluation harness
(reference scripts/dataset_evaluation.py:242-303): ATE = APE translation
RMSE after SE(3) Umeyama alignment, RTE = RPE translation over a fixed
path-distance delta (10 m, all pairs) as a percentage. Ground truth comes
as TUM files or (ts, xyz) arrays. The port's numpy copy of
``mimosa_tpu/utils/evaluation.py``.
"""

from __future__ import annotations

import numpy as np


def load_tum(path):
    """TUM file -> (ts [N], p [N,3], q_wxyz [N,4])."""
    arr = np.loadtxt(path)
    if arr.ndim == 1:
        arr = arr[None]
    ts = arr[:, 0]
    p = arr[:, 1:4]
    q = arr[:, [7, 4, 5, 6]]  # file is qx qy qz qw -> w-first
    return ts, p, q


def associate(est_ts, gt_ts, max_diff=0.02):
    """Nearest-timestamp association. Returns (est_idx, gt_idx)."""
    gi = np.searchsorted(gt_ts, est_ts)
    gi = np.clip(gi, 1, len(gt_ts) - 1)
    left = gt_ts[gi - 1]
    right = gt_ts[gi]
    pick = np.where(np.abs(est_ts - left) < np.abs(est_ts - right),
                    gi - 1, gi)
    ok = np.abs(gt_ts[pick] - est_ts) <= max_diff
    return np.nonzero(ok)[0], pick[ok]


def umeyama_align(est_p, gt_p, with_scale=False):
    """SE(3) (optionally Sim(3)) alignment est->gt. Returns (R, t, s)."""
    mu_e = est_p.mean(0)
    mu_g = gt_p.mean(0)
    E = est_p - mu_e
    G = gt_p - mu_g
    C = E.T @ G / len(E)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = (U @ S @ Vt).T
    s = float((D * np.diag(S)).sum() / (E ** 2).sum() * len(E)) \
        if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate(est_ts, est_p, gt_ts, gt_p, align=True, max_diff=0.02):
    """APE translation RMSE after SE(3) alignment (evo ape -a equivalent)."""
    ei, gi = associate(np.asarray(est_ts), np.asarray(gt_ts), max_diff)
    if len(ei) < 3:
        return float("nan")
    e = np.asarray(est_p)[ei]
    g = np.asarray(gt_p)[gi]
    if align:
        R, t, s = umeyama_align(e, g)
        e = (s * (R @ e.T)).T + t
    err = np.linalg.norm(e - g, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rte(est_ts, est_p, gt_ts, gt_p, delta_m=10.0, max_diff=0.02,
        all_pairs=True):
    """RPE translation over path-distance delta as percent of delta
    (evo rpe --delta 10 --delta_unit m --all_pairs equivalent,
    ref dataset_evaluation.py:262-273)."""
    ei, gi = associate(np.asarray(est_ts), np.asarray(gt_ts), max_diff)
    if len(ei) < 3:
        return float("nan")
    e = np.asarray(est_p)[ei]
    g = np.asarray(gt_p)[gi]
    # cumulative GT path length
    d = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(g, axis=0),
                                                        axis=-1))])
    errs = []
    j = 0
    for i in range(len(g)):
        # first index at path distance >= d[i] + delta
        j = int(np.searchsorted(d, d[i] + delta_m))
        if j >= len(g):
            break
        de = np.linalg.norm(e[j] - e[i])
        dg = np.linalg.norm(g[j] - g[i])
        errs.append(abs(de - dg))
        if not all_pairs:
            continue
    if not errs:
        return float("nan")
    return float(np.sqrt(np.mean(np.square(errs))) / delta_m * 100.0)
