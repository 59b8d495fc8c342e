"""Live observability: the per-scan debug stream and the marker data.

Port of ``mimosa_tpu/io/viz.py``, the stand-ins for the reference's debug
topics (plotjuggler layouts) and rviz markers:

- :class:`DebugStream` appends one JSON line per scan to a file that
  ``scripts/live_dashboard.py --follow`` tails;
- :func:`icp_snapshot` matches a scan against the current map at the
  current estimate and returns per-point correspondences with the full
  ``ICPResult`` (the marker data): on the card through the ICP kernel
  (``ops/icp_cuda.py``), on the CPU through its plain version;
- :func:`render_correspondences` and :func:`render_feature_overlay` draw the
  marker equivalents as PNGs; :func:`feature_overlay_arrays` is the overlay's
  device part (frame, projection, masks), which needs no matplotlib.

All of it is off the hot path and opt-in, and none of it runs inside a
captured step: each call reads the Sequencer's own state (its tensors, not
a shared step cache's buffers) on the current stream, after the steps that
wrote it. Call it from the thread that runs the Sequencer's steps.
matplotlib is imported inside the render calls only.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.lidar.downsample import voxel_downsample


def _debug_row(s, i, j):
    """(debug record row i, traj_q row j, traj_p row j) of Sequencer ``s``
    as float64 numpy: one gather and one transfer."""
    row = torch.cat([s.debug_rec[i], s.traj_q[j], s.traj_p[j]])
    row = row.cpu().numpy().astype(np.float64)
    n = s.debug_rec.shape[1]
    return row[:n], row[n:n + 4], row[n + 4:]


class DebugStream:
    """Append-only JSONL per-scan debug stream (the debug-topic stand-in).

    One line per emitted scan: ts, scan index, the 17 status slots of the
    debug record (inliers, reject counters, mean residual, degeneracy
    flags, photometric statuses, rescue flag), the IMU factor's
    localizability eigenvalues, pose, window occupancy and the host
    counters. Emitted every ``every`` scans (default 10).

    Wire it with ``replay_bag(..., debug_stream=DebugStream(path))``,
    ``OnlineEstimator(seq, debug_stream=...)``, the replay CLI's
    ``--debug-stream``, or call :meth:`emit` after ``add_scan`` from the
    thread that runs the Sequencer.
    """

    def __init__(self, path, every=10):
        self.path = path
        self.every = max(int(every), 1)
        self._f = open(path, "w")
        self._last = -1
        self.n_emitted = 0

    def emit(self, s, force=False):
        """Emit one line for the newest scan of Sequencer ``s`` (nothing if
        no new scan, or off the ``every`` cadence unless ``force``)."""
        idx = s.scan_idx
        if idx == 0 or idx == self._last:
            return False
        if not force and (idx % self.every) != 0:
            return False
        self._last = idx
        j = max(len(s._traj_ts) - 1, 0)
        row, q, p = _debug_row(s, idx - 1, j)
        line = {
            "scan": int(idx),
            "ts": float(s._traj_ts[j]) if s._traj_ts else None,
            "q_wxyz": q.round(6).tolist(),
            "p": p.round(4).tolist(),
            "icp_inliers": int(row[0]),
            "icp_status": [int(v) for v in row[1:5]],
            "mean_abs_res": round(float(row[5]), 6),
            "degen_rot": [bool(v > 0.5) for v in row[6:9]],
            "degen_trans": [bool(v > 0.5) for v in row[9:12]],
            "photo_tracked": int(row[12]),
            # slots 12-15, the tracked count first, as the JAX package has it
            "photo_status": [int(v) for v in row[12:16]],
            "rescued": bool(row[16] > 0.5),
            "imu_loc_rot": row[38:41].round(3).tolist(),
            "imu_loc_pos": row[41:44].round(3).tolist(),
            "imu_loc_vel": row[44:47].round(3).tolist(),
            "n_active": int(s.n_active),
            "counters": dict(s.counters),
        }
        self._f.write(json.dumps(line) + "\n")
        self._f.flush()
        self.n_emitted += 1
        return True

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# correspondence / localizability snapshot (the rviz-marker data)
# ---------------------------------------------------------------------------

def _pose(s, st):
    f = dict(dtype=s.dtype, device=s.device)
    return torch.tensor(st.q, **f), torch.tensor(st.p, **f)


def _padded(n, *arrays):
    """Each (array, width, dtype) copied into zeros of ``n`` rows (cut to
    n), as tensors."""
    out = []
    for a, width, dtype in arrays:
        z = np.zeros((n,) + width, dtype)
        m = min(len(a), n)
        z[:m] = a[:m]
        out.append(torch.from_numpy(z))
    return out


def snapshot_inputs(s, points, valid=None, max_points=4096):
    """What :func:`icp_snapshot` linearizes, on the Sequencer's device:
    (matches, body-frame points [max_points, 3], their validity, q, t) of
    the scan downsampled at the geometric leaf and matched at the current
    estimate; None before initialization."""
    st = s.current_state()
    if st is None:
        return None
    if valid is None:
        valid = np.isfinite(points).all(-1) & (
            np.linalg.norm(points, axis=-1) > 1e-3)
    pts, ok = _padded(max_points * 4, (points, (3,), np.float32),
                      (valid, (), bool))
    pb, pv, _ = voxel_downsample(
        lie.se3_transform(s.q_bl, s.t_bl, pts.to(s.device, s.dtype)),
        ok.to(s.device), s.cfg.geo_leaf, max_points)
    q, t = _pose(s, st)
    return geo.match(s.vmap, pb, q, t, s.map_cfg), pb, pv, q, t


def icp_snapshot(s, points, valid=None, max_points=4096):
    """Match a sensor-frame scan against the CURRENT map at the CURRENT
    estimate and return the marker data the reference's fillMarkerArray
    publishes: per-point world position, plane foot point, plane normal,
    inlier mask, plus the ICPResult's localizability eigen-triads.

    ``points``: [N,3] sensor(lidar)-frame numpy array (the raw scan; the
    snapshot skips deskew). The linearization is
    ``ops.icp_cuda.linearize``: one kernel launch on the card, its plain
    version on the CPU; the per-point inlier mask comes from the residual
    through ``geometric.inlier_gates``. Returns a dict of numpy arrays and
    ``icp``, the whole ICPResult as tensors on the Sequencer's device; None
    before initialization."""
    from mimosa_tpu_torch.ops import icp_cuda

    inputs = snapshot_inputs(s, points, valid, max_points)
    if inputs is None:
        return None
    matches, pb, pv, q, t = inputs
    res = icp_cuda.linearize(matches, pb, pv, q, t, s.geo_cfg,
                             s.window.g_dir)
    normal, mean, found = matches
    p_w = pb @ lie.quat_to_mat(q).T + t
    r = torch.sum(normal * (p_w - mean), dim=-1)
    inlier = geo.inlier_gates(r, pb, pv, found, s.geo_cfg)[0]
    foot = p_w - r[:, None] * normal

    def host(x):
        return x.cpu().numpy()

    return dict(
        p_w=host(p_w), foot=host(foot), normal=host(normal),
        inlier=host(inlier), found=host(pv & found),
        pose_q=host(q), pose_p=host(t),
        eigvals_rot=host(res.eigvals_rot),
        eigvals_trans=host(res.eigvals_trans),
        eigvecs_rot=host(res.eigvecs_rot),
        eigvecs_trans=host(res.eigvecs_trans),
        degen_rot=host(res.degenerate_rot),
        degen_trans=host(res.degenerate_trans),
        num_inlier=int(res.num_inlier), icp=res)


def render_correspondences(snap, out_png, max_draw=600):
    """Draw the correspondence/normal markers + localizability triad of an
    :func:`icp_snapshot` as a PNG (the rviz stand-in): top-down XY with
    point->plane-foot segments and plane normals, plus the translation /
    rotation eigen-triads scaled by their eigenvalues and colored by the
    degeneracy flags (red = degenerate axis)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    inl = snap["inlier"]
    idx = np.flatnonzero(inl)
    if len(idx) > max_draw:
        idx = idx[np.linspace(0, len(idx) - 1, max_draw).astype(int)]
    p, f, n = snap["p_w"][idx], snap["foot"][idx], snap["normal"][idx]
    pose = snap["pose_p"]

    fig, axes = plt.subplots(1, 2, figsize=(13, 6))
    ax = axes[0]
    for a, b in zip(p, f):
        ax.plot([a[0], b[0]], [a[1], b[1]], c="tab:orange", lw=0.5,
                alpha=0.5)
    ax.scatter(f[:, 0], f[:, 1], s=2, c="tab:blue", label="plane foot")
    ax.quiver(f[:, 0], f[:, 1], n[:, 0], n[:, 1], color="tab:green",
              width=2e-3, scale=40, alpha=0.6, label="normal")
    ax.scatter([pose[0]], [pose[1]], marker="*", s=140, c="k",
               label="pose")
    ax.set_title(f"correspondences (XY) — {snap['num_inlier']} inliers")
    ax.axis("equal")
    ax.legend(fontsize=8)

    # localizability triad: translation eigvecs in XY scaled by sqrt(eig),
    # rotation eigvals as a bar inset
    ax = axes[1]
    lam_t = snap["eigvals_trans"]
    scale = np.sqrt(np.maximum(lam_t, 0.0))
    scale = scale / max(scale.max(), 1e-9)
    for k in range(3):
        v = snap["eigvecs_trans"][:, k]
        col = "tab:red" if snap["degen_trans"][k] else "tab:blue"
        ax.annotate(
            "", xy=(v[0] * scale[k], v[1] * scale[k]), xytext=(0, 0),
            arrowprops=dict(arrowstyle="->", color=col, lw=2))
        ax.annotate(f"t{k}: {lam_t[k]:.1e}",
                    xy=(v[0] * scale[k], v[1] * scale[k]), fontsize=8)
    lam_r = snap["eigvals_rot"]
    ins = ax.inset_axes([0.65, 0.05, 0.3, 0.25])
    ins.bar(range(3), lam_r,
            color=["tab:red" if d else "tab:blue"
                   for d in snap["degen_rot"]])
    ins.set_title("rot eigvals", fontsize=7)
    ins.tick_params(labelsize=6)
    ax.set_xlim(-1.2, 1.2)
    ax.set_ylim(-1.2, 1.2)
    ax.set_title("translation localizability triad (XY projection)")
    ax.set_aspect("equal")

    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def feature_overlay_arrays(s, points, intensity, valid):
    """The feature overlay's device part: the scan's normalized intensity
    image and the live feature store's centers projected at the current
    estimate. Returns numpy (image [R,C], fu [F], fv [F], visible [F],
    good [F]): visible = valid and in the field of view, good = visible and
    on the frame's usable mask. The approximate projection serves an
    exact-Ouster configuration too (the re-skew moves pixels by sub-pixel
    amounts). None without the photometric factor or before
    initialization."""
    from mimosa_tpu_torch.lidar import photometric as ph

    if s.photo_cfg is None:
        return None
    st = s.current_state()
    if st is None:
        return None
    cfg = dataclasses.replace(s.photo_cfg, exact_ouster=False)
    pts, inten, ok = _padded(
        s.cfg.max_scan_points, (points, (3,), np.float32),
        (intensity, (), np.float32), (valid, (), bool))
    f = dict(dtype=s.dtype, device=s.device)
    frame = ph.make_frame(pts.to(**f), inten.to(**f), ok.to(s.device), cfg)
    q, t = _pose(s, st)
    q_wl, t_wl = lie.se3_compose(q, t, s.q_bl, s.t_bl)
    q_lw, t_lw = lie.se3_inverse(q_wl, t_wl)
    feats = s.features
    fu, fv, _, fov = ph.project(
        lie.se3_transform(q_lw, t_lw, feats.center_w), cfg)
    ui = torch.clamp(torch.round(fu).to(torch.int64), 0, cfg.rows - 1)
    vi = torch.clamp(torch.round(fv).to(torch.int64), 0, cfg.cols - 1)
    vis = feats.valid & fov
    good = vis & frame.mask[ui, vi]
    return tuple(x.cpu().numpy() for x in (frame.intensity, fu, fv, vis,
                                           good))


def render_feature_overlay(s, points, intensity, valid, out_png):
    """Feature image overlay (the reference's publishFeatures): the
    scan's normalized intensity image with the live feature store's
    centers projected at the current estimate (green = in fov + tracked
    mask, red = projects outside the usable mask), as a PNG."""
    arrays = feature_overlay_arrays(s, points, intensity, valid)
    if arrays is None:
        return None
    img, fu, fv, vis, good = arrays
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(14, 3.2))
    ax.imshow(img, cmap="gray", aspect="auto", interpolation="nearest")
    bad = vis & ~good
    ax.scatter(fv[good], fu[good], s=36, facecolors="none",
               edgecolors="lime", lw=1.2, label=f"tracked {good.sum()}")
    ax.scatter(fv[bad], fu[bad], s=36, facecolors="none",
               edgecolors="red", lw=1.0, label=f"masked/edge {bad.sum()}")
    ax.set_title("photometric feature overlay")
    ax.legend(fontsize=8, loc="upper right")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png
