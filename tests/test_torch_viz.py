"""The port's live observability (``io/viz.py``) against the JAX package's
``mimosa_tpu/io/viz.py``, on the CPU, and the scripts that read the port's
outputs.

The JAX package's ``DebugStream.emit``, ``icp_snapshot`` and
``render_feature_overlay`` read only named attributes of a Sequencer, so
the JAX side runs on a stand-in that carries a port Sequencer's state as
``jnp`` arrays (the configurations rebuilt field by field, the map and the
feature store from numpy): no JAX Sequencer is compiled.

* Each line the port's stream writes equals, JSON for JSON, the JAX
  stream's line on the same state, at every scan step of a short
  photometric replay; the cadence (``every``), the de-duplication and
  ``force`` give the same calls the same answers and the same files.
* ``icp_snapshot`` against JAX's on the same map, scan and pose: ``p_w``,
  ``foot`` and ``normal`` within 1e-5, ``inlier`` and ``found`` exact, the
  localizability fields at ``tests/test_torch_lidar.py``'s tolerances
  (eigenvalues rtol 1e-4 / atol 1e-6, eigenvectors 1e-3 up to sign,
  flags and counts exact); and the JAX test's own checks (more than 50
  inliers, unit normals, median segment under 0.1 m).
* ``render_correspondences`` writes the PNG bytes JAX's writes from the same
  snapshot.
* ``feature_overlay_arrays`` against JAX's ``make_frame`` / ``project``
  path of ``render_feature_overlay``: the image within 1e-3 (0-255 scale,
  ``tests/test_torch_photometric.py``'s image gate), the projected pixels
  within 1e-4 px, the masks exact, on a cloud with no beam on the edge of
  the field of view; the overlay PNG is written.
* ``scripts/live_dashboard.py`` runs unchanged on the port's stream, and
  ``scripts/export_map.py`` and ``scripts/plot_debug.py`` on a port
  checkpoint (``utils/checkpoint.save``), each as a subprocess.

The replay and CLI debug streams are held against their runs in
``tests/test_torch_replay.py``, the online driver's in
``tests/test_torch_online.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.io import viz as jviz
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.lidar import photometric as jph
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.io import viz
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.utils import checkpoint as ckpt

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINT_TOL = 1e-5          # [m] p_w, foot, normal
PIXEL_TOL = 1e-4          # [px] projected feature centers
IMG_TOL = 1e-3            # images on the 0-255 scale
# the stream's calls at each scan step k: a plain emit, a repeated one (the
# de-duplication) and, every fifth step, a forced one
CALLS = ((False,), (False,), (True,))


def _sequencer():
    """synthetic_replay.run's room Sequencer (16x256 LiDAR, 4096 points,
    K=6) with its photometric factor, on the CPU."""
    lm = tsyn.LidarModel()
    return tseq.Sequencer(
        tseq.SequencerConfig(max_scan_points=4096, n_geo_points=4096,
                             n_map_points=8192, geo_leaf=0.4,
                             map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                             keyframe_rot_thresh=0.15),
        twin.WindowConfig(K=6),
        tvh.VoxelMapConfig(leaf_size=0.4, capacity_log2=15,
                           plane_min_points=5, lru_horizon=0),
        tgeo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        trep.photo_config(lm), device="cpu")


def _jax_cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def stand_in(s, full=False):
    """The port Sequencer ``s``'s state as the JAX package's viz functions
    read it: the logging rings and host counters (``DebugStream``), and
    with ``full`` the configurations, the map, the feature store and the
    current state (``icp_snapshot``, the feature overlay)."""
    x = types.SimpleNamespace(
        scan_idx=s.scan_idx, _traj_ts=list(s._traj_ts), n_active=s.n_active,
        counters=dict(s.counters),
        **{k: jnp.asarray(convert.to_numpy(getattr(s, k)))
           for k in ("debug_rec", "traj_q", "traj_p")})
    if full:
        st = s.current_state()
        x.current_state = lambda: st
        x.dtype = jnp.float32
        x.cfg = _jax_cfg(jseq.SequencerConfig, s.cfg)
        x.map_cfg = _jax_cfg(jvh.VoxelMapConfig, s.map_cfg)
        x.geo_cfg = _jax_cfg(jgeo.GeometricConfig, s.geo_cfg)
        x.photo_cfg = _jax_cfg(jph.PhotometricConfig, s.photo_cfg)
        x.vmap = jvh.VoxelMap(**{k: jnp.asarray(v) for k, v in
                                 convert.to_numpy(s.vmap).items()})
        x.features = jph.Features(**{k: jnp.asarray(v) for k, v in
                                     convert.to_numpy(s.features).items()})
        x.window = types.SimpleNamespace(
            g_dir=jnp.asarray(convert.to_numpy(s.window.g_dir)))
    return x


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 3 s photometric room replayed through the port scan by scan, with
    two port debug streams (every scan; every 4th with CALLS) on the real
    Sequencer, and the JAX stand-in of each step's state."""
    d = tmp_path_factory.mktemp("viz")
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=3.0), tsyn.LidarModel(), seed=0, imu_noise=0.01,
        range_noise=0.01)
    s = _sequencer()
    streams = {1: viz.DebugStream(str(d / "every1.jsonl"), every=1),
               4: viz.DebugStream(str(d / "every4.jsonl"), every=4)}
    answers, states, imu_i = [], [], 0
    for k in range(len(data["scans"])):
        imu_i = trep.feed(s, data, k, imu_i)
        streams[1].emit(s)
        answers.append([streams[4].emit(s, force=f and k % 5 == 0)
                        for (f,) in CALLS])
        states.append(stand_in(s))
    for st in streams.values():
        st.close()
    return dict(s=s, data=data, dir=d, streams=streams, answers=answers,
                states=states)


def _lines(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.mark.parametrize("every", [1, 4])
def test_stream_lines_equal_jax(run, every):
    """The JAX stream on the stand-ins, called as the port's stream was:
    the same answers (cadence, de-duplication, force) and, line for line,
    the same JSON."""
    ref = jviz.DebugStream(str(run["dir"] / f"jax{every}.jsonl"),
                           every=every)
    answers = []
    for k, x in enumerate(run["states"]):
        if every == 1:
            ref.emit(x)
        else:
            answers.append([ref.emit(x, force=f and k % 5 == 0)
                            for (f,) in CALLS])
    ref.close()
    if every == 4:
        assert answers == run["answers"]
    port = _lines(run["streams"][every].path)
    jax_lines = _lines(ref.path)
    assert port == jax_lines
    s = run["s"]
    if every == 1:
        assert [ln["scan"] for ln in port] == list(range(1, s.scan_idx + 1))
        tracked = [ln["photo_tracked"] for ln in port]
        assert max(tracked) > 0
        assert all(ln["photo_status"][0] == ln["photo_tracked"]
                   for ln in port)
        assert port[-1]["counters"] == s.counters
    else:
        # each scan once, forced lines off the cadence among them
        scans = [ln["scan"] for ln in port]
        assert len(scans) == len(set(scans)) and any(k % 4 for k in scans)
        assert any(k % 4 == 0 for k in scans)
        assert not any(a[1] for a in answers)      # a repeat never writes


def test_stream_skips_before_the_first_scan(tmp_path):
    s = _sequencer()
    st = viz.DebugStream(str(tmp_path / "none.jsonl"), every=1)
    assert not st.emit(s, force=True) and st.n_emitted == 0
    st.close()
    assert (tmp_path / "none.jsonl").read_text() == ""


@pytest.fixture(scope="module")
def snapshots(run):
    """The port's and JAX's snapshots of the last scan at the final
    estimate."""
    s, scan = run["s"], run["data"]["scans"][-1]
    port = viz.icp_snapshot(s, scan["points"], scan["valid"],
                            max_points=2048)
    ref = jviz.icp_snapshot(stand_in(s, full=True), scan["points"],
                            scan["valid"], max_points=2048)
    return port, ref


def test_icp_snapshot_matches_jax(snapshots):
    port, ref = snapshots
    assert set(ref) <= set(port) and set(port) - set(ref) == {"icp"}
    for k in ("p_w", "foot", "normal"):
        np.testing.assert_allclose(port[k], ref[k], atol=POINT_TOL,
                                   err_msg=k)
    for k in ("inlier", "found", "degen_rot", "degen_trans"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("pose_q", "pose_p"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["num_inlier"] == ref["num_inlier"] == int(port["inlier"].sum())
    for k in ("eigvals_rot", "eigvals_trans"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-6)
    for k in ("eigvecs_rot", "eigvecs_trans"):
        # columns up to sign
        dots = np.abs(np.sum(port[k] * ref[k], axis=0))
        np.testing.assert_allclose(dots, 1.0, atol=1e-3, err_msg=k)
    # the JAX test's own checks (tests/test_viz.py)
    inl = port["inlier"]
    assert port["num_inlier"] > 50
    assert np.isfinite(port["foot"][inl]).all()
    assert np.allclose(np.linalg.norm(port["normal"][inl], axis=-1), 1.0,
                       atol=1e-3)
    seg = np.linalg.norm(port["p_w"][inl] - port["foot"][inl], axis=-1)
    assert np.median(seg) < 0.1
    # the whole ICPResult rides along: the plain version on the CPU
    assert isinstance(port["icp"], tgeo.ICPResult)
    assert int(port["icp"].num_inlier) == port["num_inlier"]


def test_snapshot_is_none_before_initialization():
    s = _sequencer()
    pts = np.ones((10, 3), np.float32)
    assert viz.icp_snapshot(s, pts) is None
    assert viz.feature_overlay_arrays(s, pts, np.ones(10, np.float32),
                                      np.ones(10, bool)) is None


def test_render_correspondences_bytes_equal_jax(snapshots, tmp_path):
    port, _ = snapshots
    snap = {k: v for k, v in port.items() if k != "icp"}
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert viz.render_correspondences(snap, a) == a
    jviz.render_correspondences(snap, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        pa, pb = fa.read(), fb.read()
    assert len(pa) > 5000 and pa == pb


def _jax_overlay(x, points, intensity, valid):
    """The arrays of JAX's render_feature_overlay (its jitted ``overlay``
    body, mimosa_tpu/io/viz.py:283-304), with 64-bit types off as it runs
    in production."""
    cfg = dataclasses.replace(x.photo_cfg, exact_ouster=False)
    n = x.cfg.max_scan_points
    pts = np.zeros((n, 3), np.float32)
    inten = np.zeros(n, np.float32)
    ok = np.zeros(n, bool)
    m = min(len(points), n)
    pts[:m], inten[:m], ok[:m] = points[:m], intensity[:m], valid[:m]
    st = x.current_state()

    def overlay(pts_l, inten_, vd, feats, q, t):
        from mimosa_tpu.core import lie as jlie
        q_bl = jnp.asarray(x.cfg.q_b_l, jnp.float32)
        t_bl = jnp.asarray(x.cfg.t_b_l, jnp.float32)
        frame = jph.make_frame(pts_l, inten_, vd, cfg)
        q_wl, t_wl = jlie.se3_compose(q, t, q_bl, t_bl)
        q_lw, t_lw = jlie.se3_inverse(q_wl, t_wl)
        cen_l = jlie.se3_transform(q_lw, t_lw, feats.center_w)
        fu, fv, _, fov = jph.project(cen_l, cfg)
        ui = jnp.clip(jnp.round(fu).astype(jnp.int32), 0, cfg.rows - 1)
        vi = jnp.clip(jnp.round(fv).astype(jnp.int32), 0, cfg.cols - 1)
        good = feats.valid & fov & frame.mask[ui, vi]
        return frame.intensity, fu, fv, feats.valid & fov, good

    with jax.enable_x64(False):
        out = jax.jit(overlay)(jnp.asarray(pts), jnp.asarray(inten),
                               jnp.asarray(ok), x.features,
                               jnp.asarray(st.q, jnp.float32),
                               jnp.asarray(st.p, jnp.float32))
    return [np.asarray(a) for a in out]


def test_feature_overlay_arrays_match_jax(run, tmp_path):
    """The last scan time's cloud from a LiDAR whose top and bottom beams
    lie 0.01 rad inside the configured field of view: a beam exactly on its
    edge is in view or not by the last bit of asin, which XLA and torch
    round differently (118 points of a 16x256 scan on the replay's own
    LiDAR)."""
    s = run["s"]
    lm = tsyn.LidarModel(fov_up=0.29, fov_down=-0.44)
    assert lm.fov_up < s.photo_cfg.fov_up and lm.fov_down > \
        s.photo_cfg.fov_down
    scan = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=3.0), lm, seed=0, range_noise=0.01)["scans"][-1]
    assert scan["ts_header"] == run["data"]["scans"][-1]["ts_header"]
    args = (scan["points"], scan["intensity"], scan["valid"])
    img, fu, fv, vis, good = viz.feature_overlay_arrays(s, *args)
    r_img, r_fu, r_fv, r_vis, r_good = _jax_overlay(
        stand_in(s, full=True), *args)
    np.testing.assert_allclose(img, r_img, atol=IMG_TOL)
    np.testing.assert_allclose(fu, r_fu, atol=PIXEL_TOL)
    np.testing.assert_allclose(fv, r_fv, atol=PIXEL_TOL)
    np.testing.assert_array_equal(vis, r_vis)
    np.testing.assert_array_equal(good, r_good)
    assert good.sum() > 0 and img.shape == (s.photo_cfg.rows,
                                            s.photo_cfg.cols)
    png = str(tmp_path / "feat.png")
    assert viz.render_feature_overlay(s, *args, png) == png
    assert os.path.getsize(png) > 5000


def _script(name, *args):
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name),
                        *map(str, args)], capture_output=True, text=True,
                       timeout=30, cwd=REPO)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_live_dashboard_runs_on_the_port_stream(run, tmp_path):
    """scripts/live_dashboard.py, unchanged, renders the port's stream
    once (its one-shot mode)."""
    dash = tmp_path / "dash.png"
    _script("live_dashboard.py", run["streams"][1].path, "-o", dash)
    assert os.path.getsize(dash) > 10000


def test_scripts_run_on_a_port_checkpoint(run, tmp_path):
    """scripts/export_map.py and scripts/plot_debug.py, unchanged, read a
    checkpoint from the port's utils/checkpoint.save: the occupied voxels
    and the trajectory they export are the Sequencer's."""
    s = run["s"]
    path = tmp_path / "ckpt.npz"
    ckpt.save(s, path)
    ply, npz, tum = (tmp_path / n for n in ("map.ply", "map.npz", "t.tum"))
    out = _script("export_map.py", path, "--ply", ply, "--npz", npz,
                  "--traj-tum", tum)
    n = s.vmap.n[:-1]
    sel = (s.vmap.occupied[:-1] & (n > 0)).numpy()
    assert out.startswith(f"{sel.sum()} occupied voxels")
    with np.load(npz) as z:
        np.testing.assert_array_equal(z["mean"], s.vmap.mean[:-1].numpy()[sel])
    assert f"element vertex {sel.sum()}" in ply.read_bytes()[:200].decode(
        errors="ignore")
    ref = tmp_path / "ref.tum"
    s.write_tum(str(ref))
    assert tum.read_text() == ref.read_text()
    png = tmp_path / "debug.png"
    _script("plot_debug.py", path, "-o", png)
    assert os.path.getsize(png) > 10000
