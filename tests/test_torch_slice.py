"""The port's geometric LiDAR-inertial slice against the JAX package.

* configs: the dataclasses carry the same fields and defaults;
* synthetic data: the port's numpy generator equals the JAX one;
* one scan step from a state carried across (``mimosa_tpu_torch.convert``)
  gives the same window, map and debug row;
* a short room replay through both packages: both ATEs under 0.10 m and
  within 5 mm of each other. The estimator is chaotic near tracking loss,
  so replays are compared by ATE, not pose by pose (the largest pose
  difference is printed, not gated);
* both of these for each transfer codec (f32, int16 with its dither, the
  int16 range image) and for the merged marginalization;
* importing the port pulls in neither jax nor mimosa_tpu.
"""

import copy
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.io import synthetic as jsyn
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.lidar import photometric as jph
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu.odometry import factor as jodo
from mimosa_tpu.radar import factor as jrad
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.lidar import photometric as tph
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.odometry import factor as todo
from mimosa_tpu_torch.radar import factor as trad

from torch_fixtures import build_once, one_thread_then_free_programs  # noqa: F401


@pytest.mark.parametrize("pair", [
    (jseq.SequencerConfig, tseq.SequencerConfig),
    (jwin.WindowConfig, twin.WindowConfig),
    (jvh.VoxelMapConfig, tvh.VoxelMapConfig),
    (jgeo.GeometricConfig, tgeo.GeometricConfig),
    (jph.PhotometricConfig, tph.PhotometricConfig),
    (jrad.RadarConfig, trad.RadarConfig),
    (jodo.OdometryConfig, todo.OdometryConfig),
], ids=lambda p: p[0].__name__)
def test_config_fields_and_defaults_match(pair):
    j, t = pair
    assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
        [(f.name, f.default) for f in dataclasses.fields(j)]
    assert tseq.DBG_W == jseq.DBG_W


@pytest.mark.parametrize("world,tc", [
    ("room_world", dict()),
    # the corridor_geo_proj row's trajectory
    ("corridor_world", dict(amp=(4.0, 0.6, 0.3), center=(40.0, 2.0, 1.5),
                            yaw_rate=0.15)),
])
def test_generate_matches_jax(world, tc):
    # t_total 3.5 crosses the smoothstep's end at t = 3.2, where an IMU
    # sample sits exactly on the clip bound
    tc = dict(t_total=3.5, **tc)
    lm = dict(n_rows=8, n_cols=128)
    j = jsyn.generate(getattr(jsyn, world)(), jsyn.TrajectoryConfig(**tc),
                      jsyn.LidarModel(**lm), seed=3, imu_noise=0.01,
                      range_noise=0.01)
    t = tsyn.generate(getattr(tsyn, world)(), tsyn.TrajectoryConfig(**tc),
                      tsyn.LidarModel(**lm), seed=3, imu_noise=0.01,
                      range_noise=0.01)
    assert 3.2 in t["imu"]["ts"]
    for k in ("ts", "acc", "gyro"):
        np.testing.assert_allclose(t["imu"][k], j["imu"][k], rtol=1e-9,
                                   atol=1e-9)
    for k in ("ts", "pos", "quat"):
        np.testing.assert_allclose(t["gt"][k], j["gt"][k], rtol=1e-9,
                                   atol=1e-9)
    assert len(t["scans"]) == len(j["scans"]) > 10
    for st, sj in zip(t["scans"], j["scans"]):
        assert st["ts_header"] == sj["ts_header"]
        np.testing.assert_array_equal(st["valid"], sj["valid"])
        np.testing.assert_array_equal(st["t_rel"], sj["t_rel"])
        # f32 points from f64 raycasts through poses equal to ~1e-15
        np.testing.assert_allclose(st["points"], sj["points"], atol=1e-5)
        np.testing.assert_allclose(st["intensity"], sj["intensity"],
                                   atol=1e-3)


# ------------------------------------------------------- replay through both

SEQ_KW = dict(max_scan_points=1024, n_geo_points=1024, n_map_points=2048,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=3)
# the settings the replays run with: each transfer codec, and the int16
# codec with the slide merged into the scan step
CODECS = {
    "f32": dict(quantize_transfer=False),
    "int16": dict(),
    "range": dict(range_transfer=True),
    "int16_merged": dict(merge_marginalize=True),
}
LIDAR = dict(n_rows=8, n_cols=128)
WIN_KW = dict(K=4)
# 1 m voxels: at 8x128 rays a 0.4 m grid gets under one point per voxel
# per scan, so the first scans track on ~10 inliers and both packages'
# replays go chaotic; at 1 m every scan has 200+ inliers
MAP_KW = dict(leaf_size=1.0, capacity_log2=13, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
N_CARRY = 4          # add_scan calls before the carried state: init + 3


def _ray_dirs(codec):
    if not CODECS[codec].get("range_transfer"):
        return None
    return tsyn.beam_dirs(tsyn.LidarModel(**LIDAR))[0]


def _port_sequencer(codec="f32"):
    return tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW, **CODECS[codec]),
                          twin.WindowConfig(**WIN_KW),
                          tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(**GEO_KW), device="cpu",
                          ray_dirs=_ray_dirs(codec))


def _jax_state(s):
    """A JAX Sequencer's state in convert's numpy layout."""
    st = {name: {k: np.asarray(v) for k, v in getattr(s, name)._asdict()
                 .items()} for name in ("window", "vmap", "preints")}
    st.update({name: np.asarray(getattr(s, name))
               for name in convert.SEQ_ARRAYS})
    st["host"] = {k: copy.deepcopy(getattr(s, k)) for k in convert.SEQ_HOST}
    st["imu"] = dict(ts=s.imu.ts.copy(), acc=s.imu.acc.copy(),
                     gyro=s.imu.gyro.copy())
    return st


@pytest.fixture(scope="module", params=sorted(CODECS))
def jax_replay(request, tmp_path_factory):
    """The short room replay through the JAX package with one of
    ``CODECS``, with its state snapshot before and after the
    (N_CARRY+1)-th scan."""
    return build_once(tmp_path_factory,
                      f"test_torch_slice.jax_replay.{request.param}",
                      lambda: _jax_replay(request.param))


def _jax_replay(codec):
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=3.0), tsyn.LidarModel(**LIDAR), seed=0)
    s = jseq.Sequencer(jseq.SequencerConfig(**SEQ_KW, **CODECS[codec]),
                       jwin.WindowConfig(**WIN_KW),
                       jvh.VoxelMapConfig(**MAP_KW),
                       jgeo.GeometricConfig(**GEO_KW), dtype=jnp.float32,
                       ray_dirs=_ray_dirs(codec))
    imu_i = 0
    snaps = {}
    for k in range(len(data["scans"])):
        if k == N_CARRY:
            snaps["before"] = (_jax_state(s), imu_i)
        imu_i = trep.feed(s, data, k, imu_i)
        if k == N_CARRY:
            snaps["after"] = _jax_state(s)
    return dict(codec=codec, data=data, snaps=snaps,
                trajectory=s.trajectory, counters=dict(s.counters))


def _close(out, ref, rtol, floor):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30))


def test_carried_state_scan_step_matches_jax(jax_replay):
    """From the JAX state after init + 3 scans (the window is then full, so
    the step also marginalizes), one add_scan in each package."""
    data = jax_replay["data"]
    before, imu_i = jax_replay["snaps"]["before"]
    ref = jax_replay["snaps"]["after"]
    s = convert.load_sequencer_state(_port_sequencer(jax_replay["codec"]),
                                     before)
    assert s.n_active == WIN_KW["K"]
    trep.feed(s, data, N_CARRY, imu_i)
    out = convert.sequencer_state(s)
    assert out["host"] == ref["host"]

    # window: GN from the same state, f32 sums in another order
    w, wr = out["window"], ref["window"]
    for k in ("q", "p", "v", "g_dir", "lin_q", "lin_p", "lin_v"):
        np.testing.assert_allclose(w[k], wr[k], atol=1e-4)
    for k in ("bg", "ba", "lin_bg", "lin_ba"):
        np.testing.assert_allclose(w[k], wr[k], atol=1e-4)
    np.testing.assert_array_equal(w["active"], wr["active"])
    _close(w["H_prior"], wr["H_prior"], rtol=1e-2, floor=1e-4)

    # map: the same voxels, counts and plane flags; f32 moment sums
    m, mr = out["vmap"], ref["vmap"]
    for k in ("coords", "occupied", "last_touch", "plane_valid"):
        np.testing.assert_array_equal(m[k][:-1], mr[k][:-1])
    np.testing.assert_array_equal(m["n"], mr["n"])
    for k in ("psum", "pssum", "mean"):
        _close(m[k], mr[k], rtol=1e-4, floor=1e-5)
    # valid planes: the same normal up to its sign (the sign is arbitrary
    # and cancels in J r and J J^T); other voxels' normals are unused
    ok = mr["plane_valid"]
    assert ok.sum() > 50
    np.testing.assert_allclose(
        np.abs(np.sum(m["normal"][ok] * mr["normal"][ok], axis=-1)), 1.0,
        atol=1e-4)

    # the scan's debug row: counts and flags exact, the absorbed pose
    # information and IMU eigenvalues to f32 precision of the solve
    row, rowr = out["debug_rec"][N_CARRY - 1], ref["debug_rec"][N_CARRY - 1]
    assert row[0] > 300
    np.testing.assert_array_equal(row[:5], rowr[:5])
    np.testing.assert_array_equal(row[6:17], rowr[6:17])
    np.testing.assert_allclose(row[5], rowr[5], rtol=1e-3)
    _close(row[17:38], rowr[17:38], rtol=1e-3, floor=1e-4)
    _close(row[38:47], rowr[38:47], rtol=1e-2, floor=1e-4)
    np.testing.assert_allclose(out["traj_p"], ref["traj_p"], atol=1e-4)


def test_short_replay_ate_matches_jax(jax_replay):
    data = jax_replay["data"]
    s = _port_sequencer(jax_replay["codec"])
    trep.replay(s, data)
    assert s.counters == jax_replay["counters"]
    ate_t = trep.trajectory_ate(s, data)
    jt = jax_replay["trajectory"]
    ate_j = tsyn.ate_rmse(np.asarray([t for t, _, _ in jt]),
                          np.asarray([p for _, p, _ in jt]),
                          data["gt"]["ts"], data["gt"]["pos"])
    pt = np.asarray([p for _, p, _ in s.trajectory])
    pj = np.asarray([p for _, p, _ in jt])
    print(f"short replay, {jax_replay['codec']}: ATE port {ate_t:.5f} m, "
          f"JAX {ate_j:.5f} m; "
          f"largest pose difference {np.abs(pt - pj).max():.2e} m")
    assert ate_t < 0.10 and ate_j < 0.10
    assert abs(ate_t - ate_j) < 0.005


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        # matplotlib unimportable: only the render calls of io.viz need it
        "sys.modules['matplotlib'] = None\n"
        "import mimosa_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, "
        "'mimosa_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'mimosa_tpu' or "
        "k.startswith('mimosa_tpu.'))\n"
        "for n in ('lidar.photometric', 'radar.factor', "
        "'odometry.factor', 'utils.evaluation', 'imu.propagation', "
        "'io.online', 'io.rosbag', 'io.rosbag_writer', 'io.pointcloud2', "
        "'config.loader', 'utils.checkpoint', 'io.replay'):\n"
        "    assert 'mimosa_tpu_torch.' + n in names, names\n"
        # the bulk scheduler, beside the streaming paths
        "from mimosa_tpu_torch.graph.sequencer import Sequencer\n"
        "for f in ('add_bulk', 'add_scans_bulk', '_run_bulk_chunk', "
        "'_run_bulk_chunk_mm', '_pack_scan_row'):\n"
        "    assert callable(getattr(Sequencer, f)), f\n"
        "from mimosa_tpu_torch.io import replay, synthetic_replay\n"
        "import inspect\n"
        # every replay option is ported: the debug stream last
        "assert not hasattr(replay, 'NOT_PORTED')\n"
        "assert {'bulk', 'two_pass', 'smooth', 'debug_stream'} <= set("
        "inspect.signature(replay.replay_bag).parameters)\n"
        "for n in ('io.viz',):\n"
        "    assert 'mimosa_tpu_torch.' + n in names, names\n"
        "from mimosa_tpu_torch.io import viz\n"
        "for f in ('DebugStream', 'icp_snapshot', 'render_correspondences', "
        "'render_feature_overlay', 'feature_overlay_arrays'):\n"
        "    assert callable(getattr(viz, f)), f\n"
        "from mimosa_tpu_torch.io.synthetic import generate_ouster\n"
        "from mimosa_tpu_torch.lidar.geometric import linearize_binary\n"
        # the offline refinement (item 13)
        "for n in ('graph.refine', 'parallel.window_shard'):\n"
        "    assert 'mimosa_tpu_torch.' + n in names, names\n"
        "assert {'two_pass', 'smooth'} <= set(inspect.signature("
        "synthetic_replay.run).parameters)\n"
        "assert 'init_map' in inspect.signature(Sequencer).parameters\n"
        # the mesh and the step cache (item 14)
        "assert 'mimosa_tpu_torch.parallel.sharded' in names, names\n"
        "assert {'mesh', 'step_cache'} <= set(inspect.signature("
        "Sequencer).parameters)\n"
        "assert 'step_cache' in inspect.signature("
        "synthetic_replay.run).parameters\n"
        "assert callable(synthetic_replay.bulk_stream)\n"
        "assert len(names) > 12, names\n"
        "assert not bad, bad\n"
        "assert sys.modules['matplotlib'] is None\n"
        # PyYAML only inside config.loader.load_reference_yaml
        "assert 'yaml' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr


def test_sequencer_refuses_unported_settings():
    """Rescue, rematch and the frozen map are ported: each setting
    constructs on the CPU and reaches the scan step's function; the default
    configuration is the JAX package's (the int16 codec with its dither),
    and the range codec needs its beam table."""
    for kw in (dict(rescue_enabled=True), dict(rematch_on_motion=True),
               dict(rescue_enabled=True, rematch_on_motion=True),
               dict(freeze_map=True)):
        s = tseq.Sequencer(tseq.SequencerConfig(**kw), device="cpu")
        for key in (("scan", False, True), ("scan", True, False)):
            step = s._step_fn(key)
            assert step.func is tseq._scan_state_step
            for k, v in kw.items():
                assert getattr(step.keywords["seq_cfg"], k) == v
    with pytest.raises(ValueError, match="ray_dirs"):
        tseq.Sequencer(tseq.SequencerConfig(range_transfer=True),
                       device="cpu")
    s = tseq.Sequencer(device="cpu")
    assert s.cfg == tseq.SequencerConfig()
    assert s.cfg.quantize_transfer and s.cfg.quant_dither
    assert s._dither_dev.shape == (s.cfg.max_scan_points, 3)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device the Sequencer (the streaming entry points and the
    bulk scheduler, ``add_bulk``, alike), the replay and the bag replay in
    bulk mode take the first CUDA device and raise where there is none;
    device="cpu" is the caller's explicit choice."""
    from mimosa_tpu_torch.io import replay as treplay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseq.Sequencer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trep.run(verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.replay_bag("absent.bag", "absent.yaml", "/imu", "/points",
                           bulk=True)
    s = tseq.Sequencer(device="cpu")
    s.add_bulk([])
    assert s.device == torch.device("cpu") and s.bulk_counts["chunks"] == 0


def test_replay_cli_defaults_to_the_card():
    """``python -m mimosa_tpu_torch.io.synthetic_replay`` with no
    ``--device`` asks for the card and fails without one."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['synthetic_replay', '--t-total', '0.3']\n"
            "import runpy\n"
            "runpy.run_module('mimosa_tpu_torch.io.synthetic_replay', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=40)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_replay_runs_on_the_cpu_when_asked():
    out = trep.run(device="cpu", t_total=2.0, verbose=False)
    assert out["sequencer"].device == torch.device("cpu")
    assert out["n_scans"] == 9 and out["sequencer"].scan_idx == 8
    assert out["ate"] < 0.010            # the room_clean gate


def test_add_imu_batch_matches_add_imu():
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=0.5), tsyn.LidarModel(n_rows=2, n_cols=16), seed=2)
    imu = data["imu"]
    one, batch = _port_sequencer(), _port_sequencer()
    for ts, acc, gyro in zip(imu["ts"], imu["acc"], imu["gyro"]):
        one.add_imu(ts, acc, gyro)
    batch.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    assert len(imu["ts"]) == 100
    for k in ("ts", "acc", "gyro"):
        np.testing.assert_array_equal(getattr(batch.imu, k),
                                      getattr(one.imu, k))


def test_sequencer_cpu_run_launches_no_kernel(tmp_path):
    """On CPU tensors the step takes the plain ICP version every time; the
    run's trajectory, TUM log and debug records are complete."""
    from mimosa_tpu_torch.ops import icp_cuda

    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=1.6), tsyn.LidarModel(n_rows=8, n_cols=128), seed=1)
    before = icp_cuda.LAUNCHES
    s = _port_sequencer()
    trep.replay(s, data)
    assert s.scan_idx >= 2
    assert icp_cuda.LAUNCHES == before
    traj = np.asarray([p for _, p, _ in s.trajectory])
    assert np.isfinite(traj).all() and len(traj) == len(s._traj_ts)
    assert torch.isfinite(s.window.H_prior).all()
    dbg = s.debug_records()
    assert dbg.shape == (s.scan_idx, 17)
    assert (dbg[:, 0] > 0).all() and (dbg[:, 0] == dbg[:, 1]).all()
    s.write_tum(tmp_path / "traj.tum")
    rows = np.loadtxt(tmp_path / "traj.tum")
    assert rows.shape == (len(traj), 8)
    np.testing.assert_allclose(rows[:, 1:4], traj, rtol=1e-6)
    # TUM orders the quaternion x y z w
    q = np.asarray([q for _, _, q in s.trajectory])
    np.testing.assert_allclose(rows[:, 4:], q[:, [1, 2, 3, 0]], rtol=1e-6)
