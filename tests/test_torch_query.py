"""The port's state-query API and end-to-end replays against the JAX package.

* On the same state (the JAX Sequencer's after a short room replay,
  carried into the port with ``mimosa_tpu_torch.convert``), every query
  (``current_state``, ``optimized_values``, ``state_upto``, ``pose_at``,
  ``num_keyframes``, ``imu_localizability_records``, ``pose_info_records``,
  ``last_icp``) gives the JAX package's answer exactly: the queries are
  host code over the same numbers.
* After the same replay through each package, the answers agree: the same
  timestamps, counts and flags; states within 5 mm / 5 mrad (the two runs
  sum in f32 in other orders and the estimator amplifies that, so poses
  are not bit-equal; ``tests/test_torch_slice.py`` gates the ATEs at 5 mm).
* The cases of ``tests/test_state_query.py`` and
  ``tests/test_e2e_synthetic.py`` on the port, at small widths (8x128
  LiDAR, 1024 points, K=5), with those tests' gates.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh

from torch_fixtures import build_once, one_thread_then_free_programs  # noqa: F401

SEQ_KW = dict(max_scan_points=1024, n_geo_points=1024, n_map_points=2048,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=2)
WIN_KW = dict(K=5)
# 1 m voxels: at 8x128 rays a finer grid gets too few points per voxel
MAP_KW = dict(leaf_size=1.0, capacity_log2=13, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
LIDAR = dict(n_rows=8, n_cols=128)


def _data(t_total=2.5, seed=0, **noise):
    return tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=t_total), tsyn.LidarModel(**LIDAR), seed=seed, **noise)


def _port(seq=None, geo=None):
    return tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW, **(seq or {})),
                          twin.WindowConfig(**WIN_KW),
                          tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(**GEO_KW, **(geo or {})),
                          device="cpu")


def _port_run(data, seq=None, geo=None):
    s = _port(seq, geo)
    trep.replay(s, data)
    return s


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX package's Sequencer after the short room replay: its state
    (convert's layout) and its answers to every query."""
    return build_once(tmp_path_factory, "test_torch_query.jax_run",
                      lambda: _jax_run(data))


def _jax_run(data):
    s = jseq.Sequencer(jseq.SequencerConfig(**SEQ_KW),
                       jwin.WindowConfig(**WIN_KW),
                       jvh.VoxelMapConfig(**MAP_KW),
                       jgeo.GeometricConfig(**GEO_KW), dtype=jnp.float32)
    trep.replay(s, data)
    st = {name: {k: np.asarray(v) for k, v in getattr(s, name)._asdict()
                 .items()} for name in ("window", "vmap", "preints")}
    st.update({name: np.asarray(getattr(s, name))
               for name in convert.SEQ_ARRAYS})
    st["host"] = {k: copy.deepcopy(getattr(s, k)) for k in convert.SEQ_HOST}
    st["imu"] = dict(ts=s.imu.ts.copy(), acc=s.imu.acc.copy(),
                     gyro=s.imu.gyro.copy())
    return dict(state=st, queries=_queries(s))


@pytest.fixture(scope="module")
def port_run(data):
    """The port after the same replay."""
    return _port_run(data), data


@pytest.fixture(scope="module")
def port_loaded(jax_run):
    """The port holding the JAX Sequencer's final state."""
    return convert.load_sequencer_state(_port(), jax_run["state"])


def _queries(s):
    """Every query's answer on ``s``, as plain numpy / Python values."""
    ts = s.state_ts
    traj_ts = [t for t, _, _ in s.trajectory]
    mid = 0.5 * (traj_ts[3] + traj_ts[4])
    return {
        "current_state": tuple(s.current_state()),
        "optimized_values": [tuple(v) for v in s.optimized_values()],
        "state_upto": [s.state_upto(t) for t in (
            ts[1] + 1e-6, ts[2], ts[0] - 1e-6, ts[0] - 5e-3, ts[-1] + 1.0)],
        "pose_at": [s.pose_at(t, interpolate=i) for t, i in (
            (traj_ts[0], False), (mid, True), (mid, False),
            (traj_ts[-1] + 10.0, False), (traj_ts[0] - 1.0, True))],
        "num_keyframes": s.num_keyframes,
        "imu_localizability_records": s.imu_localizability_records(),
        "pose_info_records": s.pose_info_records(),
        "last_icp": s.last_icp,
        "trajectory": s.trajectory,
    }


def _flat(x):
    """A nested answer as a list of numpy leaves and a structure key."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return [np.asarray(x if x is not None else np.nan)], repr(type(x))
    if isinstance(x, (tuple, list)):
        parts = [_flat(v) for v in x]
        return ([leaf for p in parts for leaf in p[0]],
                (type(x).__name__, len(x), tuple(p[1] for p in parts)))
    return [np.asarray(x)], ("array", np.shape(x))


QUERIES = ("current_state", "optimized_values", "state_upto", "pose_at",
           "num_keyframes", "imu_localizability_records",
           "pose_info_records", "last_icp", "trajectory")


@pytest.fixture(scope="module")
def answers(jax_run, port_loaded, port_run):
    return dict(jax=jax_run["queries"], loaded=_queries(port_loaded),
                replay=_queries(port_run[0]))


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax_on_the_same_state(answers, query):
    (ref, kr), (out, ko) = _flat(answers["jax"][query]), \
        _flat(answers["loaded"][query])
    assert ko == kr
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax_after_the_same_replay(answers, query):
    """Timestamps, counts and flags exact; states and poses within 5 mm
    (or 5%);
    the information matrices and IMU eigenvalues, which span 1e-3 .. 1e7,
    within 5% of their largest entry's scale."""
    (ref, kr), (out, ko) = _flat(answers["jax"][query]), \
        _flat(answers["replay"][query])
    assert ko == kr
    for o, r in zip(out, ref):
        if o.dtype == np.float32 and query in (
                "imu_localizability_records", "pose_info_records"):
            np.testing.assert_allclose(o, r, rtol=5e-2,
                                       atol=1e-4 * max(np.abs(r).max(), 1))
        elif (o.dtype.kind == "f" and o.ndim) or query == "last_icp":
            # last_icp: the inlier and status counts and mean |r| of two
            # registrations a few mm apart
            np.testing.assert_allclose(o, r, atol=5e-3, rtol=0.05)
        else:
            np.testing.assert_array_equal(o, r)


# ------------------------------------------- tests/test_state_query.py cases

def test_pre_init_queries_are_empty():
    s = _port()
    assert s.current_state() is None
    assert s.optimized_values() == []
    assert s.state_upto(1.0) is None
    assert s.pose_at(1.0) is None
    assert s.last_icp is None


def test_current_state_matches_trajectory_and_gt(port_run):
    s, data = port_run
    st = s.current_state()
    assert st.ts == s.state_ts[-1]
    np.testing.assert_allclose(np.linalg.norm(st.q), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(st.g_dir), 1.0, atol=1e-5)
    ts_t, p_t, q_t = s.trajectory[-1]
    assert ts_t == st.ts
    np.testing.assert_allclose(st.p, p_t, atol=1e-6)
    np.testing.assert_allclose(st.q, q_t, atol=1e-6)
    gt = data["gt"]
    assert trep.trajectory_ate(s, data) < 0.05
    assert len(gt["ts"]) == s.counters["scans"]


def test_optimized_values_cover_live_window(port_run):
    s, _ = port_run
    vals = s.optimized_values()
    assert len(vals) == s.n_active == WIN_KW["K"]
    ts = [v.ts for v in vals]
    assert ts == sorted(ts) and ts == s.state_ts[: s.n_active]
    cur = s.current_state()
    for k in ("p", "v", "bg"):
        np.testing.assert_array_equal(getattr(vals[-1], k), getattr(cur, k))


def test_state_upto_picks_rightmost_not_newer(port_run):
    s, _ = port_run
    assert s.state_upto(s.state_ts[1] + 1e-6).ts == s.state_ts[1]
    assert s.state_upto(s.state_ts[2]).ts == s.state_ts[2]
    # within the 4 ms grace below the oldest live state -> the oldest
    assert s.state_upto(s.state_ts[0] - 1e-6).ts == s.state_ts[0]
    assert s.state_upto(s.state_ts[0] - 5e-3) is None


def test_pose_at_full_log_and_interpolation(port_run):
    s, _ = port_run
    traj = s.trajectory
    assert len(traj) > s.n_active          # the log outlives the window
    ts0, p0, q0 = traj[0]                  # a marginalized state
    q_got, p_got = s.pose_at(ts0)
    np.testing.assert_array_equal(p_got, p0)
    np.testing.assert_array_equal(q_got, q0)
    assert s.pose_at(traj[-1][0] + 10.0) is None
    assert s.pose_at(ts0 - 1.0, interpolate=True) is None
    (ts_a, p_a, _), (ts_b, p_b, _) = traj[3], traj[4]
    q_m, p_m = s.pose_at(0.5 * (ts_a + ts_b), interpolate=True)
    np.testing.assert_allclose(p_m, 0.5 * (p_a + p_b), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(q_m), 1.0, atol=1e-5)
    assert np.all(p_m >= np.minimum(p_a, p_b) - 1e-5)
    assert np.all(p_m <= np.maximum(p_a, p_b) + 1e-5)


def test_log_ring_growth():
    """Runs longer than max_trajectory grow the device rings (and the
    trajectory survives), instead of clamping writes onto the last row."""
    data = _data(t_total=2.5, seed=1)
    s = _port_run(data, dict(max_trajectory=4))
    assert len(s._traj_ts) >= 9
    assert s.traj_q.shape[0] == 16        # outgrew the first capacity twice
    traj = s.trajectory
    assert len(traj) == len(s._traj_ts)
    assert s.debug_records().shape[0] == s.scan_idx
    p = np.asarray([pp for _, pp, _ in traj])
    assert np.linalg.norm(p[-1] - p[len(p) // 2]) > 1e-3
    assert np.linalg.norm(p[-1] - p[4]) > 1e-3
    assert trep.trajectory_ate(s, data) < 0.05


# --------------------------------------- tests/test_e2e_synthetic.py cases

def test_e2e_clean(port_run):
    s, data = port_run
    assert s.counters["scans_no_imu"] == 0
    assert s.num_keyframes > 5
    assert trep.trajectory_ate(s, data) < 0.05


def test_e2e_noisy_imu_and_range():
    data = _data(t_total=2.5, seed=3, imu_noise=0.02, range_noise=0.01)
    assert trep.trajectory_ate(_port_run(data), data) < 0.08


def test_e2e_deterministic():
    data = _data(t_total=1.8, seed=5)
    a, b = _port_run(data), _port_run(data)
    np.testing.assert_array_equal(
        np.asarray([p for _, p, _ in a.trajectory]),
        np.asarray([p for _, p, _ in b.trajectory]))


def test_e2e_4dof_registration():
    """ICP constrains only yaw and translation; roll and pitch ride on
    gravity and the IMU."""
    data = _data(t_total=2.5, seed=1, imu_noise=0.01, range_noise=0.005)
    s = _port_run(data, geo=dict(use_4dof=True))
    assert trep.trajectory_ate(s, data) < 0.08
