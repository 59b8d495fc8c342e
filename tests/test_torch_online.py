"""The port's online estimator (``io/online.py``) and checkpoint
(``utils/checkpoint.py``) on the CPU.

* ``tests/test_online.py``'s cases on the port: the threaded estimator gives
  the offline loop's trajectory (the same timestamps, positions within
  1e-6 m), backpressure drops, a bad event leaves the worker alive, and
  staging on the worker thread, with a debug stream emitted on the
  worker;
* the port's online trajectory against the JAX package's
  ``OnlineEstimator`` on the same pushes: the same state times, both ATEs
  under 0.08 m and within 5 mm of each other (the estimator is chaotic
  near tracking loss, so runs of the two packages are compared by ATE;
  the largest position gap is printed, not gated);
* checkpoint: a replay saved at half-time and resumed in a fresh Sequencer
  equals the uninterrupted replay (1e-5, ``tests/test_checkpoint.py``'s
  tolerance).

The sequence is the 3 s room from a 16x256 LiDAR; the JAX side runs once,
in one fixture that one test uses.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.io import online as jonline
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import online as tonline
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.io.viz import DebugStream
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.utils import checkpoint as ckpt

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

ATE_GATE = 0.08        # tests/test_online.py's sequence gate (room_noisy)
ATE_PAIR = 0.005       # [m] the two packages' ATEs apart


SEQ_KW = dict(max_scan_points=4096, n_geo_points=4096, n_map_points=8192,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=2)
MAP_KW = dict(leaf_size=0.4, capacity_log2=17, plane_min_points=5,
              lru_horizon=0)


def _port_sequencer(K=6):
    """tests/test_online.py's Sequencer, on the CPU."""
    return tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW),
                          twin.WindowConfig(K=K), tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(sigma=0.05,
                                               loc_count_thresh=50.0),
                          device="cpu")


def _jax_sequencer():
    return jseq.Sequencer(
        seq_cfg=jseq.SequencerConfig(**SEQ_KW), win_cfg=jwin.WindowConfig(K=6),
        map_cfg=jvh.VoxelMapConfig(**MAP_KW),
        geo_cfg=jgeo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        dtype=jnp.float32)


@pytest.fixture(scope="module")
def data():
    return tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(t_total=3.0),
                         tsyn.LidarModel(), seed=0)


def _feed(s, scans, imu, ii=0):
    """tests/test_online.py's offline loop: the IMU up to each scan's end
    + 30 ms, then the scan. Returns the next IMU index."""
    for scan in scans:
        t_end = scan["ts_header"] + scan["t_rel"].max()
        while ii < len(imu["ts"]) and imu["ts"][ii] <= t_end + 0.03:
            s.add_imu(imu["ts"][ii], imu["acc"][ii], imu["gyro"][ii])
            ii += 1
        s.add_scan(scan["ts_header"], scan["points"], scan["t_rel"],
                   scan["valid"])
    return ii


def _traj(s):
    tr = s.trajectory
    return (np.array([t for t, _, _ in tr]), np.array([p for _, p, _ in tr]))


def _online(estimator_cls, seq, data):
    """tests/test_online.py's online run: IMU and scans pushed in arrival
    order (a scan at its header time, so the holdback must reorder), the
    worker caught up at every scan. Returns (estimator, propagated outputs,
    graph-rate states)."""
    prop_out, states = [], []
    est = estimator_cls(
        seq, on_propagated=lambda ts, q, p, v: prop_out.append((ts, p)),
        on_state=lambda ts, q, p, v, bg, ba, g: states.append((ts, p)),
        collection_slack=0.03, max_pending_scans=10_000)
    events = [("imu", t, i) for i, t in enumerate(data["imu"]["ts"])]
    events += [("scan", sc["ts_header"], sc) for sc in data["scans"]]
    events.sort(key=lambda e: e[1])
    for kind, _, x in events:
        if kind == "imu":
            est.push_imu(data["imu"]["ts"][x], data["imu"]["acc"][x],
                         data["imu"]["gyro"][x])
        else:
            assert est.push_scan(x["ts_header"], x["points"], x["t_rel"],
                                 x["valid"])
            assert est.flush(timeout=120.0)
    return est, prop_out, states


@pytest.fixture(scope="module")
def offline(data):
    s = _port_sequencer()
    _feed(s, data["scans"], data["imu"])
    return s


@pytest.fixture(scope="module")
def online(data):
    est, prop_out, states = _online(tonline.OnlineEstimator,
                                    _port_sequencer(), data)
    mid = (est.current_state(), est.current_pose())
    est.stop(drain=True)
    assert not est._worker.is_alive()
    return est, prop_out, states, mid


def test_online_matches_offline(data, offline, online):
    """Pushing the same event stream through the threaded estimator gives the
    offline loop's trajectory: the worker's collection-delay holdback
    replicates the offline ordering."""
    est, prop_out, states, (cs_mid, cp_mid) = online
    # the thread-safe query surface while running
    assert cs_mid is not None and cs_mid.ts <= est.seq.last_state_ts
    assert cp_mid is not None and cp_mid[0] >= cs_mid.ts
    assert est.counters["scans_dropped_backlog"] == 0
    cs = est.current_state()
    np.testing.assert_allclose(cs.p, est.seq.current_state().p, atol=1e-6)
    t_off, p_off = _traj(offline)
    t_on, p_on = _traj(est.seq)
    np.testing.assert_allclose(t_on, t_off, atol=0)
    np.testing.assert_allclose(p_on, p_off, atol=1e-6)
    assert trep.trajectory_ate(est.seq, data) < ATE_GATE
    # graph-rate output fired, and the high-rate path stays near the
    # optimized trajectory (tests/test_online.py's bound)
    assert est.counters["rebases"] > 0 and len(states) > 0
    assert len(prop_out) > 0.25 * len(data["imu"]["ts"])
    errs = []
    for ts, p in prop_out:
        gi = np.searchsorted(t_on, ts)
        if 0 < gi < len(t_on) and t_on[gi] - t_on[gi - 1] < 0.5:
            a = (ts - t_on[gi - 1]) / (t_on[gi] - t_on[gi - 1])
            errs.append(np.linalg.norm(
                p - ((1 - a) * p_on[gi - 1] + a * p_on[gi])))
    assert len(errs) > 50
    assert np.median(errs) < 0.15


def test_online_matches_jax(data, online):
    """The JAX package's OnlineEstimator on the same pushes: the same state
    times and counters, both ATEs under the gate and within ATE_PAIR."""
    jest, _, jstates = _online(jonline.OnlineEstimator, _jax_sequencer(),
                               data)
    jest.stop(drain=True)
    est, _, states, _ = online
    tj, pj = _traj(jest.seq)
    tt, pt = _traj(est.seq)
    np.testing.assert_array_equal(tt, tj)
    assert est.counters == jest.counters
    assert est.seq.counters == jest.seq.counters
    assert [t for t, _ in states] == [t for t, _ in jstates]
    ate_j = trep.trajectory_ate(jest.seq, data)
    ate_t = trep.trajectory_ate(est.seq, data)
    print(f"online ATE: JAX {ate_j:.5f} m, port {ate_t:.5f} m, largest "
          f"position gap {np.abs(pt - pj).max():.2e} m")
    assert ate_j < ATE_GATE and ate_t < ATE_GATE
    assert abs(ate_j - ate_t) < ATE_PAIR


def test_online_backpressure_drops(data):
    est = tonline.OnlineEstimator(_port_sequencer(), max_pending_scans=0)
    sc = data["scans"][0]
    assert not est.push_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                             sc["valid"])
    assert est.counters["scans_dropped_backlog"] == 1
    est.stop(drain=False)
    assert not est._worker.is_alive()


def test_online_worker_survives_bad_event(caplog):
    """A malformed message does not kill the worker thread (the reference
    logs and continues, logCriticalException); an event that raises is
    logged as an ERROR record."""
    est = tonline.OnlineEstimator(_port_sequencer())
    with caplog.at_level(logging.ERROR, logger="mimosa_tpu_torch.io.online"):
        est.push_odometry(1.0, np.zeros(3), np.zeros(4))  # q/t swapped
        assert est.flush(timeout=5.0)
        assert est._worker.is_alive()
        assert not caplog.records      # dropped: not initialized yet
        est.push_imu(1.0, np.zeros(2), np.zeros(3))       # a 2-vector acc
        assert est.flush(timeout=5.0)
    assert est._worker.is_alive()
    est.stop(drain=True)
    assert [r.levelno for r in caplog.records] == [logging.ERROR]
    assert "imu event failed" in caplog.records[0].getMessage()


def test_online_worker_staging(data, offline, tmp_path):
    """stage_on_push=False stages on the worker thread; the trajectory
    equals the offline loop's. A debug stream of every scan, emitted on
    the worker after each scan, gives one line per scan step, each the
    offline loop's state after that scan."""
    # no collection slack: each scan runs as soon as it is pushed, after
    # the IMU the offline loop feeds before it
    stream = DebugStream(str(tmp_path / "online.jsonl"), every=1)
    est = tonline.OnlineEstimator(_port_sequencer(), max_pending_scans=10_000,
                                  stage_on_push=False, debug_stream=stream)
    imu, ii = data["imu"], 0
    for scan in data["scans"]:
        t_end = scan["ts_header"] + scan["t_rel"].max()
        while ii < len(imu["ts"]) and imu["ts"][ii] <= t_end + 0.03:
            est.push_imu(imu["ts"][ii], imu["acc"][ii], imu["gyro"][ii])
            ii += 1
        assert est.push_scan(scan["ts_header"], scan["points"],
                             scan["t_rel"], scan["valid"])
    est.stop(drain=True)
    assert est.seq.initialized
    assert len(est.seq.trajectory) > 5
    assert est.counters["rebases"] > 0
    t_w, p_w = _traj(est.seq)
    t_r, p_r = _traj(offline)
    np.testing.assert_array_equal(t_w, t_r)
    np.testing.assert_allclose(p_w, p_r, atol=1e-6)
    stream.close()
    lines = [json.loads(ln) for ln in open(stream.path)]
    assert [ln["scan"] for ln in lines] == \
        list(range(1, offline.scan_idx + 1))
    rec = offline.debug_records()
    for ln in lines:
        k = int(np.flatnonzero(t_r == ln["ts"])[0])
        np.testing.assert_allclose(ln["p"], p_r[k], rtol=0, atol=5.01e-5)
        assert ln["icp_inliers"] == int(rec[ln["scan"] - 1, 0])
    assert lines[-1]["counters"] == offline.counters


def test_online_refuses_the_debug_stream():
    """A debug stream that is not one is refused; a DebugStream is taken
    (test_online_worker_staging)."""
    with pytest.raises(TypeError, match="DebugStream"):
        tonline.OnlineEstimator(_port_sequencer(), debug_stream=object())


def test_checkpoint_resume_matches_uninterrupted(data, offline, tmp_path):
    """A replay saved after half its scans and resumed in a fresh
    Sequencer equals the uninterrupted replay (tests/test_checkpoint.py)."""
    scans, imu = data["scans"], data["imu"]
    half = len(scans) // 2
    s2 = _port_sequencer()
    ii = _feed(s2, scans[:half], imu)
    path = tmp_path / "ckpt.npz"
    ckpt.save(s2, path)
    s3 = _port_sequencer()
    ckpt.load(s3, path)
    assert s3.initialized and s3.scan_idx == s2.scan_idx
    assert s3.counters == s2.counters and s3.state_ts == s2.state_ts
    _feed(s3, scans[half:], imu, ii)
    t_ref, p_ref = _traj(offline)
    t3, p3 = _traj(s3)
    np.testing.assert_array_equal(t3, t_ref)
    np.testing.assert_allclose(p3, p_ref, atol=1e-5)


def test_checkpoint_carries_sensor_state(tmp_path):
    """The radar and odometry configurations and the odometry anchor travel
    with a checkpoint (their tuples come back as tuples, hashable as the
    step variants' keys need)."""
    from mimosa_tpu_torch.odometry.factor import OdometryConfig
    from mimosa_tpu_torch.radar.factor import RadarConfig

    s = _port_sequencer()
    s.radar_cfg = RadarConfig(sigma=0.04, q_b_r=(0.0, 1.0, 0.0, 0.0))
    s.odom_cfg = OdometryConfig(sigma_trans=0.01)
    s._odom_prev = dict(slot=2, q=np.array([1.0, 0, 0, 0]),
                        t=np.array([0.5, -1.0, 2.0]))
    ckpt.save(s, tmp_path / "c.npz")
    s2 = ckpt.load(_port_sequencer(), tmp_path / "c.npz")
    assert s2.radar_cfg == s.radar_cfg and s2.odom_cfg == s.odom_cfg
    hash(s2.radar_cfg)
    assert s2._odom_prev["slot"] == 2
    np.testing.assert_array_equal(s2._odom_prev["t"], s._odom_prev["t"])
