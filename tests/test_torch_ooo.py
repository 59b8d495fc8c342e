"""The port's out-of-order insertion, radar and odometry steps, and the
four-modality stream, against the JAX package.

* ``insert_state_at`` at every insert position of a K = 6 window, and
  ``_insert_preint_segments``: permutations, so bitwise equal to JAX on f32
  inputs; the radar and odometry index helpers equal;
* one stream through both packages: a 3 s room sequence from a 16x256
  LiDAR with 20 Hz radar and 10 Hz odometry, their clocks 15 ms out of
  phase with the LiDAR's, and late and re-ordered arrivals of each kind
  (``io.synthetic_replay.four_modality_stream``: late radar frames, scans
  delivered again late, swapped scans, a same-key duplicate, odometry
  right after a scan and an odometry outage). Counters,
  ``state_ts``, the trajectory's timestamps and ``window.ts`` identical; the
  ATE pair compared as ``test_short_replay_ate_matches_jax`` does (both
  under 0.08 m, the dropout_ooo gate, and within 5 mm of each other);
* the carried-state step of each new variant: the JAX state just before
  the first event of each kind in that stream, loaded into the port
  (``mimosa_tpu_torch.convert``, the odometry anchor included), then that
  event in the port, against the JAX state after it. Tolerances of
  ``test_torch_slice.py::test_carried_state_scan_step_matches_jax``:
  window states and trajectory rows within 1e-4 (the accelerometer bias
  after a radar step within 5e-4), the prior within rtol 1e-2 and 1e-3
  of its largest entry (the measured f32 errors are in the test),
  activity, timestamps, map counts and flags exact;
  preintegrated segments (identical f32 IMU rows and biases, summed in
  another order) within rtol 1e-4 of their scale.

The JAX Sequencer runs with 64-bit types off, as the JAX package runs in
production.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.imu import preintegration as jpre
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.imu import preintegration as tpre
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh

from torch_fixtures import build_once, one_thread_then_free_programs  # noqa: F401


def _jax(fn, *args, **kw):
    with jax.enable_x64(False):
        return jax.jit(fn, **kw)(*args)


def _close(out, ref, rtol, floor):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------ window insertion

K_INS = 6


def _window_pair(rng):
    """A K = 6 window with 5 active states and a dense prior, as f32 numpy
    fields, in both packages."""
    K = K_INS
    cfg = twin.WindowConfig(K=K)
    D = cfg.D
    q = rng.normal(size=(K, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    H = rng.normal(size=(D, D))
    f = dict(q=q, p=rng.normal(size=(K, 3)), v=rng.normal(size=(K, 3)),
             bg=rng.normal(size=(K, 3)) * 1e-3,
             ba=rng.normal(size=(K, 3)) * 1e-2,
             g_dir=np.array([0.01, -0.02, -1.0]) / np.linalg.norm(
                 [0.01, -0.02, -1.0]),
             ts=np.arange(K) * 0.05, active=np.arange(K) < K - 1,
             H_prior=H @ H.T, b_prior=rng.normal(size=D),
             lin_q=q, lin_p=rng.normal(size=(K, 3)),
             lin_v=rng.normal(size=(K, 3)),
             lin_bg=rng.normal(size=(K, 3)) * 1e-3,
             lin_ba=rng.normal(size=(K, 3)) * 1e-2,
             lin_g=np.array([0.0, 0.0, -1.0]))
    f = {k: v if v.dtype == bool else v.astype(np.float32)
         for k, v in f.items()}
    jw = jwin.Window(**{k: jnp.asarray(v) for k, v in f.items()})
    tw = twin.Window(**{k: torch.from_numpy(np.array(v))
                        for k, v in f.items()})
    return jw, tw, cfg


@pytest.mark.parametrize("pos", range(1, K_INS - 1))
def test_insert_state_at_is_bitwise_jax(pos):
    rng = np.random.default_rng(pos)
    jw, tw, cfg = _window_pair(rng)
    new = [rng.normal(size=n).astype(np.float32) for n in (4, 3, 3, 3, 3)]
    new[0] /= np.linalg.norm(new[0])
    ref = _jax(jwin.insert_state_at, jw, jnp.asarray(pos, jnp.int32),
               *map(jnp.asarray, new), 0.0, jwin.WindowConfig(K=cfg.K),
               static_argnums=(8,))
    out = twin.insert_state_at(tw, torch.tensor(pos), *map(torch.from_numpy,
                                                          new), 0.0, cfg)
    for k in twin.Window._fields:
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)),
                                      err_msg=k)
    assert out.active.sum() == K_INS
    # the inserted block carries no prior; gravity keeps its own
    i = pos * twin.SD + np.arange(twin.SD)
    assert not out.H_prior[i].any() and not out.b_prior[i].any()
    assert int(twin.newest_slot(out)) == \
        int(_jax(jwin.newest_slot, ref)) == K_INS - 1


@pytest.mark.parametrize("pos", range(1, K_INS - 1))
def test_insert_preint_segments_is_bitwise_jax(pos):
    rng = np.random.default_rng(10 + pos)
    k1 = K_INS - 1

    def rand(shape):
        return rng.normal(size=shape).astype(np.float32)

    def segs(lead):
        return {k: rand(lead + tuple(s)) for k, s in (
            ("dq", (4,)), ("dv", (3,)), ("dp", (3,)), ("dt", ()),
            ("J_dr_bg", (3, 3)), ("J_dv_bg", (3, 3)), ("J_dv_ba", (3, 3)),
            ("J_dp_bg", (3, 3)), ("J_dp_ba", (3, 3)), ("cov", (9, 9)),
            ("bg", (3,)), ("ba", (3,)))}

    chain, a, b = segs((k1,)), segs(()), segs(())
    fv = np.arange(k1) < pos + 1
    jp, jf = _jax(jseq._insert_preint_segments,
                  jpre.PreintState(**{k: jnp.asarray(v)
                                      for k, v in chain.items()}),
                  jnp.asarray(fv), jnp.asarray(pos, jnp.int32),
                  *(jpre.PreintState(**{k: jnp.asarray(v)
                                        for k, v in s.items()})
                    for s in (a, b)))
    tp, tf = tseq._insert_preint_segments(
        tpre.PreintState(**{k: torch.from_numpy(v)
                            for k, v in chain.items()}),
        torch.from_numpy(fv), torch.tensor(pos),
        *(tpre.PreintState(**{k: torch.from_numpy(np.array(v))
                              for k, v in s.items()}) for s in (a, b)))
    for k in tpre.PreintState._fields:
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("slots", [(0, 1), (2, 5), (4, 3)])
def test_factor_index_helpers_match_jax(slots):
    i, j = slots
    np.testing.assert_array_equal(
        twin.rot_vel_bg_idx(torch.tensor(j)).numpy(),
        np.asarray(jwin.rot_vel_bg_idx(j)))
    np.testing.assert_array_equal(
        twin.between_pose_idx(torch.tensor(i), torch.tensor(j)).numpy(),
        np.asarray(jwin.between_pose_idx(jnp.asarray(i), jnp.asarray(j))))


# ------------------------------------------------- the four-modality stream

SEQ_KW = dict(max_scan_points=4096, n_geo_points=2048, n_map_points=4096,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=2)
WIN_KW = dict(K=6)
MAP_KW = dict(leaf_size=0.4, capacity_log2=15, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
ATE_GATE = 0.080          # the dropout_ooo row's gate
# the events whose steps are carried across, by what they run
KINDS = ("radar_declare", "radar_attach", "radar_samekey", "radar_ooo",
         "odom_declare", "odom_attach", "declare", "scan_ooo",
         "scan_ooo_samekey")


def _stream():
    """(data, events) of the shared stream (see the module doc)."""
    return trep.four_modality_stream(
        tsyn.TrajectoryConfig(t_total=3.0, t_stationary=1.23),
        tsyn.LidarModel())


def _port_sequencer():
    return tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW),
                          twin.WindowConfig(**WIN_KW),
                          tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(**GEO_KW), device="cpu")


def _jax_state(s):
    st = {name: {k: np.asarray(v) for k, v in getattr(s, name)._asdict()
                 .items()} for name in ("window", "vmap", "preints")}
    st.update({name: np.asarray(getattr(s, name))
               for name in convert.SEQ_ARRAYS})
    st["host"] = {k: copy.deepcopy(getattr(s, k)) for k in convert.SEQ_HOST}
    st["host"].update(convert.sensor_host(s))
    st["imu"] = dict(ts=s.imu.ts.copy(), acc=s.imu.acc.copy(),
                     gyro=s.imu.gyro.copy())
    return st


def _kind(event, before, s):
    """What the event ran: one of ``KINDS`` or None, from the host state
    before it (counters, newest state time, trajectory length) and
    after."""
    c0, newest0, rows0 = before
    c = s.counters

    def grew(key):
        return c.get(key, 0) > c0.get(key, 0)

    declared = s.last_state_ts != newest0
    logged = len(s._traj_ts) > rows0
    kind = event[1]
    if kind == "scan":
        return ("scan_ooo" if grew("scans_ooo_inserted") else
                "scan_ooo_samekey" if grew("scans_ooo_samekey") else None)
    if kind == "radar":
        return ("radar_samekey" if grew("radar_ooo_samekey") else
                "radar_ooo" if grew("radar_ooo_inserted") else
                None if not logged else
                "radar_declare" if declared else "radar_attach")
    if logged:
        return "odom_declare" if declared else "odom_attach"
    return "declare" if grew("odom_anchor") and declared else None


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """The stream through the JAX package, with the state before and after
    the first event of each of ``KINDS`` (a slide of a full window
    included where the event made one)."""
    return build_once(tmp_path_factory, "test_torch_ooo.jax_stream",
                      _jax_stream)


def _jax_stream():
    data, events = _stream()
    snaps = {}
    with jax.enable_x64(False):
        s = jseq.Sequencer(jseq.SequencerConfig(**SEQ_KW),
                           jwin.WindowConfig(**WIN_KW),
                           jvh.VoxelMapConfig(**MAP_KW),
                           jgeo.GeometricConfig(**GEO_KW), dtype=jnp.float32,
                           step_cache={})
        imu_i = 0
        for ev in events:
            before = None
            if s.initialized and len(snaps) < len(KINDS):
                before = (_jax_state(s), imu_i)
            host = (dict(s.counters), s.last_state_ts, len(s._traj_ts))
            imu_i = trep.feed_event(s, data, ev, imu_i)
            kind = _kind(ev, host, s)
            if before is not None and kind is not None \
                    and kind not in snaps:
                snaps[kind] = (*before, ev, _jax_state(s))
        traj = s.trajectory
        out = dict(data=data, events=events, snaps=snaps, trajectory=traj,
                   counters=dict(s.counters), state_ts=list(s.state_ts),
                   traj_ts=list(s._traj_ts), window_ts=np.asarray(s.window.ts))
    return out


def test_four_modality_stream_matches_jax(jax_stream):
    data = jax_stream["data"]
    s = _port_sequencer()
    imu_i = 0
    for ev in jax_stream["events"]:
        imu_i = trep.feed_event(s, data, ev, imu_i)
    c = s.counters
    assert c == jax_stream["counters"]
    # every late path ran, and no late scan was dropped
    for k in ("radar_ooo_inserted", "radar_ooo_samekey", "scans_ooo_inserted",
              "scans_ooo_samekey", "scans_same_key", "odom_anchor"):
        assert c[k] > 0, (k, c)
    assert c["scans_dropped_ooo"] == 0
    assert s.state_ts == jax_stream["state_ts"]
    assert s._traj_ts == jax_stream["traj_ts"]
    np.testing.assert_array_equal(s.window.ts.numpy(),
                                  jax_stream["window_ts"])
    ate_t = trep.trajectory_ate(s, data)
    jt = jax_stream["trajectory"]
    ate_j = tsyn.ate_rmse(np.asarray([t for t, _, _ in jt]),
                          np.asarray([p for _, p, _ in jt]),
                          data["gt"]["ts"], data["gt"]["pos"])
    pt = np.asarray([p for _, p, _ in s.trajectory])
    pj = np.asarray([p for _, p, _ in jt])
    print(f"four-modality stream: ATE port {ate_t:.5f} m, JAX {ate_j:.5f} m; "
          f"largest pose difference {np.abs(pt - pj).max():.2e} m; {c}")
    assert ate_t < ATE_GATE and ate_j < ATE_GATE
    assert abs(ate_t - ate_j) < 0.005


@pytest.mark.parametrize("kind", KINDS)
def test_carried_state_step_matches_jax(jax_stream, kind):
    """From the JAX state just before the first event of ``kind``, that
    event in the port: the same window, preintegrated segments, factor
    flags, map and trajectory rows as the JAX step. The odometry kinds
    start mid-odometry-stream, so the carried anchor (``_odom_prev``) sets
    the between factor they make."""
    before, imu_i, event, ref = jax_stream["snaps"][kind]
    if kind.startswith("odom"):
        assert before["host"]["_odom_prev"]["slot"] >= 0
    s = convert.load_sequencer_state(_port_sequencer(), before)
    trep.feed_event(s, jax_stream["data"], event, imu_i)
    out = convert.sequencer_state(s)
    assert out["host"] == ref["host"]

    w, wr = out["window"], ref["window"]
    # ba is the window's weakest direction: after a radar step on this
    # stream JAX's own f32 step lands up to 3.7e-4 from the same step in
    # f64 (the port's f32 step 1.2e-4), so there it is held to 5e-4
    ba_tol = 5e-4 if kind.startswith("radar") else 1e-4
    for k in ("q", "p", "v", "g_dir", "bg", "ba", "lin_q", "lin_p", "lin_v",
              "lin_bg", "lin_ba"):
        np.testing.assert_allclose(w[k], wr[k], err_msg=k,
                                   atol=ba_tol if "ba" in k else 1e-4)
    np.testing.assert_array_equal(w["active"], wr["active"])
    np.testing.assert_array_equal(w["ts"], wr["ts"])
    # a slide and an insertion in one event: each package's f32 prior
    # lands up to 8.5e-4 of its largest entry from the same step in f64
    _close(w["H_prior"], wr["H_prior"], rtol=1e-2, floor=1e-3)
    for k in tpre.PreintState._fields:
        _close(out["preints"][k], ref["preints"][k], rtol=1e-4, floor=1e-4)
    np.testing.assert_array_equal(out["fv"], ref["fv"])

    m, mr = out["vmap"], ref["vmap"]
    for k in ("coords", "occupied", "last_touch", "plane_valid", "n"):
        np.testing.assert_array_equal(m[k][:-1], mr[k][:-1], err_msg=k)
    for k in ("psum", "pssum", "mean"):
        _close(m[k], mr[k], rtol=1e-4, floor=1e-5)
    np.testing.assert_array_equal(out["kf_count"], ref["kf_count"])
    np.testing.assert_allclose(out["traj_q"], ref["traj_q"], atol=1e-4)
    np.testing.assert_allclose(out["traj_p"], ref["traj_p"], atol=1e-4)
    if kind.startswith("scan"):
        row = before["host"]["scan_idx"]
        d, dr = out["debug_rec"][row], ref["debug_rec"][row]
        assert d[0] > 100
        np.testing.assert_array_equal(d[:5], dr[:5])
        np.testing.assert_array_equal(d[6:17], dr[6:17])
    else:
        np.testing.assert_array_equal(out["debug_rec"], ref["debug_rec"])
