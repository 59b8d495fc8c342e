"""The port's radar Doppler and odometry factors, their generators and the
radar exposure gyro, against the JAX package; and a photometric
Sequencer's feature store through radar frames.

* the Doppler factor at N = 512 targets with NaN rows, low-SNR rows,
  out-of-range and out-of-cone rows and 10% outliers, with and without
  extrinsics: the valid mask equal exactly, residuals within atol 1e-5,
  H within rtol 1e-4 with a floor of 1e-5 of its largest entry, the
  inlier count exact. b = sum J w r cancels: JAX's own f32 b lands up to
  3.9e-4 of its largest entry from the same factor in f64 (12 seeded
  frames), so b is held to rtol 1e-4 with a floor of 5e-4;
* the odometry between factor: the relative measurement and H within
  rtol 1e-5 (a floor of 1e-5 of the largest entry); b within rtol 1e-5
  with a floor of 2e-4, since JAX's own f32 b lands up to 6.4e-5 of its
  largest entry from the same factor in f64 (poses 5 m apart, 16 seeded
  cases); the D-optimality gate within rtol 1e-9 (host numpy in both);
* ``generate_radar`` and ``generate_odometry`` within 1e-9, as
  ``test_generate_matches_jax`` holds ``generate``;
* ``ImuBuffer.mean_measurements``, ``t_last`` and ``len`` equal;
* radar frames leave a photometric Sequencer's feature store bitwise
  unchanged.

The JAX functions run jitted with 64-bit types off, as the JAX package
runs in production.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.imu.buffer import ImuBuffer as JBuf
from mimosa_tpu.io import synthetic as jsyn
from mimosa_tpu.odometry import factor as jodo
from mimosa_tpu.radar import factor as jrad
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.imu.buffer import ImuBuffer as TBuf
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.odometry import factor as todo
from mimosa_tpu_torch.radar import factor as trad

from torch_fixtures import one_thread_then_free_programs  # noqa: F401


def _jax(fn, *args, static=()):
    with jax.enable_x64(False):
        return jax.jit(fn, static_argnums=static)(*args)


def _close(out, ref, rtol, floor):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30))


def _unit(v):
    v = np.asarray(v, float)
    return v / np.linalg.norm(v)


# extrinsics T_B_R / T_B_S: identity, and a rotated, offset mount (the
# lever arm makes the gyro and its bias enter the Doppler residual)
EXTRINSICS = {
    "identity": dict(),
    "mounted": dict(q=tuple(_unit([0.96, 0.05, -0.2, 0.15])),
                    t=(0.4, -0.1, 0.25)),
}


def _radar_cfgs(ext):
    kw = {} if not ext else dict(q_b_r=ext["q"], t_b_r=ext["t"])
    return jrad.RadarConfig(**kw), trad.RadarConfig(**kw)


def _radar_inputs(seed, cfg, n=512):
    """One state and a frame of n targets (f32): forward bearings at 2-30
    m with the Doppler of the state plus 0.02 m/s noise, then 10 NaN rows,
    20 rows under the SNR gate, 20 out of range, 20 outside the azimuth or
    elevation cones, and 10% outliers (+-1 to 3 m/s)."""
    rng = np.random.default_rng(seed)
    q = _unit(rng.normal(size=4))
    v = rng.normal(size=3) * 1.5
    bg = rng.normal(size=3) * 0.01
    omega = rng.normal(size=3) * 0.3
    dirs = rng.normal(size=(n, 3))
    dirs[:, 0] = np.abs(dirs[:, 0]) + 0.8
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(2.0, 30.0, size=n)[:, None]
    dop = tsyn.radar_residuals_np(q, v, bg, omega, dirs, np.zeros(n),
                                  cfg.q_b_r, cfg.t_b_r)
    dop += rng.normal(size=n) * 0.02
    snr = rng.uniform(8.0, 30.0, size=n)
    idx = rng.permutation(n)
    pts[idx[:10]] = np.nan
    snr[idx[10:30]] = 2.0
    pts[idx[30:40]] *= 0.01                      # under min_range
    pts[idx[40:50]] *= 3.0                       # over max_range
    pts[idx[50:60], 0] *= -1.0                   # behind: azimuth cone
    pts[idx[60:70], 2] = 3.0 * np.abs(pts[idx[60:70], 0])   # elevation
    out = idx[70:70 + n // 10]
    dop[out] += rng.choice([-1, 1], len(out)) * rng.uniform(1, 3, len(out))
    f32 = [np.asarray(a, np.float32) for a in (q, v, bg, omega, pts, dop,
                                                snr)]
    return f32


@pytest.mark.parametrize("ext", sorted(EXTRINSICS))
@pytest.mark.parametrize("seed", [0, 1])
def test_doppler_factor_matches_jax(seed, ext):
    jcfg, tcfg = _radar_cfgs(EXTRINSICS[ext])
    q, v, bg, omega, pts, dop, snr = _radar_inputs(seed, tcfg)
    jd, jr, jv = _jax(jrad.filter_targets, jnp.asarray(pts),
                      jnp.asarray(snr), jcfg, static=(2,))
    td, tr, tv = trad.filter_targets(torch.from_numpy(pts),
                                     torch.from_numpy(snr), tcfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 300 < int(tv.sum()) < 430
    assert np.isfinite(td.numpy()).all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)

    # the residuals and the factor on identical inputs (JAX's bearings)
    dirs = np.asarray(jd)
    jargs = [jnp.asarray(a) for a in (q, v, bg, omega, dirs, dop)]
    targs = [torch.from_numpy(np.array(a)) for a in (q, v, bg, omega, dirs,
                                                     dop)]
    valid = np.array(jv)
    res_j = _jax(jrad.residuals, *jargs, jcfg, static=(6,))
    res_t = trad.residuals(*targs, tcfg)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=1e-5)

    ref = _jax(jrad.linearize, *jargs, jnp.asarray(valid), jcfg, static=(7,))
    out = trad.linearize(*targs, torch.from_numpy(valid), tcfg)
    assert torch.isfinite(out.H).all() and torch.isfinite(out.b).all()
    _close(out.H.numpy(), ref.H, rtol=1e-4, floor=1e-5)
    _close(out.b.numpy(), ref.b, rtol=1e-4, floor=5e-4)
    assert int(out.num_inlier) == int(ref.num_inlier) == int(tv.sum())
    np.testing.assert_allclose(float(out.mean_abs_res),
                               float(ref.mean_abs_res), rtol=1e-5)
    # the lever arm puts the gyro bias in the block only with an offset
    assert (np.abs(out.H[6:, 6:].numpy()).max() > 0) == (ext == "mounted")


def _odom_cfgs(ext):
    kw = {} if not ext else dict(q_b_s=ext["q"], t_b_s=ext["t"])
    return jodo.OdometryConfig(**kw), todo.OdometryConfig(**kw)


@pytest.mark.parametrize("ext", sorted(EXTRINSICS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_between_factor_matches_jax(seed, ext):
    jcfg, tcfg = _odom_cfgs(EXTRINSICS[ext])
    rng = np.random.default_rng(seed)

    def pose(scale):
        return (_unit(rng.normal(size=4)).astype(np.float32),
                (rng.normal(size=3) * scale).astype(np.float32))

    prev, cur = pose(5.0), pose(5.0)
    qi, pi = pose(5.0)
    # state j near T_i * T_meas, so the residual is small but not zero
    qm, tm = _jax(jodo.relative_measurement, *map(jnp.asarray, prev + cur),
                  jcfg, static=(4,))
    tq, tt = todo.relative_measurement(
        *map(torch.from_numpy, prev + cur), tcfg)
    _close(tq.numpy(), qm, rtol=1e-5, floor=1e-5)
    _close(tt.numpy(), tm, rtol=1e-5, floor=1e-5)
    Rm = np.asarray(tsyn._quat_to_mat_np(np.asarray(qi, float)))
    qj = _unit(np.asarray(tsyn._quat_mul_np(qi, np.asarray(qm)))
               + rng.normal(size=4) * 0.01).astype(np.float32)
    pj = (pi + Rm @ np.asarray(tm) + rng.normal(size=3) * 0.02).astype(
        np.float32)
    args = (qi, pi, qj, pj, np.asarray(qm), np.asarray(tm))
    ref = _jax(jodo.linearize, *map(jnp.asarray, args), jcfg, static=(6,))
    out = todo.linearize(*(torch.from_numpy(np.array(a)) for a in args),
                         tcfg)
    _close(out.H.numpy(), ref.H, rtol=1e-5, floor=1e-5)
    _close(out.b.numpy(), ref.b, rtol=1e-5, floor=2e-4)
    assert np.abs(np.asarray(ref.b)).max() > 1.0


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1e-2, 1.0])
def test_d_optimality_matches_jax(scale):
    rng = np.random.default_rng(int(-np.log10(scale)))
    A = rng.normal(size=(6, 6))
    cov = (A @ A.T + np.eye(6)) * scale
    np.testing.assert_allclose(todo.d_optimality(cov),
                               jodo.d_optimality(cov), rtol=1e-9)


# ------------------------------------------------------------- generators

TRAJS = {
    "room": dict(t_total=3.5),
    "corridor": dict(t_total=3.0, amp=(4.0, 0.6, 0.3),
                     center=(40.0, 2.0, 1.5), yaw_rate=0.15),
}


@pytest.mark.parametrize("ext", sorted(EXTRINSICS))
@pytest.mark.parametrize("traj", sorted(TRAJS))
def test_generate_radar_matches_jax(traj, ext):
    kw = dict(seed=3, n_targets=64)
    if ext != "identity":
        kw.update(q_b_r=EXTRINSICS[ext]["q"], t_b_r=EXTRINSICS[ext]["t"])
    jt, tt = (m.TrajectoryConfig(**TRAJS[traj]) for m in (jsyn, tsyn))
    j = jsyn.generate_radar(jsyn.make_trajectory(jt), jt, **kw)
    t = tsyn.generate_radar(tsyn.make_trajectory(tt), tt, **kw)
    assert len(t) == len(j) > 40
    for ft, fj in zip(t, j):
        assert ft["ts"] == fj["ts"]
        for k in ("points", "doppler", "snr_db"):
            np.testing.assert_allclose(ft[k], fj[k], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("traj", sorted(TRAJS))
def test_generate_odometry_matches_jax(traj):
    jt, tt = (m.TrajectoryConfig(**TRAJS[traj]) for m in (jsyn, tsyn))
    j = jsyn.generate_odometry(jsyn.make_trajectory(jt), jt, seed=3)
    t = tsyn.generate_odometry(tsyn.make_trajectory(tt), tt, seed=3)
    assert len(t) == len(j) > 20
    for mt, mj in zip(t, j):
        assert mt["ts"] == mj["ts"]
        for k in ("q", "t", "cov"):
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("window", [(0.0, 0.02), (0.3, 0.32), (0.501, 0.5013),
                                    (0.9, 1.2)])
def test_exposure_gyro_matches_jax(window):
    rng = np.random.default_rng(0)
    ts = np.arange(0.0, 1.0, 0.005)
    acc, gyro = rng.normal(size=(len(ts), 3)), rng.normal(size=(len(ts), 3))
    j, t = JBuf(), TBuf()
    for b in (j, t):
        b.add_batch(ts, acc, gyro)
    assert len(t) == len(j) == len(ts)
    assert t.t_last == j.t_last == ts[-1]
    for a, b in zip(t.mean_measurements(*window),
                    j.mean_measurements(*window)):
        np.testing.assert_array_equal(a, b)
    assert TBuf().t_last is None and len(TBuf()) == 0


# ------------------------------------------- radar on a photometric Sequencer

def test_radar_frames_leave_the_feature_store_unchanged():
    """A photometric Sequencer carries its feature store in the step state;
    the radar variants (declare, attach, late same-key and inserted) pass
    it through untouched, while they do move the window. They return the
    store's own tensors, so the captured path's ``write_back`` leaves it
    alone (it copies only outputs that are not their buffer)."""
    from mimosa_tpu_torch.graph import captured

    lm = tsyn.LidarModel()
    tc = tsyn.TrajectoryConfig(t_total=2.2, t_stationary=1.23)
    data = tsyn.generate(tsyn.room_world(), tc, lm, seed=0)
    traj = tsyn.make_trajectory(tc)
    radar = tsyn.generate_radar(traj, tc, seed=0)
    s = tseq.Sequencer(
        tseq.SequencerConfig(max_scan_points=4096, n_geo_points=2048,
                             n_map_points=4096, geo_leaf=0.4, n_gn_iters=2),
        twin.WindowConfig(K=6),
        tvh.VoxelMapConfig(leaf_size=0.4, capacity_log2=15,
                           plane_min_points=5, lru_horizon=0),
        tgeo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        trep.photo_config(lm), device="cpu")
    odom = tsyn.generate_odometry(traj, tc, seed=0)
    events = trep.multimodal_events(
        data, radar, odom,
        late_radar={4 * i + 1 + i % 2 for i in range(len(radar))})
    step_fn, passed = s._step_fn, []

    def radar_step_fn(key):
        fn = step_fn(key)

        def step(state, *inputs):
            out = fn(state, *inputs)
            bufs, outs = captured.flatten(state)[0], captured.flatten(out)[0]
            n = len(s.features)
            passed.append(all(o is b for o, b in zip(outs[-n:], bufs[-n:])))
            ptrs = [b.data_ptr() for b in bufs[-n:]]
            captured.write_back(bufs, outs)
            assert [b.data_ptr() for b in bufs[-n:]] == ptrs
            return out
        return step if key[0] == "radar" else fn

    s._step_fn = radar_step_fn
    imu_i, checked = 0, set()
    for ev in events:
        feats = [f.clone() for f in s.features]
        window = [w.clone() for w in s.window]
        before = dict(s.counters)
        imu_i = trep.feed_event(s, data, ev, imu_i)
        if ev[1] != "radar" or s.counters.get("radar_dropped") != \
                before.get("radar_dropped"):
            continue
        for a, b in zip(s.features, feats):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b) for a, b in zip(s.window, window))
        checked |= {k for k in ("radar_ooo_samekey", "radar_ooo_inserted")
                    if s.counters.get(k, 0) > before.get(k, 0)}
        checked.add("in order")
    assert checked == {"in order", "radar_ooo_samekey", "radar_ooo_inserted"}
    assert len(passed) > 20 and all(passed)
    assert int(s.features.valid.sum()) > 10
