"""The port's tracking-loss rescue and rematch-on-motion against the JAX
package, on the CPU (``SequencerConfig.rescue_enabled``,
``rematch_on_motion``; the JAX scan step's two optional branches).

The JAX package with both settings (one compile of its scan step) runs
init + 5 scans of the room (a 16x256 LiDAR, 1024 ICP points, leaf 0.4 m,
K = 4, the f32 codec); from that state, carried into the port
(``mimosa_tpu_torch.convert``), three steps of the next scan:

* a clean step: rescue does not fire in either package; the port's step
  with both settings gives the bits of its step with neither;
* a small kick (the window shifted by ~0.25 m, values and linearization
  points): points move past a quarter leaf during GN, so the rematch fires
  while the inliers stay above the rescue's 30%; the port follows the JAX
  package, and differs from the port without rematch;
* a large kick (~2.5 leaves, ``tests/test_rescue.py``'s): the inliers
  collapse, the rescue fires in both packages (debug slot 16) and the
  port's window follows the JAX package's.

Then, port only: a 4 s kicked replay recovers (``test_rescue.py``'s tail
ATE gate), and the bulk scheduler with both settings gives the bits of
merged streaming across the rescued scan.

Tolerances: ``tests/test_torch_slice.py``'s carried-step ones (window
states 1e-4, map counts exact, moments 1e-4 of scale, degeneracy flags
exact), but two: the debug row's counts agree within 1%, since at this
configuration (1024 ICP points at leaf 0.4) the plain carried step already
leaves one point on a gate's edge on some scans (this one, with both
settings off in both packages: 462 against 461 inliers);
and after the small kick the accelerometer bias absorbs the kick's
velocity error (it moves ~3e-2 between rematch on and off), so f32 sums in
another order move it by ~1e-3 (gate 2e-3).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

from test_torch_slice import _close, _jax_state
from torch_fixtures import build_once, one_thread_then_free_programs  # noqa: F401

LEAF = 0.4
LM = tsyn.LidarModel(n_rows=16, n_cols=256)
SEQ_KW = dict(max_scan_points=4096, n_geo_points=1024, n_map_points=2048,
              geo_leaf=LEAF, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=3,
              quantize_transfer=False, rescue_radius=2.5 * LEAF)
BOTH = dict(rescue_enabled=True, rematch_on_motion=True)
MAP_KW = dict(leaf_size=LEAF, capacity_log2=13, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
K = 4
N_INIT = 6                     # add_scan calls before the carried steps
KICK = (0.85, 0.5, 0.0)        # ~2.5 leaves
SMALL_KICK = (0.21, 0.125, 0.0)
KICK_TOL = dict(ba=2e-3, lin_ba=2e-3)    # [m/s^2] (module docstring)
COUNT_RTOL = 0.01              # the debug row's counts (module docstring)


@pytest.fixture(scope="module")
def data():
    return tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=4.0), LM, seed=0)


def _jax_kick(s, dp):
    dp = jnp.asarray(dp, jnp.float32)
    s.window = s.window._replace(p=s.window.p + dp, lin_p=s.window.lin_p + dp)


# the JAX Sequencer's device state (immutable arrays) and host state
_JAX_ARRAYS = ("window", "vmap", "preints") + convert.SEQ_ARRAYS


def _jax_snapshot(s):
    return ({k: getattr(s, k) for k in _JAX_ARRAYS},
            copy.deepcopy({k: getattr(s, k) for k in convert.SEQ_HOST}),
            copy.deepcopy(s.imu))


def _jax_restore(s, snap):
    arrays, host, imu = snap
    for k, v in {**arrays, **copy.deepcopy(host)}.items():
        setattr(s, k, v)
    s.imu = copy.deepcopy(imu)


@pytest.fixture(scope="module")
def steps(data, tmp_path_factory):
    """The JAX package with both settings, from its state after init + 5
    scans: a clean step, a small-kick step and a large-kick step, each
    with its state before and after (convert's layout) and its IMU
    index."""
    return build_once(tmp_path_factory, "test_torch_rescue.steps",
                      lambda: _jax_steps(data))


def _jax_steps(data):
    s = jseq.Sequencer(jseq.SequencerConfig(**SEQ_KW, **BOTH),
                       jwin.WindowConfig(K=K), jvh.VoxelMapConfig(**MAP_KW),
                       jgeo.GeometricConfig(**GEO_KW), dtype=jnp.float32)
    imu_i = 0
    for k in range(N_INIT):
        imu_i = trep.feed(s, data, k, imu_i)
    start = _jax_snapshot(s)
    out = {}
    for name, dp in (("clean", None), ("rematch", SMALL_KICK),
                     ("kicked", KICK)):
        _jax_restore(s, start)
        if dp is not None:
            _jax_kick(s, dp)
        before = _jax_state(s)
        trep.feed(s, data, N_INIT, imu_i)
        out[name] = dict(k=N_INIT, imu_i=imu_i, before=before,
                         after=_jax_state(s))
    return out


def _port(**kw):
    return tseq.Sequencer(tseq.SequencerConfig(**{**SEQ_KW, **kw}),
                          twin.WindowConfig(K=K), tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(**GEO_KW), device="cpu")


def _port_step(data, step, **kw):
    """One add_scan in the port from the step's carried JAX state."""
    s = convert.load_sequencer_state(_port(**kw),
                                     copy.deepcopy(step["before"]))
    trep.feed(s, data, step["k"], step["imu_i"])
    return convert.sequencer_state(s)


def _row(st, step):
    return st["debug_rec"][step["k"] - 1]


def _assert_matches_jax(out, ref, step, tol=None):
    """The carried-step tolerances, with ``tol`` {field: atol} where the
    module docstring states another."""
    assert out["host"] == ref["host"]
    w, wr = out["window"], ref["window"]
    for k in ("q", "p", "v", "g_dir", "lin_q", "lin_p", "lin_v", "bg",
              "lin_bg", "ba", "lin_ba"):
        np.testing.assert_allclose(w[k], wr[k], atol=(tol or {}).get(k, 1e-4),
                                   err_msg=k)
    np.testing.assert_array_equal(w["active"], wr["active"])
    m, mr = out["vmap"], ref["vmap"]
    for k in ("coords", "occupied", "last_touch", "plane_valid"):
        np.testing.assert_array_equal(m[k][:-1], mr[k][:-1])
    np.testing.assert_array_equal(m["n"], mr["n"])
    for k in ("psum", "pssum", "mean"):
        _close(m[k], mr[k], rtol=1e-4, floor=1e-5)
    row, rowr = _row(out, step), _row(ref, step)
    np.testing.assert_allclose(row[:5], rowr[:5], rtol=COUNT_RTOL)
    np.testing.assert_array_equal(row[6:17], rowr[6:17])
    np.testing.assert_allclose(out["traj_p"], ref["traj_p"], atol=1e-4)


def test_clean_step_matches_jax_and_the_port_without_either(data, steps):
    step = steps["clean"]
    out = _port_step(data, step, **BOTH)
    assert _row(step["after"], step)[16] == 0 and _row(out, step)[16] == 0
    assert _row(out, step)[0] > 300
    _assert_matches_jax(out, step["after"], step)
    # no point moved past a quarter leaf and the scan was not lost: the
    # bits of the step without either branch
    plain = _port_step(data, step)
    for name in ("window", "vmap"):
        for k, x in out[name].items():
            np.testing.assert_array_equal(x, plain[name][k],
                                          err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(_row(out, step), _row(plain, step))


def test_rematch_step_matches_jax(data, steps):
    """A ~0.25 m kick: JAX does not rescue (slot 16 is 0), the port follows
    it with the rematch and departs from it without."""
    step = steps["rematch"]
    ref = step["after"]
    assert _row(ref, step)[16] == 0
    out = _port_step(data, step, **BOTH)
    _assert_matches_jax(out, ref, step, KICK_TOL)
    off = _port_step(data, step, rescue_enabled=True)
    gap = np.abs(off["window"]["p"] - ref["window"]["p"]).max()
    assert gap > 10 * np.abs(out["window"]["p"] - ref["window"]["p"]).max()
    assert gap > 1e-3, gap


def test_kicked_step_rescues_as_jax(data, steps):
    """A ~2.5 leaf kick: the scan is lost and the rescue fires in both
    packages; the port's realigned window follows the JAX package's."""
    step = steps["kicked"]
    ref = step["after"]
    assert _row(ref, step)[16] == 1, "the kick did not trigger JAX's rescue"
    out = _port_step(data, step, **BOTH)
    assert _row(out, step)[16] == 1
    _assert_matches_jax(out, ref, step)
    # without the rescue the port stays lost
    off = _port_step(data, step, rematch_on_motion=True)
    assert _row(off, step)[0] < 0.3 * _row(out, step)[0]


def _kick(s, dp):
    dp = torch.tensor(dp, dtype=s.window.p.dtype)
    s.window = s.window._replace(p=s.window.p + dp,
                                 lin_p=s.window.lin_p + dp)


def test_kicked_replay_recovers(data):
    """tests/test_rescue.py's gate on the port: the kick before scan 10 of
    the 4 s room (28 scan steps) triggers the rescue, and with the 8 states
    after it left out (10 remain after them) the ATE is under 0.10 m."""
    at = 10
    s = _port(**BOTH)
    imu_i = 0
    for k in range(len(data["scans"])):
        if k == at:
            _kick(s, KICK)
        imu_i = trep.feed(s, data, k, imu_i)
    assert s.debug_records()[:, 16].sum() >= 1
    tr = s.trajectory
    keep = [i for i in range(len(tr)) if not at <= i < at + 8]
    ate = tsyn.ate_rmse(np.array([tr[i][0] for i in keep]),
                        np.array([tr[i][1] for i in keep]),
                        data["gt"]["ts"], data["gt"]["pos"])
    assert ate < 0.10, ate


def test_kicked_bulk_equals_merged_streaming(data):
    """Both settings through the bulk scheduler, the rescued scan the
    first of a chunk: the bits of merged streaming, slot 16 included."""
    at, end = 8, 12
    scans, imu = data["scans"], data["imu"]
    b, s = _port(**BOTH), _port(merge_marginalize=True, **BOTH)
    for x in (b, s):
        x.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    b.add_scans_bulk(scans[:at], chunk=4)
    _kick(b, KICK)
    b.add_scans_bulk(scans[at:end], chunk=4)
    for k in range(end):
        if k == at:
            _kick(s, KICK)
        s.add_scan(scans[k]["ts_header"], scans[k]["points"],
                   scans[k]["t_rel"], scans[k]["valid"])
    assert b.bulk_counts["in_chunks"] >= end - at
    assert b.debug_records()[at - 1, 16] == 1
    np.testing.assert_array_equal(b.debug_records(), s.debug_records())
    assert b.counters == s.counters and b.state_ts == s.state_ts
    for (_, pb, qb), (_, ps, qs) in zip(b.trajectory, s.trajectory):
        np.testing.assert_array_equal(pb, ps)
        np.testing.assert_array_equal(qb, qs)
