"""Localization against a frozen map and the two-pass replay in the port
(``SequencerConfig.freeze_map``, ``Sequencer(init_map=...)``,
``synthetic_replay.run(two_pass=, smooth=)``) on the CPU.

* one frozen scan step from a carried state (a port replay's state after
  init + 2 scans, loaded into a frozen port Sequencer and a frozen JAX
  Sequencer): the same window and debug row as the JAX package's step, and
  the map and the keyframe ring bitwise as they came in, in both packages;
* ``init_map`` copies the given map into new tensors and refuses a map of
  another capacity, dtype or device;
* ``run(two_pass=True, smooth=True)`` at the scoreboard's 16x256 widths
  (a shorter, faster room sequence):
  pass 2 and the smoothed trajectory under room_noisy's gates (ATE
  < 0.080 m, RTE < 0.5%), pass 1's map untouched by pass 2, pass 2's map
  equal to it and one keyframe;
* a frozen ``add_scans_bulk`` gives the bits of frozen streaming with the
  merged slide (on one intra-op thread, as ``test_torch_bulk.py``).
"""

import copy

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
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.utils import evaluation as tev

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

ATE_GATE, RTE_GATE = 0.080, 0.5      # room_noisy's gates [m], [%]


def _map_bits(vmap):
    return [t.clone() for t in vmap]


def _assert_same_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------ one frozen step, both packages

SEQ_KW = dict(max_scan_points=1024, n_geo_points=1024, n_map_points=2048,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=3,
              quantize_transfer=False)
MAP_KW = dict(leaf_size=1.0, capacity_log2=13, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
N_CARRY = 3          # add_scan calls before the carried state: init + 2


def _port_small(freeze):
    return tseq.Sequencer(
        tseq.SequencerConfig(**SEQ_KW, freeze_map=freeze),
        twin.WindowConfig(K=4), tvh.VoxelMapConfig(**MAP_KW),
        tgeo.GeometricConfig(**GEO_KW), device="cpu")


def _jax_frozen(state):
    """A frozen JAX Sequencer holding ``state`` (convert's numpy layout)."""
    js = jseq.Sequencer(
        jseq.SequencerConfig(**SEQ_KW, freeze_map=True),
        jwin.WindowConfig(K=4), jvh.VoxelMapConfig(**MAP_KW),
        jgeo.GeometricConfig(**GEO_KW), dtype=jnp.float32)
    for name, cls in (("window", jwin.Window), ("vmap", jvh.VoxelMap),
                      ("preints", jpre.PreintState)):
        setattr(js, name, cls(**{k: jnp.asarray(v)
                                 for k, v in state[name].items()}))
    for name in convert.SEQ_ARRAYS:
        setattr(js, name, jnp.asarray(state[name]))
    for k in convert.SEQ_HOST:
        setattr(js, k, copy.deepcopy(state["host"][k]))
    imu = state["imu"]
    js.imu.add_batch(imu["ts"], imu["acc"], imu["gyro"])
    return js


def test_frozen_scan_step_matches_jax_and_keeps_the_map():
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=3.0), tsyn.LidarModel(n_rows=8, n_cols=128), seed=0)
    s = _port_small(freeze=False)
    imu_i = 0
    for k in range(N_CARRY):
        imu_i = trep.feed(s, data, k, imu_i)
    assert s.num_keyframes > 1
    before = convert.sequencer_state(s)

    t = convert.load_sequencer_state(_port_small(freeze=True), before)
    js = _jax_frozen(before)
    trep.feed(t, data, N_CARRY, imu_i)
    trep.feed(js, data, N_CARRY, imu_i)
    out = convert.sequencer_state(t)
    assert out["host"]["scan_idx"] == js.scan_idx == N_CARRY
    assert out["host"]["counters"] == js.counters

    # the map and the keyframe ring as they came in, in both packages
    for k, v in before["vmap"].items():
        np.testing.assert_array_equal(out["vmap"][k], v)
        np.testing.assert_array_equal(np.asarray(getattr(js.vmap, k)), v)
    for k in ("kf_q", "kf_p", "kf_count"):
        np.testing.assert_array_equal(out[k], before[k])
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), before[k])

    # the window after GN from the same state (f32 sums in another order)
    for k in ("q", "p", "v", "bg", "ba", "g_dir"):
        np.testing.assert_allclose(out["window"][k],
                                   np.asarray(getattr(js.window, k)),
                                   atol=1e-4)
    np.testing.assert_array_equal(out["window"]["active"],
                                  np.asarray(js.window.active))
    row = out["debug_rec"][N_CARRY - 1]
    rowr = np.asarray(js.debug_rec)[N_CARRY - 1]
    assert row[0] > 100
    np.testing.assert_array_equal(row[:5], rowr[:5])
    np.testing.assert_array_equal(row[6:17], rowr[6:17])
    np.testing.assert_allclose(out["traj_p"], np.asarray(js.traj_p),
                               atol=1e-4)


# ------------------------------------------------------------- init_map

def test_init_map_is_copied_and_checked():
    m = tvh.create(tvh.VoxelMapConfig(**MAP_KW))
    m = m._replace(n=torch.arange(m.n.shape[0], dtype=torch.float32),
                   occupied=torch.ones_like(m.occupied))
    s = tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW, freeze_map=True),
                       twin.WindowConfig(K=4), tvh.VoxelMapConfig(**MAP_KW),
                       device="cpu", init_map=m)
    ptrs = {x.untyped_storage().data_ptr() for x in m}
    for a, b in zip(s.vmap, m):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() not in ptrs
    s.vmap.n.zero_()
    assert m.n[-1] == m.n.shape[0] - 1       # the given map is untouched
    bad = [
        tvh.create(tvh.VoxelMapConfig(**dict(MAP_KW, capacity_log2=12))),
        tvh.create(tvh.VoxelMapConfig(**MAP_KW), dtype=torch.float64),
        tvh.create(tvh.VoxelMapConfig(**MAP_KW), device="meta"),
    ]
    for b in bad:
        with pytest.raises(ValueError, match="init_map"):
            tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW),
                           twin.WindowConfig(K=4),
                           tvh.VoxelMapConfig(**MAP_KW), device="cpu",
                           init_map=b)


# ------------------------------------------------------------ the two passes

def _rte(ts, p, data):
    return tev.rte(np.asarray(ts), np.asarray(p), data["gt"]["ts"],
                   data["gt"]["pos"])


def test_two_pass_and_smoothing_meet_the_row_gates(monkeypatch):
    """``run(two_pass=True, smooth=True)`` on the scoreboard's noisy room,
    cut to 4.5 s at twice the default motion frequencies (34 scans, an
    11.6 m path: the RTE is defined), each pass's map recorded before and
    after its replay: pass 2 and the smoothed trajectory under the row
    gates; pass 1's map untouched, pass 2 started from a copy of it and
    kept it, with one keyframe."""
    passes = []
    replay = trep.replay

    def recorded(s, data):
        rec = dict(s=s, before=_map_bits(s.vmap))
        passes.append(rec)
        n = replay(s, data)
        rec["after"] = _map_bits(s.vmap)
        return n

    monkeypatch.setattr(trep, "replay", recorded)
    out = trep.run(device="cpu", tc=tsyn.TrajectoryConfig(
        t_total=4.5, freq=(0.2, 0.32, 0.46)), imu_noise=0.01,
        range_noise=0.01, two_pass=True, smooth=True, verbose=False)
    s, data = out["sequencer"], out["data"]
    p1, p2 = passes
    assert p2["s"] is s and s.cfg.freeze_map
    assert not p1["s"].cfg.freeze_map

    tr = s.trajectory
    rte = _rte([t for t, _, _ in tr], [p for _, p, _ in tr], data)
    sm_ts, sm_q, sm_p = s.smoothed
    rte_s = _rte(sm_ts, sm_p, data)
    print(f"two-pass ATE {out['ate']:.5f} m RTE {rte:.3f}%, smoothed ATE "
          f"{out['ate_smooth']:.5f} m RTE {rte_s:.3f}%")
    assert out["ate"] < ATE_GATE and rte < RTE_GATE
    assert out["ate_smooth"] < ATE_GATE and rte_s < RTE_GATE
    assert len(sm_ts) == len(tr) and np.isfinite(sm_p).all()
    # f32 retractions: the norms drift by ~2e-5 over a replay
    np.testing.assert_allclose(np.linalg.norm(sm_q, axis=-1), 1.0,
                               atol=1e-4)

    _assert_same_bits(p1["s"].vmap, p1["after"])     # pass 1 untouched
    _assert_same_bits(p2["before"], p1["after"])     # pass 2 starts there
    _assert_same_bits(p2["after"], p2["before"])     # and keeps it
    ptrs = {t.untyped_storage().data_ptr() for t in p1["s"].vmap}
    assert not any(t.untyped_storage().data_ptr() in ptrs for t in s.vmap)
    assert s.num_keyframes == 1 and p1["s"].num_keyframes > 5
    assert not s.kf_q[1:].any() and not s.kf_p[1:].any()


# ------------------------------------------------------------ frozen bulk

BULK_KW = dict(max_scan_points=4096, n_geo_points=2048, n_map_points=4096,
               geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
               keyframe_rot_thresh=0.15, n_gn_iters=2)
BULK_MAP = dict(leaf_size=0.4, capacity_log2=14, plane_min_points=5,
                lru_horizon=0)


def _bulk_seq(freeze, init_map=None, **kw):
    return tseq.Sequencer(
        tseq.SequencerConfig(**BULK_KW, freeze_map=freeze, **kw),
        twin.WindowConfig(K=4), tvh.VoxelMapConfig(**BULK_MAP),
        tgeo.GeometricConfig(), device="cpu", init_map=init_map)


def test_frozen_bulk_equals_frozen_streaming():
    data = tsyn.generate(tsyn.room_world(),
                         tsyn.TrajectoryConfig(t_total=2.5),
                         tsyn.LidarModel(n_rows=16, n_cols=256), seed=0)
    s1 = _bulk_seq(False)
    trep.replay(s1, data)
    vmap = _map_bits(s1.vmap)
    imu = data["imu"]
    stream = _bulk_seq(True, s1.vmap, merge_marginalize=True)
    stream.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    for sc in data["scans"]:
        stream.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                        sc["valid"])
    bulk = _bulk_seq(True, s1.vmap)
    bulk.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    bulk.add_scans_bulk(data["scans"], chunk=8)
    assert bulk.bulk_counts["chunks"] >= 1 and \
        bulk.bulk_counts["codes"][0] > 0
    assert bulk.cfg.freeze_map
    assert bulk.counters == stream.counters
    assert bulk._traj_ts == stream._traj_ts
    for (tb, pb, qb), (ts, ps, qs) in zip(bulk.trajectory,
                                          stream.trajectory):
        assert tb == ts
        np.testing.assert_array_equal(pb, ps)
        np.testing.assert_array_equal(qb, qs)
    for s in (bulk, stream):
        _assert_same_bits(s.vmap, vmap)
        assert int(s.kf_count) == 1
    assert trep.trajectory_ate(bulk, data) < ATE_GATE
