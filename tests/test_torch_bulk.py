"""The port's offline bulk scheduler (``Sequencer.add_bulk``,
``add_scans_bulk``) on the CPU, at ``tests/test_bulk.py``'s sizes (a
16x256 LiDAR, 4096 points, K=4, two GN iterations, chunks of 8).

Bulk changes scheduling, not arithmetic, so:

* against the port's streaming path with ``merge_marginalize=True`` (the
  same step variants, the same inputs) bulk gives the same bits:
  positions and quaternions equal, and equal ``counters``, ``state_ts``,
  trajectory times and ``_traj_src``. Scan-only with a streamed tail, a
  same-key scan and dropped scans; a lag that forces slides; the range
  codec; the photometric factor in the f32 codec; a four-modality stream
  whose chunks hold every event code (scan, radar declare and attach,
  odometry declare and attach); three of ``tests/test_bulk_fuzz.py``'s
  random streams (drops, duplicates, lag, D-optimality rejections);
* against streaming without the merged slide, the JAX tests' tolerances:
  2e-3 m scan-only (``test_bulk.py::test_bulk_matches_streaming``), 5e-3 m
  mixed (``test_bulk_four_modality_matches_streaming``);
* ``tests/test_bulk_strict.py``'s pattern: positions point by point within
  2 mm of streaming, and a scan whose points are moved in the bulk run only
  breaks that gate;
* against the JAX package on the four-modality stream: the same
  counters, ``state_ts`` and ``_traj_src``, positions within 5e-3 m. The
  reference is the JAX Sequencer streaming with ``merge_marginalize=True``
  (what ``test_bulk.py`` holds the JAX bulk path to): the JAX package's
  own ``add_bulk`` compiles its multimodal chunk program for minutes on
  a CPU.

Every case asserts that at least one chunk ran. The torch work runs on
one intra-op thread (``torch_fixtures``): the CPU's bits depend on how a
reduction is split, and the comparisons here are bitwise.

The JAX reference's run, almost all of it XLA's compile of five step
programs, goes on a thread of its own (``jax_mm``). Run without xdist, a
module-scoped fixture starts it with the module's first test, so the
compile overlaps the port's replays; an xdist worker, which cannot know
whether it will run the JAX case, starts it only for that case.
"""

import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.lidar import photometric as tph
from mimosa_tpu_torch.mapping import voxel_hash as tvh

import test_bulk_fuzz
import test_bulk_strict
from torch_fixtures import one_thread_then_free_programs  # noqa: F401

SCAN_GAP = 2e-3          # [m] test_bulk.py's scan-only tolerance
MIXED_GAP = 5e-3         # [m] test_bulk.py's mixed-chunk tolerance
STRICT_GAP = test_bulk_strict.STRICT_DP_GATE_M
CHUNK = 8
LM = tsyn.LidarModel(n_rows=16, n_cols=256)
FUZZ_SEEDS = (8, 9, 11)   # duplicates; radar, D-optimality; lag


SEQ_KW = dict(max_scan_points=4096, n_geo_points=2048, n_map_points=4096,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=2)
MAP_KW = dict(leaf_size=0.4, capacity_log2=14, plane_min_points=5,
              lru_horizon=0)


def _port(photo_cfg=None, ray_dirs=None, **kw):
    return tseq.Sequencer(tseq.SequencerConfig(**{**SEQ_KW, **kw}),
                          twin.WindowConfig(K=4), tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(), photo_cfg, device="cpu",
                          ray_dirs=ray_dirs)


def _order(msgs, t_end):
    """add_bulk's dispatch order: (time, code), a scan at its end."""
    code = {"scan": 0, "radar": 1, "odom": 2}
    items = [((t_end(m) if m.get("kind", "scan") == "scan"
               else float(m["ts"])), code[m.get("kind", "scan")], m)
             for m in msgs]
    return [m for _, _, m in sorted(items, key=lambda e: (e[0], e[1]))]


def _replay(s, data, msgs, bulk, chunk=CHUNK, **bulk_kw):
    """All IMU first (the offline premise), then ``msgs`` through add_bulk,
    or streamed one by one in add_bulk's dispatch order."""
    imu = data["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    if bulk:
        s.add_bulk(msgs, chunk=chunk, **bulk_kw)
        return s
    for m in _order(msgs, type(s)._scan_t_end):
        kind = m.get("kind", "scan")
        if kind == "radar":
            s.add_radar(m["ts"], m["points_r"], m["doppler"], m.get("snr_db"))
        elif kind == "odom":
            s.add_odometry(m["ts"], m["q"], m["p"], m.get("cov6"))
        else:
            s.add_scan(m["ts_header"], m["points"], m["t_rel"],
                       m.get("valid"), intensity=m.get("intensity"))
    return s


def _poses(s):
    tr = s.trajectory
    return (np.array([p for _, p, _ in tr]), np.array([q for _, _, q in tr]))


def _assert_same_schedule(a, b):
    assert a.counters == b.counters
    assert a.state_ts == b.state_ts
    assert a._traj_ts == b._traj_ts
    assert a._traj_src == b._traj_src
    assert a.scan_idx == b.scan_idx


def _assert_bitwise(bulk, stream):
    """Bulk against merged streaming: the same bits and the same host
    state; at least one chunk ran."""
    assert bulk.bulk_counts["chunks"] >= 1, bulk.bulk_counts
    _assert_same_schedule(bulk, stream)
    (pb, qb), (ps, qs) = _poses(bulk), _poses(stream)
    np.testing.assert_array_equal(pb, ps)
    np.testing.assert_array_equal(qb, qs)
    np.testing.assert_array_equal(bulk.debug_records(),
                                  stream.debug_records())


def _assert_close(bulk, stream, gap):
    """Bulk against plain streaming: the same schedule, positions and
    quaternions (up to sign) within ``gap``."""
    _assert_same_schedule(bulk, stream)
    (pb, qb), (ps, qs) = _poses(bulk), _poses(stream)
    np.testing.assert_allclose(pb, ps, atol=gap)
    dq = np.minimum(np.linalg.norm(qb - qs, axis=1),
                    np.linalg.norm(qb + qs, axis=1))
    assert dq.max() < gap, dq.max()


# --------------------------------------------------------- chunk packs

PACK_CASES = {
    "int16": dict(), "int16_skip2": dict(point_skip=2),
    "int16_photo": dict(photo=True), "range": dict(range_transfer=True),
    "range_photo_skip2": dict(range_transfer=True, photo=True, point_skip=2),
    "f32": dict(quantize_transfer=False),
    "f32_photo_skip2": dict(quantize_transfer=False, photo=True,
                            point_skip=2),
}


def _photo_cfg(num_features=32):
    return tph.PhotometricConfig(
        rows=LM.n_rows, cols=LM.n_cols, fov_up=LM.fov_up,
        fov_down=LM.fov_down, range_min=0.5, range_max=40.0,
        gradient_threshold=2.0, nma_radius=5, num_features=num_features,
        margin=3, intensity_scale=1.0, filter_brightness=False,
        remove_lines=False)


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_scan_row_gives_the_stage_scan_bits(case, room):
    """A chunk's slab row, packed in place, holds the bits that
    ``stage_scan`` sends for the same scan (the mask too in the f32
    codec), in every codec, with and without the intensity column."""
    kw = dict(PACK_CASES[case])
    photo = kw.pop("photo", False)
    rd = tsyn.beam_dirs(LM)[0] if kw.get("range_transfer") else None
    s = _port(_photo_cfg() if photo else None, ray_dirs=rd, **kw)
    sc = dict(room["scans"][7])
    sc["valid"] = sc["valid"] & (np.arange(len(sc["valid"])) % 5 != 0)
    st = s.stage_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                      sc["valid"], intensity=sc.get("intensity"))
    n = s.cfg.max_scan_points
    slab = np.full((2,) + tuple(st["scan_dev"].shape), 7,
                   st["scan_dev"].numpy().dtype)
    ptv = np.zeros((2, n), bool)
    s._pack_scan_row(sc, slab[1], ptv[1] if st["valid_dev"] is not None
                     else None)
    np.testing.assert_array_equal(slab[1], st["scan_dev"].numpy())
    assert (slab[0] == 7).all()
    if st["valid_dev"] is not None:
        np.testing.assert_array_equal(ptv[1], st["valid_dev"].numpy())
    assert st["t_end"] == s._scan_t_end(sc)


# ------------------------------------------------------------ scan-only

@pytest.fixture(scope="module")
def room():
    """tests/strict_worker.py's sequence, 3 s: the room from a 16x256
    LiDAR, IMU noise 0.005, range noise 0.01."""
    return tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(t_total=3.0),
                         LM, seed=0, imu_noise=0.005, range_noise=0.01)


@pytest.fixture(scope="module")
def strict(room):
    """``test_bulk_strict._strict_stream``'s seed-0 stream of the room's
    scans (scans 11 and 12 dropped, and with scan 12 its same-key copy)
    through add_bulk, merged streaming and plain streaming."""
    msgs, _ = test_bulk_strict._strict_stream((room, None, None), 0)
    return dict(room=room, msgs=msgs,
                bulk=_replay(_port(), room, msgs, True),
                merged=_replay(_port(merge_marginalize=True), room, msgs,
                               False),
                plain=_replay(_port(), room, msgs, False))


def test_scan_only_bulk_equals_merged_streaming(strict):
    b = strict["bulk"]
    _assert_bitwise(b, strict["merged"])
    # the window fill and the tail ran streamed, past the dropped scans
    assert len(strict["msgs"]) < len(strict["room"]["scans"])
    assert b.bulk_counts["codes"] == [b.bulk_counts["in_chunks"], 0, 0, 0, 0]
    assert b.bulk_counts["streamed"] > 0
    assert b.bulk_counts["in_chunks"] + b.bulk_counts["streamed"] == \
        len(strict["msgs"])


def test_scan_only_bulk_near_plain_streaming(strict):
    """test_bulk.py::test_bulk_matches_streaming's tolerances."""
    b, s = strict["bulk"], strict["plain"]
    _assert_close(b, s, SCAN_GAP)
    np.testing.assert_allclose(b.debug_records()[:, 0],
                               s.debug_records()[:, 0], atol=64)


def test_strict_pointwise_gate(strict, room):
    """test_bulk_strict.py's gate: every position within 2 mm of the
    streamed one, the schedule equal, ATE under 2 cm."""
    b, s = strict["bulk"], strict["plain"]
    assert b.bulk_counts["chunks"] > 0
    _assert_same_schedule(b, s)
    dp = np.linalg.norm(_poses(b)[0] - _poses(s)[0], axis=1)
    assert dp.max() < STRICT_GAP, dp.max()
    assert trep.trajectory_ate(b, room) < 0.02


def test_strict_gate_catches_a_moved_scan(strict, room):
    """The gate has teeth: one scan inside a chunk with its points moved
    by 0.3 m, in the bulk run only, takes the trajectory past 2 mm."""
    msgs = list(strict["msgs"])
    # scans 0-3 initialize and fill the K = 4 window; scan 4 is the first
    # of the first chunk
    msgs[4] = dict(msgs[4], points=msgs[4]["points"] + [0.3, 0.0, 0.0])
    moved = _replay(_port(), room, msgs, True)
    assert moved.bulk_counts == strict["bulk"].bulk_counts
    _assert_same_schedule(moved, strict["plain"])
    dp = np.linalg.norm(_poses(moved)[0] - _poses(strict["plain"])[0],
                        axis=1)
    assert dp.max() > STRICT_GAP, dp.max()


def test_lag_fallback_bulk_equals_merged_streaming(room):
    """A fixed lag (test_bulk.py::test_bulk_lag_fallback): after a dropped
    scan the lag forces slides that the bulk run streams, and the window
    full again runs a chunk. At lag_secs 0.25 the K = 4 window of a 10 Hz
    LiDAR never fills (the lag keeps three states), so every scan would
    stream; 0.45 keeps four."""
    msgs = [sc for k, sc in enumerate(room["scans"]) if k != 14]
    b = _replay(_port(lag_secs=0.45), room, msgs, True)
    s = _replay(_port(lag_secs=0.45, merge_marginalize=True), room, msgs,
                False)
    _assert_bitwise(b, s)
    assert b.bulk_counts["streamed"] > 4


def test_range_codec_bulk_equals_merged_streaming(room):
    rd = tsyn.beam_dirs(LM)[0]
    b = _replay(_port(range_transfer=True, ray_dirs=rd), room,
                room["scans"], True)
    s = _replay(_port(range_transfer=True, ray_dirs=rd,
                      merge_marginalize=True), room, room["scans"], False)
    _assert_bitwise(b, s)


def test_photometric_f32_bulk_equals_merged_streaming(room):
    """The photometric factor (test_bulk.py's 32-feature configuration)
    in the f32 codec: the intensity column and the mask slab, the feature
    store carried through the chunk."""
    pc = _photo_cfg()
    b = _replay(_port(pc, quantize_transfer=False), room, room["scans"],
                True)
    s = _replay(_port(pc, quantize_transfer=False, merge_marginalize=True),
                room, room["scans"], False)
    _assert_bitwise(b, s)
    for k in b.features._fields:
        np.testing.assert_array_equal(getattr(b.features, k).numpy(),
                                      getattr(s.features, k).numpy())
    assert (b.debug_records()[2:, 12] > 0).all()


# ------------------------------------------------------- four-modality

JAX_CASE = "test_four_modality_bulk_matches_jax"


@pytest.fixture(scope="module")
def mm_stream():
    """synthetic_replay.bulk_stream: 2 s of the room from a 16x256 LiDAR
    (the radar clock out of phase with it), 20 Hz radar of 96 targets,
    10 Hz odometry 15 ms behind the radar, and a radar frame and an
    odometry message 2 ms after every fourth scan's end, as add_bulk's
    messages."""
    data, events = trep.bulk_stream(
        tsyn.TrajectoryConfig(t_total=2.0, t_stationary=1.23), LM)
    return data, trep.bulk_messages(events)


def _jax_streaming(data, msgs):
    """The JAX Sequencer (64-bit types off, as in production) streaming
    the in-order events with the merged slide: its schedule and
    trajectory."""
    with jax.enable_x64(False):
        j = jseq.Sequencer(
            seq_cfg=jseq.SequencerConfig(merge_marginalize=True, **SEQ_KW),
            win_cfg=jwin.WindowConfig(K=4),
            map_cfg=jvh.VoxelMapConfig(**MAP_KW),
            geo_cfg=jgeo.GeometricConfig(), dtype=jnp.float32,
            step_cache={})
        _replay(j, data, msgs, False)
        return types.SimpleNamespace(
            counters=j.counters, state_ts=j.state_ts, _traj_ts=j._traj_ts,
            _traj_src=j._traj_src, scan_idx=j.scan_idx,
            trajectory=j.trajectory)


@pytest.fixture(scope="module")
def jax_mm(mm_stream):
    """The JAX reference of the four-modality stream, running on a thread:
    a future of :func:`_jax_streaming`'s result (awaited at teardown, so
    no compile outlives the module's release of JAX's programs)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_jax_streaming, *mm_stream)
        yield future
        future.result()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_mm_early(request):
    """Without xdist, with the JAX case selected: start ``jax_mm`` with the
    module's first test."""
    if getattr(request.config, "workerinput", None) is None and any(
            item.originalname == JAX_CASE and item.module is request.module
            for item in request.session.items):
        request.getfixturevalue("jax_mm")


@pytest.fixture(scope="module")
def mm(mm_stream):
    """The four-modality stream through add_bulk, merged streaming and
    plain streaming."""
    data, msgs = mm_stream
    return dict(data=data, msgs=msgs,
                bulk=_replay(_port(), data, msgs, True),
                merged=_replay(_port(merge_marginalize=True), data, msgs,
                               False),
                plain=_replay(_port(), data, msgs, False))


def test_four_modality_bulk_equals_merged_streaming(mm):
    b = mm["bulk"]
    _assert_bitwise(b, mm["merged"])
    # every event code ran inside a chunk
    assert all(n > 0 for n in b.bulk_counts["codes"]), b.bulk_counts
    assert b.counters["radar_frames"] == sum(
        m.get("kind") == "radar" for m in mm["msgs"])


def test_four_modality_bulk_near_plain_streaming(mm):
    """test_bulk.py::test_bulk_four_modality_matches_streaming's
    tolerance."""
    _assert_close(mm["bulk"], mm["plain"], MIXED_GAP)


def test_four_modality_bulk_matches_jax(mm, jax_mm):
    """The JAX Sequencer (64-bit types off, as in production), streaming
    the same in-order events with the merged slide: the same counters,
    state_ts and _traj_src, positions within 5e-3 m."""
    j = jax_mm.result()
    jt = j.trajectory
    b = mm["bulk"]
    assert b.bulk_counts["chunks"] >= 1
    _assert_same_schedule(b, j)
    gap = np.abs(_poses(b)[0] - np.array([p for _, p, _ in jt])).max()
    print(f"four-modality bulk against the JAX package: largest position "
          f"gap {gap:.2e} m")
    assert gap < MIXED_GAP


# ---------------------------------------------------------------- fuzz

def _fuzz_port(**kw):
    return tseq.Sequencer(
        tseq.SequencerConfig(max_scan_points=1024, n_geo_points=1024,
                             n_map_points=2048, geo_leaf=0.4,
                             map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                             keyframe_rot_thresh=0.15, n_gn_iters=1, **kw),
        twin.WindowConfig(K=4),
        tvh.VoxelMapConfig(leaf_size=0.4, capacity_log2=13,
                           plane_min_points=5, lru_horizon=0),
        tgeo.GeometricConfig(), device="cpu")


@pytest.fixture(scope="module")
def fuzz_base():
    """test_bulk_fuzz.py's base sequence: 3.5 s of the room from an 8x128
    LiDAR."""
    syn = test_bulk_fuzz.syn
    tc = syn.TrajectoryConfig(t_total=3.5)
    return (syn.generate(syn.room_world(), tc,
                         syn.LidarModel(n_rows=8, n_cols=128), seed=0),
            syn.make_trajectory(tc), tc)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_stream_bulk_equals_merged_streaming(fuzz_base, seed):
    """One of test_bulk_fuzz.py's random streams (scan drops and same-key
    copies, radar at a random rate with frames pinned on scan ends,
    odometry with D-optimality rejections and lost anchors, a lag on some
    seeds, a random chunk size)."""
    msgs, cfg_kw, chunk = test_bulk_fuzz._fuzz_stream(fuzz_base, seed)
    data = fuzz_base[0]
    b = _replay(_fuzz_port(**cfg_kw), data, msgs, True, chunk=chunk)
    s = _replay(_fuzz_port(merge_marginalize=True, **cfg_kw), data, msgs,
                False)
    _assert_bitwise(b, s)
