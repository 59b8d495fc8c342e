"""The port's staggered Ouster generator (``io/synthetic.py::
generate_ouster``) and the exact Ouster photometric model in bulk, on the
CPU.

* The generator against the JAX package's on the same seed, plain (the
  shift-quantized azimuths) and affine (exact beam azimuths and a beam
  origin offset), at ``test_torch_slice.py::test_generate_matches_jax``'s
  tolerances: IMU and ground truth 1e-9, ``valid``, ``t_rel`` and ``ring``
  exact, points 1e-5 (f32 from f64 raycasts), intensity 1e-3.
* The affine cloud against the port's loader model
  (``config/loader.py::ouster_ray_dirs``), ``tests/test_range_transfer.py``
  's case: reconstruction error under 1e-5 m.
* The exact-Ouster photometric Sequencer on a 16x256, 2 s staggered room
  in the Ouster sensor frame (``synthetic.ouster_sensor_frame``):
  ``add_scans_bulk`` against merged streaming. Positions within 1e-6 m,
  the same photometric slot 12, features tracked on every step after the
  second. This is held to the port's own streaming run: the JAX package's
  version of the test (``tests/test_bulk.py::
  test_bulk_photometric_exact_ouster_matches_streaming``) fails on the
  JAX package itself. One intra-op thread: the comparison is bitwise in
  spirit and the CPU's reductions split by thread count.
"""

import numpy as np
import pytest

from mimosa_tpu.io import synthetic as jsyn
from mimosa_tpu_torch.config import loader as tload
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.lidar import photometric as tph
from mimosa_tpu_torch.mapping import voxel_hash as tvh

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

BULK_GAP = 1e-6          # [m] bulk against merged streaming


def _table(rows, cols, seed):
    """Beam altitudes from +22 to -22 deg and a per-row shift table drawn
    as tests/test_bulk.py:143-145 draws it."""
    alts = np.radians(np.linspace(22.0, -22.0, rows))
    shifts = np.random.default_rng(seed).integers(0, cols, rows)
    return alts, shifts


def _affine(rows, cols):
    """tests/test_range_transfer.py:212's exact azimuths and beam offset."""
    rng = np.random.default_rng(4)
    alts = np.radians(np.linspace(30.0, -30.0, rows))
    az_deg = rng.uniform(-11.0, 11.0, rows)
    shifts = np.round(az_deg * cols / 360.0).astype(int)
    return alts, shifts, dict(beam_azimuths=np.radians(az_deg),
                              beam_offset_m=0.02767)


def _assert_same_stream(t, j):
    for k in ("ts", "acc", "gyro"):
        np.testing.assert_allclose(t["imu"][k], j["imu"][k], rtol=1e-9,
                                   atol=1e-9)
    for k in ("ts", "pos", "quat"):
        np.testing.assert_allclose(t["gt"][k], j["gt"][k], rtol=1e-9,
                                   atol=1e-9)
    assert len(t["scans"]) == len(j["scans"]) > 5
    for st, sj in zip(t["scans"], j["scans"]):
        assert st["ts_header"] == sj["ts_header"]
        np.testing.assert_array_equal(st["valid"], sj["valid"])
        np.testing.assert_array_equal(st["t_rel"], sj["t_rel"])
        np.testing.assert_array_equal(st["ring"], sj["ring"])
        assert st["ring"].dtype == sj["ring"].dtype
        np.testing.assert_allclose(st["points"], sj["points"], atol=1e-5)
        np.testing.assert_allclose(st["intensity"], sj["intensity"],
                                   atol=1e-3)


@pytest.mark.parametrize("model", ["staggered", "affine"])
def test_generate_ouster_matches_jax(model):
    rows, cols = 8, 128
    if model == "staggered":
        alts, shifts = _table(rows, cols, seed=3)
        kw = {}
    else:
        alts, shifts, kw = _affine(rows, cols)
    # t_total 3.5 crosses the smoothstep's end at t = 3.2
    args = dict(n_cols=cols, seed=3, imu_noise=0.01, range_noise=0.01, **kw)
    j = jsyn.generate_ouster(jsyn.room_world(),
                             jsyn.TrajectoryConfig(t_total=3.5), alts,
                             shifts, **args)
    t = tsyn.generate_ouster(tsyn.room_world(),
                             tsyn.TrajectoryConfig(t_total=3.5), alts,
                             shifts, **args)
    _assert_same_stream(t, j)
    sc = t["scans"][0]
    assert sc["valid"].mean() > 0.9 and sc["points"].shape == (rows * cols, 3)
    # pixel-id order: row-major, the measurement block fastest
    np.testing.assert_array_equal(sc["ring"], np.repeat(np.arange(rows),
                                                        cols))


def test_generate_ouster_affine_matches_loader_model():
    """The affine cloud is the one the loader's [N,6] beam table
    reconstructs (the range codec's contract for real Ouster metadata)."""
    rows, cols = 8, 64
    alts, shifts, kw = _affine(rows, cols)
    data = tsyn.generate_ouster(tsyn.room_world(),
                                tsyn.TrajectoryConfig(t_total=1.5), alts,
                                shifts, n_cols=cols, seed=0, **kw)
    meta = dict(beam_altitudes=tuple(alts),
                beam_azimuths=tuple(kw["beam_azimuths"]),
                pixel_shift_by_row=tuple(int(s) for s in shifts),
                rows=rows, cols=cols, beam_offset_m=kw["beam_offset_m"])
    rd = tload.ouster_ray_dirs(meta)
    assert rd.shape == (rows * cols, 6)
    sc = data["scans"][0]
    ok = sc["valid"]
    p = sc["points"][ok]
    dirs, off = rd[:, :3][ok], rd[:, 3:6][ok]
    s = np.einsum("ij,ij->i", p - off, dirs)
    err = np.linalg.norm(s[:, None] * dirs + off - p, axis=-1)
    assert ok.sum() > 0.9 * rows * cols and err.max() < 1e-5


ROWS, COLS = 16, 256


def exact_ouster_room(t_total=2.0):
    """The staggered 16x256 room (tests/test_bulk.py:143-147's table) in
    the Ouster sensor frame, with its extrinsic, and its exact-Ouster
    photometric configuration. In the generator's own (lidar) frame the
    exact model's column guess lands half a turn from the sampled column,
    and no feature is ever tracked (slot 13, out of image, holds them all):
    the same in the JAX package, whose version of the bulk test fails
    there."""
    alts, shifts = _table(ROWS, COLS, seed=3)
    data, q_b_l = tsyn.ouster_sensor_frame(tsyn.generate_ouster(
        tsyn.room_world(), tsyn.TrajectoryConfig(t_total=t_total), alts,
        shifts, n_cols=COLS, seed=0))
    pc = tph.PhotometricConfig(
        rows=ROWS, cols=COLS, range_min=0.5, range_max=40.0,
        beam_altitudes=tuple(float(a) for a in alts),
        gradient_threshold=2.0, nma_radius=5, num_features=32, margin=3,
        intensity_scale=1.0, filter_brightness=False, remove_lines=False,
        exact_ouster=True, pixel_shift_by_row=tuple(int(s) for s in shifts))
    return data, pc, q_b_l


def _sequencer(pc, q_b_l, **kw):
    """tests/test_bulk.py's Sequencer (K=4, two GN iterations) at the full
    staggered cloud (point_skip 1: the pixel-id fill needs sensor order)."""
    return tseq.Sequencer(
        tseq.SequencerConfig(max_scan_points=ROWS * COLS, n_geo_points=2048,
                             n_map_points=4096, geo_leaf=0.4,
                             map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                             keyframe_rot_thresh=0.15, n_gn_iters=2,
                             q_b_l=q_b_l, **kw),
        twin.WindowConfig(K=4),
        tvh.VoxelMapConfig(leaf_size=0.4, capacity_log2=14,
                           plane_min_points=5, lru_horizon=0),
        tgeo.GeometricConfig(), pc, device="cpu")


def test_exact_ouster_bulk_matches_merged_streaming():
    data, pc, q_b_l = exact_ouster_room()
    runs = []
    for bulk in (True, False):
        s = _sequencer(pc, q_b_l, merge_marginalize=True)
        imu = data["imu"]
        s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
        if bulk:
            s.add_scans_bulk(data["scans"], chunk=4)
        else:
            for sc in data["scans"]:
                s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                           sc["valid"], intensity=sc["intensity"])
        runs.append(s)
    b, s = runs
    assert b.bulk_counts["in_chunks"] > 0
    assert b.counters == s.counters and b._traj_ts == s._traj_ts
    pb = np.array([p for _, p, _ in b.trajectory])
    ps = np.array([p for _, p, _ in s.trajectory])
    assert len(pb) == len(ps) == len(data["scans"])
    assert np.abs(pb - ps).max() <= BULK_GAP
    db, ds = b.debug_records(), s.debug_records()
    np.testing.assert_array_equal(db[:, 12], ds[:, 12])
    assert (ds[2:, 12] > 0).all(), ds[:, 12]
    gt = data["gt"]
    ate = tsyn.ate_rmse(np.array(b._traj_ts), pb, gt["ts"], gt["pos"])
    assert ate < 0.08
