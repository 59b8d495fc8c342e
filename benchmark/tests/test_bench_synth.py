"""The benchmark's frozen generator against the port's ``io/synthetic.py``
on a few small scans, per seed: points to 1e-5, IMU and ground truth to
1e-9, ``valid`` and ``t_rel`` exact; the radar frames, the odometry and
the event order likewise."""

import numpy as np
import pytest
import torch

from benchmark import synth
from mimosa_tpu_torch.io import synthetic as orig
from mimosa_tpu_torch.io import synthetic_replay as orig_replay

SEEDS = [0, 7, 2**31 + 11]


def small():
    tc = dict(t_total=1.9, t_stationary=1.23)
    lm = dict(n_rows=8, n_cols=64)
    return tc, lm


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_matches_original(seed):
    tc, lm = small()
    kw = dict(imu_rate=200, seed=seed, imu_noise=0.01, range_noise=0.01)
    a = orig.generate(orig.room_world(lx=30.0, ly=16.0, lz=6.0),
                      orig.TrajectoryConfig(**tc), orig.LidarModel(**lm),
                      **kw)
    b = synth.generate(synth.room_world(lx=30.0, ly=16.0, lz=6.0),
                       synth.TrajectoryConfig(**tc), synth.LidarModel(**lm),
                       batch=3, **kw)
    for k in ("ts", "acc", "gyro"):
        np.testing.assert_allclose(b["imu"][k], a["imu"][k], rtol=0,
                                   atol=1e-9)
    assert len(a["scans"]) == len(b["scans"]) >= 5
    for sa, sb in zip(a["scans"], b["scans"]):
        assert sa["ts_header"] == sb["ts_header"]
        np.testing.assert_array_equal(sb["t_rel"], sa["t_rel"])
        np.testing.assert_array_equal(sb["valid"], sa["valid"])
        np.testing.assert_allclose(sb["points"], sa["points"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(sb["intensity"], sa["intensity"],
                                   rtol=0, atol=1e-3)
    for k in ("ts", "pos", "quat"):
        np.testing.assert_allclose(b["gt"][k], a["gt"][k], rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_radar_odometry_events_match_original(seed):
    tc, lm = small()
    otc, stc = orig.TrajectoryConfig(**tc), synth.TrajectoryConfig(**tc)
    ra = orig.generate_radar(orig.make_trajectory(otc), otc, rate=20.0,
                             n_targets=16, seed=seed)
    rb = synth.generate_radar(synth.make_trajectory(stc), stc, rate=20.0,
                              n_targets=16, seed=seed)
    assert len(ra) == len(rb) > 5
    for fa, fb in zip(ra, rb):
        assert fa["ts"] == fb["ts"]
        for k in ("points", "doppler", "snr_db"):
            np.testing.assert_allclose(fb[k], fa[k], rtol=0, atol=1e-9)
    oa = orig.generate_odometry(orig.make_trajectory(otc), otc, seed=seed)
    ob = synth.generate_odometry(synth.make_trajectory(stc), stc, seed=seed)
    assert len(oa) == len(ob) > 5
    for ma, mb in zip(oa, ob):
        assert ma["ts"] == mb["ts"]
        for k in ("q", "t", "cov"):
            np.testing.assert_allclose(mb[k], ma[k], rtol=0, atol=1e-9)
    data = orig.generate(orig.room_world(), otc, orig.LidarModel(**lm),
                         seed=seed)
    late = {4 * i + 1 + i % 2 for i in range(len(ra))}
    ea = orig_replay.multimodal_events(data, ra, oa, late_radar=late)
    eb = synth.multimodal_events(data["scans"], rb, ob, late_radar=late)
    assert [(t, k) for t, k, _ in ea] == [(t, k) for t, k, _ in eb]


def test_arange_values_match_numpy():
    for start, step in ((1.0, 0.1), (0.615, 0.05), (0.0, 1 / 200),
                        (1.03, 0.1)):
        ref = np.arange(start, start + 500 * step, step)
        got = synth.arange_at(start, step, np.arange(len(ref)))
        np.testing.assert_array_equal(got, ref)


def test_trajectory_extends_without_a_seam():
    """The pool's later blocks are the same trajectory: scans raycast in
    two batches equal one batch."""
    tc, lm = small()
    mk = synth.ScanMaker(synth.room_world(), synth.TrajectoryConfig(**tc),
                         synth.LidarModel(**lm), torch.device("cpu"))
    whole = mk.make([3, 4, 5], None)
    parts = [mk.make([3], None), mk.make([4, 5], None)]
    for i in range(5):
        torch.testing.assert_close(
            whole[i], torch.cat([p[i] for p in parts]), rtol=0, atol=0)
