"""Parity of the port's host-side numpy modules with the JAX package.

``imu/buffer.py`` and ``utils/timing.py`` are carried into the port as
numpy code; the same seeded sample streams go through both packages'
buffers, and every output must be equal (the same float64 arithmetic).
"""

import numpy as np
import pytest

from mimosa_tpu.imu import buffer as jbuf
from mimosa_tpu.utils import timing as jtim
from mimosa_tpu_torch.imu import buffer as tbuf
from mimosa_tpu_torch.utils import timing as ttim


def _stream(n=800, dt=0.005, seed=0):
    """IMU samples at 200 Hz with a few late and duplicate timestamps."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * dt + rng.uniform(-1e-4, 1e-4, size=n)
    a, b = n // 8, n * 7 // 16                     # out of order / repeated
    ts[[a, b, b + 1]] = ts[[a - 1, b - 10, b - 1]]
    acc = np.asarray([0.2, -0.1, 9.81]) + rng.normal(size=(n, 3)) * 0.3
    gyro = rng.normal(size=(n, 3)) * 0.2
    return ts, acc, gyro


def _both(feed, **kw):
    bufs = jbuf.ImuBuffer(**kw), tbuf.ImuBuffer(**kw)
    for b in bufs:
        feed(b)
    return bufs


def _assert_same_buffer(j, t):
    for k in ("ts", "acc", "gyro"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.num_rejected_nonmonotonic == j.num_rejected_nonmonotonic
    assert t.t_first == j.t_first


def _add_one_by_one(b, stream=None):
    for ts, acc, gyro in zip(*(stream or _stream())):
        b.add(ts, acc, gyro)


FEEDS = {
    "add": (_add_one_by_one, {}),
    "add_batch": (lambda b: b.add_batch(*_stream()), {}),
    "add_batch_in_parts": (lambda b: [b.add_batch(*(a[s] for a in _stream()))
                                      for s in (slice(0, 349),
                                                slice(349, None))], {}),
    "acc_scale": (_add_one_by_one, dict(acc_scale=9.81)),
    "pruned": (lambda b: _add_one_by_one(b, _stream(n=5000)),
               dict(max_duration=1.0)),
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_buffer_contents_match_jax(feed):
    fn, kw = FEEDS[feed]
    j, t = _both(fn, **kw)
    _assert_same_buffer(j, t)
    assert t.num_rejected_nonmonotonic >= 2
    if feed == "pruned":
        assert len(t.ts) < 1200 and t.ts[-1] - t.ts[0] < 3.0


def test_buffer_load_matches_jax_restore():
    """The port's load() gives the buffer a JAX one restores through its
    setters, and both accept the same samples afterwards."""
    src = jbuf.ImuBuffer()
    src.add_batch(*_stream(n=300))
    j, t = jbuf.ImuBuffer(), tbuf.ImuBuffer()
    j.ts, j.acc, j.gyro = src.ts.copy(), src.acc.copy(), src.gyro.copy()
    t.load(src.ts, src.acc, src.gyro)
    _assert_same_buffer(j, t)
    for b in (j, t):
        assert b.add(src.ts[-1] + 0.01, np.ones(3), np.ones(3))
        assert not b.add(src.ts[-1], np.ones(3), np.ones(3))
    _assert_same_buffer(j, t)


# (t0, t1, max_n): interior, whole span, no inner sample, the subsample
# branch, zero length, and both ends past the samples (extrapolation)
WINDOWS = {
    "interior": (0.101, 0.302, 64),
    "whole_span": (0.0, 1.9951, 512),
    "no_inner_sample": (0.5001, 0.5002, 64),
    "subsampled": (0.1, 1.9, 32),
    "zero_length": (0.25, 0.25, 16),
    "past_the_ends": (-0.05, 4.5, 1024),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_segment_matches_jax(window):
    t0, t1, max_n = WINDOWS[window]
    j, t = _both(lambda b: b.add_batch(*_stream(n=400)))
    for o, r in zip(t.segment(t0, t1, max_n), j.segment(t0, t1, max_n)):
        np.testing.assert_array_equal(o, r)
    out_j, out_t = np.zeros((max_n, 8), np.float32), np.zeros((max_n, 8),
                                                              np.float32)
    ts_j, ts_t = np.empty(max_n), np.empty(max_n)
    assert (t.segment_into(t0, t1, out_t, out_ts=ts_t)
            == j.segment_into(t0, t1, out_j, out_ts=ts_j))
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(ts_t, ts_j)
    for fn in ("covers", "count_between"):
        assert getattr(t, fn)(t0, t1) == getattr(j, fn)(t0, t1)
    for tq in (t0, t1, 0.5 * (t0 + t1)):
        for o, r in zip(t.interpolate(tq), j.interpolate(tq)):
            np.testing.assert_array_equal(o, r)


def test_segment_refuses_reversed_window():
    t = tbuf.ImuBuffer()
    t.add_batch(*_stream(n=50))
    with pytest.raises(ValueError):
        t.segment(0.2, 0.1, 16)


@pytest.mark.parametrize("gravity_aligned", [True, False])
@pytest.mark.parametrize("tilt", ["level", "tilted", "upside_down"])
def test_estimate_attitude_matches_jax(gravity_aligned, tilt):
    rng = np.random.default_rng(7)
    n = 600
    f = dict(level=[0.0, 0.0, 9.81], tilted=[1.2, -0.8, 9.6],
             upside_down=[0.0, 0.0, -9.81])[tilt]
    acc = np.asarray(f) + rng.normal(size=(n, 3)) * 0.02
    gyro = np.asarray([1e-3, -2e-3, 5e-4]) + rng.normal(size=(n, 3)) * 1e-3
    ts = np.arange(n) * 0.005
    j, t = _both(lambda b: b.add_batch(ts, acc, gyro))
    args = (2.9, 1.0, 9.81, gravity_aligned)
    ref, out = jbuf.estimate_attitude(j, *args), tbuf.estimate_attitude(t,
                                                                       *args)
    assert sorted(out) == sorted(ref)
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k])
    # too little data waits in both
    assert tbuf.estimate_attitude(t, 0.5, 1.0, 9.81) is None
    assert jbuf.estimate_attitude(j, 0.5, 1.0, 9.81) is None


def test_stage_timer_summary_matches_jax():
    j, t = jtim.StageTimer(), ttim.StageTimer()
    for timer in (j, t):
        for name in ("deskew", "solve", "deskew"):
            with timer.stage(name):
                pass
    sj, st = j.summary(), t.summary()
    assert list(st) == list(sj) == ["deskew", "solve"]
    for k in st:
        assert st[k]["count"] == sj[k]["count"]
        assert st[k]["total_s"] >= 0.0 and set(st[k]) == set(sj[k])
