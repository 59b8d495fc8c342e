"""The port's trajectory metrics and IMU-rate propagator against the JAX
package's.

* ``utils/evaluation.py``: ``load_tum``, ``associate``, ``umeyama_align``,
  ``ate`` and ``rte`` on seeded trajectories, equal to the JAX package's
  at 1e-9 (both are numpy in float64);
* ``imu/propagation.py``: ``Propagator`` on ``tests/test_propagation.py``'s
  four cases and a seeded stream with rebases, bit for bit equal to the
  JAX package's (the same float64 arithmetic in the same order), and the
  cases' own checks on the port.
"""

import numpy as np
import pytest

from mimosa_tpu.imu import propagation as jprop
from mimosa_tpu.utils import evaluation as jev
from mimosa_tpu_torch.imu import propagation as tprop
from mimosa_tpu_torch.utils import evaluation as tev

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

TOL = 1e-9


def _trajectories(seed, n=400, length=30.0):
    """(est_ts, est_p, gt_ts, gt_p): a smooth ground-truth path of about
    ``length`` m at 10 Hz, and an estimate on a jittered clock that is
    rotated, shifted and noisy."""
    rng = np.random.default_rng(seed)
    gt_ts = 100.0 + np.arange(n) * 0.1
    s = np.linspace(0.0, 1.0, n)
    gt_p = np.stack([length / 2 * np.cos(2 * s), length / 3 * np.sin(3 * s),
                     0.5 * np.sin(7 * s)], -1)
    a = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]])
    est_ts = gt_ts[::2] + rng.uniform(-0.015, 0.015, len(gt_ts[::2]))
    est_p = gt_p[::2] @ R.T + rng.normal(size=3) + \
        rng.normal(size=(len(est_ts), 3)) * 0.05
    return est_ts, est_p, gt_ts, gt_p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    est_ts, est_p, gt_ts, gt_p = _trajectories(seed)
    for max_diff in (0.02, 0.01):
        ji = jev.associate(est_ts, gt_ts, max_diff)
        ti = tev.associate(est_ts, gt_ts, max_diff)
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a, b)
    for with_scale in (False, True):
        for a, b in zip(jev.umeyama_align(est_p, gt_p[::2], with_scale),
                        tev.umeyama_align(est_p, gt_p[::2], with_scale)):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    for align in (True, False):
        np.testing.assert_allclose(
            tev.ate(est_ts, est_p, gt_ts, gt_p, align=align),
            jev.ate(est_ts, est_p, gt_ts, gt_p, align=align), atol=TOL)
    for delta, all_pairs in ((10.0, True), (5.0, False)):
        r = tev.rte(est_ts, est_p, gt_ts, gt_p, delta, all_pairs=all_pairs)
        assert np.isfinite(r)
        np.testing.assert_allclose(
            r, jev.rte(est_ts, est_p, gt_ts, gt_p, delta,
                       all_pairs=all_pairs), atol=TOL)


def test_rte_is_nan_below_the_delta():
    """A path shorter than the 10 m delta has no pair to score: NaN in both
    packages (and NaN fails any ``rte < gate`` check)."""
    est_ts, est_p, gt_ts, gt_p = _trajectories(0, n=60, length=3.0)
    assert np.isnan(tev.rte(est_ts, est_p, gt_ts, gt_p))
    assert np.isnan(jev.rte(est_ts, est_p, gt_ts, gt_p))
    assert not tev.rte(est_ts, est_p, gt_ts, gt_p) < 2.0
    # fewer than three associated poses
    assert np.isnan(tev.ate(est_ts[:2], est_p[:2], gt_ts, gt_p))


def test_load_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    rows = np.concatenate([np.arange(20)[:, None] * 0.1 + 5.0,
                           rng.normal(size=(20, 7))], 1)
    path = tmp_path / "traj.tum"
    np.savetxt(path, rows)
    for a, b in zip(jev.load_tum(path), tev.load_tum(path)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    one = tmp_path / "one.tum"
    np.savetxt(one, rows[:1])
    ts, p, q = tev.load_tum(one)
    assert ts.shape == (1,) and p.shape == (1, 3) and q.shape == (1, 4)
    np.testing.assert_array_equal(q[0], rows[0, [7, 4, 5, 6]])


G = np.array([0.0, 0.0, -9.81])
BASE = ([1, 0, 0, 0], [0, 0, 0], [0, 0, 0])


def _prop_case(mod, case):
    """Run one of tests/test_propagation.py's cases on module ``mod``'s
    Propagator; returns the outputs and the final state."""
    prop = mod.Propagator()
    outs = []
    if case == "stationary":
        prop.set_base_state(0.0, *BASE, [0, 0, 0], [0, 0, 0], [0, 0, -1.0])
        for k in range(1, 101):
            outs.append(prop.add_imu(k * 0.005, -G, [0, 0, 0]))
    elif case == "constant_acceleration":
        prop.set_base_state(0.0, *BASE, [0, 0, 0], [0, 0, 0], [0, 0, -1.0])
        a = np.array([1.0, 0, 0])
        for k in range(1, 201):
            outs.append(prop.add_imu(k * 0.005, a - G, [0, 0, 0]))
    elif case == "catchup_replay":
        prop.set_base_state(0.0, *BASE, [0, 0, 0], [0, 0, 0], [0, 0, -1.0])
        a = np.array([1.0, 0, 0])
        for k in range(1, 101):
            outs.append(prop.add_imu(k * 0.005, a - G, [0, 0, 0]))
        prop.set_base_state(0.25, [1, 0, 0, 0], [0.5 * 0.25**2, 0, 0],
                            [0.25, 0, 0], [0, 0, 0], [0, 0, 0],
                            [0, 0, -1.0])
    elif case == "bias_correction":
        bg = np.array([0.01, -0.02, 0.005])
        prop.set_base_state(0.0, *BASE, bg, [0, 0, 0], [0, 0, -1.0])
        for k in range(1, 101):
            outs.append(prop.add_imu(k * 0.005, -G, bg))
    return outs, prop


CASES = ("stationary", "constant_acceleration", "catchup_replay",
         "bias_correction")


@pytest.mark.parametrize("case", CASES)
def test_propagator_matches_jax_bitwise(case):
    jouts, jp = _prop_case(jprop, case)
    touts, tp = _prop_case(tprop, case)
    assert len(jouts) == len(touts)
    for a, b in zip(jouts, touts):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for name in ("q", "p", "v", "ts"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))


@pytest.mark.parametrize("case", CASES)
def test_propagator_cases_hold_on_the_port(case):
    """tests/test_propagation.py's own checks, on the port's Propagator."""
    outs, prop = _prop_case(tprop, case)
    q, p, v = outs[-1]
    if case == "stationary":
        np.testing.assert_allclose(p, 0.0, atol=1e-9)
        np.testing.assert_allclose(v, 0.0, atol=1e-9)
    elif case == "constant_acceleration":
        np.testing.assert_allclose(v, [1.0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(p, [0.5, 0, 0], atol=1e-2)
    elif case == "catchup_replay":
        assert abs(prop.ts - 0.5) < 1e-9
        np.testing.assert_allclose(prop.v, v, atol=1e-6)
    else:
        np.testing.assert_allclose(q, [1, 0, 0, 0], atol=1e-9)


def test_propagator_stream_with_rebases_matches_jax_bitwise():
    """A seeded 400 Hz stream with rotation, biases and a rebase every
    0.1 s at a time 30 ms in the past (the online estimator's catch-up)."""
    rng = np.random.default_rng(5)
    ts = np.arange(1, 801) * 0.0025
    acc = rng.normal(size=(len(ts), 3)) + [0, 0, 9.81]
    gyro = rng.normal(size=(len(ts), 3)) * 0.3
    props = [jprop.Propagator(), tprop.Propagator()]
    outs = [[], []]
    for k, t in enumerate(ts):
        if k % 40 == 39:
            q = rng.normal(size=4)
            base = (t - 0.03, q / np.linalg.norm(q), rng.normal(size=3),
                    rng.normal(size=3), rng.normal(size=3) * 0.01,
                    rng.normal(size=3) * 0.1, [0, 0, -1.0])
            for pr in props:
                pr.set_base_state(*base)
        for pr, o in zip(props, outs):
            o.append(pr.add_imu(t, acc[k], gyro[k]))
    for a, b in zip(*outs):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
