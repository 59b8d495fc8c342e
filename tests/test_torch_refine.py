"""The port's batch smoother (``graph/refine.smooth``) against the JAX
package's (``mimosa_tpu/graph/refine.smooth``, ``mesh=None``).

Both smooth the same finished replay, given as a duck-typed Sequencer: the
24 rows of a 3.5 s synthetic room's ground truth with seeded noise on
their poses (0.005 rad, 0.01 m), seeded SPD pose-information blocks
(``pose_info_records``) with every fifth row zero (those get the weak
anchor), and the sequence's synthetic IMU stream (noise 0.01). The
smoothed positions [m] and quaternions agree within 1e-9 in f64 and 1e-5
in f32 (measured: 2.2e-16 and 4.8e-7; the IMU chain is composed in
another order); the port's smoother moves the noisy positions toward the
truth.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import refine as jref
from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu_torch.core import lie as tlie
from mimosa_tpu_torch.graph import refine as tref
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

TOL = {"float64": 1e-9, "float32": 1e-5}


@pytest.fixture(scope="module")
def replay():
    """The finished replay's host arrays and the IMU stream."""
    data = tsyn.generate(tsyn.room_world(),
                         tsyn.TrajectoryConfig(t_total=3.5),
                         tsyn.LidarModel(n_rows=8, n_cols=64), seed=0,
                         imu_noise=0.01)
    gt = data["gt"]
    K0 = len(gt["ts"])
    rng = np.random.default_rng(0)
    q = tlie.quat_mul(torch.from_numpy(gt["quat"]), tlie.exp_so3(
        torch.from_numpy(rng.normal(size=(K0, 3)) * 0.005))).numpy()
    p = gt["pos"] + rng.normal(size=(K0, 3)) * 0.01
    A = rng.normal(size=(K0, 6, 6))
    H6 = (A @ A.transpose(0, 2, 1) / 6.0 + np.eye(6)) * 1e4
    H6[::5] = 0.0
    return dict(ts=gt["ts"], q=q, p=p, H6=H6, gt=gt, imu=data["imu"])


def _duck(r, pkg, dtype):
    """A finished replay as the smoother reads it, in the JAX package's or
    the port's arrays."""
    if pkg == "jax":
        arr = lambda a: jnp.asarray(a, getattr(jnp, dtype))  # noqa: E731
        cfg, wcfg = jseq.SequencerConfig(), jwin.WindowConfig()
    else:
        arr = lambda a: torch.tensor(a, dtype=getattr(torch, dtype))  # noqa
        cfg, wcfg = tseq.SequencerConfig(), twin.WindowConfig()
    return types.SimpleNamespace(
        _traj_ts=list(r["ts"]), traj_q=arr(r["q"]), traj_p=arr(r["p"]),
        window=types.SimpleNamespace(p=arr(np.zeros((1, 3))),
                                     g_dir=arr([0.0, 0.0, -1.0])),
        cfg=cfg, win_cfg=wcfg,
        pose_info_records=lambda: r["H6"].astype(dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_smooth_matches_jax(replay, dtype):
    imu = replay["imu"]
    args = (imu["ts"], imu["acc"], imu["gyro"])
    ts_j, q_j, p_j = jref.smooth(_duck(replay, "jax", dtype), *args)
    ts_t, q_t, p_t = tref.smooth(_duck(replay, "torch", dtype), *args)
    assert q_t.dtype == p_t.dtype == np.float64
    np.testing.assert_array_equal(ts_t, ts_j)
    assert p_t.shape == (len(replay["ts"]), 3) and q_t.shape[1] == 4
    tol = TOL[dtype]
    print(f"{dtype}: largest position gap {np.abs(p_t - p_j).max():.2e} m, "
          f"quaternion {np.abs(q_t - q_j).max():.2e}")
    np.testing.assert_allclose(p_t, p_j, atol=tol, rtol=0)
    np.testing.assert_allclose(q_t, q_j, atol=tol, rtol=0)
    # the smoother moves the noisy rows toward the truth
    gt = replay["gt"]["pos"]
    err0 = np.linalg.norm(replay["p"] - gt, axis=-1).mean()
    err1 = np.linalg.norm(p_t - gt, axis=-1).mean()
    assert err1 < err0, (err0, err1)


def test_smooth_refuses_a_short_or_long_trajectory(replay):
    imu = replay["imu"]
    short = dict(replay, ts=replay["ts"][:2])
    with pytest.raises(ValueError, match="too short"):
        tref.smooth(_duck(short, "torch", "float32"), imu["ts"], imu["acc"],
                    imu["gyro"])
    with pytest.raises(ValueError, match="max_states"):
        tref.smooth(_duck(replay, "torch", "float32"), imu["ts"],
                    imu["acc"], imu["gyro"], max_states=8)
