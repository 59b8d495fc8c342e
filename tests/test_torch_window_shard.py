"""The port's window-sharded batch adjustment (``parallel/window_shard.py``)
against the JAX package's dense oracle.

The batch is ``tests/test_window_shard.py``'s: K=16 states along
``test_window.simulate``'s trajectory, its IMU chain preintegrated between
them, seeded measurement quadratics (``rand_meas``) and a dead segment.
The states, the chain and the quadratics are made once (the chain by the
port's preintegration in f64) and go as the same numpy arrays into the
JAX package's dense step (``window.build_system`` + ``window.solve``, the
JAX test's ``dense_gn_step``) and into the port's ``distributed_gn_step``:

* world size 1, f64: the JAX test's gate, atol 1e-8 of the step's scale
  and rtol 1e-6;
* world size 1, f32: the port's error against the f64 oracle within 3x
  the dense f32 oracle's own (the JAX test's f32 gate);
* four ranks of a gloo group (``tests/torch_shard_worker.py``, one
  process each): every rank returns the whole step, within the f64 gate;
* ``batch_adjust`` pulls a noisy trajectory back to the truth from pose
  measurements of every fourth state (the JAX test's gates).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import window as jwin
from mimosa_tpu.imu import preintegration as jpre
from mimosa_tpu_torch.core import lie as tlie
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.imu import preintegration as tpre
from mimosa_tpu_torch.parallel import window_shard as tws

import test_window_shard as jtest
from test_window import simulate
from torch_fixtures import one_thread_then_free_programs  # noqa: F401

K = jtest.K
DEAD = 5                 # the dead IMU segment (test_window_shard.py)
RANKS = 4
WORKER_TIMEOUT = 40      # [s] for the gloo ranks to start, solve and exit


def _batch(seed=0, state_noise=0.0):
    """(states [q, p, v, bg, ba, g] as f64 numpy, the preintegrated chain
    as a dict of [K-1, ...] f64 arrays, ground truth (q, p)): the batch of
    ``test_window_shard.build_batch``, its chain from the port's
    preintegration."""
    states, segs, dt = simulate(T=2.0, imu_rate=200, state_rate=10,
                                seed=seed)
    rng = np.random.default_rng(seed + 1)
    qs, ps, vs = [], [], []
    for k in range(K):
        q, p, v = (np.asarray(x, np.float64) for x in states[k])
        if state_noise and k > 0:
            q = tlie.quat_mul(torch.from_numpy(q), tlie.exp_so3(
                torch.from_numpy(rng.normal(size=3) * state_noise))).numpy()
            p = p + rng.normal(size=3) * state_noise
            v = v + rng.normal(size=3) * state_noise
        qs.append(q), ps.append(p), vs.append(v)
    z3 = torch.zeros(3, dtype=torch.float64)
    chain = [tpre.preintegrate(
        torch.tensor(np.asarray(a), dtype=torch.float64),
        torch.tensor(np.asarray(g), dtype=torch.float64),
        torch.full((len(a),), dt, dtype=torch.float64), z3, z3, 1e-4, 1e-5)
        for a, g in segs[:K - 1]]
    preints = {f: torch.stack([getattr(c, f) for c in chain]).numpy()
               for f in tpre.PreintState._fields}
    x = [np.asarray(qs), np.asarray(ps), np.asarray(vs), np.zeros((K, 3)),
         np.zeros((K, 3)), np.array([0.0, 0.0, -1.0])]
    gt = (np.asarray([s[0] for s in states[:K]]),
          np.asarray([s[1] for s in states[:K]]))
    return x, preints, gt


def _meas():
    mH, mb = jtest.rand_meas(jnp.float64)
    return np.asarray(mH), np.asarray(mb)


def _fv(dead=True):
    fv = np.ones(K - 1, bool)
    if dead:
        fv[DEAD] = False
    return fv


_DENSE = jax.jit(jtest.dense_gn_step, static_argnums=(10,))


def _jax_dense(x, preints, fv, mH, mb, dtype):
    """The JAX oracle's step (dx [K,15], dg [2]) in ``dtype``."""
    c = lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype.kind == "f" \
        else jnp.asarray(a)  # noqa: E731
    pre_j = jpre.PreintState(**{k: c(v) for k, v in preints.items()})
    dx, dg = _DENSE(*(c(a) for a in x), pre_j, jnp.asarray(fv), c(mH),
                    c(mb), jwin.WindowConfig(K=K, damping=1e-6))
    return np.asarray(dx, np.float64), np.asarray(dg, np.float64)


def _port_step(x, preints, fv, mH, mb, dtype, damping=1e-6):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    q, p, v, bg, ba, g = (t(a) for a in x)
    pre_t = tpre.PreintState(*[t(preints[f])
                               for f in tpre.PreintState._fields])
    cfg = twin.WindowConfig(K=K, damping=damping)
    prior = tws.anchor_prior(q, p, v, bg, ba, g,
                             (q[0], p[0], v[0], bg[0], ba[0], g), cfg)
    dx, dg = tws.distributed_gn_step(q, p, v, bg, ba, g, pre_t,
                                     torch.from_numpy(fv), t(mH), t(mb),
                                     cfg, prior)
    return dx.double().numpy(), dg.double().numpy()


@pytest.fixture(scope="module")
def batch():
    x, preints, _ = _batch()
    mH, mb = _meas()
    fv = _fv()
    dxd, dgd = _jax_dense(x, preints, fv, mH, mb, jnp.float64)
    return dict(x=x, preints=preints, fv=fv, mH=mH, mb=mb, dxd=dxd, dgd=dgd)


def _assert_f64_gate(dx, dg, b):
    scale = max(float(np.abs(b["dxd"]).max()), 1e-9)
    np.testing.assert_allclose(dx, b["dxd"], atol=1e-8 * scale, rtol=1e-6)
    np.testing.assert_allclose(dg, b["dgd"], atol=1e-8, rtol=1e-6)


def test_distributed_step_matches_dense_f64(batch):
    dx, dg = _port_step(batch["x"], batch["preints"], batch["fv"],
                        batch["mH"], batch["mb"], torch.float64)
    _assert_f64_gate(dx, dg, batch)
    # the dead segment decouples nothing by itself: the step is not zero
    assert np.abs(dx).max() > 1e-3


def test_distributed_step_f32_close(batch):
    """Production dtype: the port's f32 step within 3x the dense f32 step's
    own error against the f64 truth (cond ~1e9 from the tight IMU
    information against the soft measurement blocks)."""
    b = batch
    fv = _fv(dead=False)
    dxd, _ = _jax_dense(b["x"], b["preints"], fv, b["mH"], b["mb"],
                        jnp.float64)
    dx32, _ = _jax_dense(b["x"], b["preints"], fv, b["mH"], b["mb"],
                         jnp.float32)
    dxs, _ = _port_step(b["x"], b["preints"], fv, b["mH"], b["mb"],
                        torch.float32)
    assert np.isfinite(dxs).all()
    denom = max(float(np.linalg.norm(dxd)), 1e-9)
    err_dense32 = float(np.linalg.norm(dx32 - dxd)) / denom
    err_port32 = float(np.linalg.norm(dxs - dxd)) / denom
    assert err_port32 < max(3.0 * err_dense32, 1e-4), \
        (err_port32, err_dense32)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_four_gloo_ranks_match_dense_f64(batch, tmp_path):
    """Four CPU processes in one gloo group, a shard each (K=16: 4 states a
    shard, the interface system all-reduced, the step all-gathered): every
    rank returns the whole step of the dense oracle."""
    b = batch
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, q=b["x"][0], p=b["x"][1], v=b["x"][2], bg=b["x"][3],
             ba=b["x"][4], g=b["x"][5], fv=b["fv"], meas_H=b["mH"],
             meas_b=b["mb"], damping=1e-6,
             **{"pre_" + k: v for k, v in b["preints"].items()})
    worker = os.path.join(os.path.dirname(__file__), "torch_shard_worker.py")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker, addr, str(RANKS), str(r), str(inputs),
         str(tmp_path / f"out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(RANKS)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    for r in range(RANKS):
        out = np.load(tmp_path / f"out{r}.npz")
        assert tuple(out["shard"]) == (r, RANKS)
        _assert_f64_gate(out["dx"], out["dg"], b)


def test_batch_adjust_recovers_trajectory():
    """Noisy initial states and pose measurements of every fourth state:
    the batch adjustment pulls the trajectory back to the truth, the IMU
    chain carrying the states between the anchors
    (``test_window_shard.py::test_batch_adjust_recovers_trajectory``)."""
    dt = torch.float64
    x, preints, (q_gt, p_gt) = _batch(seed=2, state_noise=0.05)
    q0, p0, v0, bg0, ba0, g = (torch.tensor(a, dtype=dt) for a in x)
    pre_t = tpre.PreintState(*[torch.tensor(preints[f], dtype=dt)
                               for f in tpre.PreintState._fields])
    qg, pg = torch.tensor(q_gt, dtype=dt), torch.tensor(p_gt, dtype=dt)
    anchored = np.zeros(K, bool)
    anchored[::4] = True
    on = torch.tensor(anchored, dtype=dt)
    wgt = 1e4
    SD = twin.SD

    def meas_fn(q, p, v, bg, ba, g):
        r = tlie.se3_local(qg, pg, q, p)
        H = torch.zeros((K, SD, SD), dtype=dt)
        H[:, :6, :6] = torch.eye(6, dtype=dt) * (wgt * on)[:, None, None]
        b = torch.zeros((K, SD), dtype=dt)
        b[:, :6] = wgt * on[:, None] * r
        return H, b

    cfg = twin.WindowConfig(K=K, damping=1e-9)
    err0 = float(np.linalg.norm(x[1] - p_gt, axis=-1).max())
    q, p, *_ = tws.batch_adjust(q0, p0, v0, bg0, ba0, g, pre_t,
                                torch.ones(K - 1, dtype=torch.bool), meas_fn,
                                cfg, iters=4)
    e = np.linalg.norm(p.numpy() - p_gt, axis=-1)
    assert e.max() < 0.1 * err0, (err0, e.max())
    assert e[~anchored].max() < 0.05, e[~anchored].max()


def test_shard_count_must_divide_k():
    x, preints, _ = _batch()
    with pytest.raises(ValueError, match="multiple of n_wp"):
        _port_step([a[:1] if a.ndim == 2 else a for a in x],
                   {k: v[:0] for k, v in preints.items()}, _fv()[:0],
                   *_meas(), torch.float64)
