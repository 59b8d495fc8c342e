"""Parity of the port's graph/window.py with the JAX package at K=4 and K=8.

One seeded numpy f32 window state (estimates, a dense SPD prior spanning
the real 1e-1..1e7 information scales, IMU segments) goes into both
packages through ``mimosa_tpu_torch.convert``. Tolerances: normal-equation
entries rtol 1e-4 with an absolute floor of 1e-5 x the matrix's largest
entry (f32 assembly in another order); solves are compared by relative
error norm (< 1e-3 on the assembled systems, < 1e-2 against f64 on the
ill-conditioned case, the JAX test's gate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import window as jwin
from mimosa_tpu.imu import preintegration as jpre
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.imu import preintegration as tpre

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

j_preint = jax.jit(jpre.preintegrate, static_argnames=(
    "acc_var", "gyro_var", "int_var"))


def _close(out, ref, rtol=1e-4, floor=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    atol = floor * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30)


def _state(K, n_active, seed=0):
    """A plausible window: states along a path, linearization points a
    little off, an SPD prior, and K-1 preintegrated IMU segments."""
    rng = np.random.default_rng(seed)
    cfg = twin.WindowConfig(K=K)
    D = cfg.D
    q = rng.normal(size=(K, 4)) * 0.05 + np.asarray([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.cumsum(rng.normal(size=(K, 3)) * 0.1, axis=0)
    v = rng.normal(size=(K, 3)) * 0.5
    bg = rng.normal(size=(K, 3)) * 1e-3
    ba = rng.normal(size=(K, 3)) * 1e-2
    lin_q = q + rng.normal(size=(K, 4)) * 1e-3
    lin_q /= np.linalg.norm(lin_q, axis=-1, keepdims=True)
    g = np.asarray([0.01, -0.02, -1.0])
    g /= np.linalg.norm(g)
    lin_g = g + np.asarray([1e-3, 0.0, 0.0])
    lin_g /= np.linalg.norm(lin_g)
    scales = 10.0 ** rng.uniform(-1, 7, D)
    A = rng.normal(size=(D, D))
    H = (A @ A.T / D + np.eye(D)) * np.sqrt(np.outer(scales, scales))
    win = dict(q=q, p=p, v=v, bg=bg, ba=ba, g_dir=g,
               ts=np.arange(K) * 0.1, active=np.arange(K) < n_active,
               H_prior=H, b_prior=rng.normal(size=D) * np.sqrt(scales),
               lin_q=lin_q, lin_p=p + rng.normal(size=(K, 3)) * 1e-3,
               lin_v=v + rng.normal(size=(K, 3)) * 1e-3,
               lin_bg=bg.copy(), lin_ba=ba.copy(), lin_g=lin_g)
    win = {k: np.asarray(a, np.float32) if a.dtype != bool else a
           for k, a in win.items()}
    segs = []
    for i in range(K - 1):
        m = 24
        accs = (np.asarray([0.1, 0.0, 9.81]) + rng.normal(size=(m, 3)) * 0.2)
        gyros = rng.normal(size=(m, 3)) * 0.2
        dts = np.full(m, 0.1 / m)
        seg = j_preint(*(jnp.asarray(a, jnp.float32) for a in (
            accs, gyros, dts, bg[i], ba[i])), acc_var=1e-3, gyro_var=1e-5,
            int_var=1e-8)
        segs.append(seg)
    preints = {k: np.stack([np.asarray(getattr(s, k)) for s in segs])
               for k in jpre.PreintState._fields}
    fv = np.arange(K - 1) < n_active - 1
    return cfg, win, preints, fv


def _jax(win, preints):
    return (jwin.Window(**{k: jnp.asarray(v) for k, v in win.items()}),
            jpre.PreintState(**{k: jnp.asarray(v)
                                for k, v in preints.items()}))


def _torch(win, preints):
    return (convert.tuple_from_numpy(twin.Window, win),
            convert.tuple_from_numpy(tpre.PreintState, preints))


def _jcfg(cfg):
    return jwin.WindowConfig(K=cfg.K)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("cached", [False, True])
def test_build_system_and_solve_match_jax(K, cached):
    cfg, win, preints, fv = _state(K, n_active=K)
    jw, jp = _jax(win, preints)
    tw, tp = _torch(win, preints)
    rng = np.random.default_rng(1)
    Jm = rng.normal(size=(50, 6)).astype(np.float32)
    Hm = (Jm.T @ Jm * 400.0).astype(np.float32)
    bm = rng.normal(size=6).astype(np.float32) * 10
    slot = K - 1
    jcfg = _jcfg(cfg)

    @jax.jit
    def jbuild(w, p, fv_):
        cache = jwin.imu_factor_cache(w, p, jcfg) if cached else None
        H, rhs = jwin.build_system(
            w, p, fv_, jcfg, meas=[(jwin.pose_idx(slot), jnp.asarray(Hm),
                                    jnp.asarray(bm))], imu_cache=cache)
        return H, rhs, jwin.solve(H, rhs)

    Hj, rj, dxj = jbuild(jw, jp, jnp.asarray(fv))
    cache = twin.imu_factor_cache(tw, tp, cfg) if cached else None
    Ht, rt = twin.build_system(
        tw, tp, torch.from_numpy(fv), cfg,
        meas=[(twin.pose_idx(torch.tensor(slot)), torch.from_numpy(Hm),
               torch.from_numpy(bm))], imu_cache=cache)
    _close(Ht.numpy(), Hj)
    _close(rt.numpy(), rj)
    dxt = twin.solve(Ht, rt)
    assert np.all(np.isfinite(dxt.numpy()))
    assert _rel_err(dxt.numpy(), dxj) < 1e-3


def test_imu_block_matches_jax():
    """One whitened IMU factor (J [9,26], r [9]) between slots 0 and 1."""
    cfg, win, preints, _ = _state(4, n_active=4, seed=5)
    jw, jp = _jax(win, preints)
    tw, tp = _torch(win, preints)

    def args(w, p, seg):
        return (seg, w.q[0], w.p[0], w.v[0], w.bg[0], w.ba[0], w.q[1],
                w.p[1], w.v[1], w.g_dir, cfg.g_mag)

    Jj, rj = jax.jit(jwin.imu_block, static_argnums=10)(*args(
        jw, jp, jpre.PreintState(*(a[0] for a in jp))))
    Jt, rt = twin.imu_block(*args(tw, tp, tpre.PreintState(
        *(a[0] for a in tp))))
    _close(Jt.numpy(), Jj, rtol=1e-4, floor=1e-5)
    _close(rt.numpy(), rj, rtol=1e-3, floor=1e-4)


def test_solve_ill_conditioned_f32():
    """A PD system mixing ~1e7 and ~1e-1 information (condition > 1e8) must
    solve finite and close to f64 in f32, as the JAX test requires — and
    agree with the JAX solve."""
    rng = np.random.default_rng(0)
    n = 90
    scales = 10.0 ** rng.uniform(-1, 7, n)
    A = rng.standard_normal((n, n))
    H64 = (A @ A.T / n + np.eye(n)) * np.outer(scales, scales) ** 0.5
    rhs64 = rng.standard_normal(n) * scales ** 0.5
    assert np.linalg.cond(H64) > 1e8
    dx64 = np.linalg.solve(H64, rhs64)
    dxt = twin.solve(torch.tensor(H64, dtype=torch.float32),
                     torch.tensor(rhs64, dtype=torch.float32)).numpy()
    dxj = np.asarray(jax.jit(jwin.solve)(jnp.asarray(H64, jnp.float32),
                                         jnp.asarray(rhs64, jnp.float32)))
    assert np.all(np.isfinite(dxt))
    assert _rel_err(dxt, dx64) < 1e-2
    assert _rel_err(dxt, dxj) < 1e-2


def test_solve_failure_holds_state():
    """An indefinite system whose Cholesky fails gives a zero update."""
    H = torch.diag(torch.tensor([1.0, -2.0, 3.0]))
    dx = twin.solve(H, torch.ones(3))
    assert torch.equal(dx, torch.zeros(3))


@pytest.mark.parametrize("K", [4, 8])
def test_marginalize_oldest_matches_jax(K):
    cfg, win, preints, _ = _state(K, n_active=K, seed=2)
    jw, jp = _jax(win, preints)
    tw, tp = _torch(win, preints)
    ref = jax.jit(functools.partial(jwin.marginalize_oldest,
                                    cfg=_jcfg(cfg)))(jw, jp)
    out = twin.marginalize_oldest(tw, tp, cfg)
    for name in twin.Window._fields:
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        if o.dtype == bool:
            np.testing.assert_array_equal(o, r)
        elif name in ("H_prior", "b_prior"):
            # the Schur complement of an equilibrated f32 system
            _close(o, r, rtol=1e-3, floor=1e-4)
        else:
            _close(o, r)


@pytest.mark.parametrize("K", [4, 8])
def test_window_bookkeeping_matches_jax(K):
    cfg, win, preints, _ = _state(K, n_active=K - 1, seed=3)
    jw, _ = _jax(win, preints)
    tw, _ = _torch(win, preints)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(4)
    dx = (rng.normal(size=cfg.D) * 1e-2).astype(np.float32)
    new = [np.asarray(a, np.float32) for a in (
        [0.99, 0.0, 0.1, 0.0], [1, 2, 3], [0.1, 0, 0], [0, 0, 0], [0, 0, 0],
        0.5)]
    new[0] /= np.linalg.norm(new[0])
    pairs = [
        (jwin.local_delta(jw, jcfg), twin.local_delta(tw, cfg)),
        (jwin.apply_update(jw, jnp.asarray(dx), jcfg),
         twin.apply_update(tw, torch.from_numpy(dx), cfg)),
        (jwin.rebase_prior(jw, jcfg), twin.rebase_prior(tw, cfg)),
        (jwin.init_priors(jw, jcfg), twin.init_priors(tw, cfg)),
        (jwin.append_state(jw, *map(jnp.asarray, new)),
         twin.append_state(tw, *map(torch.from_numpy, new))),
    ]
    for ref, out in pairs:
        if torch.is_tensor(out):
            _close(out.numpy(), ref)
            continue
        for name in twin.Window._fields:
            o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
            if o.dtype == bool:
                np.testing.assert_array_equal(o, r)
            else:
                _close(o, r)
