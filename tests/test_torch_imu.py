"""Parity of the port's imu/preintegration.py with the JAX package.

Same seeded numpy f32 IMU segments through both. Tolerance: rtol 1e-4, with
an absolute floor of 1e-4 x the field's largest magnitude (fields such as
the covariance span many decades; their near-zero entries are rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.imu import preintegration as jpre
from mimosa_tpu_torch.imu import preintegration as tpre

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

RTOL = 1e-4


# the JAX references run jitted: eager dispatch compiles op by op
_STATIC = ("acc_var", "gyro_var", "int_var")
J_PRE = {
    "preintegrate": jax.jit(jpre.preintegrate, static_argnames=_STATIC + (
        "return_prefixes",)),
    "preintegrate_sequential": jax.jit(jpre.preintegrate_sequential,
                                       static_argnames=_STATIC),
}
J_LOC = jax.jit(jpre.localizability, static_argnames=("g_mag",))


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    atol = rtol * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def _segment(seed=0, n=64, n_valid=52):
    rng = np.random.default_rng(seed)
    accs = np.asarray([0.3, -0.2, 9.81]) + rng.normal(size=(n, 3)) * 0.5
    gyros = rng.normal(size=(n, 3)) * 0.4
    dts = np.full(n, 0.005) + rng.uniform(-1e-3, 1e-3, size=n)
    valid = np.arange(n) < n_valid
    bg = rng.normal(size=3) * 0.01
    ba = rng.normal(size=3) * 0.05
    f = {k: v.astype(np.float32) for k, v in
         dict(accs=accs, gyros=gyros, dts=dts, bg=bg, ba=ba).items()}
    f["valid"] = valid
    return f


def _both(seg):
    j = {k: jnp.asarray(v) for k, v in seg.items()}
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in seg.items()}
    return j, t


ARGS = dict(acc_var=1e-3, gyro_var=1e-5, int_var=1e-8)


@pytest.mark.parametrize("oracle", ["preintegrate", "preintegrate_sequential"])
def test_preintegrate_matches_jax(oracle):
    j, t = _both(_segment())
    ref = J_PRE[oracle](j["accs"], j["gyros"], j["dts"], j["bg"],
                                j["ba"], valid=j["valid"], **ARGS)
    out = tpre.preintegrate(t["accs"], t["gyros"], t["dts"], t["bg"],
                            t["ba"], valid=t["valid"], **ARGS)
    for name in tpre.PreintState._fields:
        _close(getattr(out, name).numpy(), getattr(ref, name))


@pytest.mark.parametrize("oracle", ["jax_sequential", "port_preintegrate"])
def test_preintegrate_sequential_matches(oracle):
    """The port's sequential oracle against the JAX package's and against
    the port's own prefix composition, on the same padded segment."""
    j, t = _both(_segment(seed=4))
    out = tpre.preintegrate_sequential(t["accs"], t["gyros"], t["dts"],
                                       t["bg"], t["ba"], valid=t["valid"],
                                       **ARGS)
    if oracle == "jax_sequential":
        ref = J_PRE["preintegrate_sequential"](
            j["accs"], j["gyros"], j["dts"], j["bg"], j["ba"],
            valid=j["valid"], **ARGS)
        ref = [np.asarray(getattr(ref, n)) for n in tpre.PreintState._fields]
    else:
        ref = [v.numpy() for v in tpre.preintegrate(
            t["accs"], t["gyros"], t["dts"], t["bg"], t["ba"],
            valid=t["valid"], **ARGS)]
    for name, r in zip(tpre.PreintState._fields, ref):
        _close(getattr(out, name).numpy(), r)


def test_preintegrate_prefixes_match_jax():
    j, t = _both(_segment(seed=1, n=40, n_valid=40))
    ref = J_PRE["preintegrate"](j["accs"], j["gyros"], j["dts"], j["bg"],
                                j["ba"], acc_var=0.0, gyro_var=0.0,
                                int_var=0.0, return_prefixes=True)
    out = tpre.preintegrate(t["accs"], t["gyros"], t["dts"], t["bg"],
                            t["ba"], 0.0, 0.0, 0.0, return_prefixes=True)
    for name in ("dq", "dv", "dp", "dt", "J_dr_bg", "J_dv_ba"):
        assert getattr(out, name).shape[0] == 40
        _close(getattr(out, name).numpy(), getattr(ref, name))


def _states(seed=2):
    rng = np.random.default_rng(seed)
    q_i = rng.normal(size=4)
    q_j = q_i + rng.normal(size=4) * 0.05
    g = np.asarray([0.02, -0.03, -1.0])
    x = dict(q_i=q_i / np.linalg.norm(q_i), p_i=rng.normal(size=3),
             v_i=rng.normal(size=3), q_j=q_j / np.linalg.norm(q_j),
             p_j=rng.normal(size=3), v_j=rng.normal(size=3),
             bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05,
             g_dir=g / np.linalg.norm(g))
    return {k: v.astype(np.float32) for k, v in x.items()}


def _preint_pair():
    j, t = _both(_segment(seed=3))
    ref = J_PRE["preintegrate"](j["accs"], j["gyros"], j["dts"], j["bg"],
                                j["ba"], valid=j["valid"], **ARGS)
    # feed the port the JAX deltas, so residual/localizability are compared
    # on identical preintegration inputs
    out = tpre.PreintState(*[torch.tensor(np.asarray(a)) for a in ref])
    return ref, out


@pytest.mark.parametrize("fn", ["residual", "predict", "correct_deltas"])
def test_residual_predict_correct_match_jax(fn):
    pj, pt = _preint_pair()
    x = _states()
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    if fn == "residual":
        ref = [jpre.residual(pj, **xj, g_mag=9.81)]
        out = [tpre.residual(pt, **xt, g_mag=9.81)]
    elif fn == "predict":
        args = ("q_i", "p_i", "v_i")
        ref = jpre.predict(pj, *[xj[a] for a in args], xj["g_dir"] * 9.81)
        out = tpre.predict(pt, *[xt[a] for a in args], xt["g_dir"] * 9.81)
    else:
        ref = jpre.correct_deltas(pj, xj["bg"], xj["ba"])
        out = tpre.correct_deltas(pt, xt["bg"], xt["ba"])
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


def test_localizability_matches_jax():
    pj, pt = _preint_pair()
    x = _states()
    ref = J_LOC(pj, **{k: jnp.asarray(v) for k, v in x.items()},
                              g_mag=9.81)
    out = tpre.localizability(pt, **{k: torch.from_numpy(v)
                                     for k, v in x.items()}, g_mag=9.81)
    # H spans ~1e3..1e9 (cov whitening): 1e-4 of each block's scale
    _close(out["H"].numpy(), ref["H"])
    for k in ("eig_rot", "eig_pos", "eig_vel"):
        _close(out[k].numpy(), ref[k])


def test_jacobian_matches_jax_jacfwd():
    """torch.func.jacfwd of the residual against jax.jacfwd (the Jacobians
    feed every IMU factor of the window)."""
    pj, pt = _preint_pair()
    x = _states()
    lin_keys = ("q_i", "p_i", "v_i", "q_j", "p_j", "v_j", "bg", "ba", "g_dir")
    fj, ft = jpre.make_residual_fn(9.81), tpre.make_residual_fn(9.81)
    zj = [jnp.zeros(k, jnp.float32) for k in (9, 9, 6, 2)]
    zt = [torch.zeros(k) for k in (9, 9, 6, 2)]
    ref = jax.jit(jax.jacfwd(fj, argnums=(0, 1, 2, 3)))(
        *zj, pj, tuple(jnp.asarray(x[k]) for k in lin_keys))
    out = torch.func.jacfwd(ft, argnums=(0, 1, 2, 3))(
        *zt, pt, tuple(torch.from_numpy(x[k]) for k in lin_keys))
    for o, r in zip(out, ref):
        _close(o.numpy(), r)
