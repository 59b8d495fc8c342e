"""Parity of the port's core/lie.py and core/eigh3.py with the JAX package.

The same seeded numpy f32 inputs go through both; outputs must agree to
atol 1e-6 / rtol 1e-5 (f32 rounding of the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.core import eigh3 as jeig
from mimosa_tpu.core import lie as jlie
from mimosa_tpu_torch.core import eigh3 as teig
from mimosa_tpu_torch.core import lie as tlie

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

ATOL, RTOL = 1e-6, 1e-5
N = 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.normal(size=(N, 4))
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    g = rng.normal(size=(N, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    g2 = g + 0.05 * rng.normal(size=(N, 3))
    g2 /= np.linalg.norm(g2, axis=-1, keepdims=True)
    phi = rng.normal(size=(N, 3)) * 0.8
    phi[:4] *= 1e-8                      # Taylor branches
    return {k: v.astype(np.float32) for k, v in dict(
        q=q, q2=q2, v=rng.normal(size=(N, 3)), t=rng.normal(size=(N, 3)),
        t2=rng.normal(size=(N, 3)), phi=phi,
        xi=rng.normal(size=(N, 6)) * 0.3, g=g, g2=g2,
        d2=rng.normal(size=(N, 2)) * 0.1).items()}


CASES = {
    "quat_mul": (lambda m, x: m.quat_mul(x["q"], x["q2"])),
    "quat_conj": (lambda m, x: m.quat_conj(x["q"])),
    "quat_rotate": (lambda m, x: m.quat_rotate(x["q"], x["v"])),
    "quat_to_mat": (lambda m, x: m.quat_to_mat(x["q"])),
    "hat": (lambda m, x: m.hat(x["v"])),
    "exp_so3": (lambda m, x: m.exp_so3(x["phi"])),
    "log_so3": (lambda m, x: m.log_so3(x["q"])),
    "right_jacobian_so3": (lambda m, x: m.right_jacobian_so3(x["phi"])),
    "left_jacobian_so3": (lambda m, x: m.left_jacobian_so3(x["phi"])),
    "se3_compose": (lambda m, x: m.se3_compose(x["q"], x["t"], x["q2"],
                                               x["t2"])),
    "se3_inverse": (lambda m, x: m.se3_inverse(x["q"], x["t"])),
    "se3_transform": (lambda m, x: m.se3_transform(x["q"], x["t"], x["v"])),
    "se3_retract": (lambda m, x: m.se3_retract(x["q"], x["t"], x["xi"])),
    "se3_local": (lambda m, x: m.se3_local(x["q"], x["t"], x["q2"],
                                           x["t2"])),
    "pose_tangent_adjoint": (lambda m, x: m.pose_tangent_adjoint(x["q"],
                                                                 x["t"])),
    "s2_basis": (lambda m, x: m.s2_basis(x["g"])),
    "s2_retract": (lambda m, x: m.s2_retract(x["g"], x["d2"])),
    "s2_local": (lambda m, x: m.s2_local(x["g"], x["g2"])),
    "mat_to_quat": (lambda m, x: m.mat_to_quat(m.quat_to_mat(x["q"]))),
    "exp_so3_mat": (lambda m, x: m.exp_so3_mat(x["phi"])),
    "inv_right_jacobian_so3": (lambda m, x: m.inv_right_jacobian_so3(
        x["phi"])),
    "se3_identity": (lambda m, x: m.se3_identity()),
}


def _np(out):
    if isinstance(out, tuple):
        return [_np(o) for o in out]
    return np.asarray(out.detach().numpy() if torch.is_tensor(out) else out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name):
    x = _inputs()
    fn = CASES[name]
    ref = _np(fn(jlie, {k: jnp.asarray(v) for k, v in x.items()}))
    out = _np(fn(tlie, {k: torch.from_numpy(v) for k, v in x.items()}))
    for o, r in zip(out if isinstance(out, list) else [out],
                    ref if isinstance(ref, list) else [ref]):
        assert o.dtype == np.float32
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL)


def _np_quat_mul(a, b):
    aw, av, bw, bv = a[:, :1], a[:, 1:], b[:, :1], b[:, 1:]
    return np.concatenate([aw * bw - np.sum(av * bv, -1, keepdims=True),
                           aw * bv + bw * av + np.cross(av, bv)], -1)


def _edge_inputs(regime, seed=5):
    """Rotations whose angle sits where the formulas switch or lose
    precision: across the Taylor cutoff (|phi| = 1e-6) or within 0.03 rad
    of pi; half the quaternions have w < 0 (the double cover)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(N, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    if regime == "taylor_cutoff":
        angle = 10.0 ** rng.uniform(-7.5, -4.5, size=(N, 1))
    else:
        angle = np.pi - 10.0 ** rng.uniform(-4.0, -1.5, size=(N, 1))
    phi = axis * angle
    dq = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * axis], -1)
    dq[::2] *= -1.0
    x = {k: v.astype(np.float64) for k, v in _inputs(seed).items()}
    x.update(phi=phi, xi=np.concatenate([phi, x["t"]], -1),
             q2=_np_quat_mul(x["q"], dq), dq=dq)
    return {k: v.astype(np.float32) for k, v in x.items()}


EDGE_CASES = {
    "exp_so3": (lambda m, x: m.exp_so3(x["phi"])),
    "log_so3": (lambda m, x: m.log_so3(x["dq"])),
    "quat_to_mat": (lambda m, x: m.quat_to_mat(x["dq"])),
    "left_jacobian_so3": (lambda m, x: m.left_jacobian_so3(x["phi"])),
    "right_jacobian_so3": (lambda m, x: m.right_jacobian_so3(x["phi"])),
    "se3_retract": (lambda m, x: m.se3_retract(x["q"], x["t"], x["xi"])),
    "se3_local": (lambda m, x: m.se3_local(x["q"], x["t"], x["q2"],
                                           x["t2"])),
    "exp_so3_mat": (lambda m, x: m.exp_so3_mat(x["phi"])),
}


@pytest.mark.parametrize("regime", ["taylor_cutoff", "near_pi"])
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_lie_matches_jax_at_edge_angles(name, regime):
    x = _edge_inputs(regime)
    fn = EDGE_CASES[name]
    ref = _np(fn(jlie, {k: jnp.asarray(v) for k, v in x.items()}))
    out = _np(fn(tlie, {k: torch.from_numpy(v) for k, v in x.items()}))
    for o, r in zip(out if isinstance(out, list) else [out],
                    ref if isinstance(ref, list) else [ref]):
        assert o.dtype == np.float32 and np.isfinite(o).all()
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL)


def _spd(seed, n=N, spread=(0.2, 1.0, 3.0)):
    """Symmetric 3x3 with well separated eigenvalues (scaled per batch)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.asarray(spread) * rng.uniform(0.5, 2.0, size=(n, 1))
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q)
    return A.astype(np.float32)


def test_eigvalsh3_matches_jax():
    A = _spd(1)
    ref = np.asarray(jeig.eigvalsh3(jnp.asarray(A)))
    out = teig.eigvalsh3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_eigh3_matches_jax():
    A = _spd(2)
    lam_j, V_j = jeig.eigh3(jnp.asarray(A))
    lam_t, V_t = teig.eigh3(torch.from_numpy(A))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=ATOL,
                               rtol=RTOL)
    # eigenvectors: f32 cross products of (A - lam I) rows amplify the
    # eigenvalue's rounding by 1/gap, so they get atol 1e-5
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), atol=1e-5)


def test_smallest_eigvec3_matches_jax_on_planes():
    # plane-fit covariances: one tiny eigenvalue (thickness ~ 1 cm)
    A = _spd(3, spread=(1e-4, 0.5, 1.5))
    lam_j, n_j = jeig.smallest_eigvec3(jnp.asarray(A))
    lam_t, n_t = teig.smallest_eigvec3(torch.from_numpy(A))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)


def test_eigh3_isotropic_and_zero():
    A = np.stack([np.eye(3), np.zeros((3, 3))]).astype(np.float32)
    lam_j, V_j = jeig.eigh3(jnp.asarray(A))
    lam_t, V_t = teig.eigh3(torch.from_numpy(A))
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    np.testing.assert_array_equal(V_t.numpy(), np.asarray(V_j))


def test_voxel_map_num_occupied_matches_jax():
    """``VoxelMap.num_occupied`` on the same cloud inserted into both
    packages' maps: the occupied rows, the write-off row left out."""
    import dataclasses

    from mimosa_tpu.mapping import voxel_hash as jvh
    from mimosa_tpu_torch.mapping import voxel_hash as tvh

    jcfg = jvh.VoxelMapConfig(leaf_size=0.5, capacity_log2=10)
    tcfg = tvh.VoxelMapConfig(**dataclasses.asdict(jcfg))
    pts = np.random.default_rng(6).uniform(-4, 4, (3000, 3)).astype(
        np.float32)
    ok = np.ones(len(pts), bool)
    jm = jax.jit(jvh.insert, static_argnames=("cfg",))(
        jvh.create(jcfg, jnp.float32), jnp.asarray(pts), jnp.asarray(ok), 0,
        jcfg)
    tm = tvh.insert(tvh.create(tcfg), torch.from_numpy(pts),
                    torch.from_numpy(ok), torch.zeros((), dtype=torch.int32),
                    tcfg)
    n = tm.num_occupied
    assert n.dtype == torch.int32 and 0 < int(n) < tcfg.capacity
    assert int(n) == int(jm.num_occupied) == int(tm.occupied[:-1].sum())


def test_stopwatch_and_stage_report():
    from mimosa_tpu_torch.utils.timing import StageTimer, Stopwatch

    sw = Stopwatch()
    lap1 = sw.lap()
    lap2 = sw.lap()
    assert 0.0 <= lap1 and 0.0 <= lap2 <= sw.elapsed()
    sw.reset()
    assert sw.elapsed() < 1.0
    t = StageTimer()
    for _ in range(3):
        with t.stage("deskew"):
            pass
    lines = t.report().splitlines()
    assert lines[0].split() == ["stage", "count", "mean", "ms", "total", "s"]
    assert lines[1].split()[:2] == ["deskew", "3"]
