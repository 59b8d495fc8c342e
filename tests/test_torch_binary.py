"""The port's binary (two-key, scan-to-scan) geometric factor,
``lidar/geometric.py::linearize_binary``, on the CPU.

``tests/test_binary_factors.py``'s geometric cases on the port, in f64:
(a) at an identity target it is the unary factor (H and b of the source
block equal ``linearize_with``'s to rtol 1e-9, the counts equal, 4-DoF
off); (b) its H and b equal J^T W J and J^T W r with J from
``torch.func.jacfwd`` of the residual at fixed correspondences and weights
(rtol 1e-6, atol 1e-8); (c) a common rigid motion of both states is in the
Hessian's null space (|H v| < 1e-6 |H|). And (d) against the JAX
package's ``linearize_binary`` on the same map, scan and poses, in f64:
H, b and the mean |r| to 1e-9 of scale, the status counts exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mimosa_tpu.core import lie as jlie
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.mapping import voxel_hash as vh

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

MAP_CFG = vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=16,
                            plane_min_points=5, neighbor_voxel_mode=7)
CFG = geo.GeometricConfig(loc_count_thresh=30.0)
F64_TOL = 1e-9         # of scale: the two packages' f64 rounding


def make_room(seed=0, n_per=5000, noise=0.003):
    rng = np.random.default_rng(seed)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(n_per, 3))
        p[:, axis] = val + rng.normal(size=n_per) * noise
        clouds.append(p)
    return np.concatenate(clouds)


def _poses(dtype=torch.float64):
    def t(x):
        return torch.tensor(x, dtype=dtype)

    return (lie.exp_so3(t([0.05, -0.1, 0.3])), t([1.5, 1.2, 1.0]),
            lie.exp_so3(t([-0.2, 0.06, -0.5])), t([0.6, 2.0, 1.4]))


def _in_frame(world, q=None, t=None):
    """World points expressed in the frame of pose (q, t) (numpy f64)."""
    pts = torch.from_numpy(world)
    if q is not None:
        pts = lie.se3_transform(*lie.se3_inverse(q, t), pts)
    return pts


def build_map(world, q=None, t=None, dtype=torch.float64):
    pts = _in_frame(world, q, t).to(dtype)
    m = vh.create(MAP_CFG, dtype=dtype)
    m = vh.insert(m, pts, torch.ones(len(pts), dtype=torch.bool),
                  torch.zeros((), dtype=torch.int32), MAP_CFG)
    return vh.update_planes(m, MAP_CFG)


def sample_scan(world, q, t, n=3000, seed=1):
    idx = np.random.default_rng(seed).choice(len(world), n, replace=False)
    return _in_frame(world[idx], q, t)


def test_binary_icp_identity_target_matches_unary():
    world = make_room()
    m = build_map(world)
    q_s, t_s, _, _ = _poses()
    pts = sample_scan(world, q_s, t_s)
    valid = torch.ones(len(pts), dtype=torch.bool)
    q_i, t_i = lie.se3_identity(torch.float64)
    una = geo.linearize(m, pts, valid, q_s, t_s, MAP_CFG, CFG)
    bi = geo.linearize_binary(m, pts, valid, q_s, t_s, q_i, t_i, MAP_CFG,
                              CFG)
    np.testing.assert_allclose(bi.H[:6, :6], una.H, rtol=1e-9)
    np.testing.assert_allclose(bi.b[:6], una.b, rtol=1e-9)
    np.testing.assert_array_equal(bi.status_counts, una.status_counts)
    assert int(bi.num_inlier) == int(una.num_inlier) > 2000
    assert bi.H.shape == (12, 12) and bi.b.shape == (12,)


def test_binary_icp_jacobian_matches_autodiff():
    """H and b are J^T W J and J^T W r with J from jacfwd of the residual
    at fixed correspondences and fixed weights."""
    world = make_room()
    q_s, t_s, q_t, t_t = _poses()
    m = build_map(world, q_t, t_t)
    pts = sample_scan(world, q_s, t_s)
    valid = torch.ones(len(pts), dtype=torch.bool)
    bi = geo.linearize_binary(m, pts, valid, q_s, t_s, q_t, t_t, MAP_CFG,
                              CFG)
    assert int(bi.num_inlier) > 2000

    # the factor's matches and weights, recomputed
    q_d, t_d = lie.se3_compose(*lie.se3_inverse(q_t, t_t), q_s, t_s)
    y0 = lie.se3_transform(q_d, t_d, pts)
    normal, mean, found = vh.query_planes(m, y0, MAP_CFG)
    r0 = torch.sum(normal * (y0 - mean), dim=-1)
    inlier = geo.inlier_gates(r0, pts, valid, found, CFG)[0]
    ar = r0.abs()
    w_h = torch.where(ar <= CFG.huber_delta, 1.0,
                      CFG.huber_delta / torch.clamp(ar, min=1e-12))
    w = torch.where(inlier, w_h, 0.0) / CFG.sigma ** 2

    def r_vec(xi):
        qs2, ts2 = lie.se3_retract(q_s, t_s, xi[:6])
        qt2, tt2 = lie.se3_retract(q_t, t_t, xi[6:])
        qd2, td2 = lie.se3_compose(*lie.se3_inverse(qt2, tt2), qs2, ts2)
        return torch.sum(normal * (lie.se3_transform(qd2, td2, pts) - mean),
                         dim=-1)

    J = torch.func.jacfwd(r_vec)(torch.zeros(12, dtype=torch.float64))
    H_ref = (J * w[:, None]).T @ J
    b_ref = J.T @ (w * r0)
    np.testing.assert_allclose(bi.H, H_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(bi.b, b_ref, rtol=1e-6, atol=1e-8)


def _gauge_vectors(q_s, t_s, q_t, t_t):
    """Right-tangent 12-vectors of a common world translation / rotation
    applied to both states (null directions of any relative factor)."""
    Rs, Rt = lie.quat_to_mat(q_s), lie.quat_to_mat(q_t)
    z = torch.zeros(3, dtype=torch.float64)
    vs = []
    for d in torch.eye(3, dtype=torch.float64):
        vs.append(torch.cat([z, Rs.T @ d, z, Rt.T @ d]))
    for w in torch.eye(3, dtype=torch.float64):
        vs.append(torch.cat([Rs.T @ w, Rs.T @ lie.cross(w, t_s),
                             Rt.T @ w, Rt.T @ lie.cross(w, t_t)]))
    return vs


def test_binary_icp_gauge_null_space():
    world = make_room()
    q_s, t_s, q_t, t_t = _poses()
    m = build_map(world, q_t, t_t)
    pts = sample_scan(world, q_s, t_s)
    bi = geo.linearize_binary(m, pts, torch.ones(len(pts), dtype=torch.bool),
                              q_s, t_s, q_t, t_t, MAP_CFG, CFG)
    scale = torch.linalg.norm(bi.H)
    for v in _gauge_vectors(q_s, t_s, q_t, t_t):
        assert torch.linalg.norm(bi.H @ v) < 1e-6 * scale


def test_binary_icp_matches_jax():
    """The same map (the room in the target frame), scan, validity and
    poses through both packages, in f64: each package fits its own map's
    planes, and in f32 the two summation orders move the fits by ~1e-7,
    which moves b by ~0.1 over 3000 points."""
    world = make_room(seed=2, n_per=3000)
    q_s, t_s, q_t, t_t = _poses()
    map_pts = _in_frame(world, q_t, t_t).numpy()
    pts = sample_scan(world, q_s, t_s).numpy()
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    m = build_map(world, q_t, t_t)
    jcfg = jvh.VoxelMapConfig(**dataclasses.asdict(MAP_CFG))
    jm = jax.jit(jvh.insert, static_argnames=("cfg",))(
        jvh.create(jcfg, jnp.float64), jnp.asarray(map_pts),
        jnp.ones(len(map_pts), bool), 0, jcfg)
    jm = jax.jit(jvh.update_planes, static_argnames=("cfg",))(jm, jcfg)
    assert int(jm.num_occupied) == int(m.num_occupied)
    jgcfg = jgeo.GeometricConfig(**dataclasses.asdict(CFG))
    poses = [x.numpy() for x in (q_s, t_s, q_t, t_t)]
    np.testing.assert_allclose(
        poses[0], np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.1, 0.3]))),
        rtol=0, atol=1e-15)
    ref = jax.jit(jgeo.linearize_binary, static_argnames=(
        "map_cfg", "cfg"))(jm, jnp.asarray(pts), jnp.asarray(valid),
                           *map(jnp.asarray, poses), map_cfg=jcfg, cfg=jgcfg)
    out = geo.linearize_binary(m, torch.from_numpy(pts),
                               torch.from_numpy(valid), q_s, t_s, q_t, t_t,
                               MAP_CFG, CFG)
    assert out.H.dtype == torch.float64 and ref.H.dtype == jnp.float64
    np.testing.assert_array_equal(out.status_counts.numpy(),
                                  np.asarray(ref.status_counts))
    assert int(out.num_inlier) == int(ref.num_inlier) > 1500
    for name in ("H", "b"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name).numpy(), r,
                                   rtol=F64_TOL, atol=F64_TOL * abs(r).max())
    np.testing.assert_allclose(float(out.mean_abs_res),
                               float(ref.mean_abs_res), rtol=F64_TOL)
