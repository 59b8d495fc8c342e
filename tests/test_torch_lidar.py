"""Parity of the port's lidar and mapping modules and the ICP kernel wrapper
with the JAX package, on the same seeded numpy f32 inputs.

Tolerances: hashes, slots, claims and selected lanes are integer results
and must be equal; map moments are f32 sums (rtol 1e-5); ICP H and b use
the JAX Pallas test's gate (rtol 2e-4, atol 2e-2) and counts are exact.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.core import lie as jlie
from mimosa_tpu.lidar import deskew as jdk
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.lidar.downsample import voxel_downsample as j_downsample
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch.lidar import deskew as tdk
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.lidar.downsample import voxel_downsample as t_downsample
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.ops import icp_cuda

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

J_MAP_CFG = jvh.VoxelMapConfig(leaf_size=0.4, capacity_log2=14,
                               plane_min_points=5, lru_horizon=3)
T_MAP_CFG = tvh.VoxelMapConfig(**dataclasses.asdict(J_MAP_CFG))

j_insert = jax.jit(jvh.insert, static_argnames=("cfg", "return_slots"))
j_update_planes = jax.jit(jvh.update_planes, static_argnames=("cfg",))
j_update_planes_at = jax.jit(jvh.update_planes_at, static_argnames=("cfg",))
j_match = jax.jit(jgeo.match, static_argnames=("map_cfg",))
j_linearize_with = jax.jit(jgeo.linearize_with, static_argnames=("cfg",))


def _t(x):
    return torch.from_numpy(np.array(x))


def _room(seed=0, n_per=1500, noise=0.003):
    """Axis-aligned room (floor, ceiling, 3 walls), f32 — unsaturated at
    leaf 0.4 (under 64 points a voxel)."""
    rng = np.random.default_rng(seed)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(n_per, 3))
        p[:, axis] = val + rng.normal(size=n_per) * noise
        clouds.append(p)
    return np.concatenate(clouds).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    """The same room inserted into both packages' maps (scan 0), planes
    refit; returns (jax map, torch map, points)."""
    pts = _room()
    valid = np.ones(len(pts), bool)
    valid[::17] = False
    jm = j_insert(jvh.create(J_MAP_CFG, jnp.float32), jnp.asarray(pts),
                  jnp.asarray(valid), 0, J_MAP_CFG)
    jm = j_update_planes(jm, J_MAP_CFG)
    tm = tvh.insert(tvh.create(T_MAP_CFG), _t(pts), _t(valid),
                    torch.zeros((), dtype=torch.int32), T_MAP_CFG)
    tm = tvh.update_planes(tm, T_MAP_CFG)
    return jm, tm, pts


# --------------------------------------------------------------- hashing


def test_hash_coords_and_slots_bit_equal():
    rng = np.random.default_rng(0)
    vc = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(4096, 3), dtype=np.int64)
    vc[:2048] = rng.integers(-300, 300, size=(2048, 3))
    vc = vc.astype(np.int32)
    hj = np.asarray(jvh.hash_coords(jnp.asarray(vc)))
    ht = tvh.hash_coords(_t(vc)).numpy()
    assert hj.dtype == np.int32
    np.testing.assert_array_equal(ht, hj.astype(np.int64))
    mask = (1 << 18) - 1
    for probe in range(8):
        sj = np.asarray(jvh._slot_of(jnp.asarray(hj), probe, mask))
        st = tvh._slot_of(_t(ht), probe, mask).numpy()
        np.testing.assert_array_equal(st, sj)


def test_voxel_downsample_same_lanes():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, size=(6000, 3)).astype(np.float32)
    valid = rng.uniform(size=6000) > 0.1
    oj, vj, sj = j_downsample(jnp.asarray(pts), jnp.asarray(valid), 0.4, 4096)
    ot, vt, st = t_downsample(_t(pts), _t(valid), 0.4, 4096)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


# ------------------------------------------------------------------- map


def test_insert_matches_jax(maps):
    jm, tm, _ = maps
    for name in ("coords", "occupied", "last_touch"):
        # the last row is the write-off slot (racing writes by design)
        np.testing.assert_array_equal(getattr(tm, name).numpy()[:-1],
                                      np.asarray(getattr(jm, name))[:-1])
    np.testing.assert_array_equal(tm.n.numpy(), np.asarray(jm.n))
    assert 0 < tm.n.max() < T_MAP_CFG.max_points_per_voxel
    for name in ("psum", "pssum"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-5, atol=1e-5)


def test_update_planes_matches_jax(maps):
    jm, tm, _ = maps
    np.testing.assert_array_equal(tm.plane_valid.numpy(),
                                  np.asarray(jm.plane_valid))
    ok = tm.plane_valid.numpy()
    assert ok.sum() > 50
    np.testing.assert_allclose(tm.mean.numpy()[ok], np.asarray(jm.mean)[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.normal.numpy()[ok],
                               np.asarray(jm.normal)[ok], atol=1e-4)


@pytest.mark.parametrize("cols", [None, 3])
def test_map_moment_sums_run_in_lane_order(cols):
    """The map's moment sums add duplicate targets in lane order on the CPU
    (x[i0] + v0 + v1 + ...), also past the lane counts where the CPU's
    accumulating index_put, on more than one thread, leaves that order."""
    rng = np.random.default_rng(3)
    n, cap = 40000, 1000
    shape = (n,) if cols is None else (n, cols)
    x = rng.normal(size=(cap,) + shape[1:]).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, cap, size=n)
    want = x.copy()
    for i in range(n):
        want[idx[i]] += v[i]
    got = tvh._scatter_add(torch.from_numpy(x), torch.from_numpy(idx),
                           torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


def test_insert_saturated_cap_is_exact():
    """Many lanes hit one voxel in one insert: the in-batch rank cap keeps
    exactly max_points_per_voxel points, in lane order, in both."""
    rng = np.random.default_rng(2)
    pts = (rng.uniform(0.01, 0.39, size=(500, 3))
           + np.asarray([1.2, 0.4, 2.0])).astype(np.float32)
    valid = np.ones(500, bool)
    jm, js = j_insert(jvh.create(J_MAP_CFG, jnp.float32), jnp.asarray(pts),
                      jnp.asarray(valid), 0, J_MAP_CFG, return_slots=True)
    tm, ts = tvh.insert(tvh.create(T_MAP_CFG), _t(pts), _t(valid),
                        torch.zeros((), dtype=torch.int32), T_MAP_CFG,
                        return_slots=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.n.numpy(), np.asarray(jm.n))
    assert tm.n.max() == T_MAP_CFG.max_points_per_voxel
    np.testing.assert_allclose(tm.psum.numpy(), np.asarray(jm.psum),
                               rtol=1e-5)
    jm = j_update_planes_at(jm, js, J_MAP_CFG)
    tm = tvh.update_planes_at(tm, ts, T_MAP_CFG)
    np.testing.assert_array_equal(tm.plane_valid.numpy(),
                                  np.asarray(jm.plane_valid))


def test_evict_stale_matches_jax(maps):
    jm, tm, pts = maps
    # a second insert at scan 5 touches part of the room; horizon 3 evicts
    # the rest at scan 6
    sub = pts[: len(pts) // 3]
    valid = np.ones(len(sub), bool)
    jm2 = j_insert(jm, jnp.asarray(sub), jnp.asarray(valid), 5, J_MAP_CFG)
    tm2 = tvh.insert(tm, _t(sub), _t(valid),
                     torch.full((), 5, dtype=torch.int32), T_MAP_CFG)
    jm2 = jvh.evict_stale(jm2, 6, J_MAP_CFG)
    tm2 = tvh.evict_stale(tm2, torch.full((), 6, dtype=torch.int32),
                          T_MAP_CFG)
    assert 0 < tm2.occupied.sum() < tm.occupied.sum()
    for name in ("occupied", "coords", "plane_valid"):
        np.testing.assert_array_equal(getattr(tm2, name).numpy()[:-1],
                                      np.asarray(getattr(jm2, name))[:-1])


def _pose(seed=3):
    rng = np.random.default_rng(seed)
    q = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=3) * 0.3)))
    t = np.asarray([2.0, 1.5, 1.2]) + rng.normal(size=3) * 0.1
    return q.astype(np.float32), t.astype(np.float32)


def _scan(pts, q, t, n, seed=4):
    """n room points in the body frame of (q, t)."""
    rng = np.random.default_rng(seed)
    pw = pts[rng.choice(len(pts), n, replace=False)]
    qi, ti = jlie.se3_inverse(jnp.asarray(q), jnp.asarray(t))
    return np.asarray(jlie.se3_transform(qi, ti, jnp.asarray(pw)),
                      np.float32)


def test_query_planes_matches_jax(maps):
    jm, tm, pts = maps
    q, t = _pose()
    pb = _scan(pts, q, t, 2048)
    nj, mj, fj = j_match(jm, jnp.asarray(pb), jnp.asarray(q),
                         jnp.asarray(t), J_MAP_CFG)
    nt, mt, ft = tgeo.match(tm, _t(pb), _t(q), _t(t), T_MAP_CFG)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft.numpy().mean() > 0.8
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-4)


# --------------------------------------------------------------- deskew


def test_deskew_matches_jax():
    rng = np.random.default_rng(5)
    m = 40
    accs = (np.asarray([0.2, -0.1, 9.81]) + rng.normal(size=(m, 3)) * 0.3)
    gyros = rng.normal(size=(m, 3)) * 0.5
    dts = np.full(m, 0.0025)
    dts[-6:] = 0.0                       # padded tail
    imu_ts = np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    t_end = 0.085
    n = 3000
    x = dict(points=rng.uniform(-10, 10, size=(n, 3)),
             t_pts=rng.uniform(0.0, t_end, size=n),
             q0=np.asarray([0.99, 0.05, -0.08, 0.1]), p0=rng.normal(size=3),
             v0=rng.normal(size=3), accs=accs, gyros=gyros, imu_ts=imu_ts,
             bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05,
             gravity=np.asarray([0.0, 0.0, -9.81]),
             q_b_l=np.asarray([0.999, 0.0, 0.0, 0.04]),
             t_b_l=np.asarray([0.1, 0.0, 0.2]), t_end=np.asarray(t_end))
    x["q0"] /= np.linalg.norm(x["q0"])
    x["q_b_l"] /= np.linalg.norm(x["q_b_l"])
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    valid = rng.uniform(size=n) > 0.05
    ref = jax.jit(jdk.deskew)(valid=jnp.asarray(valid),
                              **{k: jnp.asarray(v) for k, v in x.items()})
    out = tdk.deskew(valid=_t(valid), **{k: _t(v) for k, v in x.items()})
    # f32 integration of the same formulas: 1e-5 of the 10 m point scale
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------------ ICP


@pytest.fixture(scope="module")
def icp_case(maps):
    """Matches made by JAX at a perturbed pose, as numpy, fed to both."""
    jm, _, pts = maps
    q, t = _pose()
    pb = _scan(pts, q, t, 2048)
    q2, t2 = jlie.se3_retract(jnp.asarray(q), jnp.asarray(t), jnp.asarray(
        [0.01, -0.02, 0.01, 0.05, -0.03, 0.02], jnp.float32))
    q2, t2 = np.asarray(q2), np.asarray(t2)
    nj, mj, fj = j_match(jm, jnp.asarray(pb), jnp.asarray(q2),
                         jnp.asarray(t2), J_MAP_CFG)
    valid = np.ones(len(pb), bool)
    valid[-100:] = False
    g_dir = np.asarray([0.05, -0.02, -1.0], np.float32)
    g_dir /= np.linalg.norm(g_dir)
    return dict(matches=(np.asarray(nj), np.asarray(mj), np.asarray(fj)),
                pts=pb, valid=valid, q=q2, t=t2, g_dir=g_dir)


GEO_CFGS = {
    "default": dict(loc_count_thresh=30.0, loc_count_thresh_rot=30.0),
    "rot_thresh_differs": dict(loc_count_thresh=30.0,
                               loc_count_thresh_rot=900.0),
    "4dof": dict(loc_count_thresh=30.0, use_4dof=True),
    "4dof_rot_thresh_differs": dict(loc_count_thresh=600.0,
                                    loc_count_thresh_rot=0.0, use_4dof=True),
}


def _cfgs(name):
    return (jgeo.GeometricConfig(**GEO_CFGS[name]),
            tgeo.GeometricConfig(**GEO_CFGS[name]))


def _torch_args(c):
    return (tuple(_t(a) for a in c["matches"]), _t(c["pts"]), _t(c["valid"]),
            _t(c["q"]), _t(c["t"]))


def _assert_icp_close(out, ref, fields=tgeo.ICPResult._fields):
    for name in fields:
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        if name in ("H", "b"):
            np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-2)
        elif name in ("mean_abs_res", "eigvals_rot", "eigvals_trans"):
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-6)
        elif name in ("eigvecs_rot", "eigvecs_trans"):
            np.testing.assert_allclose(o, r, atol=1e-3)
        else:                          # counts and flags: exact
            np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_linearize_with_matches_jax(icp_case, cfg_name):
    c = icp_case
    jcfg, tcfg = _cfgs(cfg_name)
    ref = j_linearize_with(tuple(jnp.asarray(a) for a in c["matches"]),
                           jnp.asarray(c["pts"]), jnp.asarray(c["valid"]),
                           jnp.asarray(c["q"]), jnp.asarray(c["t"]), jcfg,
                           g_dir=jnp.asarray(c["g_dir"]))
    out = tgeo.linearize_with(*_torch_args(c), tcfg, g_dir=_t(c["g_dir"]))
    assert 1000 < int(out.num_inlier) < 2048
    _assert_icp_close(out, ref)
    # the eigen-subspace selectors built from it (eigenvector tolerance)
    for fn in ("degeneracy_projector", "degenerate_selector"):
        np.testing.assert_allclose(getattr(tgeo, fn)(out).numpy(),
                                   np.asarray(getattr(jgeo, fn)(ref)),
                                   atol=2e-3)


@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_icp_wrapper_on_cpu_is_the_plain_version(icp_case, cfg_name):
    c = icp_case
    _, tcfg = _cfgs(cfg_name)
    before = icp_cuda.LAUNCHES
    out = icp_cuda.linearize(*_torch_args(c), tcfg, g_dir=_t(c["g_dir"]))
    ref = tgeo.linearize_with(*_torch_args(c), tcfg, g_dir=_t(c["g_dir"]))
    assert icp_cuda.LAUNCHES == before      # no kernel launch on the CPU
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_icp_wrapper_matches_pallas_kernel(icp_case):
    """Against the Pallas kernel in interpret mode, on the fields its
    wrapper computes as linearize_with does (not degenerate_rot, which it
    judges with loc_count_thresh, and no 4-DoF)."""
    from jax.experimental.pallas import tpu as pltpu

    from mimosa_tpu.ops import icp_pallas as ip

    c = icp_case
    jcfg, tcfg = _cfgs("rot_thresh_differs")
    with pltpu.force_tpu_interpret_mode():
        ref = ip.linearize_pallas(
            tuple(jnp.asarray(a) for a in c["matches"]),
            jnp.asarray(c["pts"]), jnp.asarray(c["valid"]),
            jnp.asarray(c["q"]), jnp.asarray(c["t"]), jcfg)
    out = icp_cuda.linearize(*_torch_args(c), tcfg)
    _assert_icp_close(out, ref, fields=[
        f for f in tgeo.ICPResult._fields if f != "degenerate_rot"])
    # the Pallas wrapper's rotation flags use the translation threshold
    assert not np.array_equal(out.degenerate_rot.numpy(),
                              np.asarray(ref.degenerate_rot))


def _kernel_layout_constants():
    """The output layout constants of ``csrc/icp_linearize.cu`` (its
    ``enum``), read from the source: name -> value."""
    src = icp_cuda.SOURCE.read_text()
    enum = re.search(r"enum : int \{(.*?)\};", src, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", enum)}


# ICPResult field -> the kernel's offset constant
_KERNEL_OFFSET = {
    "H": "kH", "b": "kB", "num_inlier": "kStatus",
    "status_counts": "kStatus", "mean_abs_res": "kMeanAbs",
    "loc_counts_rot": "kCntR", "loc_counts_trans": "kCntT",
    "eigvals_rot": "kLamR", "eigvals_trans": "kLamT",
    "eigvecs_rot": "kVR", "eigvecs_trans": "kVT",
    "degenerate_rot": "kDegR", "degenerate_trans": "kDegT",
}


def _pack_like_the_kernel(res):
    """The three output buffers the kernel writes, filled from a plain
    result at the offsets the kernel source states, each buffer's unused
    entries left at a sentinel."""
    c = _kernel_layout_constants()
    f32 = torch.full((c["kOutF"],), float("nan"))
    i32 = torch.full((c["kOutI"],), -7, dtype=torch.int32)
    u8 = torch.full((c["kOutU"],), 7, dtype=torch.uint8)
    for name, const in _KERNEL_OFFSET.items():
        v = getattr(res, name).reshape(-1)
        buf = {torch.float32: f32, torch.int32: i32, torch.bool: u8}[v.dtype]
        buf[c[const]:c[const] + v.numel()] = v.to(buf.dtype)
    return f32, i32, u8


def test_icp_wrapper_layout_is_the_kernel_source_layout():
    """The wrapper's layout table, and the list it checks icp_layout()
    against when the library loads, agree with the kernel source."""
    c = _kernel_layout_constants()
    assert icp_cuda.SIZES == {icp_cuda.F32: c["kOutF"],
                              icp_cuda.I32: c["kOutI"],
                              icp_cuda.U8: c["kOutU"]}
    for name, (_, off, _) in icp_cuda.LAYOUT.items():
        assert off == c[_KERNEL_OFFSET[name]], name
    assert icp_cuda.BLOCKS[1] == c["kBlocks"]
    layout = re.search(r"kLayout\[\] = \{(.*?)\};",
                       icp_cuda.SOURCE.read_text(), re.S).group(1)
    layout = re.sub(r"/\*.*?\*/", "", layout)
    assert [c[k.strip()] for k in layout.split(",")] == \
        icp_cuda._expected_layout()
    # fields tile each buffer without overlap (num_inlier is
    # status_counts[0]); the blocks [2,3,3] close the f32 buffer
    for buf in (icp_cuda.F32, icp_cuda.I32, icp_cuda.U8):
        spans = sorted((off, off + int(np.prod(shape)))
                       for name, (b, off, shape) in icp_cuda.LAYOUT.items()
                       if b == buf and name != "num_inlier")
        if buf == icp_cuda.F32:
            spans.append((icp_cuda.BLOCKS[1], icp_cuda.BLOCKS[1] + 18))
        assert spans[0][0] == 0 and spans[-1][1] == icp_cuda.SIZES[buf]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), spans


@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_icp_wrapper_unpacks_the_kernel_layout(icp_case, cfg_name):
    """The plain result packed as the kernel writes it and read back by the
    wrapper's unpack equals the plain result field by field (dtype, shape,
    value)."""
    c = icp_case
    _, tcfg = _cfgs(cfg_name)
    ref = tgeo.linearize_with(*_torch_args(c), tcfg, g_dir=_t(c["g_dir"]))
    f32, i32, u8 = _pack_like_the_kernel(ref)
    out = icp_cuda.unpack(f32, i32, u8)
    assert isinstance(out, tgeo.ICPResult)
    for name in tgeo.ICPResult._fields:
        o, r = getattr(out, name), getattr(ref, name)
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o, r), name
        # views of the buffers, not copies
        assert o.untyped_storage().data_ptr() in (
            f32.untyped_storage().data_ptr(),
            i32.untyped_storage().data_ptr(),
            u8.untyped_storage().data_ptr()), name
    assert icp_cuda.blocks(f32).shape == (2, 3, 3)


def test_icp_wrapper_rejects_bad_cuda_input():
    """Inputs the kernel does not take raise before anything launches."""
    meta = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        icp_cuda.linearize((meta, meta, meta), meta, meta, meta, meta,
                           tgeo.GeometricConfig())
