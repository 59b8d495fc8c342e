"""The port's CUDA ICP kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc (``cuda`` marker) and skips
without one. The file imports nothing of JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit; ``tests/conftest.py`` imports jax,
so run it there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: counts and flags exact; H and b to the JAX Pallas test's gate
(rtol 2e-4, atol 2e-2), since the kernel sums in another order. The
kernel's eigen-analysis (f64 arithmetic on its own f32 blocks) against
torch ``eigh3`` in f64 on the same blocks: eigenvalues within
1e-4 max|lambda|, each eigenvector column up to sign with
``|v . v_ref| >= 1 - 1e-4``. Where an eigenvalue repeats (a rank-deficient
block) its eigenvectors are any orthonormal basis of the eigenspace, so
there the eigenspace is compared: projectors within 1e-4.
"""

import numpy as np
import pytest
import torch

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.core.eigh3 import eigh3
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.mapping import voxel_hash as vh
from mimosa_tpu_torch.ops import icp_cuda

pytestmark = pytest.mark.cuda

MAP_CFG = vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=16,
                            plane_min_points=5)
GEO_CFGS = {
    "default": dict(loc_count_thresh=30.0, loc_count_thresh_rot=30.0),
    "rot_thresh_differs": dict(loc_count_thresh=30.0,
                               loc_count_thresh_rot=900.0),
    "4dof_rot_thresh_differs": dict(loc_count_thresh=600.0,
                                    loc_count_thresh_rot=0.0, use_4dof=True),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    """A room (floor, ceiling, three walls) in a port map, and a pose. The
    map is built on the CPU, where its float sums have one order, so every
    run compares the kernel with its plain version on the same bits."""
    rng = np.random.default_rng(0)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(8000, 3))
        p[:, axis] = val + rng.normal(size=8000) * 0.003
        clouds.append(p)
    world = torch.tensor(np.concatenate(clouds), dtype=torch.float32)
    vmap = vh.insert(vh.create(MAP_CFG, "cpu"), world,
                     torch.ones(len(world), dtype=torch.bool),
                     torch.zeros((), dtype=torch.int32), MAP_CFG)
    vmap = vh.update_planes(vmap, MAP_CFG)
    vmap = type(vmap)(*(x.to(dev) for x in vmap))
    world = world.to(dev)
    q_true = lie.exp_so3(torch.tensor([0.05, -0.1, 0.4], device=dev))
    t_true = torch.tensor([2.0, 1.5, 1.2], device=dev)
    q, t = lie.se3_retract(q_true, t_true, torch.tensor(
        [0.01, -0.02, 0.01, 0.05, -0.03, 0.02], device=dev))
    g_dir = torch.tensor([0.05, -0.02, -1.0], device=dev)
    return dict(world=world, vmap=vmap, q_true=q_true, t_true=t_true, q=q,
                t=t, g_dir=g_dir / torch.linalg.vector_norm(g_dir))


def _args(scene, n, seed=1):
    """n scene points (drawn with replacement past the cloud's size) in the
    body frame of the true pose, matched at the perturbed pose."""
    dev = scene["world"].device
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(len(scene["world"]), (n,), generator=gen).to(dev)
    qi, ti = lie.se3_inverse(scene["q_true"], scene["t_true"])
    pts = lie.se3_transform(qi, ti, scene["world"][idx]).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-50:] = False
    matches = geo.match(scene["vmap"], pts, scene["q"], scene["t"], MAP_CFG)
    return matches, pts, valid, scene["q"], scene["t"]


def _assert_close(out, ref):
    """Counts and flags exact; H, b, eigenvalues and mean |r| within the
    gate. Eigenvectors are not compared: the closed-form eigh3 may pick
    another sign from inputs that differ in the last bits, and the exact
    localizability counts already hold them."""
    for name in geo.ICPResult._fields:
        o, r = getattr(out, name), getattr(ref, name)
        if name in ("eigvecs_rot", "eigvecs_trans"):
            continue
        if o.dtype.is_floating_point:
            torch.testing.assert_close(o, r, rtol=2e-4, atol=2e-2)
        else:
            assert torch.equal(o, r), (name, o, r)


# 8192: the entry() width; 4133: ragged; 300000: past the grid cap, so each
# thread's grid-stride loop takes several points
@pytest.mark.parametrize("n", [8192, 4133, 300000])
@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_kernel_matches_plain(scene, n, cfg_name):
    cfg = geo.GeometricConfig(**GEO_CFGS[cfg_name])
    args = _args(scene, n)
    before = icp_cuda.LAUNCHES
    out = icp_cuda.linearize(*args, cfg, g_dir=scene["g_dir"])
    again = icp_cuda.linearize(*args, cfg, g_dir=scene["g_dir"])
    ref = geo.linearize_with(*args, cfg, g_dir=scene["g_dir"])
    torch.cuda.synchronize()
    assert icp_cuda.LAUNCHES == before + 2
    assert int(out.num_inlier) > n // 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    _assert_close(out, ref)


def test_kernel_takes_uint8_masks(scene):
    cfg = geo.GeometricConfig()
    (normal, mean, found), pts, valid, q, t = _args(scene, 4096)
    out = icp_cuda.linearize((normal, mean, found.to(torch.uint8)), pts,
                             valid.to(torch.uint8), q, t, cfg)
    ref = icp_cuda.linearize((normal, mean, found), pts, valid, q, t, cfg)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_kernel_rejects_what_it_does_not_take(scene):
    cfg = geo.GeometricConfig()
    (normal, mean, found), pts, valid, q, t = _args(scene, 1024)
    before = icp_cuda.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        icp_cuda.linearize((normal, mean, found), pts.T.contiguous().T,
                           valid, q, t, cfg)
    with pytest.raises(TypeError, match="dtype"):
        icp_cuda.linearize((normal.double(), mean, found), pts, valid, q, t,
                           cfg)
    with pytest.raises(ValueError, match="is on cpu"):
        icp_cuda.linearize((normal, mean, found), pts, valid.cpu(), q, t,
                           cfg)
    with pytest.raises(ValueError, match="shape"):
        icp_cuda.linearize((normal[:-1], mean, found), pts, valid, q, t, cfg)
    assert icp_cuda.LAUNCHES == before


def _assert_eigen_close(lam, V, A):
    """The kernel's (lam [3], V [3,3]) of its block A against torch eigh3
    on A in f64 (the tolerances are in the module docstring)."""
    lam_ref, V_ref = eigh3(A.double())
    lam, V = lam.double(), V.double()
    scale = max(lam_ref.abs().max().item(), 1e-30)
    assert (lam - lam_ref).abs().max().item() <= 1e-4 * scale, (lam, lam_ref)
    torch.testing.assert_close(V.T @ V, torch.eye(3, dtype=V.dtype,
                                                  device=V.device),
                               rtol=0, atol=1e-5)
    # eigenvalues within 1e-6 max|lambda| of a neighbour share an eigenspace
    groups, cur = [], [0]
    for k in (1, 2):
        if (lam_ref[k] - lam_ref[k - 1]).item() <= 1e-6 * scale:
            cur.append(k)
        else:
            groups.append(cur)
            cur = [k]
    groups.append(cur)
    for g in groups:
        if len(g) == 1:
            k = g[0]
            dot = torch.dot(V[:, k], V_ref[:, k]).abs().item()
            assert dot >= 1 - 1e-4, (k, V, V_ref)
        elif len(g) < 3:
            P, P_ref = V[:, g] @ V[:, g].T, V_ref[:, g] @ V_ref[:, g].T
            assert (P - P_ref).abs().max().item() <= 1e-4, (g, V, V_ref)


def _launch(args, cfg, g_dir=None):
    """One launch: (ICPResult, its three buffers)."""
    bufs = icp_cuda.launch(*args, cfg, g_dir=g_dir)
    return icp_cuda.unpack(*bufs), bufs


@pytest.mark.parametrize("n", [8192, 4133, 300000])
def test_kernel_eigen_matches_torch_eigh3(scene, n):
    cfg = geo.GeometricConfig(**GEO_CFGS["default"])
    out, (f32, _, _) = _launch(_args(scene, n), cfg)
    blocks = icp_cuda.blocks(f32)
    torch.cuda.synchronize()
    _assert_eigen_close(out.eigvals_rot, out.eigvecs_rot, blocks[0])
    _assert_eigen_close(out.eigvals_trans, out.eigvecs_trans, blocks[1])


def _plane_args(scene, n):
    """n points of the floor z = 0, each matched to the floor's own plane
    (normal exactly +z): the translation block is rank 1 and the rotation
    block rank 2."""
    dev = scene["world"].device
    rng = np.random.default_rng(3)
    world = np.zeros((n, 3), np.float32)
    world[:, :2] = rng.uniform(0.2, 3.8, size=(n, 2))
    world = torch.tensor(world, device=dev)
    qi, ti = lie.se3_inverse(scene["q_true"], scene["t_true"])
    pts = lie.se3_transform(qi, ti, world).contiguous()
    normal = torch.zeros_like(world)
    normal[:, 2] = 1.0
    found = torch.ones(n, dtype=torch.bool, device=dev)
    return ((normal, world, found), pts, found.clone(), scene["q_true"],
            scene["t_true"])


@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_kernel_on_a_single_plane(scene, cfg_name):
    cfg = geo.GeometricConfig(**GEO_CFGS[cfg_name])
    args = _plane_args(scene, 8192)
    out, (f32, _, _) = _launch(args, cfg, g_dir=scene["g_dir"])
    ref = geo.linearize_with(*args, cfg, g_dir=scene["g_dir"])
    blocks = icp_cuda.blocks(f32)
    torch.cuda.synchronize()
    assert int(out.num_inlier) == 8192
    for name in ("status_counts", "loc_counts_trans", "degenerate_trans"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in ("H", "b", "mean_abs_res"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=2e-4, atol=2e-2)
    assert torch.linalg.matrix_rank(blocks[1].double(), rtol=1e-5) == 1
    assert torch.linalg.matrix_rank(blocks[0].double(), rtol=1e-5) == 2
    _assert_eigen_close(out.eigvals_rot, out.eigvecs_rot, blocks[0])
    _assert_eigen_close(out.eigvals_trans, out.eigvecs_trans, blocks[1])


@pytest.mark.parametrize("cfg_name", sorted(GEO_CFGS))
def test_kernel_with_no_valid_point(scene, cfg_name):
    """All points invalid: zero blocks, so eigh3's isotropic branch and its
    axis fallbacks; every field equals the plain version's."""
    cfg = geo.GeometricConfig(**GEO_CFGS[cfg_name])
    matches, pts, valid, q, t = _args(scene, 4133)
    args = (matches, pts, torch.zeros_like(valid), q, t)
    out, (f32, _, _) = _launch(args, cfg, g_dir=scene["g_dir"])
    ref = geo.linearize_with(*args, cfg, g_dir=scene["g_dir"])
    torch.cuda.synchronize()
    assert not icp_cuda.blocks(f32).any()
    for name in geo.ICPResult._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    eye = torch.eye(3, device=pts.device)
    assert torch.equal(out.eigvecs_rot, eye)
    assert torch.equal(out.eigvecs_trans, eye)
    _assert_eigen_close(out.eigvals_rot, out.eigvecs_rot,
                        icp_cuda.blocks(f32)[0])


@pytest.mark.parametrize("n", [8192, 300000])
def test_two_launches_are_bitwise_equal(scene, n):
    cfg = geo.GeometricConfig(**GEO_CFGS["4dof_rot_thresh_differs"])
    args = _args(scene, n)
    a = icp_cuda.launch(*args, cfg, g_dir=scene["g_dir"])
    b = icp_cuda.launch(*args, cfg, g_dir=scene["g_dir"])
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_one_device_kernel_a_call(scene):
    """The profiler sees one kernel on the card for each linearize call,
    and the call issues no other device work."""
    from torch.profiler import ProfilerActivity, profile

    cfg = geo.GeometricConfig(**GEO_CFGS["4dof_rot_thresh_differs"])
    args = _args(scene, 8192)
    icp_cuda.linearize(*args, cfg, g_dir=scene["g_dir"])
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            icp_cuda.linearize(*args, cfg, g_dir=scene["g_dir"])
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == calls, [e.name for e in device]
    assert all("icp_linearize" in e.name for e in device)


def _unaligned(x):
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary (the bulk copy needs 16-byte alignment)."""
    pad = 4 // x.element_size()
    buf = torch.empty(x.numel() + pad, dtype=x.dtype, device=x.device)
    y = buf[pad:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("n", [8192, 4133])
def test_staged_and_unstaged_paths_agree_bitwise(scene, n):
    """Inputs off 16-byte alignment take the path that reads device memory
    in both passes; the sums run in the same order, so the result is the
    staged path's, bit for bit."""
    cfg = geo.GeometricConfig(**GEO_CFGS["4dof_rot_thresh_differs"])
    (normal, mean, found), pts, valid, q, t = _args(scene, n)
    staged = icp_cuda.launch((normal, mean, found), pts, valid, q, t, cfg,
                             g_dir=scene["g_dir"])
    unstaged = icp_cuda.launch(
        (_unaligned(normal), _unaligned(mean), _unaligned(found)),
        _unaligned(pts), _unaligned(valid), q, t, cfg, g_dir=scene["g_dir"])
    torch.cuda.synchronize()
    for x, y in zip(staged, unstaged):
        assert torch.equal(x, y)
