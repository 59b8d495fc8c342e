"""The port's CUDA ICP kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc (``cuda`` marker) and skips
without one. The file imports nothing of JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit; ``tests/conftest.py`` imports jax,
so run it there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: counts and flags exact; H and b to the JAX Pallas test's gate
(rtol 2e-4, atol 2e-2), since the kernel sums in another order.
"""

import numpy as np
import pytest
import torch

from mimosa_tpu_torch.core import lie
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
    """A room (floor, ceiling, three walls) in a port map, and a pose."""
    rng = np.random.default_rng(0)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(8000, 3))
        p[:, axis] = val + rng.normal(size=8000) * 0.003
        clouds.append(p)
    world = torch.tensor(np.concatenate(clouds), dtype=torch.float32,
                         device=dev)
    vmap = vh.insert(vh.create(MAP_CFG, dev), world,
                     torch.ones(len(world), dtype=torch.bool, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev), MAP_CFG)
    vmap = vh.update_planes(vmap, MAP_CFG)
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
