"""The port's CUDA ICP kernel against its plain PyTorch version, and the
steps captured as CUDA graphs against the same steps run op by op, on the
card: the scan step, the photometric scan step, every variant of the
four-modality stream (radar, odometry, late scans and radar frames), and
the bulk scheduler's chunks (bits of merged streaming, no host sync in a
chunk of captured variants, the ICP launches a chunk), and the last
modules: the binary factor against the CPU, ``io.viz``'s snapshot (one
kernel launch) and debug stream under a shared step cache, and the
exact-Ouster photometric Sequencer in bulk.

Every test here needs an NVIDIA GPU and nvcc (``cuda`` marker) and skips
without one (but the native pack's build-failure test, which needs g++
only). The file imports nothing of JAX, so it runs on a machine that
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
there the eigenspace is compared: projectors within 1e-4. A captured step
and an eager step from one state: the tolerances of
``tests/test_torch_slice.py`` (counts and flags exact); two replays of one
graph from one state: the same bits (but the map's write-off row).
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


# ------------------------------------------------ the captured scan step

def _room_sequencer(eager, mesh=None, step_cache=None, **seq_kw):
    """The room_clean configuration of ``io.synthetic_replay.run`` (16x256
    LiDAR, int16 codec), captured or eager, on ``mesh`` and with
    ``step_cache`` where given."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win

    kw = dict(max_scan_points=4096, n_geo_points=4096, n_map_points=8192,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15)
    kw.update(seq_kw)
    return seq.Sequencer(
        seq.SequencerConfig(**kw), win.WindowConfig(K=6),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        device="cuda", eager=eager, mesh=mesh, step_cache=step_cache)


@pytest.fixture(scope="module")
def room(dev):
    from mimosa_tpu_torch.io import synthetic as syn

    return syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=3.0),
                        syn.LidarModel(), seed=0)


def _feed(s, data, ks, imu_i=0):
    from mimosa_tpu_torch.io.synthetic_replay import feed

    for k in ks:
        imu_i = feed(s, data, k, imu_i)
    return imu_i


def _state(s):
    from mimosa_tpu_torch import convert

    torch.cuda.synchronize()
    return convert.sequencer_state(s)


def _assert_states_close(a, b):
    """The slice tolerances of tests/test_torch_slice.py: window states to
    1e-4, the prior to rtol 1e-2 of its scale, map counts and flags exact
    (but the write-off row), moments to rtol 1e-4, debug counts and flags
    exact."""
    for k in ("q", "p", "v", "g_dir", "bg", "ba"):
        np.testing.assert_allclose(a["window"][k], b["window"][k], atol=1e-4)
    np.testing.assert_array_equal(a["window"]["active"],
                                  b["window"]["active"])
    H, Hr = a["window"]["H_prior"], b["window"]["H_prior"]
    np.testing.assert_allclose(H, Hr, rtol=1e-2,
                               atol=1e-4 * np.abs(Hr).max())
    for k in ("coords", "occupied", "n", "plane_valid", "last_touch"):
        np.testing.assert_array_equal(a["vmap"][k][:-1], b["vmap"][k][:-1])
    for k in ("psum", "pssum"):
        np.testing.assert_allclose(a["vmap"][k], b["vmap"][k], rtol=1e-4,
                                   atol=1e-5 * np.abs(b["vmap"][k]).max())
    np.testing.assert_array_equal(a["kf_count"], b["kf_count"])
    d, dr = a["debug_rec"], b["debug_rec"]
    np.testing.assert_array_equal(d[:, :5], dr[:, :5])
    np.testing.assert_array_equal(d[:, 6:17], dr[:, 6:17])
    np.testing.assert_allclose(a["traj_p"], b["traj_p"], atol=1e-4)
    assert a["host"] == b["host"]


def _assert_states_equal(a, b):
    for name in ("window", "vmap", "preints"):
        for k, x in a[name].items():
            y = b[name][k]
            if name == "vmap":           # the write-off row takes any lane
                x, y = x[:-1], y[:-1]
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{k}")
    for k in ("fv", "kf_q", "kf_p", "kf_count", "traj_q", "traj_p",
              "debug_rec"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["host"] == b["host"]


def test_captured_step_matches_eager(room):
    """From the same state, one scan step replayed from its graph and one
    run op by op agree to the slice tolerances."""
    from mimosa_tpu_torch import convert

    eager, graph = _room_sequencer(True), _room_sequencer(False)
    n = 10
    imu_e = _feed(eager, room, range(n))
    _feed(graph, room, range(n))
    key = ("scan", False, True)
    assert key in graph.graphs.graphs      # captured by now
    convert.load_sequencer_state(graph, _state(eager))
    _feed(eager, room, [n], imu_e)
    _feed(graph, room, [n], imu_e)
    _assert_states_close(_state(graph), _state(eager))


def test_two_replays_are_bitwise_equal(room):
    """The same state and scan through one graph twice: the same bits."""
    from mimosa_tpu_torch import convert

    s = _room_sequencer(False)
    n = 10
    imu_i = _feed(s, room, range(n))
    start = _state(s)
    captures = s.graphs.captures
    _feed(s, room, [n], imu_i)
    first = _state(s)
    convert.load_sequencer_state(s, start)
    _feed(s, room, [n], imu_i)
    _assert_states_equal(_state(s), first)
    assert s.graphs.captures == captures   # replayed, not captured again


def test_replay_launches_the_icp_kernel_per_gn_iteration(room):
    """A replay of the append step adds n_gn_iters + 1 launches; the
    capture itself adds none. The profiler sees as many ICP kernels run on
    the card as the count says."""
    from torch.profiler import ProfilerActivity, profile

    s = _room_sequencer(False)
    imu_i = _feed(s, room, range(4))
    key = ("scan", False, True)
    assert key in s.graphs.warm and key in s.graphs.graphs
    graph, launches = s.graphs.graphs[key]
    assert launches == s.cfg.n_gn_iters + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(4, 8):
            before, replays = icp_cuda.LAUNCHES, s.graphs.replays
            imu_i = _feed(s, room, [k], imu_i)
            torch.cuda.synchronize()
            assert s.graphs.replays > replays
            assert icp_cuda.LAUNCHES - before == launches
    icp = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "icp_linearize" in e.name]
    assert len(icp) == 4 * launches


def test_ring_growth_recaptures_and_keeps_the_trajectory(room):
    """With 8 trajectory rows the rings grow twice in the replay; the step
    is captured again for the new buffers, and the trajectory equals the
    eager run's."""
    eager = _room_sequencer(True, max_trajectory=8)
    graph = _room_sequencer(False, max_trajectory=8)
    _feed(eager, room, range(len(room["scans"])))
    _feed(graph, room, range(len(room["scans"])))
    assert graph.traj_q.shape[0] == eager.traj_q.shape[0] == 32
    assert graph.graphs.captures >= 4     # append and marginalize, twice
    a = np.asarray([p for _, p, _ in graph.trajectory])
    b = np.asarray([p for _, p, _ in eager.trajectory])
    assert len(a) == len(b) == len(graph._traj_ts) > 16
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_native_pack_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that refuses the pack raises; nothing falls back."""
    from mimosa_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="could not build"):
        native.pack_scan(np.zeros((4, 3)), np.zeros(4), None, None, 1, 4, 4,
                         0.01, 1e-5, 0.1)


def test_same_key_variant_is_captured(room):
    """Two scans repeated 2 ms after the original attach to the newest
    state (the same-key path); the second one replays its graph. The
    trajectory equals the eager run's."""
    scans = list(room["scans"][:12])
    for k in (6, 9):
        scans.insert(k + 1, dict(scans[k], ts_header=scans[k]["ts_header"]
                                 + 2e-3))
    data = dict(room, scans=scans)
    eager, graph = _room_sequencer(True), _room_sequencer(False)
    _feed(eager, data, range(len(scans)))
    _feed(graph, data, range(len(scans)))
    assert graph.counters == eager.counters
    assert graph.counters["scans_same_key"] == 2
    assert ("scan", False, False) in graph.graphs.graphs
    a = np.asarray([p for _, p, _ in graph.trajectory])
    b = np.asarray([p for _, p, _ in eager.trajectory])
    np.testing.assert_allclose(a, b, atol=1e-4)


# ------------------------------------------------ the photometric factor

def _photo_sequencer(eager):
    """The room_photometric configuration of ``io.synthetic_replay.run``
    (16x256 LiDAR, int16 codec with the intensity column), captured or
    eager."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import photo_config

    return seq.Sequencer(
        seq.SequencerConfig(max_scan_points=4096, n_geo_points=4096,
                            n_map_points=8192, geo_leaf=0.4,
                            map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                            keyframe_rot_thresh=0.15),
        win.WindowConfig(K=6),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        photo_config(syn.LidarModel()), device="cuda", eager=eager)


@pytest.fixture(scope="module")
def noisy_room(dev):
    from mimosa_tpu_torch.io import synthetic as syn

    return syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=3.0),
                        syn.LidarModel(), seed=0, imu_noise=0.01,
                        range_noise=0.01)


def _assert_features_equal(a, b):
    for k, x in a["features"].items():
        np.testing.assert_array_equal(x, b["features"][k], err_msg=k)


def test_photometric_captured_replay_equals_eager(noisy_room):
    """The photometric Sequencer replayed from its graphs and run op by op:
    the same bits in every state field, the feature store included, with
    features tracked on every step after the second."""
    eager, graph = _photo_sequencer(True), _photo_sequencer(False)
    n = len(noisy_room["scans"])
    _feed(eager, noisy_room, range(n))
    _feed(graph, noisy_room, range(n))
    assert graph.graphs.replays > 10
    a, b = _state(graph), _state(eager)
    _assert_states_equal(a, b)
    _assert_features_equal(a, b)
    tracked = graph.debug_records()[2:, 12]
    assert (tracked > 0).all(), tracked
    assert graph.last_photo[0] == int(tracked[-1])


def test_photometric_two_replays_are_bitwise_equal(noisy_room):
    """The same state and scan through one photometric graph twice."""
    from mimosa_tpu_torch import convert

    s = _photo_sequencer(False)
    n = 10
    imu_i = _feed(s, noisy_room, range(n))
    start = _state(s)
    assert start["features"]["valid"].sum() > 10
    captures = s.graphs.captures
    _feed(s, noisy_room, [n], imu_i)
    first = _state(s)
    convert.load_sequencer_state(s, start)
    _feed(s, noisy_room, [n], imu_i)
    again = _state(s)
    _assert_states_equal(again, first)
    _assert_features_equal(again, first)
    assert s.graphs.captures == captures


def _photo_inputs(model):
    """(config, make_frame arguments as CPU tensors) of a seeded scene:
    four textured walls for the approximate model, an organized synthetic
    room scan with a deskew-like T_Le_Lt and per-row shifts for the exact
    one."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.lidar import photometric as ph

    if model == "exact":
        lm = syn.LidarModel()
        data = syn.generate(syn.room_world(), syn.TrajectoryConfig(
            t_total=1.5), lm, seed=0)
        sc = data["scans"][-1]
        raw = torch.tensor(np.nan_to_num(sc["points"]), dtype=torch.float32)
        frac = (torch.arange(len(raw)) % lm.n_cols / lm.n_cols)[:, None]
        q = lie.exp_so3(frac * torch.tensor([0.01, -0.02, 0.15]))
        t = frac * torch.tensor([0.3, -0.1, 0.02])
        shifts = tuple(int(s) for s in
                       np.random.default_rng(7).integers(-12, 13, 16))
        cfg = ph.PhotometricConfig(
            rows=16, cols=256, fov_up=lm.fov_up, fov_down=lm.fov_down,
            range_min=0.5, range_max=50.0, gradient_threshold=2.0,
            nma_radius=3, num_features=40, margin=3, intensity_scale=1.0,
            exact_ouster=True, pixel_shift_by_row=shifts,
            beam_offset_m=0.015)
        return cfg, (lie.se3_transform(q, t, raw),
                     torch.tensor(sc["intensity"], dtype=torch.float32),
                     torch.tensor(sc["valid"]), cfg, None, raw, q, t)
    rng = np.random.default_rng(6)
    pts = []
    for axis, val in [(0, 6.0), (1, 5.0), (0, -6.0), (1, -5.0)]:
        p = rng.uniform(-7, 7, size=(10000, 3))
        p[:, 2] = rng.uniform(-2.5, 2.5, size=10000)
        p[:, axis] = val
        pts.append(p)
    pts = np.concatenate(pts)
    inten = np.clip(120 + 60 * np.sin(2.0 * pts[:, 0])
                    * np.cos(1.5 * pts[:, 1])
                    + 40 * np.sin(3.0 * pts[:, 2]), 0, 255)
    cfg = ph.PhotometricConfig(rows=32, cols=256, range_min=0.5,
                               range_max=50.0, gradient_threshold=2.0,
                               nma_radius=3, num_features=40, margin=4,
                               intensity_scale=1.0)
    return cfg, (torch.tensor(pts, dtype=torch.float32),
                 torch.tensor(inten, dtype=torch.float32),
                 torch.ones(len(pts), dtype=torch.bool), cfg)


@pytest.mark.parametrize("model", ["approximate", "exact"])
def test_photometric_frame_and_factor_on_the_card_match_cpu(dev, model):
    """make_frame, detect_features and linearize on the card against the
    same calls on the CPU, with the tolerances of
    tests/test_torch_photometric.py: masks, validity, statuses exact;
    images within 1e-3 on the 0-255 scale; patch points within 1e-5 m;
    H and b within rtol 2e-4 of their largest entry. Detection and the
    factor take the CPU's frame on both devices (identical inputs)."""
    from mimosa_tpu_torch.lidar import photometric as ph

    def on(x, d):
        if x is None or isinstance(x, ph.PhotometricConfig):
            return x
        if type(x) is tuple:
            return tuple(on(v, d) for v in x)
        if isinstance(x, tuple):
            return type(x)(*[on(v, d) for v in x])
        return x.to(d)

    cfg, args = _photo_inputs(model)
    cpu = ph.make_frame(*args)
    card = ph.make_frame(*on(args, dev))
    for name, a in cpu._asdict().items():
        if a is None:
            assert getattr(card, name) is None
            continue
        b = getattr(card, name).cpu()
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            tol = 1e-3 if name in ("intensity", "gx", "gy") else 1e-5
            torch.testing.assert_close(b, a, rtol=0, atol=tol, msg=name)
    assert cpu.mask.float().mean() > 0.1

    q = lie.quat_identity()
    t = torch.zeros(3)
    feats = ph.detect_features(cpu, ph.empty_features(cfg), q, t, cfg)
    feats_d = ph.detect_features(on(cpu, dev), ph.empty_features(cfg,
                                                                 device=dev),
                                 q.to(dev), t.to(dev), cfg)
    assert int(feats.valid.sum()) > 10
    assert torch.equal(feats.valid, feats_d.valid.cpu())
    assert torch.equal(feats.life, feats_d.life.cpu())
    for name in ("pts_w", "psi", "center_w"):
        torch.testing.assert_close(getattr(feats_d, name).cpu(),
                                   getattr(feats, name), rtol=0, atol=1e-5)

    qp, tp = lie.se3_retract(q, t, torch.tensor(
        [0.002, -0.001, 0.006, 0.02, -0.01, 0.01]))
    ref = ph.linearize(cpu, feats, qp, tp, cfg)
    out = ph.linearize(on(cpu, dev), on(feats, dev), qp.to(dev), tp.to(dev),
                       cfg)
    assert int(ref.num_tracked) > 5
    assert torch.equal(out.status_counts.cpu(), ref.status_counts)
    assert torch.equal(out.tracked.cpu(), ref.tracked)
    for name in ("H", "b"):
        o, r = getattr(out, name).cpu(), getattr(ref, name)
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=2e-4 * r.abs().max().item())


# ------------------------------------------------ the four-modality stream

@pytest.fixture(scope="module")
def mm_stream(dev):
    """The CPU parity stream of tests/test_torch_ooo.py: a 3 s room from a
    16x256 LiDAR with 20 Hz radar and 10 Hz odometry, late and re-ordered
    arrivals of each kind."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import four_modality_stream

    return four_modality_stream(
        syn.TrajectoryConfig(t_total=3.0, t_stationary=1.23),
        syn.LidarModel())


def _feed_events(s, data, events, imu_i=0):
    from mimosa_tpu_torch.io.synthetic_replay import feed_event

    for ev in events:
        imu_i = feed_event(s, data, ev, imu_i)
    return imu_i


# the step variants the four-modality stream runs, by kind (radar and
# odometry keys also carry their configuration)
MM_VARIANTS = {("scan", False, True), ("scan", False, False), ("scan_ooo",),
               ("marginalize",), ("declare",), ("radar", "declare"),
               ("radar", "attach"), ("radar", "samekey"), ("radar", "ooo"),
               ("odom", True), ("odom", False)}


def _variant(key):
    return key[:2] if key[0] in ("radar", "odom") else key


def test_four_modality_captured_run_equals_eager(mm_stream):
    """The stream replayed from graphs and run op by op: the same bits in
    every state field and the same counters; every step variant was
    captured once and then replayed."""
    data, events = mm_stream
    eager, graph = _room_sequencer(True), _room_sequencer(False)
    _feed_events(eager, data, events)
    _feed_events(graph, data, events)
    assert graph.counters == eager.counters
    for k in ("radar_ooo_inserted", "radar_ooo_samekey",
              "scans_ooo_inserted", "scans_ooo_samekey", "odom_anchor"):
        assert graph.counters[k] > 0, (k, graph.counters)
    _assert_states_equal(_state(graph), _state(eager))
    g = graph.graphs
    assert {_variant(k) for k in g.graphs} == MM_VARIANTS
    assert g.captures == len(g.graphs)       # none captured twice
    assert g.replays > len(events) // 2


def test_four_modality_two_replays_are_bitwise_equal(mm_stream):
    """One stretch of the stream (late radar, odometry, a swapped scan
    inserted mid-window) twice from the same state through the captured
    graphs: the same bits, and no graph captured again."""
    from mimosa_tpu_torch import convert

    data, events = mm_stream
    s = _room_sequencer(False)
    j = len(events) // 2
    imu_i = _feed_events(s, data, events[:j])
    start = _state(s)
    c0 = dict(s.counters)
    _feed_events(s, data, events[j:], imu_i)
    first = _state(s)
    assert s.counters["scans_ooo_inserted"] > c0["scans_ooo_inserted"]
    assert s.counters["radar_ooo_inserted"] > c0["radar_ooo_inserted"]
    captures = s.graphs.captures
    convert.load_sequencer_state(s, start)
    _feed_events(s, data, events[j:], imu_i)
    _assert_states_equal(_state(s), first)
    assert s.graphs.captures == captures


def test_out_of_order_scan_replay_launches_match_the_profiler(mm_stream):
    """Over the second half of the stream, where the second swapped scan
    captures and replays the out-of-order step, the ICP launches counted
    equal
    (n_gn_iters + 1) per scan step, in order and out of order, and the
    kernels the profiler sees run on the card."""
    from torch.profiler import ProfilerActivity, profile

    data, events = mm_stream
    s = _room_sequencer(False)
    j = len(events) // 2
    imu_i = _feed_events(s, data, events[:j])
    # the first swapped scan ran the step's warm-up; the second is
    # captured and replayed inside the profiled half
    assert ("scan_ooo",) in s.graphs.warm
    assert ("scan_ooo",) not in s.graphs.graphs
    torch.cuda.synchronize()
    launches, steps = icp_cuda.LAUNCHES, s.scan_idx
    ooo = s.counters["scans_ooo_inserted"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _feed_events(s, data, events[j:], imu_i)
        torch.cuda.synchronize()
    assert s.counters["scans_ooo_inserted"] > ooo
    assert s.graphs.graphs[("scan_ooo",)][1] == s.cfg.n_gn_iters + 1
    counted = icp_cuda.LAUNCHES - launches
    assert counted == (s.cfg.n_gn_iters + 1) * (s.scan_idx - steps)
    ran = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "icp_linearize_kernel" in e.name]
    assert len(ran) == counted


# ------------------------------------ the online estimator and the checkpoint

def _recording(s):
    """Record what the online estimator's worker hands Sequencer ``s``, in
    order: ("imu", (ts, acc, gyro)) and ("scan", ts_header)."""
    order = []
    add_imu, add_scan = s.add_imu, s.add_scan

    def rec_imu(ts, acc, gyro):
        order.append(("imu", (ts, acc, gyro)))
        add_imu(ts, acc, gyro)

    def rec_scan(ts_header, staged):
        order.append(("scan", ts_header))
        add_scan(ts_header, staged=staged)

    s.add_imu, s.add_scan = rec_imu, rec_scan
    return order


def _replay_order(s, data, order):
    """Feed Sequencer ``s`` the recorded order offline."""
    by_header = {sc["ts_header"]: sc for sc in data["scans"]}
    for kind, x in order:
        if kind == "imu":
            s.add_imu(*x)
        else:
            sc = by_header[x]
            s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                       sc["valid"])
    torch.cuda.synchronize()


def _push_all(est, data, on_scan=None):
    """IMU and scans in arrival order (a scan 10 ms after its end), the
    worker caught up after every scan."""
    from mimosa_tpu_torch.graph.sequencer import Sequencer

    imu = data["imu"]
    ev = [(float(t), 0, i) for i, t in enumerate(imu["ts"])]
    ev += [(Sequencer._scan_t_end(sc) + 0.01, 1, k)
           for k, sc in enumerate(data["scans"])]
    for _, kind, k in sorted(ev):
        if kind == 0:
            est.push_imu(imu["ts"][k], imu["acc"][k], imu["gyro"][k])
            continue
        sc = data["scans"][k]
        assert est.push_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                             sc["valid"])
        if on_scan is not None:
            on_scan(k)
        assert est.flush(timeout=300.0)


def _same_trajectory(a, b):
    assert a._traj_ts == b._traj_ts
    np.testing.assert_array_equal(
        np.asarray([p for _, p, _ in a.trajectory]),
        np.asarray([p for _, p, _ in b.trajectory]))


def test_online_run_equals_the_captured_offline_run(room, caplog):
    """The online estimator on the card (scans staged on the pusher's thread,
    steps captured and replayed on the worker) gives the bits of the same
    Sequencer fed the worker's event order offline, captured."""
    import logging

    from mimosa_tpu_torch.io.online import OnlineEstimator

    s = _room_sequencer(False)
    order = _recording(s)
    states = []
    with caplog.at_level(logging.ERROR, logger="mimosa_tpu_torch.io.online"):
        est = OnlineEstimator(s, on_state=lambda ts, *a: states.append(ts))
        _push_all(est, room)
        est.stop(drain=True)
    assert not est._worker.is_alive() and not caplog.records
    assert est.counters["scans_dropped_backlog"] == 0
    assert s.graphs.replays > 0 and est.counters["rebases"] > 0
    off = _room_sequencer(False)
    _replay_order(off, room, order)
    _same_trajectory(s, off)
    # the last rebase carries the newest state, read from the card
    cs = est.current_state()
    assert cs.ts == states[-1] == s.last_state_ts
    np.testing.assert_array_equal(cs.p, s.current_state().p.astype(float))


def test_stage_during_a_capture_neither_fails_nor_reorders(room, caplog):
    """While the worker captures a step variant, this thread (the pusher)
    pushes IMU samples and the next scan, staging it: a pinned buffer, its
    copy to the card and an event, on this thread's stream. The capture
    succeeds (it is thread-local), and the run gives the bits of the same
    Sequencer fed the worker's order offline, captured: every staged copy
    landed before the step that read it."""
    import logging
    import queue

    from mimosa_tpu_torch.graph.sequencer import Sequencer
    from mimosa_tpu_torch.io.online import OnlineEstimator

    s = _room_sequencer(False)
    order = _recording(s)
    entered, release = queue.Queue(), queue.Queue()
    capture = s.graphs._capture

    def capture_waiting_for_a_stage(fn, bufs, ins):
        def step(*args):
            # inside the capture: wait until the pusher has staged a scan
            entered.put(None)
            release.get(timeout=120.0)
            return fn(*args)
        return capture(step, bufs, ins)

    s.graphs._capture = capture_waiting_for_a_stage
    imu = room["imu"]
    ev = [(float(t), 0, i) for i, t in enumerate(imu["ts"])]
    ev += [(Sequencer._scan_t_end(sc) + 0.01, 1, k)
           for k, sc in enumerate(room["scans"])]
    staged_in_capture, waiting = 0, False
    with caplog.at_level(logging.ERROR, logger="mimosa_tpu_torch.io.online"):
        est = OnlineEstimator(s)
        for _, kind, k in sorted(ev):
            if kind == 0:
                est.push_imu(imu["ts"][k], imu["acc"][k], imu["gyro"][k])
                continue
            sc = room["scans"][k]
            assert est.push_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                                 sc["valid"])
            if waiting:               # staged while the capture is open
                staged_in_capture += 1
                waiting = False
                release.put(None)
            # until the worker has caught up or is inside a capture
            while not est.flush(timeout=0.05):
                try:
                    entered.get_nowait()
                except queue.Empty:
                    continue
                waiting = True
                break
        if waiting:
            release.put(None)
        est.stop(drain=True)
    assert not est._worker.is_alive() and not caplog.records
    assert staged_in_capture >= 2 and s.graphs.captures >= 2
    off = _room_sequencer(False)
    _replay_order(off, room, order)
    _same_trajectory(s, off)


def test_checkpoint_between_replays_resumes_bitwise(room, tmp_path):
    """Save after 12 scans, run to the end, load, run the rest again: the
    captured graphs replay on the loaded state (its values copied into their
    static buffers, nothing captured again) and give the same bits."""
    from mimosa_tpu_torch.utils import checkpoint as ckpt

    s = _room_sequencer(False)
    n = 12
    imu_i = _feed(s, room, range(n))
    assert {("scan", False, True), ("marginalize",)} <= set(s.graphs.graphs)
    steps = s.scan_idx                    # the first scan initializes
    ckpt.save(s, tmp_path / "mid.npz")
    rest = range(n, len(room["scans"]))
    _feed(s, room, rest, imu_i)
    torch.cuda.synchronize()
    first = _state(s)
    traj = np.asarray([p for _, p, _ in s.trajectory])
    captures, replays = s.graphs.captures, s.graphs.replays
    ckpt.load(s, tmp_path / "mid.npz")
    assert s.scan_idx == steps
    _feed(s, room, rest, imu_i)
    assert s.graphs.captures == captures and s.graphs.replays > replays
    _assert_states_equal(_state(s), first)
    np.testing.assert_array_equal(
        np.asarray([p for _, p, _ in s.trajectory]), traj)


# ------------------------------------------------ the bulk scheduler

def _bulk_replay(s, data, msgs, bulk, chunk=8):
    """All IMU first, then ``msgs`` through add_bulk, or streamed in
    add_bulk's dispatch order (time, then scan / radar / odometry)."""
    from mimosa_tpu_torch.graph.sequencer import Sequencer

    imu = data["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    if bulk:
        s.add_bulk(msgs, chunk=chunk)
        return s
    code = {"scan": 0, "radar": 1, "odom": 2}
    for _, _, m in sorted(
            ((Sequencer._scan_t_end(m) if m.get("kind", "scan") == "scan"
              else float(m["ts"])), code[m.get("kind", "scan")], m)
            for m in msgs):
        kind = m.get("kind", "scan")
        if kind == "radar":
            s.add_radar(m["ts"], m["points_r"], m["doppler"], m["snr_db"])
        elif kind == "odom":
            s.add_odometry(m["ts"], m["q"], m["p"], m["cov6"])
        else:
            s.add_scan(m["ts_header"], m["points"], m["t_rel"], m["valid"])
    return s


def _assert_bulk_bitwise(b, s):
    assert b.bulk_counts["chunks"] > 0
    assert b.counters == s.counters and b.state_ts == s.state_ts
    assert b._traj_ts == s._traj_ts and b._traj_src == s._traj_src
    for (_, pb, qb), (_, ps, qs) in zip(b.trajectory, s.trajectory):
        np.testing.assert_array_equal(pb, ps)
        np.testing.assert_array_equal(qb, qs)


def test_scan_only_bulk_equals_merged_streaming_on_the_card(room):
    """Chunks of captured scan steps replayed from device slabs give the
    bits of the captured streaming path with the merged slide."""
    b = _bulk_replay(_room_sequencer(False), room, room["scans"], True)
    s = _bulk_replay(_room_sequencer(False, merge_marginalize=True), room,
                     room["scans"], False)
    assert ("scan", True, True) in b.graphs.graphs
    _assert_bulk_bitwise(b, s)


def test_mixed_bulk_equals_merged_streaming_on_the_card(dev):
    """synthetic_replay.bulk_stream (radar and odometry declares and
    attaches inside chunks): bulk and merged streaming, both captured, give
    the same bits."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io import synthetic_replay as trep

    data, events = trep.bulk_stream(
        syn.TrajectoryConfig(t_total=2.5, t_stationary=1.23),
        syn.LidarModel())
    msgs = trep.bulk_messages(events)
    b = _bulk_replay(_room_sequencer(False), data, msgs, True)
    s = _bulk_replay(_room_sequencer(False, merge_marginalize=True), data,
                     msgs, False)
    assert all(n > 0 for n in b.bulk_counts["codes"]), b.bulk_counts
    _assert_bulk_bitwise(b, s)


def test_a_captured_chunk_makes_no_host_sync_and_launches_4_per_scan(room):
    """A chunk whose variants are captured already: no host sync anywhere
    in it (pack, the slabs' copies, the replays, the bookkeeping), the ICP
    kernel launched (n_gn_iters + 1) times per scan step by the count and
    by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    s = _room_sequencer(False)
    scans = room["scans"]
    imu = room["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    # initialization, the K = 6 window's fill, and one chunk: its first
    # scan warms the merged scan variant up, its second captures it
    n0 = 6 + 4
    s.add_scans_bulk(scans[:n0], chunk=4)
    assert s.bulk_counts["chunks"] == 1
    assert ("scan", True, True) in s.graphs.graphs
    torch.cuda.synchronize()
    chunk = scans[n0:n0 + 4]
    launches, captures = icp_cuda.LAUNCHES, s.graphs.captures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            s.add_scans_bulk(chunk, chunk=4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert s.bulk_counts["chunks"] == 2 and s.bulk_counts["in_chunks"] == 8
    assert s.bulk_counts["streamed"] == n0 - 4
    assert s.graphs.captures == captures
    n1 = s.cfg.n_gn_iters + 1
    assert icp_cuda.LAUNCHES - launches == n1 * len(chunk)
    ran = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    assert ran == n1 * len(chunk)


# ------------------------------------ tracking-loss rescue and rematch

RESCUE_KW = dict(rescue_enabled=True, rescue_radius=1.0)   # 2.5 map leaves
KICK_AT = 15
KICK = (0.85, 0.5, 0.0)       # ~2.5 leaves, as tests/test_rescue.py's kick
SMALL_KICK = (0.21, 0.125, 0.0)


def _kick(s, dp):
    """Shift every window state, values and linearization points, by dp:
    the map then disagrees with everything the estimator believes."""
    dp = torch.tensor(dp, dtype=s.window.p.dtype, device=s.window.p.device)
    s.window = s.window._replace(p=s.window.p + dp,
                                 lin_p=s.window.lin_p + dp)


@pytest.fixture(scope="module")
def long_room(dev):
    """The room of ``room``, 5 s: 38 scan steps, so that the tail after a
    kick at scan 15 holds 15 states."""
    from mimosa_tpu_torch.io import synthetic as syn

    return syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=5.0),
                        syn.LidarModel(), seed=0)


def _kicked_run(s, data, dp=KICK, at=KICK_AT, upto=None):
    imu_i = _feed(s, data, range(at))
    _kick(s, dp)
    _feed(s, data, range(at, upto or len(data["scans"])), imu_i)
    torch.cuda.synchronize()
    return s


def _positions(s):
    return np.asarray([p for _, p, _ in s.trajectory])


def test_kicked_stream_rescues_and_captured_equals_eager(long_room):
    """The tracking-loss rescue recovers a kicked window: the flag (debug
    slot 16) set on the same scans captured and eager, positions within
    the capture gate (1 cm), the tail ATE (the 8 states after the kick
    left out) under 0.10 m as in tests/test_rescue.py."""
    from mimosa_tpu_torch.io import synthetic as syn

    cap = _kicked_run(_room_sequencer(False, **RESCUE_KW), long_room)
    eag = _kicked_run(_room_sequencer(True, **RESCUE_KW), long_room)
    fc, fe = cap.debug_records()[:, 16], eag.debug_records()[:, 16]
    assert fc.sum() >= 1
    np.testing.assert_array_equal(fc, fe)
    np.testing.assert_allclose(_positions(cap), _positions(eag), atol=0.01)
    tr = cap.trajectory
    keep = [i for i in range(len(tr)) if not KICK_AT <= i < KICK_AT + 8]
    ate = syn.ate_rmse(np.array([tr[i][0] for i in keep]),
                       np.array([tr[i][1] for i in keep]),
                       long_room["gt"]["ts"], long_room["gt"]["pos"])
    assert ate < 0.10, ate


def test_rescue_runs_inside_the_scan_graph_without_a_host_sync(room):
    """The rescue is a conditional node of the captured scan step: the
    lost scan, in a bulk chunk, replays the graph captured before the kick
    (no capture after it, no host sync in the chunk), and the card runs
    the body's 14 x 3 + n_gn_iters ICP kernels on the rescued scan only.
    The count, with the body's device counter read when asked, equals the
    profiler's."""
    from torch.profiler import ProfilerActivity, profile

    s = _room_sequencer(False, **RESCUE_KW)
    scans, imu = room["scans"], room["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    s.add_scans_bulk(scans[:KICK_AT], chunk=4)
    assert ("scan", True, True) in s.graphs.graphs
    captures, n1 = s.graphs.captures, s.cfg.n_gn_iters + 1
    _kick(s, KICK)
    torch.cuda.synchronize()
    icp_cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            s.add_scans_bulk(scans[KICK_AT:KICK_AT + 2], chunk=2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert s.graphs.captures == captures
    assert s.bulk_counts["in_chunks"] >= 2 + 4
    flags = s.debug_records()[KICK_AT - 1:KICK_AT + 1, 16]
    body = 14 * 3 + s.cfg.n_gn_iters
    ran = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    assert flags.sum() >= 1
    assert ran == 2 * n1 + body * int(flags.sum())
    assert icp_cuda.launches() == ran


def test_clean_stream_with_rescue_on_equals_rescue_off(room):
    """On a clean stream the node's body never runs: slot 16 stays 0 and
    the trajectory equals the run without rescue."""
    on = _room_sequencer(False, **RESCUE_KW)
    off = _room_sequencer(False)
    _feed(on, room, range(len(room["scans"])))
    _feed(off, room, range(len(room["scans"])))
    assert on.debug_records()[:, 16].sum() == 0
    np.testing.assert_array_equal(_positions(on), _positions(off))


def test_rematch_captured_equals_eager(room):
    """rematch_on_motion after a small kick (~0.25 m: points move past a
    quarter leaf during GN, no rescue): captured and eager within the
    capture gate, and the run differs from the one without rematch."""
    runs = [_kicked_run(_room_sequencer(eager, rematch_on_motion=r), room,
                        SMALL_KICK)
            for eager, r in ((False, True), (True, True), (False, False))]
    np.testing.assert_allclose(_positions(runs[0]), _positions(runs[1]),
                               atol=0.01)
    assert np.abs(_positions(runs[0]) - _positions(runs[2])).max() > 0


def test_kicked_bulk_equals_merged_streaming_on_the_card(long_room):
    """The kicked stream's rescued scan inside a bulk chunk of captured
    steps: the bits of merged streaming, slot 16 equal."""
    scans, imu = long_room["scans"], long_room["imu"]
    b = _room_sequencer(False, **RESCUE_KW)
    s = _room_sequencer(False, merge_marginalize=True, **RESCUE_KW)
    b.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    b.add_scans_bulk(scans[:KICK_AT], chunk=4)
    _kick(b, KICK)
    b.add_scans_bulk(scans[KICK_AT:], chunk=4)
    _kicked_run(s, long_room)
    assert b.bulk_counts["chunks"] > 2
    np.testing.assert_array_equal(b.debug_records(), s.debug_records())
    assert b.debug_records()[:, 16].sum() >= 1
    _assert_bulk_bitwise(b, s)


# ------------------------------------------------ the mesh and the cache


@pytest.fixture(scope="module")
def nccl_mesh(dev):
    """A world of one NCCL rank on the card (a hash store) and its
    ("dp", "mp") mesh."""
    import torch.distributed as dist

    from mimosa_tpu_torch.parallel import sharded

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield sharded.make_mesh(n_mp=1, device_type="cuda")
    dist.destroy_process_group()


def test_mesh_scan_step_captured_equals_eager(room, nccl_mesh):
    """The scan step on a world-size-1 NCCL mesh, its all-reduces recorded
    into the captured graph (and into the rescue's conditional node):
    captured and eager within the capture gate, the same counters and
    rescue flags, the ICP kernel n_gn_iters + 1 a scan and 14 x 3 +
    n_gn_iters more on a rescued one (the mesh's per-iteration match may
    rescue the first scan on the just-born map, as
    tests/test_parallel.py:384-390 says of the JAX package's)."""
    runs = []
    for eager in (False, True):
        s = _room_sequencer(eager, mesh=nccl_mesh, rescue_enabled=True)
        icp_cuda.reset_launches()
        _feed(s, room, range(len(room["scans"])))
        torch.cuda.synchronize()
        runs.append((s, icp_cuda.launches()))
    (cap, n_cap), (eag, n_eag) = runs
    assert cap.graphs.captures > 0 and cap.graphs.replays > 0
    assert cap.counters == eag.counters
    np.testing.assert_array_equal(cap.debug_records()[:, 16],
                                  eag.debug_records()[:, 16])
    np.testing.assert_allclose(_positions(cap), _positions(eag), atol=0.01)
    body = 14 * 3 + cap.cfg.n_gn_iters
    n1 = cap.cfg.n_gn_iters + 1
    rescued = int(eag.debug_records()[:, 16].sum())
    assert n_eag == n1 * eag.scan_idx + body * rescued
    # the stream runs one scan variant, whose warm-up (the first scan
    # step) runs the rescue's body once whatever the predicate
    assert [k for k in cap.graphs.warm if k[0] == "scan"] == [
        ("scan", False, True)]
    first = int(eag.debug_records()[0, 16])
    assert n_cap == n1 * cap.scan_idx + body * (rescued + 1 - first)


def test_shared_step_cache_interleaved_equals_separate(room):
    """Two Sequencers of one configuration fed scan by scan in turns
    through one step cache (one CapturedSteps, its graphs and static
    buffers) give the bits of each run through a cache of its own, with
    fewer graphs captured."""
    from mimosa_tpu_torch.io import synthetic as syn

    datas = [room, syn.generate(syn.room_world(), syn.TrajectoryConfig(
        t_total=3.0), syn.LidarModel(), seed=1)]
    alone = [_room_sequencer(False) for _ in datas]
    for s, d in zip(alone, datas):
        _feed(s, d, range(len(d["scans"])))
    cache = {}
    shared = [_room_sequencer(False, step_cache=cache) for _ in datas]
    assert shared[0].graphs is shared[1].graphs
    imu = [0, 0]
    for k in range(max(len(d["scans"]) for d in datas)):
        for j, (s, d) in enumerate(zip(shared, datas)):
            if k < len(d["scans"]):
                imu[j] = _feed(s, d, [k], imu[j])
    torch.cuda.synchronize()
    for s, a in zip(shared, alone):
        assert s.counters == a.counters
        for x, y in zip(s.trajectory, a.trajectory):
            assert x[0] == y[0]
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_array_equal(x[2], y[2])
    assert shared[0].graphs.captures < sum(a.graphs.captures for a in alone)


# --------------------------- the binary factor, the snapshot, exact Ouster

def test_binary_factor_on_the_card_matches_cpu(scene):
    """linearize_binary (plain torch on both devices) on the card against
    the CPU on the same map, scan and poses: H and b to the kernel gate,
    the counts exact."""
    _, pts, valid, q, t = _args(scene, 8192)
    # the map's frame a little off the world's: the target state
    q_t, t_t = lie.se3_retract(*lie.se3_identity(q.dtype, q.device),
                               torch.tensor([0.002, -0.001, 0.003, 0.02,
                                             0.01, -0.01], device=q.device))
    args = (pts, valid, q, t, q_t, t_t)
    cfg = geo.GeometricConfig(**GEO_CFGS["default"])
    out = geo.linearize_binary(scene["vmap"], *args, MAP_CFG, cfg)
    cpu_map = type(scene["vmap"])(*(x.cpu() for x in scene["vmap"]))
    ref = geo.linearize_binary(cpu_map, *(a.cpu() for a in args), MAP_CFG,
                               cfg)
    assert int(ref.num_inlier) > 1000
    for name in geo.BinaryICPResult._fields:
        o, r = getattr(out, name).cpu(), getattr(ref, name)
        if o.dtype.is_floating_point:
            torch.testing.assert_close(o, r, rtol=2e-4, atol=2e-2)
        else:
            assert torch.equal(o, r), (name, o, r)


def test_icp_snapshot_launches_the_kernel_once(room):
    """icp_snapshot on a captured Sequencer: one ICP kernel launch, whose
    result matches the plain version on the card on the same inputs, and
    the JAX test's checks."""
    from mimosa_tpu_torch.io import viz

    s = _room_sequencer(False)
    _feed(s, room, range(len(room["scans"])))
    scan = room["scans"][-1]
    icp_cuda.reset_launches()
    snap = viz.icp_snapshot(s, scan["points"], scan["valid"],
                            max_points=4096)
    assert icp_cuda.launches() == 1
    inputs = viz.snapshot_inputs(s, scan["points"], scan["valid"], 4096)
    ref = geo.linearize_with(*inputs, s.geo_cfg, s.window.g_dir)
    _assert_close(snap["icp"], ref)
    inl = snap["inlier"]
    assert snap["num_inlier"] == int(inl.sum()) > 50
    assert np.allclose(np.linalg.norm(snap["normal"][inl], axis=-1), 1.0,
                       atol=1e-3)
    seg = np.linalg.norm(snap["p_w"][inl] - snap["foot"][inl], axis=-1)
    assert np.median(seg) < 0.1


def test_debug_stream_reads_each_sequencers_own_state(room, tmp_path):
    """Two Sequencers through one step cache, fed in turns, each with a
    stream of every scan: each stream's lines are those of the same run
    through a cache of its own (a stream reads its Sequencer's state, not
    the shared graphs' buffers)."""
    import json

    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io import viz

    datas = [room, syn.generate(syn.room_world(), syn.TrajectoryConfig(
        t_total=3.0), syn.LidarModel(), seed=1)]

    def run(seqs, tag, turns):
        streams = [viz.DebugStream(str(tmp_path / f"{tag}{j}.jsonl"), 1)
                   for j in range(2)]
        imu = [0, 0]
        order = [(k, j) for k in range(max(len(d["scans"]) for d in datas))
                 for j in range(2)] if turns else \
            [(k, j) for j in range(2) for k in range(len(datas[j]["scans"]))]
        for k, j in order:
            if k < len(datas[j]["scans"]):
                imu[j] = _feed(seqs[j], datas[j], [k], imu[j])
                streams[j].emit(seqs[j])
        for st in streams:
            st.close()
        return [[json.loads(ln) for ln in open(st.path)] for st in streams]

    cache = {}
    shared = run([_room_sequencer(False, step_cache=cache)
                  for _ in datas], "shared", turns=True)
    alone = run([_room_sequencer(False) for _ in datas], "alone",
                turns=False)
    assert shared == alone and all(len(x) > 10 for x in shared)


def _ouster_room():
    """The staggered 16x256 room of tests/test_torch_ouster.py in the Ouster
    sensor frame, and its exact-Ouster photometric Sequencer settings."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.lidar import photometric as ph

    rows, cols = 16, 256
    alts = np.radians(np.linspace(22.0, -22.0, rows))
    shifts = np.random.default_rng(3).integers(0, cols, rows)
    data, q_b_l = syn.ouster_sensor_frame(syn.generate_ouster(
        syn.room_world(), syn.TrajectoryConfig(t_total=2.0), alts, shifts,
        n_cols=cols, seed=0))
    pc = ph.PhotometricConfig(
        rows=rows, cols=cols, range_min=0.5, range_max=40.0,
        beam_altitudes=tuple(float(a) for a in alts),
        gradient_threshold=2.0, nma_radius=5, num_features=32, margin=3,
        intensity_scale=1.0, filter_brightness=False, remove_lines=False,
        exact_ouster=True, pixel_shift_by_row=tuple(int(s) for s in shifts))
    return data, pc, q_b_l


def test_exact_ouster_bulk_equals_merged_streaming_on_the_card(dev):
    """The exact-Ouster photometric Sequencer, captured: add_scans_bulk
    against merged streaming gives the same bits and the same slot 12,
    which tracks on every step after the second."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win

    data, pc, q_b_l = _ouster_room()

    def make(**kw):
        return seq.Sequencer(
            seq.SequencerConfig(max_scan_points=pc.rows * pc.cols,
                                n_geo_points=2048, n_map_points=4096,
                                geo_leaf=0.4, map_insert_leaf=0.15,
                                keyframe_trans_thresh=0.3,
                                keyframe_rot_thresh=0.15, n_gn_iters=2,
                                q_b_l=q_b_l, **kw),
            win.WindowConfig(K=4),
            vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=14,
                              plane_min_points=5, lru_horizon=0),
            geo.GeometricConfig(), pc, device="cuda")

    b = make()
    imu = data["imu"]
    b.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    b.add_scans_bulk(data["scans"], chunk=4)
    s = make(merge_marginalize=True)
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    for sc in data["scans"]:
        s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"], sc["valid"],
                   intensity=sc["intensity"])
    torch.cuda.synchronize()
    assert b.bulk_counts["in_chunks"] > 0
    _assert_bulk_bitwise(b, s)
    db, ds = b.debug_records(), s.debug_records()
    np.testing.assert_array_equal(db[:, 12], ds[:, 12])
    assert (ds[2:, 12] > 0).all(), ds[:, 12]
