"""The port's mesh-sharded path (``parallel/sharded.py``,
``Sequencer(mesh=...)``) and its step cache, against the JAX package.

* ``_owner_ok`` against the JAX package's over n_mp in {1, 2, 4}, two
  ``capacity_log2`` and points on both sides of the origin (negative
  hashes): exact. ``make_mesh`` refuses n_mp = 3.
* Four CPU processes in one gloo group, a ``("dp", "mp")`` mesh of 2 x 2
  (``tests/torch_sharded_worker.py``, one process a rank), against the
  JAX package's functions on ``make_mesh(4, n_mp=2)`` over the conftest's
  CPU devices, on the same inputs (tests/test_parallel.py's room):

  - ``sharded_insert``: the ranks' sub-tables gathered into the stacked
    layout against the JAX package's stacked map, row by row: integer
    fields exact (but the write-off row), moments rtol 1e-5 / atol 1e-5,
    plane means likewise where a plane is valid, normals atol 1e-4
    (tests/test_torch_lidar.py's gates) against the JAX package's plane fit
    of its row run op by op (its jitted mesh insert rounds that fit
    otherwise: up to 1.3e-4 apart on a normal of this room);
  - ``sharded_linearize`` on the JAX package's stacked map (each rank its
    row, ``convert.sharded_map_from_numpy``), two geometric
    configurations: H and b at the ICP gate (rtol 2e-4, atol 2e-2),
    mean |r| and the eigenvalues rtol 1e-4, counts and flags exact, on
    every rank;
  - ``sharded_radar_linearize``: rtol 1e-4 / atol 1e-4
    (tests/test_parallel.py:209-215), the inlier count exact;
  - a ``Sequencer(mesh=...)`` replay of tests/test_parallel.py's
    exception-path stream (cut to 2 s: the same-key duplicate and the
    late scan kept) at that test's configuration (2048 ICP points, K=4,
    rescue on at 0.05), every rank the same bits, held against the port's
    single-device Sequencer on the same stream under the JAX test's
    structural bounds (tests/test_parallel.py:436-475): equal counters and
    timestamps, positions within 0.05 m (the mesh matches afresh every
    GN iteration, the single device once a scan), ATE < 0.08 m, slot 16
    never set.

  The JAX package's mesh step and mesh Sequencer are not compiled here
  (minutes on this CPU); the JAX references of the unit calls run on a
  thread beside the ranks.
* A mesh of world size 1 (a one-process gloo group): the same replay
  within 0.05 m of the single-device port; and tests/test_torch_rescue.py's
  kicked replay on it, rescued (slot 16) with a tail ATE under 0.10 m.
* The step cache on the CPU: Sequencers of one configuration share the
  step functions, another configuration and a mesh Sequencer keep their
  own; interleaved Sequencers through one cache give the bits of
  separate ones (one intra-op thread).
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mimosa_tpu.core import lie as jlie
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu.parallel import sharded as jpar
from mimosa_tpu.radar import factor as jrad
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.mapping import voxel_hash as tvh
from mimosa_tpu_torch.odometry import factor as todo
from mimosa_tpu_torch.parallel import sharded as tpar
from mimosa_tpu_torch.radar import factor as trad

import torch_sharded_worker as wk
from test_parallel import room_points
from torch_fixtures import one_thread_then_free_programs  # noqa: F401

RANKS = 4
WORKER_TIMEOUT = 70      # [s] for the gloo ranks to start, run and exit
STRUCTURAL = 0.05        # [m] mesh against single (test_parallel.py:459)
MAP_INT = ("coords", "occupied", "last_touch", "plane_valid")


@pytest.mark.parametrize("cap_log2", [13, 19])
@pytest.mark.parametrize("n_mp", [1, 2, 4])
def test_owner_ok_matches_jax(n_mp, cap_log2):
    rng = np.random.default_rng(n_mp * 100 + cap_log2)
    pts = rng.uniform(-200, 200, size=(20000, 3)).astype(np.float32)
    leaf = 0.5
    own_t = [tpar._owner_ok(torch.from_numpy(pts), leaf, n_mp, i,
                            cap_log2).numpy() for i in range(n_mp)]
    for i in range(n_mp):
        own_j = np.asarray(jpar._owner_ok(
            jnp.asarray(pts), jnp.asarray(leaf, jnp.float32), n_mp, i,
            cap_log2))
        np.testing.assert_array_equal(own_t[i], own_j)
    # an exact partition
    np.testing.assert_array_equal(np.sum(own_t, axis=0), 1)


def test_make_mesh_rejects_non_pow2_mp():
    with pytest.raises(ValueError):
        tpar.make_mesh(n_mp=3, device_type="cpu")


def test_sharded_map_from_numpy_takes_the_row():
    cfg = tvh.VoxelMapConfig(capacity_log2=6)
    rows = [convert.to_numpy(tvh.create(cfg)) for _ in range(2)]
    rows[1]["n"][3] = 7.0
    stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    got = convert.sharded_map_from_numpy(stacked, 1)
    assert float(got.n[3]) == 7.0 and float(got.n.sum()) == 7.0
    assert got.coords.dtype == torch.int32


# ------------------------------------------------------- four gloo ranks


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _unit_inputs():
    """tests/test_parallel.py's room (20000 points) and 4096 body points
    at a pose off the truth, and test_sharded_radar_matches_single's
    radar frame; all f32 numpy."""
    world = room_points()
    q_true = jlie.exp_so3(jnp.asarray([0.03, -0.05, 0.4], jnp.float32))
    t_true = jnp.asarray([2.0, 1.5, 1.2], jnp.float32)
    rng = np.random.default_rng(1)
    qi, ti = jlie.se3_inverse(q_true, t_true)
    pts = jlie.se3_transform(qi, ti, jnp.asarray(
        world[rng.choice(len(world), 4096, replace=False)]))
    q = jlie.quat_mul(q_true, jlie.exp_so3(
        jnp.asarray([0.02, -0.01, 0.03], jnp.float32)))
    t = t_true + jnp.asarray([0.1, -0.05, 0.08], jnp.float32)
    valid = np.ones(4096, bool)
    valid[-100:] = False
    g_dir = np.asarray([0.05, -0.02, -1.0], np.float32)
    g_dir /= np.linalg.norm(g_dir)

    rng = np.random.default_rng(2)
    n = 256
    pts_r = rng.uniform(-1, 1, size=(n, 3)) * [20, 10, 3]
    snr = rng.uniform(0, 30, size=n)
    f32 = jnp.float32
    dirs, _, r_valid = jrad.filter_targets(
        jnp.asarray(pts_r, f32), jnp.asarray(snr, f32),
        jrad.RadarConfig(**wk.RADAR_KW))
    r_q = jlie.exp_so3(jnp.asarray([0.1, -0.2, 0.3], f32))
    r_v = np.asarray([1.0, -0.5, 0.2], np.float32)
    vr = np.asarray(jlie.quat_rotate(jlie.quat_conj(r_q), jnp.asarray(r_v)))
    dop = -(np.asarray(dirs) @ vr) + rng.normal(size=n) * 0.05
    f = np.float32
    return dict(
        world=world.astype(f), pts=np.asarray(pts, f), valid=valid,
        q=np.asarray(q, f), t=np.asarray(t, f), g_dir=g_dir,
        r_q=np.asarray(r_q, f), r_v=r_v, r_bg=np.asarray(
            [0.01, -0.02, 0.005], f), r_om=np.asarray([0.05, 0.1, -0.3], f),
        r_dirs=np.asarray(dirs, f), r_dop=dop.astype(f),
        r_valid=np.asarray(r_valid))


def _jax_units(u, stacked, mesh):
    """The JAX package's linearizations on ``stacked`` (jitted: shard_map
    outside jit runs op by op) and its radar block."""
    map_cfg = jvh.VoxelMapConfig(**wk.MAP_KW)
    lin = jax.jit(jpar.sharded_linearize, static_argnums=(6, 7, 8))
    out = {}
    for i, kw in enumerate(wk.GEO_CFGS):
        res = lin(stacked, *(jnp.asarray(u[k]) for k in
                             ("pts", "valid", "q", "t", "g_dir")),
                  map_cfg, jgeo.GeometricConfig(**kw), mesh)
        out.update({f"icp{i}_{k}": np.asarray(v)
                    for k, v in res._asdict().items()})
    rl = jax.jit(jpar.sharded_radar_linearize, static_argnums=(7, 8))
    res = rl(*(jnp.asarray(u[k]) for k in ("r_q", "r_v", "r_bg", "r_om",
                                            "r_dirs", "r_dop", "r_valid")),
             jrad.RadarConfig(**wk.RADAR_KW), mesh)
    out.update({"radar_" + k: np.asarray(v)
                for k, v in res._asdict().items()})
    return out


def _spawn(world, rank, addr, out, inputs=None):
    return subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      "torch_sharded_worker.py"),
         addr, str(world), str(rank), str(out)]
        + ([str(inputs)] if inputs is not None else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks of a 2 x 2 mesh and two worlds of one (the stream, the
    kicked replay), running while
    this process computes the JAX references (on a thread) and the
    single-device replay. The JAX stacked map is made first: the ranks
    linearize on it."""
    tmp = tmp_path_factory.mktemp("sharded")
    u = _unit_inputs()
    jmesh = jpar.make_mesh(RANKS, n_mp=2)
    map_cfg = jvh.VoxelMapConfig(**wk.MAP_KW)
    ins = jax.jit(jpar.sharded_insert, static_argnums=(4, 5))
    stacked = ins(jpar.create_sharded_map(map_cfg, jmesh),
                  jnp.asarray(u["world"]), jnp.ones(len(u["world"]), bool),
                  jnp.asarray(0, jnp.int32), map_cfg, jmesh)
    stacked_np = {k: np.asarray(v) for k, v in stacked._asdict().items()}
    # the JAX package's plane fit, op by op, of each row's moments: its
    # jitted mesh insert fits the same moments with other f32 rounding
    # (up to 1.3e-4 apart on a normal of this room)
    refit = [np.asarray(jvh.update_planes(jax.tree_util.tree_map(
        lambda a: a[i], stacked), map_cfg).normal) for i in range(2)]
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **u, **{"map_" + k: v for k, v in stacked_np.items()})
    addr4 = f"tcp://127.0.0.1:{_free_port()}"
    addr1 = f"tcp://127.0.0.1:{_free_port()}"
    procs = [_spawn(RANKS, r, addr4, tmp / f"out{r}.npz", inputs)
             for r in range(RANKS)]
    procs.append(_spawn(1, 0, addr1, tmp / "ws1.npz"))
    procs.append(_spawn(1, 0, f"tcp://127.0.0.1:{_free_port()}",
                        tmp / "kicked.npz", "kicked"))
    errs = []
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            future = pool.submit(_jax_units, u, stacked, jmesh)
            single = wk.replay_stream(wk.exception_path_sequencer(),
                                      *wk.exception_path_stream())
            jref = future.result()
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    return dict(inputs=u, stacked=stacked_np, refit=refit, jax=jref,
                single=single,
                out=[dict(np.load(tmp / f"out{r}.npz")) for r in
                     range(RANKS)],
                ws1=dict(np.load(tmp / "ws1.npz")),
                kicked=dict(np.load(tmp / "kicked.npz")))


@pytest.mark.parametrize("row", [0, 1])
def test_sharded_insert_matches_jax_stack(ranks, row):
    """The ranks' tables gathered, row ``row`` (mp index) against the JAX
    package's stacked map; every rank gathered the same stack."""
    ref = ranks["stacked"]
    outs = ranks["out"]
    for k in tvh.VoxelMap._fields:
        for o in outs[1:]:
            np.testing.assert_array_equal(o["ins_" + k], outs[0]["ins_" + k])
    got = {k: outs[0]["ins_" + k][row] for k in tvh.VoxelMap._fields}
    want = {k: ref[k][row] for k in tvh.VoxelMap._fields}
    for k in MAP_INT:
        np.testing.assert_array_equal(got[k][:-1], want[k][:-1])
    np.testing.assert_array_equal(got["n"][:-1], want["n"][:-1])
    assert got["occupied"][:-1].sum() > 300
    for k in ("psum", "pssum"):
        np.testing.assert_allclose(got[k][:-1], want[k][:-1], rtol=1e-5,
                                   atol=1e-5)
    ok = got["plane_valid"][:-1]
    assert ok.sum() > 100
    np.testing.assert_allclose(got["mean"][:-1][ok], want["mean"][:-1][ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["normal"][:-1][ok],
                               ranks["refit"][row][:-1][ok], atol=1e-4)


@pytest.mark.parametrize("rank", range(RANKS))
def test_sharded_linearize_matches_jax(ranks, rank):
    out, ref = ranks["out"][rank], ranks["jax"]
    assert tuple(out["coord"]) == divmod(rank, 2)
    for i in range(len(wk.GEO_CFGS)):
        assert 2000 < int(out[f"icp{i}_num_inlier"]) < 4096
        for name in jgeo.ICPResult._fields:
            o, r = out[f"icp{i}_{name}"], ref[f"icp{i}_{name}"]
            if name in ("H", "b"):
                np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-2)
            elif name in ("mean_abs_res", "eigvals_rot", "eigvals_trans"):
                np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-6)
            elif name in ("eigvecs_rot", "eigvecs_trans"):
                np.testing.assert_allclose(np.abs(o), np.abs(r), atol=1e-3)
            else:                      # counts and flags: exact
                np.testing.assert_array_equal(o, r, err_msg=name)


@pytest.mark.parametrize("rank", range(RANKS))
def test_sharded_radar_matches_jax(ranks, rank):
    out, ref = ranks["out"][rank], ranks["jax"]
    assert int(out["radar_num_inlier"]) == int(ref["radar_num_inlier"]) > 50
    for k in ("H", "b"):
        np.testing.assert_allclose(out["radar_" + k], ref["radar_" + k],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["radar_mean_abs_res"],
                               ref["radar_mean_abs_res"], rtol=1e-4)


def _assert_replay_near_single(run, single, data):
    assert json.loads(str(run["counters"])) == json.loads(single["counters"])
    c = json.loads(single["counters"])
    assert c["scans_same_key"] >= 1
    assert c.get("scans_ooo_inserted", 0) + c.get("scans_ooo_samekey",
                                                  0) >= 1
    np.testing.assert_array_equal(run["traj_ts"], single["traj_ts"])
    assert run["rescued"].max() == 0 and single["rescued"].max() == 0
    np.testing.assert_allclose(run["traj_p"], single["traj_p"],
                               atol=STRUCTURAL)
    for p in (run["traj_p"], single["traj_p"]):
        ate = tsyn.ate_rmse(run["traj_ts"], p, data["gt"]["ts"],
                            data["gt"]["pos"])
        assert ate < 0.08, ate


def test_mesh_replay_matches_single_device(ranks):
    """The 2 x 2 mesh's replay: every rank the same bits (the collectives
    give every rank the same sums), and near the single-device port."""
    outs = ranks["out"]
    for o in outs[1:]:
        for k in ("traj_ts", "traj_p", "rescued", "counters"):
            np.testing.assert_array_equal(o[k], outs[0][k])
    data, _ = wk.exception_path_stream()
    _assert_replay_near_single(outs[0], ranks["single"], data)


def test_world_size_one_mesh_replay_matches_single_device(ranks):
    data, _ = wk.exception_path_stream()
    _assert_replay_near_single(ranks["ws1"], ranks["single"], data)


def test_world_size_one_mesh_rescues_a_kicked_window(ranks):
    """tests/test_torch_rescue.py's kicked replay on a mesh of one: the
    rescue's sequential candidates (14 x 3 mesh linearizations) fire on
    the kicked scan, and with the 8 states after the kick left out the
    ATE is under 0.10 m (tests/test_rescue.py's gate)."""
    out = ranks["kicked"]
    # row KICK_AT - 1 is the kicked scan (row 0 the first after the
    # initialization, which the mesh's per-iteration match may rescue on
    # the just-born map, as tests/test_parallel.py:384-390 says of JAX's)
    assert out["kick_rescued"][wk.KICK_AT - 1] == 1
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=4.0), tsyn.LidarModel(n_rows=16, n_cols=256), seed=0)
    keep = [i for i in range(len(out["kick_ts"]))
            if not wk.KICK_AT <= i < wk.KICK_AT + 8]
    ate = tsyn.ate_rmse(out["kick_ts"][keep], out["kick_p"][keep],
                        data["gt"]["ts"], data["gt"]["pos"])
    assert ate < 0.10, ate


# ------------------------------------------------------------ step cache


def _short_run(cache, **kw):
    return trep.run(device="cpu", t_total=1.5, verbose=False,
                    step_cache=cache, **kw)


def _steps(cache):
    return {k for k in cache if k[1] == "step"}


def test_step_cache_shares_steps_of_one_configuration():
    """Two replays through ``synthetic_replay.run(step_cache=)``: the
    second makes no step function (it takes the first one's) and gives the
    same trajectory; another configuration adds steps of its own."""
    cache = {}
    a = _short_run(cache)
    n = len(_steps(cache))
    assert n >= 1 and a["n_scans"] >= 3
    fns = {k: cache[k] for k in _steps(cache)}
    b = _short_run(cache)
    assert _steps(cache) == set(fns) and all(cache[k] is v
                                             for k, v in fns.items())
    pa = np.asarray([p for _, p, _ in a["sequencer"].trajectory])
    pb = np.asarray([p for _, p, _ in b["sequencer"].trajectory])
    np.testing.assert_array_equal(pa, pb)
    _short_run(cache, use_4dof=True)
    assert len(_steps(cache)) == 2 * n


def test_step_cache_interleaved_equals_separate():
    """Two Sequencers of one configuration fed scan by scan in turns
    through one cache give the bits of each fed alone."""
    datas = [tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=1.5), tsyn.LidarModel(n_rows=16, n_cols=256), seed=s)
        for s in (0, 1)]
    cache = {}
    shared = [wk.exception_path_sequencer(step_cache=cache)
              for _ in datas]
    alone = [wk.exception_path_sequencer() for _ in datas]
    for s, d in zip(alone, datas):
        trep.replay(s, d)
    imu_i = [0, 0]
    for k in range(max(len(d["scans"]) for d in datas)):
        for j, (s, d) in enumerate(zip(shared, datas)):
            if k < len(d["scans"]):
                imu_i[j] = trep.feed(s, d, k, imu_i[j])
    for s, r in zip(shared, alone):
        assert s.counters == r.counters
        np.testing.assert_array_equal(
            np.asarray([p for _, p, _ in s.trajectory]),
            np.asarray([p for _, p, _ in r.trajectory]))
    assert len(_steps(cache)) >= 1


def test_mesh_sequencer_keeps_its_own_steps():
    """A mesh Sequencer's steps hold its mesh: its keys are its own even
    with a shared cache and an equal configuration. The step makers give
    the single-device steps with the mesh's functions."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tpar.make_mesh(n_mp=1, device_type="cpu")
        cache = {}
        a, b = (wk.exception_path_sequencer(mesh, step_cache=cache)
                for _ in range(2))
        c, d = (wk.exception_path_sequencer(step_cache=cache)
                for _ in range(2))
        assert a._ckey("step", "x") != b._ckey("step", "x")
        assert a._cfg_salt[0] == "instance"
        assert c._ckey("step", "x") == d._ckey("step", "x")
        # the step makers put the mesh's functions into the steps
        scan = tpar.make_sharded_scan_step(mesh, a.cfg, a.win_cfg,
                                           a.map_cfg, a.geo_cfg)
        assert scan.func is tseq._scan_step
        lin = scan.keywords["linearize_fn"]
        assert lin.__qualname__.startswith("sequencer_fns")
        radar = tpar.make_sharded_radar_step(mesh, a.cfg, a.win_cfg,
                                             trad.RadarConfig())
        assert radar.keywords["mode"] == "declare"
        assert radar.keywords["linearize_fn"].func is \
            tpar.sharded_radar_linearize
        odom = tpar.make_sharded_odom_step(mesh, a.cfg, a.win_cfg,
                                           todo.OdometryConfig(), False)
        assert odom.func is tseq._odom_step and not odom.keywords["declare"]
    finally:
        dist.destroy_process_group()
