"""One rank of the port's mesh-sharded path, for test_torch_sharded.py.

Each process joins a ``torch.distributed`` gloo group of CPU processes and
builds the ``("dp", "mp")`` mesh of ``parallel.sharded.make_mesh`` over it
(n_mp = 2 at world size 4, else 1). Given an .npz of inputs it runs, on
its own rows and sub-table:

* ``sharded_insert`` of the room points into an empty sub-table, the
  tables then gathered into the JAX package's stacked layout;
* ``sharded_linearize`` on the JAX package's stacked map given as input
  (this rank's row of it, ``convert.sharded_map_from_numpy``), for each
  geometric configuration of ``GEO_CFGS``;
* ``sharded_radar_linearize``;

and then a ``Sequencer(mesh=...)`` replay of :func:`exception_path_stream`;
given ``kicked`` instead, :func:`kicked_replay` alone (the rescue on the
mesh). It writes what it got to its own .npz file. It imports neither jax
nor the JAX package.

Run: python torch_sharded_worker.py <tcp://host:port> <world size> <rank>
     <output.npz> [<units inputs.npz> | kicked]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the geometric configurations the linearization runs under (the second:
# the 4-DoF projection, the rotation threshold apart from translation's)
GEO_CFGS = (dict(loc_count_thresh=30.0),
            dict(loc_count_thresh=600.0, loc_count_thresh_rot=0.0,
                 use_4dof=True))
MAP_KW = dict(leaf_size=0.4, capacity_log2=14, plane_min_points=5)
RADAR_KW = dict(t_b_r=(0.1, 0.0, -0.05))
# the exception-path stream, cut from tests/test_parallel.py's 3.6 s
STREAM_T = 2.0
# tests/test_torch_rescue.py's kicked replay: the whole window shifted by
# ~2.5 map leaves before scan KICK_AT of a 4 s room
KICK = (0.85, 0.5, 0.0)
KICK_AT = 10


def exception_path_stream(t_total=STREAM_T):
    """tests/test_parallel.py's ``_exception_path_stream`` on the port's
    generator: the room from a 16x256 LiDAR, every scan, and after the
    middle one a same-key duplicate (+2 ms) and the scan of two periods
    before it sent again late, offset to the middle of its interval (the
    mid-window insertion path). Returns (data, stream)."""
    from mimosa_tpu_torch.io import synthetic as syn

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(
        t_total=t_total), syn.LidarModel(n_rows=16, n_cols=256), seed=0)
    scans = list(data["scans"])
    mid = scans[len(scans) // 2]
    ooo_src = dict(scans[len(scans) // 2 - 2])
    stream = []
    for sc in scans:
        stream.append(sc)
        if sc is mid:
            stream.append(dict(mid, ts_header=mid["ts_header"] + 2e-3))
            stream.append(dict(ooo_src,
                               ts_header=ooo_src["ts_header"] + 0.05))
    return data, stream


def exception_path_sequencer(mesh=None, device="cpu", **kw):
    """tests/test_parallel.py's ``_replay_exception_paths`` Sequencer
    (2048 ICP points, K=4, rescue on at 0.05, f32 codec), on ``mesh`` or
    on one device; ``kw`` as the Sequencer takes them."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    return seq.Sequencer(
        seq.SequencerConfig(
            max_scan_points=4096, n_geo_points=2048, n_map_points=4096,
            geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
            keyframe_rot_thresh=0.15, n_gn_iters=2, quantize_transfer=False,
            rescue_enabled=True, rescue_min_inlier_frac=0.05),
        win.WindowConfig(K=4),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=13,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        device=device, mesh=mesh, **kw)


def replay_stream(s, data, stream):
    """All the IMU, then the stream's scans in order. Returns the run's
    numbers as plain arrays and a JSON of its counters."""
    import numpy as np

    imu = data["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    for sc in stream:
        s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                   sc.get("valid"))
    tr = s.trajectory
    return dict(traj_ts=np.asarray([t for t, _, _ in tr]),
                traj_p=np.asarray([p for _, p, _ in tr]),
                rescued=s.debug_records()[:, 16],
                counters=json.dumps(s.counters, sort_keys=True))


def kicked_replay(mesh):
    """tests/test_torch_rescue.py's kicked replay (its configuration: 1024
    ICP points, K=4, rescue radius 2.5 leaves) on ``mesh``: the rescue's
    candidates then run one after another through the mesh's
    linearization. Returns the rescue flags and the trajectory."""
    import numpy as np
    import torch

    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import feed
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=4.0),
                        syn.LidarModel(n_rows=16, n_cols=256), seed=0)
    s = seq.Sequencer(
        seq.SequencerConfig(
            max_scan_points=4096, n_geo_points=1024, n_map_points=2048,
            geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
            keyframe_rot_thresh=0.15, n_gn_iters=3, quantize_transfer=False,
            rescue_enabled=True, rescue_radius=1.0),
        win.WindowConfig(K=4),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=13,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        device="cpu", mesh=mesh)
    imu_i = 0
    for k in range(len(data["scans"])):
        if k == KICK_AT:
            dp = torch.tensor(KICK, dtype=s.window.p.dtype)
            s.window = s.window._replace(p=s.window.p + dp,
                                         lin_p=s.window.lin_p + dp)
        imu_i = feed(s, data, k, imu_i)
    tr = s.trajectory
    return dict(kick_rescued=s.debug_records()[:, 16],
                kick_ts=np.asarray([t for t, _, _ in tr]),
                kick_p=np.asarray([p for _, p, _ in tr]))


def _units(mesh, inputs):
    """The unit calls on this rank: its inserted table gathered, the ICP
    results on the given map, the radar block."""
    import numpy as np
    import torch

    from mimosa_tpu_torch import convert
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh
    from mimosa_tpu_torch.parallel import sharded
    from mimosa_tpu_torch.radar import factor as rad

    a = np.load(inputs)
    t = {k: torch.from_numpy(a[k]) for k in a.files}
    map_cfg = vh.VoxelMapConfig(**MAP_KW)
    own = sharded.sharded_insert(
        sharded.create_sharded_map(map_cfg, mesh, "cpu"), t["world"],
        torch.ones(len(t["world"]), dtype=torch.bool),
        torch.zeros((), dtype=torch.int32), map_cfg, mesh)
    out = {"ins_" + k: v for k, v in
           convert.gather_sharded_map(own, mesh).items()}
    given = convert.sharded_map_from_numpy(
        {k[4:]: a[k] for k in a.files if k.startswith("map_")},
        mesh.get_local_rank("mp"))
    for i, kw in enumerate(GEO_CFGS):
        res = sharded.sharded_linearize(
            given, t["pts"], t["valid"], t["q"], t["t"], t["g_dir"],
            map_cfg, geo.GeometricConfig(**kw), mesh)
        out.update({f"icp{i}_{k}": v.numpy()
                    for k, v in res._asdict().items()})
    res = sharded.sharded_radar_linearize(
        t["r_q"], t["r_v"], t["r_bg"], t["r_om"], t["r_dirs"], t["r_dop"],
        t["r_valid"], rad.RadarConfig(**RADAR_KW), mesh)
    out.update({"radar_" + k: v.numpy() for k, v in res._asdict().items()})
    return out


def main(addr, world, rank, output, inputs=None):
    """Join the group, run this rank's work (see the module doc), write
    it to ``output``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mimosa_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank)
    try:
        mesh = sharded.make_mesh(n_mp=2 if world == 4 else 1,
                                 device_type="cpu")
        out = dict(coord=np.asarray([mesh.get_local_rank("dp"),
                                     mesh.get_local_rank("mp")]))
        if inputs == "kicked":
            out.update(kicked_replay(mesh))
        else:
            if inputs is not None:
                out.update(_units(mesh, inputs))
            out.update(replay_stream(exception_path_sequencer(mesh),
                                     *exception_path_stream()))
        np.savez(output, **out)
    finally:
        dist.destroy_process_group()
    bad = sorted(k for k in sys.modules if k.split(".")[0] in
                 ("jax", "jaxlib", "mimosa_tpu"))
    if bad:
        raise SystemExit(f"the worker imported {bad}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *sys.argv[5:])
