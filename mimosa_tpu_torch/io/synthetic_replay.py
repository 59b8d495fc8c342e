"""Synthetic end-to-end replay of the port (the scoreboard's sequences).

``python -m mimosa_tpu_torch.io.synthetic_replay [--device cpu]`` generates
the synthetic room sequence, replays it through the port's Sequencer
exactly as ``mimosa_tpu/io/synthetic_replay.py`` drives the JAX one, with
the same default transfer codec (int16 with the subtractive dither), and
prints the ATE. :func:`run` takes the world, trajectory, noise, codec,
registration and photometric settings of the JAX package's ``run`` that the
geometric and photometric scoreboard rows use
(``scripts/dataset_evaluation.py``). It runs on the first CUDA device unless
``--device`` names another, and raises where there is no card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mimosa_tpu_torch import require_cuda
from mimosa_tpu_torch.graph import sequencer as seq
from mimosa_tpu_torch.graph import window as win
from mimosa_tpu_torch.io import synthetic as syn
from mimosa_tpu_torch.lidar import geometric as geo
from mimosa_tpu_torch.lidar import photometric as ph
from mimosa_tpu_torch.mapping import voxel_hash as vh


def feed(s, data, k, imu_i=0):
    """Feed scan k in event order: the IMU samples up to its end (+30 ms
    collection delay) from index ``imu_i`` on, then the scan. Returns the
    index of the next IMU sample."""
    imu = data["imu"]
    scan = data["scans"][k]
    t_end = scan["ts_header"] + scan["t_rel"].max()
    while imu_i < len(imu["ts"]) and imu["ts"][imu_i] <= t_end + 0.03:
        s.add_imu(imu["ts"][imu_i], imu["acc"][imu_i], imu["gyro"][imu_i])
        imu_i += 1
    s.add_scan(scan["ts_header"], scan["points"], scan["t_rel"],
               scan["valid"], intensity=scan.get("intensity"))
    return imu_i


def replay(s, data):
    """Event-ordered replay of the whole sequence. Returns the number of
    scans fed."""
    imu_i = 0
    for k in range(len(data["scans"])):
        imu_i = feed(s, data, k, imu_i)
    return len(data["scans"])


def trajectory_ate(s, data):
    tr = s.trajectory
    return syn.ate_rmse(np.asarray([t for t, _, _ in tr]),
                        np.asarray([p for _, p, _ in tr]),
                        data["gt"]["ts"], data["gt"]["pos"])


def photo_config(lm, project_on_degeneracy=False):
    """The photometric settings of the JAX package's replay for LiDAR
    model ``lm``."""
    return ph.PhotometricConfig(
        rows=lm.n_rows, cols=lm.n_cols, fov_up=lm.fov_up,
        fov_down=lm.fov_down, range_min=0.5, range_max=40.0,
        gradient_threshold=2.0, nma_radius=5, num_features=48, margin=3,
        intensity_scale=1.0, filter_brightness=False, remove_lines=False,
        project_on_degeneracy=project_on_degeneracy)


def run(device=None, t_total=12.0, verbose=True, seed=0, imu_noise=0.0,
        range_noise=0.0, world=None, tc=None, range_transfer=False,
        use_4dof=False, project_degenerate=False, use_photometric=False,
        project_on_degeneracy=False):
    """Replay a synthetic sequence (default: room_clean) on ``device``
    (default: the first CUDA device; raises where there is none).
    ``use_photometric`` adds the photometric factor (PG-LIO) with the JAX
    package's settings (:func:`photo_config`)."""
    device = require_cuda() if device is None else torch.device(device)
    world = world if world is not None else syn.room_world()
    tc = tc if tc is not None else syn.TrajectoryConfig(t_total=t_total)
    lm = syn.LidarModel()
    data = syn.generate(world, tc, lm, seed=seed, imu_noise=imu_noise,
                        range_noise=range_noise)
    s = seq.Sequencer(
        seq_cfg=seq.SequencerConfig(
            max_scan_points=max(4096, lm.n_rows * lm.n_cols),
            n_geo_points=4096, n_map_points=8192,
            geo_leaf=0.4, map_insert_leaf=0.15,
            keyframe_trans_thresh=0.3, keyframe_rot_thresh=0.15,
            range_transfer=range_transfer),
        win_cfg=win.WindowConfig(K=6),
        map_cfg=vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17,
                                  plane_min_points=5, lru_horizon=0),
        geo_cfg=geo.GeometricConfig(
            sigma=0.05, loc_count_thresh=50.0, use_4dof=use_4dof,
            project_degenerate=project_degenerate),
        photo_cfg=photo_config(lm, project_on_degeneracy)
        if use_photometric else None,
        device=device,
        # the range codec's beam table: exact for this generator, whose
        # noise is radial
        ray_dirs=syn.beam_dirs(lm)[0] if range_transfer else None)
    t0 = time.perf_counter()
    n_scans = replay(s, data)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    ate = trajectory_ate(s, data)
    if verbose:
        print(f"replayed {n_scans} scans in {wall:.1f}s "
              f"({n_scans / max(wall, 1e-9):.1f} scans/s incl. first-call "
              f"set-up) on {s.device}")
        print(f"counters: {s.counters}")
        print(f"ATE RMSE: {ate:.4f} m (gate: < 0.010 m)")
    return dict(ate=ate, wall=wall, n_scans=n_scans, counters=s.counters,
                sequencer=s, data=data)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    ap.add_argument("--t-total", type=float, default=12.0)
    args = ap.parse_args()
    out = run(device=args.device, t_total=args.t_total)
    raise SystemExit(0 if out["ate"] < 0.010 else 1)
