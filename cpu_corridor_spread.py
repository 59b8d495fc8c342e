#!/usr/bin/env python3
"""The corridor scoreboard rows on the CPU through both packages.

    JAX_PLATFORMS=cpu python3 cpu_corridor_spread.py jax
    python3 cpu_corridor_spread.py torch [THREADS ...]

A measurement tool, not a test and not part of the port: it imports the
JAX package (``jax``) or the port (``torch``), as its argument says, and
prints one JSON line with the ATE [m] and RTE [%] of each row, computed as
the scoreboard does (``scripts/dataset_evaluation.py``: ATE after SE(3)
alignment, RTE over every 10 m of path, against the sequence's ground
truth, seed 0):

* corridor_geo_proj and corridor_pglio through each package's
  ``synthetic_replay.run`` with the scoreboard's settings
  (``scripts/dataset_evaluation.py:219-224,275-292``);
* the corridor with 20 Hz radar streamed event by event
  (``chip_smoke.py``'s ``corridor_radar``: corridor_radar_bulk's sequence
  and Sequencer through ``add_scan`` and ``add_radar``).

It answers whether a gap between the port on the card and the JAX package
on the TPU on these rows is the port's or the platform's: each run here is
the same arithmetic on the CPU. With thread counts after ``torch`` the
port runs once for each intra-op thread count (``torch.set_num_threads``):
a count splits the CPU's reductions its own way, which moves the last bits
of the sums and nothing else. Each row takes 0.5-2 min.
"""

import json
import sys
import time

import numpy as np


def corridor_kw(syn):
    return dict(world=syn.corridor_world(),
                tc=syn.TrajectoryConfig(t_total=8.0, amp=(4.0, 0.6, 0.3),
                                        center=(40.0, 2.0, 1.5),
                                        yaw_rate=0.15),
                seed=0, imu_noise=0.01, range_noise=0.005, verbose=False)


ROWS = (("corridor_geo_proj", dict(project_degenerate=True)),
        ("corridor_pglio", dict(use_photometric=True,
                                project_on_degeneracy=True,
                                project_degenerate=True)))
SEQ_KW = dict(max_scan_points=4096, n_geo_points=4096, n_map_points=8192,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=3)
MAP_KW = dict(leaf_size=0.4, capacity_log2=17, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0, project_degenerate=True)


def main(package, threads=None):
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from mimosa_tpu.graph import sequencer as seq
        from mimosa_tpu.graph import window as win
        from mimosa_tpu.io import synthetic as syn
        from mimosa_tpu.io import synthetic_replay as sr
        from mimosa_tpu.lidar import geometric as geo
        from mimosa_tpu.mapping import voxel_hash as vh
        from mimosa_tpu.utils import evaluation as ev
        run_kw, make_kw = {}, dict(dtype=jnp.float32)
    else:
        from mimosa_tpu_torch.graph import sequencer as seq
        from mimosa_tpu_torch.graph import window as win
        from mimosa_tpu_torch.io import synthetic as syn
        from mimosa_tpu_torch.io import synthetic_replay as sr
        from mimosa_tpu_torch.lidar import geometric as geo
        from mimosa_tpu_torch.mapping import voxel_hash as vh
        from mimosa_tpu_torch.utils import evaluation as ev
        run_kw, make_kw = dict(device="cpu"), dict(device="cpu")
        import torch
        if threads is not None:
            torch.set_num_threads(threads)
        threads = torch.get_num_threads()
    # the port's event builder and feeder are numpy and host calls: they
    # drive either package's Sequencer
    from mimosa_tpu_torch.io.synthetic_replay import (feed_event,
                                                      multimodal_events)

    def score(s, data):
        tr = s.trajectory
        ts = np.asarray([t for t, _, _ in tr])
        p = np.asarray([p for _, p, _ in tr])
        gt = data["gt"]
        return dict(ate=ev.ate(ts, p, gt["ts"], gt["pos"]),
                    rte=ev.rte(ts, p, gt["ts"], gt["pos"]))

    out = {"package": package, "threads": threads}
    for name, kw in ROWS:
        t0 = time.perf_counter()
        o = sr.run(**kw, **corridor_kw(syn), **run_kw)
        out[name] = dict(score(o["sequencer"], o["data"]),
                         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    kw = corridor_kw(syn)
    data = syn.generate(kw["world"], kw["tc"], syn.LidarModel(), seed=0,
                        imu_noise=0.01, range_noise=0.005)
    radar = syn.generate_radar(syn.make_trajectory(kw["tc"]), kw["tc"],
                               seed=0)
    s = seq.Sequencer(seq.SequencerConfig(**SEQ_KW), win.WindowConfig(K=6),
                      vh.VoxelMapConfig(**MAP_KW),
                      geo.GeometricConfig(**GEO_KW), **make_kw)
    imu_i = 0
    for event in multimodal_events(data, radar):
        imu_i = feed_event(s, data, event, imu_i)
    out["corridor_radar_streamed"] = dict(score(s, data),
                                          seconds=time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ("jax", "torch") or (
            sys.argv[1] == "jax" and len(sys.argv) > 2):
        sys.exit(__doc__)
    for n in [int(a) for a in sys.argv[2:]] or [None]:
        main(sys.argv[1], n)
