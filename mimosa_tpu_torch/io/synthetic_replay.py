"""Synthetic end-to-end replay of the port (the scoreboard's sequences).

``python -m mimosa_tpu_torch.io.synthetic_replay [--device cpu]`` generates
the synthetic room sequence, replays it through the port's Sequencer
exactly as ``mimosa_tpu/io/synthetic_replay.py`` drives the JAX one, with
the same default transfer codec (int16 with the subtractive dither), and
prints the ATE. :func:`run` takes the world, trajectory, noise, codec,
registration and photometric settings of the JAX package's ``run`` that the
geometric and photometric scoreboard rows use
(``scripts/dataset_evaluation.py``), and its offline refinements: the
two-pass replay against the frozen final map and the batch smoothing of the
whole trajectory. It runs on the first CUDA device unless ``--device``
names another, and raises where there is no card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mimosa_tpu_torch import require_cuda
from mimosa_tpu_torch.graph import refine
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


RADAR_DELAY = 0.06       # a late radar frame's delay [s]
REINJECT_DELAY = 0.15    # a scan delivered again, this late [s]


def multimodal_events(data, radar=(), odom=(), *, late_radar=(),
                      reinject=(), swap=(), duplicate=()):
    """The measurements of a multi-sensor sequence in arrival order: a list
    of (arrival time, kind, message) with kind "scan" (a scan dict of
    ``io.synthetic.generate``), "radar" (a frame of ``generate_radar``) or
    "odom" (a message of ``generate_odometry``). A measurement arrives at
    its own time (a scan at its end), except:

    * radar frames with an index in ``late_radar``: ``RADAR_DELAY`` late;
    * scans with an index in ``reinject``: delivered on time and again,
      unchanged, ``REINJECT_DELAY`` late (a second receiver's copy);
    * scans with an index in ``swap``: delivered just after the next scan;
    * scans with an index in ``duplicate``: followed by a copy 2 ms later
      (a same-key scan).

    Equal arrival times keep the order scans, radar frames, odometry
    messages."""
    ev = []
    scans = data["scans"]
    t_ends = [seq.Sequencer._scan_t_end(sc) for sc in scans]
    for k, sc in enumerate(scans):
        arrive = t_ends[k + 1] if k in swap else t_ends[k]
        ev.append((arrive, "scan", sc))
        if k in reinject:
            ev.append((t_ends[k] + REINJECT_DELAY, "scan", sc))
        if k in duplicate:
            ev.append((arrive + 2e-3, "scan",
                       dict(sc, ts_header=sc["ts_header"] + 2e-3)))
    for j, fr in enumerate(radar):
        ev.append((fr["ts"] + (RADAR_DELAY if j in late_radar else 0.0),
                   "radar", fr))
    ev.extend((m["ts"], "odom", m) for m in odom)
    # equal arrival times keep the order above
    order = sorted(range(len(ev)), key=lambda i: ev[i][0])
    return [ev[i] for i in order]


def four_modality_stream(tc, lm, n_targets=96):
    """(data, events) of a LiDAR + radar + odometry + IMU sequence with
    late and re-ordered arrivals (:func:`multimodal_events`): the scans
    and IMU of ``generate`` in the room (seed 0, noise-free), 20 Hz radar
    frames of ``n_targets`` targets and 10 Hz odometry (covariance 1e-4 I)
    from the same trajectory, and, with n scans:

    * one radar frame in four 60 ms late, alternating between the radar's
      two phases (frames 1, 6, 9, 14, ...): a frame on an odometry
      message's time collapses onto that message's state, the other is
      inserted mid-window;
    * every sixth scan (5, 11, ...) delivered again 150 ms late (a second
      receiver): it collapses onto its own state;
    * scans n/2 - 3 and n/2 + 3 each swapped with the next one: each is
      inserted mid-window;
    * scan n/2 followed by a copy 2 ms later (a same-key scan);
    * two more odometry messages, noise-free, 2 ms after the ends of scans
      n/2 + 1 and n/2 + 4: they attach to those scans' states (the
      generators put every other radar frame on an odometry message's
      time, and the odometry message comes first, so none attaches by
      itself);
    * no odometry for 0.35 s after scan 3's end (an outage: its anchor
      state leaves the window, and the next message anchors afresh).

    Pass ``tc`` with ``t_stationary`` off the LiDAR's 0.1 s grid (e.g.
    1.23 s) so that the radar and odometry clocks run out of phase with
    the LiDAR's, as unsynchronized sensors do; on the generators' default
    (1.2 s) every late scan lands within two IMU samples of a radar
    frame's state."""
    data = syn.generate(syn.room_world(), tc, lm, seed=0)
    traj = syn.make_trajectory(tc)
    radar = syn.generate_radar(traj, tc, rate=20.0, n_targets=n_targets,
                               seed=0)
    odom = syn.generate_odometry(traj, tc, rate=10.0, seed=0)
    n = len(data["scans"])
    t_end = [seq.Sequencer._scan_t_end(sc) for sc in data["scans"]]
    odom = [m for m in odom if not t_end[3] < m["ts"] < t_end[3] + 0.35]
    for k in (n // 2 + 1, n // 2 + 4):
        t = np.array([t_end[k] + 2e-3])
        odom.append(dict(ts=float(t[0]), q=traj["quat"](t)[0],
                         t=traj["pos"](t)[0], cov=np.eye(6) * 1e-4))
    events = multimodal_events(
        data, radar, odom,
        late_radar={4 * i + 1 + i % 2 for i in range(len(radar))},
        reinject=set(range(5, n, 6)), swap={n // 2 - 3, n // 2 + 3},
        duplicate={n // 2})
    return data, events


ATTACH_DELAY = 2e-3      # [s] under one 200 Hz IMU period


def bulk_stream(tc, lm, n_targets=96):
    """(data, events) of an in-order LiDAR + radar + odometry + IMU
    sequence that takes every path of the bulk scheduler's chunks: the
    scans and IMU of ``generate`` in the room (seed 0, noise-free), 20 Hz
    radar frames of ``n_targets`` targets and 10 Hz odometry (covariance
    1e-4 I) from the same trajectory, each odometry message 15 ms after a
    radar frame and 50 ms from a scan's end (so it declares its own
    state), and, 2 ms after the end of every fourth scan from the fifth on
    (``ATTACH_DELAY``, less than one IMU period), a copy of the radar frame
    nearest in time and a noise-free odometry message: both attach to the
    scan's state. No event arrives late (:func:`multimodal_events` with no
    late arrival). Pass ``tc`` with ``t_stationary`` off the LiDAR's 0.1 s
    grid (e.g. 1.23 s), so that the radar clock runs out of phase with the
    LiDAR's."""
    data = syn.generate(syn.room_world(), tc, lm, seed=0)
    traj = syn.make_trajectory(tc)
    radar = syn.generate_radar(traj, tc, rate=20.0, n_targets=n_targets,
                               seed=0)
    odom = syn.generate_odometry(
        traj, dataclasses.replace(tc, t_stationary=tc.t_stationary + 0.13),
        rate=10.0, seed=0)
    radar_ts = np.array([fr["ts"] for fr in radar])
    scans = data["scans"]
    for k in range(4, len(scans), 4):
        t = seq.Sequencer._scan_t_end(scans[k]) + ATTACH_DELAY
        fr = radar[int(np.argmin(np.abs(radar_ts - t)))]
        radar.append(dict(fr, ts=t))
        tt = np.array([t])
        odom.append(dict(ts=t, q=traj["quat"](tt)[0], t=traj["pos"](tt)[0],
                         cov=np.eye(6) * 1e-4))
    radar.sort(key=lambda fr: fr["ts"])
    odom.sort(key=lambda m: m["ts"])
    return data, multimodal_events(data, radar, odom)


def bulk_messages(events):
    """The messages of :func:`multimodal_events`' events in
    ``Sequencer.add_bulk``'s layout (``kind`` "scan", "radar" or "odom")."""
    out = []
    for _, kind, m in events:
        if kind == "scan":
            out.append(m)
        elif kind == "radar":
            out.append(dict(kind="radar", ts=m["ts"], points_r=m["points"],
                            doppler=m["doppler"], snr_db=m["snr_db"]))
        else:
            out.append(dict(kind="odom", ts=m["ts"], q=m["q"], p=m["t"],
                            cov6=m["cov"]))
    return out


def feed_event(s, data, event, imu_i=0):
    """Feed one event of :func:`multimodal_events` to Sequencer ``s``: the
    IMU samples up to its arrival (+30 ms collection delay) from index
    ``imu_i`` on, then the measurement. Returns the index of the next IMU
    sample."""
    imu = data["imu"]
    arrive, kind, m = event
    j = int(np.searchsorted(imu["ts"], arrive + 0.03, "right"))
    if j > imu_i:
        s.add_imu_batch(imu["ts"][imu_i:j], imu["acc"][imu_i:j],
                        imu["gyro"][imu_i:j])
        imu_i = j
    if kind == "scan":
        s.add_scan(m["ts_header"], m["points"], m["t_rel"], m.get("valid"),
                   intensity=m.get("intensity"))
    elif kind == "radar":
        s.add_radar(m["ts"], m["points"], m["doppler"], m["snr_db"])
    else:
        s.add_odometry(m["ts"], m["q"], m["t"], m["cov"])
    return imu_i


def dropout_scans(data):
    """The scan stream of the JAX scoreboard's dropout_ooo row
    (``scripts/dataset_evaluation.py:190-199``): after the ninth scan each
    scan drops with probability 0.15 (draws from seed 7), scans 15 and 30
    are followed by a copy 2 ms later (same key), and from the tenth scan
    of the stream on every ninth pair of neighbours is swapped."""
    rng = np.random.default_rng(7)
    scans = []
    for k, sc in enumerate(data["scans"]):
        if k > 8 and rng.random() < 0.15:
            continue
        scans.append(sc)
        if k in (15, 30):
            scans.append(dict(sc, ts_header=sc["ts_header"] + 2e-3))
    for k in range(10, len(scans) - 1, 9):
        scans[k], scans[k + 1] = scans[k + 1], scans[k]
    return scans


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
        project_on_degeneracy=False, two_pass=False, smooth=False,
        step_cache=None):
    """Replay a synthetic sequence (default: room_clean) on ``device``
    (default: the first CUDA device; raises where there is none).
    ``use_photometric`` adds the photometric factor (PG-LIO) with the JAX
    package's settings (:func:`photo_config`).

    ``two_pass``: replay the sequence again, in a second Sequencer that
    localizes against the first one's final map (``freeze_map``, the map
    copied in as ``init_map``); the result is pass 2's. ``smooth``: smooth
    the whole trajectory in one batch (``graph/refine.smooth``) over the
    sequence's IMU stream, kept as ``sequencer.smoothed = (ts, q, p)``, with
    its ATE as ``ate_smooth``. ``wall`` and ``n_scans`` are pass 1's.

    ``step_cache``: one dict passed to repeated calls (a scoreboard, a test
    module) shares the step functions and the captured graphs among their
    Sequencers of one configuration (``Sequencer(step_cache=)``)."""
    device = require_cuda() if device is None else torch.device(device)
    world = world if world is not None else syn.room_world()
    tc = tc if tc is not None else syn.TrajectoryConfig(t_total=t_total)
    lm = syn.LidarModel()
    data = syn.generate(world, tc, lm, seed=seed, imu_noise=imu_noise,
                        range_noise=range_noise)

    def make_sequencer(freeze=False, init_map=None):
        return seq.Sequencer(
            seq_cfg=seq.SequencerConfig(
                max_scan_points=max(4096, lm.n_rows * lm.n_cols),
                n_geo_points=4096, n_map_points=8192,
                geo_leaf=0.4, map_insert_leaf=0.15,
                keyframe_trans_thresh=0.3, keyframe_rot_thresh=0.15,
                range_transfer=range_transfer, freeze_map=freeze),
            win_cfg=win.WindowConfig(K=6),
            map_cfg=vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17,
                                      plane_min_points=5, lru_horizon=0),
            geo_cfg=geo.GeometricConfig(
                sigma=0.05, loc_count_thresh=50.0, use_4dof=use_4dof,
                project_degenerate=project_degenerate),
            photo_cfg=photo_config(lm, project_on_degeneracy)
            if use_photometric else None,
            device=device, init_map=init_map, step_cache=step_cache,
            # the range codec's beam table: exact for this generator, whose
            # noise is radial
            ray_dirs=syn.beam_dirs(lm)[0] if range_transfer else None)

    s = make_sequencer()
    t0 = time.perf_counter()
    n_scans = replay(s, data)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    if two_pass:
        # mapping -> localization: every scan, the earliest too, registers
        # against the complete final map
        s = make_sequencer(freeze=True, init_map=s.vmap)
        replay(s, data)
    ate = trajectory_ate(s, data)
    ate_smooth = None
    if smooth:
        imu = data["imu"]
        s.smoothed = refine.smooth(s, imu["ts"], imu["acc"], imu["gyro"])
        sm_ts, _, sm_p = s.smoothed
        ate_smooth = syn.ate_rmse(sm_ts, sm_p, data["gt"]["ts"],
                                  data["gt"]["pos"])
    if verbose:
        print(f"replayed {n_scans} scans in {wall:.1f}s "
              f"({n_scans / max(wall, 1e-9):.1f} scans/s incl. first-call "
              f"set-up) on {s.device}")
        print(f"counters: {s.counters}")
        print(f"ATE RMSE: {ate:.4f} m (gate: < 0.010 m)"
              + (f"  smoothed: {ate_smooth:.4f} m" if smooth else ""))
    return dict(ate=ate, wall=wall, n_scans=n_scans, counters=s.counters,
                sequencer=s, data=data, ate_smooth=ate_smooth)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    ap.add_argument("--t-total", type=float, default=12.0)
    args = ap.parse_args()
    out = run(device=args.device, t_total=args.t_total)
    raise SystemExit(0 if out["ate"] < 0.010 else 1)
