"""Offline deterministic replay of a real dataset (ROS1 bag) through the
full estimator — the mimosa_rosbag equivalent.

Usage:
    python -m mimosa_tpu_torch.io.replay --bag seq.bag --config params.yaml \
        --imu-topic /os_cloud_node/imu --lidar-topic /os_cloud_node/points \
        [--radar-topic ...] [--odom-topic ...] [--gt gt.tum] \
        [--out traj.tum] [--config-override override.yaml] [--device cpu] \
        [--bulk] [--two-pass] [--smooth]

The port of ``mimosa_tpu/io/replay.py``. Replays messages in receipt-time
order with the scan-collection delay (scans processed only once IMU has
advanced past their end — reference src/mimosa_rosbag.cpp:111-115,
200-224), writes the TUM trajectory, and if ground truth is given prints
ATE/RTE (the dataset_evaluation.py metrics). It runs on the first CUDA
device, the Sequencer's steps captured as CUDA graphs, unless ``--device``
names another (``--device cpu``), and raises where there is no card.

``--bulk`` replays offline through the Sequencer's bulk scheduler
(``Sequencer.add_bulk``): the decoded scans, radar frames and odometry
messages gather in a batch that runs in chunks of 32 events once the IMU
has passed the newest of them.

``--two-pass`` replays the bag again against the first pass's final map,
frozen (mapping, then localization); ``--smooth`` smooths the whole final
trajectory in one batch (``graph/refine.py``) and writes that one to
``--out``, with its ATE line after the streamed one's.

Not ported yet, each refused with ``NotImplementedError``:
``--debug-stream`` and ``--stream-every`` (ROADMAP item 15).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import heapq
import os
import tempfile
import time

import numpy as np
import torch

from mimosa_tpu_torch import require_cuda

class StepControl:
    """Keyboard pause/step for interactive replay debugging (the raw-tty
    control of the reference harness, src/mimosa_rosbag.cpp:31-47,166-185):
    SPACE toggles pause, ``s`` processes one scan while paused, ``q``
    aborts the replay. ``read_keys`` is injectable for tests; the default
    polls a raw non-blocking stdin when it is a TTY."""

    def __init__(self, read_keys=None):
        self.paused = False
        self._abort = False
        if read_keys is not None:
            self._read = read_keys
        else:
            self._read = self._make_tty_reader()

    @staticmethod
    def _make_tty_reader():
        import sys
        if not sys.stdin.isatty():
            return lambda: ""
        import atexit
        import termios
        import tty
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        os.set_blocking(fd, False)
        atexit.register(termios.tcsetattr, fd, termios.TCSADRAIN, saved)

        def read():
            try:
                return os.read(fd, 16).decode(errors="ignore")
            except BlockingIOError:
                return ""

        return read

    def gate(self):
        """Call before dispatching each scan. Blocks while paused; returns
        False when the user aborted."""
        while not self._abort:
            for ch in self._read():
                if ch == " ":
                    self.paused = not self.paused
                elif ch == "s" and self.paused:
                    return True          # step: process exactly one scan
                elif ch == "q":
                    self._abort = True
            if not self.paused or self._abort:
                break
            time.sleep(0.02)
        return not self._abort


def _fit_range_codec(ray_dirs, m0, pc2, verbose):
    """The range codec's fidelity gate on the first in-range scan ``m0``:
    the bag's cloud must follow the beam-table reconstruction model
    p = s*dir + off (pixel-id point order included) — a driver with a
    different frame/order convention would otherwise silently corrupt
    every point at decode. Threshold: 5 mm median residual (the driver's
    own f32 reconstruction sits ~1e-4; a convention mismatch is meters).
    A fixed sensor-frame yaw between table and cloud is fitted and
    compensated. Returns the table to use; raises ValueError otherwise."""
    d0 = pc2.decode(m0["data"], m0["fields"], m0["point_step"],
                    header_stamp=m0["stamp"])
    p0 = d0["points"]
    if len(p0) != len(ray_dirs):
        raise ValueError(
            f"range_transfer: scan has {len(p0)} points but the "
            f"beam table covers {len(ray_dirs)} lanes. The range "
            f"codec needs ORGANIZED full-frame clouds in sensor "
            f"pixel-id order (rows*cols points, non-returns kept as "
            f"zero/NaN lanes — the Ouster driver's "
            f"'organized'/'destaggered=false' output); a driver "
            f"configured to drop non-returns emits variable-length "
            f"clouds the per-lane table cannot address. Rerun "
            f"without --range-transfer or reconfigure the driver")
    dirs0 = ray_dirs[:, :3]
    okp = np.isfinite(p0).all(-1) & \
        (np.einsum("ij,ij->i", p0, p0) > 0.25)

    def _median_resid(rd):
        d_, o_ = rd[:, :3], rd[:, 3:6] if rd.shape[1] == 6 else 0.0
        sc_ = np.einsum("ij,ij->i", p0 - o_, d_)
        rs = np.linalg.norm(sc_[:, None] * d_ + o_ - p0, axis=-1)
        return float(np.median(rs[okp])) if okp.any() else np.inf

    med = _median_resid(ray_dirs)
    if med > 5e-3 and okp.any():
        # a custom driver frame that differs from the metadata model
        # by a FIXED sensor-frame yaw (e.g. a different encoder-angle
        # origin) is harmless to the estimator — fit one yaw from the
        # azimuth mismatch and retry before refusing
        ap = np.arctan2(p0[okp, 1], p0[okp, 0])
        ad = np.arctan2(dirs0[okp, 1], dirs0[okp, 0])
        z = np.exp(1j * (ap - ad))
        zm = z.mean()
        if np.abs(zm) > 0.9:          # consistent single-yaw offset
            def _rot_table(phi_):
                cp_, sp_ = np.cos(phi_), np.sin(phi_)
                Rz_ = np.array([[cp_, -sp_, 0.0], [sp_, cp_, 0.0],
                                [0.0, 0.0, 1.0]])
                rd_ = ray_dirs.copy()
                rd_[:, :3] = ray_dirs[:, :3] @ Rz_.T
                if ray_dirs.shape[1] == 6:
                    rd_[:, 3:6] = ray_dirs[:, 3:6] @ Rz_.T
                return rd_

            # the circular mean is biased (mrad-scale) by the beam-
            # origin offset on near points — refine with a fine grid
            # minimizing the actual reconstruction residual
            phi0 = float(np.angle(zm))
            grid = phi0 + np.radians(np.linspace(-0.5, 0.5, 201))
            meds = [_median_resid(_rot_table(g)) for g in grid]
            phi = float(grid[int(np.argmin(meds))])
            rd2 = _rot_table(phi)
            med2 = float(np.min(meds))
            if med2 <= 5e-3:
                if verbose:
                    print(f"range codec: compensated a fixed "
                          f"{np.degrees(phi):+.2f} deg sensor-frame "
                          f"yaw between beam table and cloud "
                          f"(residual {med * 1e3:.1f} -> "
                          f"{med2 * 1e3:.3f} mm)")
                ray_dirs = rd2
                med = med2
    if med > 5e-3:
        raise ValueError(
            f"range_transfer: beam-table reconstruction residual "
            f"{med * 1e3:.1f} mm on the first scan — the bag's cloud "
            f"does not follow the Ouster metadata model; rerun "
            f"without --range-transfer")
    if verbose:
        print(f"range codec fidelity: median residual "
              f"{med * 1e3:.3f} mm over {int(okp.sum())} points")
    return ray_dirs


def replay_bag(bag_path, config_path, imu_topic, lidar_topic,
               radar_topic=None, odom_topic=None, override_path=None,
               start_offset=0.0, duration=None, max_scan_points=None,
               verbose=True, device=None, step_control=None,
               ouster_metadata=None, two_pass=False, smooth=False,
               debug_stream=None, bulk=False, bulk_chunk=32,
               range_transfer=False, **seq_overrides):
    """Replay a bag (or a glob of bags) through a port Sequencer on
    ``device`` (default: the first CUDA device; raises where there is
    none) and return the Sequencer.

    ``range_transfer=True``: the sensor-native range-image transfer codec
    (int16 (range, t[, intensity]) lanes + device-side xyz reconstruction
    from the Ouster beam table). Requires Ouster metadata
    (``ouster_metadata`` or the config's sensor_metadata_path) for the
    beam table (config.loader.ouster_ray_dirs). The first decoded scan is
    checked against the table and the replay REFUSES if the bag's cloud
    does not follow the reconstruction model.

    ``bulk=True``: offline replay through ``Sequencer.add_bulk`` in
    ``bulk_chunk``-event chunks (the scheduler's eligibility rules decide
    what streams); it gives the bits of the streaming replay with
    ``merge_marginalize=True``, and takes no ``step_control``.

    ``two_pass=True``: mapping, then localization. Pass 1 replays the bag
    and builds the map; pass 2 replays the same messages in a second
    Sequencer against pass 1's final map, frozen (``freeze_map``, the map
    copied in as ``init_map``), so that every scan, the earliest too,
    registers against the whole map. Returns pass 2's Sequencer.

    ``smooth=True``: the final trajectory smoothed in one batch
    (``graph/refine.smooth``) over the bag's whole IMU stream, kept on the
    returned Sequencer as ``.smoothed = (ts, q, p)``.

    ``debug_stream``: an ``io.viz.DebugStream``, which gets one JSON line
    per scan on its cadence (after each streamed event, forced after each
    bulk flush and at the end of each pass)."""
    if debug_stream is not None and not callable(
            getattr(debug_stream, "emit", None)):
        raise TypeError(f"debug_stream must be an io.viz.DebugStream, not "
                        f"{type(debug_stream).__name__}")
    if bulk and step_control is not None:
        raise ValueError("bulk replay is non-interactive")
    device = require_cuda() if device is None else torch.device(device)

    from mimosa_tpu_torch import native
    from mimosa_tpu_torch.config import loader
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.io import pointcloud2 as pc2
    from mimosa_tpu_torch.io.rosbag import Bag

    if max_scan_points:
        seq_overrides["max_scan_points"] = max_scan_points
    cs = loader.load_reference_yaml(config_path, override_path,
                                    **seq_overrides)
    meta_path = ouster_metadata or cs.raw.get("lidar", {}).get(
        "sensor_metadata_path")
    meta = loader.load_ouster_metadata(meta_path) if meta_path else None
    # the full PG-LIO pipeline when the config enables photometric (the
    # reference's ENWIDE/Newer College default); the Ouster metadata JSON
    # supplies the beam table (reference loads it into lidar/sensor)
    photo_cfg = None
    if bool(cs.raw.get("lidar", {}).get("photometric", {})
            .get("enabled", False)):
        photo_cfg = loader.photometric_from_reference(cs.raw, meta)
    ray_dirs = None
    if range_transfer:
        if meta is None:
            raise ValueError("range_transfer needs Ouster metadata "
                             "(--ouster-metadata or the config's "
                             "sensor_metadata_path) for the beam table")
        ray_dirs = loader.ouster_ray_dirs(meta)
        cs = dataclasses.replace(cs, sequencer=dataclasses.replace(
            cs.sequencer, range_transfer=True))

    topics = {imu_topic, lidar_topic}
    if radar_topic:
        topics.add(radar_topic)
    if odom_topic:
        topics.add(odom_topic)

    raw_cfg = cs.raw
    lidar_mgr = raw_cfg.get("lidar", {}).get("manager", {})
    filters = dict(
        range_min=float(lidar_mgr.get("range_min", 0.2)),
        range_max=float(lidar_mgr.get("range_max", 100.0)),
        intensity_min=float(lidar_mgr.get("intensity_min", 0.0)),
        intensity_max=float(lidar_mgr.get("intensity_max", 1e10)),
        # point_skip_divisor is applied ON DEVICE to the geometric pipeline
        # only (SequencerConfig.geo_skip, set by the loader) — the
        # reference's photometric module sees the full cloud
        # (manager.cpp:244-335 thins geometric_point_idxs_ only)
        point_skip=1,
        ring_skip=int(raw_cfg.get("lidar", {}).get("geometric", {})
                      .get("ring_skip_divisor", 1)),
    )
    # ring-major organization before point skipping (ref lidar/manager.cpp:
    # 205-242): for clouds NOT delivered row-major, applying the skip
    # divisor in arrival order would drop whole rings — reorganize by ring
    # (native counting sort) and skip in ring-major order instead
    organize = bool(lidar_mgr.get("organize_pointcloud_by_ring", False))
    skip_div = int(raw_cfg.get("lidar", {}).get("geometric", {})
                   .get("point_skip_divisor", 1))
    if organize and cs.sequencer.geo_skip > 1:
        # ring-organized clouds are thinned HOST-side in ring-major order
        # (arrival-order modulo would drop whole rings, ref manager.cpp:
        # 205-242) — disable the device-side modulo to avoid double skip
        cs = dataclasses.replace(cs, sequencer=dataclasses.replace(
            cs.sequencer, geo_skip=1))
    use_refl = bool(lidar_mgr.get("use_reflectivity_as_intensity", False))
    sq_range = bool(lidar_mgr.get("scale_intensity_by_sq_range", False))

    # per-sensor timestamp offsets + initial message skips (the reference's
    # SensorManagerBase config base: ts_offset, initial_skip —
    # sensor_manager_base.hpp:15-27; imu ts_offset at imu/manager config)
    def _sensor_base(ns):
        mgr = raw_cfg.get(ns, {}).get("manager", {})
        return float(mgr.get("ts_offset", 0.0)), int(
            mgr.get("initial_skip", 0))
    ts_off = {}
    skip_left0 = {}
    for ns, key in (("imu", "imu"), ("lidar", "lidar"), ("radar", "radar"),
                    ("odometry", "odom")):
        ts_off[key], skip_left0[key] = _sensor_base(ns)

    bag_files = sorted(glob.glob(bag_path)) if any(
        c in bag_path for c in "*?[") else [bag_path]
    msgs = []
    for bf in bag_files:
        msgs.extend(Bag(bf).messages(topics))
    msgs.sort(key=lambda m: m[2])
    if not msgs:
        raise ValueError(f"no messages on {topics} in {bag_path}")
    t0 = msgs[0][2] + start_offset
    t_stop = t0 + duration if duration else float("inf")

    if range_transfer:
        first = next((m for m in msgs
                      if m[0] == lidar_topic and m[2] >= t0), None)
        if first is None:
            raise ValueError(f"no scans on {lidar_topic} in range")
        ray_dirs = _fit_range_codec(ray_dirs, first[3], pc2, verbose)

    def make_sequencer(freeze=False, init_map=None):
        cfg = dataclasses.replace(cs.sequencer, freeze_map=True) if freeze \
            else cs.sequencer
        s_ = seq.Sequencer(seq_cfg=cfg, win_cfg=cs.window,
                           map_cfg=cs.voxel_map, geo_cfg=cs.geometric,
                           photo_cfg=photo_cfg, device=device,
                           ray_dirs=ray_dirs, init_map=init_map)
        s_.radar_cfg = cs.radar
        s_.odom_cfg = cs.odometry
        return s_

    def run_events(s, label=""):
        """Replay the messages in range through Sequencer ``s``."""
        skip_left = dict(skip_left0)
        # measurement release queue: every exteroceptive message is held
        # until the IMU stream has passed its dispatch ts (scans: corrected
        # end ts — the reference's lidar_collection_delay semantics,
        # mimosa_rosbag.cpp:111-115; radar/odometry: frame ts — the
        # reference instead consumes them at arrival and EXTRAPOLATES IMU,
        # imu/manager.cpp:238-357; holding is the drop-free deterministic
        # equivalent). Heap entries: (release_ts, kind 0=scan/1=radar/
        # 2=odom, arrival seq, payload).
        pending = []
        pend_seq = 0
        batch = []        # bulk: decoded events (message, dispatch time)
        n_proc = 0

        def flush_bulk(force=False):
            """Run the batch through add_bulk once it holds ``bulk_chunk``
            events and the IMU has passed the newest one's dispatch time
            (the collection delay, applied chunk-wise), or at the end."""
            nonlocal n_proc
            if not batch or (not force and (
                    len(batch) < bulk_chunk or s.imu.t_last is None
                    or s.imu.t_last < max(t for _, t in batch))):
                return
            s.add_bulk([b for b, _ in batch], chunk=bulk_chunk)
            n_proc += sum(1 for b, _ in batch
                          if b.get("kind", "scan") == "scan")
            batch.clear()
            if debug_stream is not None:
                debug_stream.emit(s, force=True)

        t_start = time.time()
        for topic, _, t, m in msgs:
            if t < t0 or t > t_stop:
                continue
            if topic == imu_topic:
                if skip_left["imu"] > 0:
                    skip_left["imu"] -= 1
                    continue
                s.add_imu(m["stamp"] + ts_off["imu"], m["acc"], m["gyro"])
                if bulk:
                    flush_bulk()
                while pending and s.imu.t_last is not None and \
                        pending[0][0] <= s.imu.t_last:
                    _, kind_, _, payload = heapq.heappop(pending)
                    if kind_ == 0:
                        s.add_scan(payload["ts_header"], staged=payload)
                        n_proc += 1
                    elif kind_ == 1:
                        s.add_radar(*payload)
                    else:
                        s.add_odometry(*payload)
                    if debug_stream is not None:
                        debug_stream.emit(s)
            elif topic == lidar_topic:
                if skip_left["lidar"] > 0:
                    skip_left["lidar"] -= 1
                    continue
                if step_control is not None and not step_control.gate():
                    break                     # user abort ('q')
                stamp = m["stamp"] + ts_off["lidar"]
                d = pc2.decode(m["data"], m["fields"], m["point_step"],
                               header_stamp=stamp,
                               use_reflectivity=use_refl)
                if sq_range:
                    # ref scale_intensity_by_sq_range: undo 1/r^2 falloff
                    d["intensity"] = d["intensity"] * np.einsum(
                        "ni,ni->n", d["points"], d["points"])
                if organize:
                    ok = pc2.point_filters(d["points"], d["intensity"],
                                           d["ring"],
                                           **{**filters, "point_skip": 1})
                    if skip_div > 1 and len(d["ring"]):
                        n_rings = max(int(d["ring"].max()) + 1, 1)
                        order = native.ring_sort(d["ring"], n_rings)
                        keep = np.zeros(len(order), bool)
                        keep[order[::skip_div]] = True
                        ok &= keep
                else:
                    ok = pc2.point_filters(d["points"], d["intensity"],
                                           d["ring"], **filters)
                if bulk:
                    tv = d["t_rel"][ok]
                    batch.append((dict(ts_header=stamp, points=d["points"],
                                       t_rel=d["t_rel"], valid=ok,
                                       intensity=d["intensity"]),
                                  float(stamp + (tv.max() if tv.size
                                                 else 0.0))))
                    continue
                # stage at arrival: the pack + host-to-device copy overlap
                # the device work of earlier scans while this one waits for
                # IMU coverage
                st = s.stage_scan(stamp, d["points"], d["t_rel"], ok,
                                  intensity=d["intensity"])
                heapq.heappush(pending, (st["t_end"], 0, pend_seq, st))
                pend_seq += 1
            elif radar_topic and topic == radar_topic:
                if skip_left["radar"] > 0:
                    skip_left["radar"] -= 1
                    continue
                d = pc2.decode_radar(m["data"], m["fields"],
                                     m["point_step"])
                ts_r = m["stamp"] + ts_off["radar"]
                if not bool(raw_cfg.get("radar", {}).get("manager", {})
                            .get("is_exposure_compensated", True)):
                    ts_r += float(raw_cfg["radar"]["manager"]
                                  .get("frame_ms", 0.0)) * 1e-3 / 2.0
                if bulk:
                    batch.append((dict(kind="radar", ts=ts_r,
                                       points_r=d["points"],
                                       doppler=d["doppler"],
                                       snr_db=d["snr_db"]), ts_r))
                    continue
                heapq.heappush(pending, (ts_r, 1, pend_seq, (
                    ts_r, d["points"], d["doppler"], d["snr_db"])))
                pend_seq += 1
            elif odom_topic and topic == odom_topic:
                if skip_left["odom"] > 0:
                    skip_left["odom"] -= 1
                    continue
                ts_o = m["stamp"] + ts_off["odom"]
                if bulk:
                    batch.append((dict(kind="odom", ts=ts_o, q=m["q"],
                                       p=m["p"], cov6=m["pose_cov"]), ts_o))
                    continue
                heapq.heappush(pending, (ts_o, 2, pend_seq, (
                    ts_o, m["q"], m["p"], m["pose_cov"])))
                pend_seq += 1
        if bulk:
            flush_bulk(force=True)
        if debug_stream is not None:
            debug_stream.emit(s, force=True)
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        wall = time.time() - t_start
        if verbose:
            print(f"{label}replayed {n_proc} scans in {wall:.1f}s "
                  f"({n_proc / max(wall, 1e-9):.2f} scans/s) on {s.device} "
                  f"counters={s.counters}")

    s = make_sequencer()
    run_events(s)
    if two_pass:
        s2 = make_sequencer(freeze=True, init_map=s.vmap)
        run_events(s2, label="pass 2 (frozen map): ")
        s = s2
    if smooth and len(s._traj_ts) >= 3:
        from mimosa_tpu_torch.graph import refine
        imu_rows = [(m["stamp"] + ts_off["imu"], m["acc"], m["gyro"])
                    for topic, _, t, m in msgs
                    if topic == imu_topic and t0 <= t <= t_stop]
        s.smoothed = refine.smooth(
            s, np.asarray([r[0] for r in imu_rows]),
            np.asarray([r[1] for r in imu_rows]),
            np.asarray([r[2] for r in imu_rows]))
        if verbose:
            print(f"batch smoothing: re-solved {len(s.smoothed[0])} states")
    return s


def write_smoothed_tum(path, smoothed):
    """A smoothed trajectory (ts, q_wxyz, p) as a TUM file, in
    ``Sequencer.write_tum``'s layout: ts x y z qx qy qz qw."""
    ts, q, p = smoothed
    with open(path, "w") as f:
        for i in range(len(ts)):
            f.write(f"{ts[i]:.9f} {p[i][0]} {p[i][1]} {p[i][2]} "
                    f"{q[i][1]} {q[i][2]} {q[i][3]} {q[i][0]}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Replay a ROS1 bag through the port's estimator and "
                    "write its TUM trajectory.")
    ap.add_argument("--bag", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--imu-topic", required=True)
    ap.add_argument("--lidar-topic", required=True)
    ap.add_argument("--radar-topic")
    ap.add_argument("--odom-topic")
    ap.add_argument("--config-override")
    ap.add_argument("--ouster-metadata",
                    help="Ouster sensor metadata JSON (beam table) for the "
                         "photometric pipeline")
    ap.add_argument("--gt", help="ground truth TUM file for ATE/RTE")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mimosa_tpu_torch_traj.tum"))
    ap.add_argument("-s", "--start-offset", type=float, default=0.0)
    ap.add_argument("--duration", type=float)
    ap.add_argument("--max-scan-points", type=int,
                    help="points a scan the Sequencer takes (replay_bag's "
                         "max_scan_points; default SequencerConfig's 32768, "
                         "so a 64 x 1024 Ouster scan needs 65536)")
    ap.add_argument("--device",
                    help="torch device (default: the first CUDA device)")
    ap.add_argument("--profile",
                    help="write a torch.profiler chrome trace of the replay "
                         "to this directory")
    ap.add_argument("--interactive", action="store_true",
                    help="SPACE pause, 's' step one scan, 'q' abort")
    ap.add_argument("--range-transfer", action="store_true",
                    help="sensor-native range-image transfer codec (half "
                         "the host-to-device bytes; needs Ouster metadata "
                         "for the beam table; refuses if the bag's cloud "
                         "does not follow the reconstruction model)")
    ap.add_argument("--bulk", action="store_true",
                    help="offline batch mode: the scans, radar frames and "
                         "odometry messages run in chunks of 32 events "
                         "through Sequencer.add_bulk")
    ap.add_argument("--two-pass", action="store_true",
                    help="mapping -> localization refinement: replay again "
                         "against the first pass's final map, frozen")
    ap.add_argument("--smooth", action="store_true",
                    help="batch smoothing of the whole final trajectory "
                         "(graph/refine.py), written to --out")
    ap.add_argument("--debug-stream", metavar="JSONL",
                    help="write a per-scan JSONL debug stream for the live "
                         "dashboard (scripts/live_dashboard.py --follow)")
    ap.add_argument("--stream-every", type=int, default=10,
                    help="debug-stream cadence in scans (default 10)")
    args = ap.parse_args(argv)

    import contextlib
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA]
                          if torch.cuda.is_available() else []))
    stream = None
    if args.debug_stream:
        from mimosa_tpu_torch.io.viz import DebugStream
        stream = DebugStream(args.debug_stream, every=args.stream_every)
    try:
        with prof:
            s = replay_bag(args.bag, args.config, args.imu_topic,
                           args.lidar_topic, args.radar_topic,
                           args.odom_topic, args.config_override,
                           args.start_offset, args.duration,
                           args.max_scan_points, device=args.device,
                           step_control=StepControl() if args.interactive
                           else None,
                           ouster_metadata=args.ouster_metadata,
                           two_pass=args.two_pass, smooth=args.smooth,
                           debug_stream=stream, bulk=args.bulk,
                           range_transfer=args.range_transfer)
    finally:
        if stream is not None:
            stream.close()
    if stream is not None:
        print(f"debug stream -> {args.debug_stream} "
              f"({stream.n_emitted} lines)")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile -> {trace}")
    smoothed = getattr(s, "smoothed", None)
    if smoothed is not None:
        sm_ts, _, sm_p = smoothed
        write_smoothed_tum(args.out, smoothed)
        print(f"smoothed trajectory -> {args.out} ({len(sm_ts)} poses)")
    else:
        s.write_tum(args.out)
        print(f"trajectory -> {args.out} ({len(s.trajectory)} poses)")
    if args.gt:
        from mimosa_tpu_torch.utils import evaluation as ev
        gt_ts, gt_p, _ = ev.load_tum(args.gt)
        est_ts = np.asarray([t for t, _, _ in s.trajectory])
        est_p = np.asarray([p for _, p, _ in s.trajectory])
        print(f"ATE: {ev.ate(est_ts, est_p, gt_ts, gt_p):.4f} m  "
              f"RTE: {ev.rte(est_ts, est_p, gt_ts, gt_p):.2f} %")
        if smoothed is not None:
            print(f"smoothed ATE: "
                  f"{ev.ate(sm_ts, sm_p, gt_ts, gt_p):.4f} m  "
                  f"RTE: {ev.rte(sm_ts, sm_p, gt_ts, gt_p):.2f} %")


if __name__ == "__main__":
    main()
