"""The general traffic generator: one configuration's sensors under one
traffic mix, from one seed, as a stream of measurements in arrival order.

A configuration file says which sensors the rig carries and how they
sample the scene (``sensors``); a traffic file says how the measurements
reach the system (late radar frames, the IMU's lead, how much sensor time
to make ahead). The stream is made in blocks of ``BLOCK_SENSOR_S`` sensor
seconds: block 0 draws exactly as ``synth.generate`` (and the original
generator) would for a sequence of that length, and later blocks continue
the same trajectory and the same random generators, so a seed gives the
same measurements whatever the run's length. Scans are raycast on the
device and copied to host memory, as a sensor driver hands them over.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import synth

KIND_ORDER = {"scan": 0, "radar": 1, "odom": 2}
BLOCK_SENSOR_S = 4.0       # sensor seconds a block
SCAN_BATCH = 8             # scans raycast in one call
# made at set-up: the warm-up's sensor time and POOL_SENSOR_S_PER_S sensor
# seconds a second of the window, until the scans take POOL_CAP_BYTES
POOL_SENSOR_S_PER_S = 6.0
POOL_CAP_BYTES = 2560 * 2**20


def late_radar(j, rule):
    """Is radar frame j late? ``rule`` = {"every": n, "offsets": [...]}:
    frame j is late where j % n == offsets[(j // n) % len(offsets)]."""
    if not rule:
        return False
    n, offs = rule["every"], rule["offsets"]
    return j % n == offs[(j // n) % len(offs)]


class Pool:
    """The measurements of one run, made ahead at set-up and on demand.

    ``events[i]`` is (arrival time, kind, message); ``imu`` holds the IMU
    samples made so far (ts, acc, gyro). :meth:`ensure` makes more blocks
    until event i and the IMU up to its arrival exist."""

    def __init__(self, cfg, mix, seed, device):
        s = cfg["sensors"]
        self.sensors, self.mix = s, mix
        self.tc = synth.TrajectoryConfig(**s["trajectory"])
        self.traj = synth.make_trajectory(self.tc)
        lid = s["lidar"]
        self.lm = synth.LidarModel(**{k: lid[k] for k in (
            "n_rows", "n_cols", "fov_up", "fov_down", "period",
            "max_range")})
        self.maker = synth.ScanMaker(synth.room_world(**s["world"]), self.tc,
                                     self.lm, torch.device(device))
        self.seed = int(seed) % 2**63
        self.rng = np.random.default_rng(self.seed)
        self.rng_radar = np.random.default_rng(self.seed + 100)
        self.rng_odom = np.random.default_rng(self.seed + 200)
        self.until = 0.0                 # sensor time made so far
        self.n_imu = self.n_scans = self.n_radar = self.n_odom = 0
        self.imu_parts = []
        self.imu = dict(ts=np.zeros(0), acc=np.zeros((0, 3)),
                        gyro=np.zeros((0, 3)))
        self.events = []
        self.bytes = 0                   # host bytes of the scans made
        self.gen_s = 0.0                 # seconds spent making blocks
        self.blocks = 0

    # ------------------------------------------------------------- blocks
    def _scans(self, k1):
        lid, lm = self.sensors["lidar"], self.lm
        N = lm.n_rows * lm.n_cols
        out = []
        for k0 in range(self.n_scans, k1, SCAN_BATCH):
            ks = list(range(k0, min(k1, k0 + SCAN_BATCH)))
            noise = (self.rng.normal(size=(len(ks), N)) * lid["range_noise"]
                     if lid["range_noise"] else None)
            pts, valid, inten, _, _ = self.maker.make(ks, noise)
            pts, valid = pts.cpu().numpy(), valid.cpu().numpy()
            inten = inten.cpu().numpy() if lid["intensity"] else None
            for j, k in enumerate(ks):
                sc = dict(ts_header=self.maker.ts0(k), points=pts[j],
                          t_rel=self.maker.t_rel, valid=valid[j])
                if inten is not None:
                    sc["intensity"] = inten[j]
                out.append((self.maker.t_end(k), "scan", sc))
            self.bytes += pts.nbytes + valid.nbytes + (
                0 if inten is None else inten.nbytes)
        self.n_scans = max(self.n_scans, k1)
        return out

    def extend(self):
        """Make the next block: its IMU first, then its scans (the
        original's draw order), radar frames and odometry messages."""
        t0 = time.perf_counter()
        s, T1 = self.sensors, self.until + BLOCK_SENSOR_S
        rate = s["imu"]["rate"]
        i1 = synth.arange_count(0.0, T1, 1.0 / rate)
        ts, acc, gyro = synth.imu_block(self.traj, rate, self.n_imu, i1,
                                        self.rng, s["imu"]["noise"])
        self.n_imu = i1
        self.imu_parts.append((ts, acc, gyro))
        self.imu = dict(ts=np.concatenate([p[0] for p in self.imu_parts]),
                        acc=np.concatenate([p[1] for p in self.imu_parts]),
                        gyro=np.concatenate([p[2] for p in self.imu_parts]))
        new = self._scans(synth.arange_count(
            self.maker.start, T1 - self.lm.period, self.lm.period))
        r = s.get("radar")
        if r:
            start = self.tc.t_stationary * 0.5
            k1 = synth.arange_count(start, T1, 1.0 / r["rate"])
            frames = synth.radar_frames(self.traj, r["rate"], self.n_radar,
                                        k1, start, self.rng_radar,
                                        r["n_targets"], r["noise"])
            rule = self.mix.get("late_radar")
            delay = self.mix.get("radar_delay_s", 0.0)
            new += [(fr["ts"] + (delay if late_radar(self.n_radar + j, rule)
                                 else 0.0), "radar", fr)
                    for j, fr in enumerate(frames)]
            self.n_radar = k1
        o = s.get("odometry")
        if o:
            start = self.tc.t_stationary * 0.5
            k1 = synth.arange_count(start, T1, 1.0 / o["rate"])
            new += [(m["ts"], "odom", m) for m in synth.odometry_msgs(
                self.traj, o["rate"], self.n_odom, k1, start, self.rng_odom,
                o["noise_rot"], o["noise_trans"], o["cov"])]
            self.n_odom = k1
        self.until = T1
        self.blocks += 1
        self._merge(new)
        self.gen_s += time.perf_counter() - t0

    def _merge(self, new):
        """Append ``new`` in arrival order; a late frame of this block may
        arrive before measurements of the next, so the tail that could
        interleave is sorted again (ties: scans, radar, odometry)."""
        key = lambda e: (e[0], KIND_ORDER[e[1]])  # noqa: E731
        new.sort(key=key)
        if not new:
            return
        cut = len(self.events)
        while cut and self.events[cut - 1][0] > new[0][0]:
            cut -= 1
        tail = self.events[cut:] + new
        tail.sort(key=key)
        self.events[cut:] = tail

    def ready(self, i):
        """Are event i, everything that arrives before it, and the IMU up
        to its arrival and lead made?"""
        margin = self.mix["imu_lead_s"] + self.mix.get("radar_delay_s", 0.0) \
            + 2 * self.lm.period
        return i < len(self.events) and \
            self.events[i][0] + margin < self.until

    def ensure(self, i):
        """Make blocks until event i is ready; returns the seconds spent."""
        t0 = time.perf_counter()
        while not self.ready(i):
            self.extend()
        return time.perf_counter() - t0

    def prepare(self, warm_sensor_s, seconds):
        """Make blocks ahead, at set-up, for the warm-up's ``warm_sensor_s``
        and a window of ``seconds`` (``POOL_*``)."""
        sensor_s = warm_sensor_s + POOL_SENSOR_S_PER_S * seconds
        while self.until < sensor_s and self.bytes < POOL_CAP_BYTES:
            self.extend()

    def imu_upto(self, i0, t):
        """Index one past the last IMU sample at or before t, from i0 on."""
        return max(i0, int(np.searchsorted(self.imu["ts"], t, "right")))
