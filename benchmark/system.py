"""The system under test: the port's Sequencer, built from a
configuration file's sections, and the calls that hand it one
measurement. This is the only module of the harness that imports the
program (``mimosa_tpu_torch``)."""

from __future__ import annotations

# the port's ICP kernel as the profiler names it (csrc/icp_linearize.cu)
ICP_KERNEL = "icp_linearize_kernel"


def _tuples(x):
    """JSON lists as tuples (the configurations are hashed as step-cache
    keys)."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


class System:
    """One Sequencer of configuration ``cfg`` on ``device``, with the
    radar and odometry factor settings its sensors use."""

    def __init__(self, cfg, device):
        from mimosa_tpu_torch.graph import sequencer as seq
        from mimosa_tpu_torch.graph import window as win
        from mimosa_tpu_torch.lidar import geometric as geo
        from mimosa_tpu_torch.lidar import photometric as ph
        from mimosa_tpu_torch.mapping import voxel_hash as vh
        from mimosa_tpu_torch.odometry import factor as odo
        from mimosa_tpu_torch.radar import factor as rad

        s = _tuples(cfg["system"])
        photo = s.get("photometric")
        self.seq = seq.Sequencer(
            seq.SequencerConfig(**s["sequencer"]),
            win.WindowConfig(**s["window"]),
            vh.VoxelMapConfig(**s["map"]),
            geo.GeometricConfig(**s["geometric"]),
            None if photo is None else ph.PhotometricConfig(**photo),
            device=device)
        self.radar_cfg = rad.RadarConfig(**s.get("radar_factor", {}))
        self.odom_cfg = odo.OdometryConfig(**s.get("odometry_factor", {}))
        self.photometric = photo is not None

    def hand(self, kind, m):
        """Hand one measurement over, as a sensor driver would: a scan as
        its raw host arrays (the host pack runs inside), a radar frame, an
        odometry message."""
        s = self.seq
        if kind == "scan":
            s.add_scan(m["ts_header"], m["points"], m["t_rel"], m["valid"],
                       intensity=m.get("intensity"))
        elif kind == "radar":
            s.add_radar(m["ts"], m["points"], m["doppler"], m["snr_db"],
                        radar_cfg=self.radar_cfg)
        else:
            s.add_odometry(m["ts"], m["q"], m["t"], m["cov"],
                           odom_cfg=self.odom_cfg)

    def hand_bulk(self, events, chunk):
        """Hand recorded measurements over to the offline scheduler, in
        arrival order: scans alone through ``add_scans_bulk``, a mix
        through ``add_bulk``."""
        msgs = []
        for _, kind, m in events:
            if kind == "scan":
                msgs.append(m)
            elif kind == "radar":
                msgs.append(dict(kind="radar", ts=m["ts"],
                                 points_r=m["points"], doppler=m["doppler"],
                                 snr_db=m["snr_db"]))
            else:
                msgs.append(dict(kind="odom", ts=m["ts"], q=m["q"],
                                 p=m["t"], cov6=m["cov"]))
        if all(kind == "scan" for _, kind, _ in events):
            self.seq.add_scans_bulk(msgs, chunk=chunk)
        else:
            self.seq.add_bulk(msgs, chunk=chunk, radar_cfg=self.radar_cfg,
                              odom_cfg=self.odom_cfg)

    def add_imu(self, ts, acc, gyro):
        if len(ts):
            self.seq.add_imu_batch(ts, acc, gyro)

    def newest(self):
        """The newest state on the host, a row (ts, q wxyz, p, v, bg, ba),
        or None before initialization."""
        st = self.seq.current_state()
        if st is None:
            return None
        return (st.ts, *st.q, *st.p, *st.v, *st.bg, *st.ba)

    def trajectory(self):
        """[(ts, p [3], q wxyz [4])] of every state logged so far."""
        return self.seq.trajectory

    def window_states(self):
        """Rows (ts, q, p, v, bg, ba) of the live window, oldest first."""
        return [(st.ts, *st.q, *st.p, *st.v, *st.bg, *st.ba)
                for st in self.seq.optimized_values()]

    def n_records(self):
        """Scan records written so far (one a scan step)."""
        return len(self.seq.debug_records())

    def photo_used(self, first):
        """Features the photometric factor used, on each scan record from
        ``first`` on (None without the photometric factor)."""
        if not self.photometric:
            return None
        return self.seq.debug_records()[first:, 12]

    def captures(self):
        g = self.seq.graphs
        return 0 if g is None else g.captures

    def timers(self):
        """{stage: total seconds} of the Sequencer's host stage timers."""
        return {k: v["total_s"] for k, v in self.seq.timers.summary().items()}

    def counts(self):
        """The program's own counters and what they say of the map."""
        s = self.seq
        out = dict(s.counters)
        out["bulk"] = dict(s.bulk_counts)
        out["keyframes"] = s.num_keyframes
        out["map_voxels"] = int(s.vmap.num_occupied)
        return out
