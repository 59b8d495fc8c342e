"""The two ways measurements reach the system, each with its warm-up:

* ``stream``: live and closed loop. The IMU up to an event's arrival (and
  the traffic's lead) is pushed, then the event is handed over, then the
  newest state is read back to host memory; only then is the next event
  handed over. An event's latency runs from the hand-over to the pose on
  the host.
* ``bulk``: offline replay. Recorded measurements go to the bulk
  scheduler in chunks, in arrival order, with their IMU pushed first; the
  window ends at the first chunk boundary after its length, with one
  device synchronize.

Warm-up runs the same traffic from the start of the stream until the
captured step graphs stop growing, so that nothing is captured inside the
window."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.hostinfo import Host

now = time.perf_counter

# Warm-up, by mode: at least ``sensor_s`` of stream events (the bulk mode
# streams them, as an offline replay's start does), then, for bulk, at
# least ``chunks`` chunks; each phase until ``quiet`` events or
# ``quiet_chunks`` chunks in a row captured nothing, within
# ``max_sensor_s``.
WARM = {"stream": dict(sensor_s=4.0, max_sensor_s=14.0, quiet=40),
        "bulk": dict(sensor_s=3.0, max_sensor_s=12.0, chunks=2,
                     quiet_chunks=2)}
# The traced stretch of a ``--trace 1`` run: from ``TRACE_SKIP_S`` into
# the window on, ``TRACE_SENSOR_S`` of events (stream) or ``TRACE_CHUNKS``
# chunks (bulk).
TRACE_SKIP_S = 3.0
TRACE_SENSOR_S = 1.0
TRACE_CHUNKS = 1


class Window:
    """What a window did: its length, the work and the host clocks of
    each event, the answers it gave, and the program's timers and counts
    at its ends."""

    def __init__(self):
        self.seconds = 0.0
        self.scans = 0
        self.events = []            # (kind, measurement time) handed over
        self.latency_s = []         # stream: hand-over to pose on host
        self.submit_s = []          # stream: hand-over to add_*'s return
        self.answers = []           # stream: newest state after each event
        self.gen_s = 0.0            # pool blocks made inside the window
        self.captures = 0           # graphs captured inside the window
        self.timers0 = self.timers1 = None
        self.first_row = 0          # bulk: trajectory rows before the window
        self.first_record = 0       # scan records before the window
        self.host = Host()          # what the host did meanwhile


def measurement_time(kind, m):
    from benchmark.synth import scan_t_end
    return scan_t_end(m) if kind == "scan" else m["ts"]


class Driver:
    def __init__(self, system, pool, mix, tracer, device):
        self.sys, self.pool, self.mix = system, pool, mix
        self.tracer = tracer
        self.cuda = torch.device(device).type == "cuda"
        self.i = 0                  # next event
        self.imu_i = 0              # next IMU sample

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def push_imu(self, t):
        p = self.pool
        j = p.imu_upto(self.imu_i, t + self.mix["imu_lead_s"])
        imu = p.imu
        self.sys.add_imu(imu["ts"][self.imu_i:j], imu["acc"][self.imu_i:j],
                         imu["gyro"][self.imu_i:j])
        self.imu_i = j

    def stream_one(self, w=None):
        """Hand event ``self.i`` over and read the newest state back."""
        tr = self.tracer
        with tr.span("gen"):
            g = self.pool.ensure(self.i)
        arrive, kind, m = self.pool.events[self.i]
        with tr.span("imu"):
            self.push_imu(arrive)
        with tr.span(kind):
            t0 = now()
            self.sys.hand(kind, m)
            t1 = now()
            row = self.sys.newest()
            t2 = now()
        self.i += 1
        if w is not None:
            w.gen_s += g
            w.events.append((kind, measurement_time(kind, m)))
            w.submit_s.append(t1 - t0)
            w.latency_s.append(t2 - t0)
            w.answers.append(row)
            if kind == "scan":
                w.scans += 1

    def bulk_one(self, w=None):
        """Hand the next chunk of events to the bulk scheduler."""
        tr, chunk = self.tracer, self.mix["chunk"]
        with tr.span("gen"):
            g = self.pool.ensure(self.i + chunk - 1)
        evs = self.pool.events[self.i:self.i + chunk]
        with tr.span("imu"):
            self.push_imu(max(e[0] for e in evs))
        with tr.span("bulk"):
            self.sys.hand_bulk(evs, chunk)
        self.i += chunk
        if w is not None:
            w.gen_s += g
            w.events += [(k, measurement_time(k, m)) for _, k, m in evs]
            w.scans += sum(k == "scan" for _, k, _ in evs)

    # ----------------------------------------------------------- warm-up
    def warm(self):
        """Run the cell's own traffic until the captured graphs stop
        growing (``WARM``)."""
        p, bulk = self.pool, self.mix["mode"] == "bulk"
        wm = WARM[self.mix["mode"]]
        quiet, last = 0, self.sys.captures()
        while True:
            p.ensure(self.i)
            t = p.events[self.i][0]
            if t >= wm["max_sensor_s"]:
                break
            if t >= wm["sensor_s"] and (bulk or quiet >= wm["quiet"]):
                break
            self.stream_one()
            c = self.sys.captures()
            quiet = quiet + 1 if c == last else 0
            last = c
        if bulk:
            n, quiet = 0, 0
            while n < wm["chunks"] or quiet < wm["quiet_chunks"]:
                if p.events[self.i][0] >= wm["max_sensor_s"]:
                    break
                self.bulk_one()
                c = self.sys.captures()
                quiet = quiet + 1 if c == last else 0
                last, n = c, n + 1
        self.sync()

    # ------------------------------------------------------------ window
    def window(self, seconds, trace):
        """The measured window. With ``trace``, the profiler runs over a
        stretch of it (``TRACE_*``)."""
        tr = self.tracer
        bulk = self.mix["mode"] == "bulk"
        step = self.bulk_one if bulk else self.stream_one
        w = Window()
        w.timers0 = self.sys.timers()
        w.first_row = len(self.sys.trajectory()) if bulk else 0
        w.first_record = self.sys.n_records()
        c0 = self.sys.captures()
        traced_from = None
        w.host.start()
        t_start = now()
        while now() - t_start < seconds:
            w.gen_s += self.pool.ensure(self.i)
            if trace and not tr.done:
                el = now() - t_start
                if not tr.active and el >= TRACE_SKIP_S:
                    tr.start()
                    traced_from = (self.i, self.pool.events[self.i][0])
                elif tr.active and (
                        (bulk and (self.i - traced_from[0])
                         >= TRACE_CHUNKS * self.mix["chunk"])
                        or (not bulk and self.pool.events[self.i][0]
                            - traced_from[1] >= TRACE_SENSOR_S)):
                    tr.stop()
            step(w)
        if tr.active:
            tr.stop()
        with tr.span("sync"):
            self.sync()
        w.seconds = now() - t_start
        w.host.stop()
        w.captures = self.sys.captures() - c0
        w.timers1 = self.sys.timers()
        return w


def percentile(samples, q):
    """The q-th percentile of all samples (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(samples, float), q))
