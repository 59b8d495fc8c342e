"""Online (live) estimator — the mimosa_node equivalent.

The port of ``mimosa_tpu/io/online.py``: the same threads, queue, holdback,
backpressure, counters and callbacks around the port's :class:`Sequencer`.
The reference's online entry point wires ROS callbacks to the managers
with an AsyncSpinner(2) plus a dedicated high-priority IMU callback queue
on its own thread (ref src/mimosa_node.cpp:22-54), guarded by four
mutexes. Here the concurrency stays at the edges and the estimator core is
single-threaded and deterministic:

* ``push_imu`` is the high-priority path: it advances the host-rate
  :class:`~mimosa_tpu_torch.imu.propagation.Propagator` synchronously on
  the caller's thread (numpy, microseconds — ref imu/manager.cpp:98-161)
  and emits the low-latency odometry callback, then enqueues the sample
  for the graph worker.
* All graph work (the Sequencer's steps, captured CUDA graphs on the card)
  runs on ONE worker thread draining the event queue in arrival order —
  the ordering the reference gets from its callback queues, without the
  mutexes (the sequencer is only ever touched by the worker).
* Scans are staged (packed, and their host-to-device copy started) on the
  pusher's thread and held back until the IMU buffer has advanced past
  the scan end — the lidar_collection_delay queue of the offline harness
  applied online (ref src/mimosa_rosbag.cpp:111-115). Radar/odometry
  events hold until IMU covers their timestamp. On the card the staged
  copy is enqueued on the pusher's current stream and an event recorded
  after it; the worker's stream waits on that event before the step that
  reads the scan, whatever streams the two threads use.
* After every graph update the newest optimized state is gathered on the
  device into one [19] row, copied to pinned host memory without waiting
  for the stream, and an event recorded after the copy; the next time the
  worker is idle or takes an IMU sample it waits on that event (by then
  the copy has virtually always landed) and rebases the propagator (ref
  setPropagationBaseState, imu/manager.cpp:484-494).

Backpressure: if more than ``max_pending_scans`` scans are queued/held the
newest scan is dropped and counted (``scans_dropped_backlog``) — the
behavior a real-time deployment needs when compute falls behind, which the
reference delegates to ROS subscriber queue sizes.
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np
import torch

from mimosa_tpu_torch.graph.sequencer import EstimatorState
from mimosa_tpu_torch.imu.propagation import Propagator

logger = logging.getLogger(__name__)


def extract_state(window, slot, out):
    """Write slot ``slot``'s (q, p, v, bg, ba) and the gravity direction
    into the [19] tensor ``out`` (device ops only)."""
    torch.cat([window.q[slot], window.p[slot], window.v[slot],
               window.bg[slot], window.ba[slot], window.g_dir], out=out)


class OnlineEstimator:
    """Thread-safe live front door around a port :class:`Sequencer`.

    Parameters
    ----------
    seq : mimosa_tpu_torch.graph.sequencer.Sequencer
        A fresh sequencer (owned exclusively by this estimator's worker); it
        runs on the device it was made for.
    on_propagated : callable(ts, q, p, v) or None
        High-rate output, called on the ``push_imu`` caller's thread for
        every IMU sample once the propagator has a base state.
    on_state : callable(ts, q, p, v, bg, ba, g_dir) or None
        Graph-rate output, called on the worker thread after each
        optimized-state rebase.
    collection_slack : float
        Extra seconds of IMU data required past a scan's end before the
        scan is processed (deskew needs coverage through t_end).
    max_pending_scans : int
        Backlog bound; scans beyond it are dropped (newest-dropped).
    stage_on_push : bool
        True packs each scan and starts its host-to-device copy on the
        pusher's thread, overlapping the worker's device work. False
        defers staging to the worker.
    debug_stream : mimosa_tpu_torch.io.viz.DebugStream or None
        Emitted on the worker thread after each scan, on its cadence (the
        live dashboard's feed); the read follows the scan's step on the
        worker's stream.
    """

    def __init__(self, seq, g_mag=9.81, on_propagated=None, on_state=None,
                 collection_slack=0.0, max_pending_scans=8,
                 stage_on_push=True, debug_stream=None):
        if debug_stream is not None and not callable(
                getattr(debug_stream, "emit", None)):
            raise TypeError(f"debug_stream must be an io.viz.DebugStream, "
                            f"not {type(debug_stream).__name__}")
        self.seq = seq
        self.debug_stream = debug_stream
        self.on_propagated = on_propagated
        self.on_state = on_state
        self.collection_slack = float(collection_slack)
        self.max_pending_scans = int(max_pending_scans)
        self.stage_on_push = bool(stage_on_push)
        self.propagator = Propagator(g_mag=g_mag)
        self.counters = {"imu": 0, "scans": 0, "radar": 0, "odom": 0,
                         "scans_dropped_backlog": 0, "rebases": 0}
        self._cuda = seq.device.type == "cuda"
        # the card the worker thread runs on ("cuda" names the current one)
        self._cuda_index = None if not self._cuda else (
            seq.device.index if seq.device.index is not None
            else torch.cuda.current_device())
        self._prop_lock = threading.Lock()
        self._queue = queue.SimpleQueue()
        self._n_pending_scans = 0        # queued + held (worker-adjusted)
        self._pending_lock = threading.Lock()
        self._held = []                  # events waiting for IMU coverage
        # the newest state's row on the device and its host copy (pinned
        # on the card), made at the first extraction
        self._state_dev = self._state_host = None
        self._pending_state = None       # (ts, copy-done event or None)
        self._latest_state = None        # last resolved EstimatorState
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mimosa-graph-worker")
        self._worker.start()

    # ------------------------------------------------------------- pushers

    def push_imu(self, ts, acc, gyro):
        """High-priority path: propagate + emit immediately, then enqueue
        for the graph worker. Returns the propagated (q, p, v) or None."""
        self.counters["imu"] += 1
        acc = np.asarray(acc, float)
        gyro = np.asarray(gyro, float)
        with self._prop_lock:
            out = self.propagator.add_imu(ts, acc, gyro)
        if out is not None and self.on_propagated is not None:
            self.on_propagated(float(ts), *out)
        self._queue.put(("imu", (float(ts), acc, gyro)))
        return out

    def push_scan(self, ts_header, points, t_rel, valid=None,
                  intensity=None):
        """Stage the scan (starts the host-to-device copy on this thread so
        it overlaps in-flight device work) and enqueue it. Returns False if
        the backlog bound dropped it."""
        with self._pending_lock:
            if self._n_pending_scans >= self.max_pending_scans:
                self.counters["scans_dropped_backlog"] += 1
                return False
            self._n_pending_scans += 1
        if self.stage_on_push:
            payload = self._stage(ts_header, points, t_rel, valid, intensity)
        else:
            payload = ("raw", ts_header, points, t_rel, valid, intensity)
        self.counters["scans"] += 1
        self._queue.put(("scan", payload))
        return True

    def push_radar(self, ts, points_r, doppler, snr_db=None):
        self.counters["radar"] += 1
        self._queue.put(("radar", (float(ts), np.asarray(points_r),
                                   np.asarray(doppler),
                                   None if snr_db is None
                                   else np.asarray(snr_db))))

    def push_odometry(self, ts, q_s, t_s, cov6=None):
        self.counters["odom"] += 1
        self._queue.put(("odom", (float(ts), np.asarray(q_s, float),
                                  np.asarray(t_s, float),
                                  None if cov6 is None
                                  else np.asarray(cov6, float))))

    # -------------------------------------------------------------- queries

    def current_state(self):
        """Latest optimized state snapshot (the online analogue of
        graph::Manager::getCurrentState, ref graph/manager.hpp:128).
        Thread-safe: returns the immutable snapshot published by the worker
        after each rebase; None before the first optimized state lands."""
        return self._latest_state

    def current_pose(self):
        """IMU-rate propagated (ts, q, p, v) — the low-latency high-rate
        output (ref imu/manager.cpp:98-161). None until the propagator has
        a base state."""
        with self._prop_lock:
            pr = self.propagator
            if not pr.ready or pr.ts is None:
                return None
            return (float(pr.ts), pr.q.copy(), pr.p.copy(), pr.v.copy())

    # ------------------------------------------------------------ lifecycle

    def stop(self, drain=True, timeout=60.0):
        """Stop the worker. With ``drain`` the remaining queue is processed
        (held scans whose IMU coverage never arrives are discarded)."""
        self._queue.put(("stop", drain))
        self._worker.join(timeout)

    def flush(self, timeout=60.0):
        """Block until every event pushed so far has been consumed by the
        worker (held scans may still be waiting on IMU coverage)."""
        done = threading.Event()
        self._queue.put(("flush", done))
        return done.wait(timeout)

    # -------------------------------------------------------------- worker

    def _stage(self, *scan):
        """``Sequencer.stage_scan`` on this thread; on the card, with the
        event the worker's stream waits on before it reads the scan."""
        payload = self.seq.stage_scan(*scan)
        if self._cuda:
            payload["copied"] = torch.cuda.Event()
            payload["copied"].record(
                torch.cuda.current_stream(self.seq.device))
        return payload

    def _run(self):
        if self._cuda:
            # the CUDA device is per thread: this thread runs the steps
            torch.cuda.set_device(self._cuda_index)
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.05)
            except queue.Empty:
                kind, payload = "idle", None
            if kind == "flush":
                payload.set()
                continue
            try:
                if kind == "stop":
                    if payload:           # drain
                        self._drain_remaining()
                    self._resolve_rebase()
                elif kind == "idle":
                    self._resolve_rebase()
                else:
                    self._handle(kind, payload)
            except Exception:             # keep the worker alive
                logger.exception("online worker: %s event failed", kind)
            if kind == "stop":
                return

    def _handle(self, kind, payload):
        seq = self.seq
        if kind == "imu":
            # consume any landed state copy first: by the next IMU event the
            # asynchronous copy has virtually always landed, so this is free
            self._resolve_rebase()
            seq.add_imu(*payload)
            self._release_held()
            return
        # exteroceptive events wait for IMU coverage of their end time
        if kind == "scan":
            if isinstance(payload, tuple) and payload[0] == "raw":
                payload = self._stage(*payload[1:])
            need = payload["t_end"] + self.collection_slack
        else:
            need = payload[0]
        if len(seq.imu) == 0 or seq.imu.t_last < need:
            self._held.append((need, kind, payload))
            return
        self._process(kind, payload)

    def _release_held(self):
        if not self._held:
            return
        t_last = self.seq.imu.t_last
        ready = [h for h in self._held if h[0] <= t_last]
        if not ready:
            return
        self._held = [h for h in self._held if h[0] > t_last]
        for _, kind, payload in sorted(ready, key=lambda h: h[0]):
            self._process(kind, payload)

    def _process(self, kind, payload):
        seq = self.seq
        if kind == "scan":
            copied = payload.get("copied")
            if copied is not None:
                torch.cuda.current_stream(seq.device).wait_event(copied)
            seq.add_scan(payload["ts_header"], staged=payload)
            with self._pending_lock:
                self._n_pending_scans -= 1
            if self.debug_stream is not None:
                self.debug_stream.emit(seq)
        elif kind == "radar":
            ts, pts, dop, snr = payload
            seq.add_radar(ts, pts, dop, snr_db=snr)
        elif kind == "odom":
            ts, q_s, t_s, cov6 = payload
            seq.add_odometry(ts, q_s, t_s, cov6=cov6)
        if seq.initialized and seq.n_active > 0:
            self._request_rebase()

    # ------------------------------------------------------ state extraction

    def _request_rebase(self):
        """Gather the newest state on the device and start its copy to the
        host; the result is consumed when it lands (the worker does not
        wait for the step here)."""
        seq = self.seq
        w = seq.window
        if self._state_dev is None:
            self._state_dev = torch.empty(19, dtype=w.q.dtype,
                                          device=seq.device)
            self._state_host = torch.empty(19, dtype=w.q.dtype,
                                           pin_memory=self._cuda)
        extract_state(w, seq.n_active - 1, self._state_dev)
        done = None
        if self._cuda:
            self._state_host.copy_(self._state_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(seq.device))
        else:
            self._state_host.copy_(self._state_dev)
        self._pending_state = (seq.last_state_ts, done)

    def _resolve_rebase(self):
        if self._pending_state is None:
            return
        ts, done = self._pending_state
        self._pending_state = None
        if done is not None:
            done.synchronize()
        s = self._state_host.numpy().astype(float)
        q, p, v, bg, ba, g = (s[0:4], s[4:7], s[7:10], s[10:13], s[13:16],
                              s[16:19])
        with self._prop_lock:
            self.propagator.set_base_state(ts, q, p, v, bg, ba, g)
        self._latest_state = EstimatorState(float(ts), q, p, v, bg, ba, g)
        self.counters["rebases"] += 1
        if self.on_state is not None:
            self.on_state(float(ts), q, p, v, bg, ba, g)

    def _drain_remaining(self):
        while True:
            try:
                kind, payload = self._queue.get_nowait()
            except queue.Empty:
                break
            if kind == "stop":
                continue
            if kind == "flush":
                payload.set()
                continue
            try:
                self._handle(kind, payload)
            except Exception:
                logger.exception("online worker drain: %s failed", kind)
        if self._held:
            logger.info("online: %d events still waiting for IMU coverage "
                        "at stop", len(self._held))
            with self._pending_lock:
                self._n_pending_scans -= sum(
                    1 for h in self._held if h[1] == "scan")
            self._held.clear()
