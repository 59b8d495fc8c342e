"""IMU-rate forward propagation — the low-latency output path.

Reference equivalent: imu::Manager's propagation machinery
(src/imu/manager.cpp:98-161): graph-rate (10 Hz) optimized states rebase
the propagation via ``setPropagationBaseState`` (:484-494), and every IMU
sample advances a high-rate (100-400 Hz) pose/velocity estimate published
immediately. Pure numpy in float64 on the host: at IMU rate a device
launch would cost more than the math. The port's copy of
``mimosa_tpu/imu/propagation.py``, the same arithmetic in the same order.
"""

from __future__ import annotations

import numpy as np


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rotate(q, v):
    qv = q[1:]
    t = 2.0 * np.cross(qv, v)
    return v + q[0] * t + np.cross(qv, t)


def _exp_so3(phi):
    a = np.linalg.norm(phi)
    if a < 1e-12:
        return np.array([1.0, 0.5 * phi[0], 0.5 * phi[1], 0.5 * phi[2]])
    half = 0.5 * a
    return np.concatenate([[np.cos(half)], np.sin(half) * phi / a])


class Propagator:
    """High-rate state propagation from the last optimized base state.

    Catch-up replay: the base state usually lands at a timestamp older than
    already-propagated IMU samples, so a ring of recent measurements is
    kept and replayed from the base time (ref "catch-up replay if msgs were
    missed", imu/manager.cpp:118-141).
    """

    def __init__(self, g_mag=9.81, history_secs=1.0):
        self.g_mag = g_mag
        self.history_secs = history_secs
        self._hist = []          # (ts, acc, gyro)
        self._base = None
        self.q = None
        self.p = None
        self.v = None
        self.ts = None

    @property
    def ready(self):
        return self._base is not None

    def set_base_state(self, ts, q, p, v, bg, ba, g_dir):
        """Rebase from a freshly optimized state, replaying buffered IMU
        samples newer than ``ts``."""
        if self._hist and ts < self._hist[0][0] - 1e-9:
            import logging
            logging.getLogger(__name__).warning(
                "propagation base %.3f predates the IMU history ring "
                "(oldest %.3f) — catch-up replay has a gap; increase "
                "history_secs or rebase more often", ts, self._hist[0][0])
        self._base = dict(ts=float(ts), q=np.asarray(q, float),
                          p=np.asarray(p, float), v=np.asarray(v, float),
                          bg=np.asarray(bg, float), ba=np.asarray(ba, float),
                          g=np.asarray(g_dir, float) * self.g_mag)
        b = self._base
        self.q, self.p, self.v, self.ts = b["q"].copy(), b["p"].copy(), \
            b["v"].copy(), b["ts"]
        for (t, acc, gyro) in self._hist:
            if t > self.ts:
                self._advance(t, acc, gyro)

    def add_imu(self, ts, acc, gyro):
        """Advance the high-rate state; returns (q, p, v) or None if no
        base state yet."""
        ts = float(ts)
        self._hist.append((ts, np.asarray(acc, float),
                           np.asarray(gyro, float)))
        cutoff = ts - self.history_secs
        while self._hist and self._hist[0][0] < cutoff:
            self._hist.pop(0)
        if self._base is None:
            return None
        if ts > self.ts:
            self._advance(ts, np.asarray(acc, float), np.asarray(gyro, float))
        return self.q.copy(), self.p.copy(), self.v.copy()

    def _advance(self, ts, acc, gyro):
        dt = ts - self.ts
        b = self._base
        a_w = _quat_rotate(self.q, acc - b["ba"]) + b["g"]
        self.p = self.p + self.v * dt + 0.5 * a_w * dt * dt
        self.v = self.v + a_w * dt
        self.q = _quat_mul(self.q, _exp_so3((gyro - b["bg"]) * dt))
        self.q /= np.linalg.norm(self.q)
        self.ts = ts
