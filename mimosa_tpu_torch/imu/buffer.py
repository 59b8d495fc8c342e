"""Host-side IMU buffer with interpolation and attitude initialization.

Port of ``mimosa_tpu/imu/buffer.py`` (numpy only, so it is carried over
unchanged in behaviour): measurements arrive one at a time at 100-400 Hz
and are kept on the host; the buffer emits fixed-size padded segments for
the device preintegration and deskew.
"""

from __future__ import annotations

import numpy as np


class ImuBuffer:
    """Time-indexed buffer of (ts, acc[3], gyro[3]).

    * strictly monotonic timestamps (non-monotonic samples are rejected and
      counted);
    * bounded duration: samples older than ``max_duration`` before the
      newest are pruned;
    * ``segment(t0, t1)`` returns padded arrays with linearly interpolated
      boundary samples at exactly t0 and t1.
    """

    def __init__(self, max_duration: float = 30.0, acc_scale: float = 1.0):
        self.max_duration = max_duration
        self.acc_scale = acc_scale
        # amortized storage: samples live at [0:_n) of preallocated arrays
        self._cap = 1024
        self._ts = np.zeros(self._cap)
        self._acc = np.zeros((self._cap, 3))
        self._gyro = np.zeros((self._cap, 3))
        self._n = 0
        self.num_rejected_nonmonotonic = 0

    @property
    def ts(self):
        return self._ts[:self._n]

    @property
    def acc(self):
        return self._acc[:self._n]

    @property
    def gyro(self):
        return self._gyro[:self._n]

    def load(self, ts, acc, gyro):
        """Replace the buffer's contents (state carried from another run)."""
        ts = np.asarray(ts, float)
        n = len(ts)
        self._cap = max(1024, n)
        self._ts = np.zeros(self._cap)
        self._acc = np.zeros((self._cap, 3))
        self._gyro = np.zeros((self._cap, 3))
        self._ts[:n] = ts
        self._acc[:n] = np.asarray(acc, float)
        self._gyro[:n] = np.asarray(gyro, float)
        self._n = n

    def __len__(self):
        return self._n

    @property
    def t_first(self):
        return self._ts[0] if self._n else None

    @property
    def t_last(self):
        return self._ts[self._n - 1] if self._n else None

    def _grow(self, need):
        while self._cap < need:
            self._cap *= 2
        for nm, width in (("_ts", None), ("_acc", 3), ("_gyro", 3)):
            cur = getattr(self, nm)
            grown = np.zeros(self._cap if width is None
                             else (self._cap, width))
            grown[: self._n] = cur[: self._n]
            setattr(self, nm, grown)

    def _prune(self):
        cutoff = self._ts[self._n - 1] - self.max_duration
        if self._n and self._ts[0] < cutoff:
            k = int(np.searchsorted(self._ts[: self._n], cutoff))
            # slide down only when a meaningful fraction is stale
            # (amortized O(1) per add)
            if k > max(64, self._cap // 8):
                m = self._n - k
                self._ts[:m] = self._ts[k: self._n]
                self._acc[:m] = self._acc[k: self._n]
                self._gyro[:m] = self._gyro[k: self._n]
                self._n = m

    def add(self, ts: float, acc, gyro) -> bool:
        if self._n and ts <= self._ts[self._n - 1]:
            self.num_rejected_nonmonotonic += 1
            return False
        if self._n + 1 > self._cap:
            self._grow(self._n + 1)
        self._ts[self._n] = ts
        self._acc[self._n] = np.asarray(acc) * self.acc_scale
        self._gyro[self._n] = gyro
        self._n += 1
        self._prune()
        return True

    def add_batch(self, ts, acc, gyro) -> int:
        """Bulk insert of time-ordered samples; non-monotonic ones (vs the
        buffer tail and within the batch) are rejected and counted.
        Returns the number accepted."""
        ts = np.asarray(ts, float)
        acc = np.asarray(acc, float)
        gyro = np.asarray(gyro, float)
        last = self._ts[self._n - 1] if self._n else -np.inf
        keep = np.empty(len(ts), bool)
        run = last
        for i, t in enumerate(ts):        # strictly-increasing filter
            keep[i] = t > run
            if keep[i]:
                run = t
        n_new = int(keep.sum())
        self.num_rejected_nonmonotonic += len(ts) - n_new
        if not n_new:
            return 0
        if self._n + n_new > self._cap:
            self._grow(self._n + n_new)
        sl = slice(self._n, self._n + n_new)
        self._ts[sl] = ts[keep]
        self._acc[sl] = acc[keep] * self.acc_scale
        self._gyro[sl] = gyro[keep]
        self._n += n_new
        self._prune()
        return n_new

    def covers(self, t0: float, t1: float, slack: float = 0.0) -> bool:
        return (len(self.ts) >= 2 and self.ts[0] <= t0 + slack
                and self.ts[-1] + slack >= t1)

    def count_between(self, t0: float, t1: float) -> int:
        """Number of raw samples in (t0, t1]."""
        return int(np.searchsorted(self.ts, t1, "right")
                   - np.searchsorted(self.ts, t0, "right"))

    def interpolate(self, t: float):
        """Linear interpolation (or nearest-extrapolation) at time t."""
        i = np.clip(np.searchsorted(self.ts, t), 1, len(self.ts) - 1)
        t0, t1 = self.ts[i - 1], self.ts[i]
        a = 0.0 if t1 == t0 else np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
        return ((1 - a) * self.acc[i - 1] + a * self.acc[i],
                (1 - a) * self.gyro[i - 1] + a * self.gyro[i])

    def segment(self, t0: float, t1: float, max_n: int):
        """Padded measurement segment spanning [t0, t1]: (ts [max_n],
        acc [max_n,3], gyro [max_n,3], dt [max_n], valid [max_n], n).
        Row 0 is interpolated at t0, rows 1..n-2 are the raw samples
        strictly inside (t0, t1), row n-1 is interpolated at t1; padding
        repeats the last row with dt = 0."""
        out = np.zeros((max_n, 8))
        ts = np.empty(max_n)
        n = self.segment_into(t0, t1, out, out_ts=ts)
        return (ts, out[:, 0:3], out[:, 3:6], out[:, 6],
                out[:, 7] > 0.0, n)

    def segment_into(self, t0: float, t1: float, out: np.ndarray,
                     out_ts: np.ndarray | None = None) -> int:
        """Fill ``out`` ([max_n, 8], the scan step's IMU row layout
        [acc3 | gyro3 | dt | valid]) in place with the segment of
        :meth:`segment` and return the number of real rows n. ``out_ts``
        ([max_n], optional) receives the absolute timestamps."""
        if t1 < t0:
            raise ValueError(f"segment end {t1} precedes its start {t0}")
        max_n = out.shape[0]
        ts_v = self._ts[: self._n]
        i0 = int(np.searchsorted(ts_v, t0, "right"))
        i1 = int(np.searchsorted(ts_v, t1, "left"))
        if i1 - i0 + 2 > max_n:
            # subsample uniformly to fit (sized never to trigger)
            keep = np.linspace(i0, i1 - 1, max_n - 2).astype(int)
            ts_in = ts_v[keep]
            acc_in = self._acc[keep]
            gyro_in = self._gyro[keep]
        else:
            ts_in = ts_v[i0:i1]
            acc_in = self._acc[i0:i1]
            gyro_in = self._gyro[i0:i1]
        k = len(ts_in)
        n = k + 2
        a0, g0 = self.interpolate(t0)
        a1, g1 = self.interpolate(t1)
        out[0, 0:3] = a0
        out[0, 3:6] = g0
        out[1:1 + k, 0:3] = acc_in
        out[1:1 + k, 3:6] = gyro_in
        out[k + 1, 0:3] = a1
        out[k + 1, 3:6] = g1
        if k:
            out[0, 6] = ts_in[0] - t0
            out[1:k, 6] = ts_in[1:] - ts_in[:-1]
            out[k, 6] = t1 - ts_in[-1]
        else:
            out[0, 6] = t1 - t0
        out[n - 1, 6] = 0.0
        np.maximum(out[: n - 1, 6], 0.0, out=out[: n - 1, 6])
        out[n:, 0:6] = out[n - 1, 0:6]
        out[n:, 6] = 0.0
        out[: n - 1, 7] = 1.0
        out[n - 1:, 7] = 0.0
        if out_ts is not None:
            out_ts[0] = t0
            out_ts[1:1 + k] = ts_in
            out_ts[k + 1:] = t1
        return n

    def mean_measurements(self, t0: float, t1: float):
        """Mean (acc, gyro) over [t0, t1], the interpolated end samples
        included (the gyro over a radar frame's exposure)."""
        i0 = np.searchsorted(self.ts, t0, "right")
        i1 = np.searchsorted(self.ts, t1, "left")
        a0, g0 = self.interpolate(t0)
        a1, g1 = self.interpolate(t1)
        accs = np.vstack([a0[None], self.acc[i0:i1], a1[None]])
        gyros = np.vstack([g0[None], self.gyro[i0:i1], g1[None]])
        return accs.mean(0), gyros.mean(0)


def estimate_attitude(buf: ImuBuffer, t: float, wait_secs: float,
                      g_mag: float, gravity_aligned: bool = True):
    """Stationary attitude + gyro-bias initialization.

    Returns None if the buffer holds too little stationary data, else a dict
    with q_w_b (world<-body), bg, ba, g_dir (unit world gravity direction).
    gravity_aligned=True: world z is up, attitude from the mean specific
    force; False: world frame = initial body frame, gravity = -mean_acc.
    """
    if buf.t_first is None or t - buf.t_first < wait_secs:
        return None
    i0 = np.searchsorted(buf.ts, t - wait_secs, "right")
    i1 = np.searchsorted(buf.ts, t, "right")
    if i1 - i0 < 10:
        return None
    mean_acc = buf.acc[i0:i1].mean(0)
    mean_gyro = buf.gyro[i0:i1].mean(0)
    bg = mean_gyro.copy()
    if gravity_aligned:
        # rotation taking the measured specific force to +z*g
        a = mean_acc / np.linalg.norm(mean_acc)
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(a, z)
        s = np.linalg.norm(v)
        c = float(np.dot(a, z))
        if s < 1e-9:
            q = np.array([1.0, 0, 0, 0]) if c > 0 else np.array([0.0, 1, 0, 0])
        else:
            axis = v / s
            ang = np.arctan2(s, c)
            q = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])
        g_dir = np.array([0.0, 0.0, -1.0])
        w, x, y_, z_ = q
        R = np.array([
            [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x * y_ - w * z_),
             2 * (x * z_ + w * y_)],
            [2 * (x * y_ + w * z_), 1 - 2 * (x * x + z_ * z_),
             2 * (y_ * z_ - w * x)],
            [2 * (x * z_ - w * y_), 2 * (y_ * z_ + w * x),
             1 - 2 * (x * x + y_ * y_)]])
        ba = mean_acc - R.T @ (z * g_mag)
    else:
        q = np.array([1.0, 0, 0, 0])
        g_dir = -mean_acc / np.linalg.norm(mean_acc)
        ba = mean_acc + g_dir * g_mag
    return dict(q_w_b=q, bg=bg, ba=ba, g_dir=g_dir, t=t)
