"""Per-stage host wall-clock timing (port of ``mimosa_tpu/utils/timing.py``).

Host clock only: a stage that launches device work measures the enqueue
unless it ends in ``torch.cuda.synchronize()``. Safe to use from several
threads (the online estimator stages scans on the pusher's thread).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class Stopwatch:
    """Elapsed / lap wall-clock timer (the reference's Stopwatch)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._last = self._t0

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def lap(self) -> float:
        """Seconds since the previous lap (or the reset)."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        return dt


class StageTimer:
    """Accumulates per-stage wall times and counts across iterations.

    >>> t = StageTimer()
    >>> with t.stage("deskew"):
    ...     work()
    >>> t.summary()   # {'deskew': {'total_s': ..., 'count': ..., 'mean_ms': ...}}
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self):
        with self._lock:
            return {
                k: dict(total_s=self.totals[k], count=self.counts[k],
                        mean_ms=self.totals[k] / max(self.counts[k], 1) * 1e3)
                for k in sorted(self.totals)
            }

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>7s} {'mean ms':>9s} {'total s':>9s}"]
        for k, v in self.summary().items():
            lines.append(f"{k:24s} {v['count']:7d} {v['mean_ms']:9.2f} "
                         f"{v['total_s']:9.2f}")
        return "\n".join(lines)
