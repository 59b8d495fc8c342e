"""What the host did in a window, so that a slow run can be told apart
from a fast one: the CPU time of the process, of its main thread and of
its other threads (the program's worker pools), and the garbage
collector's pauses. Thread times come from ``/proc`` (Linux) and are left
out where it cannot be read."""

from __future__ import annotations

import gc
import os
import time
from pathlib import Path

TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def threads():
    """{thread id: CPU seconds} of this process's threads."""
    out = {}
    task = Path("/proc/self/task")
    for d in task.glob("*") if task.is_dir() else ():
        try:
            f = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        out[d.name] = (int(f[11]) + int(f[12])) / TICK
    return out


class Host:
    """Readings of the host over a window: ``start``, ``stop``, then
    ``summary``."""

    def __init__(self):
        self.gc_s, self.gc_n, self._gc0 = 0.0, 0, None

    def _gc(self, phase, info):
        if phase == "start":
            self._gc0 = time.perf_counter()
        elif self._gc0 is not None:
            self.gc_s += time.perf_counter() - self._gc0
            self.gc_n += 1
            self._gc0 = None

    def start(self):
        self.t0 = time.perf_counter()
        self.thr0 = threads()
        self.cpu0 = os.times()
        gc.callbacks.append(self._gc)

    def stop(self):
        gc.callbacks.remove(self._gc)
        t = os.times()
        self.wall = time.perf_counter() - self.t0
        self.user = t.user - self.cpu0.user
        self.system = t.system - self.cpu0.system
        used = {tid: s - self.thr0.get(tid, 0.0)
                for tid, s in threads().items()}
        self.main_s = used.pop(str(os.getpid()), 0.0)
        self.others = sorted(used.values(), reverse=True)

    def summary(self):
        busy = ", ".join(f"{s:.2f}" for s in self.others[:4])
        return (f"host: window {self.wall:.3f} s; process CPU user "
                f"{self.user:.3f} s, system {self.system:.3f} s; main "
                f"thread {self.main_s:.2f} CPU s, {len(self.others)} other "
                f"threads {sum(self.others):.2f} (busiest {busy}); "
                f"collector {self.gc_n} pauses, {1e3 * self.gc_s:.1f} ms")
