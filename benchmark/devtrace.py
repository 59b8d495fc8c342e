"""The device trace of a traced stretch and its reduction: device busy
time (the union of kernel and copy intervals), device ops, the ICP
kernel's launches and time, device time inside the benchmark's host
spans, the busiest device ops by name and the idle gaps by the host span
they fell in. Spans are ``torch.profiler.record_function`` ranges named
``bench.<what>``, opened by the harness around its calls into the program
only while a trace is running."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

TRACED = "bench.traced"


class Tracer:
    """Starts and stops one profiler over a stretch of the window."""

    def __init__(self):
        self.prof = None
        self.active = False
        self.done = False
        self._outer = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._outer = torch.profiler.record_function(TRACED)
        self._outer.__enter__()
        self.active = True

    def stop(self):
        self._outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)      # synchronizes the device
        self.active = False
        self.done = True

    def span(self, name):
        """A host span ``bench.<name>`` while tracing, else nothing."""
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function("bench." + name)

    def reduce(self, kernel_names=()):
        return Trace(self.prof.profiler.kineto_results.events(),
                     kernel_names)


class Trace:
    """What the traced stretch shows. Times in seconds."""

    def __init__(self, events, kernel_names=()):
        CPU = torch.autograd.DeviceType.CPU
        dev, spans, outer = [], [], None
        for e in events:
            dt = e.device_type()
            if dt == CPU:
                if e.is_user_annotation() and e.name().startswith("bench."):
                    iv = (e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()[6:])
                    if e.name() == TRACED:
                        outer = iv
                    else:
                        spans.append(iv)
            elif not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
        if outer is None:
            raise RuntimeError("the trace holds no traced stretch")
        w0, w1 = outer[0], outer[1]
        dev = sorted(d for d in dev if d[1] > w0 and d[0] < w1)
        self.window_s = (w1 - w0) / 1e9
        self.n_ops = len(dev)
        by_name = defaultdict(float)
        self.kernels = defaultdict(lambda: [0, 0.0])
        for a, b, n in dev:
            by_name[n] += (b - a) / 1e9
            for k in kernel_names:
                if k in n:
                    self.kernels[k][0] += 1
                    self.kernels[k][1] += (b - a) / 1e9
        self.top_ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        # busy: the union of the device intervals inside the window
        merged = []
        for a, b, _ in dev:
            a, b = max(a, w0), min(b, w1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        # idle gaps, each put under the innermost span open at its start
        spans.sort()
        starts = [s[0] for s in spans]
        gaps = defaultdict(float)
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps[self._span_at(spans, starts, g0)] += (g1 - g0) / 1e9
        self.idle_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:10]
        # device time of the ops that started inside each span
        self.by_span = defaultdict(lambda: [0.0, 0, 0])
        for s in spans:
            self.by_span[s[2]][2] += 1
        top = self._top_level(spans)
        tstarts = [s[0] for s in top]
        for a, b, _ in dev:
            i = bisect.bisect_right(tstarts, a) - 1
            if i >= 0 and a <= top[i][1]:
                rec = self.by_span[top[i][2]]
                rec[0] += (b - a) / 1e9
                rec[1] += 1

    @staticmethod
    def _top_level(spans):
        """The spans not inside another (spans sorted by start)."""
        out = []
        for s in spans:
            if not out or s[0] >= out[-1][1]:
                out.append(s)
        return out

    @staticmethod
    def _span_at(spans, starts, t):
        for a, b, n in reversed(spans[:bisect.bisect_right(starts, t)]):
            if t <= b:
                return n
        return "outside spans"

    def span_device(self, name):
        """(device seconds, device ops, spans) of the spans ``name``."""
        return tuple(self.by_span.get(name, (0.0, 0, 0)))
