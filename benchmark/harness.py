"""One run of one cell: find the cell, its configuration, its traffic mix,
its limits and its metrics by their names in ``BENCHMARK.json``; make the
inputs from the seed; build and warm the system; measure the window; judge
the answers against the reference; print the metrics.

Everything that belongs to one configuration, mix, cell or metric is a
file of its own: ``configs/<config>.json`` (as ``BENCHMARK.json`` names
it), ``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``. Adding a cell, configuration, mix or metric adds
files and entries and edits none."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mimosa_tpu")


class RunError(RuntimeError):
    """A run that cannot measure: it prints no result and exits non-zero."""


def process_start():
    """The wall-clock time at which this process started (Linux), else
    now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        boot = next(float(line.split()[1]) for line in
                    Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def environment(root):
    """Set before torch is imported: every build and kernel cache inside
    the checkout, at fixed paths."""
    b = Path(root) / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(b / "cuda")


def host_threads(cfg):
    """The configuration's ``host_threads``, the threads of the program's
    host pools (OpenMP, BLAS), set before torch is imported; unset, the
    program's defaults hold."""
    n = cfg.get("host_threads")
    if n is not None:
        for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                  "OPENBLAS_NUM_THREADS"):
            os.environ[k] = str(int(n))


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise RunError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise RunError(f"no configuration named {name!r}")

    def traffic(self, name):
        return json.loads((self.dir / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell):
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell, trace):
        """The metric entries this cell reports: its end-to-end metrics
        with ``trace`` 0, its per-layer metrics with 1."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, name):
        """The ``read(run)`` function of ``metrics/<name>.py``."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What the metric readers read: the cell, its configuration and mix,
    the window, the set-up time, the trace (None without one), the
    program's counts and the card's name."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def timer_s(self, stage):
        """Seconds the program's host stage timer ``stage`` ran inside the
        window."""
        w = self.window
        return w.timers1.get(stage, 0.0) - w.timers0.get(stage, 0.0)


def check_device(chips):
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def measure(bench, cell_name, seed, seconds, trace, device=None,
            t_start=None, hooks=None):
    """One run of cell ``cell_name``. ``device`` None looks for the card
    (and fails without one); the CPU tests pass ``"cpu"``. ``hooks``
    (tests only) may replace the system's class. Returns the Run."""
    import torch

    from benchmark import devtrace, drive, reference, system, traffic

    t_start = time.time() if t_start is None else t_start
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    if device is None:
        device = check_device(cell["chips"])
    cuda = torch.device(device).type == "cuda"
    phases = {"start": time.time() - t_start}
    pool = traffic.Pool(cfg, mix, seed, device)
    pool.prepare(drive.WARM[mix["mode"]]["max_sensor_s"], seconds)
    pre_gen_s = pool.gen_s
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["inputs"] = time.time() - t_start
    make = (hooks or {}).get("system", system.System)
    sysm = make(cfg, device)
    phases["system"] = time.time() - t_start
    tracer = devtrace.Tracer()
    drv = drive.Driver(sysm, pool, mix, tracer, device)
    drv.warm()
    warm_events = drv.i
    # the pool's and the warm-up's objects are never freed inside the
    # window: keep the collector from walking them there
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    phases["warm"] = setup_s
    win = drv.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = tracer.reduce([system.ICP_KERNEL]) if trace and tracer.done \
        else None
    counts = sysm.counts()
    if mix["mode"] == "stream":
        missing, ts, q, p, v, bg, ba = reference.stream_states(win)
        live = None
    else:
        traj = sysm.trajectory()
        live = sysm.window_states()
        missing, ts, q, p = reference.bulk_states(win, traj)
    photo = sysm.photo_used(win.first_record)
    n_gn = sysm.seq.cfg.n_gn_iters
    n_icp = sysm.seq.cfg.n_geo_points
    del sysm, drv
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    numbers = reference.judge(cfg, missing, ts, q, p)
    if photo is not None:
        numbers["photo_unused_share"] = photo_unused_share(photo)
    if mix["mode"] == "stream":
        shown = reference.printed(cfg, ts, q, p, v, bg, ba)
    else:
        shown = reference.printed(cfg, ts, q, p)
        if live:
            a = _rows(live)
            shown.update({k: x for k, x in reference.printed(
                cfg, a[:, 0], a[:, 1:5], a[:, 5:8], a[:, 8:11],
                a[:, 11:14], a[:, 14:17]).items() if k != "ate_m"})
    correct, checks = reference.verdict(numbers, bench.limits(cell_name))
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    return Run(cell=cell, config=cfg, mix=mix, seed=seed, window=win,
               setup_s=setup_s, pre_gen_s=pre_gen_s, trace=tr,
               counts=counts, n_gn_iters=n_gn, n_icp_points=n_icp,
               memory_peak_bytes=int(peak), device_kind=kind,
               correct=correct, checks=checks, shown=shown,
               numbers=numbers, states=(ts, q, p), missing=missing,
               pool_until=pool.until, pool_blocks=pool.blocks,
               phases=phases, warm_events=warm_events)


def photo_unused_share(used):
    """The share of the window's scan steps whose photometric factor used
    no feature: the program's own record that the factor was in the step,
    beside the reference's judgement of the poses it moved."""
    return float((used <= 0).mean()) if len(used) else 1.0


def _rows(rows):
    import numpy as np
    return np.asarray(rows, float).reshape(-1, 17)


def report(bench, run, trace):
    """The metric values this cell reports, by its metric entries."""
    out = {}
    for m in bench.metrics(run.cell["name"], trace):
        v = bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None, t_start=None, root=None):
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(HERE.parent if root is None else root)
    try:
        host_threads(bench.config(bench.cell(args.workload)["config"]))
        run = measure(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    metrics = report(bench, run, bool(args.trace))
    w = run.window
    err = sys.stderr
    print(f"window {w.seconds:.6f} s, {len(w.events)} events, {w.scans} "
          f"scans, pool made {run.pool_until:.1f} sensor s in "
          f"{run.pool_blocks} blocks ({run.pre_gen_s:.3f} s at set-up, "
          f"{w.gen_s:.3f} s inside the window), {w.captures} graphs "
          f"captured inside the window", file=err)
    print("set-up, seconds from process start at the end of: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.phases.items())
        + f"; {run.warm_events} warm-up events", file=err)
    print(w.host.summary(), file=err)
    print(f"card {power_limit()}; peak {run.memory_peak_bytes} B; "
          f"counts {json.dumps(run.counts)}", file=err)
    compared = {k for k, _, _ in run.checks}
    shown = {**{k: v for k, v in run.numbers.items() if k not in compared},
             **run.shown}
    print("printed, not compared: " + ", ".join(
        f"{k} {v:.6g}" for k, v in shown.items()), file=err)
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
              for k, v, lim in run.checks}
    for k, v, lim in run.checks:
        print(f"check {k} {v!r} limit {lim!r}", file=err)
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": run.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": run.correct, "attempted": len(w.events),
            "failed": run.missing, "metrics": metrics, "device": device}
    if args.trace and run.trace is not None:
        t = run.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": [[n, s] for n, s in t.top_ops],
                             "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    line["checks"] = checks
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0
