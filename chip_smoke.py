#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``mimosa_tpu_torch``) through its main path on the card
and prints one line per phase; any failure raises, so the exit code is
non-zero. It needs a CUDA device and ``nvcc``; it imports nothing of JAX or
of the JAX package.

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``mimosa_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``build/mimosa_tpu_torch/``;
3. kernel: the ICP reduction against its plain PyTorch version on a
   synthetic room scene at N = 8192 and N = 4133 (status and localizability
   counts exact, H and b to rtol 2e-4 / atol 2e-2, two launches bitwise
   equal, 4-DoF on, rotation threshold != translation threshold) and the
   median time of each over 50 calls (CUDA events);
4. slice: the Sequencer at the widths of ``__graft_entry__.entry()``
   (32768 points a scan, 8192 ICP points, K=8, 2^18 voxels) on a room
   sequence from a 64x512 LiDAR: finite poses, ATE < 0.08 m, and the ICP
   kernel launched (n_gn_iters + 1) times per scan step;
5. room_clean: ``mimosa_tpu_torch.io.synthetic_replay.run(device="cuda")``
   with ATE < 0.010 m.

The last two lines are the card's nvidia-smi line and
``{"ok": true, "device": {...}}``; the line before them is the JSON record
of the kernel (launches on the main path, error and times).
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = dict(rtol=2e-4, atol=2e-2)   # the JAX Pallas test's H/b gate
ENTRY_ATE_GATE = 0.08                      # room_noisy's gate
ROOM_CLEAN_ATE_GATE = 0.010                # ACCURACY.md room_clean gate


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n=50, warmup=5):
    """Median ms of ``fn()`` over n calls, each between CUDA events on the
    current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_only_ms(matches, pts, valid, q, t, cfg, n_calls=200):
    """The kernel's own three launches per call, without the wrapper's
    torch ops around them: (device ms of the three kernels from a profile
    of n_calls calls, host-clock ms per call of n_calls back-to-back
    calls, which the enqueue bounds)."""
    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.core import lie
    from mimosa_tpu_torch.ops import icp_cuda

    normal, mean, found = matches
    R = lie.quat_to_mat(q)
    rt = torch.cat([R.reshape(9), t]).contiguous()
    vecs = torch.eye(3, device=pts.device).repeat(2, 1).reshape(-1)

    def call():
        icp_cuda._launch_sums(pts, normal, mean, found, valid, rt, cfg)
        icp_cuda._launch_loc_counts(pts, normal, mean, found, valid, rt,
                                    vecs, cfg)

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        call()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "icp_" in e.name]
    check(len(kernels) == 3 * n_calls, f"the profiler saw {len(kernels)} "
          f"ICP kernels in {n_calls} calls, expected {3 * n_calls}")
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return device_ms / n_calls, host_ms


def room_scene(dev, n_per=6000, noise=0.003, seed=0):
    """Room cloud (floor, ceiling, three walls) inserted into a port voxel
    map at leaf 0.4 — the scene of tests/test_icp.py."""
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    rng = np.random.default_rng(seed)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(n_per, 3))
        p[:, axis] = val + rng.normal(size=n_per) * noise
        clouds.append(p)
    pts = torch.tensor(np.concatenate(clouds), dtype=torch.float32,
                       device=dev)
    cfg = vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=16,
                            plane_min_points=5)
    m = vh.insert(vh.create(cfg, dev), pts,
                  torch.ones(len(pts), dtype=torch.bool, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev), cfg)
    return vh.update_planes(m, cfg), cfg, pts


def kernel_phase(dev):
    from mimosa_tpu_torch.core import lie
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.ops import icp_cuda

    vmap, map_cfg, world = room_scene(dev)
    cfg = geo.GeometricConfig(loc_count_thresh=30.0,
                              loc_count_thresh_rot=400.0, use_4dof=True)
    g_dir = torch.tensor([0.02, -0.01, -1.0], device=dev)
    g_dir = g_dir / torch.linalg.vector_norm(g_dir)
    q_true = lie.exp_so3(torch.tensor([0.05, -0.1, 0.4], device=dev))
    t_true = torch.tensor([2.0, 1.5, 1.2], device=dev)
    q, t = lie.se3_retract(q_true, t_true, torch.tensor(
        [0.01, -0.02, 0.01, 0.05, -0.03, 0.02], device=dev))
    gen = torch.Generator(device="cpu").manual_seed(1)
    results = {}
    for n in (8192, 4096, 4096 + 37):
        idx = torch.randperm(len(world), generator=gen)[:n].to(dev)
        qi, ti = lie.se3_inverse(q_true, t_true)
        pts = lie.se3_transform(qi, ti, world[idx]).contiguous()
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[-50:] = False
        matches = geo.match(vmap, pts, q, t, map_cfg)
        args = (matches, pts, valid, q, t, cfg)
        out = icp_cuda.linearize(*args, g_dir=g_dir)
        again = icp_cuda.linearize(*args, g_dir=g_dir)
        ref = geo.linearize_with(*args, g_dir=g_dir)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"N={n}: two launches on the same inputs differ")
        for name in ("num_inlier", "status_counts", "loc_counts_rot",
                     "loc_counts_trans", "degenerate_rot",
                     "degenerate_trans"):
            check(torch.equal(getattr(out, name), getattr(ref, name)),
                  f"N={n}: {name} {getattr(out, name).tolist()} != plain "
                  f"{getattr(ref, name).tolist()}")
        check(int(out.num_inlier) > n // 2, f"N={n}: too few inliers")
        for name in ("H", "b"):
            o, r = getattr(out, name), getattr(ref, name)
            check(torch.allclose(o, r, **KERNEL_TOL),
                  f"N={n}: {name} differs from plain by "
                  f"{(o - r).abs().max().item()}")
        err = max((out.H - ref.H).abs().max().item(),
                  (out.b - ref.b).abs().max().item())
        ms = cuda_ms(lambda: icp_cuda.linearize(*args, g_dir=g_dir))
        plain_ms = cuda_ms(lambda: geo.linearize_with(*args, g_dir=g_dir))
        dev_ms, enq_ms = kernel_only_ms(*args)
        results[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          inliers=int(out.num_inlier))
        print(f"[kernel] N={n}: counts/flags exact, bitwise repeatable, "
              f"max |dH|,|db| = {err:.3e}; wrapper {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 50 calls); the three kernels "
              f"alone {1e3 * dev_ms:.2f} us device time a call (profiler), "
              f"{1e3 * enq_ms:.2f} us a call back-to-back (host clock); "
              f"inliers {int(out.num_inlier)}", flush=True)
    return results


def replay_timed(s, data, ks, imu_i=0):
    """Feed scans ``ks`` in event order, synchronizing after each: returns
    (host ms of each scan's IMU feed and step, next IMU index)."""
    from mimosa_tpu_torch.io.synthetic_replay import feed

    ms = []
    for k in ks:
        t0 = time.perf_counter()
        imu_i = feed(s, data, k, imu_i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, imu_i


def device_busy_ms(prof):
    """Union of the device intervals (kernels, copies) a profile recorded,
    in ms, and their number."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def slice_phase(dev):
    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh
    from mimosa_tpu_torch.ops import icp_cuda

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=4.0),
                        syn.LidarModel(n_rows=64, n_cols=512), seed=0)
    s = seq.Sequencer(
        seq.SequencerConfig(max_scan_points=32768, n_geo_points=8192,
                            n_map_points=8192, n_gn_iters=3,
                            max_trajectory=1024, quantize_transfer=False,
                            geo_leaf=0.4, map_insert_leaf=0.15),
        win.WindowConfig(K=8),
        vh.VoxelMapConfig(capacity_log2=18, leaf_size=0.4,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0),
        device=dev)
    n_scans = len(data["scans"])
    n_prof = 3                # the last scans run under the profiler
    torch.cuda.reset_peak_memory_stats()
    icp_cuda.LAUNCHES = 0
    ms, imu_i = replay_timed(s, data, range(n_scans - n_prof))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = replay_timed(s, data, range(n_scans - n_prof, n_scans),
                                  imu_i)
    launches = icp_cuda.LAUNCHES
    steps = s.scan_idx
    want = (s.cfg.n_gn_iters + 1) * steps
    check(steps > 20, f"only {steps} scan steps ran")
    check(launches == want, f"ICP kernel launched {launches} times in "
          f"{steps} scan steps, expected {want}")
    traj = np.asarray([p for _, p, _ in s.trajectory])
    check(np.isfinite(traj).all(), "non-finite poses")
    ate = trajectory_ate(s, data)
    check(ate < ENTRY_ATE_GATE, f"entry-width ATE {ate:.4f} m >= "
          f"{ENTRY_ATE_GATE}")
    steady = ms[5:]           # after the first 5 scans (init included)
    med = statistics.median(steady)
    p90 = float(np.percentile(steady, 90))
    busy, n_dev = device_busy_ms(prof)
    check(n_dev > 0, "the profiler saw no device work in the scan steps")
    busy_scan = busy / n_prof
    print(f"[slice] entry widths: {steps} scan steps + init, ICP kernel "
          f"launches {launches} (= {s.cfg.n_gn_iters + 1} x {steps}), ATE "
          f"{ate:.5f} m (gate {ENTRY_ATE_GATE}), ms/scan steady median "
          f"{med:.2f} p90 {p90:.2f} over {len(steady)} scans (first step "
          f"{ms[1]:.1f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)
    print(f"[slice] profiled last {n_prof} scans: {n_dev / n_prof:.0f} device "
          f"ops and {busy_scan:.2f} ms device busy per scan, host "
          f"{statistics.median(ms_prof):.2f} ms/scan under the profiler; "
          f"device idle {100 * (1 - busy_scan / med):.1f}% of the unprofiled "
          f"median scan", flush=True)
    return launches


def room_clean_phase():
    from mimosa_tpu_torch.io import synthetic_replay

    out = synthetic_replay.run(device="cuda", verbose=False)
    rate = out["n_scans"] / out["wall"]
    check(out["ate"] < ROOM_CLEAN_ATE_GATE, f"room_clean ATE "
          f"{out['ate']:.4f} m >= {ROOM_CLEAN_ATE_GATE}")
    print(f"[room_clean] ATE {out['ate']:.5f} m (gate "
          f"{ROOM_CLEAN_ATE_GATE}), {out['n_scans']} scans at {rate:.1f} "
          f"scans/s incl. first-call set-up", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from mimosa_tpu_torch import require_cuda
    from mimosa_tpu_torch.ops import icp_cuda

    dev = require_cuda()
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    icp_cuda.build()
    secs, log = icp_cuda.build_info
    print(f"[build] {icp_cuda.SOURCE.name} -> {icp_cuda.BUILD_DIR} in "
          f"{secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    timings = kernel_phase(dev)
    launches = slice_phase(dev)
    room_clean_phase()

    main_n = 8192
    rec = dict(name="icp_linearize", route="cuda",
               source="mimosa_tpu_torch/csrc/icp_linearize.cu",
               replaces="mimosa_tpu/ops/icp_pallas.py:169",
               launches=launches,
               max_abs_err=timings[main_n]["max_abs_err"],
               ms=timings[main_n]["ms"], plain_ms=timings[main_n]["plain_ms"])
    print(json.dumps({"kernels": [rec]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
