#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --stage-split   # only the per-stage split (11.)
    python3 chip_smoke.py --chunk-graph   # only the chunk-graph design (12.)
    python3 chip_smoke.py --mesh          # only 4.'s captured run and 15.
    python3 chip_smoke.py --viz           # 16. and 17. with what they read

Drives the port (``mimosa_tpu_torch``) through its main paths on the card
and prints one line per phase; any failure raises, so the exit code is
non-zero. It needs a CUDA device, ``nvcc`` and ``g++``; it imports nothing
of JAX or of the JAX package.

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``mimosa_tpu_torch/csrc/*.cu`` with nvcc for sm_90a and
   the host scan pack (``mimosa_tpu_torch/native``) with g++ into
   ``build/mimosa_tpu_torch/``;
3. kernel: the ICP linearization (one cluster launch a call) against its
   plain PyTorch version on a synthetic room scene at N = 8192, 4096 and
   4133 (status and localizability counts and flags exact, H and b to
   rtol 2e-4 / atol 2e-2, two launches bitwise equal, 4-DoF on, rotation
   threshold != translation threshold), the kernel's eigen-analysis
   against torch eigh3 in f64 on the kernel's own blocks (eigenvalues
   within 1e-4 max|lambda|, eigenvectors |v . v_ref| >= 1 - 1e-4), the
   median time of each over 50 calls (CUDA events), the wrapper's host
   time a call back to back, the device kernels and device time a call
   (profiler: one kernel a call), and the SM clocks of the kernel's
   phases (its optional trace, median of 50 launches); then the
   conditional node's predicate kernel (``csrc/graph_cond.cu``) against
   its plain version, the predicate read on the host: a captured step
   whose node doubles a [8192, 3] tensor gives the host branch's bits with
   the predicate false and true, and its time with the predicate false
   against the host read;
4. slice: the Sequencer at the widths of ``__graft_entry__.entry()``
   (32768 points a scan, 8192 ICP points, K=8, 2^18 voxels, f32 codec) on
   a room sequence from a 64x512 LiDAR, twice in one process: with the
   scan step captured as CUDA graphs (the default; the main path, whose
   ICP launches the kernel record counts) and op by op (``eager=True``).
   Each: finite poses, ATE < 0.08 m, the ICP kernel launched
   (n_gn_iters + 1) times per scan step (the wrappers' count, and the
   kernels the profiler sees run in the last scans), ms a scan (median,
   p90) and the device's busy and idle share (profiler over the last
   scans); then the
   largest position gap between the two trajectories (< 0.01 m);
5. photo: the geometric + photometric (PG-LIO) Sequencer at Ouster OS-1-64
   widths (a 64x1024 LiDAR, 65,536 points a scan shipped with intensity,
   every 4th lane to geometry, 8192 ICP points, 2^19 voxels, K=8, a
   64-feature store) on bench.py's 30 x 16 x 6 m room, 4 s with IMU and
   range noise 0.01, captured (this slice's main path) and eager in one
   process: the checks and numbers of 4. (ATE < 0.08 m) plus the
   photometric factor tracking features on every step after the second
   (debug slot 12: median and minimum), and, from the eager run's last
   scans, the device time and device ops a scan of the photometric stages
   (frame build, the 4 linearizations, lifecycle + detection) in profiler
   ranges;
6. multimodal: the four-modality stream at the widths of 4. (the 4 s
   room from a 64x512 LiDAR, K=8, f32 codec) with 20 Hz radar frames of
   512 targets and 10 Hz odometry, their clocks 15 ms out of phase with
   the LiDAR's, and the late and re-ordered arrivals of
   ``synthetic_replay.four_modality_stream`` (one radar frame in four
   60 ms late, every sixth scan delivered again 150 ms late, two swapped
   scans, a same-key duplicate, odometry right after a scan, an odometry
   outage), captured (this slice's main path) with a synchronize after
   each event: ATE < 0.08 m, every late path taken (``MM_COUNTERS``),
   every step variant (``MM_VARIANTS``) run and captured once, the ICP
   kernel launched (n_gn_iters + 1) times per scan step in order and late
   (the count, and the kernels the profiler sees in a stretch of 14 events
   around the second swapped scan), host ms an event by kind (median,
   p90), device ms and ops an event by kind (profiler ranges over that
   stretch), the device's idle share, wall seconds per sensor second and
   the peak device memory; then eager, in the same process, over the
   shortest prefix of the stream in which the captured run ran every
   variant: every variant run, the ICP launches, ATE < 0.08 m, and the
   captured positions over the prefix within 0.01 m of the eager ones;
7. scoreboard: the rows of the JAX package's synthetic scoreboard on the
   card, with the settings and gates of ``scripts/dataset_evaluation.py``:
   through ``mimosa_tpu_torch.io.synthetic_replay.run`` room_clean (int16
   codec, < 0.010 m), room_noisy, room_range_codec, fast_spin,
   room_photometric (< 0.08 m), corridor_geo_proj (< 3.0 m) and
   corridor_pglio (< 0.80 m); streamed event by event dropout_ooo
   (< 0.080 m) and the corridor with 20 Hz radar through ``add_radar``
   (< 0.20 m, the gate of the JAX package's bulk corridor_radar_bulk row),
   printed beside corridor_geo_proj. Each row's RTE against its ground
   truth (``utils/evaluation.rte``, over every 10 m of path) under the
   reference's RTE gate: 0.5% the room rows and dropout_ooo, 1.0%
   fast_spin, 5.0% corridor_pglio, 2.0% the corridor with radar; but
   corridor_geo_proj, whose RTE is printed beside its 40% gate and the JAX
   package's own values, not gated (``GEO_PROJ_RTE``);
9. online: the online estimator (``io.online.OnlineEstimator``, scans staged on
   the pushing thread, the default backlog bound of 8) around the
   entry-width Sequencer on the 4 s room: scans pushed with a flush each
   until every step variant is captured, then the rest in real time (each
   IMU sample and each scan when the wall clock reaches its arrival, a
   scan 10 ms after its end): push_imu host us (median, p99), push to the
   scan's on_state ms (median, p90), scans dropped (0), rebases,
   propagated outputs, ICP launches and graph replays, no ERROR record
   from the worker, ATE < 0.08 m, and the trajectory within 1e-6 m of the
   same Sequencer fed the worker's event order offline, captured;
8. bulk: the offline bulk scheduler (``Sequencer.add_bulk``): (a) at
   bench.py's geometric bulk widths (an OS-0-128 128x1024 LiDAR thinned 4x
   at pack time, 8192 ICP points, K=8, 2^19 voxels, int16 codec) on
   bench.py's 9 s room: the first 20 scans streamed, the rest in chunks of
   32 (bench.py's replay_once_bulk) and the last 4 in one chunk under the
   profiler, against the same configuration streamed scan by scan with
   the merged slide (staged one ahead): warm scans/s of both with one
   synchronize at the end, chunks run, events in chunks and streamed, the
   pack, copy and dispatch ms a chunk, the device's busy ms a scan and its
   idle share over the bulk stretch, peak device memory, ICP launches
   (n_gn_iters + 1 a scan step, the count and the profiler's), ATE
   < 0.08 m and the position gap to streaming < 1e-6 m (the same bits);
   (b) mixed chunks at entry widths (``synthetic_replay.bulk_stream``: 20
   Hz radar of 512 targets, 10 Hz odometry, radar frames and odometry
   messages that attach to a scan's state), chunks of 8, against the same
   events streamed with the merged slide: a gap < 1e-6 m, equal counters,
   state_ts and _traj_src, and every event code (scan, radar declare and
   attach, odometry declare and attach) inside a chunk; (c) the
   corridor_radar_bulk row through ``add_bulk`` in chunks of 16 (ATE
   < 0.20 m, RTE < 2.0%, the reference's gates), printed beside the JAX
   package's bulk row and the streamed row of 7.;
10. replay: the bag CLI at OS-1-64 widths: the photometric phase's 4 s
   noisy room (65,536 points a scan) with its IMU and 20 Hz radar frames
   in a bag from the port's writer, its ground truth as a TUM file and a
   YAML config (the JAX bag CLI test's parameters, the photometric
   namespace, the radar manager); ``io.replay.replay_bag`` in this process
   (scans and radar frames consumed, ICP launches, replays, ms a scan,
   ATE < 0.08 m, RTE printed: undefined on a path under 10 m), the same
   bag through ``replay_bag(bulk=True)`` in this process (ms a scan, ATE
   < 0.08 m, the same counters), then
   ``python -m mimosa_tpu_torch.io.replay`` as a subprocess on the same
   files with a debug stream of every scan (``--debug-stream
   --stream-every 1``), which must exit 0 with the same ATE line and TUM
   file, and whose stream 16.(b) holds against the in-process run;
13. refine: the offline refinement (a Sequencer with ``freeze_map`` started
   from a copy of another's map, ``init_map``; ``graph/refine.smooth`` over
   ``parallel/window_shard``): (a) the scoreboard's room_noisy_two_pass
   and room_noisy_smooth (``scripts/dataset_evaluation.py:278-281``)
   through ``synthetic_replay.run(two_pass=True[, smooth=True])``,
   captured: ATE < 0.080 m and RTE < 0.5% (the smoothed trajectory's for
   room_noisy_smooth) beside the JAX package's values and this run's
   one-pass room_noisy; each pass's map digest before its first scan and
   after its last and its keyframes' after its first and its last: pass 2
   starts from pass 1's final map and leaves it and its keyframe
   unchanged, pass 1's map is unchanged, the two share no storage; pass
   2's ICP launches (n_gn_iters + 1 a scan step) and the profiler's count
   over its last 3 scan steps; ms a scan of each pass (synchronized); the
   smoother's K0, host seconds and peak device memory; (b) the replay
   phase's bag through ``replay_bag(two_pass=True, smooth=True)`` in this
   process, with ``bulk=True`` (pass 2 within 1e-6 m of streamed pass 2),
   and the CLI with ``--two-pass --smooth --out`` as a subprocess (exit 0,
   its ATE lines and smoothed TUM file equal to the in-process run's);
   pass 2's and the smoothed ATE < 0.08 m; the smoother alone: K0 by row
   kind, host seconds, device busy (profiler), peak device memory, the
   same bits as the replay's call; (c) the smoother on the CPU on the same
   inputs: positions within 1e-4 m of the card's;
14. rescue: the tracking-loss rescue and rematch-on-motion
   (``SequencerConfig.rescue_enabled``, ``rematch_on_motion``): (a) the
   entry-width Sequencer with rescue (radius 2.5 map leaves) on a 5 s
   room, its whole window shifted by ~2.5 leaves in x and y before scan
   15 (tests/test_rescue.py's kick), captured and eager: slot 16 set on
   the same scans, positions within 0.01 m, the tail ATE (the 8 states
   after the kick left out) under 0.10 m, and over scans 13-16 the ICP
   launches counted (the conditional node's body counts its launches on
   the device) equal to the code's, n_gn_iters + 1 a scan and 14 x 3 +
   n_gn_iters more on a rescued one, with the profiler's records named for
   the kernel printed beside them (not gated: inside a conditional node's
   body the profiler misnames kernels and loses records), and each scan's
   device ms and ops (the rescued one beside the steady ones); (b) the same room
   unkicked, captured, rescue off then on: slot 16 never set, positions
   within 1e-6 m, ms and device ms / ops a steady scan of each (the
   node's cost); (c) room_noisy's Sequencer with ``rematch_on_motion``,
   captured (ATE < 0.080 m, RTE < 0.5%) against rematch off (ms and
   device ms / ops a steady scan), and eager over its first 20 scans
   (within 0.01 m of the captured run there); (d) (a)'s kicked stream
   through ``add_scans_bulk`` against merged streaming, both captured:
   the rescued scans equal, positions within 1e-6 m;
15. mesh: ``Sequencer(mesh=...)`` (``parallel/sharded.py``) on a world of
   one NCCL rank on this card (a hash store, ``make_mesh(n_mp=1)``; the
   group destroyed after the phase), its all-reduces recorded into the
   captured scan graphs and into the rescue's conditional node: (a) 4.'s
   entry-width room on the mesh, captured (4.'s numbers and checks, and
   the NCCL kernels the profiler sees) against eager over its first 10
   scans (< 0.01 m) and against 4.'s single-device captured run (< 0.05 m,
   the JAX package's structural bound: the mesh matches afresh every GN
   iteration), with ms, device ms and device ops a scan of both, the
   sharding tax; (b) 6.'s four-modality stream on the mesh, captured (6.'s
   numbers and checks: every late path, ATE < 0.08 m; radar through the
   dp-split linearization); (c) 14.(a)'s kicked stream on the mesh,
   captured and eager over its first 17 scans: the kicked scan rescued,
   the same flags and positions within 0.01 m, the tail ATE < 0.10 m, and
   over scans 13-16 the ICP launches counted equal to the code's
   (n_gn_iters + 1 a scan, 14 x 3 + n_gn_iters more on a rescued one: the
   candidates one after another), with the profiler's records named for
   the kernel printed beside them (inside a conditional node's body the
   profiler names some ~1.2 us kernels as the ICP kernel, whatever the
   run; the count is not held against it there); (d) the scoreboard's
   room_clean and room_noisy each through a Sequencer of its own, then
   both through one ``step_cache`` fed scan by scan in turns: the same
   bits, and fewer graphs captured;
16. viz: ``io.viz`` at full width: (a) ``icp_snapshot(max_points=8192)``
   on 4.'s captured Sequencer and its last scan: exactly one ICP kernel
   launch by the count, its result against the plain ``linearize_with``
   on the card on the same inputs (``viz.snapshot_inputs``; counts and
   flags exact, H and b to rtol 2e-4 / atol 2e-2), the inlier mask's sum
   the inlier count, unit normals, the median |p_w - foot| under 0.1 m,
   host ms a snapshot; (b) in 10., the CLI's debug stream of every scan
   against the in-process run: one line a scan step, each line's pose the
   TUM row of its time at the line's rounding, its ICP, degeneracy and
   photometric slots the in-process debug records, the last line's scan
   counters the final ones; (c) 9.'s live driver again with a debug stream
   of every scan: 9.'s gates (no drop, no ERROR record, ...), one line a
   scan step, push to on_state ms beside 9.'s; (d) the feature overlay's
   device arrays (``viz.feature_overlay_arrays``) at 64x1024 on 5.'s
   captured Sequencer, card against a CPU twin: feature centers within
   1e-3 px, the masks equal; (e) ``linearize_binary`` at N = 8192 on
   (a)'s map and points, card against CPU (counts exact, H, b and mean |r|
   to the gate of 3.), and at an identity target its source block against
   the ICP kernel's H and b (the same gate);
17. ouster: the exact Ouster photometric model at OS-1-64 widths: 5.'s
   room (4 s, its noise) from ``synthetic.generate_ouster`` with 64 rows
   at 5.'s beam altitudes, 1024 columns and a per-row shift table from a
   seeded generator (``tests/test_bulk.py:143-145``), in the Ouster sensor
   frame (``synthetic.ouster_sensor_frame``: the exact model's column
   convention), through 5.'s Sequencer with ``exact_ouster`` at that table,
   captured: ``add_scans_bulk`` in chunks of 16 against merged streaming,
   ATE < 0.08 m and RTE printed, slot 12 above 0 on every step after the
   second, the same slot 12 and positions within 1e-6 m, ICP launches
   n_gn_iters + 1 a scan step by the count, ms a scan and warm scans/s of
   both over the last 16 scans;
11. with ``--stage-split`` and nothing else: the entry-width replay run
   eagerly with a device synchronize and a host clock around each stage of
   the scan step, printing host ms a scan step by stage (no JSON lines);
12. with ``--chunk-graph`` and nothing else: one CUDA graph recording a
   whole chunk of 32 scan steps at the widths of 8.(a), against the
   per-step replays the bulk scheduler makes and against streaming:
   capture seconds, graph memory, ms a chunk of each, device ms between
   steps, and whether they give the same bits (no JSON lines).
18. with ``--viz`` and nothing else: 5.'s captured run, 10., 4.'s
   captured run, 9., 16. and 17. (no JSON lines).

The last two lines are the card's nvidia-smi line and
``{"ok": true, "device": {...}}``; the line before them is the JSON record
of the kernels: the ICP kernel (launches on the entry-width, photometric,
four-modality, bulk, online, bag-replay, refinement, rescue and mesh
paths, each counted from 0 around its run, error, times and bound; the
snapshot's launches in 16.(a) and the exact-Ouster bulk run's in 17.) and
the conditional node's predicate kernel (its launches in 14.(a)'s
captured run);
the line before that the seconds each phase took.
"""

import bisect
import contextlib
import json
import logging
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = dict(rtol=2e-4, atol=2e-2)   # the JAX Pallas test's H/b gate
EIGVAL_TOL = 1e-4                          # of max |lambda|
EIGVEC_TOL = 1e-4                          # 1 - |v . v_ref|
# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s and
# f32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# flops the linearization needs: per point (world point 18, residual 8,
# |p| gate 11, R^T n 15, j_rot 9, weights 2, the 21 + 6 + 12 weighted and
# unweighted sums 117, sum |r| 2) and per inlier (6 projections of 3)
FLOPS_POINT = 182
FLOPS_INLIER = 30
ENTRY_ATE_GATE = 0.08                      # room_noisy's gate
PHOTO_ATE_GATE = 0.08                      # room_photometric's gate
# captured against eager at entry widths: the same kernels on the same
# inputs, so the capture must not move the estimate; 1 cm is the room_clean
# gate, and a last-bit difference grows to ~0.2 mm over a short replay (the
# CPU tests' JAX-against-port gap)
CAPTURE_GAP = 0.01
# the geometric rows of the JAX package's synthetic scoreboard
# (scripts/dataset_evaluation.py:149-163, 219-224, 275-292): name,
# synthetic_replay.run keywords, ATE gate [m], RTE gate [%] (None: printed
# beside the reference's gate, not gated)
NOISY = dict(imu_noise=0.01, range_noise=0.01)
CORRIDOR = dict(seed=0, imu_noise=0.01, range_noise=0.005)
SCOREBOARD = (
    ("room_clean", dict(), 0.010, 0.5),
    ("room_noisy", NOISY, 0.080, 0.5),
    ("room_range_codec", dict(range_transfer=True, **NOISY), 0.080, 0.5),
    ("fast_spin", dict(seed=0, tc=dict(t_total=8.0, yaw_rate=1.8,
                                       amp=(3.0, 1.6, 0.4),
                                       freq=(0.22, 0.31, 0.40)), **NOISY),
     0.080, 1.0),
    ("corridor_geo_proj", dict(project_degenerate=True, world="corridor",
                               tc=dict(t_total=8.0, amp=(4.0, 0.6, 0.3),
                                       center=(40.0, 2.0, 1.5),
                                       yaw_rate=0.15), **CORRIDOR), 3.0,
     None),
    # the photometric rows (scripts/dataset_evaluation.py:282-294)
    ("room_photometric", dict(use_photometric=True, **NOISY), 0.080, 0.5),
    ("corridor_pglio", dict(use_photometric=True, project_on_degeneracy=True,
                            project_degenerate=True, world="corridor",
                            tc=dict(t_total=8.0, amp=(4.0, 0.6, 0.3),
                                    center=(40.0, 2.0, 1.5), yaw_rate=0.15),
                            **CORRIDOR), 0.80, 5.0),
)
# corridor_geo_proj's RTE is printed beside the reference's gate (40%) and
# the JAX package's own values on this row, and not gated: the JAX package
# itself gives 41.98% on the CPU at seed 0 (ROADMAP.md section 3, fault 2)
# and 18.9% on the TPU (ACCURACY_r05.json), so one seed cannot hold the
# row to that gate
GEO_PROJ_RTE = ("gate 40%; the JAX package: 41.98% on the CPU, 18.9% on "
                "the TPU; not gated: the reference fails this gate on the "
                "CPU")
# the photometric slice's stages, timed by torch.profiler ranges in its
# eager run: (photometric function, range name)
PHOTO_STAGES = (("make_frame", "photo frame build"),
                ("linearize", "photo linearize"),
                ("update_lifecycle", "photo lifecycle + detect"),
                ("detect_features", "photo lifecycle + detect"))


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
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


def wrapper_profile(call, n_calls=200):
    """(device ms a call of the ICP kernel, ICP kernels the profiler
    recorded over n_calls calls, host-clock ms a call of n_calls
    back-to-back calls). Fails if the calls put any other work on the
    device."""
    from torch.profiler import ProfilerActivity, profile

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
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if "icp_" in e.name]
    check(len(kernels) == len(device), "the wrapper issued device work "
          f"besides its kernel: {sorted({e.name for e in device})}")
    # the profiler may drop a few records at the edges of its window, so
    # the count is held to at most one kernel a call (the three-launch
    # design gave three) and to most calls
    check(0.9 * n_calls <= len(kernels) <= n_calls, f"the profiler saw "
          f"{len(kernels)} ICP kernels in {n_calls} calls, expected one a "
          "call")
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return device_ms / len(kernels), len(kernels), host_ms


def eigen_check(out, f32):
    """(max |lambda - lambda_ref| / max |lambda_ref|, min |v . v_ref|) of the
    kernel's eigen-analysis against torch eigh3 in f64 on its own blocks."""
    from mimosa_tpu_torch.core.eigh3 import eigh3
    from mimosa_tpu_torch.ops import icp_cuda

    lam_err, dot_min = 0.0, 1.0
    for k, (lam, V) in enumerate(((out.eigvals_rot, out.eigvecs_rot),
                                  (out.eigvals_trans, out.eigvecs_trans))):
        lam_ref, V_ref = eigh3(icp_cuda.blocks(f32)[k].double())
        scale = max(lam_ref.abs().max().item(), 1e-30)
        lam_err = max(lam_err,
                      (lam.double() - lam_ref).abs().max().item() / scale)
        dots = (V.double() * V_ref).sum(0).abs()
        dot_min = min(dot_min, dots.min().item())
    return lam_err, dot_min


def kernel_trace(args, g_dir, n_runs=50):
    """Median SM clocks of each phase of the kernel over n_runs launches,
    from its optional trace: {phase: cycles}."""
    from mimosa_tpu_torch.ops import icp_cuda

    trace = torch.zeros(len(icp_cuda.TRACE_POINTS), dtype=torch.int64,
                        device=args[1].device)
    rows = []
    for _ in range(n_runs):
        icp_cuda.launch(*args, g_dir=g_dir, trace=trace)
        rows.append(trace.clone())
    t = torch.stack(rows).cpu()
    cycles = torch.cat([t[:, 1:] - t[:, :-1], t[:, -1:] - t[:, :1]], 1)
    med = cycles.double().median(0).values.tolist()
    return dict(zip(icp_cuda.TRACE_POINTS[1:] + ("entry to flags",), med))


def bound(n, n_inlier):
    """(least ms the card could take, what bounds it): each input read
    once (points, normals, means [N,3] f32, two byte masks, q, t, g_dir),
    each output written once (the three result buffers), and the flops
    this run's inliers need."""
    from mimosa_tpu_torch.ops import icp_cuda

    out_bytes = (4 * icp_cuda.SIZES[icp_cuda.F32]
                 + 4 * icp_cuda.SIZES[icp_cuda.I32]
                 + icp_cuda.SIZES[icp_cuda.U8])
    nbytes = n * (3 * 12 + 2) + 4 * (4 + 3 + 3) + out_bytes
    flops = FLOPS_POINT * n + FLOPS_INLIER * n_inlier
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


ICP_EXACT = ("num_inlier", "status_counts", "loc_counts_rot",
             "loc_counts_trans", "degenerate_rot", "degenerate_trans")


def icp_check(out, ref, what):
    """An ICPResult against its plain version: counts and flags exact, H
    and b within KERNEL_TOL."""
    for name in ICP_EXACT:
        check(torch.equal(getattr(out, name).cpu(), getattr(ref, name).cpu()),
              f"{what}: {name} {getattr(out, name).tolist()} != plain "
              f"{getattr(ref, name).tolist()}")
    for name in ("H", "b"):
        o, r = getattr(out, name).cpu(), getattr(ref, name).cpu()
        check(torch.allclose(o, r, **KERNEL_TOL), f"{what}: {name} differs "
              f"from plain by {(o - r).abs().max().item()}")
    return max((getattr(out, n).cpu() - getattr(ref, n).cpu()).abs().max()
               .item() for n in ("H", "b"))


def room_scene(dev, n_per=6000, noise=0.003, seed=0):
    """Room cloud (floor, ceiling, three walls) inserted into a port voxel
    map at leaf 0.4 — the scene of tests/test_icp.py. The map is built on
    the CPU, where its float sums have one order, so every run holds the
    kernel against its plain version on the same bits."""
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    rng = np.random.default_rng(seed)
    clouds = []
    for axis, val in [(2, 0.0), (2, 3.0), (0, 0.0), (0, 4.0), (1, 0.0)]:
        p = rng.uniform(0.2, 3.8, size=(n_per, 3))
        p[:, axis] = val + rng.normal(size=n_per) * noise
        clouds.append(p)
    pts = torch.tensor(np.concatenate(clouds), dtype=torch.float32)
    cfg = vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=16,
                            plane_min_points=5)
    m = vh.insert(vh.create(cfg, "cpu"), pts,
                  torch.ones(len(pts), dtype=torch.bool),
                  torch.zeros((), dtype=torch.int32), cfg)
    m = vh.update_planes(m, cfg)
    return type(m)(*(x.to(dev) for x in m)), cfg, pts.to(dev)


def kernel_phase(dev):
    from mimosa_tpu_torch.core import lie
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.ops import icp_cuda

    vmap, map_cfg, world = room_scene(dev)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
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
        bufs = icp_cuda.launch(*args, g_dir=g_dir)
        again = icp_cuda.launch(*args, g_dir=g_dir)
        out = icp_cuda.unpack(*bufs)
        ref = geo.linearize_with(*args, g_dir=g_dir)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(bufs, again)),
              f"N={n}: two launches on the same inputs differ")
        err = icp_check(out, ref, f"N={n}")
        check(int(out.num_inlier) > n // 2, f"N={n}: too few inliers")
        lam_err, dot_min = eigen_check(out, bufs[0])
        check(lam_err <= EIGVAL_TOL, f"N={n}: kernel eigenvalues differ from "
              f"torch eigh3 by {lam_err:.3e} of max |lambda|")
        check(dot_min >= 1 - EIGVEC_TOL, f"N={n}: a kernel eigenvector is "
              f"off torch eigh3's: |v . v_ref| = {dot_min:.8f}")

        def call():
            return icp_cuda.linearize(*args, g_dir=g_dir)

        ms = cuda_ms(call)
        plain_ms = cuda_ms(lambda: geo.linearize_with(*args, g_dir=g_dir))
        dev_ms, n_kernels, host_ms = wrapper_profile(call)
        phases = kernel_trace(args, g_dir)
        inliers = int(out.num_inlier)
        bound_ms, bound_by, nbytes = bound(n, inliers)
        results[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          device_ms=dev_ms, host_ms=host_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          inliers=inliers)
        print(f"[kernel] N={n}: counts/flags exact, bitwise repeatable, "
              f"max |dH|,|db| = {err:.3e}; eigen vs torch eigh3 (f64, own "
              f"blocks): max |dlambda| {lam_err:.3e} of max |lambda|, min "
              f"|v . v_ref| {dot_min:.9f}; wrapper {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 50 calls, CUDA events); "
              f"wrapper {host_ms:.4f} ms a call back to back (host clock); "
              f"{n_kernels} ICP kernels and no other device op in 200 calls, "
              f"{1e3 * dev_ms:.3f} us device time a kernel (profiler); bound {1e3 * bound_ms:.4f} us by "
              f"{bound_by} ({nbytes} B); inliers {inliers}", flush=True)
        print(f"[kernel] N={n} phases, median SM cycles of 50 traced "
              f"launches (us at the {mhz:g} MHz max SM clock): " + ", ".join(
                  f"{k} {c:.0f} ({c / mhz:.3f})" for k, c in phases.items()),
              flush=True)
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


def device_busy_ms(events):
    """Union of the device intervals (kernels, copies) among a profile's
    ``events``, in ms, and their number (the device-side spans of profiler
    ranges are not device work and do not count)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def entry_replay(**kw):
    """(Sequencer at the widths of ``__graft_entry__.entry()``, its 4 s
    room sequence from a 64x512 LiDAR); ``kw`` (``device``, ``eager``) as
    the Sequencer takes them, the default device where not given."""
    from mimosa_tpu_torch.io import synthetic as syn

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=4.0),
                        syn.LidarModel(n_rows=64, n_cols=512), seed=0)
    return entry_sequencer(**kw), data


def entry_sequencer(merge_marginalize=False, seq_kw=None, **kw):
    """The Sequencer at the widths of ``__graft_entry__.entry()`` with the
    room settings of ``synthetic_replay.run`` (and the merged slide with
    ``merge_marginalize``, other SequencerConfig settings in ``seq_kw``)."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    s = seq.Sequencer(
        seq.SequencerConfig(max_scan_points=32768, n_geo_points=8192,
                            n_map_points=8192, n_gn_iters=3,
                            max_trajectory=1024, quantize_transfer=False,
                            geo_leaf=0.4, map_insert_leaf=0.15,
                            merge_marginalize=merge_marginalize,
                            **(seq_kw or {})),
        win.WindowConfig(K=8),
        vh.VoxelMapConfig(capacity_log2=18, leaf_size=0.4,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0), **kw)
    check(s.device.type == "cuda", f"the Sequencer chose {s.device}")
    return s


def entry_run(eager):
    """One entry-width replay, captured or eager: its numbers, with the ICP
    launches counted from 0 over the replay."""
    s, data = entry_replay(eager=eager)
    check((s.graphs is None) == eager, "the Sequencer's capture setting")
    return slice_run("slice", "entry widths", s, data, ENTRY_ATE_GATE)


def range_device(prof, name):
    """(device ms, device ops, calls) of the profiler range ``name``: the
    kernels and copies launched inside it, nested ops included."""
    def ops(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in ops(c)]

    calls = [e for e in prof.events() if e.name == name
             and e.device_type == torch.autograd.DeviceType.CPU]
    ks = [k for e in calls for k in ops(e)]
    return sum(k.duration for k in ks) / 1e3, len(ks), len(calls)


@contextlib.contextmanager
def photo_ranges():
    """The photometric stages of the scan step inside ``torch.profiler``
    ranges (``PHOTO_STAGES``); only an eager step runs them."""
    from torch.profiler import record_function

    from mimosa_tpu_torch.lidar import photometric as ph

    def ranged(name, fn):
        def wrapper(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapper

    saved = [(f, getattr(ph, f)) for f, _ in PHOTO_STAGES]
    for f, name in PHOTO_STAGES:
        setattr(ph, f, ranged(name, getattr(ph, f)))
    try:
        yield
    finally:
        for f, fn in saved:
            setattr(ph, f, fn)


def slice_run(tag, label, s, data, ate_gate, stage_ranges=False):
    """Replay ``data`` through Sequencer ``s``, captured or eager as it was
    made: its numbers, with the ICP launches counted from 0 over the
    replay; the last scans run under the profiler (with the photometric
    stages in ranges where ``stage_ranges``)."""
    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate
    from mimosa_tpu_torch.ops import icp_cuda

    eager = s.graphs is None
    n_scans = len(data["scans"])
    n_prof = 3                # the last scans run under the profiler
    torch.cuda.reset_peak_memory_stats()
    icp_cuda.LAUNCHES = 0
    ms, imu_i = replay_timed(s, data, range(n_scans - n_prof))
    with (photo_ranges() if stage_ranges else contextlib.nullcontext()), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = replay_timed(s, data, range(n_scans - n_prof, n_scans),
                                  imu_i)
    launches = icp_cuda.LAUNCHES
    steps = s.scan_idx
    want = (s.cfg.n_gn_iters + 1) * steps
    events = prof.events()
    name = "eager" if eager else "captured"
    check(steps > 20, f"{name}: only {steps} scan steps ran")
    check(launches == want, f"{name}: ICP kernel launched {launches} times "
          f"in {steps} scan steps, expected {want}")
    # the count above is bookkeeping under replay (a capture records the
    # launches and the replays add them); the profiler sees the kernels the
    # card ran in the last scans
    ran = sum(1 for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    want_ran = (s.cfg.n_gn_iters + 1) * n_prof
    check(ran == want_ran, f"{name}: the profiler saw {ran} ICP kernels run "
          f"in the last {n_prof} scan steps, expected {want_ran}")
    traj = np.asarray([p for _, p, _ in s.trajectory])
    check(np.isfinite(traj).all(), f"{name}: non-finite poses")
    ate = trajectory_ate(s, data)
    check(ate < ate_gate, f"{name}: {label} ATE {ate:.4f} m >= {ate_gate}")
    steady = ms[5:]           # after the first 5 scans (init included)
    busy, n_dev = device_busy_ms(events)
    check(n_dev > 0, f"{name}: the profiler saw no device work")
    nccl = sum(1 for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" in e.name.lower())
    out = dict(name=name, launches=launches, ran=ran, steps=steps, ate=ate,
               s=s, data=data, nccl=nccl / n_prof,
               med=statistics.median(steady),
               p90=float(np.percentile(steady, 90)), first=ms[1:5],
               busy=busy / n_prof, n_dev=n_dev / n_prof,
               prof_ms=statistics.median(ms_prof), traj=traj,
               mem=torch.cuda.max_memory_allocated() / 2**20,
               captures=None if eager else s.graphs.captures)
    out["idle"] = 100 * (1 - out["busy"] / out["med"])
    print(f"[{tag}] {name}, {label}: {steps} scan steps + init, ICP "
          f"kernel launches {launches} (= {s.cfg.n_gn_iters + 1} x {steps}), "
          f"ATE {ate:.5f} m (gate {ate_gate}), ms/scan steady median "
          f"{out['med']:.2f} p90 {out['p90']:.2f} over {len(steady)} scans "
          f"(steps 1-4: {', '.join(f'{m:.1f}' for m in out['first'])}); "
          f"peak device memory {out['mem']:.0f} MiB"
          + ("" if eager else f"; {out['captures']} graphs captured"),
          flush=True)
    print(f"[{tag}] {name}, profiled last {n_prof} scans: {ran} ICP kernels "
          f"ran on the card (= {s.cfg.n_gn_iters + 1} x {n_prof}), "
          f"{out['n_dev']:.0f} device ops and {out['busy']:.2f} ms device "
          f"busy per scan, host {out['prof_ms']:.2f} ms/scan under the "
          f"profiler; device idle {out['idle']:.1f}% of the unprofiled "
          f"median scan", flush=True)
    if s.photo_cfg is not None:
        # the photometric factor tracks features on every step after the
        # second (the first detects, the second tracks what it found)
        tracked = s.debug_records()[2:, 12]
        check((tracked > 0).all(), f"{name}: the photometric factor tracked "
              f"no feature on a steady step: {tracked.tolist()}")
        out["tracked"] = tracked
        print(f"[{tag}] {name}: photometric features tracked a step (debug "
              f"slot 12, steps 3-{steps}): median "
              f"{statistics.median(tracked):.0f}, min {tracked.min():.0f} "
              f"of {s.photo_cfg.num_features}", flush=True)
    if stage_ranges:
        out["stages"] = {}
        for rname in dict.fromkeys(n for _, n in PHOTO_STAGES):
            dev_ms, n_ops, calls = range_device(prof, rname)
            check(calls > 0 and n_ops > 0, f"no device work in {rname}")
            out["stages"][rname] = (dev_ms / n_prof, n_ops / n_prof,
                                    calls / n_prof)
        print(f"[{tag}] {name}, photometric stages a scan (profiler ranges "
              f"over the last {n_prof} scans): " + ", ".join(
                  f"{k} {v[0]:.3f} ms device in {v[1]:.0f} device ops "
                  f"({v[2]:.0f} calls)" for k, v in out["stages"].items()),
              flush=True)
    return out


def captured_vs_eager(tag, cap, eag):
    """Hold a captured run against the eager run of the same replay: the
    largest position gap under CAPTURE_GAP. Returns the captured run's ICP
    launches and the ICP kernels the profiler saw run in its last scans."""
    check(cap["traj"].shape == eag["traj"].shape, "trajectory lengths differ")
    gap = float(np.abs(cap["traj"] - eag["traj"]).max())
    check(gap < CAPTURE_GAP, f"{tag}: captured and eager positions differ "
          f"by {gap:.4f} m")
    print(f"[{tag}] captured vs eager: ms/scan median {cap['med']:.2f} vs "
          f"{eag['med']:.2f} ({eag['med'] / cap['med']:.1f}x), device idle "
          f"{cap['idle']:.1f}% vs {eag['idle']:.1f}%, ATE {cap['ate']:.5f} vs "
          f"{eag['ate']:.5f} m, largest position gap {gap:.2e} m (gate "
          f"{CAPTURE_GAP})", flush=True)
    return cap["launches"], cap["ran"]


def slice_phase():
    """The entry-width replay captured (the main path) and then eager, in
    one process (:func:`captured_vs_eager`). Returns the captured run's ICP
    launches, the profiler's ICP kernels and the captured run."""
    cap = entry_run(eager=False)
    return (*captured_vs_eager("slice", cap, entry_run(eager=True)), cap)


# bench.py's trajectory, 4 s
PHOTO_TC = dict(t_total=4.0, amp=(6.0, 3.0, 0.8), center=(12.0, 8.0, 2.0))


def photo_data():
    """The photometric slice's sequence: bench.py's room (30 x 16 x 6 m) and
    trajectory, 4 s, IMU and range noise 0.01, from an Ouster OS-1-64
    sized LiDAR (64 x 1024, 65,536 points a scan)."""
    from mimosa_tpu_torch.io import synthetic as syn

    return syn.generate(
        syn.room_world(lx=30.0, ly=16.0, lz=6.0),
        syn.TrajectoryConfig(**PHOTO_TC),
        syn.LidarModel(n_rows=64, n_cols=1024), seed=0, imu_noise=0.01,
        range_noise=0.01)


def photo_sequencer(eager, seq_kw=None, photo_kw=None):
    """The geometric + photometric Sequencer with bench.py's photometric
    settings (bench.py:79-83, 109-148): the full cloud shipped (int16 codec
    with the intensity column, point_skip 1) and every 4th lane to
    geometry, 8192 ICP points, 2^19 voxels, K=8, and the photometric
    configuration at the LiDAR's 64 x 1024 image with the FIR line removal
    and brightness flattening on (other SequencerConfig and
    PhotometricConfig settings in ``seq_kw`` and ``photo_kw``)."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.lidar import photometric as ph
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    lm = syn.LidarModel(n_rows=64, n_cols=1024)
    s = seq.Sequencer(
        seq.SequencerConfig(max_scan_points=lm.n_rows * lm.n_cols,
                            point_skip=1, geo_skip=4, n_geo_points=8192,
                            n_map_points=16384, geo_leaf=0.5,
                            map_insert_leaf=0.2, keyframe_trans_thresh=0.3,
                            keyframe_rot_thresh=0.15, n_gn_iters=3,
                            max_trajectory=1024, **(seq_kw or {})),
        win.WindowConfig(K=8),
        vh.VoxelMapConfig(leaf_size=0.5, capacity_log2=19,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig(),
        ph.PhotometricConfig(rows=lm.n_rows, cols=lm.n_cols,
                             fov_up=lm.fov_up, fov_down=lm.fov_down,
                             range_min=0.5, range_max=60.0,
                             gradient_threshold=2.0, nma_radius=5,
                             num_features=64, margin=3, intensity_scale=1.0,
                             **(photo_kw or {})),
        eager=eager)
    check(s.device.type == "cuda", f"the Sequencer chose {s.device}")
    check((s.graphs is None) == eager, "the Sequencer's capture setting")
    return s


def photo_phase():
    """The geometric + photometric slice at 64 x 1024 captured (the main
    path) and then eager in one process (:func:`captured_vs_eager`), the
    eager run's last scans with the photometric stages in profiler
    ranges. Returns the captured run's ICP launches, the profiler's ICP
    kernels and the captured run."""
    t0 = time.perf_counter()
    data = photo_data()
    print(f"[photo] {len(data['scans'])} scans of "
          f"{len(data['scans'][0]['points'])} points generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    label = "64x1024 photometric"
    cap = slice_run("photo", label, photo_sequencer(False), data,
                    PHOTO_ATE_GATE)
    eag = slice_run("photo", label, photo_sequencer(True), data,
                    PHOTO_ATE_GATE, stage_ranges=True)
    return (*captured_vs_eager("photo", cap, eag), cap)


# the four-modality phase's event kinds, as the host sorts an event before
# it runs (a late one is no newer than the newest state)
MM_KINDS = ("scan", "radar", "odometry", "ooo scan", "ooo radar")
# the step variants that stream runs (radar and odometry keys also carry
# their configuration)
MM_VARIANTS = {("scan", False, True), ("scan", False, False), ("scan_ooo",),
               ("marginalize",), ("declare",), ("radar", "declare"),
               ("radar", "attach"), ("radar", "samekey"), ("radar", "ooo"),
               ("odom", True), ("odom", False)}
# late paths each of which the stream must take
MM_COUNTERS = ("radar_ooo_inserted", "radar_ooo_samekey", "scans_ooo_inserted",
               "scans_ooo_samekey", "scans_same_key", "odom_anchor")


def mm_stream():
    """The four-modality stream at entry widths: the 4 s room from a 64x512
    LiDAR (the radar and odometry clocks 15 ms out of phase with it), 20 Hz
    radar frames of 512 targets (``RADAR_BULK_PAD``; some fail the cone
    gates), 10 Hz odometry, and the late and re-ordered arrivals of
    ``synthetic_replay.four_modality_stream``."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import four_modality_stream

    return four_modality_stream(
        syn.TrajectoryConfig(t_total=4.0, t_stationary=1.23),
        syn.LidarModel(n_rows=64, n_cols=512), n_targets=512)


def mm_kind(s, event):
    """The event's kind in ``MM_KINDS``, from the host state before it."""
    from mimosa_tpu_torch.graph.sequencer import Sequencer

    _, kind, m = event
    if kind == "odom":
        return "odometry"
    t = Sequencer._scan_t_end(m) if kind == "scan" else m["ts"]
    late = s.initialized and t <= s.last_state_ts
    return ("ooo " if late else "") + kind


def variant(key):
    return key[:2] if key[0] in ("radar", "odom") else key


def busy_by_range(events, names):
    """{name: [device ms, device ops, calls]} of the profiler ranges
    ``names`` among a profile's ``events``: the device work that started
    inside each range (each ends in a synchronize, so a range holds its
    event's device work)."""
    CPU, CUDA = (torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA)
    rngs = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == CPU and e.name in names)
    starts = [r[0] for r in rngs]
    out = {n: [0.0, 0, 0] for n in names}
    for r in rngs:
        out[r[2]][2] += 1
    for e in events:
        if e.device_type != CUDA or getattr(e, "is_user_annotation", False):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= rngs[i][1]:
            out[rngs[i][2]][0] += e.time_range.elapsed_us() / 1e3
            out[rngs[i][2]][1] += 1
    return out


def step_variants(s):
    """The step variants Sequencer ``s`` has run (its step cache's keys),
    as ``variant`` names them."""
    return {variant(k[2:]) for k in s._step_cache if k[1] == "step"}


def mm_run(eager, data, events, mesh=None, tag="multimodal", upto=None):
    """The four-modality stream through the entry-width Sequencer, captured
    or eager, with a synchronize after each event: ms per event by kind
    (an event that ran a variant's warm-up or capture counted apart), and
    a profiled stretch around the second swapped scan's insertion with
    each event in a profiler range named by its kind. ``mesh``: the
    Sequencer on that mesh (the lines then tagged ``tag``). ``upto``: only
    the first ``upto`` events, with no profiled stretch, and every variant
    of ``MM_VARIANTS`` run in them in place of every late path taken; the
    run's ``first`` holds the event at which each variant first ran."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mimosa_tpu_torch.io.synthetic_replay import (feed_event,
                                                      trajectory_ate)
    from mimosa_tpu_torch.ops import icp_cuda

    s = entry_sequencer(eager=eager, mesh=mesh)
    name = "eager" if eager else "captured"
    check((s.graphs is None) == eager, "the Sequencer's capture setting")
    if upto is not None:
        events = events[:upto]
        name += f" over the first {upto} events"
    # the stretch: the later of the two swapped scans (n/2 + 3), arriving
    # after its successor, and the events around it
    sc = data["scans"][len(data["scans"]) // 2 + 3]
    late = next((i for i, (t, _, m) in enumerate(events)
                 if m is sc and t > s._scan_t_end(sc)), None)
    w0, w1 = (-1, -1) if upto is not None else (late - 8, late + 6)
    torch.cuda.reset_peak_memory_stats()
    icp_cuda.LAUNCHES = 0
    rows, imu_i, prof, first = [], 0, None, {}
    for i, ev in enumerate(events):
        if i == w0:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            launches0, steps0 = icp_cuda.LAUNCHES, s.scan_idx
        kind = mm_kind(s, ev)
        g0 = None if eager else (len(s.graphs.warm), s.graphs.captures)
        ready = s.initialized
        t0 = time.perf_counter()
        with record_function(kind) if w0 <= i < w1 \
                else contextlib.nullcontext():
            imu_i = feed_event(s, data, ev, imu_i)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        setup = not eager and g0 != (len(s.graphs.warm), s.graphs.captures)
        rows.append((kind, ms, setup, ready, ev[0], w0 <= i < w1))
        for v in step_variants(s) - set(first):
            first[v] = i
        if i == w1 - 1:
            prof.__exit__(None, None, None)
            ran_launches = icp_cuda.LAUNCHES - launches0
            win_steps = s.scan_idx - steps0
    launches, steps = icp_cuda.LAUNCHES, s.scan_idx
    n1 = s.cfg.n_gn_iters + 1
    check(launches == n1 * steps, f"{name}: ICP kernel launched {launches} "
          f"times in {steps} scan steps (in order and late), expected "
          f"{n1 * steps}")
    check(set(first) == MM_VARIANTS, f"{name}: the stream ran the variants "
          f"{sorted(first, key=str)}")
    traj = np.asarray([p for _, p, _ in s.trajectory])
    check(np.isfinite(traj).all(), f"{name}: non-finite poses")
    if upto is not None:
        ate = trajectory_ate(s, data)
        check(ate < ENTRY_ATE_GATE, f"{name}: four-modality ATE {ate:.4f} "
              f"m >= {ENTRY_ATE_GATE}")
        ms_ev = [r[1] for r in rows if r[3] and not r[2]]
        print(f"[{tag}] {name}: {steps} scan steps, every variant run "
              f"(first at event " + ", ".join(
                  f"{v} {i}" for v, i in sorted(first.items(), key=str))
              + f"), ICP kernel launches {launches} (= {n1} x {steps}), ATE "
              f"{ate:.5f} m (gate {ENTRY_ATE_GATE}), host ms an event "
              f"(synchronized) median {statistics.median(ms_ev):.2f}",
              flush=True)
        return dict(name=name, launches=launches, steps=steps, ate=ate,
                    traj=traj, counters=dict(s.counters), first=first)
    events_p = prof.events()
    ran = sum(1 for e in events_p
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    check(ran == ran_launches == n1 * win_steps, f"{name}: the profiler saw "
          f"{ran} ICP kernels run in the profiled stretch, the count says "
          f"{ran_launches}, its {win_steps} scan steps need {n1 * win_steps}")
    c = s.counters
    for k in MM_COUNTERS:
        check(c.get(k, 0) > 0, f"{name}: the stream never took {k}: {c}")
    ate = trajectory_ate(s, data)
    check(ate < ENTRY_ATE_GATE, f"{name}: four-modality ATE {ate:.4f} m >= "
          f"{ENTRY_ATE_GATE}")
    out = dict(name=name, launches=launches, ran=ran, steps=steps, ate=ate,
               traj=traj, counters=dict(c), first=first,
               mem=torch.cuda.max_memory_allocated() / 2**20)
    live = [r for r in rows if r[3]]
    steady = [r for r in live if not r[2]]
    span = live[-1][4] - live[0][4]
    out["wall_all"] = sum(r[1] for r in live) / 1e3 / span
    out["wall_steady"] = (statistics.mean(r[1] for r in steady) * len(live)
                          / 1e3 / span)
    out["ms"] = {k: [r[1] for r in steady if r[0] == k] for k in MM_KINDS}
    out["setup_ms"] = [r[1] for r in live if r[2]]
    out["dev"] = busy_by_range(events_p, MM_KINDS)
    check(all(out["dev"][k][2] > 0 for k in MM_KINDS), f"{name}: the "
          f"profiled stretch lacks a kind: {out['dev']}")
    # the device's idle share of the steady stream: each kind's device ms
    # an event (the profiled stretch) over its unprofiled host ms
    busy = sum(out["dev"][k][0] / out["dev"][k][2] * len(v)
               for k, v in out["ms"].items())
    out["idle"] = 100 * (1 - busy / sum(sum(v) for v in out["ms"].values()))
    print(f"[{tag}] {name}: {len(events)} events ({steps} scan steps, "
          f"{c['radar_frames']} radar frames, {c['odom_msgs']} odometry "
          f"messages), ICP kernel launches {launches} (= {n1} x {steps}), "
          f"ATE {ate:.5f} m (gate {ENTRY_ATE_GATE}), peak device memory "
          f"{out['mem']:.0f} MiB; counters {c}", flush=True)
    print(f"[{tag}] {name}: host ms an event (synchronized), median / "
          f"p90 / events: " + ", ".join(
              f"{k} {statistics.median(v):.2f} / "
              f"{float(np.percentile(v, 90)):.2f} / {len(v)}"
              for k, v in out["ms"].items() if v)
          + (f"; {len(out['setup_ms'])} events ran a warm-up or a capture, "
             f"{sum(out['setup_ms']) / 1e3:.2f} s in all"
             if out["setup_ms"] else ""), flush=True)
    print(f"[{tag}] {name}: profiled stretch of {w1 - w0} events: "
          f"{ran} ICP kernels ran (= {n1} x {win_steps} scan steps), device "
          f"ms / device ops an event by kind: " + ", ".join(
              f"{k} {v[0] / v[2]:.3f} / {v[1] / v[2]:.0f} ({v[2]})"
              for k, v in out["dev"].items())
          + f"; device idle {out['idle']:.1f}% of the steady stream's host "
          f"time; "
          f"wall seconds per sensor second {out['wall_steady']:.3f} steady, "
          f"{out['wall_all']:.3f} with set-up, over {span:.2f} s", flush=True)
    if not eager:
        g = s.graphs
        kinds = sorted({variant(k) for k in g.graphs}, key=str)
        check(set(kinds) == MM_VARIANTS, f"captured variants {kinds}")
        check(g.captures == len(g.graphs), f"{g.captures} captures of "
              f"{len(g.graphs)} variants: one was captured again")
        out["graphs"] = {str(variant(k)): g.graphs[k][1] for k in g.graphs}
        print(f"[{tag}] captured: {g.captures} graphs, one a variant, "
              f"{g.replays} replays; ICP launches each records: "
              + ", ".join(f"{k} {v}" for k, v in out["graphs"].items()),
              flush=True)
    return out


def multimodal_phase():
    """The four-modality stream at entry widths, captured (this slice's
    main path, the whole stream), then eager over the shortest prefix of
    the stream that runs every variant of ``MM_VARIANTS`` (the captured
    run's first event of each), in one process: the captured positions
    over that prefix within the capture gate of the eager ones."""
    t0 = time.perf_counter()
    data, events = mm_stream()
    print(f"[multimodal] {len(events)} events generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cap = mm_run(False, data, events)
    upto = max(cap["first"].values()) + 1
    eag = mm_run(True, data, events, upto=upto)
    n = len(eag["traj"])
    check(0 < n <= len(cap["traj"]), "the eager prefix's trajectory")
    gap = float(np.abs(cap["traj"][:n] - eag["traj"]).max())
    check(gap < CAPTURE_GAP, f"multimodal: captured and eager positions "
          f"differ by {gap:.4f} m over the first {upto} events")
    print(f"[multimodal] captured vs eager over the first {upto} of "
          f"{len(events)} events (every variant run): {n} trajectory rows, "
          f"largest position gap {gap:.2e} m (gate {CAPTURE_GAP}); captured "
          f"radar ms an event {statistics.median(cap['ms']['radar']):.2f}, "
          f"ATE {cap['ate']:.5f} m over the whole stream", flush=True)
    return cap["launches"], cap["ran"]


# stages of the scan step timed by --stage-split: (module, function, name)
STAGES = (
    ("mimosa_tpu_torch.lidar.deskew", "deskew", "deskew"),
    ("mimosa_tpu_torch.imu.preintegration", "preintegrate", "preintegrate"),
    ("mimosa_tpu_torch.graph.sequencer", "voxel_downsample", "downsample"),
    ("mimosa_tpu_torch.lidar.geometric", "match", "match"),
    ("mimosa_tpu_torch.ops.icp_cuda", "linearize", "ICP linearize"),
    ("mimosa_tpu_torch.graph.window", "imu_factor_cache", "imu_factor_cache"),
    ("mimosa_tpu_torch.graph.window", "build_system", "build_system"),
    ("mimosa_tpu_torch.graph.window", "solve", "solve"),
    ("mimosa_tpu_torch.graph.window", "apply_update", "apply_update"),
    ("mimosa_tpu_torch.graph.window", "rebase_prior", "rebase + absorb"),
    ("mimosa_tpu_torch.graph.window", "add_measurement_block",
     "rebase + absorb"),
    ("mimosa_tpu_torch.graph.sequencer", "_keyframe_map_update",
     "keyframe + map update"),
    ("mimosa_tpu_torch.imu.preintegration", "localizability",
     "IMU localizability"),
    ("mimosa_tpu_torch.graph.sequencer", "_marginalize", "marginalize"),
)


def stage_split_phase():
    """The entry-width replay, run eagerly, with a device synchronize and a
    host clock around each stage function of the step: host ms a scan step
    of each stage (nested stages count in both: deskew's preintegration,
    the map update's downsample). Passes the device explicitly, so the same
    split runs against a tree whose Sequencer has another default."""
    import importlib

    from mimosa_tpu_torch import require_cuda

    s, data = entry_replay(device=require_cuda(), eager=True)
    acc, calls, saved = {}, {}, []

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = calls.get(name, 0) + 1
            return out
        return wrapper

    for mod_name, fn_name, name in STAGES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, timed(name, getattr(mod, fn_name)))
    try:
        ms, _ = replay_timed(s, data, range(len(data["scans"])))
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)
    steps = s.scan_idx
    split = ", ".join(f"{name} {1e3 * t / steps:.2f} ({calls[name]} calls)"
                      for name, t in sorted(acc.items(), key=lambda x: -x[1]))
    print(f"[stage-split] entry widths, {steps} scan steps, synchronized "
          f"around each stage: median {statistics.median(ms[5:]):.2f} ms a "
          f"scan; host ms a scan step by stage: {split}", flush=True)


def scoreboard_phase():
    """The scoreboard rows on the card (captured steps), each under its
    gate. Returns every row's (ATE, RTE) by name."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io import synthetic_replay

    rows = {}
    for name, kw, gate, rte_gate in SCOREBOARD:
        kw = dict(kw)
        if "tc" in kw:
            kw["tc"] = syn.TrajectoryConfig(**kw["tc"])
        if kw.pop("world", None) == "corridor":
            kw["world"] = syn.corridor_world()
        out = synthetic_replay.run(verbose=False, **kw)
        s = out["sequencer"]
        check(s.device.type == "cuda", f"{name} ran on {s.device}")
        check(s.graphs is not None and s.graphs.replays > 0,
              f"{name}: no captured step was replayed")
        ms = 1e3 * out["wall"] / out["n_scans"]
        codec = ("range" if s.cfg.range_transfer else "int16"
                 if s.cfg.quantize_transfer else "f32")
        rte = row_rte(s, out["data"])
        print(f"[scoreboard] {name}: ATE {out['ate']:.5f} m (gate {gate}), "
              f"RTE {rte:.3f}% ("
              + (f"gate {rte_gate}%" if rte_gate is not None
                 else GEO_PROJ_RTE)
              + f"), {out['n_scans']} scans, {codec} codec, {ms:.2f} ms a "
              f"scan incl. first-call set-up and captures, counters "
              f"{out['counters']}", flush=True)
        check(out["ate"] < gate, f"{name} ATE {out['ate']:.4f} m >= {gate}")
        if rte_gate is not None:
            # a NaN RTE (a path under the 10 m delta) fails here
            check(rte < rte_gate, f"{name} RTE {rte:.3f}% >= {rte_gate}%")
        rows[name] = (out["ate"], rte)
    for name, build, gate, rte_gate in STREAM_ROWS:
        rows[name] = stream_row(name, *build(), gate, rte_gate)
    ates = {k: v[0] for k, v in rows.items()}
    print(f"[scoreboard] corridor: ATE {ates['corridor_radar']:.5f} m with "
          f"20 Hz radar streamed against {ates['corridor_geo_proj']:.5f} m "
          f"with geometry alone (corridor_geo_proj): the Doppler factor "
          f"observes the velocity along the axis the walls leave free",
          flush=True)
    return rows


def row_rte(s, data):
    """RTE [%] of Sequencer ``s``'s trajectory against the sequence's
    ground truth (the scoreboard's ``_rte_vs_gt``,
    scripts/dataset_evaluation.py:109): translation error over every
    10 m of path; NaN on a path shorter than that."""
    from mimosa_tpu_torch.utils import evaluation as ev

    tr = s.trajectory
    return ev.rte(np.asarray([t for t, _, _ in tr]),
                  np.asarray([p for _, p, _ in tr]), data["gt"]["ts"],
                  data["gt"]["pos"])


def row_sequencer(**geo_kw):
    """The Sequencer of the JAX scoreboard's dropout_ooo and
    corridor_radar_bulk rows (scripts/dataset_evaluation.py:178-190,
    241-252): 16x256 LiDAR, 4096 points, K=6, 2^17 voxels, int16 codec."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    return seq.Sequencer(
        seq.SequencerConfig(max_scan_points=4096, n_geo_points=4096,
                            n_map_points=8192, geo_leaf=0.4,
                            map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                            keyframe_rot_thresh=0.15, n_gn_iters=3),
        win.WindowConfig(K=6),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17, plane_min_points=5,
                          lru_horizon=0),
        geo.GeometricConfig(**geo_kw))


def dropout_ooo():
    """The dropout_ooo row (scripts/dataset_evaluation.py:165-225): the
    8 s noisy room (seed 3) from a 16x256 LiDAR with 15% of the scans
    dropped, every ninth pair swapped and two same-key duplicates, scan by
    scan (default GeometricConfig)."""
    from mimosa_tpu_torch.graph.sequencer import Sequencer
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import dropout_scans

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=8.0),
                        syn.LidarModel(), seed=3, imu_noise=0.01,
                        range_noise=0.01)
    events = [(Sequencer._scan_t_end(sc), "scan", sc)
              for sc in dropout_scans(data)]
    return row_sequencer(), data, events


def corridor_radar():
    """The corridor_radar_bulk row's sequence and settings
    (scripts/dataset_evaluation.py:227-262: the 8 s corridor, 20 Hz radar
    Doppler, degeneracy projection on), streamed event by event through
    add_scan and add_radar instead of the bulk scheduler."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import multimodal_events

    tc = syn.TrajectoryConfig(t_total=8.0, amp=(4.0, 0.6, 0.3),
                              center=(40.0, 2.0, 1.5), yaw_rate=0.15)
    data = syn.generate(syn.corridor_world(), tc, syn.LidarModel(), seed=0,
                        imu_noise=0.01, range_noise=0.005)
    radar = syn.generate_radar(syn.make_trajectory(tc), tc, seed=0)
    return (row_sequencer(sigma=0.05, loc_count_thresh=50.0,
                          project_degenerate=True),
            data, multimodal_events(data, radar))


# the streamed scoreboard rows: name, (Sequencer, data, events), ATE gate
# [m], RTE gate [%] (dataset_evaluation.py:299, and corridor_radar_bulk's
# for the corridor)
STREAM_ROWS = (("dropout_ooo", dropout_ooo, 0.080, 0.5),
               ("corridor_radar", corridor_radar, 0.20, 2.0))


def stream_row(name, s, data, events, gate, rte_gate):
    """One streamed scoreboard row on the card (captured steps): its ATE,
    under ``gate``, and its RTE, under ``rte_gate``; returns both."""
    from mimosa_tpu_torch.io.synthetic_replay import (feed_event,
                                                      trajectory_ate)

    check(s.device.type == "cuda", f"{name} ran on {s.device}")
    t0 = time.perf_counter()
    imu_i = 0
    for ev in events:
        imu_i = feed_event(s, data, ev, imu_i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(s.graphs.replays > 0, f"{name}: no captured step was replayed")
    ate = trajectory_ate(s, data)
    c = s.counters
    if name == "dropout_ooo":
        # the failure-handling paths of the JAX row fire
        check(c["scans_dropped_ooo"] + c.get("scans_ooo_inserted", 0) > 0
              and c["scans_same_key"] > 0,
              f"dropout_ooo took no late or same-key path: {c}")
    rte = row_rte(s, data)
    print(f"[scoreboard] {name}: ATE {ate:.5f} m (gate {gate}), RTE "
          f"{rte:.3f}% (gate {rte_gate}%), {len(events)} events streamed, "
          f"int16 codec, {1e3 * wall / len(events):.2f} ms an event incl. "
          f"first-call set-up and captures, counters {c}", flush=True)
    check(ate < gate, f"{name} ATE {ate:.4f} m >= {gate}")
    check(rte < rte_gate, f"{name} RTE {rte:.3f}% >= {rte_gate}%")
    return ate, rte

# bench.py's scene (bench.py:79-84): the 30 x 16 x 6 m room, 9 s
BULK_TC = dict(t_total=9.0, amp=(6.0, 3.0, 0.8), center=(12.0, 8.0, 2.0))
BULK_CHUNK = 32           # bench.py's replay_once_bulk
BULK_PROF = 4             # scans of the last chunk, run under the profiler
BULK_GAP = 1e-6           # [m] bulk against merged streaming: the same bits
BULK_MM_CHUNK = 8
CORRIDOR_BULK_CHUNK = 16  # scripts/dataset_evaluation.py:259
CORRIDOR_BULK_JAX = "the JAX package's bulk row on the TPU: 33.2 mm / 0.27%"


def bench_sequencer():
    """bench.py's geometric bulk configuration (bench.py:109-150): an
    OS-0-128 scan (128 x 1024) thinned 4x at pack time into 32768 lanes
    of the int16 codec, 8192 ICP points, 16384 map points, geo_leaf 0.5,
    map_insert_leaf 0.2, K=8, 2^19 voxels, 3 GN iterations; with the
    merged slide, so that its streamed warm-up captures the variant its
    chunks replay."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    s = seq.Sequencer(
        seq.SequencerConfig(max_scan_points=32768, point_skip=4,
                            n_geo_points=8192, n_map_points=16384,
                            geo_leaf=0.5, map_insert_leaf=0.2,
                            keyframe_trans_thresh=0.3,
                            keyframe_rot_thresh=0.15, n_gn_iters=3,
                            merge_marginalize=True),
        win.WindowConfig(K=8),
        vh.VoxelMapConfig(leaf_size=0.5, capacity_log2=19,
                          plane_min_points=5, lru_horizon=0),
        geo.GeometricConfig())
    check(s.device.type == "cuda" and s.graphs is not None,
          f"the bench Sequencer chose {s.device}")
    return s


def positions(s):
    return np.asarray([p for _, p, _ in s.trajectory])


def bulk_gap(b, s, what):
    """Bulk against merged streaming: the same schedule and positions
    within BULK_GAP. Returns the largest position gap."""
    check(b.counters == s.counters and b.state_ts == s.state_ts
          and b._traj_ts == s._traj_ts and b._traj_src == s._traj_src,
          f"{what}: bulk and streaming ran another schedule: "
          f"{b.counters} vs {s.counters}")
    gap = float(np.abs(positions(b) - positions(s)).max())
    check(gap < BULK_GAP, f"{what}: bulk and merged streaming positions "
          f"differ by {gap:.3e} m")
    return gap


def bulk_scans():
    """(a) bench.py's offline bulk replay at 128 x 1024 (replay_once_bulk,
    bench.py:219-235): the first min(20, n // 3) scans streamed, the rest
    through add_scans_bulk in chunks of 32 (the remainder one more chunk,
    ``tail_chunk``), timed with one synchronize at the end; then the last
    BULK_PROF scans as one chunk under the profiler. The comparator: the
    same configuration streamed scan by scan, each scan staged while the
    one before runs (bench.py:186-208). Returns (ICP launches over the
    bulk stretch, the profiler's ICP kernels in the profiled chunk)."""
    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate
    from mimosa_tpu_torch.ops import icp_cuda

    t0 = time.perf_counter()
    data = syn.generate(syn.room_world(lx=30.0, ly=16.0, lz=6.0),
                        syn.TrajectoryConfig(**BULK_TC),
                        syn.LidarModel(n_rows=128, n_cols=1024), seed=0,
                        imu_noise=0.01, range_noise=0.01)
    scans, imu = data["scans"], data["imu"]
    n = len(scans)
    n_warm = min(20, n // 3)
    print(f"[bulk] bench.py's room, 9 s: {n} scans of "
          f"{len(scans[0]['points'])} points generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    s = bench_sequencer()
    imu_i = 0

    def stage(i):
        sc = scans[i]
        return s.stage_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                            sc["valid"])

    staged = stage(0)
    for i in range(n):
        if i == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        st = staged
        j = int(np.searchsorted(imu["ts"], st["t_end"] + 0.03, "right"))
        if j > imu_i:
            s.add_imu_batch(imu["ts"][imu_i:j], imu["acc"][imu_i:j],
                            imu["gyro"][imu_i:j])
            imu_i = j
        s.add_scan(st["ts_header"], staged=st)
        if i + 1 < n:
            staged = stage(i + 1)
    torch.cuda.synchronize()
    stream_rate = (n - n_warm) / (time.perf_counter() - t0)
    stream_clock = nvidia_smi("clocks.sm,power.draw")

    b = bench_sequencer()
    b.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    for sc in scans[:n_warm]:
        b.add_scan(sc["ts_header"], sc["points"], sc["t_rel"], sc["valid"])
    check(("scan", True, True) in b.graphs.graphs, "the bulk Sequencer's "
          "warm-up did not capture the chunks' variant")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed, last = scans[n_warm:-BULK_PROF], scans[-BULK_PROF:]
    extra = len(timed) % BULK_CHUNK
    icp_cuda.LAUNCHES = 0
    steps0, captures0 = b.scan_idx, b.graphs.captures
    t0 = time.perf_counter()
    b.add_scans_bulk(timed, chunk=BULK_CHUNK,
                     tail_chunk=extra if extra >= 2 else None)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    bulk_rate = len(timed) / bulk_s
    bulk_clock = nvidia_smi("clocks.sm,power.draw")
    timers = b.timers.summary()
    counts = dict(b.bulk_counts)
    launches0 = icp_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b.add_scans_bulk(last, chunk=BULK_PROF)
        torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() / 2**20
    launches = icp_cuda.LAUNCHES
    n1 = b.cfg.n_gn_iters + 1
    steps = b.scan_idx - steps0
    check(b.bulk_counts["chunks"] >= 2 and
          b.bulk_counts["in_chunks"] + b.bulk_counts["streamed"]
          == n - n_warm, f"bulk: {b.bulk_counts}")
    check(b.graphs.captures == captures0, "bulk: a chunk captured a graph")
    check(launches == n1 * steps, f"bulk: ICP kernel launched {launches} "
          f"times in {steps} scan steps, expected {n1 * steps}")
    events = prof.events()
    ran = sum(1 for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    check(ran == launches - launches0 == n1 * BULK_PROF, f"bulk: the "
          f"profiler saw {ran} ICP kernels run in a chunk of {BULK_PROF} "
          f"scans, the count says {launches - launches0}")
    busy, n_dev = device_busy_ms(events)
    check(n_dev > 0, "bulk: the profiler saw no device work")
    busy_scan = busy / BULK_PROF
    idle = 100 * (1 - busy_scan * len(timed) / (1e3 * bulk_s))
    gap = bulk_gap(b, s, "bulk 128x1024")
    ate = trajectory_ate(b, data)
    check(np.isfinite(positions(b)).all(), "bulk: non-finite poses")
    check(ate < ENTRY_ATE_GATE, f"bulk: ATE {ate:.4f} m >= "
          f"{ENTRY_ATE_GATE}")
    per_chunk = {k: timers[k]["mean_ms"] for k in
                 ("t_bulk_pack", "t_bulk_put", "t_bulk_dispatch")}
    print(f"[bulk] 128x1024 (bench.py's bulk configuration, int16 codec): "
          f"{n_warm} scans streamed to warm up, then {len(timed)} in "
          f"{counts['chunks']} chunks of {BULK_CHUNK}"
          + (f" and {extra}" if extra >= 2 else "")
          + f" ({counts['in_chunks']} in chunks, {counts['streamed']} "
          f"streamed by the scheduler) and {BULK_PROF} in one more chunk "
          f"under the profiler; warm scans/s with one synchronize at the "
          f"end: bulk {bulk_rate:.2f}, streaming (merged slide, staged one "
          f"ahead) {stream_rate:.2f} (SM clock and power draw read after "
          f"each: bulk {bulk_clock}, streaming {stream_clock}); ms a chunk: "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_chunk.items())
          + f"; peak device memory {mem:.0f} MiB", flush=True)
    print(f"[bulk] 128x1024: ICP kernel launches {launches} (= {n1} x "
          f"{steps} scan steps), the profiler saw {ran} run in the "
          f"profiled chunk (= {n1} x {BULK_PROF}); device busy "
          f"{busy_scan:.2f} ms a scan in {n_dev / BULK_PROF:.0f} device "
          f"ops, idle {idle:.1f}% of the timed bulk stretch "
          f"({1e3 * bulk_s / len(timed):.2f} ms a scan); ATE {ate:.5f} m "
          f"(gate {ENTRY_ATE_GATE}); largest position gap to streaming "
          f"{gap:.2e} m (gate {BULK_GAP})", flush=True)
    return launches, ran


def bulk_mixed():
    """(b) Mixed chunks at entry widths: synthetic_replay.bulk_stream on
    the 4 s room from a 64x512 LiDAR (20 Hz radar of 512 targets, 10 Hz
    odometry, a radar frame and an odometry message 2 ms after every fourth
    scan's end, all in order) through add_bulk in chunks of 8, against the
    same events streamed with the merged slide. Returns the bulk run's ICP
    launches."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io import synthetic_replay as trep
    from mimosa_tpu_torch.ops import icp_cuda

    data, events = trep.bulk_stream(
        syn.TrajectoryConfig(t_total=4.0, t_stationary=1.23),
        syn.LidarModel(n_rows=64, n_cols=512), n_targets=512)
    msgs = trep.bulk_messages(events)
    imu = data["imu"]
    runs = {}
    for name in ("stream", "bulk"):
        s = entry_sequencer(merge_marginalize=True)
        s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
        icp_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        if name == "bulk":
            s.add_bulk(msgs, chunk=BULK_MM_CHUNK)
        else:
            for _, kind, m in events:
                if kind == "scan":
                    s.add_scan(m["ts_header"], m["points"], m["t_rel"],
                               m["valid"])
                elif kind == "radar":
                    s.add_radar(m["ts"], m["points"], m["doppler"],
                                m["snr_db"])
                else:
                    s.add_odometry(m["ts"], m["q"], m["t"], m["cov"])
        torch.cuda.synchronize()
        runs[name] = (s, time.perf_counter() - t0, icp_cuda.LAUNCHES)
    (b, b_s, launches), (s, s_s, _) = runs["bulk"], runs["stream"]
    gap = bulk_gap(b, s, "bulk mixed")
    codes = b.bulk_counts["codes"]
    check(all(c > 0 for c in codes), f"bulk mixed: an event code never ran "
          f"inside a chunk: {b.bulk_counts}")
    n1 = b.cfg.n_gn_iters + 1
    check(launches == n1 * b.scan_idx, f"bulk mixed: ICP kernel launched "
          f"{launches} times in {b.scan_idx} scan steps")
    print(f"[bulk] mixed chunks at entry widths: {len(msgs)} events "
          f"({b.counters['scans']} scans, {b.counters['radar_frames']} radar "
          f"frames, {b.counters['odom_msgs']} odometry messages), "
          f"{b.bulk_counts['chunks']} chunks of {BULK_MM_CHUNK}, "
          f"{b.bulk_counts['in_chunks']} events in chunks, "
          f"{b.bulk_counts['streamed']} streamed; inside chunks by code: "
          + ", ".join(f"{k} {c}" for k, c in zip(
              ("scan", "radar declare", "radar attach", "odometry declare",
               "odometry attach"), codes))
          + f"; ICP kernel launches {launches} (= {n1} x {b.scan_idx}); "
          f"{b_s:.2f} s bulk, {s_s:.2f} s streamed, each with its variants' "
          f"warm-ups and captures; largest position gap {gap:.2e} m (gate "
          f"{BULK_GAP}); counters, state_ts and _traj_src equal", flush=True)
    return launches


def bulk_corridor(streamed):
    """(c) The corridor_radar_bulk row through add_bulk in chunks of 16
    (scripts/dataset_evaluation.py:227-262): ATE < 0.20 m, RTE < 2.0%.
    ``streamed``: the streamed row's (ATE, RTE)."""
    from mimosa_tpu_torch.io.synthetic_replay import (bulk_messages,
                                                      trajectory_ate)

    s, data, events = corridor_radar()
    imu = data["imu"]
    s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    t0 = time.perf_counter()
    s.add_bulk(bulk_messages(events), chunk=CORRIDOR_BULK_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(s.bulk_counts["chunks"] > 0, "corridor_radar_bulk ran no chunk")
    ate, rte = trajectory_ate(s, data), row_rte(s, data)
    print(f"[bulk] corridor_radar_bulk through add_bulk (chunks of "
          f"{CORRIDOR_BULK_CHUNK}): ATE {ate:.5f} m (gate 0.20), RTE "
          f"{rte:.3f}% (gate 2.0%); {CORRIDOR_BULK_JAX}; the row streamed "
          f"(scoreboard): {streamed[0]:.5f} m / {streamed[1]:.3f}%; "
          f"{s.bulk_counts['chunks']} chunks, {s.bulk_counts['in_chunks']} "
          f"events in chunks, {s.bulk_counts['streamed']} streamed, "
          f"{1e3 * wall / len(events):.2f} ms an event incl. first-call "
          f"set-up and captures; counters {s.counters}", flush=True)
    check(ate < 0.20, f"corridor_radar_bulk ATE {ate:.4f} m >= 0.20")
    check(rte < 2.0, f"corridor_radar_bulk RTE {rte:.3f}% >= 2.0%")


def bulk_phase(streamed_corridor):
    """The bulk scheduler: (a) scan-only at bench.py's 128 x 1024 widths,
    (b) mixed chunks at entry widths, (c) the corridor_radar_bulk row;
    (d), bulk bag replay, is part of the replay phase. Returns the ICP
    launches and profiled kernels of (a) and the launches of (b)."""
    launches, ran = bulk_scans()
    mixed = bulk_mixed()
    bulk_corridor(streamed_corridor)
    return launches, ran, mixed


def chunk_graph_phase():
    """``--chunk-graph``: the design the bulk scheduler did not take, one
    CUDA graph recording a whole chunk of BULK_CHUNK scan steps, against
    the per-step replays of a chunk and against streaming, at bench.py's
    128 x 1024 widths (:func:`bench_sequencer`, the first 20 scans
    streamed in each). Three Sequencers take the next BULK_CHUNK scans:
    one through add_scans_bulk (per-step replays), one scan by scan
    (staged one ahead), each with a CUDA event recorded before every step
    it launches; the third packs and sends the same chunk (its replays
    recorded instead of run), captures the chunk's steps into one graph
    that reads the device slabs, and replays it. Prints the ms a chunk of
    each (host clock, synchronized at the end), the device ms between
    consecutive steps (median, min, max), the host ms the per-step chunk
    spent dispatching, the capture seconds, the graph's memory, the ICP
    launches it recorded, and whether the three give the same bits."""
    from mimosa_tpu_torch.graph.captured import flatten, unflatten, write_back
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.ops import icp_cuda

    data = syn.generate(syn.room_world(lx=30.0, ly=16.0, lz=6.0),
                        syn.TrajectoryConfig(**BULK_TC),
                        syn.LidarModel(n_rows=128, n_cols=1024), seed=0,
                        imu_noise=0.01, range_noise=0.01)
    scans, imu = data["scans"], data["imu"]
    n_warm = min(20, len(scans) // 3)
    chunk = scans[n_warm:n_warm + BULK_CHUNK]
    seqs = []
    for _ in range(3):
        s = bench_sequencer()
        s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
        for sc in scans[:n_warm]:
            s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                       sc["valid"])
        seqs.append(s)
    a, st, g = seqs
    torch.cuda.synchronize()

    def timed_steps(s):
        """Record a CUDA event before each step ``s`` launches."""
        marks, run = [], s._run

        def marked(key, inputs=()):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            run(key, inputs)
        s._run = marked
        return marks

    def gaps(marks):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        ms = [x.elapsed_time(y) for x, y in zip(marks, marks[1:] + [end])]
        return (statistics.median(ms), min(ms), max(ms))

    marks = timed_steps(a)
    t0 = time.perf_counter()
    a.add_scans_bulk(chunk, chunk=BULK_CHUNK)
    dispatch_ms = 1e3 * (time.perf_counter() - t0)
    step_gaps = gaps(marks)
    step_ms = 1e3 * (time.perf_counter() - t0)
    check(a.bulk_counts["chunks"] == 1, f"per-step: {a.bulk_counts}")

    marks = timed_steps(st)
    t0 = time.perf_counter()
    staged = st.stage_scan(chunk[0]["ts_header"], chunk[0]["points"],
                           chunk[0]["t_rel"], chunk[0]["valid"])
    for i in range(len(chunk)):
        nxt = None
        cur = staged
        if i + 1 < len(chunk):
            sc = chunk[i + 1]
            nxt = st.stage_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                                sc["valid"])
        st.add_scan(cur["ts_header"], staged=cur)
        staged = nxt
    stream_gaps = gaps(marks)
    stream_ms = 1e3 * (time.perf_counter() - t0)

    recorded = []
    g._run = lambda key, inputs=(): recorded.append((key, inputs))
    t0 = time.perf_counter()
    g.add_scans_bulk(chunk, chunk=BULK_CHUNK)
    torch.cuda.synchronize()
    pack_ms = 1e3 * (time.perf_counter() - t0)
    del g._run
    check(len(recorded) == BULK_CHUNK, f"{len(recorded)} steps recorded")
    graphs = g.graphs
    bufs = graphs._adopt(g._state())
    spec = graphs._spec
    fns = {key: g._step_cache[g._ckey("step", *key)] for key, _ in recorded}
    graph = torch.cuda.CUDAGraph()
    mem0 = torch.cuda.memory_reserved()
    launches0 = icp_cuda.LAUNCHES
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        state = unflatten(bufs, spec)
        for key, ins in recorded:
            state = fns[key](state, *ins)
        write_back(bufs, flatten(state)[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    recorded_launches = icp_cuda.LAUNCHES - launches0
    icp_cuda.LAUNCHES = launches0
    mem = (torch.cuda.memory_reserved() - mem0) / 2**20
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t0)
    for k, v in zip(g._state_names, unflatten(bufs, spec)):
        setattr(g, k, v)

    def bits(s):
        tr = s.trajectory
        return (np.asarray([p for _, p, _ in tr]),
                np.asarray([q for _, _, q in tr]))

    ref = bits(a)
    same = {name: all(np.array_equal(x, y) for x, y in zip(ref, bits(s)))
            for name, s in (("streaming", st), ("chunk graph", g))}
    n = BULK_CHUNK
    print(f"[chunk-graph] 128x1024, {n} scan steps after a 20-scan warm-up "
          f"(ms a chunk, host clock, one synchronize at the end; device ms "
          f"between consecutive steps median / min / max): per-step "
          f"replays (add_scans_bulk) {step_ms:.2f} ({1e3 * n / step_ms:.2f} "
          f"scans/s; its host returned after {dispatch_ms:.2f} ms), "
          f"{step_gaps[0]:.2f} / {step_gaps[1]:.2f} / {step_gaps[2]:.2f}; "
          f"streaming, staged one ahead {stream_ms:.2f} "
          f"({1e3 * n / stream_ms:.2f} scans/s), {stream_gaps[0]:.2f} / "
          f"{stream_gaps[1]:.2f} / {stream_gaps[2]:.2f}; one graph: "
          f"captured in {capture_s:.2f} s, {mem:.0f} MiB more reserved "
          f"device memory, {recorded_launches} ICP launches recorded, pack "
          f"and copy {pack_ms:.2f} ms + replay {graph_ms:.2f} ms a chunk "
          f"({1e3 * n / (pack_ms + graph_ms):.2f} scans/s); the bits of the "
          f"per-step replays: "
          + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)


ONLINE_ARRIVAL = 0.01     # a scan reaches the online estimator 10 ms after its end
ONLINE_GAP = 1e-6         # [m] online against the same events fed offline
# the step variants the entry-width room runs, captured before the real-time
# part of the online phase
ONLINE_VARIANTS = {("scan", False, True), ("marginalize",)}


class ErrorRecords(logging.Handler):
    """Keeps the ERROR records a logger emits."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def online_events(data):
    """(arrival time, kind, index) of a sequence's IMU samples (kind 0, at
    their time) and scans (kind 1, ONLINE_ARRIVAL after their end), in
    arrival order."""
    from mimosa_tpu_torch.graph.sequencer import Sequencer

    ev = [(float(t), 0, i) for i, t in enumerate(data["imu"]["ts"])]
    ev += [(Sequencer._scan_t_end(sc) + ONLINE_ARRIVAL, 1, k)
           for k, sc in enumerate(data["scans"])]
    return sorted(ev)


def online_phase(stream=None, tag="[online]"):
    """The online estimator (``io.online.OnlineEstimator``, scans staged on the
    pusher's thread, the default backlog bound) around the entry-width
    Sequencer, captured, on the 4 s room: the first scans pushed with a
    flush after each until every step variant of the room is captured,
    then the rest pushed in real time (each IMU sample and scan when the
    wall clock reaches its arrival). Gates: no scan dropped, no ERROR
    record from the worker, ATE, ICP launches, and the trajectory equal to
    the same Sequencer fed the worker's event order offline, captured.
    ``stream``: a debug stream the worker emits to after each scan (the
    lines printed under ``tag``). Returns the ICP launches, the graph
    replays and the median ms from a scan's push to its on_state, of the
    online run, and its Sequencer."""
    from mimosa_tpu_torch.io.online import OnlineEstimator
    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate
    from mimosa_tpu_torch.ops import icp_cuda

    s, data = entry_replay()
    scans, imu = data["scans"], data["imu"]
    # what the worker hands the Sequencer, in its order
    order = []
    add_imu, add_scan = s.add_imu, s.add_scan

    def rec_imu(ts, acc, gyro):
        order.append(("imu", (ts, acc, gyro)))
        add_imu(ts, acc, gyro)

    def rec_scan(ts_header, staged):
        order.append(("scan", ts_header))
        add_scan(ts_header, staged=staged)

    s.add_imu, s.add_scan = rec_imu, rec_scan
    props, states, pushed = [], [], {}
    errors = ErrorRecords()
    log = logging.getLogger("mimosa_tpu_torch.io.online")
    log.addHandler(errors)
    events = online_events(data)
    icp_cuda.LAUNCHES = 0
    est = OnlineEstimator(
        s, on_propagated=lambda ts, q, p, v: props.append(ts),
        on_state=lambda ts, *st: states.append((ts, time.perf_counter())),
        stage_on_push=True, debug_stream=stream)
    check(est.max_pending_scans == 8, "the default backlog bound")

    def push(kind, k, real_time=False):
        if kind == 0:
            return est.push_imu(imu["ts"][k], imu["acc"][k], imu["gyro"][k])
        sc = scans[k]
        if real_time:
            pushed[s._scan_t_end(sc)] = time.perf_counter()
        return est.push_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                             sc["valid"])

    i = n_warm = 0
    try:
        while True:
            check(i < len(events), "the room never ran every variant")
            _, kind, k = events[i]
            i += 1
            push(kind, k)
            if kind == 1:
                n_warm += 1
                check(est.flush(timeout=300.0), "flush timed out")
                if ONLINE_VARIANTS <= set(s.graphs.graphs):
                    break
        imu_us = []
        t_base = time.perf_counter() - events[i][0]
        for t, kind, k in events[i:]:
            delay = t_base + t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t0 = time.perf_counter()
            push(kind, k, real_time=True)
            if kind == 0:
                imu_us.append((time.perf_counter() - t0) * 1e6)
        real_s = time.perf_counter() - t_base - events[i][0]
        est.stop(drain=True, timeout=120.0)
    finally:
        log.removeHandler(errors)
    check(not est._worker.is_alive(), "the online worker did not stop")
    launches, replays = icp_cuda.LAUNCHES, s.graphs.replays
    c = est.counters
    check(c["scans_dropped_backlog"] == 0,
          f"{c['scans_dropped_backlog']} scans dropped for backlog")
    check(not errors.records, "the online worker logged errors: "
          + "; ".join(r.getMessage() for r in errors.records))
    n1 = s.cfg.n_gn_iters + 1
    check(launches > 0 and launches == n1 * s.scan_idx, f"online: ICP kernel "
          f"launched {launches} times in {s.scan_idx} scan steps")
    ate = trajectory_ate(s, data)
    check(ate < ENTRY_ATE_GATE, f"online ATE {ate:.4f} m >= {ENTRY_ATE_GATE}")
    # a scan pushed in real time: from its push to the on_state call of its
    # state (the first call with its end time)
    lat = [(t_state - pushed.pop(ts)) * 1e3 for ts, t_state in states
           if ts in pushed]
    check(len(lat) > 10, f"only {len(lat)} scan states reached on_state")

    # the same Sequencer, fed the worker's order offline, captured
    off = entry_sequencer()
    by_header = {sc["ts_header"]: sc for sc in scans}
    for kind, x in order:
        if kind == "imu":
            off.add_imu(*x)
        else:
            sc = by_header[x]
            off.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                         sc["valid"])
    torch.cuda.synchronize()
    check(off._traj_ts == s._traj_ts, "online and offline state times differ")
    gap = float(np.abs(np.asarray([p for _, p, _ in s.trajectory])
                       - np.asarray([p for _, p, _ in off.trajectory])).max())
    check(gap < ONLINE_GAP, f"online and offline positions differ by {gap:.3e}"
          f" m")
    print(f"{tag} entry widths, OnlineEstimator (stage_on_push, backlog "
          f"bound {est.max_pending_scans}"
          + (", a debug stream of every scan" if stream else "")
          + f"): {n_warm} scans pushed with a "
          f"flush each until every variant ran its warm-up and capture, "
          f"then {c['scans'] - n_warm} scans and {len(imu_us)} IMU samples "
          f"in real time over {real_s:.2f} s (scans {1e3 * ONLINE_ARRIVAL:g} "
          f"ms after their end); push_imu host us median "
          f"{statistics.median(imu_us):.1f} p99 "
          f"{float(np.percentile(imu_us, 99)):.1f}; scan push to its "
          f"on_state ms median {statistics.median(lat):.2f} p90 "
          f"{float(np.percentile(lat, 90)):.2f} over {len(lat)} scans",
          flush=True)
    print(f"{tag} scans dropped for backlog {c['scans_dropped_backlog']}, "
          f"rebases {c['rebases']}, propagated outputs {len(props)}, ICP "
          f"kernel launches {launches} (= {n1} x {s.scan_idx}), graph "
          f"replays {replays}, worker ERROR records {len(errors.records)}, "
          f"ATE {ate:.5f} m (gate {ENTRY_ATE_GATE}); the same Sequencer fed "
          f"the worker's {len(order)} events offline, captured: largest "
          f"position gap {gap:.3e} m (gate {ONLINE_GAP:g})", flush=True)
    return launches, replays, statistics.median(lat), s


# the JAX package's bag CLI test configuration (SYN_PARAMS,
# tests/test_bag_replay_cli.py:13-49)
SYN_PARAMS = {
    "imu": {"manager": {"pose_init_wait_secs": 0.5},
            "preintegration": {"acc_noise_density": 0.03,
                               "gyro_noise_density": 0.003,
                               "gravity_magnitude": 9.81,
                               "gravity_aligned_initialization": True,
                               "acc_bias_random_walk": 1e-3,
                               "gyro_bias_random_walk": 1e-4}},
    "graph": {"manager": {"max_measurement_latency": 0.25,
                          "smoother": {"lag": 0.5,
                                       "additional_update_iterations": 2,
                                       "initial_position_sigma": 1e-3,
                                       "initial_rotation_pitch_roll_sigma_deg":
                                           0.01}}},
    "lidar": {"T_B_S": [0, 0, 0, 0, 0, 0, 1],
              "manager": {"enabled": True, "range_min": 0.2,
                          "range_max": 60.0},
              "geometric": {
                  "neighbor_voxel_mode": 19,
                  "map_keyframe_trans_thresh": 0.3,
                  "map_keyframe_rot_thresh_deg": 8.0,
                  "lru_horizon": 0,
                  "initial_clouds_to_force_map_update": 5,
                  "scan_to_map": {
                      "source_voxel_grid_filter_leaf_size": 0.4,
                      "target_ivox_map_leaf_size": 0.4,
                      "target_ivox_map_min_dist_in_voxel": 0.15,
                      "plane_validity_distance": 0.08,
                      "lidar_point_noise_std_dev": 0.05,
                      "huber_threshold": 2.0,
                      "max_corres_distance": 0.5,
                      "degen_thresh_trans": 50.0}}},
}
REPLAY_ATE_GATE = 0.08    # room_noisy's gate


def replay_config(lm):
    """SYN_PARAMS plus the photometric namespace for LiDAR model ``lm`` (its
    image and field of view; the photometric settings of the synthetic
    replay, ``synthetic_replay.photo_config``, with the reference's central
    difference gradient, 8x smaller than the Sobel one) and the radar
    manager."""
    import copy
    import math

    cfg = copy.deepcopy(SYN_PARAMS)
    cfg["lidar"]["photometric"] = {
        "enabled": True, "rows": lm.n_rows, "cols": lm.n_cols,
        "fov_up_deg": math.degrees(lm.fov_up),
        "fov_down_deg": math.degrees(lm.fov_down),
        "range_min": 0.5, "range_max": 40.0, "gradient_threshold": 0.25,
        "nma_radius": 5, "num_features_detect": 64, "margin_size": 3,
        "intensity_scale": 1.0, "filter_brightness": False,
        "remove_lines": False}
    cfg["radar"] = {"T_B_S": [0, 0, 0, 0, 0, 0, 1],
                    "manager": {"enabled": True,
                                "is_exposure_compensated": True}}
    return cfg


def write_tum(path, ts, pos, quat):
    """Ground truth as a TUM file (ts x y z qx qy qz qw), every float in
    full."""
    with open(path, "w") as f:
        for t, p, q in zip(ts, pos, quat):
            f.write(" ".join(repr(float(v)) for v in
                             (t, p[0], p[1], p[2], q[1], q[2], q[3], q[0]))
                    + "\n")


def replay_files(tmp):
    """The replay cell's inputs, written into directory ``tmp``: the
    photometric phase's 4 s noisy room (64 x 1024) with its IMU and 20 Hz
    radar frames in a bag from the port's writer, ``replay_config`` as YAML
    and the ground truth as TUM. Returns (bag, config, ground truth paths,
    radar frames, points a scan)."""
    import os

    import yaml

    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.rosbag_writer import write_synthetic_bag

    lm = syn.LidarModel(n_rows=64, n_cols=1024)
    tc = syn.TrajectoryConfig(**PHOTO_TC)
    data = photo_data()
    radar = syn.generate_radar(syn.make_trajectory(tc), tc, rate=20.0, seed=0)
    bag, cfgp, gtp = (os.path.join(tmp, n) for n in (
        "room.bag", "params.yaml", "gt.tum"))
    write_synthetic_bag(bag, data, radar_frames=radar)
    with open(cfgp, "w") as f:
        yaml.safe_dump(replay_config(lm), f)
    gt = data["gt"]
    write_tum(gtp, gt["ts"], gt["pos"], gt["quat"])
    return bag, cfgp, gtp, radar, lm.n_rows * lm.n_cols


def replay_phase():
    """The bag CLI at OS-1-64 widths: the photometric phase's 4 s noisy room
    (64 x 1024, 65,536 points a scan) with its IMU and 20 Hz radar frames
    written to a bag by the port's writer, its ground truth to a TUM file
    and ``replay_config`` to a YAML file; then ``io.replay.replay_bag`` in
    this process and ``python -m mimosa_tpu_torch.io.replay`` as a
    subprocess on the same files. Gates: ATE, ICP launches, the CLI's exit
    code, and its ATE line and TUM file equal to the in-process run's.
    Returns the in-process run's ICP launches and graph replays."""
    import os
    import tempfile

    from mimosa_tpu_torch.io.replay import replay_bag
    from mimosa_tpu_torch.ops import icp_cuda
    from mimosa_tpu_torch.utils import evaluation as ev

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bag, cfgp, gtp, radar, n_pts = replay_files(tmp)
        outp = os.path.join(tmp, "traj.tum")
        setup_s = time.perf_counter() - t0
        icp_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        s = replay_bag(bag, cfgp, "/imu", "/points", radar_topic="/radar",
                       max_scan_points=n_pts, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, replays = icp_cuda.LAUNCHES, s.graphs.replays
        check(s.device.type == "cuda" and s.photo_cfg is not None,
              "the replay's Sequencer")
        s.write_tum(outp + ".inproc")
        gt_ts, gt_p, _ = ev.load_tum(gtp)
        tr = s.trajectory
        est_ts = np.asarray([t for t, _, _ in tr])
        est_p = np.asarray([p for _, p, _ in tr])
        ate = ev.ate(est_ts, est_p, gt_ts, gt_p)
        rte = ev.rte(est_ts, est_p, gt_ts, gt_p)
        path = float(np.linalg.norm(np.diff(gt_p, axis=0), axis=-1).sum())
        c = s.counters
        n1 = s.cfg.n_gn_iters + 1
        check(launches > 0 and launches == n1 * s.scan_idx, f"replay: ICP "
              f"kernel launched {launches} times in {s.scan_idx} scan steps")
        check(c["radar_frames"] == len(radar), f"replay consumed "
              f"{c['radar_frames']} of {len(radar)} radar frames")
        check(ate < REPLAY_ATE_GATE, f"replay ATE {ate:.4f} m >= "
              f"{REPLAY_ATE_GATE}")
        tracked = s.debug_records()[2:, 12]
        # the same bag through the bulk scheduler (replay_bag(bulk=True),
        # chunks of 32 events)
        t0 = time.perf_counter()
        sb = replay_bag(bag, cfgp, "/imu", "/points", radar_topic="/radar",
                        max_scan_points=n_pts, verbose=False, bulk=True)
        torch.cuda.synchronize()
        bulk_wall = time.perf_counter() - t0
        tb = sb.trajectory
        bulk_ate = ev.ate(np.asarray([t for t, _, _ in tb]),
                          np.asarray([p for _, p, _ in tb]), gt_ts, gt_p)
        check(sb.counters == c, f"replay bulk counters {sb.counters}")
        check(bulk_ate < REPLAY_ATE_GATE, f"replay bulk ATE {bulk_ate:.4f} m "
              f">= {REPLAY_ATE_GATE}")
        t0 = time.perf_counter()
        jsonl = os.path.join(tmp, "stream.jsonl")
        cli = subprocess.run(
            [sys.executable, "-m", "mimosa_tpu_torch.io.replay", "--bag", bag,
             "--config", cfgp, "--imu-topic", "/imu", "--lidar-topic",
             "/points", "--radar-topic", "/radar", "--max-scan-points",
             str(n_pts), "--gt", gtp, "--out", outp, "--debug-stream", jsonl,
             "--stream-every", "1"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"the replay CLI exited {cli.returncode}:"
              f"\n{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
        ate_line = [ln for ln in cli.stdout.splitlines()
                    if ln.startswith("ATE:")]
        want = f"ATE: {ate:.4f} m"
        check(len(ate_line) == 1 and ate_line[0].startswith(want),
              f"the CLI printed {ate_line}, the in-process run {want}")
        with open(outp) as a, open(outp + ".inproc") as b:
            same_tum = a.read() == b.read()
        check(same_tum, "the CLI's TUM file differs from the in-process run")
        with open(jsonl) as f:
            lines = [json.loads(ln) for ln in f]
        stream_checks(lines, s, outp, cli.stdout)
    print(f"[replay] OS-1-64 widths ({n_pts} points a scan), photometric + "
          f"radar config from YAML: bag, config and ground truth written in "
          f"{setup_s:.1f} s; replay_bag in process: {s.scan_idx} scan steps "
          f"of {c['scans']} scans, {c['radar_frames']} radar frames "
          f"consumed ({c['radar_dropped']} dropped before initialization), "
          f"ICP kernel launches {launches} (= {n1} x {s.scan_idx}), graph "
          f"replays {replays}, {1e3 * wall / c['scans']:.2f} ms a scan "
          f"incl. bag decode, first-call set-up and captures; ATE {ate:.5f} "
          f"m (gate {REPLAY_ATE_GATE}), RTE {rte:.3f}% (undefined below a "
          f"10 m path; this one is {path:.2f} m; not gated), photometric "
          f"features tracked a step median "
          f"{statistics.median(tracked):.0f} min {tracked.min():.0f}",
          flush=True)
    print(f"[replay] replay_bag(bulk=True) in process on the same bag: "
          f"{1e3 * bulk_wall / sb.counters['scans']:.2f} ms a scan incl. "
          f"bag decode, first-call set-up and captures; ATE {bulk_ate:.5f} m "
          f"(gate {REPLAY_ATE_GATE}); {sb.bulk_counts['chunks']} chunks, "
          f"{sb.bulk_counts['in_chunks']} events in chunks, "
          f"{sb.bulk_counts['streamed']} streamed; largest position gap to "
          f"the streamed replay (without the merged slide) "
          f"{np.abs(positions(sb) - est_p).max():.2e} m", flush=True)
    print(f"[replay] CLI subprocess (python -m mimosa_tpu_torch.io.replay) "
          f"exit 0 in {cli_s:.1f} s; its line '{ate_line[0]}' and its TUM "
          f"file ({len(tr)} poses) equal the in-process run's", flush=True)
    return launches, replays


def stream_checks(lines, s, tum, stdout):
    """[viz] (b): the CLI's debug stream of every scan (``lines``) against
    the in-process replay ``s`` of the same bag and the CLI's TUM file:
    one line per scan step, in order; each line's pose the TUM row of its
    time at the line's rounding (half a unit of its last decimal: the TUM
    text holds the f32 value's shortest repr); its ICP, degeneracy and
    photometric slots the in-process run's debug record of that scan; the
    last line's scan counters the run's final ones (radar frames after the
    last scan count on); the CLI prints the line count."""
    from mimosa_tpu_torch.utils import evaluation as ev

    check([ln["scan"] for ln in lines] == list(range(1, s.scan_idx + 1)),
          f"the CLI's debug stream holds scans "
          f"{[ln['scan'] for ln in lines]}, the run {s.scan_idx}")
    ts, p, q = ev.load_tum(tum)
    rec = s.debug_records()
    for ln in lines:
        k = int(np.argmin(np.abs(ts - ln["ts"])))
        r = rec[ln["scan"] - 1]
        check(abs(ts[k] - ln["ts"]) < 1e-6
              and np.abs(np.asarray(ln["p"]) - p[k]).max() <= 5.01e-5
              and np.abs(np.asarray(ln["q_wxyz"]) - q[k]).max() <= 5.01e-7,
              f"debug line of scan {ln['scan']}: pose {ln['p']} "
              f"{ln['q_wxyz']}, the TUM row {p[k]} {q[k]}")
        check(ln["icp_inliers"] == int(r[0])
              and ln["icp_status"] == [int(v) for v in r[1:5]]
              and ln["degen_rot"] == [bool(v > 0.5) for v in r[6:9]]
              and ln["degen_trans"] == [bool(v > 0.5) for v in r[9:12]]
              and ln["photo_tracked"] == int(r[12]),
              f"debug line of scan {ln['scan']} against the in-process "
              f"record {r.tolist()}")
    last = {k: v for k, v in lines[-1]["counters"].items()
            if k.startswith("scans")}
    check(last == {k: v for k, v in s.counters.items()
                   if k.startswith("scans")},
          f"the last debug line's counters {lines[-1]['counters']}, the "
          f"run's {s.counters}")
    check(f"({len(lines)} lines)" in stdout, "the CLI's line count")
    print(f"[viz] (b) the bag CLI with --debug-stream --stream-every 1: "
          f"{len(lines)} lines (scans 1-{s.scan_idx}), each line's pose the "
          f"TUM row of its time at the line's rounding, its ICP, degeneracy "
          f"and photometric slots the in-process run's records, the last "
          f"line's scan counters the run's final ones; photometric features "
          f"tracked a line median "
          f"{statistics.median(ln['photo_tracked'] for ln in lines):.0f}",
          flush=True)


# the two scoreboard rows of the offline refinement
# (scripts/dataset_evaluation.py:278-281): name, synthetic_replay.run
# keywords, the JAX package's ATE / RTE (ACCURACY_r05.json, on the TPU)
REFINE_ROWS = (
    ("room_noisy_two_pass", dict(two_pass=True, **NOISY), "5.4 mm / 0.035%"),
    ("room_noisy_smooth", dict(two_pass=True, smooth=True, **NOISY),
     "3.6 mm / 0.020%"),
)
REFINE_GATES = (0.080, 0.5)   # ATE [m], RTE [%] of both rows
REFINE_PROF = 3               # pass 2's last scans, run under the profiler
SMOOTH_CARD_CPU = 1e-4        # [m] the smoother on the card against the CPU
BULK_TWO_PASS_GAP = 1e-6      # [m] bulk pass 2 against streamed pass 2


def digest(tensors):
    """sha256 of the bytes of ``tensors``, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def kf_digest(s):
    return digest((s.kf_q, s.kf_p, s.kf_count))


@contextlib.contextmanager
def recorded_passes():
    """``synthetic_replay.replay`` replaced by the same scan-by-scan feed
    with records around each pass: the map's digest before its first scan
    and after its last, the keyframes' after its first scan (the
    initialization sets keyframe 0) and after its last, host ms a scan with
    a synchronize after each, and for a frozen pass the ICP launches
    counted from 0 and the profiler's ICP kernels over its last scans.
    Yields the list of records, one a pass."""
    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.io import synthetic_replay as sr
    from mimosa_tpu_torch.ops import icp_cuda

    passes = []

    def replay(s, data):
        n = len(data["scans"])
        frozen = s.cfg.freeze_map
        rec = dict(s=s, frozen=frozen, map_before=digest(s.vmap))
        passes.append(rec)
        if frozen:
            icp_cuda.LAUNCHES = 0
        ms, imu_i = replay_timed(s, data, range(1))
        rec["kf_first"] = kf_digest(s)
        more, imu_i = replay_timed(s, data, range(1, n - REFINE_PROF), imu_i)
        ms += more
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if frozen
              else contextlib.nullcontext()) as prof:
            more, _ = replay_timed(s, data, range(n - REFINE_PROF, n), imu_i)
        ms += more
        rec.update(ms=ms, map_after=digest(s.vmap), kf_last=kf_digest(s),
                   launches=icp_cuda.LAUNCHES if frozen else None,
                   ran=None if prof is None else sum(
                       1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "icp_linearize_kernel" in e.name))
        return n

    saved = sr.replay
    sr.replay = replay
    try:
        yield passes
    finally:
        sr.replay = saved


@contextlib.contextmanager
def timed_smoother(record):
    """``graph.refine.smooth`` timed where it is called: host seconds (with
    a synchronize), peak device memory, K0 (``record``)."""
    from mimosa_tpu_torch.graph import refine

    saved = refine.smooth

    def smooth(s, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = saved(s, *args, **kw)
        torch.cuda.synchronize()
        record.update(s=time.perf_counter() - t0, K0=len(out[0]),
                      peak=(torch.cuda.max_memory_allocated() - base) / 2**20)
        return out

    refine.smooth = smooth
    try:
        yield
    finally:
        refine.smooth = saved


def refine_rows(room_noisy):
    """(a) room_noisy_two_pass and room_noisy_smooth through the port's
    ``synthetic_replay.run`` on the card, captured, each under the rows'
    gates, beside the JAX package's values and this run's one-pass
    room_noisy (``room_noisy``: (ATE, RTE)); pass 2's map and keyframes
    bitwise frozen, pass 1's map untouched, pass 2's ICP launches and the
    profiler's count. Returns pass 2's ICP launches and the profiler's
    ICP kernels of the first row."""
    from mimosa_tpu_torch.io import synthetic_replay as sr
    from mimosa_tpu_torch.utils import evaluation as ev

    out_launches = out_ran = None
    for name, kw, jax_vals in REFINE_ROWS:
        sm = {}
        with recorded_passes() as passes, timed_smoother(sm):
            out = sr.run(verbose=False, **kw)
        s, data = out["sequencer"], out["data"]
        check(len(passes) == 2 and passes[1]["s"] is s, f"{name}: passes")
        p1, p2 = passes
        check(s.device.type == "cuda" and s.graphs is not None
              and s.graphs.replays > 0 and s.cfg.freeze_map
              and not p1["s"].cfg.freeze_map,
              f"{name}: pass 2 did not replay frozen captured steps")
        # pass 2 starts from a copy of pass 1's final map and keeps it
        # and its keyframes; pass 1's map is left as it was
        check(p2["map_before"] == p1["map_after"] == p2["map_after"]
              == digest(p1["s"].vmap), f"{name}: a map changed")
        check(p2["kf_first"] == p2["kf_last"] and s.num_keyframes == 1,
              f"{name}: pass 2 changed its keyframes "
              f"({s.num_keyframes} keyframes)")
        shared = {t.untyped_storage().data_ptr() for t in p1["s"].vmap} & \
            {t.untyped_storage().data_ptr() for t in s.vmap}
        check(not shared, f"{name}: the passes share map storage")
        n1 = s.cfg.n_gn_iters + 1
        check(p2["launches"] == n1 * s.scan_idx, f"{name}: pass 2 launched "
              f"the ICP kernel {p2['launches']} times in {s.scan_idx} scan "
              f"steps")
        check(p2["ran"] == n1 * REFINE_PROF, f"{name}: the profiler saw "
              f"{p2['ran']} ICP kernels in pass 2's last {REFINE_PROF} "
              f"scan steps")
        if out_launches is None:
            out_launches, out_ran = p2["launches"], p2["ran"]
        if kw.get("smooth"):
            ts, _, p = s.smoothed
            ate, label = out["ate_smooth"], "smoothed"
        else:
            tr = s.trajectory
            ts = np.asarray([t for t, _, _ in tr])
            p = np.asarray([q for _, q, _ in tr])
            ate, label = out["ate"], "pass 2"
        rte = ev.rte(np.asarray(ts), np.asarray(p), data["gt"]["ts"],
                     data["gt"]["pos"])
        gate, rte_gate = REFINE_GATES
        print(f"[refine] {name}: {label} ATE {ate:.5f} m (gate {gate}), RTE "
              f"{rte:.3f}% (gate {rte_gate}%); the JAX package {jax_vals}; "
              f"the port's one-pass room_noisy in this run "
              f"{1e3 * room_noisy[0]:.2f} mm / {room_noisy[1]:.3f}%; pass 2 "
              f"ATE {out['ate']:.5f} m; {s.scan_idx} scan steps a pass, "
              f"ms a scan (synchronized, median of steps 6-) pass 1 "
              f"{statistics.median(p1['ms'][5:]):.2f}, pass 2 "
              f"{statistics.median(p2['ms'][5:]):.2f}; pass 2: map digest "
              f"{p2['map_before'][:12]} before its first scan and after its "
              f"last, = pass 1's final map, still pass 1's; keyframes 1, "
              f"unchanged from its first scan to its last; ICP kernel "
              f"launches {p2['launches']} (= {n1} x {s.scan_idx}), the "
              f"profiler saw {p2['ran']} run in its last {REFINE_PROF} scan "
              f"steps", flush=True)
        if sm:
            print(f"[refine] {name}: smoother over K0 = {sm['K0']} rows, "
                  f"{sm['s']:.3f} s host (synchronized), peak device memory "
                  f"{sm['peak']:.1f} MiB above its inputs", flush=True)
        check(ate < gate and rte < rte_gate,
              f"{name}: ATE {ate:.4f} m, RTE {rte:.3f}%")
    return out_launches, out_ran


def cpu_copy(s):
    """The finished replay ``s`` as ``graph.refine.smooth`` reads it, in
    CPU tensors: the smoother then runs on the CPU."""
    import types

    H6 = s.pose_info_records()
    n = len(s._traj_ts)
    return types.SimpleNamespace(
        _traj_ts=list(s._traj_ts), traj_q=s.traj_q[:n].cpu(),
        traj_p=s.traj_p[:n].cpu(), cfg=s.cfg, win_cfg=s.win_cfg,
        window=types.SimpleNamespace(p=s.window.p.cpu(),
                                     g_dir=s.window.g_dir.cpu()),
        pose_info_records=lambda: H6.copy())


def refine_bag():
    """(b) the replay cell's 64x1024 photometric bag with 20 Hz radar:
    ``replay_bag(two_pass=True, smooth=True)`` in this process, the CLI with
    ``--two-pass --smooth --out`` as a subprocess (exit 0, its TUM file and
    ATE lines equal to the in-process run's), pass 2's and the smoothed
    ATE under REPLAY_ATE_GATE, ``bulk=True`` pass 2 within
    BULK_TWO_PASS_GAP of streamed pass 2; the smoother timed alone (host
    seconds, device busy from the profiler, peak memory, K0 by row kind);
    (c) the smoother on the CPU on the same inputs, within
    SMOOTH_CARD_CPU."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from mimosa_tpu_torch.graph import refine
    from mimosa_tpu_torch.io.replay import replay_bag, write_smoothed_tum
    from mimosa_tpu_torch.io.rosbag import Bag
    from mimosa_tpu_torch.ops import icp_cuda
    from mimosa_tpu_torch.utils import evaluation as ev

    with tempfile.TemporaryDirectory() as tmp:
        bag, cfgp, gtp, radar, n_pts = replay_files(tmp)
        outp = os.path.join(tmp, "refined.tum")
        kw = dict(radar_topic="/radar", max_scan_points=n_pts, verbose=False,
                  two_pass=True)
        icp_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        s = replay_bag(bag, cfgp, "/imu", "/points", smooth=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = icp_cuda.LAUNCHES
        n1 = s.cfg.n_gn_iters + 1
        check(s.cfg.freeze_map and s.num_keyframes == 1
              and launches == 2 * n1 * s.scan_idx, f"bag: pass 2 frozen, "
              f"{s.num_keyframes} keyframes, {launches} ICP launches in 2 x "
              f"{s.scan_idx} scan steps")
        write_smoothed_tum(outp + ".inproc", s.smoothed)
        gt_ts, gt_p, _ = ev.load_tum(gtp)
        est_p = positions(s)
        est_ts = np.asarray([t for t, _, _ in s.trajectory])
        ate = ev.ate(est_ts, est_p, gt_ts, gt_p)
        sm_ts, _, sm_p = s.smoothed
        ate_s = ev.ate(sm_ts, sm_p, gt_ts, gt_p)
        check(ate < REPLAY_ATE_GATE and ate_s < REPLAY_ATE_GATE,
              f"bag: pass 2 ATE {ate:.4f} m, smoothed {ate_s:.4f} m")

        # the same two passes through the bulk scheduler
        t0 = time.perf_counter()
        sb = replay_bag(bag, cfgp, "/imu", "/points", bulk=True, **kw)
        torch.cuda.synchronize()
        bulk_wall = time.perf_counter() - t0
        check(sb.cfg.freeze_map and sb.counters == s.counters
              and sb._traj_ts == s._traj_ts, "bag: bulk pass 2's schedule")
        bulk_gap = float(np.abs(positions(sb) - est_p).max())
        check(bulk_gap < BULK_TWO_PASS_GAP, f"bag: bulk pass 2 is "
              f"{bulk_gap:.3e} m from streamed pass 2")

        # the CLI
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "mimosa_tpu_torch.io.replay", "--bag", bag,
             "--config", cfgp, "--imu-topic", "/imu", "--lidar-topic",
             "/points", "--radar-topic", "/radar", "--max-scan-points",
             str(n_pts), "--gt", gtp, "--out", outp, "--two-pass",
             "--smooth"], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"the refining replay CLI exited "
              f"{cli.returncode}:\n{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
        lines = [ln for ln in cli.stdout.splitlines() if "ATE:" in ln]
        want = [f"ATE: {ate:.4f} m", f"smoothed ATE: {ate_s:.4f} m"]
        check(len(lines) == 2 and all(a.startswith(b)
                                      for a, b in zip(lines, want)),
              f"the CLI printed {lines}, the in-process run {want}")
        with open(outp) as a, open(outp + ".inproc") as b:
            check(a.read() == b.read(), "the refining CLI's TUM file "
                  "differs from the in-process run's")

        # the smoother alone on pass 2's replay, then under the profiler,
        # then on the CPU on the same inputs
        imu = [m for _, _, _, m in Bag(bag).messages({"/imu"})]
        args = (np.asarray([m["stamp"] for m in imu]),
                np.asarray([m["acc"] for m in imu]),
                np.asarray([m["gyro"] for m in imu]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        alone = refine.smooth(s, *args)
        torch.cuda.synchronize()
        sm_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        check(all(np.array_equal(a, b) for a, b in zip(alone, s.smoothed)),
              "the smoother gave other bits on the same replay")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            refine.smooth(s, *args)
            torch.cuda.synchronize()
        busy, n_dev = device_busy_ms(prof.events())
        t0 = time.perf_counter()
        cpu = refine.smooth(cpu_copy(s), *args)
        cpu_s = time.perf_counter() - t0
        card_cpu = float(np.abs(cpu[2] - s.smoothed[2]).max())
        check(card_cpu < SMOOTH_CARD_CPU, f"the smoother on the card and "
              f"on the CPU differ by {card_cpu:.3e} m")
        K0 = len(sm_ts)
        scan_rows = sum(1 for src in s._traj_src if src >= 0)
        weak = int((np.abs(s.pose_info_records()).max(axis=(1, 2))
                    < 1e-9).sum())
    print(f"[refine] bag (OS-1-64, 64 x 1024, photometric + 20 Hz radar): "
          f"replay_bag(two_pass=True, smooth=True) {s.scan_idx} scan steps "
          f"a pass, {wall:.1f} s for both passes and the smoother "
          f"({1e3 * wall / (2 * s.counters['scans']):.2f} ms a scan incl. "
          f"bag decode, set-up and captures); ICP kernel launches {launches} "
          f"(= {n1} x 2 x {s.scan_idx}); keyframes in pass 2: 1; pass 2 ATE "
          f"{ate:.5f} m, smoothed ATE {ate_s:.5f} m (gate "
          f"{REPLAY_ATE_GATE})", flush=True)
    print(f"[refine] bag: replay_bag(two_pass=True, bulk=True) "
          f"{bulk_wall:.1f} s, {sb.bulk_counts['chunks']} chunks in pass 2; "
          f"largest position "
          f"gap to streamed pass 2 {bulk_gap:.2e} m (gate "
          f"{BULK_TWO_PASS_GAP}); CLI --two-pass --smooth exit 0 in "
          f"{cli_s:.1f} s, its lines {lines} and its TUM file ({K0} poses) "
          f"equal the in-process run's", flush=True)
    print(f"[refine] bag smoother: K0 = {K0} rows ({scan_rows} scan rows, "
          f"{K0 - scan_rows} radar and initialization rows, {weak} weakly "
          f"anchored); alone {sm_s:.3f} s host (synchronized), device busy "
          f"{busy:.1f} ms in {n_dev} device ops (profiler), peak device "
          f"memory {peak:.1f} MiB above its inputs; on the CPU {cpu_s:.3f} "
          f"s, largest position gap card to CPU {card_cpu:.2e} m (gate "
          f"{SMOOTH_CARD_CPU})", flush=True)


def refine_phase(room_noisy):
    """The offline refinement: (a) the two scoreboard rows, (b) the bag CLI
    with ``--two-pass --smooth`` at 64x1024, (c) the smoother on the card
    against the CPU. ``room_noisy``: this run's one-pass room_noisy (ATE,
    RTE). Returns pass 2's ICP launches and the profiler's count in (a)'s
    first row."""
    launches, ran = refine_rows(room_noisy)
    refine_bag()
    return launches, ran


# the tracking-loss rescue (tests/test_rescue.py): a radius of 2.5 map
# leaves, and a kick of the whole window by ~2.5 leaves in x and y
RESCUE_KW = dict(rescue_enabled=True, rescue_radius=1.0)
KICK = (0.85, 0.5, 0.0)
RESCUE_T = 5.0            # [s] of the entry-width room (38 scan steps)
KICK_AT = 15              # the scan before which the window is kicked
RESCUE_SKIP = 8           # states after the kick left out of the tail ATE
RESCUE_TAIL_GATE = 0.10   # [m] tests/test_rescue.py's tail ATE gate
RESCUE_ON_OFF_GAP = 1e-6  # [m] a clean stream, rescue on against off
REMATCH_EAGER_SCANS = 20  # the eager rematch run's depth (of 120 scans)


def kick(s, dp):
    """Shift every window state, values and linearization points, by dp:
    the map then disagrees with everything the estimator believes."""
    dp = torch.tensor(dp, dtype=s.window.p.dtype, device=s.window.p.device)
    s.window = s.window._replace(p=s.window.p + dp,
                                 lin_p=s.window.lin_p + dp)


def rescue_data():
    """The entry-width room (64x512 LiDAR), RESCUE_T seconds."""
    from mimosa_tpu_torch.io import synthetic as syn

    return syn.generate(syn.room_world(), syn.TrajectoryConfig(
        t_total=RESCUE_T), syn.LidarModel(n_rows=64, n_cols=512), seed=0)


def scan_ranges(s, data, at=None, stretch=()):
    """Feed every scan, a synchronize after each, the window kicked before
    scan ``at``; the scans in ``stretch`` each in a profiler range "scan k".
    Returns (host ms a scan, profile or None, ICP launches counted over the
    stretch)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mimosa_tpu_torch.io.synthetic_replay import feed
    from mimosa_tpu_torch.ops import icp_cuda

    ms, imu_i, prof, counted = [], 0, None, 0
    for k in range(len(data["scans"])):
        if k == at:
            kick(s, KICK)
        if stretch and k == stretch[0]:
            counted = icp_cuda.launches()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        with (record_function(f"scan {k}") if k in stretch
              else contextlib.nullcontext()):
            imu_i = feed(s, data, k, imu_i)
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if stretch and k == stretch[-1]:
            prof.__exit__(None, None, None)
            counted = icp_cuda.launches() - counted
    return ms, prof, counted


def tail_ate(s, data, at):
    """ATE of the trajectory with the RESCUE_SKIP states from ``at`` on
    left out (tests/test_rescue.py:80-88)."""
    from mimosa_tpu_torch.io import synthetic as syn

    tr = s.trajectory
    keep = [i for i in range(len(tr)) if not at <= i < at + RESCUE_SKIP]
    return syn.ate_rmse(np.asarray([tr[i][0] for i in keep]),
                        np.asarray([tr[i][1] for i in keep]),
                        data["gt"]["ts"], data["gt"]["pos"])


def rescue_kicked(data):
    """(a) the kicked stream at entry widths, captured then eager: the
    rescue flag on the same scans, the gap, the tail ATE, the rescued
    scan's device ms and ops beside a steady scan's, and the profiler's
    ICP kernels over the stretch against the count. Returns the captured
    run's ICP launches, the profiler's, the predicate kernel's launches
    and the captured trajectory."""
    from mimosa_tpu_torch.ops import cond_cuda, icp_cuda

    stretch = tuple(range(KICK_AT - 2, KICK_AT + 2))
    runs = {}
    for name, eager in (("captured", False), ("eager", True)):
        s = entry_sequencer(seq_kw=RESCUE_KW, eager=eager)
        icp_cuda.reset_launches()
        cond_cuda.LAUNCHES = 0
        ms, prof, counted = scan_ranges(s, data, KICK_AT,
                                        stretch if not eager else ())
        flags = s.debug_records()[:, 16]
        runs[name] = dict(s=s, ms=ms, flags=flags, traj=positions(s),
                          launches=icp_cuda.launches(),
                          nodes=cond_cuda.LAUNCHES, prof=prof,
                          counted=counted)
        check(flags.sum() >= 1, f"rescue, {name}: the kick did not trigger "
              f"the rescue")
        ate = tail_ate(s, data, KICK_AT)
        check(ate < RESCUE_TAIL_GATE, f"rescue, {name}: tail ATE {ate:.4f} "
              f"m >= {RESCUE_TAIL_GATE}")
        runs[name]["ate"] = ate
        print(f"[rescue] (a) {name}: rescued scans (slot 16) "
              f"{(np.nonzero(flags)[0] + 1).tolist()} of {len(flags)} "
              f"(the window kicked before scan {KICK_AT}), tail ATE "
              f"{ate:.5f} m (gate {RESCUE_TAIL_GATE}, the {RESCUE_SKIP} "
              f"states after the kick left out), ICP launches "
              f"{runs[name]['launches']}, ms a scan (synchronized) median "
              f"{statistics.median(ms[3:]):.2f}, the rescued scan "
              f"{max(ms[KICK_AT - 1:KICK_AT + 1]):.2f}"
              + ("" if eager else " (under the profiler)"), flush=True)
    cap, eag = runs["captured"], runs["eager"]
    check(np.array_equal(cap["flags"], eag["flags"]), "rescue: captured and "
          "eager rescued other scans")
    gap = float(np.abs(cap["traj"] - eag["traj"]).max())
    check(gap < CAPTURE_GAP, f"rescue: captured and eager positions differ "
          f"by {gap:.4f} m")
    events = cap["prof"].events()
    # the profiler's records named for the kernel are printed, not held to
    # the count: inside a conditional node's body it names other kernels as
    # this one and loses records (PERF.md section 6); the count (the
    # host's, with the bodies' device counter folded in) is held to the
    # code's
    ran = sum(1 for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "icp_linearize_kernel" in e.name)
    cap["ran"] = ran
    dev = busy_by_range(events, [f"scan {k}" for k in stretch])
    rescued = [k for k in stretch if cap["flags"][k - 1] > 0]
    steady = [k for k in stretch if cap["flags"][k - 1] == 0]
    check(rescued and steady, f"rescue: the stretch {stretch} lacks a "
          f"rescued or a steady scan")
    per = {k: dev[f"scan {k}"][:2] for k in stretch}
    n1 = cap["s"].cfg.n_gn_iters + 1
    body = 14 * 3 + n1 - 1
    want = n1 * len(stretch) + body * len(rescued)
    check(cap["counted"] == want, f"rescue: the count says "
          f"{cap['counted']} ICP launches over scans {stretch[0]}-"
          f"{stretch[-1]}, the code {want}")
    print(f"[rescue] (a) captured vs eager: gap {gap:.2e} m (gate "
          f"{CAPTURE_GAP}); scans {stretch[0]}-{stretch[-1]}: "
          f"{cap['counted']} ICP launches counted, with the conditional "
          f"bodies' device counter (= {n1} a scan + {body} on each rescued "
          f"scan); the profiler's records named for the kernel {ran}; device "
          f"ms / ops a scan: " + ", ".join(
              f"scan {k}{' (rescued)' if k in rescued else ''} "
              f"{v[0]:.3f} / {v[1]}" for k, v in per.items())
          + f"; the rescued scan adds "
          f"{per[rescued[0]][0] - per[steady[0]][0]:.3f} ms and "
          f"{per[rescued[0]][1] - per[steady[0]][1]} ops to a steady "
          f"scan's; predicate kernels {cap['nodes']} (one a captured scan "
          f"step)", flush=True)
    return cap


def steady_profile(s, data, n_prof=3):
    """Replay ``data`` through ``s`` with a synchronize a scan, the last
    ``n_prof`` scans under the profiler: (host ms a scan, device ms and
    ops a scan over the profiled scans)."""
    from torch.profiler import ProfilerActivity, profile

    n = len(data["scans"])
    ms, imu_i = replay_timed(s, data, range(n - n_prof))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay_timed(s, data, range(n - n_prof, n), imu_i)
    busy, n_dev = device_busy_ms(prof.events())
    return ms, busy / n_prof, n_dev / n_prof


def rescue_clean(data):
    """(b) the clean stream captured, rescue off then on: no rescue, the
    same positions, and the node's cost a steady scan."""
    out = {}
    for name, kw in (("off", None), ("on", RESCUE_KW)):
        s = entry_sequencer(seq_kw=kw)
        ms, busy, ops = steady_profile(s, data)
        out[name] = dict(traj=positions(s), flags=s.debug_records()[:, 16],
                         med=statistics.median(ms[5:]), busy=busy, ops=ops)
    check(out["on"]["flags"].sum() == 0, "rescue: the clean stream was "
          "rescued")
    gap = float(np.abs(out["on"]["traj"] - out["off"]["traj"]).max())
    check(gap <= RESCUE_ON_OFF_GAP, f"rescue: a clean stream with rescue on "
          f"differs from off by {gap:.3e} m")
    on, off = out["on"], out["off"]
    print(f"[rescue] (b) clean stream, captured, rescue on vs off: slot 16 "
          f"sum 0, gap {gap:.2e} m (gate {RESCUE_ON_OFF_GAP}); ms a steady "
          f"scan (synchronized, median) {on['med']:.2f} vs {off['med']:.2f}; "
          f"device ms / ops a scan (last 3) {on['busy']:.3f} / "
          f"{on['ops']:.0f} vs {off['busy']:.3f} / {off['ops']:.0f}: the "
          f"node adds {on['busy'] - off['busy']:.3f} ms and "
          f"{on['ops'] - off['ops']:.0f} ops a scan", flush=True)


def rematch_sequencer(rematch, eager=False, **kw):
    """room_noisy's Sequencer (``synthetic_replay.run``'s room settings:
    16x256 LiDAR, 4096 points, K=6, 2^17 voxels, int16 codec) with
    ``rematch_on_motion``; ``kw`` as the Sequencer takes them."""
    from mimosa_tpu_torch.graph import sequencer as seq
    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.mapping import voxel_hash as vh

    return seq.Sequencer(
        seq.SequencerConfig(max_scan_points=4096, n_geo_points=4096,
                            n_map_points=8192, geo_leaf=0.4,
                            map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
                            keyframe_rot_thresh=0.15,
                            rematch_on_motion=rematch),
        win.WindowConfig(K=6),
        vh.VoxelMapConfig(leaf_size=0.4, capacity_log2=17, plane_min_points=5,
                          lru_horizon=0),
        geo.GeometricConfig(sigma=0.05, loc_count_thresh=50.0), eager=eager,
        **kw)


def rescue_rematch():
    """(c) room_noisy with rematch_on_motion, captured (its ATE and RTE
    gates) and eager over its first REMATCH_EAGER_SCANS scans (the
    captured run's states there within the capture gate); device ms a
    scan, rematch on against off."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate

    data = syn.generate(syn.room_world(), syn.TrajectoryConfig(t_total=12.0),
                        syn.LidarModel(), seed=0, **NOISY)
    out = {}
    for name, rematch in (("off", False), ("on", True)):
        s = rematch_sequencer(rematch)
        ms, busy, ops = steady_profile(s, data)
        out[name] = dict(s=s, med=statistics.median(ms[5:]), busy=busy,
                         ops=ops, ate=trajectory_ate(s, data),
                         rte=row_rte(s, data))
    on, off = out["on"], out["off"]
    check(on["ate"] < 0.080, f"rematch: room_noisy ATE {on['ate']:.4f} m "
          f">= 0.080")
    check(on["rte"] < 0.5, f"rematch: room_noisy RTE {on['rte']:.3f}% >= "
          f"0.5%")
    short = dict(data, scans=data["scans"][:REMATCH_EAGER_SCANS])
    eag = rematch_sequencer(True, eager=True)
    replay_timed(eag, short, range(REMATCH_EAGER_SCANS))
    pe = positions(eag)
    gap = float(np.abs(positions(on["s"])[:len(pe)] - pe).max())
    check(gap < CAPTURE_GAP, f"rematch: captured and eager positions differ "
          f"by {gap:.4f} m")
    print(f"[rescue] (c) room_noisy with rematch_on_motion, captured: ATE "
          f"{on['ate']:.5f} m (gate 0.080), RTE {on['rte']:.3f}% (gate "
          f"0.5%); without: {off['ate']:.5f} m, {off['rte']:.3f}%; eager "
          f"over the first {REMATCH_EAGER_SCANS} scans against captured: gap "
          f"{gap:.2e} m (gate {CAPTURE_GAP}); ms a steady scan "
          f"(synchronized, median) {on['med']:.2f} vs {off['med']:.2f}; "
          f"device ms / ops a scan (last 3) {on['busy']:.3f} / "
          f"{on['ops']:.0f} vs {off['busy']:.3f} / {off['ops']:.0f}: "
          f"rematch adds {on['busy'] - off['busy']:.3f} ms and "
          f"{on['ops'] - off['ops']:.0f} ops a scan", flush=True)


def rescue_bulk(data):
    """(d) the kicked stream through add_scans_bulk (the rescued scan the
    first of a chunk) against merged streaming, both captured."""
    scans, imu = data["scans"], data["imu"]
    b = entry_sequencer(seq_kw=RESCUE_KW)
    s = entry_sequencer(merge_marginalize=True, seq_kw=RESCUE_KW)
    for x in (b, s):
        x.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
    b.add_scans_bulk(scans[:KICK_AT], chunk=BULK_MM_CHUNK)
    kick(b, KICK)
    b.add_scans_bulk(scans[KICK_AT:], chunk=BULK_MM_CHUNK)
    for k, sc in enumerate(scans):
        if k == KICK_AT:
            kick(s, KICK)
        s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"], sc["valid"])
    torch.cuda.synchronize()
    fb, fs = b.debug_records()[:, 16], s.debug_records()[:, 16]
    check(fb.sum() >= 1 and np.array_equal(fb, fs), f"rescue bulk: rescued "
          f"scans {(np.nonzero(fb)[0] + 1).tolist()} against streaming's "
          f"{(np.nonzero(fs)[0] + 1).tolist()}")
    check(b.bulk_counts["in_chunks"] > 0, f"rescue bulk: no chunk ran: "
          f"{b.bulk_counts}")
    gap = bulk_gap(b, s, "rescue bulk")
    print(f"[rescue] (d) the kicked stream in bulk (chunks of "
          f"{BULK_MM_CHUNK}) against merged streaming: rescued scans "
          f"{(np.nonzero(fb)[0] + 1).tolist()} in both, gap {gap:.2e} m (gate "
          f"{BULK_GAP}), {b.bulk_counts}", flush=True)


def rescue_phase():
    """The tracking-loss rescue and rematch-on-motion: (a) a kicked stream
    at entry widths captured and eager, (b) a clean stream rescue on and
    off, (c) room_noisy with rematch, (d) the kicked stream in bulk.
    Returns (a)'s captured run."""
    data = rescue_data()
    cap = rescue_kicked(data)
    rescue_clean(data)
    rescue_rematch()
    rescue_bulk(data)
    return cap


MESH_GAP = 0.05           # [m] mesh against single: tests/test_parallel.py:459
MESH_EAGER_SCANS = 10     # the eager mesh run's depth at entry widths
MESH_KICK_EAGER = KICK_AT + 2   # ... and on the kicked stream
SHARED_ROWS = (("room_clean", {}), ("room_noisy", NOISY))


@contextlib.contextmanager
def nccl_world():
    """A process group of one NCCL rank on this card (a hash store, no
    network) and the ("dp", "mp") mesh over it; destroyed on the way
    out."""
    import torch.distributed as dist

    from mimosa_tpu_torch.parallel import sharded

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield sharded.make_mesh(n_mp=1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def mesh_entry(mesh, single):
    """(a) the entry-width room through Sequencer(mesh=...), captured (the
    numbers of slice_run), eager over its first MESH_EAGER_SCANS scans, and
    held against ``single``, the slice phase's captured single-device run
    on the same data."""
    s, data = entry_replay(mesh=mesh)
    cap = slice_run("mesh", "entry widths on the mesh", s, data,
                    ENTRY_ATE_GATE)
    check(s.graphs.captures > 0 and s.graphs.replays > 0, "mesh: no "
          "captured step was replayed")
    eag = entry_sequencer(mesh=mesh, eager=True)
    replay_timed(eag, data, range(MESH_EAGER_SCANS))
    pe = positions(eag)
    gap_eager = float(np.abs(cap["traj"][:len(pe)] - pe).max())
    check(gap_eager < CAPTURE_GAP, f"mesh: captured and eager positions "
          f"differ by {gap_eager:.4f} m")
    check(cap["traj"].shape == single["traj"].shape, "mesh: trajectory "
          "lengths differ from the single device's")
    gap = float(np.abs(cap["traj"] - single["traj"]).max())
    check(gap < MESH_GAP, f"mesh: positions differ from the single "
          f"device's by {gap:.4f} m")
    print(f"[mesh] (a) entry widths, world size 1: captured against eager "
          f"(first {MESH_EAGER_SCANS} scans) {gap_eager:.2e} m (gate "
          f"{CAPTURE_GAP}); against the single-device captured run "
          f"{gap:.2e} m (gate {MESH_GAP}: the mesh matches afresh every GN "
          f"iteration); ATE {cap['ate']:.5f} vs {single['ate']:.5f} m; ms a "
          f"scan (synchronized) median {cap['med']:.2f} vs "
          f"{single['med']:.2f}, p90 {cap['p90']:.2f} vs "
          f"{single['p90']:.2f}; device ms a scan {cap['busy']:.3f} vs "
          f"{single['busy']:.3f}, device ops a scan {cap['n_dev']:.0f} vs "
          f"{single['n_dev']:.0f} (the sharding tax: "
          f"{cap['busy'] - single['busy']:+.3f} ms, "
          f"{cap['n_dev'] - single['n_dev']:+.0f} ops); NCCL kernels the "
          f"profiler saw a scan {cap['nccl']:.1f} (3 all-reduces a "
          f"linearization, in-place at world size 1)", flush=True)
    return cap


def mesh_kicked(mesh, kernel_us):
    """(c) the rescue phase's kicked stream on the mesh, captured (over
    scans KICK_AT-2..KICK_AT+1 the ICP launches counted against the code's:
    n_gn_iters + 1 a scan, and 14 x 3 + n_gn_iters more on a rescued one)
    and eager over its first MESH_KICK_EAGER scans. The profiler's records
    named for the ICP kernel over the stretch are printed, not gated: inside
    a conditional node's body the profiler names some ~1.2 us kernels as
    the ICP kernel, whose launch takes ``kernel_us`` (3.), so those records
    are also counted apart by their length. Returns the captured run's ICP
    launches."""
    from mimosa_tpu_torch.ops import icp_cuda

    data = rescue_data()
    stretch = tuple(range(KICK_AT - 2, KICK_AT + 2))
    s = entry_sequencer(seq_kw=RESCUE_KW, mesh=mesh)
    icp_cuda.reset_launches()
    ms, prof, counted = scan_ranges(s, data, KICK_AT, stretch)
    launches = icp_cuda.launches()
    flags = s.debug_records()[:, 16]
    check(flags[KICK_AT - 1] == 1, f"mesh rescue: the kicked scan "
          f"{KICK_AT} was not rescued: "
          f"{(np.nonzero(flags)[0] + 1).tolist()}")
    ate = tail_ate(s, data, KICK_AT)
    check(ate < RESCUE_TAIL_GATE, f"mesh rescue: tail ATE {ate:.4f} m >= "
          f"{RESCUE_TAIL_GATE}")
    eag = entry_sequencer(seq_kw=RESCUE_KW, mesh=mesh, eager=True)
    scan_ranges(eag, dict(data, scans=data["scans"][:MESH_KICK_EAGER]),
                KICK_AT)
    fe = eag.debug_records()[:, 16]
    check(np.array_equal(flags[:len(fe)], fe), "mesh rescue: captured and "
          "eager rescued other scans")
    pe = positions(eag)
    gap = float(np.abs(positions(s)[:len(pe)] - pe).max())
    check(gap < CAPTURE_GAP, f"mesh rescue: captured and eager positions "
          f"differ by {gap:.4f} m")
    events = prof.events()
    named = [e.time_range.elapsed_us() for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "icp_linearize_kernel" in e.name]
    ran = len(named)
    long = sum(1 for us in named if us >= kernel_us / 2)
    n1, body = s.cfg.n_gn_iters + 1, 14 * 3 + s.cfg.n_gn_iters
    rescued = [k for k in stretch if flags[k - 1] > 0]
    want = n1 * len(stretch) + body * len(rescued)
    check(counted == want, f"mesh rescue: the count says {counted} ICP "
          f"launches over scans {stretch[0]}-{stretch[-1]}, the code {want}")
    dev = busy_by_range(events, [f"scan {k}" for k in stretch])
    print(f"[mesh] (c) the kicked stream on the mesh: rescued scans "
          f"{(np.nonzero(flags)[0] + 1).tolist()} of {len(flags)} (the "
          f"window kicked before scan {KICK_AT}), tail ATE {ate:.5f} m "
          f"(gate {RESCUE_TAIL_GATE}); eager over the first "
          f"{MESH_KICK_EAGER} scans: the same flags, gap {gap:.2e} m (gate "
          f"{CAPTURE_GAP}); scans {stretch[0]}-{stretch[-1]}: {counted} ICP "
          f"launches counted (= {n1} a scan + {body} on each rescued one, "
          f"the candidates one after another); the profiler's records named "
          f"for the kernel {ran}, {long} of them at least half the "
          f"kernel's {kernel_us:.2f} us; device ms / ops a scan: "
          + ", ".join(
              f"scan {k}{' (rescued)' if k in rescued else ''} "
              f"{dev[f'scan {k}'][0]:.3f} / {dev[f'scan {k}'][1]}"
              for k in stretch)
          + f"; ICP launches in the run {launches}", flush=True)
    return launches


def mesh_shared_cache():
    """(d) room_clean and room_noisy (the scoreboard's 12 s rows at
    ``synthetic_replay.run``'s settings), each through a Sequencer of its
    own, then both through one step cache, their scans fed in turns: the
    same bits, and the graphs captured without the cache and with it."""
    from mimosa_tpu_torch.io import synthetic as syn
    from mimosa_tpu_torch.io.synthetic_replay import feed

    datas = [syn.generate(syn.room_world(), syn.TrajectoryConfig(
        t_total=12.0), syn.LidarModel(), seed=0, **kw)
        for _, kw in SHARED_ROWS]
    alone = [rematch_sequencer(False) for _ in datas]
    for s, d in zip(alone, datas):
        replay_timed(s, d, range(len(d["scans"])))
    cache = {}
    shared = [rematch_sequencer(False, step_cache=cache) for _ in datas]
    check(shared[0].graphs is shared[1].graphs, "the shared cache gave "
          "each Sequencer graphs of its own")
    imu = [0] * len(datas)
    t0 = time.perf_counter()
    for k in range(max(len(d["scans"]) for d in datas)):
        for j, (s, d) in enumerate(zip(shared, datas)):
            if k < len(d["scans"]):
                imu[j] = feed(s, d, k, imu[j])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for (name, _), s, a in zip(SHARED_ROWS, shared, alone):
        check(s.counters == a.counters, f"shared cache, {name}: counters "
              f"differ")
        for i, (x, y) in enumerate(zip(s.trajectory, a.trajectory)):
            check(x[0] == y[0] and np.array_equal(x[1], y[1])
                  and np.array_equal(x[2], y[2]), f"shared cache, {name}: "
                  f"state {i} differs from the unshared run's")
    alone_caps = sum(s.graphs.captures for s in alone)
    caps = shared[0].graphs.captures
    check(caps < alone_caps, f"shared cache: {caps} captures against "
          f"{alone_caps} without")
    print(f"[mesh] (d) step_cache: {' and '.join(n for n, _ in SHARED_ROWS)}"
          f" fed scan by scan in turns through one cache give the bits of "
          f"the unshared runs ({sum(len(d['scans']) for d in datas)} scans, "
          f"{secs:.2f} s interleaved, one state hand-over a step); graphs "
          f"captured {alone_caps} without the cache, {caps} with it",
          flush=True)
    return dict(alone=alone_caps, shared=caps)


def mesh_phase(single, kernel_us):
    """Sequencer(mesh=...) on a world of one NCCL rank: (a) entry widths
    against eager and the single device, (b) the four-modality stream,
    (c) the kicked stream (the rescue on the mesh), (d) the step cache.
    Returns (a)'s ICP launches and the profiler's ICP kernels."""
    clock = [time.perf_counter()]
    with nccl_world() as mesh:
        cap = mesh_entry(mesh, single)
        clock.append(time.perf_counter())
        data, events = mm_stream()
        mm = mm_run(False, data, events, mesh=mesh, tag="mesh")
        print(f"[mesh] (b) the four-modality stream on the mesh, captured: "
              f"ATE {mm['ate']:.5f} m (gate {ENTRY_ATE_GATE}), late paths "
              f"{ {k: mm['counters'].get(k) for k in MM_COUNTERS} }, radar "
              f"through the dp-split linearization", flush=True)
        clock.append(time.perf_counter())
        mesh_kicked(mesh, kernel_us)
        clock.append(time.perf_counter())
    mesh_shared_cache()
    clock.append(time.perf_counter())
    print("[mesh] seconds by part: " + ", ".join(
        f"({p}) {b - a:.1f}" for p, a, b in zip("abcd", clock, clock[1:])),
        flush=True)
    return cap["launches"], cap["ran"]


VIZ_POINTS = 8192         # icp_snapshot's points at entry widths
OVERLAY_PX = 1e-3         # [px] the overlay's feature centers, card vs CPU
def cpu_twin(s):
    """A CPU Sequencer of ``s``'s configuration holding ``s``'s state."""
    from mimosa_tpu_torch import convert
    from mimosa_tpu_torch.graph import sequencer as seq

    c = seq.Sequencer(s.cfg, s.win_cfg, s.map_cfg, s.geo_cfg, s.photo_cfg,
                      device="cpu")
    return convert.load_sequencer_state(c, convert.sequencer_state(s))


def viz_snapshot(cap):
    """(a) icp_snapshot on the slice's captured entry-width Sequencer and
    its last scan: one ICP launch, the kernel's result against the plain
    version on the card on the same inputs, the marker data's checks.
    Returns the launches and the snapshot's inputs."""
    from mimosa_tpu_torch.io import viz
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.ops import icp_cuda

    s, scan = cap["s"], cap["data"]["scans"][-1]
    args = (s, scan["points"], scan["valid"], VIZ_POINTS)
    icp_cuda.reset_launches()
    snap = viz.icp_snapshot(*args)
    launches = icp_cuda.launches()
    check(launches == 1, f"viz: the snapshot launched the ICP kernel "
          f"{launches} times, expected 1")
    inputs = viz.snapshot_inputs(*args)
    ref = geo.linearize_with(*inputs, s.geo_cfg, s.window.g_dir)
    err = icp_check(snap["icp"], ref, "viz snapshot")
    inl = snap["inlier"]
    check(int(inl.sum()) == snap["num_inlier"] > 50, f"viz: "
          f"{int(inl.sum())} inliers in the mask, {snap['num_inlier']} "
          f"counted")
    nn = np.linalg.norm(snap["normal"][inl], axis=-1)
    check(np.allclose(nn, 1.0, atol=1e-3), "viz: a normal is not unit")
    seg = float(np.median(np.linalg.norm(snap["p_w"][inl]
                                         - snap["foot"][inl], axis=-1)))
    check(seg < 0.1, f"viz: median point-to-plane segment {seg:.4f} m")
    host_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        viz.icp_snapshot(*args)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[viz] (a) icp_snapshot(max_points={VIZ_POINTS}) on the slice's "
          f"captured entry-width Sequencer, last scan: ICP kernel launches "
          f"{launches}; against the plain linearize_with on the card on the "
          f"same inputs: counts and flags exact, max |dH|,|db| {err:.3e} "
          f"(gate {KERNEL_TOL}); {snap['num_inlier']} inliers = the mask's, "
          f"unit normals, median |p_w - foot| {seg:.4f} m (gate 0.1); host "
          f"ms a snapshot median {statistics.median(host_ms):.2f} over 20 "
          f"(the result read to the host)", flush=True)
    return launches, inputs


def viz_overlay(photo):
    """(d) the feature overlay's device arrays at 64x1024 on the photometric
    slice's captured Sequencer and its last scan, card against a CPU twin:
    feature centers within OVERLAY_PX, the visibility masks equal."""
    from mimosa_tpu_torch.io import viz

    s, scan = photo["s"], photo["data"]["scans"][-1]
    args = (scan["points"], scan["intensity"], scan["valid"])
    t0 = time.perf_counter()
    card = viz.feature_overlay_arrays(s, *args)
    ms = (time.perf_counter() - t0) * 1e3
    cpu = viz.feature_overlay_arrays(cpu_twin(s), *args)
    img, fu, fv, vis, good = card
    d_u = float(np.abs(fu - cpu[1]).max())
    d_v = float(np.abs(fv - cpu[2]).max())
    check(max(d_u, d_v) <= OVERLAY_PX, f"viz overlay: feature centers "
          f"{d_u:.2e} / {d_v:.2e} px from the CPU's")
    check(np.array_equal(vis, cpu[3]) and np.array_equal(good, cpu[4]),
          "viz overlay: the masks differ from the CPU's")
    check(good.sum() > 0 and img.shape == (s.photo_cfg.rows,
                                           s.photo_cfg.cols),
          "viz overlay: no tracked feature on the image")
    d_img = np.abs(img - cpu[0])
    print(f"[viz] (d) feature overlay arrays at {img.shape[0]}x"
          f"{img.shape[1]} on the photometric slice's Sequencer, card vs "
          f"CPU: {len(fu)} feature slots, {int(vis.sum())} visible, "
          f"{int(good.sum())} on the usable mask (the same masks); centers "
          f"within {max(d_u, d_v):.2e} px (gate {OVERLAY_PX}); image pixels "
          f"off by more than 1e-3 {int((d_img > 1e-3).sum())} of {img.size}, "
          f"max {d_img.max():.3e} (printed: a beam on the field of view's "
          f"edge is in view by the last bit of asin); host ms on the card "
          f"{ms:.2f}", flush=True)


def viz_binary(cap, inputs):
    """(e) linearize_binary at N = VIZ_POINTS on (a)'s map and points, card
    against CPU; its identity-target source block against the ICP
    kernel's H and b on the same points."""
    import dataclasses

    from mimosa_tpu_torch.core import lie
    from mimosa_tpu_torch.lidar import geometric as geo
    from mimosa_tpu_torch.ops import icp_cuda

    s = cap["s"]
    _, pb, pv, q, t = inputs
    # the map's frame a little off the world's: the target state
    q_t, t_t = lie.se3_retract(*lie.se3_identity(q.dtype, q.device),
                               torch.tensor([0.002, -0.001, 0.003, 0.02,
                                             0.01, -0.01], device=q.device))
    cfg = dataclasses.replace(s.geo_cfg, use_4dof=False)
    args = (pb, pv, q, t, q_t, t_t)
    out = geo.linearize_binary(s.vmap, *args, s.map_cfg, cfg)
    cpu_map = type(s.vmap)(*(x.cpu() for x in s.vmap))
    ref = geo.linearize_binary(cpu_map, *(a.cpu() for a in args), s.map_cfg,
                               cfg)
    check(torch.equal(out.status_counts.cpu(), ref.status_counts),
          f"viz binary: counts {out.status_counts.tolist()} != CPU "
          f"{ref.status_counts.tolist()}")
    for name in ("H", "b", "mean_abs_res"):
        o, r = getattr(out, name).cpu(), getattr(ref, name)
        check(torch.allclose(o, r, **KERNEL_TOL), f"viz binary: {name} "
              f"differs from the CPU's by {(o - r).abs().max().item()}")
    q_i, t_i = lie.se3_identity(q.dtype, q.device)
    bi = geo.linearize_binary(s.vmap, pb, pv, q, t, q_i, t_i, s.map_cfg, cfg)
    una = icp_cuda.linearize(geo.match(s.vmap, pb, q, t, s.map_cfg), pb, pv,
                             q, t, cfg)
    check(torch.equal(bi.status_counts, una.status_counts), "viz binary: "
          "identity-target counts differ from the kernel's")
    for o, r, name in ((bi.H[:6, :6], una.H, "H"), (bi.b[:6], una.b, "b")):
        check(torch.allclose(o, r, **KERNEL_TOL), f"viz binary: the "
              f"identity target's {name} differs from the kernel's by "
              f"{(o - r).abs().max().item()}")
    ms = cuda_ms(lambda: geo.linearize_binary(s.vmap, *args, s.map_cfg, cfg))
    print(f"[viz] (e) linearize_binary at N={len(pb)} on the snapshot's "
          f"map and points: card vs CPU counts exact, H, b, mean |r| within "
          f"{KERNEL_TOL}; at an identity target its source block equals the "
          f"ICP kernel's H and b (same gate), counts exact; "
          f"{int(out.num_inlier)} inliers; {ms:.3f} ms a call on the card "
          f"(plain torch op by op, median of 50, CUDA events)", flush=True)


def viz_phase(cap, photo, online_ms):
    """[viz]: (a) the snapshot, (c) the live driver with a debug stream of
    every scan, (d) the overlay's device arrays, (e) the binary factor;
    (b), the bag CLI's stream, runs in the replay phase. Returns (a)'s ICP
    launches (the snapshot path)."""
    import os
    import tempfile

    from mimosa_tpu_torch.io.viz import DebugStream

    launches, inputs = viz_snapshot(cap)
    with tempfile.TemporaryDirectory() as tmp:
        stream = DebugStream(os.path.join(tmp, "online.jsonl"), every=1)
        try:
            _, _, ms, s = online_phase(stream, tag="[viz] (c)")
        finally:
            stream.close()
        with open(stream.path) as f:
            lines = [json.loads(ln) for ln in f]
    check([ln["scan"] for ln in lines] == list(range(1, s.scan_idx + 1)),
          f"viz online: the stream holds scans "
          f"{[ln['scan'] for ln in lines]} of {s.scan_idx}")
    print(f"[viz] (c) the live driver with a debug stream of every scan: "
          f"{len(lines)} lines, one a scan step; push to on_state ms median "
          f"{ms:.2f} against {online_ms:.2f} without the stream", flush=True)
    viz_overlay(photo)
    viz_binary(cap, inputs)
    return launches


OUSTER_CHUNK = 16
OUSTER_SEED = 3           # the shift table's seed (tests/test_bulk.py:143)


def ouster_data():
    """The photometric slice's 4 s room (its noise, world and trajectory) as
    a staggered Ouster OS-1-64 stream: 64 rows at the photometric slice's
    beam altitudes (row 0 the highest, as an Ouster table has them), 1024
    columns, a per-row shift table drawn as tests/test_bulk.py:143-145
    draws it, in the Ouster sensor frame. Returns (data, altitudes,
    shifts, q_b_l)."""
    from mimosa_tpu_torch.io import synthetic as syn

    lm = syn.LidarModel(n_rows=64, n_cols=1024)
    alts = np.linspace(lm.fov_up, lm.fov_down, lm.n_rows)
    shifts = np.random.default_rng(OUSTER_SEED).integers(
        0, lm.n_cols, lm.n_rows)
    data, q_b_l = syn.ouster_sensor_frame(syn.generate_ouster(
        syn.room_world(lx=30.0, ly=16.0, lz=6.0),
        syn.TrajectoryConfig(**PHOTO_TC), alts, shifts, n_cols=lm.n_cols,
        seed=0, imu_noise=0.01, range_noise=0.01))
    return data, alts, shifts, q_b_l


def ouster_sequencer(alts, shifts, q_b_l, merge_marginalize=False):
    """The photometric slice's Sequencer with the exact Ouster model (the
    staggered pixel-id fill, the yaw table, the re-skew) at its beam
    table, captured."""
    return photo_sequencer(
        False, seq_kw=dict(q_b_l=q_b_l, merge_marginalize=merge_marginalize),
        photo_kw=dict(beam_altitudes=tuple(float(a) for a in alts),
                      exact_ouster=True,
                      pixel_shift_by_row=tuple(int(x) for x in shifts)))


def ouster_phase():
    """[ouster]: the exact-Ouster photometric Sequencer at OS-1-64 widths,
    captured, through add_scans_bulk in chunks of OUSTER_CHUNK against
    merged streaming: ATE, slot 12 on every step after the second, the
    same slot 12 and positions within BULK_GAP, ICP launches
    n_gn_iters + 1 a scan step by the count; ms a scan and warm scans/s of
    both. Returns the bulk run's ICP launches."""
    from mimosa_tpu_torch.io.synthetic_replay import trajectory_ate
    from mimosa_tpu_torch.ops import icp_cuda
    from mimosa_tpu_torch.utils import evaluation as ev

    t0 = time.perf_counter()
    data, alts, shifts, q_b_l = ouster_data()
    scans, imu = data["scans"], data["imu"]
    n, n_warm = len(scans), len(scans) - OUSTER_CHUNK
    print(f"[ouster] {n} staggered scans of {len(scans[0]['points'])} points "
          f"(64 x 1024, shifts {shifts.min()}-{shifts.max()} columns) "
          f"generated in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    for name in ("streaming", "bulk"):
        s = ouster_sequencer(alts, shifts, q_b_l,
                             merge_marginalize=name == "streaming")
        s.add_imu_batch(imu["ts"], imu["acc"], imu["gyro"])
        icp_cuda.reset_launches()
        t0, captures = time.perf_counter(), []
        # the warm-up (the first scans) runs chunks of a quarter size, so
        # that the chunks' variant is captured before the timed chunk
        for part, chunk in ((scans[:n_warm], OUSTER_CHUNK // 4),
                            (scans[n_warm:], OUSTER_CHUNK)):
            if name == "bulk":
                s.add_scans_bulk(part, chunk=chunk)
                check(s.bulk_counts["chunks"] > 0, f"ouster: no chunk ran "
                      f"in the warm-up: {s.bulk_counts}")
            else:
                for sc in part:
                    s.add_scan(sc["ts_header"], sc["points"], sc["t_rel"],
                               sc["valid"], intensity=sc["intensity"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            warm_s, t0 = t1 - t0, t1
            captures.append(s.graphs.captures if s.graphs else 0)
        check(captures[0] == captures[1], f"ouster {name}: the timed scans "
              f"captured {captures[1] - captures[0]} graphs")
        launches = icp_cuda.launches()
        n1 = s.cfg.n_gn_iters + 1
        check(launches == n1 * s.scan_idx, f"ouster {name}: ICP kernel "
              f"launched {launches} times in {s.scan_idx} scan steps")
        tracked = s.debug_records()[:, 12]
        check((tracked[2:] > 0).all(), f"ouster {name}: the exact model "
              f"tracked no feature on a steady step: {tracked.tolist()}")
        ate = trajectory_ate(s, data)
        check(ate < PHOTO_ATE_GATE, f"ouster {name}: ATE {ate:.4f} m >= "
              f"{PHOTO_ATE_GATE}")
        tr = s.trajectory
        rte = ev.rte(np.asarray([t for t, _, _ in tr]),
                     np.asarray([p for _, p, _ in tr]), data["gt"]["ts"],
                     data["gt"]["pos"])
        runs[name] = dict(s=s, launches=launches, tracked=tracked, ate=ate,
                          rte=rte, rate=OUSTER_CHUNK / warm_s)
    b, st = runs["bulk"], runs["streaming"]
    check(b["s"].bulk_counts["in_chunks"] >= OUSTER_CHUNK, f"ouster: "
          f"{b['s'].bulk_counts}")
    check(np.array_equal(b["tracked"], st["tracked"]), "ouster: bulk and "
          "streaming tracked other features")
    gap = bulk_gap(b["s"], st["s"], "ouster")
    print(f"[ouster] exact-Ouster photometric Sequencer at 64x1024, "
          f"captured: {b['s'].scan_idx} scan steps; bulk (chunks of "
          f"{OUSTER_CHUNK}) against merged streaming: gap {gap:.2e} m (gate "
          f"{BULK_GAP}), the same slot 12 (features tracked a step median "
          f"{statistics.median(st['tracked'][2:]):.0f}, min "
          f"{st['tracked'][2:].min():.0f} of "
          f"{st['s'].photo_cfg.num_features}); ATE {b['ate']:.5f} m (gate "
          f"{PHOTO_ATE_GATE}), RTE {b['rte']:.3f}% (not gated: under a 10 m "
          f"path); ICP kernel launches {b['launches']} (= "
          f"{b['s'].cfg.n_gn_iters + 1} x {b['s'].scan_idx}); warm scans/s "
          f"over the last {OUSTER_CHUNK} scans (one chunk; one synchronize; "
          f"the warm-up in chunks of {OUSTER_CHUNK // 4}): bulk "
          f"{b['rate']:.2f} ({1e3 / b['rate']:.2f} ms a scan), streaming "
          f"{st['rate']:.2f} ({1e3 / st['rate']:.2f} ms a scan); "
          f"{b['s'].bulk_counts}", flush=True)
    return b["launches"]


def cond_kernel_phase(dev):
    """The conditional node's predicate kernel (``ops/cond_cuda.py``)
    against its plain version, the host read of the predicate: a graph
    whose node doubles a [8192, 3] tensor, replayed with the predicate
    false and true, against the same choice made on the host. Its time: a
    step of that graph with the predicate false (the input copy, the
    kernel and the node, the body skipped) against the host read."""
    from mimosa_tpu_torch.graph import captured

    x0 = torch.arange(8192 * 3, dtype=torch.float32,
                      device=dev).reshape(8192, 3)
    flag = torch.zeros(1, device=dev)

    def fn(state, flag):
        (y,) = state
        return captured.cond(flag[0] > 0.5, lambda: (y * 2.0,), (y,))

    steps = captured.CapturedSteps(dev)
    x, ref, err = x0.clone(), x0.clone(), 0.0
    for f in (0, 1, 0, 1, 1, 0):
        flag.fill_(float(f))
        (x,) = steps.run("cond", fn, (x,), (flag,))
        ref = ref * 2.0 if f else ref
        torch.cuda.synchronize()
        err = max(err, float((x - ref).abs().max()))
    check(err == 0.0, f"cond: the node's result differs from the host "
          f"branch's by {err}")
    flag.fill_(0.0)
    ms = cuda_ms(lambda: steps.run("cond", fn, (x,), (flag,)))
    pred = flag[0] > 0.5
    plain_ms = cuda_ms(lambda: bool(pred))
    nbytes = 1
    bound_ms = 1e3 * nbytes / HBM_BYTES_S
    print(f"[kernel] cond predicate: a node holding a [8192, 3] doubling "
          f"replayed with the predicate false and true equals the host "
          f"branch (max |d| {err}); a step, predicate false, {ms:.4f} ms "
          f"against the host read {plain_ms:.4f} ms (median of 50, CUDA "
          f"events); bound {1e3 * bound_ms:.6f} us by bytes", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from mimosa_tpu_torch import native, require_cuda
    from mimosa_tpu_torch.ops import cond_cuda, icp_cuda

    dev = require_cuda()
    smi = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    icp_cuda.build()
    secs, log = icp_cuda.build_info
    print(f"[build] {icp_cuda.SOURCE.name} -> {icp_cuda.BUILD_DIR} in "
          f"{secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    cond_cuda.build()
    print(f"[build] {cond_cuda.SOURCE.name} -> {icp_cuda.BUILD_DIR} in "
          f"{cond_cuda.build_info[0]:.1f} s", flush=True)
    t0 = time.perf_counter()
    native.build()
    print(f"[build] {native.SOURCES[0].name} -> {native.BUILD_DIR} "
          f"({native.build_mode}) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    if "--stage-split" in sys.argv[1:]:
        stage_split_phase()
        return 0
    if "--chunk-graph" in sys.argv[1:]:
        chunk_graph_phase()
        return 0
    if "--mesh" in sys.argv[1:]:
        mesh_phase(entry_run(eager=False), 1e3 * kernel_phase(dev)[8192][
            "device_ms"])
        return 0
    if "--viz" in sys.argv[1:]:
        photo = slice_run("photo", "64x1024 photometric",
                          photo_sequencer(False), photo_data(),
                          PHOTO_ATE_GATE)
        replay_phase()
        viz_phase(entry_run(eager=False), photo, online_phase()[2])
        ouster_phase()
        return 0
    timings = kernel_phase(dev)
    cond_timing = cond_kernel_phase(dev)
    clock = [("start", time.perf_counter())]
    launches, ran, slice_cap = slice_phase()
    clock.append(("slice", time.perf_counter()))
    photo_launches, photo_ran, photo_cap = photo_phase()
    clock.append(("photo", time.perf_counter()))
    mm_launches, mm_ran = multimodal_phase()
    clock.append(("multimodal", time.perf_counter()))
    rows = scoreboard_phase()
    clock.append(("scoreboard", time.perf_counter()))
    bulk_launches, bulk_ran, bulk_mixed_launches = bulk_phase(
        rows["corridor_radar"])
    clock.append(("bulk", time.perf_counter()))
    online_launches, online_replays, online_ms, _ = online_phase()
    clock.append(("online", time.perf_counter()))
    replay_launches, replay_replays = replay_phase()
    clock.append(("replay", time.perf_counter()))
    refine_launches, refine_ran = refine_phase(rows["room_noisy"])
    clock.append(("refine", time.perf_counter()))
    rescue = rescue_phase()
    clock.append(("rescue", time.perf_counter()))
    mesh_launches, mesh_ran = mesh_phase(slice_cap,
                                         1e3 * timings[8192]["device_ms"])
    clock.append(("mesh", time.perf_counter()))
    viz_launches = viz_phase(slice_cap, photo_cap, online_ms)
    clock.append(("viz", time.perf_counter()))
    ouster_launches = ouster_phase()
    clock.append(("ouster", time.perf_counter()))
    print("[clock] seconds by phase: " + ", ".join(
        f"{n} {t - t_prev:.1f}" for (_, t_prev), (n, t)
        in zip(clock, clock[1:])), flush=True)

    at = timings[8192]
    rec = dict(name="icp_linearize", route="cuda",
               source="mimosa_tpu_torch/csrc/icp_linearize.cu",
               replaces="mimosa_tpu/ops/icp_pallas.py:169",
               launches=launches, max_abs_err=at["max_abs_err"],
               ms=at["ms"], plain_ms=at["plain_ms"],
               bound_ms=at["bound_ms"], bound_by=at["bound_by"],
               library_ms=None, bound_us=1e3 * at["bound_ms"],
               device_us=1e3 * at["device_ms"], host_ms=at["host_ms"],
               profiled_runs=ran, launches_photometric=photo_launches,
               profiled_runs_photometric=photo_ran,
               launches_multimodal=mm_launches,
               profiled_runs_multimodal=mm_ran,
               launches_online=online_launches,
               graph_replays_online=online_replays,
               launches_replay=replay_launches,
               graph_replays_replay=replay_replays,
               launches_bulk=bulk_launches, profiled_runs_bulk=bulk_ran,
               launches_bulk_mixed=bulk_mixed_launches,
               launches_refine=refine_launches,
               profiled_runs_refine=refine_ran,
               launches_rescue=rescue["launches"],
               profiled_runs_rescue=rescue["ran"],
               launches_mesh=mesh_launches, profiled_runs_mesh=mesh_ran,
               launches_viz=viz_launches, launches_ouster=ouster_launches)
    cond_rec = dict(name="cond_predicate", route="cuda",
                    source="mimosa_tpu_torch/csrc/graph_cond.cu",
                    replaces="mimosa_tpu/graph/sequencer.py:2348",
                    launches=rescue["nodes"], **cond_timing,
                    library_ms=None)
    print(json.dumps({"kernels": [rec, cond_rec]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
