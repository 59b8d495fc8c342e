"""The readings that the limits of ``limits/<cell>.json`` are set from,
on the card: for each seed, one run of the cell (its own window, at its
own size) judged against the reference, and the control, the reference
held in bfloat16 and put in the program's place at the same answers'
times, judged the same way. All seeds run in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 20

prints one JSON line a seed. The benchmark's own runs do not run this."""

import gc
import json
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def readings(bench, cell, seed, seconds, t_start=None):
    from benchmark import reference
    run = harness.measure(bench, cell, seed, seconds, False, t_start=t_start)
    ts, q, p = run.states
    qc, pc, _ = reference.truth(run.config, ts, "bfloat16")
    control = reference.judge(run.config, 0, ts, qc, pc)
    return run, control


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default=None,
                    help="a directory for each seed's answers (.npz)")
    args = ap.parse_args()
    bench = harness.Bench(ROOT)
    harness.host_threads(bench.config(bench.cell(args.workload)["config"]))
    import torch
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        run, control = readings(bench, args.workload, seed, args.seconds,
                                t_start)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, program=run.numbers,
            control=control, correct=run.correct, shown=run.shown,
            metrics=harness.report(bench, run, False),
            window_s=run.window.seconds, events=len(run.window.events),
            scans=run.window.scans, captures=run.window.captures,
            phases=run.phases, peak=run.memory_peak_bytes,
            timers={k: run.timer_s(k) for k in run.window.timers1},
            counts=run.counts)), flush=True)
        if args.dump:
            import numpy as np
            w = run.window
            ts, q, p = run.states
            np.savez(Path(args.dump) / f"{args.workload}_{seed}.npz", ts=ts,
                     q=q, p=p, kinds=np.array([k for k, _ in w.events]),
                     t_meas=np.array([t for _, t in w.events]),
                     latency=np.array(w.latency_s),
                     submit=np.array(w.submit_s))
        del run
        gc.collect()
        torch.cuda.empty_cache()
        t_start = time.time()


if __name__ == "__main__":
    harness.environment(ROOT)
    main()
