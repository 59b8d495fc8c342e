"""The harness as data: a cell, configuration, traffic mix and metric are
found by their names from added files alone; rates and percentiles come
from all the window's work; a run without a card measures nothing; no
module of the harness, the port it drives or the reference loads JAX or
the JAX package, and the reference loads nothing of the port."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.drive import Window
from benchmark.tests import tiny

REPO = tiny.REPO


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_added_files_and_entries_are_found(tmp_path):
    root = tiny.make(tmp_path)
    before = digest(root / "benchmark")
    d = root / "benchmark"
    # a four-modality rig: the enwide configuration with a radar and an
    # odometry source added, its LiDAR geometric only
    cfg = json.loads((d / "configs" / "enwide_pglio.json").read_text())
    cfg["sensors"]["lidar"]["intensity"] = False
    cfg["sensors"].update(
        radar={"rate": 20.0, "n_targets": 32, "noise": 0.02},
        odometry={"rate": 10.0, "cov": 1e-4, "noise_rot": 0.002,
                  "noise_trans": 0.005})
    del cfg["system"]["photometric"]
    cfg["system"].update(radar_factor={}, odometry_factor={})
    (d / "configs" / "four_small.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "traffic" / "stream.json").read_text())
    mix["late_radar"] = {"every": 2, "offsets": [1]}
    (d / "traffic" / "stream_late.json").write_text(json.dumps(mix))
    (d / "metrics" / "events_per_s.py").write_text(
        "def read(run):\n    return len(run.window.events) / "
        "run.window.seconds\n")
    (d / "limits" / "small_radar_late.json").write_text(
        json.dumps({"missing_states": 0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="four_small",
                                file="benchmark/configs/four_small.json"))
    spec["workloads"].append(dict(name="small_radar_late",
                                  config="four_small",
                                  traffic="stream_late", chips=1, why="x"))
    spec["per_layer"].append(dict(
        name="events_per_s", unit="events/s", better="higher",
        source="host_clock", layer="host loop", moves="pose_latency_p95_ms",
        workloads=["small_radar_late"]))
    spec["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["small_radar_late"])
        if m["name"] == "pose_latency_p95_ms" else m
        for m in spec["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digest(d)
    assert {k: v for k, v in after.items() if k in before} == before

    b = harness.Bench(root)
    assert b.config(b.cell("small_radar_late")["config"])["sensors"][
        "radar"]["n_targets"] == 32
    assert b.traffic("stream_late")["late_radar"]["every"] == 2
    assert [m["name"] for m in b.metrics("small_radar_late", True)] == \
        ["events_per_s"]
    run = harness.measure(b, "small_radar_late", 5, 1.0, False,
                          device="cpu")
    assert run.correct and run.counts["radar_frames"] > 0
    out = harness.report(b, run, True)
    assert out["events_per_s"]["value"] == pytest.approx(
        len(run.window.events) / run.window.seconds)


def test_host_threads_come_from_the_configuration(monkeypatch):
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.delenv(k, raising=False)
    harness.host_threads({})
    assert "OMP_NUM_THREADS" not in os.environ
    b = harness.Bench(REPO)
    harness.host_threads(b.config(b.cell("enwide_stream")["config"]))
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["MKL_NUM_THREADS"] == "1"


def fake_run(latency, seconds, scans):
    w = Window()
    w.latency_s, w.seconds, w.scans = list(latency), seconds, scans
    w.submit_s = list(latency)
    return harness.Run(window=w)


def test_tails_and_rates_see_every_sample():
    b = harness.Bench(REPO)
    # a stall of 1 s holds up the last 10 events of 100
    steady = [0.010] * 95 + [0.020] * 5
    stall = [0.010] * 90 + [0.010 + 0.1 * k for k in range(10, 0, -1)]
    p95, p50, rate = (b.reader(n) for n in (
        "pose_latency_p95_ms", "pose_latency_p50_ms", "scans_per_s"))
    a, s = fake_run(steady, 1.0, 100), fake_run(stall, 3.0, 100)
    assert p95(s) > 20 * p95(a)
    assert p50(a) == pytest.approx(10.0)
    # a stall of half the events moves the median
    half = [0.010] * 49 + [0.040] * 51
    assert p50(fake_run(half, 1.0, 100)) == pytest.approx(40.0)
    # a stall of the window lowers the rate over the window's whole time
    assert rate(s) == pytest.approx(rate(a) / 3)
    # the percentile is of all samples, not of chunks' medians
    many = [0.010] * 900 + [0.050] * 100
    assert p95(fake_run(many, 1.0, 0)) == pytest.approx(50.0)


def test_no_card_no_result(tmp_path):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "enwide_bulk", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's files alone (no
    program) exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "enwide_bulk", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
{body}
tops = {{m.split('.')[0] for m in sys.modules}}
print(json.dumps(sorted(tops)))
"""

HARNESS = """
import importlib.util, torch
from benchmark import (control, cost, devtrace, drive, harness, reference,
                       synth, system, traffic)
b = harness.Bench({root!r})
for m in b.spec["end_to_end"] + b.spec["per_layer"]:
    b.reader(m["name"])
for w in b.spec["workloads"]:
    cfg = b.config(w["config"]); b.traffic(w["traffic"]); b.limits(w["name"])
from benchmark.tests.tiny import cut
for c in b.spec["configs"]:
    system.System(cut(b.config(c["name"])), "cpu")
"""


def modules(body):
    r = subprocess.run([sys.executable, "-c", IMPORTS.format(
        root=str(REPO), body=body.format(root=str(REPO)))],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = modules(HARNESS)
    assert "mimosa_tpu_torch" in tops     # the system under test
    assert not tops & {"jax", "jaxlib", "flax", "mimosa_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = modules("from benchmark import reference")
    assert not tops & {"jax", "jaxlib", "flax", "mimosa_tpu",
                       "mimosa_tpu_torch"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the run measures on the card")


@pytest.mark.cuda
def test_a_cut_cell_runs_on_the_card(card, tmp_path):
    b = harness.Bench(tiny.make(tmp_path, {"enwide_stream": {
        "missing_states": 0, "rel_pos_rms_m": 0.05}}))
    run = harness.measure(b, "enwide_stream", 11, 2.0, True)
    assert run.correct and run.trace is not None and run.trace.busy_s > 0
