"""``BENCHMARK.json`` and the files it names: allowed keys, names and
units; every per-layer metric moves an end-to-end metric that each of its
cells reports; every cell has its configuration, traffic, limits and
readers; the run length fits the check's time with 24 cells."""

import json
import re

import pytest

from benchmark import cost, harness
from benchmark.tests.tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
E2E = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def cells_of(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_top_level_and_paths():
    assert set(SPEC) == TOP
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32 and all(map(text_ok, SPEC["command"]))
    assert (REPO / SPEC["command"][1]).is_file()
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and key != "end_to_end" and key != "per_layer":
                    assert text_ok(e[k])
            if "layer" in e:
                assert text_ok(e["layer"])
    for group in (True, False):
        ns = [n for g, n in names if g == group]
        assert len(ns) == len(set(ns))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= E2E and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= LAYER and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in cells_of(m):
            assert cell in cells_of(e2e[m["moves"]]), (m["name"], cell)
    for w in SPEC["workloads"]:
        reported = [m["name"] for m in SPEC["end_to_end"]
                    if w["name"] in cells_of(m)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in cells_of(m) for m in SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_every_name_has_its_files():
    b = harness.Bench(REPO)
    for c in SPEC["configs"]:
        cfg = b.config(c["name"])
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert isinstance(cfg["assumed"], list) and cfg["assumed"]
    for w in SPEC["workloads"]:
        assert b.traffic(w["traffic"])["mode"] in ("bulk", "stream")
        lim = b.limits(w["name"])
        assert lim["missing_states"] == 0 and len(lim) >= 2
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(b.reader(m["name"]))


def test_run_seconds_fit_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_icp_byte_count():
    assert cost.icp_bytes(8192) == 311722
    peak = cost.peaks("NVIDIA H100 80GB HBM3")
    share, bound = cost.roofline(cost.icp_bytes(8192),
                                 cost.icp_flops(8192, 8192), 7.31e-6, peak)
    assert bound == "bytes" and share == pytest.approx(1.273, abs=1e-3)
