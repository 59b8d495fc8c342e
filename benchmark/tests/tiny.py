"""A copy of the benchmark at a size a CPU test can run: every cell of
``BENCHMARK.json`` with its configuration cut to a 16 x 128 LiDAR, small
maps and solver sizes, short warm-ups and chunks of 8."""

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def cut(cfg):
    c = copy.deepcopy(cfg)
    c["sensors"]["lidar"].update(n_rows=16, n_cols=128)
    s = c["system"]["sequencer"]
    s.update(max_scan_points=2048, n_geo_points=512, n_map_points=1024,
             point_skip=1)
    s.pop("geo_skip", None)
    c["system"]["map"]["capacity_log2"] = 14
    if c["system"].get("photometric"):
        c["system"]["photometric"].update(rows=16, cols=128,
                                          num_features=16)
    if "radar" in c["sensors"]:
        c["sensors"]["radar"]["n_targets"] = 64
    return c


def shorten():
    """Warm-ups, blocks and the pool at the cut size (the harness's own
    settings are for the card)."""
    from benchmark import drive, traffic
    drive.WARM = {"stream": dict(sensor_s=2.5, max_sensor_s=4.0, quiet=0),
                  "bulk": dict(sensor_s=2.5, max_sensor_s=4.0, chunks=1,
                               quiet_chunks=0)}
    drive.TRACE_SKIP_S = 0.0
    traffic.BLOCK_SENSOR_S = 2.0
    traffic.POOL_SENSOR_S_PER_S = 0.5


def make(root, limits=None):
    """Write the cut benchmark under ``root`` (bulk chunks of 8), and cut
    the harness's warm-ups for this process; ``limits`` {cell: {...}}
    replaces cells' limits. Returns root."""
    shorten()
    root = Path(root)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (root / c["file"]).write_text(json.dumps(cut(cfg)))
    p = root / "benchmark" / "traffic" / "bulk.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), chunk=8)))
    for cell, lim in (limits or {}).items():
        (root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
