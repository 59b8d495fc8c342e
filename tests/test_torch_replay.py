"""The port's bag replay (``io/replay.py``) on the CPU.

* the JAX package's ``replay_bag`` and the port's ``replay_bag(device=
  "cpu")`` on one bag with IMU, LiDAR, radar and odometry topics: the same
  state times and counters, both ATEs under 0.08 m and within 5 mm of each
  other (runs of the two packages are compared by ATE: the estimator is
  chaotic near tracking loss; the largest position gap is printed, not
  gated);
* the CLI (``main``): it calls ``replay_bag`` as the in-process replay
  does, its TUM file is that replay's, and it prints the ATE against
  ``--gt``;
* organize-by-ring: a ring-interleaved cloud with ``point_skip_divisor``
  4 is thinned in ring-major order through ``native.ring_sort``
  (``tests/test_bag_replay_cli.py``'s case);
* the range codec's fidelity gate and its yaw fit;
* ``StepControl``;
* bulk mode (``bulk=True``, ``--bulk``): the bits of the streaming replay
  with the merged slide, and the CLI's call and TUM file are the bulk
  replay's;
* the offline refinement (``two_pass=True``, ``smooth=True``, ``--two-pass``,
  ``--smooth``): pass 2 localizes against pass 1's map, frozen, and the
  smoothed trajectory is the one written; the CLI passes each option on
  and writes what it gives, and ``--two-pass --smooth`` on the bag calls
  ``replay_bag`` as the in-process refinement does and writes its TUM
  file;
* the debug stream (``--debug-stream``, ``--stream-every``): one line per
  scan at a cadence of 1 in the streamed CLI run, forced after each bulk
  flush in the bulk one, each line the run's pose rows and debug records;
* a debug stream that is not one, and the missing card, raise.

The JAX side runs once, in one fixture that one test uses. It takes most
of this module's time: the JAX package compiles its scan, radar and
odometry steps on the CPU. The port's streamed, bulk and refined runs are
each made once, by the CLI (``_cli``: ``replay_bag`` spied on, so the run
is the CLI's own), and the CLI tests hold what it wrote and printed, and
the arguments it passed, against that run.
"""

import contextlib
import copy
import dataclasses
import inspect
import io
import json

import numpy as np
import pytest
import torch
import yaml

from mimosa_tpu.io import replay as jreplay
from mimosa_tpu_torch.config import loader as tload
from mimosa_tpu_torch.io import pointcloud2 as tpc2
from mimosa_tpu_torch.io import replay as treplay
from mimosa_tpu_torch.io import rosbag as tbag
from mimosa_tpu_torch.io import rosbag_writer as tw
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io.viz import DebugStream
from mimosa_tpu_torch.utils import evaluation as tev
from test_bag_replay_cli import SYN_PARAMS
from torch_fixtures import one_thread_then_free_programs  # noqa: F401

ATE_GATE = 0.08        # tests/test_bag_replay_cli.py's gate
ATE_PAIR = 0.005       # [m] the two packages' ATEs apart


def _write_bag(path, data, radar, odom):
    """IMU, scans (at their end + 10 ms), rio radar frames (+5 ms) and
    odometry (+3 ms) in receipt order, by the port's writer."""
    w = tw.BagWriter(str(path))
    imu = data["imu"]
    ev = [(t, 0, k) for k, t in enumerate(imu["ts"])]
    ev += [(sc["ts_header"] + sc["t_rel"].max() + 0.01, 1, k)
           for k, sc in enumerate(data["scans"])]
    ev += [(fr["ts"] + 0.005, 2, k) for k, fr in enumerate(radar)]
    ev += [(m["ts"] + 0.003, 3, k) for k, m in enumerate(odom)]
    for t, kind, k in sorted(ev):
        if kind == 0:
            w.write("/imu", "sensor_msgs/Imu", imu["ts"][k],
                    tw.serialize_imu(imu["ts"][k], imu["acc"][k],
                                     imu["gyro"][k]))
        elif kind == 1:
            sc = data["scans"][k]
            pts = np.where(sc["valid"][:, None], sc["points"], np.nan)
            w.write("/points", "sensor_msgs/PointCloud2", t,
                    tw.serialize_ouster_cloud(sc["ts_header"], pts,
                                              sc["intensity"], sc["t_rel"]))
        elif kind == 2:
            fr = radar[k]
            w.write("/radar", "sensor_msgs/PointCloud2", t,
                    tw.serialize_radar_rio(fr["ts"], fr["points"],
                                           fr["doppler"], fr["snr_db"]))
        else:
            m = odom[k]
            w.write("/odom", "nav_msgs/Odometry", t,
                    tw.serialize_odometry(m["ts"], m["q"], m["t"], m["cov"]))
    w.close()


@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    """A 2.5 s noisy room from a 16x256 LiDAR with 5 Hz radar frames and
    5 Hz odometry between the scans (radar 25 ms and odometry 75 ms after
    a scan's end: each declares its own state, none arrives late), its
    ground truth as a TUM file, and SYN_PARAMS with the radar and odometry
    managers."""
    d = tmp_path_factory.mktemp("replay")
    tc = tsyn.TrajectoryConfig(t_total=2.5, t_stationary=1.25)
    data = tsyn.generate(tsyn.room_world(), tc, tsyn.LidarModel(), seed=0,
                         imu_noise=0.01, range_noise=0.005)
    traj = tsyn.make_trajectory(tc)
    radar = tsyn.generate_radar(traj, tc, rate=5.0, seed=0)
    odom = tsyn.generate_odometry(
        traj, dataclasses.replace(tc, t_stationary=1.35), rate=5.0, seed=0)
    _write_bag(d / "room.bag", data, radar, odom)
    params = copy.deepcopy(SYN_PARAMS)
    params["radar"] = {"T_B_S": [0, 0, 0, 0, 0, 0, 1],
                       "manager": {"enabled": True,
                                   "is_exposure_compensated": True}}
    params["odometry"] = {"manager": {"enabled": True}}
    (d / "params.yaml").write_text(yaml.safe_dump(params))
    gt = data["gt"]
    with open(d / "gt.tum", "w") as f:
        for t, p, q in zip(gt["ts"], gt["pos"], gt["quat"]):
            f.write(" ".join(repr(float(v)) for v in
                             (t, *p, q[1], q[2], q[3], q[0])) + "\n")
    return dict(dir=d, bag=str(d / "room.bag"), cfg=str(d / "params.yaml"),
                gt=str(d / "gt.tum"), data=data, n_radar=len(radar),
                n_odom=len(odom))


KW = dict(radar_topic="/radar", odom_topic="/odom", max_scan_points=4096,
          verbose=False)
TOPIC_FLAGS = ["--radar-topic", "/radar", "--odom-topic", "/odom",
               "--max-scan-points", "4096"]


def _cli(bag, name, flags, replay_bag=None):
    """``treplay.main`` on the bag, ``--out`` a file ``name``, with
    ``replay_bag`` (or the function given) spied on. Returns its run: the
    Sequencer that ``replay_bag`` returned, the arguments it got (bound to
    its signature), what the CLI printed and the path it wrote."""
    real = replay_bag or treplay.replay_bag
    calls = []

    def spy(*args, **kw):
        calls.append((args, kw))
        calls.append(real(*args, **kw))
        return calls[-1]

    out = bag["dir"] / name
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        mp.setattr(treplay, "replay_bag", spy)
        treplay.main(["--bag", bag["bag"], "--config", bag["cfg"],
                      "--imu-topic", "/imu", "--lidar-topic", "/points",
                      "--out", str(out), "--device", "cpu"] + flags)
    (args, kw), s = calls
    return dict(s=s, call=_bound(*args, **kw), printed=printed.getvalue(),
                out=out)


def _bound(*args, **kw):
    """``replay_bag``'s arguments by name, defaults applied, but
    ``verbose`` (it only prints)."""
    b = inspect.signature(treplay.replay_bag).bind(*args, **kw)
    b.apply_defaults()
    return {k: v for k, v in b.arguments.items() if k != "verbose"}


def _assert_cli_call(run, bag, **kw):
    """The CLI called ``replay_bag`` as the in-process call with ``kw``
    does."""
    assert run["call"] == _bound(bag["bag"], bag["cfg"], "/imu", "/points",
                                 device="cpu", **kw)


@pytest.fixture(scope="module")
def port_cli(bag):
    """The bag streamed through the CLI, with ``--gt`` and a debug stream
    of every scan."""
    return _cli(bag, "cli.tum", TOPIC_FLAGS + [
        "--gt", bag["gt"], "--debug-stream", str(bag["dir"] / "cli.jsonl"),
        "--stream-every", "1"])


@pytest.fixture(scope="module")
def port_run(port_cli):
    return port_cli["s"]


def _traj(s):
    tr = s.trajectory
    return (np.array([t for t, _, _ in tr]), np.array([p for _, p, _ in tr]))


def _ate(s, bag):
    gt_ts, gt_p, _ = tev.load_tum(bag["gt"])
    return tev.ate(*_traj(s), gt_ts, gt_p)


def test_replay_matches_jax(bag, port_run):
    js = jreplay.replay_bag(bag["bag"], bag["cfg"], "/imu", "/points", **KW)
    s = port_run
    assert s.device.type == "cpu"
    c = s.counters
    assert c == js.counters
    assert c["radar_frames"] == bag["n_radar"] and \
        c["odom_msgs"] == bag["n_odom"]
    # every modality ran, and nothing arrived late
    assert c["scans"] > 10 and c["radar_frames"] > c["radar_dropped"]
    assert c["odom_msgs"] > c["odom_dropped"] and c["scans_no_imu"] == 0
    assert not any(k.endswith(("ooo_inserted", "ooo_samekey")) and v
                   for k, v in c.items())
    tj, pj = _traj(js)
    tt, pt = _traj(s)
    np.testing.assert_array_equal(tt, tj)
    ate_j, ate_t = _ate(js, bag), _ate(s, bag)
    print(f"bag replay ATE: JAX {ate_j:.5f} m, port {ate_t:.5f} m, largest "
          f"position gap {np.abs(pt - pj).max():.2e} m")
    assert ate_j < ATE_GATE and ate_t < ATE_GATE
    assert abs(ate_j - ate_t) < ATE_PAIR


def test_cli_writes_the_replay_tum(bag, port_cli):
    """The CLI calls ``replay_bag`` as the in-process replay does, writes
    the TUM file of the replay it ran and prints its ATE."""
    stream = port_cli["call"]["debug_stream"]
    assert isinstance(stream, DebugStream) and stream.every == 1
    _assert_cli_call(port_cli, bag, debug_stream=stream, **KW)
    out, port_run = port_cli["out"], port_cli["s"]
    ref = bag["dir"] / "inproc.tum"
    port_run.write_tum(str(ref))
    assert out.read_text() == ref.read_text()
    ts, p, q = tev.load_tum(str(out))
    assert len(ts) == len(port_run.trajectory)
    line = [ln for ln in port_cli["printed"].splitlines()
            if ln.startswith("ATE:")]
    assert line == [f"ATE: {_ate(port_run, bag):.4f} m  RTE: nan %"]


def _stream_lines(path):
    return [json.loads(ln) for ln in open(path)]


def _assert_lines_are_the_run(lines, s, tum):
    """Each debug line is Sequencer ``s``'s state after that scan: its pose
    the TUM row of its time, at the line's rounding, its ICP and
    photometric slots the run's debug record, its counters a prefix of the
    run's (only the scan count and what came after may have grown)."""
    ts, p, q = tev.load_tum(str(tum))
    rec = s.debug_records()
    for ln in lines:
        k = int(np.argmin(np.abs(ts - ln["ts"])))
        assert abs(ts[k] - ln["ts"]) < 1e-6
        # at the line's rounding (half a unit of its last decimal; the TUM
        # text holds the f32 value's shortest repr)
        np.testing.assert_allclose(ln["p"], p[k], rtol=0, atol=5.01e-5)
        np.testing.assert_allclose(ln["q_wxyz"], q[k], rtol=0, atol=5.01e-7)
        r = rec[ln["scan"] - 1]
        assert ln["icp_inliers"] == int(r[0])
        assert ln["icp_status"] == [int(v) for v in r[1:5]]
        assert ln["degen_rot"] == [bool(v > 0.5) for v in r[6:9]]
        assert ln["degen_trans"] == [bool(v > 0.5) for v in r[9:12]]
        assert ln["photo_tracked"] == int(r[12])
        assert ln["counters"]["scans"] <= s.counters["scans"]


def test_cli_writes_the_debug_stream(bag, port_cli):
    """``--debug-stream --stream-every 1`` on the streamed replay: one
    line per scan step, in order, each the run's state after that scan;
    the last line's scan counters are the run's final ones (radar frames
    and odometry messages after the last scan count on), and the CLI
    prints the line count."""
    s = port_cli["s"]
    lines = _stream_lines(bag["dir"] / "cli.jsonl")
    assert [ln["scan"] for ln in lines] == list(range(1, s.scan_idx + 1))
    _assert_lines_are_the_run(lines, s, port_cli["out"])
    last = lines[-1]["counters"]
    # radar frames and odometry messages after the last scan count on
    assert set(last) <= set(s.counters)
    assert {k: v for k, v in last.items() if k.startswith("scans")} == \
        {k: v for k, v in s.counters.items() if k.startswith("scans")}
    assert f"({len(lines)} lines)" in port_cli["printed"]


def test_cli_bulk_writes_the_debug_stream(bag, bulk_runs):
    """``--bulk --debug-stream`` (cadence 10): a line forced after each
    flush of the bulk batch and at the end, and on the cadence after a
    streamed event; the scans strictly increase to the last, and each line
    is the run's state after its scan."""
    b = bulk_runs["bulk"]
    lines = _stream_lines(bag["dir"] / "cli_bulk.jsonl")
    scans = [ln["scan"] for ln in lines]
    assert len(lines) >= 2 and scans == sorted(set(scans))
    assert scans[-1] == b.scan_idx
    assert any(k % 10 for k in scans[:-1])       # a forced flush line
    _assert_lines_are_the_run(lines, b, bulk_runs["cli"]["out"])


BULK_CHUNK = 8          # the bag's eligible runs are shorter than 32


@pytest.fixture(scope="module")
def bulk_runs(bag):
    """The bag through the CLI's ``--bulk`` (``replay_bag(bulk=True)``) in
    chunks of BULK_CHUNK events, and through replay_bag streamed with the
    merged slide, on the module's one intra-op thread (``torch_fixtures``;
    these runs are compared bit for bit)."""
    import functools

    cli = _cli(bag, "cli_bulk.tum", TOPIC_FLAGS + [
        "--bulk", "--debug-stream", str(bag["dir"] / "cli_bulk.jsonl")],
        functools.partial(treplay.replay_bag, bulk_chunk=BULK_CHUNK))
    return dict(
        cli=cli, bulk=cli["s"],
        merged=treplay.replay_bag(bag["bag"], bag["cfg"], "/imu",
                                  "/points", device="cpu",
                                  merge_marginalize=True, **KW))


def test_bulk_replay_equals_merged_streaming_replay(bag, bulk_runs):
    """replay_bag(bulk=True) gives the streaming replay's bits with the
    merged slide: chunks of scans, radar and odometry declares ran, the
    rest streamed, and the positions, quaternions, counters, state times
    and trajectory rows are the same."""
    b, s = bulk_runs["bulk"], bulk_runs["merged"]
    assert b.bulk_counts["chunks"] > 0
    assert b.bulk_counts["codes"][0] > 0 and b.bulk_counts["streamed"] > 0
    assert b.counters == s.counters
    assert b.counters["radar_frames"] == bag["n_radar"]
    assert b.counters["odom_msgs"] == bag["n_odom"]
    assert b.state_ts == s.state_ts
    assert b._traj_ts == s._traj_ts and b._traj_src == s._traj_src
    for (tb, pb, qb), (ts, ps, qs) in zip(b.trajectory, s.trajectory):
        assert tb == ts
        np.testing.assert_array_equal(pb, ps)
        np.testing.assert_array_equal(qb, qs)
    assert _ate(b, bag) < ATE_GATE


def test_cli_bulk_writes_the_bulk_replay_tum(bag, bulk_runs):
    """``--bulk``: the CLI calls ``replay_bag`` as the in-process bulk
    replay does (``bulk=True``; the chunk size is set to BULK_CHUNK by the
    function the CLI was given) and writes the TUM file of its run."""
    cli = bulk_runs["cli"]
    stream = cli["call"]["debug_stream"]
    assert isinstance(stream, DebugStream) and stream.every == 10
    _assert_cli_call(cli, bag, bulk=True, debug_stream=stream, **KW)
    ref = bag["dir"] / "inproc_bulk.tum"
    bulk_runs["bulk"].write_tum(str(ref))
    assert cli["out"].read_text() == ref.read_text()


def test_organize_by_ring_thins_ring_major(tmp_path):
    """A ring-interleaved cloud (ring index fastest) with
    point_skip_divisor 4: arrival-order skipping would keep every 4th ring;
    the ring-major skip through native.ring_sort keeps a quarter of every
    ring and the estimator tracks (tests/test_bag_replay_cli.py)."""
    lm = tsyn.LidarModel(n_rows=32, n_cols=256)
    base = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(t_total=2.5),
                         lm, seed=0)
    n_rows, n_cols = lm.n_rows, lm.n_cols
    w = tw.BagWriter(str(tmp_path / "ring.bag"))
    imu = base["imu"]
    ev = [(t, 0, k) for k, t in enumerate(imu["ts"])]
    ev += [(sc["ts_header"] + np.nan_to_num(sc["t_rel"]).max() + 0.01, 1, k)
           for k, sc in enumerate(base["scans"])]
    for t, kind, k in sorted(ev):
        if kind == 0:
            w.write("/imu", "sensor_msgs/Imu", imu["ts"][k],
                    tw.serialize_imu(imu["ts"][k], imu["acc"][k],
                                     imu["gyro"][k]))
            continue
        sc = base["scans"][k]
        n = len(sc["points"])
        row = np.repeat(np.arange(n_rows), n_cols)[:n].astype(np.uint16)
        perm = np.lexsort((row, np.tile(np.arange(n_cols), n_rows)[:n]))
        v = sc["valid"][perm]
        pts = np.where(v[:, None], sc["points"][perm], np.nan)
        w.write("/points", "sensor_msgs/PointCloud2", t,
                tw.serialize_ouster_cloud(sc["ts_header"], pts,
                                          np.ones(len(pts)),
                                          np.nan_to_num(sc["t_rel"])[perm],
                                          ring=row[perm]))
    w.close()
    params = copy.deepcopy(SYN_PARAMS)
    params["lidar"]["manager"]["organize_pointcloud_by_ring"] = True
    params["lidar"]["geometric"]["point_skip_divisor"] = 4
    cfgp = tmp_path / "params.yaml"
    cfgp.write_text(yaml.safe_dump(params))
    s = treplay.replay_bag(str(tmp_path / "ring.bag"), str(cfgp), "/imu",
                           "/points", max_scan_points=n_rows * n_cols,
                           verbose=False, device="cpu")
    # thinned on the host in ring-major order, so not again on the device
    assert s.cfg.geo_skip == 1
    ts, p = _traj(s)
    assert tsyn.ate_rmse(ts, p, base["gt"]["ts"], base["gt"]["pos"]) < \
        ATE_GATE
    assert s.debug_records()[3:, 0].min() > 100


def _organized_scan(tmp_path, yaw=0.0, scramble=False):
    """(ray table, first-scan message) of an organized Ouster cloud that
    follows the affine beam model p = s * dir + off exactly, turned by
    ``yaw`` about z, optionally with its points out of pixel order."""
    rows, cols = 16, 128
    meta = {"beam_intrinsics": {
        "beam_altitude_angles": np.linspace(-20, 20, rows).tolist(),
        "beam_azimuth_angles": np.linspace(2, -2, rows).tolist(),
        "lidar_origin_to_beam_origin_mm": 15.0},
        "lidar_data_format": {"columns_per_frame": cols,
                              "pixels_per_column": rows}}
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta))
    rd = tload.ouster_ray_dirs(tload.load_ouster_metadata(str(path)))
    rng = np.random.default_rng(0)
    s = rng.uniform(2.0, 20.0, len(rd))
    pts = s[:, None] * rd[:, :3] + rd[:, 3:6]
    c, si = np.cos(yaw), np.sin(yaw)
    pts = pts @ np.array([[c, -si, 0], [si, c, 0], [0, 0, 1.0]]).T
    if scramble:
        pts = pts[rng.permutation(len(pts))]
    body = tw.serialize_ouster_cloud(1.0, pts, np.ones(len(pts)),
                                     np.zeros(len(pts)))
    return rd, tbag.parse_pointcloud2(body)


def test_range_codec_fidelity_gate(tmp_path, capsys):
    rd, m0 = _organized_scan(tmp_path)
    np.testing.assert_array_equal(
        treplay._fit_range_codec(rd, m0, tpc2, verbose=False), rd)
    # a fixed sensor-frame yaw is fitted and compensated
    rd_y, m0_y = _organized_scan(tmp_path, yaw=np.radians(0.3))
    fitted = treplay._fit_range_codec(rd_y, m0_y, tpc2, verbose=True)
    assert "compensated a fixed +0.30 deg" in capsys.readouterr().out
    assert not np.array_equal(fitted, rd_y)
    # points out of pixel order, and a cloud of the wrong size, refuse
    rd_s, m0_s = _organized_scan(tmp_path, scramble=True)
    with pytest.raises(ValueError, match="reconstruction residual"):
        treplay._fit_range_codec(rd_s, m0_s, tpc2, verbose=False)
    with pytest.raises(ValueError, match="beam table covers"):
        treplay._fit_range_codec(rd[:-1], m0, tpc2, verbose=False)


def test_step_control_semantics():
    """SPACE pause / 's' step / 'q' abort (the reference's raw-tty replay
    control, mimosa_rosbag.cpp:166-185), as tests/test_bag_replay_cli.py."""
    feed = iter(["", " s", "s", " ", "", "q", ""])
    sc = treplay.StepControl(read_keys=lambda: next(feed, ""))
    assert sc.gate() and not sc.paused        # running
    assert sc.gate() and sc.paused            # pause + step one scan
    assert sc.gate() and sc.paused            # step again
    assert sc.gate() and not sc.paused        # resume
    assert sc.gate()
    assert not sc.gate()                      # abort
    assert not sc.gate()                      # stays aborted


# the refinement runs replay the bag's IMU and LiDAR topics only: a CPU
# step per radar frame and odometry message would triple their time (the
# card's chip_smoke.py runs the smoother over radar rows)
REFINE_KW = dict(max_scan_points=4096, verbose=False)
REFINE_FLAGS = ["--max-scan-points", "4096"]


@pytest.fixture(scope="module")
def refined_cli(bag):
    """The bag's IMU and scans through the CLI's ``--two-pass --smooth``
    (``replay_bag(two_pass=True, smooth=True)``), with ``--gt``."""
    return _cli(bag, "cli_refined.tum", REFINE_FLAGS + [
        "--gt", bag["gt"], "--two-pass", "--smooth"])


@pytest.fixture(scope="module")
def refined(refined_cli):
    return refined_cli["s"]


@pytest.mark.parametrize("option", ["two_pass", "smooth"])
def test_replay_runs_the_refinement(bag, refined, option):
    """``two_pass``: the returned Sequencer is pass 2's, every scan
    localized against pass 1's final map (the map not empty, no keyframe
    added after the first). ``smooth``: the whole trajectory smoothed, one
    row a trajectory row, and kept as ``.smoothed``."""
    s = refined
    gt_ts, gt_p, _ = tev.load_tum(bag["gt"])
    if option == "two_pass":
        assert s.cfg.freeze_map and s.num_keyframes == 1
        assert int(s.vmap.plane_valid.sum()) > 100
        assert s.counters["scans"] > 10 and s.scan_idx > 10
        assert len(s._traj_ts) == s.scan_idx + 1
        assert _ate(s, bag) < ATE_GATE
    else:
        ts, q, p = s.smoothed
        np.testing.assert_array_equal(ts, _traj(s)[0])
        assert q.shape == (len(ts), 4) and np.isfinite(p).all()
        assert tev.ate(ts, p, gt_ts, gt_p) < ATE_GATE


@pytest.mark.parametrize("flag", ["--two-pass", "--smooth"])
def test_cli_runs_the_refinement(bag, refined, flag, monkeypatch, capsys):
    """The CLI passes ``--two-pass`` / ``--smooth`` on to ``replay_bag``
    and writes what it returns: the smoothed trajectory where there is
    one (and its ATE line after the streamed one's), else the streamed
    one. ``replay_bag`` is stood in for by the in-process run."""
    calls = []

    def fake_replay_bag(*args, **kw):
        calls.append(kw)
        return refined if kw[flag[2:].replace("-", "_")] else None

    monkeypatch.setattr(treplay, "replay_bag", fake_replay_bag)
    monkeypatch.setattr(refined, "smoothed", refined.smoothed
                        if flag == "--smooth" else None)
    out = bag["dir"] / f"cli_{flag[2:]}.tum"
    treplay.main(["--bag", bag["bag"], "--config", bag["cfg"],
                  "--imu-topic", "/imu", "--lidar-topic", "/points",
                  "--gt", bag["gt"], "--out", str(out), "--device", "cpu",
                  flag])
    assert len(calls) == 1
    assert calls[0]["two_pass"] == (flag == "--two-pass")
    assert calls[0]["smooth"] == (flag == "--smooth")
    ref = bag["dir"] / f"ref_{flag[2:]}.tum"
    if flag == "--smooth":
        treplay.write_smoothed_tum(ref, refined.smoothed)
    else:
        refined.write_tum(str(ref))
    assert out.read_text() == ref.read_text()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ATE:" in ln]
    assert len(lines) == (2 if flag == "--smooth" else 1)
    assert lines[0].startswith("ATE:")


def test_cli_two_pass_smooth_writes_the_replay_tum(bag, refined_cli):
    """``--two-pass --smooth --out`` on the bag calls ``replay_bag`` as the
    in-process ``replay_bag(two_pass=True, smooth=True)`` does, writes the
    smoothed trajectory of its run, and prints both ATE lines."""
    _assert_cli_call(refined_cli, bag, two_pass=True, smooth=True,
                     **REFINE_KW)
    refined, out = refined_cli["s"], refined_cli["out"]
    printed = refined_cli["printed"]
    ref = bag["dir"] / "inproc_refined.tum"
    treplay.write_smoothed_tum(ref, refined.smoothed)
    assert out.read_text() == ref.read_text()
    assert len(out.read_text().splitlines()) == len(refined.trajectory)
    gt_ts, gt_p, _ = tev.load_tum(bag["gt"])
    ts, _, p = refined.smoothed
    assert f"smoothed ATE: {tev.ate(ts, p, gt_ts, gt_p):.4f} m" in printed
    assert f"ATE: {_ate(refined, bag):.4f} m" in printed


@pytest.mark.parametrize("option", [dict(debug_stream=object())],
                         ids=["debug_stream"])
def test_replay_refuses_what_is_not_ported(option):
    """Every replay option of the JAX package is ported; a debug stream
    that is not one is refused before the bag is read."""
    assert not hasattr(treplay, "NOT_PORTED")
    with pytest.raises(TypeError, match="DebugStream"):
        treplay.replay_bag("absent.bag", "absent.yaml", "/imu", "/points",
                           device="cpu", **option)


@pytest.mark.parametrize("flags,every", [
    (["--debug-stream", "x.jsonl"], 10),
    (["--debug-stream", "x.jsonl", "--stream-every", "5"], 5)],
    ids=["debug_stream", "stream_every"])
def test_cli_refuses_what_is_not_ported(flags, every, tmp_path, monkeypatch):
    """The CLI refuses none of the JAX package's flags: ``--debug-stream``
    and ``--stream-every`` reach ``replay_bag`` as a DebugStream on that
    file at that cadence (10 by default), closed when the replay ends, here
    by the missing bag's error."""
    calls = []

    def fake_replay_bag(*args, **kw):
        calls.append(kw["debug_stream"])
        raise FileNotFoundError("absent.bag")

    monkeypatch.setattr(treplay, "replay_bag", fake_replay_bag)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        treplay.main(["--bag", "absent.bag", "--config", "absent.yaml",
                      "--imu-topic", "/imu", "--lidar-topic", "/points",
                      "--device", "cpu"] + flags)
    (stream,) = calls
    assert isinstance(stream, DebugStream) and stream.every == every
    assert stream.path == "x.jsonl" and stream._f.closed
    assert (tmp_path / "x.jsonl").read_text() == ""


def test_replay_needs_a_card_unless_asked_for_the_cpu(bag, monkeypatch):
    """Without ``device`` the replay and its CLI ask for the card and raise
    where there is none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.replay_bag(bag["bag"], bag["cfg"], "/imu", "/points")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.main(["--bag", bag["bag"], "--config", bag["cfg"],
                      "--imu-topic", "/imu", "--lidar-topic", "/points"])
