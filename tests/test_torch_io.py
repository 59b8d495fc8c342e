"""The port's bag, cloud and config inputs against the JAX package's.

* ``io/rosbag_writer.py``: the two writers give the same bytes for the same
  data (IMU, Ouster clouds, rio radar clouds, odometry), and a bag written
  by either is read the same by either package's ``io/rosbag.py``, field by
  field;
* ``io/rosbag.py``: ``parse_odometry`` and ``topic_info``;
* ``io/pointcloud2.py``: ``tests/test_pointcloud2.py``'s Ouster, Velodyne
  and Hesai cases, the filters and ``time_base``, equal to JAX's, and
  ``decode_radar``;
* ``native``: ``ring_sort`` and ``decode_filtered`` bit-identical to
  ``mimosa_tpu.native`` (and ``ring_sort`` to its numpy twin);
* ``config/loader.py``: ``from_reference_dict`` on the bag CLI test's
  ``SYN_PARAMS`` and on dicts built here (the reference YAMLs are absent),
  ``load_reference_yaml`` with an override, ``photometric_from_reference``
  and the Ouster metadata helpers give the same config fields as JAX's.
"""

import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import yaml

from mimosa_tpu import native as jnative
from mimosa_tpu.config import loader as jload
from mimosa_tpu.io import pointcloud2 as jpc2
from mimosa_tpu.io import rosbag as jbag
from mimosa_tpu.io import rosbag_writer as jw
from mimosa_tpu_torch import native as tnative
from mimosa_tpu_torch.config import loader as tload
from mimosa_tpu_torch.io import pointcloud2 as tpc2
from mimosa_tpu_torch.io import rosbag as tbag
from mimosa_tpu_torch.io import rosbag_writer as tw
from mimosa_tpu_torch.io import synthetic as tsyn
from test_bag_replay_cli import SYN_PARAMS
from torch_fixtures import one_thread_then_free_programs  # noqa: F401


def _equal(a, b, path="msg"):
    """Field-by-field equality of two parsed messages (dicts, Fields,
    arrays, bytes, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def stream():
    """A 2 s room from a 16x256 LiDAR (noisy), 20 Hz radar frames and
    10 Hz odometry, generated by the port (equal to JAX's generators,
    tests/test_torch_slice.py and test_torch_radar.py)."""
    tc = tsyn.TrajectoryConfig(t_total=2.0)
    data = tsyn.generate(tsyn.room_world(), tc, tsyn.LidarModel(), seed=0,
                         imu_noise=0.01, range_noise=0.005)
    traj = tsyn.make_trajectory(tc)
    radar = tsyn.generate_radar(traj, tc, seed=0)
    odom = tsyn.generate_odometry(traj, tc, seed=0)
    return data, radar, odom


def test_serializers_give_the_same_bytes(stream):
    data, radar, odom = stream
    imu = data["imu"]
    for k in (0, 7, len(imu["ts"]) - 1):
        assert tw.serialize_imu(imu["ts"][k], imu["acc"][k],
                                imu["gyro"][k]) == \
            jw.serialize_imu(imu["ts"][k], imu["acc"][k], imu["gyro"][k])
    sc = data["scans"][3]
    pts = np.where(sc["valid"][:, None], sc["points"], np.nan)
    ring = np.arange(len(pts)) % 16
    for r in (None, ring):
        assert tw.serialize_ouster_cloud(
            sc["ts_header"], pts, sc["intensity"], sc["t_rel"], r) == \
            jw.serialize_ouster_cloud(sc["ts_header"], pts, sc["intensity"],
                                      sc["t_rel"], r)
    fr = radar[2]
    for snr, noise in ((None, None), (fr["snr_db"], fr["snr_db"] * 0.1)):
        assert tw.serialize_radar_rio(fr["ts"], fr["points"], fr["doppler"],
                                      snr, noise) == \
            jw.serialize_radar_rio(fr["ts"], fr["points"], fr["doppler"],
                                   snr, noise)
    m = odom[4]
    for cov in (None, m["cov"]):
        assert tw.serialize_odometry(m["ts"], m["q"], m["t"], cov) == \
            jw.serialize_odometry(m["ts"], m["q"], m["t"], cov)


def _write_bag(w, path, data, radar, odom):
    """write_synthetic_bag, then a second bag through BagWriter with the
    odometry messages too (write_synthetic_bag writes none)."""
    w.write_synthetic_bag(str(path), data, radar_frames=radar)
    b = w.BagWriter(str(path) + ".odom")
    for m in odom:
        b.write("/odom", "nav_msgs/Odometry", m["ts"] + 0.003,
                w.serialize_odometry(m["ts"], m["q"], m["t"], m["cov"]))
    b.close()


def test_bags_equal_bytes_and_read_the_same(stream, tmp_path):
    data, radar, odom = stream
    paths = {}
    for name, w in (("jax", jw), ("torch", tw)):
        paths[name] = tmp_path / f"{name}.bag"
        _write_bag(w, paths[name], data, radar, odom)
    for suffix in ("", ".odom"):
        assert (tmp_path / f"jax.bag{suffix}").read_bytes() == \
            (tmp_path / f"torch.bag{suffix}").read_bytes()
    for writer in paths.values():
        for suffix in ("", ".odom"):
            p = f"{writer}{suffix}"
            jm = jbag.Bag(p).read_sorted()
            tm = tbag.Bag(p).read_sorted()
            assert len(jm) == len(tm) > 0
            for a, b in zip(jm, tm):
                _equal(a, b)
            raw_j = list(jbag.Bag(p).messages(parse=False))
            raw_t = list(tbag.Bag(p).messages(parse=False))
            assert raw_j == raw_t
            assert tbag.Bag(p).topic_info() == jbag.Bag(p).topic_info()
    topics = {m[0] for m in tbag.Bag(str(paths["torch"])).messages()}
    assert topics == {"/imu", "/points", "/radar"}
    only = tbag.Bag(str(paths["torch"])).read_sorted(topics={"/radar"})
    assert len(only) == len(radar)


def test_parse_odometry_and_decode_radar(stream):
    _, radar, odom = stream
    for m in odom[:3]:
        body = tw.serialize_odometry(m["ts"], m["q"], m["t"], m["cov"])
        a, b = jbag.parse_odometry(body), tbag.parse_odometry(body)
        _equal(a, b)
        np.testing.assert_array_equal(b["q"], m["q"])
        np.testing.assert_array_equal(b["p"], m["t"])
        np.testing.assert_array_equal(b["pose_cov"], m["cov"])
    fr = radar[1]
    cloud = tbag.parse_pointcloud2(tw.serialize_radar_rio(
        fr["ts"], fr["points"], fr["doppler"], fr["snr_db"]))
    _equal(jbag.parse_pointcloud2(tw.serialize_radar_rio(
        fr["ts"], fr["points"], fr["doppler"], fr["snr_db"])), cloud)
    a = jpc2.decode_radar(cloud["data"], cloud["fields"], cloud["point_step"])
    b = tpc2.decode_radar(cloud["data"], cloud["fields"], cloud["point_step"])
    _equal(a, b)
    assert b["fmt"] == "radar_rio"
    # the writer stores the raw sensor axes; decode applies the remap back
    np.testing.assert_allclose(b["points"], fr["points"], atol=1e-6)
    np.testing.assert_allclose(b["doppler"], fr["doppler"], rtol=1e-6)
    # the mmWave layout: velocity and intensity as doppler and snr
    n = 5
    fields = [tpc2.Field("x", 0, 7), tpc2.Field("y", 4, 7),
              tpc2.Field("z", 8, 7), tpc2.Field("intensity", 12, 7),
              tpc2.Field("velocity", 16, 7)]
    buf = np.arange(n * 20, dtype=np.uint8)
    jf = [jpc2.Field(*dataclasses.astuple(f)) for f in fields]
    _equal(jpc2.decode_radar(buf, jf, 20), tpc2.decode_radar(buf, fields, 20))
    with pytest.raises(ValueError, match="not a radar format"):
        lidar = tbag.parse_pointcloud2(tw.serialize_ouster_cloud(
            0.0, np.ones((4, 3)), np.ones(4), np.zeros(4)))
        tpc2.decode_radar(lidar["data"], lidar["fields"],
                          lidar["point_step"])


def _ouster_cloud(pc2, n=64, seed=0):
    """tests/test_pointcloud2.py's make_ouster_cloud on module ``pc2``."""
    rng = np.random.default_rng(seed)
    step = 32
    fields = [
        pc2.Field("x", 0, 7), pc2.Field("y", 4, 7), pc2.Field("z", 8, 7),
        pc2.Field("intensity", 16, 7), pc2.Field("t", 20, 6),
        pc2.Field("reflectivity", 24, 4), pc2.Field("ring", 26, 4),
    ]
    buf = np.zeros(n * step, np.uint8)
    xyz = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, size=n).astype(np.float32)
    t = (np.arange(n) * 1000).astype(np.uint32)
    ring = (np.arange(n) % 16).astype(np.uint16)
    v = pc2.structured_view(buf, fields, step)
    v["x"], v["y"], v["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    v["intensity"] = inten
    v["t"] = t
    v["ring"] = ring
    return buf, fields, step, xyz, inten, t, ring


def _fields(pc2, spec):
    return [pc2.Field(*f) for f in spec]


VELODYNE = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
            ("ring", 16, 4), ("time", 18, 7)]
HESAI = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
         ("timestamp", 16, 8), ("ring", 24, 4)]


@pytest.mark.parametrize("use_reflectivity", [False, True])
def test_decode_ouster_matches_jax(use_reflectivity):
    buf, fields, step, xyz, inten, t, ring = _ouster_cloud(tpc2)
    jfields = _fields(jpc2, [dataclasses.astuple(f) for f in fields])
    assert tpc2.detect_format(fields) == jpc2.detect_format(jfields) == \
        "ouster"
    a = jpc2.decode(buf, jfields, step, header_stamp=3.0,
                    use_reflectivity=use_reflectivity)
    b = tpc2.decode(buf, fields, step, header_stamp=3.0,
                    use_reflectivity=use_reflectivity)
    _equal(a, b)
    np.testing.assert_allclose(b["points"], xyz, atol=0)
    if not use_reflectivity:
        np.testing.assert_allclose(b["intensity"], inten, atol=0)
    np.testing.assert_allclose(b["t_rel"], t * 1e-9, atol=1e-15)
    np.testing.assert_array_equal(b["ring"], ring.astype(np.int32))


def test_velodyne_and_hesai_match_jax():
    for spec, fmt in ((VELODYNE, "velodyne"), (HESAI, "hesai")):
        assert tpc2.detect_format(_fields(tpc2, spec)) == \
            jpc2.detect_format(_fields(jpc2, spec)) == fmt
    # Hesai's absolute f64 stamps, decoded relative to the header
    step, n, stamp = 32, 10, 1.7e9
    buf = np.zeros(n * step, np.uint8)
    v = tpc2.structured_view(buf, _fields(tpc2, HESAI), step)
    v["timestamp"] = stamp + np.arange(n) * 1e-4
    v["x"] = 1.0
    a = jpc2.decode(buf, _fields(jpc2, HESAI), step, header_stamp=stamp)
    b = tpc2.decode(buf, _fields(tpc2, HESAI), step, header_stamp=stamp)
    _equal(a, b)
    np.testing.assert_allclose(b["t_rel"], np.arange(n) * 1e-4, atol=1e-6)
    # Velodyne: relative f32 seconds
    step = 24
    buf = np.zeros(n * step, np.uint8)
    v = tpc2.structured_view(buf, _fields(tpc2, VELODYNE), step)
    v["time"] = np.arange(n, dtype=np.float32) * 1e-3
    v["ring"] = np.arange(n) % 4
    v["y"] = 2.0
    _equal(jpc2.decode(buf, _fields(jpc2, VELODYNE), step),
           tpc2.decode(buf, _fields(tpc2, VELODYNE), step))


def test_unknown_format_raises():
    bad = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("mystery", 12, 7)]
    for pc2 in (jpc2, tpc2):
        with pytest.raises(ValueError, match="unknown point format"):
            pc2.detect_format(_fields(pc2, bad))


def test_point_filters_and_time_base_match_jax():
    pts = np.asarray([[1.0, 0, 0], [0.05, 0, 0], [200.0, 0, 0],
                      [np.nan, 0, 0], [5.0, 0, 0], [6.0, 0, 0]], np.float32)
    inten = np.asarray([10, 10, 10, 10, 0.5, 10], np.float32)
    ring = np.asarray([0, 0, 0, 0, 0, 1], np.int32)
    t_rel = np.linspace(0, 0.1, 6)
    tag = np.asarray([0x00, 0x10, 0x20, 0x30, 0x10, 0x00])
    for kw in (dict(intensity_min=1.0, ring_skip=2), dict(intensity_min=1.0),
               dict(point_skip=2), dict(t_rel=t_rel, t_rel_max=0.05),
               dict(livox_tag=tag, range_max=1e3)):
        kw = dict(range_min=0.2, range_max=100, **kw) \
            if "range_max" not in kw else dict(range_min=0.2, **kw)
        np.testing.assert_array_equal(
            tpc2.point_filters(pts, inten, ring, **kw),
            jpc2.point_filters(pts, inten, ring, **kw))
    ok = tpc2.point_filters(pts, inten, ring, range_min=0.2, range_max=100,
                            intensity_min=1.0, ring_skip=2)
    np.testing.assert_array_equal(ok, [True, False, False, False, False,
                                       False])
    for fmt in ("ouster", "ouster_r8", "ouster_odyssey", "livox_custom2",
                "internal", "livox", "hesai", "rslidar", "velodyne",
                "velodyne_anybotics", "radar_rio"):
        assert tpc2.time_base(fmt, 1234.5) == jpc2.time_base(fmt, 1234.5)
    buf, fields, step, *_ = _ouster_cloud(tpc2, n=32, seed=2)
    d = tpc2.decode(buf, fields, step, header_stamp=1234.5)
    sc, off = tpc2.time_base(d["fmt"], 1234.5)
    v = tpc2.structured_view(buf, fields, step)
    np.testing.assert_allclose(v["t"].astype(np.float64) * sc - off,
                               d["t_rel"], atol=1e-12)


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


@pytest.mark.parametrize("kw", [
    dict(range_min=2.0, range_max=15.0, intensity_min=20.0,
         intensity_max=240.0, point_skip=2, ring_skip=2),
    dict(range_min=0.1, range_max=1000.0),
    dict(range_min=0.5, range_max=9.0, point_skip=3, t_scale=1e-9,
         t_offset=1e-6),
], ids=["filters", "wide", "skip+time"])
def test_decode_filtered_bit_identical(jax_lib, kw):
    buf, fields, step, *_ = _ouster_cloud(tpc2, n=512, seed=1)
    v = tpc2.structured_view(buf, fields, step)
    x = np.array(v["x"])
    x[[3, 100]] = np.nan
    v["x"] = x
    jfields = _fields(jpc2, [dataclasses.astuple(f) for f in fields])
    for max_out in (512, 100):
        a = jnative.decode_filtered(buf, jfields, step, max_out, **kw)
        b = tnative.decode_filtered(buf, fields, step, max_out, **kw)
        assert len(b[0]) > 0
        for x_, y_ in zip(a, b):
            assert x_.dtype == y_.dtype
            np.testing.assert_array_equal(x_, y_)
    # the plain decode and filters give the same points
    # (tests/test_native.py's check)
    d = tpc2.decode(buf, fields, step)
    filt = {k: v for k, v in kw.items() if k not in ("t_scale", "t_offset")}
    idx = np.nonzero(tpc2.point_filters(d["points"], d["intensity"],
                                        d["ring"], **filt))[0][:len(b[0])]
    np.testing.assert_array_equal(b[0], d["points"][idx])
    np.testing.assert_array_equal(b[1], d["intensity"][idx])
    np.testing.assert_array_equal(b[3], d["ring"][idx])
    np.testing.assert_allclose(b[2], d["t_rel"][idx] - kw.get("t_offset", 0),
                               atol=1e-12)


def test_decode_filtered_other_formats(jax_lib):
    """A Velodyne cloud (f32 relative seconds, u16 ring) and a Hesai cloud
    (f64 absolute stamps), each with the format's time base."""
    rng = np.random.default_rng(3)
    n = 300
    for spec, step, tf in ((VELODYNE, 24, "time"), (HESAI, 32, "timestamp")):
        fields = _fields(tpc2, spec)
        buf = np.zeros(n * step, np.uint8)
        v = tpc2.structured_view(buf, fields, step)
        for k in ("x", "y", "z"):
            v[k] = rng.uniform(-20, 20, n).astype(np.float32)
        v["intensity"] = rng.uniform(0, 100, n).astype(np.float32)
        v["ring"] = rng.integers(0, 32, n)
        v[tf] = 1.7e9 + rng.uniform(0, 0.1, n) if tf == "timestamp" \
            else rng.uniform(0, 0.1, n).astype(np.float32)
        fmt = tpc2.detect_format(fields)
        sc, off = tpc2.time_base(fmt, 1.7e9)
        kw = dict(t_scale=sc, t_offset=off, range_min=1.0, range_max=25.0,
                  ring_skip=3)
        a = jnative.decode_filtered(buf, _fields(jpc2, spec), step, n, **kw)
        b = tnative.decode_filtered(buf, fields, step, n, **kw)
        assert len(b[0]) > 0
        for x_, y_ in zip(a, b):
            np.testing.assert_array_equal(x_, y_)


@pytest.mark.parametrize("n,n_rings", [(8, 4), (5000, 16), (4096, 64),
                                       (0, 8)])
def test_ring_sort_bit_identical(jax_lib, n, n_rings):
    rng = np.random.default_rng(n)
    # rings outside [0, n_rings) count as the last ring
    rings = rng.integers(-2, n_rings + 3, n).astype(np.int32)
    a = jnative.ring_sort(rings, n_rings)
    b = tnative.ring_sort(rings, n_rings)
    assert a.dtype == b.dtype == np.int64
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, tnative.ring_sort_numpy(rings, n_rings))
    with pytest.raises(ValueError):
        tnative.ring_sort(rings, 0)


def _config_dicts():
    """SYN_PARAMS, and dicts built here that reach every key the loader
    reads (the reference platform YAMLs are not in the repository)."""
    full = copy.deepcopy(SYN_PARAMS)
    full["graph"]["manager"]["smoother"].update(
        initial_velocity_sigma=0.2, initial_bias_gyro_sigma=0.05,
        initial_bias_acc_sigma=0.5, initial_gravity_sigma=0.3)
    full["imu"]["manager"].update(acc_scale_factor=9.81,
                                  max_buffer_duration=20.0)
    full["imu"]["preintegration"]["integration_sigma"] = 1e-3
    full["lidar"]["T_B_S"] = [0.1, -0.2, 0.3, 0.0, 0.0, 0.3827, 0.9240]
    full["lidar"]["manager"]["range_max"] = 120.0
    full["lidar"]["geometric"].update(point_skip_divisor=4)
    full["lidar"]["geometric"]["scan_to_map"].update(
        num_corres_points=7, use_huber=False, reg_4_dof=True,
        project_on_degneneracy=True, degen_thresh_rot=10.0)
    full["radar"] = {"T_B_S": [0.2, 0, 0.1, 0.0, 0.7071, 0.0, 0.7071],
                     "manager": {"enabled": True, "noise_sigma": 0.04,
                                 "filter_min_db": 6.0, "range_min": 0.5,
                                 "range_max": 16.0,
                                 "threshold_azimuth_deg": 55.0,
                                 "threshold_elevation_deg": 30.0,
                                 "use_to_init": True}}
    full["odometry"] = {"T_B_S": [0, 0, 0.5, 0, 0, 0, 1],
                        "manager": {"enabled": True, "sigma_rot_deg": 0.5,
                                    "sigma_trans_m": 0.001,
                                    "d_opt_thresh": 1.0}}
    return {"empty": {}, "syn_params": SYN_PARAMS,
            "num_corres_7": {"lidar": {"geometric": {"scan_to_map": {
                "num_corres_points": 7}}}},
            "full": full}


CONFIGS = ("sequencer", "window", "voxel_map", "geometric", "radar",
           "odometry")


def _same_config_set(j, t):
    for name in CONFIGS:
        assert dataclasses.asdict(getattr(t, name)) == \
            dataclasses.asdict(getattr(j, name)), name
    for flag in ("lidar_enabled", "radar_enabled", "odometry_enabled"):
        assert getattr(t, flag) == getattr(j, flag), flag
    assert t.raw == j.raw


@pytest.mark.parametrize("name", ["empty", "syn_params", "num_corres_7",
                                  "full"])
def test_from_reference_dict_matches_jax(name):
    raw = _config_dicts()[name]
    kw = dict(max_scan_points=4096) if name == "syn_params" else {}
    j = jload.from_reference_dict(copy.deepcopy(raw), **kw)
    t = tload.from_reference_dict(copy.deepcopy(raw), **kw)
    _same_config_set(j, t)
    if name == "num_corres_7":
        assert t.voxel_map.plane_min_points == 7
    if name == "empty":
        assert t.voxel_map.plane_min_points == 5
    if name == "full":
        assert t.radar_enabled and t.odometry_enabled
        assert t.geometric.huber_delta > 1e20
        assert abs(sum(x * x for x in t.radar.q_b_r) - 1.0) < 1e-12


def test_check_valid_refuses_like_jax():
    bad = {"graph": {"manager": {"smoother": {"lag": 0.05}}},
           "radar": {"manager": {"range_min": 5.0, "range_max": 1.0}},
           "lidar": {"geometric": {"neighbor_voxel_mode": 5}}}
    msgs = []
    for ld in (jload, tload):
        with pytest.raises(ld.ConfigError) as e:
            ld.from_reference_dict(copy.deepcopy(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tload.deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == \
        jload.deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == \
        {"a": {"b": 3, "c": 2}}


def test_load_reference_yaml_with_override_matches_jax(tmp_path):
    cfgp = tmp_path / "params.yaml"
    cfgp.write_text(yaml.safe_dump(SYN_PARAMS))
    ov = tmp_path / "override.yaml"
    ov.write_text("lidar:\n  geometric:\n    scan_to_map:\n"
                  "      reg_4_dof: true\n")
    j = jload.load_reference_yaml(str(cfgp), str(ov), max_scan_points=4096,
                                  n_geo_points=1024)
    t = tload.load_reference_yaml(str(cfgp), str(ov), max_scan_points=4096,
                                  n_geo_points=1024)
    _same_config_set(j, t)
    assert t.geometric.use_4dof and t.sequencer.n_geo_points == 1024


def _ouster_meta(tmp_path, rows=16, cols=256, offset_mm=12.0):
    alt = np.linspace(-22.5, 22.5, rows)
    az = np.linspace(3.0, -3.0, rows)
    meta = {"beam_intrinsics": {
        "beam_altitude_angles": alt.tolist(),
        "beam_azimuth_angles": az.tolist(),
        "lidar_origin_to_beam_origin_mm": offset_mm},
        "lidar_data_format": {
            "columns_per_frame": cols, "pixels_per_column": rows,
            "pixel_shift_by_row": [int(round(a * cols / 360)) for a in az]}}
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta))
    return str(path)


def test_photometric_and_ouster_metadata_match_jax(tmp_path):
    meta_path = _ouster_meta(tmp_path)
    jm, tm = jload.load_ouster_metadata(meta_path), \
        tload.load_ouster_metadata(meta_path)
    assert jm == tm
    np.testing.assert_array_equal(jload.ouster_ray_dirs(jm),
                                  tload.ouster_ray_dirs(tm))
    assert tload.ouster_ray_dirs(tm).shape == (16 * 256, 6)
    no_off = dict(tm, beam_offset_m=0.0)
    assert tload.ouster_ray_dirs(no_off).shape == (16 * 256, 3)
    raw = copy.deepcopy(SYN_PARAMS)
    raw["lidar"]["photometric"] = {
        "enabled": True, "rows": 16, "cols": 256, "fov_up_deg": 17.2,
        "fov_down_deg": -25.8, "gradient_threshold": 0.25, "nma_radius": 5,
        "num_features_detect": 48, "margin_size": 3,
        "high_pass_fir": [0.1, -0.2, 0.1], "low_pass_fir": [0.5, 0.5],
        "edgelet_patch_offsets": [[0, 1], [1, 0]],
        "robust_cost_function": "gemanmcclure"}
    for meta in (None, jm):
        a = jload.photometric_from_reference(raw, meta)
        b = tload.photometric_from_reference(raw, meta)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    b = tload.photometric_from_reference(raw)
    assert (b.rows, b.cols, b.grad_kernel) == (16, 256, "central")
    assert abs(b.fov_up - math.radians(17.2)) < 1e-12
    assert tload.photometric_from_reference(raw, tm).exact_ouster
    raw["lidar"]["photometric"]["robust_cost_function"] = "cauchy"
    with pytest.raises(tload.ConfigError):
        tload.photometric_from_reference(raw)
