"""Typed config loading mirroring the reference's config_utilities layout.

The reference declares per-module config structs loaded from ROS params /
YAML with namespaces like ``imu/preintegration``, ``graph/manager/smoother``,
``lidar/geometric/scan_to_map`` (reference src/graph/manager.cpp:771-839,
src/imu/manager.cpp:496-547, src/lidar/geometric_config.cpp:13-90). Here the
same YAML files (e.g. mimosa/config/enwide/params.yaml) load directly into
this framework's frozen dataclasses, so a reference user can bring their
tuned configs unchanged. Overlay files (the ``config_override`` launch arg,
ref launch/enwide_rosbag.launch:17-21) deep-merge on top.

The port's copy of ``mimosa_tpu/config/loader.py``, building the port's
own config dataclasses (the same fields and defaults). PyYAML is imported
only by :func:`load_reference_yaml`; :func:`from_reference_dict` takes the
parsed dict and needs nothing beyond the port.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

from mimosa_tpu_torch.graph.sequencer import SequencerConfig
from mimosa_tpu_torch.graph.window import WindowConfig
from mimosa_tpu_torch.lidar.geometric import GeometricConfig
from mimosa_tpu_torch.mapping.voxel_hash import VoxelMapConfig
from mimosa_tpu_torch.odometry.factor import OdometryConfig
from mimosa_tpu_torch.radar.factor import RadarConfig


class ConfigError(ValueError):
    pass


def check_valid(cs: "ConfigSet"):
    """Startup validation mirroring the reference's config_utilities
    ``checkValid`` clauses (e.g. geometric_config.cpp:84-89,
    manager.cpp:645-650): fail fast on inconsistent parameters."""
    errs = []

    def chk(cond, msg):
        if not cond:
            errs.append(msg)

    s = cs.sequencer
    chk(s.geo_leaf > 0, "geo_leaf must be > 0")
    chk(s.map_insert_leaf > 0, "map_insert_leaf must be > 0")
    chk(s.n_gn_iters >= 1, "n_gn_iters must be >= 1")
    chk(s.pose_init_wait_secs > 0, "pose_init_wait_secs must be > 0")
    chk(s.max_scan_points > 0, "max_scan_points must be > 0")
    chk(s.n_geo_points <= s.max_scan_points,
        "n_geo_points must be <= max_scan_points")
    chk(s.point_skip >= 1, "point_skip must be >= 1")
    chk(abs(sum(x * x for x in s.q_b_l) - 1.0) < 1e-3,
        "q_b_l must be a unit quaternion")
    m = cs.voxel_map
    chk(m.neighbor_voxel_mode in (1, 7, 19, 27),
        "neighbor_voxel_mode must be 1/7/19/27")
    chk(m.plane_min_points >= 3, "plane_min_points must be >= 3")
    chk(m.plane_max_thickness > 0, "plane_max_thickness must be > 0")
    g = cs.geometric
    chk(g.sigma > 0, "geometric sigma must be > 0")
    chk(g.max_p2p_dist > 0, "max_corres_distance must be > 0")
    w = cs.window
    chk(w.K >= 2, "window K must be >= 2")
    chk(w.g_mag > 9.0 and w.g_mag < 10.5, "gravity magnitude implausible")
    r = cs.radar
    chk(r.sigma > 0, "radar noise_sigma must be > 0")
    chk(r.max_range > r.min_range, "radar range_max must exceed range_min")
    if errs:
        raise ConfigError("invalid configuration:\n  " + "\n  ".join(errs))
    return cs


@dataclasses.dataclass(frozen=True)
class ConfigSet:
    sequencer: SequencerConfig
    window: WindowConfig
    voxel_map: VoxelMapConfig
    geometric: GeometricConfig
    radar: RadarConfig
    odometry: OdometryConfig
    raw: dict
    lidar_enabled: bool = True
    radar_enabled: bool = False
    odometry_enabled: bool = False


def deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _get(d: dict, path: str, default=None):
    cur: Any = d
    for k in path.split("/"):
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def _pose7(v):
    """Reference T_B_S format [x y z qx qy qz qw] -> (q_wxyz, t).
    Normalizes the quaternion: hand-written extrinsics in the shipped
    configs are off by up to 3e-4 (e.g. magpie's lidar T_B_S), and the
    reference's gtsam::Rot3 normalizes on construction."""
    x, y, z, qx, qy, qz, qw = v
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz) or 1.0
    return (qw / n, qx / n, qy / n, qz / n), (x, y, z)


def load_ouster_metadata(path) -> dict:
    """Ouster sensor metadata JSON (the reference loads it into the
    ``lidar/sensor`` namespace — ref photometric_config.cpp:64-74,
    e.g. mimosa/config/enwide/os_enwide.json). Returns beam altitude
    angles in radians, per-row pixel shifts and image dimensions."""
    with open(path) as f:
        meta = json.load(f)
    bi = meta.get("beam_intrinsics", meta)
    alt_deg = bi.get("beam_altitude_angles")
    az_deg = bi.get("beam_azimuth_angles")
    li = meta.get("lidar_data_format", meta.get("data_format", {}))
    shifts = li.get("pixel_shift_by_row")
    cols = li.get("columns_per_frame")
    rows = li.get("pixels_per_column", len(alt_deg) if alt_deg else None)
    if cols is None:
        mode = meta.get("config_params", {}).get("lidar_mode", "1024x10")
        cols = int(str(mode).split("x")[0])
    return dict(
        beam_altitudes=tuple(math.radians(a) for a in alt_deg),
        # per-beam azimuth offsets (degrees -> radians): the exact values
        # the integer pixel_shift_by_row rounds to columns
        # (shift[v] = round(az_deg[v] * cols / 360) in every shipped
        # os_*.json) — required for the range_transfer beam table; a
        # rounded shift alone is off by up to half a column (~0.2 deg =
        # decimeters at range)
        beam_azimuths=tuple(math.radians(a) for a in az_deg)
        if az_deg else None,
        pixel_shift_by_row=tuple(shifts) if shifts else None,
        rows=int(rows), cols=int(cols),
        beam_offset_m=float(
            bi.get("lidar_origin_to_beam_origin_mm", 0.0)) * 1e-3,
    )


def ouster_ray_dirs(meta: dict):
    """Per-lane beam table for ``SequencerConfig.range_transfer``, in the
    STAGGERED sensor pixel-id order (row-major, measurement block
    fastest) that the Ouster data stream and the exact_ouster photometric
    fill consume (ref photometric.cpp:72-90 PBID addressing).

    Azimuth of row v, block c: the encoder angle 2*pi*(1 - c/cols) — the
    Ouster driver's own convention (Sensor Docs "lidar frame": theta_enc
    = 2*pi*(1 - measurement_id/cols)) — plus the per-beam azimuth offset:
    the EXACT ``beam_azimuth_angles`` when the metadata carries them
    (shift[v] = round(az[v]*cols/360) in every shipped os_*.json, so the
    integer destagger shift is their column-rounded form — rounding alone
    is off by up to half a column, decimeters at range), else the
    shift-derived approximation (the synthetic generate_ouster model).
    Elevation: beam_altitude_angles[v].

    With a nonzero ``lidar_origin_to_beam_origin`` the Ouster model is
    AFFINE: p = s*dir + n*enc with enc the horizontal encoder direction
    (Ouster Sensor Docs, lidar_origin_to_beam_origin_mm; ref
    config/enwide/os_enwide.json) — then returns [N,6] (dir, offset) and
    the codec packs s = dot(p - offset, dir) (see native.pack_range);
    with n == 0 returns plain [N,3] unit dirs (p = r*dir).

    NOTE on conventions: io.synthetic.generate_ouster emits the same
    encoder origin, so table and synthetic cloud agree exactly. If a real
    driver's cloud still disagrees (a custom driver frame), the codec
    fidelity check in io/replay.py (--range-transfer) measures the
    reconstruction residual on the first scan, auto-compensates a fixed
    sensor-frame yaw when one explains the residual (a fixed yaw cancels
    in the estimator), and refuses otherwise rather than silently
    corrupting points."""
    import numpy as np
    alt = np.asarray(meta["beam_altitudes"])
    rows, n_cols = int(meta["rows"]), int(meta["cols"])
    v, c = np.meshgrid(np.arange(rows), np.arange(n_cols), indexing="ij")
    az_enc = 2.0 * np.pi * (1.0 - c / n_cols)
    beam_az = meta.get("beam_azimuths")
    if beam_az is not None and len(beam_az):
        az = az_enc - np.asarray(beam_az, float)[:, None] \
            * np.ones_like(az_enc)
    else:
        shifts = np.asarray(meta["pixel_shift_by_row"] or [0] * rows, int)
        u_dest = (c + shifts[:, None]) % n_cols
        az = 2.0 * np.pi * (1.0 - u_dest / n_cols)
    ca, sa = np.cos(az), np.sin(az)
    cal = np.cos(alt)[:, None] * np.ones_like(ca)
    sal = np.sin(alt)[:, None] * np.ones_like(ca)
    dirs = np.stack([cal * ca, cal * sa, sal], -1).reshape(-1, 3)
    n_off = float(meta.get("beam_offset_m", 0.0) or 0.0)
    if n_off == 0.0:
        return dirs
    enc = np.stack([np.cos(az_enc), np.sin(az_enc),
                    np.zeros_like(az_enc)], -1)
    enc = (enc * np.ones_like(az)[..., None]).reshape(-1, 3)
    return np.concatenate([dirs, n_off * enc], axis=-1)


def photometric_from_reference(raw: dict, ouster_meta=None):
    """Build a PhotometricConfig from the reference's ``lidar/photometric``
    namespace (ref photometric_config.cpp:14-112) + optional Ouster
    metadata for the beam table."""
    from mimosa_tpu_torch.lidar.photometric import PhotometricConfig

    g = lambda p, d=None: _get(raw, "lidar/photometric/" + p, d)  # noqa: E731
    kw = dict(
        range_min=float(g("range_min", 0.5)),
        range_max=float(g("range_max", 30.0)),
        patch_size=int(g("patch_size", 5)),
        margin=int(g("margin_size", 10)),
        erosion_buffer=int(g("erosion_buffer", 10)),
        intensity_scale=float(g("intensity_scale", 0.25)),
        intensity_gamma=float(g("intensity_gamma", 1.0)),
        remove_lines=bool(g("remove_lines", True)),
        filter_brightness=bool(g("filter_brightness", True)),
        brightness_window=tuple(g("brightness_window_size", (41, 7))),
        gaussian_blur=bool(g("gaussian_blur", True)),
        gaussian_blur_size=int(g("gaussian_blur_size", 3)),
        hp_fir=tuple(g("high_pass_fir", ())),
        lp_fir=tuple(g("low_pass_fir", ())),
        # the reference's gradient magnitudes come from cv::Sobel ksize=1
        # scale=0.5 (central difference) — its gradient_threshold values
        # are tuned for that scale
        grad_kernel="central",
        gradient_threshold=float(g("gradient_threshold", 10.0)),
        nma_radius=int(g("nma_radius", 11)),
        num_features=int(g("num_features_detect", 60)),
        max_feature_life=int(g("max_feature_life_time", 1000)),
        occlusion_range_diff=float(
            g("occlusion_range_diff_threshold", 0.2)),
        max_dist_from_mean=float(g("max_dist_from_mean", 3.0)),
        max_dist_from_plane=float(g("max_dist_from_plane", 0.5)),
        sigma=float(g("sigma", 0.25)),
        use_robust=bool(g("use_robust_cost_function", True)),
        robust=str(g("robust_cost_function", "huber")),
        huber_delta=float(g("robust_cost_function_parameter", 1.345)),
        max_error=float(g("max_error", 0.5075)),
        static_mask_path=str(g("static_mask_path", "")),
        # edgelet machinery (ref photometric_config.cpp:53-55): explicit
        # sampling pattern as (x=col, y=row) pairs + per-feature rotation
        # of the pattern onto the local edge normal/tangent frame
        patch_offsets=tuple(tuple(int(v) for v in p)
                            for p in (g("edgelet_patch_offsets") or ())),
        rotate_patch=bool(g("rotate_patch_to_align_with_gradient", False)),
    )
    if kw["robust"] not in ("huber", "gemanmcclure"):
        raise ConfigError("robust_cost_function must be huber or "
                          "gemanmcclure")
    if ouster_meta:
        kw.update(rows=ouster_meta["rows"], cols=ouster_meta["cols"],
                  beam_altitudes=ouster_meta["beam_altitudes"])
        if ouster_meta.get("pixel_shift_by_row"):
            # real Ouster metadata enables the exact sampling model
            # (destagger + yaw table + projectUndistorted — the
            # reference's only model, photometric.cpp:72-198); explicit
            # lidar/photometric/exact_ouster: false opts out
            kw.update(
                exact_ouster=bool(g("exact_ouster", True)),
                pixel_shift_by_row=ouster_meta["pixel_shift_by_row"],
                beam_offset_m=ouster_meta.get("beam_offset_m", 0.0))
    else:
        # without sensor metadata the image model comes from explicit keys
        # (extension for non-Ouster / synthetic platforms; the reference
        # always derives these from the metadata JSON)
        if g("rows"):
            kw.update(rows=int(g("rows")), cols=int(g("cols", 1024)))
        if g("fov_up_deg") is not None:
            kw.update(fov_up=math.radians(float(g("fov_up_deg"))),
                      fov_down=math.radians(float(g("fov_down_deg", -45.0))))
    return PhotometricConfig(**kw)


def load_reference_yaml(path, override_path=None, declare_rate_hz=10.0,
                        **seq_overrides) -> ConfigSet:
    """Load a reference-format params.yaml (+ optional override overlay).
    Needs PyYAML."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    if override_path:
        with open(override_path) as f:
            raw = deep_merge(raw, yaml.safe_load(f) or {})
    return from_reference_dict(raw, declare_rate_hz=declare_rate_hz,
                               **seq_overrides)


def from_reference_dict(raw: dict, declare_rate_hz=10.0,
                        **seq_overrides) -> ConfigSet:
    g = lambda p, d=None: _get(raw, p, d)  # noqa: E731

    # ---- window / smoother (ref graph/manager.cpp:45-93,771-839)
    # K is the static slot CAPACITY, sized for the expected multi-sensor
    # declare rate (lidar + radar + odometry Hz — pass the sum as
    # declare_rate_hz for e.g. hornbill's 20-50 Hz radar declares); the
    # reference's time-lag SEMANTICS are enforced at runtime by
    # SequencerConfig.lag_secs (age-based marginalization), so an
    # over-provisioned K costs only compute, never accuracy.
    lag = float(g("graph/manager/smoother/lag", 0.5))
    K = max(3, int(math.ceil(lag * declare_rate_hz)) + 1)
    deg = math.pi / 180.0
    window = WindowConfig(
        K=K,
        g_mag=float(g("imu/preintegration/gravity_magnitude", 9.81)),
        sigma_bg_rw=float(g("imu/preintegration/gyro_bias_random_walk", 1e-3)),
        sigma_ba_rw=float(g("imu/preintegration/acc_bias_random_walk", 5e-2)),
        init_sigma_rot=max(
            float(g("graph/manager/smoother/"
                    "initial_rotation_pitch_roll_sigma_deg", 1e-6)) * deg,
            1e-8),
        init_sigma_pos=max(
            float(g("graph/manager/smoother/initial_position_sigma", 1e-6)),
            1e-8),
        init_sigma_vel=float(
            g("graph/manager/smoother/initial_velocity_sigma", 0.1)),
        init_sigma_bg=float(
            g("graph/manager/smoother/initial_bias_gyro_sigma", 0.1)),
        init_sigma_ba=float(
            g("graph/manager/smoother/initial_bias_acc_sigma", 1.0)),
        init_sigma_grav=float(
            g("graph/manager/smoother/initial_gravity_sigma", 0.5)),
    )

    # ---- voxel map (ref lidar/geometric scan_to_map + iVox params)
    voxel_map = VoxelMapConfig(
        leaf_size=float(
            g("lidar/geometric/scan_to_map/target_ivox_map_leaf_size", 0.5)),
        neighbor_voxel_mode=int(g("lidar/geometric/neighbor_voxel_mode", 7)),
        lru_horizon=int(g("lidar/geometric/lru_horizon", 1000)),
        # ref fits the correspondence plane from num_corres_points kNN
        # points (geometric_config.hpp:23, =5 in every dataset config); a
        # voxel plane fitted from fewer points than that is not a valid
        # correspondence
        plane_min_points=float(
            g("lidar/geometric/scan_to_map/num_corres_points", 5)),
        plane_max_thickness=float(
            g("lidar/geometric/scan_to_map/plane_validity_distance", 0.07)),
    )

    # ---- geometric ICP (ref geometric_config.cpp)
    sigma = float(g("lidar/geometric/scan_to_map/lidar_point_noise_std_dev",
                    0.07))
    use_huber = bool(g("lidar/geometric/scan_to_map/use_huber", True))
    geometric = GeometricConfig(
        sigma=sigma,
        huber_delta=(float(
            g("lidar/geometric/scan_to_map/huber_threshold", 1.345)) * sigma
            if use_huber else 1e30),
        max_p2p_dist=float(
            g("lidar/geometric/scan_to_map/max_corres_distance", 1.0)),
        use_4dof=bool(g("lidar/geometric/scan_to_map/reg_4_dof", False)),
        project_degenerate=bool(
            g("lidar/geometric/scan_to_map/project_on_degneneracy", False)),
        loc_count_thresh=float(
            g("lidar/geometric/scan_to_map/degen_thresh_trans", 40.0)),
        # the reference keeps a separate (usually 0 = never degenerate)
        # rotation threshold, geometric_config.hpp:31
        loc_count_thresh_rot=float(
            g("lidar/geometric/scan_to_map/degen_thresh_rot", 0.0)),
    )

    # ---- radar (ref src/radar/manager.cpp config)
    q_br, t_br = _pose7(g("radar/T_B_S", [0, 0, 0, 0, 0, 0, 1]))
    radar = RadarConfig(
        sigma=float(g("radar/manager/noise_sigma", 0.05)),
        min_snr_db=float(g("radar/manager/filter_min_db", 5.0)),
        min_range=float(g("radar/manager/range_min", 0.1)),
        max_range=float(g("radar/manager/range_max", 60.0)),
        max_azimuth=float(g("radar/manager/threshold_azimuth_deg", 60.0))
        * deg,
        max_elevation=float(g("radar/manager/threshold_elevation_deg", 60.0))
        * deg,
        q_b_r=q_br, t_b_r=t_br,
        use_to_init=bool(g("radar/manager/use_to_init", False)),
    )

    # ---- odometry (ref src/odometry/manager.cpp:82-84 key names)
    q_bs, t_bs = _pose7(g("odometry/T_B_S", [0, 0, 0, 0, 0, 0, 1]))
    odometry = OdometryConfig(
        sigma_rot=float(g("odometry/manager/sigma_rot_deg", 1.15)) * deg,
        sigma_trans=float(g("odometry/manager/sigma_trans_m", 0.05)),
        max_d_optimality=float(g("odometry/manager/d_opt_thresh", 1e-2)),
        q_b_s=q_bs, t_b_s=t_bs,
        use_to_init=bool(g("odometry/manager/use_to_init", False)),
    )

    # ---- sequencer
    q_bl, t_bl = _pose7(g("lidar/T_B_S", [0, 0, 0, 0, 0, 0, 1]))
    seq_kwargs = dict(
        lag_secs=lag,
        # the reference's point_skip_divisor thins only the geometric
        # pipeline (manager.cpp:244-335); geo_skip applies it on-device so
        # photometric sees the full cloud
        geo_skip=int(g("lidar/geometric/point_skip_divisor", 1)),
        geo_leaf=float(g(
            "lidar/geometric/scan_to_map/source_voxel_grid_filter_leaf_size",
            0.5)),
        map_insert_leaf=float(g(
            "lidar/geometric/scan_to_map/target_ivox_map_min_dist_in_voxel",
            0.15)),
        n_gn_iters=min(
            int(g("graph/manager/smoother/additional_update_iterations", 5))
            + 1, 6),
        g_mag=window.g_mag,
        pose_init_wait_secs=float(
            g("imu/manager/pose_init_wait_secs", 0.5)),
        gravity_aligned_init=bool(
            g("imu/preintegration/gravity_aligned_initialization", True)),
        max_measurement_latency=float(
            g("graph/manager/max_measurement_latency", 0.25)),
        keyframe_trans_thresh=float(
            g("lidar/geometric/map_keyframe_trans_thresh", 2.0)),
        keyframe_rot_thresh=float(
            g("lidar/geometric/map_keyframe_rot_thresh_deg", 30.0)) * deg,
        num_initial_keyframes=max(
            int(g("lidar/geometric/initial_clouds_to_force_map_update", 1)),
            1),
        acc_var=float(g("imu/preintegration/acc_noise_density", 0.2)) ** 2,
        gyro_var=float(g("imu/preintegration/gyro_noise_density", 0.026)) ** 2,
        int_var=max(float(g("imu/preintegration/integration_sigma", 0.0)),
                    1e-4) ** 2,
        imu_acc_scale=float(g("imu/manager/acc_scale_factor", 1.0)),
        imu_max_buffer_duration=float(
            g("imu/manager/max_buffer_duration", 30.0)),
        q_b_l=q_bl, t_b_l=t_bl,
        # finest int16 position resolution that still covers the platform's
        # lidar range (2% headroom); floors at the default 2.5 mm
        quant_pos_res=max(
            SequencerConfig.quant_pos_res,
            float(g("lidar/manager/range_max", 100.0)) * 1.02 / 32767.0),
        # range_transfer ships uint16 ranges (span 0..65534 LSB): same
        # widening rule against the platform's range_max
        quant_range_res=max(
            SequencerConfig.quant_range_res,
            float(g("lidar/manager/range_max", 100.0)) * 1.02 / 65534.0),
    )
    seq_kwargs.update(seq_overrides)
    # clamp downsample sizes to the scan size unless explicitly overridden
    msp = seq_kwargs.get("max_scan_points", SequencerConfig.max_scan_points)
    seq_kwargs.setdefault("n_geo_points",
                          min(SequencerConfig.n_geo_points, msp))
    seq_kwargs.setdefault("n_map_points",
                          min(SequencerConfig.n_map_points, msp))
    sequencer = SequencerConfig(**seq_kwargs)

    return check_valid(ConfigSet(
        sequencer=sequencer, window=window, voxel_map=voxel_map,
        geometric=geometric, radar=radar, odometry=odometry, raw=raw,
        lidar_enabled=bool(g("lidar/manager/enabled", True)),
        radar_enabled=bool(g("radar/manager/enabled", False)),
        odometry_enabled=bool(g("odometry/manager/enabled", False)),
    ))
