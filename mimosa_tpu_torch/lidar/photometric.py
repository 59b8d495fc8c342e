"""Photometric intensity-patch pipeline (PG-LIO).

Port of ``mimosa_tpu/lidar/photometric.py`` as batched torch image ops:

* image build: deskewed points scatter into [rows, cols] range / intensity
  images through the spherical projection (beam altitude table + azimuth
  model), the nearest point winning each pixel and the lowest lane winning
  a tie; or, with ``exact_ouster``, the sensor's pixel-id fill with a
  per-row yaw table and per-pixel re-skew transforms;
* the intensity normalization chain (scale, gamma, line removal by a
  vertical high-pass FIR x horizontal low-pass FIR, brightness flattening
  by a box blur, Gaussian blur, clamp) as ``conv2d`` correlations, Sobel
  gradients, and the valid-mask erosion as a min-pool;
* feature detection: gradient threshold, suppression near live features,
  non-max suppression among eligible pixels only, degeneracy-aware scoring,
  top-k by a stable descending sort (the lower pixel index first on ties,
  as ``lax.top_k``), rotated patches and the 3-D patch gates;
* the NCC patch factor: psi-normalized patch residuals sampled bilinearly,
  robust weights and status codes. The JAX package takes one ``jacfwd`` a
  feature under ``vmap``; the pose tangent is shared by all features, so
  here one ``torch.func.jacfwd`` of the batched residual [F, P] gives the
  whole Jacobian [F, P, 6] (the same math in fewer device ops).

The configuration's constant tensors (altitude table, FIR taps, blur and
Sobel kernels, patch offsets, destagger map, fallback point, identity
quaternion image) are made once per (config, device, dtype) by
:func:`resident` and reused, so a step that calls these functions holds no
host-to-device copy and can be captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F_nn

from mimosa_tpu_torch.core import eigh3, lie

# feature / projection rejection statuses
PH_OK = 0
PH_OOB = 1          # out of image bounds / FOV
PH_RANGE = 2
PH_MASKED = 3
PH_OCCLUDED = 4
PH_NCC = 5
PH_NUM_STATUS = 6


@dataclasses.dataclass(frozen=True)
class PhotometricConfig:
    rows: int = 64
    cols: int = 1024
    # beam altitude angles (radians, length == rows, descending or ascending)
    fov_up: float = 0.3927            # used if altitude table not given
    fov_down: float = -0.3927
    beam_altitudes: tuple = ()        # explicit table wins (Ouster JSON)
    range_min: float = 0.5
    range_max: float = 30.0
    patch_size: int = 5
    margin: int = 10
    erosion_buffer: int = 10
    intensity_scale: float = 0.25
    intensity_gamma: float = 1.0
    remove_lines: bool = True
    filter_brightness: bool = True
    brightness_window: tuple = (41, 7)
    gaussian_blur: bool = True
    gaussian_blur_size: int = 3       # odd
    # FIR taps of the line-removal chain (empty: _HP_FIR / _LP_FIR)
    hp_fir: tuple = ()
    lp_fir: tuple = ()
    # gradient kernel: "sobel3" (3x3 Sobel) or "central" ([-0.5, 0, 0.5],
    # 8x smaller magnitude: gradient_threshold does not transfer)
    grad_kernel: str = "sobel3"
    gradient_threshold: float = 10.0
    nma_radius: int = 11
    num_features: int = 60            # live feature budget
    max_feature_life: int = 1000
    occlusion_range_diff: float = 0.2
    # patch 3-D validity at detection: every patch point within
    # max_dist_from_mean of the centroid and max_dist_from_plane of the
    # patch plane
    max_dist_from_mean: float = 3.0
    max_dist_from_plane: float = 0.5
    sigma: float = 0.25
    # robust cost on the whitened residual norm: "huber" or "gemanmcclure"
    use_robust: bool = True
    robust: str = "huber"
    huber_delta: float = 1.345
    max_error: float = 0.5075
    # static environment mask file (zeros = masked): .npy bool/uint8 array
    # or a grayscale image PIL can read
    static_mask_path: str = ""
    project_on_degeneracy: bool = True  # unary VSV^T selection
    # patch sampling pattern as (x=col, y=row) offsets added to the
    # candidate pixel; empty = the full patch_size x patch_size square.
    # rotate_patch aligns the pattern with the local edge normal/tangent
    patch_offsets: tuple = ()
    rotate_patch: bool = False
    # exact Ouster sampling model: pixel-id fill (destagger shifts), a
    # per-row yaw table of the raw sampling azimuths with hole
    # interpolation, projection through that table, and patch samples
    # re-skewed to the matched pixel's sampling time
    exact_ouster: bool = False
    pixel_shift_by_row: tuple = ()    # Ouster metadata per-row shift
    beam_offset_m: float = 0.0        # lidar origin to beam origin [m]


# default FIR taps (the reference configuration's high / low pass)
_HP_FIR = (-0.00122687, -0.00152587, 0.0009631, 0.00382838, 0.00071422,
           -0.00765637, -0.00681285, 0.01015542, 0.01944999, -0.00536835,
           -0.03792929, -0.01565801, 0.05816374, 0.07138264, -0.07402277,
           -0.30572514, 0.5802669, -0.30572514, -0.07402277, 0.07138264,
           0.05816374, -0.01565801, -0.03792929, -0.00536835, 0.01944999,
           0.01015542, -0.00681285, -0.00765637, 0.00071422, 0.00382838,
           0.0009631, -0.00152587, -0.00122687)
_LP_FIR = (-0.0013038, -0.00117813, -0.00102349, -0.00051396, 0.000759,
           0.00322145, 0.00724004, 0.01304552, 0.02066957, 0.02990645,
           0.04030759, 0.0512121, 0.06181081, 0.07123596, 0.07866427,
           0.08341891, 0.08505541, 0.08341891, 0.07866427, 0.07123596,
           0.06181081, 0.0512121, 0.04030759, 0.02990645, 0.02066957,
           0.01304552, 0.00724004, 0.00322145, 0.000759, -0.00051396,
           -0.00102349, -0.00117813, -0.0013038)

_YAW_WIN = 5   # the yaw-table search window: +-5 columns around the guess


def _altitudes_np(cfg: PhotometricConfig):
    if cfg.beam_altitudes:
        return np.asarray(cfg.beam_altitudes, np.float64)
    return np.linspace(cfg.fov_up, cfg.fov_down, cfg.rows)


def patch_layout(cfg: PhotometricConfig):
    """Static patch sampling pattern as (dr[P], dc[P], center_idx) numpy
    int32 arrays and an int: from ``cfg.patch_offsets`` ((x=col, y=row)
    pairs) or the full patch_size square. center_idx is the sample closest
    to (0, 0)."""
    if cfg.patch_offsets:
        off = np.asarray(cfg.patch_offsets, np.int32)
        dc, dr = off[:, 0], off[:, 1]
    else:
        half = cfg.patch_size // 2
        rr, cc = np.meshgrid(np.arange(-half, half + 1),
                             np.arange(-half, half + 1), indexing="ij")
        dr, dc = rr.reshape(-1), cc.reshape(-1)
    ci = int(np.argmin(dr.astype(np.int64) ** 2 + dc.astype(np.int64) ** 2))
    return dr.astype(np.int32), dc.astype(np.int32), ci


def n_patch_points(cfg: PhotometricConfig) -> int:
    return (len(cfg.patch_offsets) if cfg.patch_offsets
            else cfg.patch_size ** 2)


def _destagger_np(cfg: PhotometricConfig):
    shift = np.asarray(cfg.pixel_shift_by_row or (0,) * cfg.rows, np.int64)
    c = np.arange(cfg.cols)[None, :]
    u = (c + shift[:, None]) % cfg.cols
    return (np.arange(cfg.rows)[:, None] * cfg.cols + u).reshape(-1)


class Resident(NamedTuple):
    """A configuration's constant tensors on one device (:func:`resident`)."""

    alt: torch.Tensor        # [R] beam altitudes as the config gives them
    desc: bool               # the table descends (row 0 the highest beam)
    t_alt: torch.Tensor      # [R] ascending: -alt where the table descends
    hp: torch.Tensor         # [1,1,K,1] vertical high-pass FIR
    lp: torch.Tensor         # [1,1,1,K] horizontal low-pass FIR
    gauss: torch.Tensor      # [1,1,k,k] Gaussian blur
    dr: torch.Tensor         # [P] int64 patch offsets
    dc: torch.Tensor
    dmap: torch.Tensor       # [R*C] int64 destagger map
    fallback: torch.Tensor   # [3] stand-in point of an empty slot
    yaw_offs: torch.Tensor   # [2*_YAW_WIN+1] int64
    q_id: torch.Tensor       # [R*C+1, 4] identity quaternions (exact mode)


@functools.lru_cache(maxsize=None)
def _resident(cfg: PhotometricConfig, device: torch.device, dtype):
    """Cached for the life of the process, one entry a (config, device,
    dtype); every caller shares the tensors, and no function writes into
    them."""
    f = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    alt_np = _altitudes_np(cfg)
    alt = torch.tensor(alt_np, **f)
    hp = torch.tensor(cfg.hp_fir or _HP_FIR, **f)
    lp = torch.tensor(cfg.lp_fir or _LP_FIR, **f)
    k = cfg.gaussian_blur_size
    # OpenCV's default sigma for ksize k (GaussianBlur with sigma=0)
    s = 0.3 * ((k - 1) * 0.5 - 1.0) + 0.8
    x = torch.arange(k, **f) - (k - 1) / 2.0
    g1 = torch.exp(-0.5 * (x / s) ** 2)
    g = torch.outer(g1, g1)
    dr, dc, _ = patch_layout(cfg)
    npx = cfg.rows * cfg.cols
    q_id = torch.eye(1, 4, **f).expand(npx + 1 if cfg.exact_ouster else 1,
                                       4).contiguous()
    desc = bool(alt_np[0] > alt_np[-1])
    return Resident(
        alt=alt, desc=desc, t_alt=-alt if desc else alt,
        hp=hp[None, None, :, None], lp=lp[None, None, None, :],
        gauss=(g / g.sum())[None, None],
        dr=torch.tensor(dr, **i64), dc=torch.tensor(dc, **i64),
        dmap=torch.tensor(_destagger_np(cfg), **i64),
        fallback=torch.tensor([5.0, 1.0, 0.5], **f),
        yaw_offs=torch.arange(-_YAW_WIN, _YAW_WIN + 1, **i64),
        q_id=q_id)


def resident(cfg: PhotometricConfig, like: torch.Tensor) -> Resident:
    """The constant tensors of ``cfg`` on ``like``'s device in its dtype,
    made at the first call and reused (no host copy after it); the first
    call also makes the gradient kernels :func:`sobel` takes."""
    _gradient_kernels(cfg.grad_kernel, like.device, like.dtype)
    return _resident(cfg, like.device, like.dtype)


def altitudes(cfg: PhotometricConfig, like: torch.Tensor = None):
    """The beam altitude table [rows] (on ``like``'s device and dtype;
    f32 on the CPU without it)."""
    if like is None:
        like = torch.zeros(())
    return resident(cfg, like).alt


class Frame(NamedTuple):
    """Per-scan image pyramid. The exact-Ouster fields (None in the
    approximate model) carry the per-row yaw table and the per-pixel
    re-skew transforms."""

    intensity: torch.Tensor   # [R,C] normalized
    rng: torch.Tensor         # [R,C] range image (0 where empty)
    mask: torch.Tensor        # [R,C] bool: valid & eroded
    gx: torch.Tensor          # [R,C] Sobel
    gy: torch.Tensor
    yaw: torch.Tensor = None      # [R,C] raw sampling azimuths (exact mode)
    p_img: torch.Tensor = None    # [R,C,3] deskewed Le point per pixel
    q_rs: torch.Tensor = None     # [R,C,4] T_Le_Lt rotation per pixel
    t_rs: torch.Tensor = None     # [R,C,3] T_Le_Lt translation per pixel
    rs_ok: torch.Tensor = None    # [R,C] bool: re-skew pixel filled
    col_q: torch.Tensor = None    # [C,4] column-fallback rotation
    col_t: torch.Tensor = None    # [C,3]
    col_ok: torch.Tensor = None   # [C] bool


def _norm(x):
    """|x| over the last axis as sqrt(sum x^2) (``jnp.linalg.norm``)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _iround(x, hi):
    """round half to even, then clip to [0, hi], as int64 indices."""
    return torch.clamp(torch.round(x).to(torch.int64), 0, hi)


# ---------------------------------------------------------------------------
# projection model
# ---------------------------------------------------------------------------

def _row_of(a, c, cfg):
    """Fractional row of altitudes ``a`` (already sign-flipped where the
    table descends) in the ascending table ``c.t_alt``, and the in-bounds
    flag."""
    t = c.t_alt
    i = torch.clamp(torch.searchsorted(t, a.contiguous()) - 1, 0,
                    cfg.rows - 2)
    t0, t1 = t[i], t[i + 1]
    frac = torch.clamp((a - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return i + frac, (a >= t[0]) & (a <= t[-1])


def project(points, cfg: PhotometricConfig):
    """Spherical projection lidar-frame points -> fractional (row, col).

    Returns (u row, v col, rng, in_fov). Azimuth +pi maps to col 0 and the
    column grows as the azimuth falls (clockwise seen from above)."""
    c = resident(cfg, points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = torch.sqrt(x * x + y * y + z * z + 1e-12)
    az = torch.atan2(y, x)
    v = (1.0 - az / math.pi) * 0.5 * cfg.cols
    v = torch.remainder(v, cfg.cols)
    alt = torch.asin(torch.clamp(z / rng, -1.0, 1.0))
    u, in_fov = _row_of(-alt if c.desc else alt, c, cfg)
    return u, v, rng, in_fov


def backproject(u, v, rng, cfg: PhotometricConfig):
    """(row, col, range) -> lidar-frame 3-D point (inverse of project)."""
    table = resident(cfg, u).alt
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, cfg.rows - 2)
    alt = table[i] + (u - i) * (table[i + 1] - table[i])
    az = (1.0 - 2.0 * v / cfg.cols) * math.pi
    ca = torch.cos(alt)
    return torch.stack([rng * ca * torch.cos(az), rng * ca * torch.sin(az),
                        rng * torch.sin(alt)], dim=-1)


# ---------------------------------------------------------------------------
# exact Ouster sampling model (flagged)
# ---------------------------------------------------------------------------

def destagger_flat_map(cfg: PhotometricConfig, device=None):
    """idx -> flat destaggered pixel map [R*C] int64: staggered column c of
    row v maps to image column (c + pixel_shift_by_row[v]) mod cols."""
    return torch.as_tensor(_destagger_np(cfg), device=device)


def fill_row_holes(vals, filled, cfg: PhotometricConfig,
                   left_anchor=np.pi, right_anchor=-np.pi):
    """Per-row linear interpolation of unfilled pixels between the nearest
    filled columns, anchored at +pi (col 0) / -pi (last col): the yaw-table
    hole interpolation."""
    R, C = vals.shape
    dtype = vals.dtype
    cols_i = torch.arange(C, device=vals.device)[None, :].expand(R, C)
    li = torch.cummax(torch.where(filled, cols_i, -1), dim=1).values
    ri_rev = torch.cummax(torch.flip(torch.where(filled, C - 1 - cols_i, -1),
                                     [1]), dim=1).values
    ri = C - 1 - torch.flip(ri_rev, [1])
    lv = torch.gather(vals, 1, torch.clamp(li, 0, C - 1))
    rv = torch.gather(vals, 1, torch.clamp(ri, 0, C - 1))
    lv = torch.where(li >= 0, lv, left_anchor)
    rv = torch.where(ri <= C - 1, rv, right_anchor)
    lpos = torch.where(li >= 0, li, 0).to(dtype)
    rpos = torch.where(ri <= C - 1, ri, C - 1).to(dtype)
    t = (cols_i.to(dtype) - lpos) / torch.clamp(rpos - lpos, min=1.0)
    return torch.where(filled, vals, lv + t * (rv - lv))


def _spherical(points, cfg: PhotometricConfig):
    """(phi azimuth, theta altitude with the beam-origin offset, range)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rxy = torch.sqrt(x * x + y * y + 1e-12)
    L = rxy - cfg.beam_offset_m
    R = torch.sqrt(L * L + z * z + 1e-12)
    phi = torch.atan2(y, x)
    theta = torch.asin(torch.clamp(z / R, -1.0, 1.0))
    rng = torch.sqrt(x * x + y * y + z * z + 1e-12)
    return phi, theta, rng


def project_yaw(points, yaw, cfg: PhotometricConfig):
    """Exact projection through the per-row yaw table: the ideal azimuth
    gives the column guess, then the bracketing pair of actual sampling
    azimuths within +-5 columns gives the sub-pixel column. Returns (u row,
    v col, rng, ok)."""
    c = resident(cfg, points)
    dtype = points.dtype
    phi, theta, rng = _spherical(points, cfg)
    u, in_alt = _row_of(-theta if c.desc else theta, c, cfg)

    v0 = -cfg.cols / (2.0 * math.pi) * phi + 0.5 * cfg.cols   # fx*phi + cx
    safety = (v0 >= _YAW_WIN) & (v0 <= cfg.cols - _YAW_WIN)
    ri = _iround(u, cfg.rows - 1)
    base = torch.clamp(torch.round(v0).to(torch.int64), _YAW_WIN,
                       cfg.cols - _YAW_WIN - 1)
    yw = yaw[ri[..., None], base[..., None] + c.yaw_offs]      # [..., 11]
    phe = phi[..., None]
    # yaw descends along columns: find the bracketing adjacent pair
    br = (yw[..., :-1] >= phe) & (yw[..., 1:] <= phe)
    found = torch.any(br, dim=-1)
    kb = torch.argmax(br.to(torch.int32), dim=-1)
    # fallback: extrapolate from the nearest pair
    kn = torch.clamp(torch.argmin(torch.abs(yw - phe), dim=-1), 0,
                     2 * _YAW_WIN - 1)
    k = torch.where(found, kb, kn)
    yl = torch.gather(yw, -1, k[..., None])[..., 0]
    yr = torch.gather(yw, -1, k[..., None] + 1)[..., 0]
    d = yl - yr
    v = (base - _YAW_WIN + k).to(dtype) + \
        (yl - phi) / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    ok = in_alt & safety & (v >= 0) & (v <= cfg.cols - 1) & torch.isfinite(v)
    return u, v, rng, ok


def reskew_lookup(frame: Frame, u, v):
    """Per-pixel T_Le_Lt at rounded (u, v), falling back to the column's
    first filled pixel where the pixel holds no deskewed point. Returns
    (q, t, ok)."""
    R, C = frame.rng.shape
    ui = _iround(u, R - 1)
    vi = _iround(v, C - 1)
    hit = frame.rs_ok[ui, vi]
    q = torch.where(hit[..., None], frame.q_rs[ui, vi], frame.col_q[vi])
    t = torch.where(hit[..., None], frame.t_rs[ui, vi], frame.col_t[vi])
    return q, t, hit | frame.col_ok[vi]


def project_undistorted(frame: Frame, pts_le, cfg: PhotometricConfig):
    """Project into the scan-end image through the yaw table, look up the
    matched pixel's sampling-time transform, re-skew the point to that time
    and project again. Returns (u, v, rng, ok) of the re-skewed point."""
    u1, v1, _, ok1 = project_yaw(pts_le, frame.yaw, cfg)
    q, t, okT = reskew_lookup(frame, u1, v1)
    # T_Le_Lt maps Lt -> Le; distort back: p_t = R(q)^T (p_le - t)
    p_t = lie.quat_rotate(lie.quat_conj(q), pts_le - t)
    u, v, rng, ok2 = project_yaw(p_t, frame.yaw, cfg)
    return u, v, rng, ok1 & okT & ok2


# ---------------------------------------------------------------------------
# image build + normalization
# ---------------------------------------------------------------------------

def _claim(flat, key, ok, npx, big):
    """(lanes that win their pixel, the per-pixel minimum [npx+1]): the
    smallest ``key`` wins (scatter-min), then the lowest lane among equal
    keys. ``flat`` [N] int64 targets in [0, npx], ``npx`` the write-off
    slot; lanes not ``ok`` leave ``big``."""
    n = flat.shape[0]
    kmin = torch.full((npx + 1,), big, dtype=key.dtype,
                      device=key.device).scatter_reduce(
        0, flat, torch.where(ok, key, big), "amin")
    win = ok & (kmin[flat] == key)
    lane = torch.arange(n, device=flat.device)
    claims = torch.full((npx + 1,), n, dtype=torch.int64,
                        device=flat.device).scatter_reduce(
        0, torch.where(win, flat, npx), lane, "amin")
    return win & (claims[flat] == lane), kmin


def _scatter_set(base, idx, src):
    """base with base[idx] = src, out of place (repeated indices write only
    the write-off row)."""
    return base.index_put((idx,), src)


def build_images(points_le, intensity, valid, cfg: PhotometricConfig):
    """Scatter deskewed points into intensity / range images: nearest
    pixel, the smallest range wins a pixel (the front surface), the lowest
    lane a tie."""
    dtype = points_le.dtype
    R, C = cfg.rows, cfg.cols
    npx = R * C
    u, v, rng, fov = project(points_le, cfg)
    ok = valid & fov & (rng >= cfg.range_min) & (rng <= cfg.range_max)
    ui = _iround(u, R - 1)
    vi = _iround(v, C - 1)
    flat = torch.where(ok, ui * C + vi, npx)
    big = torch.finfo(dtype).max
    winner, rimg = _claim(flat, rng, ok, npx, big)
    iimg = _scatter_set(torch.zeros(npx + 1, dtype=dtype,
                                    device=points_le.device),
                        torch.where(winner, flat, npx), intensity.to(dtype))
    rimg = torch.where(rimg >= big, 0.0, rimg)
    return iimg[:-1].reshape(R, C), rimg[:-1].reshape(R, C)


def _conv2(img, kernel):
    """'same' 2-D correlation of one image with a [1,1,kh,kw] kernel."""
    return F_nn.conv2d(img[None, None], kernel, padding="same")[0, 0]


def _box_blur(img, h, w):
    k = torch.ones((h, w), dtype=img.dtype, device=img.device) / (h * w)
    return _conv2(img, k[None, None])


def normalize_intensity(iimg, valid_mask, cfg: PhotometricConfig):
    """The intensity normalization chain."""
    c = resident(cfg, iimg)
    img = iimg * cfg.intensity_scale
    if cfg.intensity_gamma != 1.0:
        img = torch.pow(torch.clamp(img, min=0.0), cfg.intensity_gamma)
    if cfg.remove_lines:
        lines = _conv2(_conv2(img, c.hp), c.lp)
        # clip negatives after line subtraction
        img = torch.clamp(img - lines, min=0.0)
    if cfg.filter_brightness:
        bw, bh = cfg.brightness_window
        # img = 140 * img / (blur + 1)
        img = 140.0 * img / (_box_blur(img, bh, bw) + 1.0)
    if cfg.gaussian_blur:
        img = _conv2(img, c.gauss)
    img = torch.clamp(img, max=255.0)
    return torch.where(valid_mask, img, 0.0)


@functools.lru_cache(maxsize=None)
def _gradient_kernels(kind, device, dtype):
    """The (kx, ky) correlation kernels [1,1,.,.], cached as
    :func:`_resident`."""
    if kind == "central":
        kx = torch.tensor([[-0.5, 0.0, 0.5]], dtype=dtype, device=device)
    else:
        kx = torch.tensor([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                          dtype=dtype, device=device)
    return kx[None, None], kx.T.contiguous()[None, None]


def sobel(img, kind="sobel3"):
    """(gx, gy): the 3x3 Sobel, or with ``kind="central"`` the central
    difference [-0.5, 0, 0.5]. The kernels are made once per device and
    dtype."""
    kx, ky = _gradient_kernels(kind, img.device, img.dtype)
    return _conv2(img, kx), _conv2(img, ky)


def erode(mask, k):
    """Binary erosion with a (2k+1)^2 structuring element; the border
    counts as valid (a min-pool padded with ones)."""
    m = mask.to(torch.float32)
    out = -F_nn.max_pool2d(-m[None, None], 2 * k + 1, stride=1,
                           padding=k)[0, 0]
    return out > 0.5


def load_static_mask(cfg: PhotometricConfig):
    """The static environment mask (zeros mark always-invalid pixels, e.g.
    the robot frame) as a [R,C] numpy bool array, or None. Accepts .npy
    arrays or any grayscale image PIL can read."""
    if not cfg.static_mask_path:
        return None
    p = cfg.static_mask_path
    if p.endswith(".npy"):
        m = np.load(p)
    else:
        from PIL import Image
        m = np.asarray(Image.open(p).convert("L"))
    if m.shape != (cfg.rows, cfg.cols):
        raise ValueError(f"static mask {m.shape} != image "
                         f"({cfg.rows},{cfg.cols})")
    return m.astype(bool)


def _finish_frame(iimg, rimg, cfg, static_mask):
    vmask = rimg > 0
    inorm = normalize_intensity(iimg, vmask, cfg)
    gx, gy = sobel(inorm, cfg.grad_kernel)
    if static_mask is not None:
        # zeros of the static mask are always invalid, applied before the
        # erosion
        vmask = vmask & static_mask
    k = (cfg.patch_size // 2) + max(cfg.erosion_buffer // 4, 1)
    return inorm, erode(vmask, k), gx, gy


def make_frame(points_le, intensity, valid, cfg: PhotometricConfig,
               static_mask=None, points_raw=None, q_le_lt=None,
               t_le_lt=None) -> Frame:
    """Per-scan frame. Approximate model: images scattered at the ideal
    projection of the deskewed points. With ``cfg.exact_ouster`` (needs
    ``points_raw``, the pre-deskew lidar-frame points in sensor index
    order, and the deskew's per-point T_Le_Lt): the pixel-id fill, the yaw
    table and the re-skew lookup images."""
    if not cfg.exact_ouster:
        iimg, rimg = build_images(points_le, intensity, valid, cfg)
        inorm, mask, gx, gy = _finish_frame(iimg, rimg, cfg, static_mask)
        return Frame(inorm, rimg, mask, gx, gy)

    if points_raw is None or q_le_lt is None or t_le_lt is None:
        raise ValueError("exact_ouster needs points_raw and the per-point "
                         "T_Le_Lt from deskew")
    c = resident(cfg, points_le)
    dtype, dev = points_le.dtype, points_le.device
    R, C = cfg.rows, cfg.cols
    n = points_le.shape[0]
    npx = R * C
    intensity = intensity.to(dtype)
    # the lane index is the sensor pixel id (an organized row-major
    # staggered cloud); lanes past the image go to the write-off pixel
    idx = torch.arange(n, device=dev)
    flat_all = torch.where((idx < npx) & valid,
                           c.dmap[torch.clamp(idx, max=npx - 1)], npx)
    rng_raw = _norm(torch.where(valid[:, None], points_raw, 1.0))
    in_rng = (rng_raw >= cfg.range_min) & (rng_raw <= cfg.range_max)
    flat = torch.where(in_rng, flat_all, npx)
    z1 = torch.zeros(npx + 1, dtype=dtype, device=dev)
    iimg = _scatter_set(z1, flat, intensity)[:-1].reshape(R, C)
    rimg = _scatter_set(z1, flat, rng_raw)[:-1].reshape(R, C)
    p_img = _scatter_set(torch.zeros((npx + 1, 3), dtype=dtype, device=dev),
                         flat, points_le)[:-1].reshape(R, C, 3)

    # yaw table from every raw point (no range gate), holes interpolated
    az = torch.atan2(points_raw[..., 1], points_raw[..., 0])
    yaw_img = _scatter_set(z1, flat_all, az)[:-1]
    yfill = _scatter_set(torch.zeros(npx + 1, dtype=torch.bool, device=dev),
                         flat_all, torch.ones_like(valid))[:-1]
    yaw = fill_row_holes(yaw_img.reshape(R, C), yfill.reshape(R, C), cfg)

    inorm, mask, gx, gy = _finish_frame(iimg, rimg, cfg, static_mask)

    # re-skew lookup: each deskewed point's T_Le_Lt at its scan-end
    # projection pixel, the nearest point winning (the lowest lane a tie)
    uk, vk, _, okp = project_yaw(points_le, yaw, cfg)
    okk = in_rng & okp & valid & (idx < npx)
    flat_k = torch.where(okk, _iround(uk, R - 1) * C + _iround(vk, C - 1),
                         npx)
    winner, _ = _claim(flat_k, rng_raw, okk, npx, torch.finfo(dtype).max)
    wtgt = torch.where(winner, flat_k, npx)
    q_rs = _scatter_set(c.q_id, wtgt, q_le_lt)[:-1].reshape(R, C, 4)
    t_rs = _scatter_set(torch.zeros((npx + 1, 3), dtype=dtype, device=dev),
                        wtgt, t_le_lt)[:-1].reshape(R, C, 3)
    rs_ok = _scatter_set(torch.zeros(npx + 1, dtype=torch.bool, device=dev),
                         wtgt, torch.ones_like(valid))[:-1].reshape(R, C)

    # column fallback: any point in the same column was sampled at about
    # the same time (the first filled row)
    frow = torch.argmax(rs_ok.to(torch.int32), dim=0)
    cidx = torch.arange(C, device=dev)
    col_ok = torch.any(rs_ok, dim=0)
    return Frame(inorm, rimg, mask, gx, gy, yaw=yaw, p_img=p_img,
                 q_rs=q_rs, t_rs=t_rs, rs_ok=rs_ok,
                 col_q=q_rs[frow, cidx], col_t=t_rs[frow, cidx],
                 col_ok=col_ok)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

class Features(NamedTuple):
    """Fixed-capacity feature store."""

    pts_w: torch.Tensor     # [F, P, 3] patch 3-D points in world frame
    psi: torch.Tensor       # [F, P] NCC embedding of the reference patch
    center_w: torch.Tensor  # [F, 3]
    life: torch.Tensor      # [F] int32 scans since creation (-1 = empty)
    valid: torch.Tensor     # [F] bool


def rotate_offsets(gx, gy, dr, dc):
    """Rotate integer patch offsets so the pattern's axes align with the
    local edge normal / tangent: T = [normal tangent] with
    normal = (-g_y, g_x)/|g|, tangent = (g_x, g_y)/|g| in (x=col, y=row)
    coordinates. Returns continuous (r_row, r_col) offsets; the caller
    rounds.

    gx/gy: [...] gradient components along columns / rows; dr/dc: [P]."""
    n = torch.sqrt(gx * gx + gy * gy) + 1e-6
    nx, ny = -gy / n, gx / n
    tx, ty = gx / n, gy / n
    x = dc.to(nx.dtype)
    y = dr.to(nx.dtype)
    r_c = nx[..., None] * x + tx[..., None] * y
    r_r = ny[..., None] * x + ty[..., None] * y
    return r_r, r_c


def empty_features(cfg: PhotometricConfig, dtype=torch.float32,
                   device=None) -> Features:
    F = cfg.num_features
    P = n_patch_points(cfg)
    f = dict(dtype=dtype, device=device)
    return Features(
        pts_w=torch.zeros((F, P, 3), **f), psi=torch.zeros((F, P), **f),
        center_w=torch.zeros((F, 3), **f),
        life=torch.full((F,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros(F, dtype=torch.bool, device=device),
    )


def get_psi(patch):
    """Zero-mean unit-norm NCC embedding. The norm is eps-regularized (not
    clamped), so its derivative is finite for constant patches."""
    mu = torch.mean(patch, dim=-1, keepdim=True)
    c = patch - mu
    n = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True) + 1e-10)
    return c / n


def bilinear(img, u, v):
    """Bilinear sample of img at fractional (u=row, v=col); columns wrap."""
    R, C = img.shape
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, R - 2)
    v0f = torch.floor(v)
    a = u - u0
    b = v - v0f
    v0 = torch.remainder(v0f.to(torch.int64), C)
    v1 = torch.remainder(v0 + 1, C)
    i00 = img[u0, v0]
    i01 = img[u0, v1]
    i10 = img[u0 + 1, v0]
    i11 = img[u0 + 1, v1]
    return (1 - a) * ((1 - b) * i00 + b * i01) + a * ((1 - b) * i10 + b * i11)


def _max_pool_same(img, r):
    """Max over a (2r+1)^2 window, the border padded with -inf."""
    return F_nn.max_pool2d(img[None, None], 2 * r + 1, stride=1,
                           padding=r)[0, 0]


def detect_features(frame: Frame, feats: Features, q_wl, t_wl,
                    cfg: PhotometricConfig, degen_dirs=None) -> Features:
    """Top up the feature store from the current frame.

    Candidates: gradient magnitude above threshold, away from live
    features, non-max suppressed by nma_radius among eligible pixels only,
    ranked by gradient magnitude or, when ``degen_dirs`` ((dirs [D,3] in
    the lidar frame, mask [D] bool)) marks a degenerate direction, by the
    alignment of their gradient with the image motion along it. New
    features fill empty slots only, in rank order."""
    c = resident(cfg, frame.intensity)
    R, C = frame.intensity.shape
    dev = frame.intensity.device
    F = cfg.num_features
    _, _, ci = patch_layout(cfg)
    P = c.dr.shape[0]
    gmag = torch.sqrt(frame.gx ** 2 + frame.gy ** 2)
    rows = torch.arange(R, device=dev)[:, None].expand(R, C)
    cols = torch.arange(C, device=dev)[None, :].expand(R, C)
    margin_ok = (rows >= cfg.margin) & (rows < R - cfg.margin) & \
                (cols >= cfg.margin) & (cols < C - cfg.margin)
    elig = (gmag >= cfg.gradient_threshold) & frame.mask & margin_ok

    # suppress candidates near live features: scatter the current pixel of
    # each valid feature, dilate by the suppression window
    q_lw_s, t_lw_s = lie.se3_inverse(q_wl, t_wl)
    cen_l = lie.se3_transform(q_lw_s, t_lw_s, feats.center_w)
    if frame.yaw is not None:
        fu, fv, _, ffov = project_yaw(cen_l, frame.yaw, cfg)
    else:
        fu, fv, _, ffov = project(cen_l, cfg)
    f_ok = feats.valid & ffov
    occ = _scatter_set(
        torch.zeros(R * C + 1, dtype=torch.float32, device=dev),
        torch.where(f_ok, _iround(fu, R - 1) * C + _iround(fv, C - 1),
                    R * C),
        torch.ones(F, dtype=torch.float32, device=dev))[:-1].reshape(R, C)
    near_existing = _max_pool_same(occ, cfg.nma_radius) > 0.5
    elig = elig & ~near_existing
    g_el = torch.where(elig, gmag, 0.0)
    local_max = _max_pool_same(g_el, cfg.nma_radius)
    cand = elig & (g_el >= local_max)

    score = torch.where(cand, gmag, -1.0)
    if degen_dirs is not None:
        # degeneracy-aware scoring: |grad . (duv/dp @ d)| for the image
        # motion under a sensor translation along each degenerate
        # direction d, by finite differences
        dirs_l, mask_d = degen_dirs
        dtype = frame.intensity.dtype
        rng_img = torch.clamp(frame.rng, min=1e-3)
        pts_pix = backproject(rows.to(dtype), cols.to(dtype), rng_img, cfg)

        def uv_of(p):
            u, v, _, _ = project(p, cfg)
            return u, v

        eps = 0.05
        u_0, v_0 = uv_of(pts_pix)
        boost = torch.zeros_like(gmag)
        for di in range(dirs_l.shape[0]):
            u_d, v_d = uv_of(pts_pix + eps * dirs_l[di])
            s_d = torch.abs(frame.gy * ((u_d - u_0) / eps)
                            + frame.gx * ((v_d - v_0) / eps))
            boost = boost + torch.where(mask_d[di], s_d, 0.0)
        # when any direction is degenerate, rank by the alignment score;
        # otherwise by the plain gradient
        score = torch.where(cand, torch.where(torch.any(mask_d), boost, gmag),
                            -1.0)
    # top-k with the lower index first among equal scores (lax.top_k)
    flat_score, flat_idx = torch.sort(score.reshape(-1), descending=True,
                                      stable=True)
    flat_score, flat_idx = flat_score[:F], flat_idx[:F]
    cu = flat_idx // C
    cv = flat_idx % C
    good = flat_score > 0

    if cfg.rotate_patch:
        # structure tensor over a patch_size window at each candidate; its
        # dominant eigenvector in closed form, the better-conditioned of
        # the two algebraic expressions per element
        ones = torch.ones((1, 1, cfg.patch_size, cfg.patch_size),
                          dtype=frame.gx.dtype, device=dev)
        sxx = _conv2(frame.gx * frame.gx, ones)[cu, cv]
        syy = _conv2(frame.gy * frame.gy, ones)[cu, cv]
        sxy = _conv2(frame.gx * frame.gy, ones)[cu, cv]
        lam = 0.5 * (sxx + syy) + torch.sqrt(
            0.25 * (sxx - syy) ** 2 + sxy * sxy)
        e1 = torch.stack([sxy, lam - sxx], -1)
        e2 = torch.stack([lam - syy, sxy], -1)
        pick = (_norm(e1) >= _norm(e2))[..., None]
        ev = torch.where(pick, e1, e2)
        r_r, r_c = rotate_offsets(ev[..., 0], ev[..., 1], c.dr, c.dc)
        pu = torch.round(cu[:, None] + r_r).to(torch.int64)     # [F, P]
        pv = torch.round(cv[:, None] + r_c).to(torch.int64)
    else:
        pu = cu[:, None] + c.dr[None, :]
        pv = cv[:, None] + c.dc[None, :]
    pu = torch.clamp(pu, 0, R - 1)
    pv = torch.remainder(pv, C)

    inten = frame.intensity[pu, pv]                        # [F, P]
    rng = frame.rng[pu, pv]
    patch_ok = (rng > 0).all(-1) & good
    psi = get_psi(inten)

    if frame.p_img is not None:
        # exact mode: the actual deskewed 3-D point of each patch pixel
        pts_l = frame.p_img[pu, pv]
    else:
        pts_l = backproject(pu.to(frame.intensity.dtype),
                            pv.to(frame.intensity.dtype), rng, cfg)

    # patch 3-D validity: a compact planar surface patch (normal = the
    # smallest eigenvector of the patch covariance)
    centered = pts_l - torch.mean(pts_l, dim=1, keepdim=True)    # [F,P,3]
    compact = (_norm(centered) <= cfg.max_dist_from_mean).all(-1)
    cov = torch.einsum("fpi,fpj->fij", centered, centered) / P
    _, normal = eigh3.smallest_eigvec3(
        cov + 1e-9 * torch.eye(3, dtype=cov.dtype, device=dev))
    planar = (torch.abs(torch.einsum("fpi,fi->fp", centered, normal))
              <= cfg.max_dist_from_plane).all(-1)
    patch_ok = patch_ok & compact & planar
    pts_w = lie.se3_transform(q_wl, t_wl, pts_l.reshape(-1, 3)).reshape(
        -1, P, 3)
    center_w = pts_w[:, ci, :]

    # fill empty slots with the best new candidates, in order
    empty = ~feats.valid
    slot_rank = torch.cumsum(empty.to(torch.int32), 0) - 1
    cand_rank = torch.cumsum(patch_ok.to(torch.int32), 0) - 1
    take = torch.where(empty, slot_rank, -1)
    # candidate index of rank k (inverse permutation by a stable argsort)
    order = torch.argsort(torch.where(patch_ok, cand_rank, 1 << 30),
                          stable=True)
    n_good = torch.sum(patch_ok.to(torch.int32))
    use = (take >= 0) & (take < n_good)
    sel = torch.where(use, order[torch.clamp(take, 0, F - 1)], 0)

    def gather_new(arr_new, arr_old):
        shape = (-1,) + (1,) * (arr_new.dim() - 1)
        return torch.where(use.reshape(shape), arr_new[sel], arr_old)

    new_valid = feats.valid | use
    return Features(
        pts_w=gather_new(pts_w, feats.pts_w),
        psi=gather_new(psi, feats.psi),
        center_w=gather_new(center_w, feats.center_w),
        life=torch.where(new_valid & ~feats.valid, 0,
                         torch.where(feats.valid, feats.life + 1, -1)
                         ).to(torch.int32),
        valid=new_valid,
    )


# ---------------------------------------------------------------------------
# the factor
# ---------------------------------------------------------------------------

class PhotoResult(NamedTuple):
    H: torch.Tensor              # [6,6]
    b: torch.Tensor              # [6]
    num_tracked: torch.Tensor    # int32 scalar
    status_counts: torch.Tensor  # [PH_NUM_STATUS] int32
    tracked: torch.Tensor        # [F] bool: per-feature tracking success


class PhotoBinaryResult(NamedTuple):
    """Two-key photometric block, tangent layout [xi_a(6), xi_b(6)]."""

    H: torch.Tensor              # [12,12]
    b: torch.Tensor              # [12]
    num_tracked: torch.Tensor
    status_counts: torch.Tensor  # [PH_NUM_STATUS]
    tracked: torch.Tensor        # [F] bool


def _patch_factor(frame: Frame, pts, psi_ref, valid_f, to_lidar, n_tan,
                  cfg: PhotometricConfig):
    """The NCC patch factor of F features with P patch points each, whose
    points ``to_lidar(xi, pts)`` puts into ``frame``'s lidar frame at the
    tangent ``xi`` [n_tan]. Returns (H, b, used [F], status [F]).

    The Jacobian is one forward-mode ``jacfwd`` of the batched residual
    [F, P] with respect to the shared tangent."""
    dtype = frame.intensity.dtype
    c = resident(cfg, frame.intensity)
    # empty slots hold zeros; atan2(0, 0) has a NaN derivative and 0 * NaN
    # would poison the masked sums, so invalid slots take a benign point
    pts = torch.where(valid_f[:, None, None], pts, c.fallback)

    def residual(xi):
        p = to_lidar(xi, pts)
        if frame.yaw is not None:
            # exact sampling model: re-skew to the matched pixel's sampling
            # time + yaw-table projection
            u, v, rng, fov = project_undistorted(frame, p, cfg)
        else:
            u, v, rng, fov = project(p, cfg)
        psi_cur = get_psi(bilinear(frame.intensity, u, v))
        r = psi_cur - psi_ref
        return r, (r, psi_cur, u, v, rng, fov)

    xi0 = torch.zeros(n_tan, dtype=dtype, device=pts.device)
    J, (r, psi_cur, u, v, rng, fov) = torch.func.jacfwd(
        residual, has_aux=True)(xi0)                         # J [F, P, n]

    # gates: the margin and the eroded mask gate the patch center only;
    # every patch pixel must lie in the image, in range and unoccluded
    _, _, ctr = patch_layout(cfg)
    ui = _iround(u, cfg.rows - 1)
    vi = _iround(v, cfg.cols - 1)
    in_img = fov & (u >= 0) & (u <= cfg.rows - 1)
    center_ok = (u[:, ctr] >= cfg.margin) & (u[:, ctr] < cfg.rows - cfg.margin)
    in_rng = (rng >= cfg.range_min) & (rng <= cfg.range_max)
    masked_c = frame.mask[ui[:, ctr], vi[:, ctr]]
    img_rng = frame.rng[ui, vi]
    not_occl = torch.abs(img_rng - rng) <= cfg.occlusion_range_diff * rng
    pix_ok = (in_img & in_rng & not_occl).all(-1)
    all_ok = valid_f & pix_ok & center_ok & masked_c

    # NCC gate: correlation of the current patch with the reference
    ncc_ok = torch.sum(psi_cur * psi_ref, dim=-1) > 0.5
    use = all_ok & ncc_ok

    err = _norm(r)
    # robust weight on the whitened residual norm (the squared sqrt-weight,
    # as it scales J^T J directly)
    we = err / cfg.sigma
    d = cfg.huber_delta
    if not cfg.use_robust:
        w_rob = torch.ones_like(err)
    elif cfg.robust == "gemanmcclure":
        w_rob = (d * d / (d * d + we * we)) ** 2
    else:
        w_rob = torch.where(we <= d, 1.0, d / torch.clamp(we, min=1e-9))
    w = torch.where(use & (err <= cfg.max_error), w_rob, 0.0) / \
        (cfg.sigma ** 2)
    Jt = J.transpose(-1, -2)
    H = torch.sum((Jt @ J) * w[:, None, None], dim=0)
    b = torch.sum((Jt @ r[..., None])[..., 0] * w[:, None], dim=0)
    pix_all = (in_img & in_rng).all(-1)
    status = torch.where(
        ~valid_f, PH_OOB,
        torch.where(~(pix_ok & masked_c),
                    torch.where(~pix_all, PH_OOB,
                                torch.where(~masked_c, PH_MASKED,
                                            PH_OCCLUDED)),
                    torch.where(~ncc_ok, PH_NCC, PH_OK)))
    return H, b, use, status


def _status_counts(status, valid_f):
    codes = torch.arange(PH_NUM_STATUS, device=status.device)
    return ((status[None, :] == codes[:, None]) & valid_f[None, :]).sum(
        -1).to(torch.int32)


def linearize(frame: Frame, feats: Features, q_wl, t_wl,
              cfg: PhotometricConfig, degen_proj=None) -> PhotoResult:
    """The unary photometric patch factor on the scan-end pose.

    q_wl/t_wl: the current world->lidar pose (T_W_L). degen_proj: an
    optional [6,6] projector restricting the factor to
    geometric-degenerate directions."""

    def to_lidar(xi, pts):
        # right-perturb the world->lidar pose
        q2, t2 = lie.se3_retract(q_wl, t_wl, xi)
        qi, ti = lie.se3_inverse(q2, t2)
        return lie.se3_transform(qi, ti, pts)

    H, b, used, status = _patch_factor(frame, feats.pts_w, feats.psi,
                                       feats.valid, to_lidar, 6, cfg)
    if degen_proj is not None:
        H = degen_proj @ H @ degen_proj.T
        b = degen_proj @ b
    return PhotoResult(H, b, torch.sum(used.to(torch.int32)).to(torch.int32),
                       _status_counts(status, feats.valid), used)


def linearize_binary(frame_b: Frame, pts_a, psi_ref, valid_f,
                     q_wl_a, t_wl_a, q_wl_b, t_wl_b,
                     cfg: PhotometricConfig) -> PhotoBinaryResult:
    """Binary scan-to-scan photometric factor: patches anchored in frame a
    (patch 3-D points ``pts_a`` [F,P,3] in a's scan-end lidar frame)
    projected into frame b's intensity image, constraining both
    world->lidar poses. The gates are the unary set evaluated in frame b,
    with no degeneracy restriction. The residual depends on the relative
    pose only, so a common rigid motion of both states lies in H's null
    space."""

    def to_lidar(xi, pts):
        qa, ta = lie.se3_retract(q_wl_a, t_wl_a, xi[:6])
        qb, tb = lie.se3_retract(q_wl_b, t_wl_b, xi[6:])
        qbi, tbi = lie.se3_inverse(qb, tb)
        qd, td = lie.se3_compose(qbi, tbi, qa, ta)
        return lie.se3_transform(qd, td, pts)

    H, b, used, status = _patch_factor(frame_b, pts_a, psi_ref, valid_f,
                                       to_lidar, 12, cfg)
    return PhotoBinaryResult(H, b,
                             torch.sum(used.to(torch.int32)).to(torch.int32),
                             _status_counts(status, valid_f), used)


def update_lifecycle(feats: Features, tracked, cfg: PhotometricConfig
                     ) -> Features:
    """Kill lost and expired features; survivors keep their age."""
    alive = feats.valid & tracked & (feats.life < cfg.max_feature_life)
    return feats._replace(valid=alive,
                          life=torch.where(alive, feats.life, -1))
