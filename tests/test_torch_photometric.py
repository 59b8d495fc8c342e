"""The port's photometric module (PG-LIO) against the JAX package.

* constants, configuration and layouts equal;
* function by function on the same seeded numpy f32 inputs: projection,
  image build, normalization (line removal and brightness flattening on
  and off), gradients, erosion, both frame models, feature detection (with
  and without degenerate directions and rotated patches, with live
  features, and a tie that pins the top-k order), the unary and binary
  factors and the lifecycle. Each function gets identical inputs, so a
  last-bit difference upstream cannot flip a float threshold downstream;
* the photometric scan step from a JAX state carried across
  (``mimosa_tpu_torch.convert``), and a short room replay's ATE pair.

The JAX functions run jitted with 64-bit types off, as the JAX package
runs in production (the test session turns them on, which would widen
``backproject``'s altitude table to f64).

Tolerances: masks, indices, statuses, counts, lives and validity flags
exact; projected pixel coordinates within 1e-4 px; images within 1e-3 on
the 0-255 intensity scale (the convolutions sum in another order); H and b
within rtol 2e-4 of their largest entry, the gate of the ICP tests; patch
points within 1e-5 m and psi within 1e-5 where the inputs are identical.
The carried scan step: window and trajectory within 1e-4 as in
tests/test_torch_slice.py, the feature store's points within 1e-4 m and
psi within 1e-5, validity, lives and debug slots 12-15 exact.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu.graph import window as jwin
from mimosa_tpu.lidar import geometric as jgeo
from mimosa_tpu.lidar import photometric as jph
from mimosa_tpu.mapping import voxel_hash as jvh
from mimosa_tpu_torch import convert
from mimosa_tpu_torch.core import lie as tlie
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.graph import window as twin
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.io import synthetic_replay as trep
from mimosa_tpu_torch.lidar import geometric as tgeo
from mimosa_tpu_torch.lidar import photometric as tph
from mimosa_tpu_torch.mapping import voxel_hash as tvh

from torch_fixtures import build_once, one_thread_then_free_programs  # noqa: F401


PX_TOL = 1e-4        # projected pixel coordinates [px]
IMG_TOL = 1e-3       # images on the 0-255 scale
LIN_RTOL = 2e-4      # H and b, of their largest entry
PT_TOL = 1e-5        # patch points [m] and psi from identical inputs

# the small configuration of tests/test_photometric.py, with the FIR line
# removal and brightness flattening left at their defaults (on)
BASE = dict(rows=32, cols=256, range_min=0.5, range_max=50.0,
            gradient_threshold=2.0, nma_radius=3, num_features=40, margin=4,
            intensity_scale=1.0)


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    return jph.PhotometricConfig(**kw), tph.PhotometricConfig(**kw)


_JITS = {}


def _jax(fn, *args, static=(), **kw):
    """``fn`` jitted (``static`` argument indices), run with 64-bit types
    off."""
    key = (fn, static)
    if key not in _JITS:
        _JITS[key] = jax.jit(fn, static_argnums=static)
    with jax.enable_x64(False):
        return _JITS[key](*args, **kw)


def _np(x):
    return None if x is None else np.asarray(x)


def _t(x):
    """A JAX value (or NamedTuple of them) as torch, the same bits."""
    if x is None:
        return None
    if type(x) is tuple:
        return tuple(_t(v) for v in x)
    if isinstance(x, tuple):
        return type(x)(*[_t(v) for v in x])
    return torch.from_numpy(np.array(x))


def _close(out, ref, rtol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def textured_scene(seed, n=40000):
    """Points on four textured walls around the sensor (lidar frame), with a
    smooth intensity texture, f32 (tests/test_photometric.py's scene)."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis, val in [(0, 6.0), (1, 5.0), (0, -6.0), (1, -5.0)]:
        p = rng.uniform(-7, 7, size=(n // 4, 3))
        p[:, 2] = rng.uniform(-2.5, 2.5, size=n // 4)
        p[:, axis] = val
        pts.append(p)
    pts = np.concatenate(pts)
    inten = (120 + 60 * np.sin(2.0 * pts[:, 0]) * np.cos(1.5 * pts[:, 1])
             + 40 * np.sin(3.0 * pts[:, 2]))
    valid = rng.uniform(size=len(pts)) > 0.02
    return (pts.astype(np.float32), np.clip(inten, 0, 255).astype(np.float32),
            valid)


def organized_scan(rows, cols, seed=0):
    """An organized room scan (lane = row-major sensor pixel id) from the
    synthetic generator, plus a deskew-like per-point transform T_Le_Lt
    that grows with the column (the sampling time), for the exact model:
    (points_le, intensity, valid, points_raw, q_le_lt, t_le_lt), f32."""
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=1.5), tsyn.LidarModel(n_rows=rows, n_cols=cols), seed=seed)
    sc = data["scans"][-1]
    raw = np.nan_to_num(sc["points"]).astype(np.float32)
    frac = (np.arange(rows * cols) % cols) / cols
    rv = np.stack([0.01 * frac, -0.02 * frac, 0.15 * frac], -1)
    q = np.asarray(tlie.exp_so3(torch.tensor(rv, dtype=torch.float32)))
    t = (np.stack([0.3, -0.1, 0.02]) * frac[:, None]).astype(np.float32)
    le = np.asarray(tlie.se3_transform(torch.tensor(q), torch.tensor(t),
                                       torch.tensor(raw)))
    return (le, sc["intensity"].astype(np.float32), sc["valid"], raw, q, t)


def _exact_cfgs(rows=16, cols=256, **kw):
    lm = tsyn.LidarModel(n_rows=rows, n_cols=cols)
    shifts = tuple(int(s) for s in
                   np.random.default_rng(7).integers(-12, 13, rows))
    return _cfgs(rows=rows, cols=cols, fov_up=lm.fov_up,
                 fov_down=lm.fov_down, exact_ouster=True,
                 pixel_shift_by_row=shifts, beam_offset_m=0.015,
                 nma_radius=3, margin=3, **kw)


# --------------------------------------------------------------- constants

def test_constants_and_layouts_match():
    for k in ("PH_OK", "PH_OOB", "PH_RANGE", "PH_MASKED", "PH_OCCLUDED",
              "PH_NCC", "PH_NUM_STATUS", "_HP_FIR", "_LP_FIR", "_YAW_WIN"):
        assert getattr(tph, k) == getattr(jph, k), k
    assert tseq.PH_SUM_SLOTS == jseq.PH_SUM_SLOTS
    assert [(f.name, f.default) for f in
            dataclasses.fields(tph.PhotometricConfig)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jph.PhotometricConfig)]
    for kw in (dict(), dict(beam_altitudes=(0.2, 0.05, -0.1, -0.3)),
               dict(rows=4, fov_up=-0.3, fov_down=0.25)):
        jc, tc = _cfgs(**kw)
        np.testing.assert_allclose(
            tph.altitudes(tc).numpy(),
            np.asarray(jph.altitudes(jc), np.float32), rtol=1e-7)
    for kw in (dict(), dict(patch_offsets=((0, 0), (1, 0), (-1, 0), (0, 1),
                                           (0, -1), (2, 2))),
               dict(patch_size=3)):
        jc, tc = _cfgs(**kw)
        for a, b in zip(tph.patch_layout(tc), jph.patch_layout(jc)):
            np.testing.assert_array_equal(a, b)
        assert tph.n_patch_points(tc) == jph.n_patch_points(jc)
    jc, tc = _exact_cfgs()
    np.testing.assert_array_equal(tph.destagger_flat_map(tc).numpy(),
                                  np.asarray(jph.destagger_flat_map(jc)))


# -------------------------------------------------------------- projection

@pytest.mark.parametrize("rows,cols", [(16, 256), (32, 256)])
def test_project_and_backproject_match(rows, cols):
    jc, tc = _cfgs(rows=rows, cols=cols)
    pts, _, _ = textured_scene(1, 4000)
    ju, jv, jr, jf = _jax(jph.project, pts, jc, static=(1,))
    tu, tv, tr, tf = tph.project(torch.from_numpy(pts), tc)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.asarray(jf).mean() > 0.3
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=PX_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=PX_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    # the inverse, from identical (u, v, range)
    jb = _jax(jph.backproject, ju, jv, jr, jc, static=(3,))
    tb = tph.backproject(_t(ju), _t(jv), _t(jr), tc)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)


def test_project_yaw_and_undistorted_match():
    jc, tc = _exact_cfgs()
    le, inten, valid, raw, q, t = organized_scan(16, 256)
    jfr = _jax(jph.make_frame, le, inten, valid, jc, None, raw, q, t,
               static=(3,))
    tfr = _t(jfr)
    ju, jv, jr, jok = _jax(jph.project_yaw, le, jfr.yaw, jc, static=(2,))
    tu, tv, tr, tok = tph.project_yaw(torch.from_numpy(le), tfr.yaw, tc)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert np.asarray(jok).mean() > 0.5
    ok = np.asarray(jok)
    np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok],
                               atol=PX_TOL)
    np.testing.assert_allclose(tv.numpy()[ok], np.asarray(jv)[ok],
                               atol=PX_TOL)
    ju, jv, jr, jok = _jax(jph.project_undistorted, jfr, le, jc,
                           static=(2,))
    tu, tv, tr, tok = tph.project_undistorted(tfr, torch.from_numpy(le), tc)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok],
                               atol=PX_TOL)
    np.testing.assert_allclose(tv.numpy()[ok], np.asarray(jv)[ok],
                               atol=PX_TOL)


# ------------------------------------------------------------- image build

def test_build_images_match():
    jc, tc = _cfgs()
    pts, inten, valid = textured_scene(2)
    ji, jr = _jax(jph.build_images, pts, inten, valid, jc, static=(3,))
    ti, tr = tph.build_images(torch.from_numpy(pts),
                              torch.from_numpy(inten),
                              torch.from_numpy(valid), tc)
    assert (np.asarray(jr) > 0).mean() > 0.3
    np.testing.assert_array_equal(tr.numpy() > 0, np.asarray(jr) > 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


@pytest.mark.parametrize("remove_lines", [True, False])
@pytest.mark.parametrize("filter_brightness", [True, False])
def test_normalize_intensity_matches(remove_lines, filter_brightness):
    jc, tc = _cfgs(remove_lines=remove_lines,
                   filter_brightness=filter_brightness,
                   intensity_scale=0.7, intensity_gamma=1.2)
    pts, inten, valid = textured_scene(3)
    # the image build does not read the normalization settings
    iimg, rimg = _jax(jph.build_images, pts, inten, valid, _cfgs()[0],
                      static=(3,))
    vmask = np.asarray(rimg) > 0
    out_j = _jax(jph.normalize_intensity, iimg, vmask, jc, static=(2,))
    out_t = tph.normalize_intensity(_t(iimg), torch.from_numpy(vmask), tc)
    assert np.asarray(out_j).max() > 50.0
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=IMG_TOL)


@pytest.mark.parametrize("kind", ["sobel3", "central"])
def test_sobel_and_erode_match(kind):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, size=(32, 256)).astype(np.float32)
    gx_j, gy_j = _jax(jph.sobel, img, kind, static=(1,))
    gx_t, gy_t = tph.sobel(torch.from_numpy(img), kind)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=IMG_TOL)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), atol=IMG_TOL)
    mask = rng.uniform(size=(32, 256)) > 0.1
    mask[:, :40] = True                  # a solid block that survives
    for k in (1, 4):
        out = tph.erode(torch.from_numpy(mask), k).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(_jax(jph.erode, mask, k, static=(1,))))
    assert out.sum() > 0


@pytest.mark.parametrize("model", ["approximate", "approximate_masked",
                                   "exact"])
def test_make_frame_matches(model):
    if model == "exact":
        jc, tc = _exact_cfgs()
        le, inten, valid, raw, q, t = organized_scan(16, 256)
        args = (le, inten, valid, jc, None, raw, q, t)
    else:
        jc, tc = _cfgs()
        le, inten, valid = textured_scene(5)
        smask = None
        if model == "approximate_masked":
            smask = np.ones((32, 256), bool)
            smask[:, 100:140] = False
        args = (le, inten, valid, jc, smask)
    jfr = _jax(jph.make_frame, *args, static=(3,))
    targs = [a if isinstance(a, jph.PhotometricConfig) else
             None if a is None else torch.from_numpy(np.asarray(a))
             for a in args]
    targs[3] = tc
    tfr = tph.make_frame(*targs)
    for name in tph.Frame._fields:
        a, b = getattr(tfr, name), _np(getattr(jfr, name))
        if b is None:
            assert a is None, name
            continue
        a = a.numpy()
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name in ("intensity", "gx", "gy"):
            np.testing.assert_allclose(a, b, atol=IMG_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert np.asarray(jfr.mask).mean() > 0.1


# ------------------------------------------------------------------- frames

@pytest.fixture(scope="module")
def scene_frames():
    """JAX frames (both models) of seeded scenes, with features detected
    at the identity pose: the identical inputs of the factor tests."""
    out = {}
    jc, tc = _cfgs()
    pts, inten, valid = textured_scene(6)
    jfr = _jax(jph.make_frame, pts, inten, valid, jc, static=(3,))
    out["approximate"] = (jc, tc, jfr)
    jc, tc = _exact_cfgs()
    le, inten, valid, raw, q, t = organized_scan(16, 256)
    jfr = _jax(jph.make_frame, le, inten, valid, jc, None, raw, q, t,
               static=(3,))
    out["exact"] = (jc, tc, jfr)
    return out


def _pose(rv, t):
    q = np.asarray(tlie.exp_so3(torch.tensor(rv, dtype=torch.float32)))
    return q, np.asarray(t, np.float32)


def _assert_features_equal(tf, jf, tol=PT_TOL):
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.life.numpy(), np.asarray(jf.life))
    for name in ("pts_w", "psi", "center_w"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), atol=tol,
                                   err_msg=name)


DETECT_CASES = {
    "plain": dict(),
    "degenerate": dict(degen=True),
    "rotated": dict(rotate_patch=True),
    "degenerate_rotated": dict(degen=True, rotate_patch=True),
    "not_degenerate": dict(degen="none"),
    "exact": dict(model="exact"),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_features_matches(scene_frames, case):
    kw = dict(DETECT_CASES[case])
    model = kw.pop("model", "approximate")
    degen = kw.pop("degen", False)
    jc, tc, jfr = scene_frames[model]
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    tfr = _t(jfr)
    q, t = _pose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    dd = None
    if degen:
        # lidar-frame directions; one flagged degenerate (or none)
        dirs = np.asarray(tlie.quat_rotate(
            torch.from_numpy(_pose([0.1, -0.2, 0.3], [0, 0, 0])[0]).expand(
                3, 4), torch.eye(3)))
        mask = np.array([False, False, False]) if degen == "none" \
            else np.array([False, True, False])
        dd = (dirs, mask)
    feats0 = jph.empty_features(jc, jnp.float32)
    jf = _jax(jph.detect_features, jfr, feats0, q, t, jc, dd, static=(4,))
    tf = tph.detect_features(tfr, _t(feats0), torch.from_numpy(q),
                             torch.from_numpy(t), tc, degen_dirs=_t(dd))
    assert np.asarray(jf.valid).sum() > 10
    _assert_features_equal(tf, jf)

    # with live features: keep every other slot, move the pose, top up
    keep = np.asarray(jf.valid).copy()
    keep[1::2] = False
    live = jf._replace(valid=jnp.asarray(keep),
                       life=jnp.where(jnp.asarray(keep), jf.life, -1))
    q2, t2 = _pose([0.0, 0.0, 0.02], [0.05, -0.03, 0.0])
    jf2 = _jax(jph.detect_features, jfr, live, q2, t2, jc, dd, static=(4,))
    tf2 = tph.detect_features(tfr, _t(live), torch.from_numpy(q2),
                              torch.from_numpy(t2), tc, degen_dirs=_t(dd))
    assert (np.asarray(jf2.valid) & ~keep).any()
    _assert_features_equal(tf2, jf2)


def test_detect_features_tie_takes_lower_index_first():
    """93 candidates with equal gradient magnitude for 40 slots: both
    packages take the 40 lowest pixel indices, in index order (lax.top_k's
    rule on ties)."""
    jc, tc = _cfgs()
    R, C = 32, 256
    rows, cols = np.mgrid[0:R, 0:C]
    peak = (rows % 8 == 4) & (cols % 8 == 4)
    gx = np.where(peak, 10.0, 1.0).astype(np.float32)
    gy = np.zeros((R, C), np.float32)
    inten = (100 + 50 * np.sin(0.7 * cols) * np.cos(0.9 * rows)).astype(
        np.float32)
    rng = np.full((R, C), 5.0, np.float32)
    mask = np.ones((R, C), bool)
    jfr = jph.Frame(*map(jnp.asarray, (inten, rng, mask, gx, gy)))
    q, t = _pose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    feats0 = jph.empty_features(jc, jnp.float32)
    jf = _jax(jph.detect_features, jfr, feats0, q, t, jc, static=(4,))
    tf = tph.detect_features(_t(jfr), _t(feats0), torch.from_numpy(q),
                             torch.from_numpy(t), tc)
    _assert_features_equal(tf, jf)
    assert tf.valid.all()
    # the centers, back in the image, are the first 40 peaks in row-major
    # order inside the margin
    u, v, _, _ = tph.project(tf.center_w, tc)
    got = (torch.round(u) * C + torch.round(v)).to(torch.int64).tolist()
    ok = peak & (rows >= 4) & (rows < R - 4) & (cols >= 4) & (cols < C - 4)
    assert got == np.flatnonzero(ok.reshape(-1))[:40].tolist()


# ------------------------------------------------------------------ factors

def _features(scene_frames, model, kw=None):
    """Features detected at the identity pose in a scene frame, and the
    configurations with the factor settings ``kw`` (which detection does
    not read)."""
    jc, tc, jfr = scene_frames[model]
    q, t = _pose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    jf = _jax(jph.detect_features, jfr, jph.empty_features(jc, jnp.float32),
              q, t, jc, static=(4,))
    if kw:
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return jc, tc, jfr, jf


LIN_CASES = {
    "huber": dict(),
    "gemanmcclure": dict(robust="gemanmcclure", huber_delta=0.2),
    "no_robust": dict(use_robust=False),
    "degen_proj": dict(proj=True),
    "exact": dict(model="exact"),
}


@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_linearize_matches(scene_frames, case):
    kw = dict(LIN_CASES[case])
    model = kw.pop("model", "approximate")
    proj = kw.pop("proj", False)
    jc, tc, jfr, jf = _features(scene_frames, model, kw)
    # a perturbed pose: residuals nonzero, most features still tracked
    q, t = _pose([0.002, -0.001, 0.006], [0.02, -0.01, 0.01])
    P = None
    if proj:
        P = np.zeros((6, 6), np.float32)
        P[3, 3] = P[5, 5] = P[1, 1] = 1.0
    jr = _jax(jph.linearize, jfr, jf, q, t, jc, P, static=(4,))
    tr = tph.linearize(_t(jfr), _t(jf), torch.from_numpy(q),
                       torch.from_numpy(t), tc, degen_proj=_t(P))
    n = int(np.asarray(jf.valid).sum())
    assert n > 10 and int(jr.num_tracked) > 0.5 * n
    assert int(tr.num_tracked) == int(jr.num_tracked)
    np.testing.assert_array_equal(tr.status_counts.numpy(),
                                  np.asarray(jr.status_counts))
    np.testing.assert_array_equal(tr.tracked.numpy(), np.asarray(jr.tracked))
    assert tr.status_counts.dtype == torch.int32
    _close(tr.H, jr.H, LIN_RTOL)
    _close(tr.b, jr.b, LIN_RTOL)


def test_linearize_binary_matches(scene_frames):
    """Patches anchored in frame a at the identity pose, seen in the same
    frame from a second pose: the 12-D block, its gates and statuses."""
    jc, tc, jfr, jf = _features(scene_frames, "approximate")
    qa, ta = _pose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    qb, tb = _pose([0.001, 0.0, -0.004], [-0.015, 0.01, 0.0])
    args = (jf.pts_w, jf.psi, jf.valid, qa, ta, qb, tb)
    jr = _jax(jph.linearize_binary, jfr, *args, jc, static=(8,))
    tr = tph.linearize_binary(_t(jfr), *[_t(a) for a in args], tc)
    assert int(jr.num_tracked) > 10
    assert int(tr.num_tracked) == int(jr.num_tracked)
    np.testing.assert_array_equal(tr.status_counts.numpy(),
                                  np.asarray(jr.status_counts))
    np.testing.assert_array_equal(tr.tracked.numpy(), np.asarray(jr.tracked))
    assert tr.H.shape == (12, 12)
    _close(tr.H, jr.H, LIN_RTOL)
    _close(tr.b, jr.b, LIN_RTOL)


def test_update_lifecycle_matches():
    jc, tc = _cfgs(max_feature_life=5)
    rng = np.random.default_rng(8)
    F = jc.num_features
    feats = jph.empty_features(jc, jnp.float32)._replace(
        valid=jnp.asarray(rng.uniform(size=F) > 0.3),
        life=jnp.asarray(rng.integers(-1, 8, F), jnp.int32))
    tracked = rng.uniform(size=F) > 0.2
    jo = _jax(jph.update_lifecycle, feats, tracked, jc, static=(2,))
    to = tph.update_lifecycle(_t(feats), torch.from_numpy(tracked), tc)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_array_equal(to.life.numpy(), np.asarray(jo.life))
    assert to.life.dtype == torch.int32
    assert 0 < int(to.valid.sum()) < F


# ---------------------------------------------------------------- scan step

LIDAR = dict(n_rows=16, n_cols=256)
# two GN iterations, not the default three: the JAX package unrolls the
# loop, and each iteration's photometric Jacobian adds ~5 s to the step's
# XLA:CPU compile; the code path is the same
SEQ_KW = dict(max_scan_points=4096, n_geo_points=2048, n_map_points=4096,
              geo_leaf=0.4, map_insert_leaf=0.15, keyframe_trans_thresh=0.3,
              keyframe_rot_thresh=0.15, n_gn_iters=2)
WIN_KW = dict(K=4)
MAP_KW = dict(leaf_size=0.4, capacity_log2=14, plane_min_points=5,
              lru_horizon=0)
GEO_KW = dict(sigma=0.05, loc_count_thresh=50.0)
N_CARRY = 5          # add_scan calls before the carried state: init + 4


def _photo_kw():
    return dataclasses.asdict(trep.photo_config(tsyn.LidarModel(**LIDAR)))


def _port_sequencer():
    return tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW),
                          twin.WindowConfig(**WIN_KW),
                          tvh.VoxelMapConfig(**MAP_KW),
                          tgeo.GeometricConfig(**GEO_KW),
                          tph.PhotometricConfig(**_photo_kw()), device="cpu")


def _jax_state(s):
    st = {name: {k: np.asarray(v) for k, v in getattr(s, name)._asdict()
                 .items()}
          for name in ("window", "vmap", "preints", "features")}
    st.update({name: np.asarray(getattr(s, name))
               for name in convert.SEQ_ARRAYS})
    st["host"] = {k: copy.deepcopy(getattr(s, k)) for k in convert.SEQ_HOST}
    st["imu"] = dict(ts=s.imu.ts.copy(), acc=s.imu.acc.copy(),
                     gyro=s.imu.gyro.copy())
    return st


@pytest.fixture(scope="module")
def jax_photo_replay(tmp_path_factory):
    """A short noisy 16x256 room replay through the JAX package with the
    photometric factor (the room_photometric settings, int16 codec), with
    its state before and after the (N_CARRY+1)-th scan."""
    return build_once(tmp_path_factory,
                      "test_torch_photometric.jax_photo_replay",
                      _jax_photo_replay)


def _jax_photo_replay():
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=2.0), tsyn.LidarModel(**LIDAR), seed=0, imu_noise=0.01,
        range_noise=0.01)
    snaps = {}
    with jax.enable_x64(False):
        s = jseq.Sequencer(jseq.SequencerConfig(**SEQ_KW),
                           jwin.WindowConfig(**WIN_KW),
                           jvh.VoxelMapConfig(**MAP_KW),
                           jgeo.GeometricConfig(**GEO_KW),
                           photo_cfg=jph.PhotometricConfig(**_photo_kw()),
                           dtype=jnp.float32)
        imu_i = 0
        for k in range(len(data["scans"])):
            if k == N_CARRY:
                snaps["before"] = (_jax_state(s), imu_i)
            imu_i = trep.feed(s, data, k, imu_i)
            if k == N_CARRY:
                snaps["after"] = _jax_state(s)
        traj = s.trajectory
    return dict(data=data, snaps=snaps, trajectory=traj,
                counters=dict(s.counters))


def test_carried_state_photometric_step_matches_jax(jax_photo_replay):
    """From the JAX state after init + 4 scans (window full, features
    live), one add_scan in each package: the window, the feature store and
    the scan's debug row."""
    data = jax_photo_replay["data"]
    before, imu_i = jax_photo_replay["snaps"]["before"]
    ref = jax_photo_replay["snaps"]["after"]
    assert before["features"]["valid"].sum() > 10
    s = convert.load_sequencer_state(_port_sequencer(), before)
    trep.feed(s, data, N_CARRY, imu_i)
    out = convert.sequencer_state(s)
    assert out["host"] == ref["host"]

    w, wr = out["window"], ref["window"]
    for k in ("q", "p", "v", "g_dir", "bg", "ba", "lin_q", "lin_p"):
        np.testing.assert_allclose(w[k], wr[k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(w["active"], wr["active"])
    _close(w["H_prior"], wr["H_prior"], 1e-2)

    f, fr = out["features"], ref["features"]
    np.testing.assert_array_equal(f["valid"], fr["valid"])
    np.testing.assert_array_equal(f["life"], fr["life"])
    ok = fr["valid"]
    assert ok.sum() > 10
    # world points of the detections hang on the converged pose (1e-4, as
    # the window); psi on the intensity image each package built (1e-5)
    np.testing.assert_allclose(f["pts_w"][ok], fr["pts_w"][ok], atol=1e-4)
    np.testing.assert_allclose(f["center_w"][ok], fr["center_w"][ok],
                               atol=1e-4)
    np.testing.assert_allclose(f["psi"][ok], fr["psi"][ok], atol=1e-5)

    row = out["debug_rec"][N_CARRY - 1]
    rowr = ref["debug_rec"][N_CARRY - 1]
    assert row[12] > 10
    np.testing.assert_array_equal(row[:5], rowr[:5])
    np.testing.assert_array_equal(row[6:17], rowr[6:17])
    _close(row[17:38], rowr[17:38], 1e-3)
    np.testing.assert_allclose(out["traj_p"], ref["traj_p"], atol=1e-4)


def test_short_photometric_replay_ate_matches_jax(jax_photo_replay):
    data = jax_photo_replay["data"]
    s = _port_sequencer()
    trep.replay(s, data)
    assert s.counters == jax_photo_replay["counters"]
    ate_t = trep.trajectory_ate(s, data)
    jt = jax_photo_replay["trajectory"]
    ate_j = tsyn.ate_rmse(np.asarray([t for t, _, _ in jt]),
                          np.asarray([p for _, p, _ in jt]),
                          data["gt"]["ts"], data["gt"]["pos"])
    tracked = s.debug_records()[2:, 12]
    print(f"photometric replay: ATE port {ate_t:.5f} m, JAX {ate_j:.5f} m; "
          f"tracked features {tracked.tolist()}")
    assert (tracked > 0).all()
    assert s.last_photo[0] == int(tracked[-1])
    assert ate_t < 0.08 and ate_j < 0.08
    assert abs(ate_t - ate_j) < 0.005


def _ouster_lane_order(data, lm):
    """The scans with their lanes in an Ouster's pixel-id order: row 0 the
    highest beam, column 0 at azimuth +pi, azimuth falling along the row
    (the generator's lanes run from the lowest beam and azimuth 0 up)."""
    R, C = lm.n_rows, lm.n_cols
    r, c = np.divmod(np.arange(R * C), C)
    order = np.argsort((R - 1 - r) * C + (C // 2 - c) % C)
    keys = ("points", "t_rel", "valid", "intensity")
    return dict(data, scans=[dict(sc, **{k: sc[k][order] for k in keys})
                             for sc in data["scans"]])


def test_exact_ouster_sequencer_tracks_and_refuses_point_skip():
    """The Sequencer's exact-model path (raw points and the deskew's
    per-point T_Le_Lt into the frame build) on a short noisy replay in
    pixel-id lane order: features tracked on every step after the second,
    ATE under room_photometric's gate. It refuses point_skip > 1, and a
    photometric Sequencer refuses a state without a feature store."""
    lm = tsyn.LidarModel(**LIDAR)
    data = _ouster_lane_order(tsyn.generate(
        tsyn.room_world(), tsyn.TrajectoryConfig(t_total=1.8), lm, seed=1,
        imu_noise=0.01, range_noise=0.01), lm)
    cfg = tph.PhotometricConfig(**dict(_photo_kw(), exact_ouster=True))
    with pytest.raises(ValueError, match="point_skip"):
        tseq.Sequencer(tseq.SequencerConfig(point_skip=2), photo_cfg=cfg,
                       device="cpu")
    s = tseq.Sequencer(tseq.SequencerConfig(**SEQ_KW),
                       twin.WindowConfig(**WIN_KW),
                       tvh.VoxelMapConfig(**MAP_KW),
                       tgeo.GeometricConfig(**GEO_KW), cfg, device="cpu")
    trep.replay(s, data)
    tracked = s.debug_records()[2:, 12]
    print(f"exact model: ATE {trep.trajectory_ate(s, data):.5f} m, tracked "
          f"{tracked.tolist()}")
    assert s.scan_idx >= 6 and (tracked > 0).all()
    assert trep.trajectory_ate(s, data) < 0.08
    state = convert.sequencer_state(s)
    del state["features"]
    with pytest.raises(KeyError, match="features"):
        convert.load_sequencer_state(_port_sequencer(), state)
