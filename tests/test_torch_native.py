"""The port's host scan pack and transfer codecs against the JAX package.

* ``mimosa_tpu_torch.native.pack_scan`` / ``pack_range`` (the port's own
  build of the C++ pack) are bit-identical to ``mimosa_tpu.native``'s and
  to the port's numpy twins over a grid of skips, output lengths below and
  above the input's, column counts, dither, f32 and f64 input, NaN and inf
  lanes, and the affine [N,6] beam table;
* the per-lane dither table is bit-identical to the JAX package's;
* each codec's device decode (int16 xyz, int16 range, f32) matches the JAX
  package's on the same packs: validity masks exact, points and times
  within 2 f32 ulps (the two compilers may fuse a multiply and an add
  differently).

(A build that fails raises: ``tests/test_torch_cuda.py``, which runs on
the card's machine too.)
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimosa_tpu import native as jnative
from mimosa_tpu.graph import sequencer as jseq
from mimosa_tpu_torch import native as tnative
from mimosa_tpu_torch.graph import sequencer as tseq
from mimosa_tpu_torch.io import synthetic as tsyn
from mimosa_tpu_torch.lidar import photometric as tph

from torch_fixtures import one_thread_then_free_programs  # noqa: F401

RES = dict(pos=0.0025, rng=0.0015, t=4e-6, inten=0.25)


def _inputs(seed, dtype, n=257):
    """Points with NaN lanes, times with inf lanes, a mask, intensities."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=20.0, size=(n, 3))
    t = rng.uniform(0.0, 0.1, size=n)
    pts[rng.random(n) < 0.1, rng.integers(0, 3)] = np.nan
    t[rng.random(n) < 0.05] = np.inf
    valid = rng.random(n) < 0.9
    inten = rng.uniform(0.0, 300.0, size=n)
    return pts.astype(dtype), t.astype(dtype), valid, inten.astype(dtype)


def _beam(n_out, seed=5):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_out, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    off = rng.normal(scale=0.03, size=(n_out, 3))
    return np.concatenate([dirs, off], -1).astype(np.float32)


def _n_out(n, skip, where):
    """An output length below or above the number of kept lanes."""
    kept = -(-n // skip)
    return kept - 17 if where == "below" else kept + 40


GRID = list(itertools.product((1, 3), ("below", "above"), (False, True),
                              (np.float32, np.float64)))


def _grid_id(case):
    skip, where, dither, dtype = case
    return (f"skip{skip}-{where}-{'dither' if dither else 'plain'}-"
            f"{np.dtype(dtype).name}")


@pytest.mark.parametrize("ncol", [4, 5])
@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_pack_scan_bit_identical(case, ncol):
    skip, where, dither, dtype = case
    pts, t, valid, inten = _inputs(skip + 7 * ncol, dtype)
    args = (pts, t, valid, inten if ncol > 4 else None, skip,
            _n_out(len(pts), skip, where), ncol, RES["pos"], RES["t"],
            RES["inten"])
    out, t_end = tnative.pack_scan(*args, dither=dither)
    ref, t_ref = jnative.pack_scan(*args, dither=dither)
    twin, t_twin = tnative.pack_scan_numpy(*args, dither=dither)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, twin)
    assert t_end == t_ref == t_twin > 0.0
    assert (out[:, 3] == -32768).sum() > 0     # NaN, inf and masked lanes


@pytest.mark.parametrize("ncol,beam", [(2, False), (3, False), (2, True),
                                       (3, True)])
@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_pack_range_bit_identical(case, ncol, beam):
    skip, where, dither, dtype = case
    pts, t, valid, inten = _inputs(skip + 11 * ncol, dtype)
    n_out = _n_out(len(pts), skip, where)
    args = (pts, t, valid, inten if ncol > 2 else None, skip, n_out, ncol,
            RES["rng"], RES["t"], RES["inten"])
    bm = _beam(n_out) if beam else None
    out, t_end = tnative.pack_range(*args, dither=dither, beam=bm)
    ref, t_ref = jnative.pack_range(*args, dither=dither, beam=bm)
    twin, t_twin = tnative.pack_range_numpy(*args, dither=dither, beam=bm)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, twin)
    assert t_end == t_ref == t_twin > 0.0


def test_pack_semantics():
    """t_end over the valid finite lanes of the full input; NaN, masked and
    pad lanes carry the t == -32768 sentinel."""
    pts = np.array([[1.0, 2.0, 3.0], [np.nan, 0.0, 0.0], [0.5, -0.5, 0.25],
                    [4.0, 4.0, 4.0]])
    t = np.array([0.0, 0.01, 0.02, 0.09])
    valid = np.array([True, True, True, False])
    out, t_end = tnative.pack_scan(pts, t, valid, None, 1, 6, 4, 0.01, 2e-6,
                                   0.1, dither=False)
    assert t_end == 0.02
    assert out[0, :3].tolist() == [100, 200, 300]
    assert out[1, 3] == out[3, 3] == -32768
    assert (out[4:, 3] == -32768).all()
    assert out[2, 3] == round(0.02 / 2e-6) - 32767
    # what the C++ would read past: refused before the call
    with pytest.raises(ValueError, match="beam"):
        tnative.pack_range(pts, t, valid, None, 1, 6, 2, 0.01, 2e-6, 0.1,
                           beam=np.zeros((5, 6), np.float32))
    with pytest.raises(ValueError, match="valid"):
        tnative.pack_scan(pts, t, valid[:3], None, 1, 6, 4, 0.01, 2e-6, 0.1)
    with pytest.raises(ValueError, match="columns"):
        tnative.pack_scan(pts, t, valid, None, 1, 6, 3, 0.01, 2e-6, 0.1)


def test_dither_lanes_bit_identical():
    n = 32768
    ref = np.asarray(jseq._dither_lanes(n, np.dtype(np.float32)))
    out = tseq._dither_lanes(n, torch.float32).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    assert out.min() >= -0.5 and out.max() < 0.5


# ------------------------------------------------------------- decode

CODECS = {
    "int16": dict(),
    "int16_plain": dict(quant_dither=False),
    "range": dict(range_transfer=True),
    "range_affine": dict(range_transfer=True),
    "f32": dict(quantize_transfer=False),
}


def _staged_and_decoded(codec, photo):
    """One synthetic scan (16x256 LiDAR, skip 2, padded to 2560 lanes)
    staged by the port (with its intensity column for a photometric
    Sequencer, ``photo``) and decoded by both packages: ((points, times,
    intensity, valid) of the port, the same of JAX)."""
    kw = dict(max_scan_points=2560, point_skip=2, **CODECS[codec])
    lm = tsyn.LidarModel()
    data = tsyn.generate(tsyn.room_world(), tsyn.TrajectoryConfig(
        t_total=1.5), lm, seed=4, range_noise=0.01)
    scan = data["scans"][-1]
    dirs = tsyn.beam_dirs(lm)[0]
    if codec == "range_affine":
        # the affine model p = s * dir + offset, exact for these points
        off = np.random.default_rng(2).normal(scale=0.03, size=dirs.shape)
        dirs = np.concatenate([dirs, off], -1)
        scan = dict(scan, points=(scan["points"] + np.where(
            scan["valid"][:, None], off, 0.0)).astype(np.float32))
    s = tseq.Sequencer(tseq.SequencerConfig(**kw), device="cpu",
                       ray_dirs=dirs if kw.get("range_transfer") else None,
                       photo_cfg=tph.PhotometricConfig(rows=16, cols=256)
                       if photo else None)
    st = s.stage_scan(scan["ts_header"], scan["points"], scan["t_rel"],
                      scan["valid"], intensity=scan["intensity"])
    t_offset = np.float32(0.0371)
    out = tseq._decode_scan(
        st["scan_dev"], st["valid_dev"], torch.tensor(t_offset), s.cfg,
        torch.float32, s._ray_dirs_dev, s._dither_dev)
    ref = jseq._decode_scan(
        jnp.asarray(st["scan_dev"].numpy()),
        None if st["valid_dev"] is None
        else jnp.asarray(st["valid_dev"].numpy()), jnp.float32(t_offset),
        jseq.SequencerConfig(**kw), np.dtype(np.float32),
        None if s._ray_dirs_dev is None
        else jnp.asarray(s._ray_dirs_dev.numpy()))
    return out, ref


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_decode_matches_jax(codec):
    """One synthetic scan staged by the port and decoded by both packages
    (:func:`_staged_and_decoded`); a geometric Sequencer ships no intensity,
    so both decode zeros."""
    (pts, t_pts, inten, valid), (jp, jt, ji, jv) = _staged_and_decoded(
        codec, photo=False)
    np.testing.assert_array_equal(inten.numpy(), np.asarray(ji))
    assert not inten.any()
    assert pts.dtype == t_pts.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert 1000 < int(valid.sum()) < 2560
    np.testing.assert_array_max_ulp(pts.numpy(), np.asarray(jp), maxulp=2)
    np.testing.assert_array_max_ulp(t_pts.numpy(), np.asarray(jt), maxulp=2)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_decode_intensity_matches_jax(codec):
    """A photometric Sequencer's pack carries the intensity column; both
    packages decode the same points, times, intensity and mask."""
    (pts, t_pts, inten, valid), (jp, jt, ji, jv) = _staged_and_decoded(
        codec, photo=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(inten.numpy(), np.asarray(ji))
    assert float(inten.max()) > 50.0
    np.testing.assert_array_max_ulp(pts.numpy(), np.asarray(jp), maxulp=2)
    np.testing.assert_array_max_ulp(t_pts.numpy(), np.asarray(jt), maxulp=2)
