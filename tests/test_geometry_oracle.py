"""Geometry + oracle unit tests (SURVEY.md §4(1))."""

import numpy as np
import pytest

from imagestitching.config import StitchOptions
from imagestitching.core import geometry, oracle
from imagestitching.core.layout import ImageSpec, solve

rng = np.random.default_rng(0)


# ---------------------------------------------------------------- orientation

def test_display_size():
    assert geometry.display_size(40, 30, 1) == (40, 30)
    for o in (5, 6, 7, 8):
        assert geometry.display_size(40, 30, o) == (30, 40)


def test_orient_array_shapes_and_roundtrip_semantics():
    img = rng.integers(0, 255, (3, 5, 3), np.uint8)  # H=3, W=5
    for o in range(1, 9):
        out = geometry.orient_array(img, o)
        if o in geometry.TRANSPOSED_ORIENTATIONS:
            assert out.shape == (5, 3, 3)
        else:
            assert out.shape == (3, 5, 3)


def test_orient_matches_reference_affine_inverse():
    """Cross-check the swizzle table against the canvas transform stack of
    utils/canvas.js:160-197, evaluated as an inverse affine map per pixel.

    Orientation 7 is excluded: the reference's case 7 places the quad above
    the dest rect (documented upstream bug); we implement standard EXIF 7.
    """
    sh, sw = 4, 6  # raw size
    img = rng.integers(0, 255, (sh, sw), np.int64)

    def reference_display(o):
        # display dims
        dw, dh = geometry.display_size(sw, sh, o)
        disp = np.zeros((dh, dw), np.int64)
        for Y in range(dh):
            for X in range(dw):
                u, v = X + 0.5, Y + 0.5  # dest coords (dx=dy=0)
                if o == 1:
                    lu, lv, W, H = u, v, dw, dh
                elif o == 2:
                    lu, lv, W, H = dw - u, v, dw, dh
                elif o == 3:
                    lu, lv, W, H = dw - u, dh - v, dw, dh
                elif o == 4:
                    lu, lv, W, H = u, dh - v, dw, dh
                elif o == 5:
                    # p = T(R(S(l))) with S=scale(1,-1), R=rot(pi/2), T=translate(dx,dy)
                    # p = (lv, lu)  => lu = Y+0.5? inverse: lu = v? see geometry.py
                    lu, lv, W, H = v, u, dh, dw
                elif o == 6:
                    lu, lv, W, H = v, dw - u, dh, dw
                elif o == 8:
                    lu, lv, W, H = dh - v, u, dh, dw
                else:
                    raise AssertionError
                # nearest-neighbour sample of raw at (lu/W*sw, lv/H*sh)
                sx = min(sw - 1, int(lu / W * sw))
                sy = min(sh - 1, int(lv / H * sh))
                disp[Y, X] = img[sy, sx]
        return disp

    for o in (1, 2, 3, 4, 5, 6, 8):
        got = geometry.orient_array(img, o)
        want = reference_display(o)
        np.testing.assert_array_equal(got, want, err_msg=f"orientation {o}")


def test_orientation7_is_transverse():
    img = np.arange(6).reshape(2, 3)
    got = geometry.orient_array(img, 7)
    want = np.transpose(img)[::-1, ::-1]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- spans/coords

def test_pixel_span_integer_rect():
    assert geometry.pixel_span(0.0, 10.0) == (0, 10)
    assert geometry.pixel_span(3.0, 4.0) == (3, 7)


def test_pixel_span_fractional_rect():
    # rect [0.4, 5.4): pixel 0 center 0.5 inside; pixel 5 center 5.5 outside
    assert geometry.pixel_span(0.4, 5.0) == (0, 5)
    # rect [0.6, 5.6): pixel 0 center 0.5 outside; pixel 5 center 5.5 inside
    assert geometry.pixel_span(0.6, 5.0) == (1, 6)


def test_clipped_pixel_span():
    assert geometry.clipped_pixel_span(-2.0, 5.0, 10) == (0, 3)
    assert geometry.clipped_pixel_span(8.0, 5.0, 10) == (8, 10)
    lo, hi = geometry.clipped_pixel_span(20.0, 5.0, 10)
    assert hi <= 10 or lo >= hi  # fully off-canvas -> empty span


def test_source_coords_identity():
    # identity map: n dest pixels over [0, n) from m=n sources -> s = X
    s = geometry.source_coords(np.arange(5), 0.0, 5.0, 5)
    np.testing.assert_allclose(s, np.arange(5, dtype=np.float64))


# ---------------------------------------------------------------- filters

def test_bilinear_matrix_identity():
    w = geometry.filter_matrix(0, 7, 0.0, 7.0, 7)
    np.testing.assert_allclose(w, np.eye(7, dtype=np.float32), atol=1e-7)


def test_bilinear_matrix_rows_sum_to_one():
    for (n, m) in [(10, 3), (3, 10), (7, 7), (1, 5), (5, 1)]:
        for kind in ("bilinear", "triangle", "box"):
            w = geometry.filter_matrix(0, n, 0.0, float(n), m, kind=kind)
            np.testing.assert_allclose(w.sum(1), np.ones(n), atol=1e-6)


def test_bilinear_matrix_matches_taps():
    n, m = 13, 29
    a, L = 2.25, 11.5
    w = geometry.filter_matrix(3, 3 + n, a, L, m, dtype=np.float64)
    i0, i1, w1 = geometry.bilinear_taps(3, 3 + n, a, L, m)
    src = rng.standard_normal((m,))
    via_matrix = w @ src
    via_taps = src[i0] * (1 - w1) + src[i1] * w1
    np.testing.assert_allclose(via_matrix, via_taps, atol=1e-12)


def test_source_band_covers_taps():
    n, m = 64, 200
    a, L = 5.7, 48.3
    lo, hi = geometry.source_band(0, n, a, L, m)
    i0, i1, _ = geometry.bilinear_taps(0, n, a, L, m)
    assert lo <= i0.min() and hi > i1.max()


def test_source_band_adjacent_tiles_tile_the_source():
    m = 1000
    a, L = 0.0, 500.0
    prev_hi = None
    for t0 in range(0, 500, 100):
        lo, hi = geometry.source_band(t0, t0 + 100, a, L, m)
        i0, i1, _ = geometry.bilinear_taps(t0, t0 + 100, a, L, m)
        assert lo <= i0.min() and hi > i1.max()
        if prev_hi is not None:
            assert lo <= prev_hi  # bands overlap or abut; no gaps
        prev_hi = hi


# ---------------------------------------------------------------- oracle

def _plan(specs, **kw):
    kw.setdefault("supersample", False)
    return solve(specs, StitchOptions(**kw))


def test_oracle_identity_single_image():
    img = rng.integers(0, 255, (32, 48, 3), np.uint8)
    plan = _plan([ImageSpec(48, 32)])
    out = oracle.stitch(plan, [img])
    np.testing.assert_array_equal(out, img)


def test_oracle_two_image_concat_identity_sizes():
    a = rng.integers(0, 255, (16, 32, 3), np.uint8)
    b = rng.integers(0, 255, (24, 32, 3), np.uint8)
    plan = _plan([ImageSpec(32, 16), ImageSpec(32, 24)])
    out = oracle.stitch(plan, [a, b])
    assert out.shape == (40, 32, 3)
    np.testing.assert_array_equal(out[:16], a)
    np.testing.assert_array_equal(out[16:], b)


def test_oracle_gap_is_background():
    a = np.zeros((8, 8, 3), np.uint8)
    b = np.zeros((8, 8, 3), np.uint8)
    plan = _plan([ImageSpec(8, 8), ImageSpec(8, 8)], gap=4)
    out = oracle.stitch(plan, [a, b])
    assert out.shape == (20, 8, 3)
    np.testing.assert_array_equal(out[8:12], np.full((4, 8, 3), 255, np.uint8))


def test_oracle_resize_halves_constant_image():
    img = np.full((16, 64, 3), 100, np.uint8)
    small = np.full((16, 32, 3), 200, np.uint8)
    plan = _plan([ImageSpec(64, 16), ImageSpec(32, 16)], mode="min")
    out = oracle.stitch(plan, [img, small])
    assert plan.out_w == 32
    # constant images stay constant under any linear filter with unit row sums
    np.testing.assert_array_equal(out[:8], np.full((8, 32, 3), 100))
    np.testing.assert_array_equal(out[8:], np.full((16, 32, 3), 200))


def test_oracle_bilinear_exact_2x_upscale_1d_ramp():
    # one row, two pixels [0, 100] upscaled to 4: centers at s = -0.25,0.25,.75,1.25
    img = np.array([[[0], [100]]], np.uint8).astype(np.uint8)
    plan = _plan([ImageSpec(2, 1), ImageSpec(4, 1)], mode="max", gap=0)
    out = oracle.stitch(plan, [img, np.zeros((1, 4, 1), np.uint8)])
    row = out[0, :, 0].astype(float)
    np.testing.assert_allclose(row, [0, 25, 75, 100])


def test_oracle_orientation6_rotates():
    # raw 2x4 (H=2,W=4); orientation 6 -> display 2x4 -> (W=2,H=4)
    raw = np.arange(8, dtype=np.uint8).reshape(2, 4, 1)
    plan = _plan([ImageSpec(4, 2, orientation=6)])
    out = oracle.stitch(plan, [raw])
    assert out.shape == (4, 2, 1)
    want = geometry.orient_array(raw, 6)
    np.testing.assert_array_equal(out, want)


def test_oracle_mixed_orientations_and_aspects():
    specs = [ImageSpec(40, 30, orientation=o) for o in (1, 3, 6, 8)]
    imgs = [rng.integers(0, 255, (30, 40, 3), np.uint8) for _ in specs]
    plan = _plan(specs, direction="horizontal", mode="min", gap=2)
    out = oracle.stitch(plan, imgs)
    assert out.shape == (plan.canvas_h, plan.canvas_w, 3)
    assert plan.out_h == 30  # min height among displays (30,30,40,40 -> 30)


def test_to_uint8_rounding():
    x = np.array([-1.0, 0.49, 0.5, 254.49, 254.5, 300.0])
    np.testing.assert_array_equal(oracle.to_uint8(x),
                                  np.array([0, 0, 1, 254, 255, 255], np.uint8))


def test_stitch_rows_matches_full():
    specs = [ImageSpec(40, 30, orientation=6), ImageSpec(30, 40),
             ImageSpec(35, 25)]
    imgs = [rng.integers(0, 255, (30, 40, 3), np.uint8),
            rng.integers(0, 255, (40, 30, 3), np.uint8),
            rng.integers(0, 255, (25, 35, 3), np.uint8)]
    plan = _plan(specs, gap=3)
    full = oracle.stitch(plan, imgs)
    for lo, hi in [(0, 16), (10, 50), (plan.canvas_h - 7, plan.canvas_h),
                   (0, plan.canvas_h)]:
        band = oracle.stitch_rows(plan, imgs, lo, hi)
        np.testing.assert_array_equal(band, full[lo:hi])
