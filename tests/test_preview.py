"""Preview sizing/draw (reference calcPreviewHeight + preview blit,
utils/canvas.js:124-128, pages/index/index.js:1593-1609)."""

import numpy as np

from imagestitching import api

rng = np.random.default_rng(29)


def test_preview_size_aspect_and_floor():
    # aspect-following height
    assert api.preview_size(400, 200, 100) == (100, 180)  # floored at 180
    assert api.preview_size(400, 1600, 100) == (100, 400)
    # reference floor is 180 px (canvas.js:127)
    assert api.preview_size(1000, 10, 500)[1] == 180


def test_make_preview_downscale():
    img = np.full((400, 800, 3), 77, np.uint8)
    prev = api.make_preview(img, 200)
    assert prev.shape == (180, 200, 3)  # 200*400/800=100 -> floor 180
    np.testing.assert_array_equal(prev, np.full((180, 200, 3), 77))


def test_make_preview_matches_oracle_resample():
    img = rng.integers(0, 256, (64, 128, 3), np.uint8)
    prev = api.make_preview(img, 32, min_height=1)
    assert prev.shape == (16, 32, 3)
    # constant rows stay constant; spot-check separable identity on 2x
    img2 = np.repeat(np.repeat(prev, 2, axis=0), 2, axis=1)
    back = api.make_preview(img2, 32, min_height=1)
    assert np.abs(back.astype(int) - prev.astype(int)).max() <= 1


def test_make_preview_device_matches_host():
    """VERDICT r1 #8: device preview parity vs the float64 host path."""
    img = rng.integers(0, 256, (333, 517, 3), np.uint8)
    dev = api.make_preview(img, 120, device=True)
    host = api.make_preview(img, 120, device=False)
    assert dev.shape == host.shape
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


def test_make_preview_accepts_device_array():
    import jax.numpy as jnp
    img = rng.integers(0, 256, (90, 45, 3), np.uint8)
    dev = api.make_preview(jnp.asarray(img), 30, min_height=1)
    host = api.make_preview(img, 30, min_height=1, device=False)
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


def test_make_preview_degenerate_shapes():
    """1-px sides and upscales through both paths (soak --preview pins)."""
    for h, w in [(1, 37), (37, 1), (1, 1), (3, 500)]:
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        box_w = 12
        pw, ph = api.preview_size(w, h, box_w, min_height=2)
        dev = api.make_preview(img, box_w, min_height=2, device=True)
        host = api.make_preview(img, box_w, min_height=2, device=False)
        assert dev.shape == (ph, pw, 3) == host.shape
        assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


def test_make_preview_upscale_matches_oracle():
    """box_w > source width: the tap builder must upscale cleanly."""
    img = rng.integers(0, 256, (9, 7, 3), np.uint8)
    dev = api.make_preview(img, 50, min_height=1, device=True)
    host = api.make_preview(img, 50, min_height=1, device=False)
    assert dev.shape == host.shape == (round(50 * 9 / 7), 50, 3)
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


def test_preview_size_rounds_half_up():
    """The reference keeps a fractional CSS height (utils/canvas.js:127);
    our integer height rounds half-up like every other layout rounding
    (_js_round) — Python's banker's round() would give 2 here."""
    assert api.preview_size(2, 5, 1, min_height=1) == (1, 3)    # 2.5 -> 3
    assert api.preview_size(4, 10, 1, min_height=1) == (1, 3)   # 2.5 -> 3
    assert api.preview_size(4, 6, 2, min_height=1) == (2, 3)    # 3.0 -> 3
