"""Streaming export: banded readback overlapped with incremental PNG encode.

Covers the native band-incremental writer (imgio.native.PngStreamWriter),
the overlap pipeline (runtime.export.stream_to_png) for host and device
canvases, and the api.stitch_to_file(stream=...) front door — including its
fallbacks.  The monolithic encoder is the byte-level referee: libpng with the
same compression level must produce pixel-identical files.
"""

import os

import numpy as np
import pytest

from imagestitching import api
from imagestitching.config import MemoryBudget, RuntimeConfig
from imagestitching.imgio import codec, native
from imagestitching.runtime import export

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native codec unavailable")

rng = np.random.default_rng(42)


def _canvas(h=300, w=217):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


# ---------------------------------------------------------------- writer

@needs_native
def test_stream_writer_roundtrip_arbitrary_bands(tmp_path):
    arr = _canvas()
    p = str(tmp_path / "s.png")
    with native.PngStreamWriter(p, 217, 300, compression=6) as w:
        w.write(arr[:1])
        w.write(arr[1:128])
        w.write(arr[128:300])
    back, _ = codec.decode(open(p, "rb").read())
    np.testing.assert_array_equal(back, arr)
    # pixel-identical to the monolithic single-thread encoder (deflate bytes
    # may differ: the stream uses the adaptive zlib path, the monolithic one
    # libdeflate — both are ordinary zlib streams to any reader)
    mono, _ = codec.decode(native.encode_png(arr, compression=6, threads=1))
    np.testing.assert_array_equal(back, mono)


@needs_native
def test_stream_writer_matches_monolith_bytes_zlib_mode(tmp_path):
    """With the fast paths disabled both forms run libpng with the fixed Up
    filter and must agree byte-for-byte."""
    arr = _canvas()
    p = str(tmp_path / "z.png")
    os.environ["ISX_PNG_FAST"] = "0"
    try:
        with native.PngStreamWriter(p, 217, 300, compression=6) as w:
            w.write(arr[:100])
            w.write(arr[100:300])
        assert open(p, "rb").read() == native.encode_png(
            arr, compression=6, threads=1)
    finally:
        del os.environ["ISX_PNG_FAST"]


@needs_native
def test_stream_writer_adapts_per_band(tmp_path):
    """Incompressible bands go out as stored blocks (ratio ~1), compressible
    bands keep real compression — within one valid zlib stream."""
    noise = rng.integers(0, 256, (256, 400, 3), np.uint8)
    flat = np.full((256, 400, 3), 37, np.uint8)
    arr = np.concatenate([noise, flat], axis=0)
    p = str(tmp_path / "a.png")
    with native.PngStreamWriter(p, 400, 512, compression=6) as w:
        w.write(arr[:256])
        w.write(arr[256:])
    size = os.path.getsize(p)
    # noise half stays ~its raw size; flat half nearly vanishes
    assert noise.nbytes * 0.95 < size < noise.nbytes * 1.1
    back, _ = codec.decode(open(p, "rb").read())
    np.testing.assert_array_equal(back, arr)


@needs_native
def test_stream_writer_validates(tmp_path):
    p = str(tmp_path / "s.png")
    w = native.PngStreamWriter(p, 64, 32)
    with pytest.raises(ValueError, match="band shape"):
        w.write(np.zeros((4, 63, 3), np.uint8))
    with pytest.raises(ValueError, match="more rows"):
        w.write(np.zeros((33, 64, 3), np.uint8))
    w.write(np.zeros((30, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="before all rows"):
        w.close()
    # closed now; further writes rejected
    with pytest.raises(ValueError, match="closed"):
        w.write(np.zeros((2, 64, 3), np.uint8))


@needs_native
def test_stream_writer_abort_on_exception(tmp_path):
    p = str(tmp_path / "s.png")
    with pytest.raises(RuntimeError, match="boom"):
        with native.PngStreamWriter(p, 64, 32) as w:
            w.write(np.zeros((4, 64, 3), np.uint8))
            raise RuntimeError("boom")
    # handle freed; partial file left for the caller
    assert w._handle is None
    assert os.path.exists(p)


# ---------------------------------------------------------------- pipeline

@needs_native
def test_stream_to_png_host_and_device_match(tmp_path):
    import jax.numpy as jnp

    arr = _canvas(500, 301)
    p_host = str(tmp_path / "h.png")
    p_dev = str(tmp_path / "d.png")
    ph1 = export.stream_to_png(arr, p_host, band_rows=128)
    ph2 = export.stream_to_png(jnp.asarray(arr), p_dev, band_rows=128)
    assert not ph1["overlapped"] and ph2["overlapped"]
    assert ph2["readback_s"] > 0
    b1, _ = codec.decode(open(p_host, "rb").read())
    b2, _ = codec.decode(open(p_dev, "rb").read())
    np.testing.assert_array_equal(b1, arr)
    np.testing.assert_array_equal(b2, arr)


@needs_native
def test_stream_to_png_tail_band_not_multiple(tmp_path):
    import jax.numpy as jnp

    # 130 rows with 64-row bands: tail band is clamped + trimmed
    arr = _canvas(130, 257)
    p = str(tmp_path / "t.png")
    export.stream_to_png(jnp.asarray(arr), p, band_rows=64)
    back, _ = codec.decode(open(p, "rb").read())
    np.testing.assert_array_equal(back, arr)


@needs_native
def test_stream_to_png_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="3-channel"):
        export.stream_to_png(np.zeros((8, 8, 1), np.uint8),
                             str(tmp_path / "g.png"))
    assert not os.path.exists(tmp_path / "g.png")


# ---------------------------------------------------------------- api

def _sources(tmp_path, n=3):
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
            for w, h in [(300, 200), (250, 320), (300, 200)][:n]]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    return imgs, paths


@needs_native
def test_stitch_to_file_stream_matches_monolithic(tmp_path):
    _, paths = _sources(tmp_path)
    p1, m1 = api.stitch_to_file(paths, str(tmp_path / "s.png"), gap=4,
                                return_metrics=True)
    p2 = api.stitch_to_file(paths, str(tmp_path / "m.png"), gap=4,
                            stream=False)
    a1, _ = codec.decode(open(p1, "rb").read())
    a2, _ = codec.decode(open(p2, "rb").read())
    np.testing.assert_array_equal(a1, a2)
    assert m1.export_s > 0 and m1.encode_s > 0


@needs_native
def test_stitch_to_file_stream_overlapped_big_task(tmp_path):
    # >=7 images routes through run_overlapped(keep_on_device=True)
    imgs, paths = _sources(tmp_path)
    paths = paths * 3
    p, m = api.stitch_to_file(paths, str(tmp_path / "o.png"), gap=2,
                              return_metrics=True)
    assert m.strategy.startswith("overlapped")
    got, _ = codec.decode(open(p, "rb").read())
    from imagestitching.config import StitchOptions
    from imagestitching.core import oracle
    from imagestitching.core.layout import ImageSpec, solve
    plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs * 3],
                 StitchOptions(gap=2))
    want = oracle.stitch(plan, imgs * 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@needs_native
def test_stitch_to_file_stream_banded_strategy_host_canvas(tmp_path):
    # a tiny budget forces banded compositing -> host canvas -> the
    # streaming writer still consumes it (no device readback)
    _, paths = _sources(tmp_path)
    cfg = RuntimeConfig(budget=MemoryBudget(hbm_bytes=256 << 10))
    p, m = api.stitch_to_file(paths, str(tmp_path / "b.png"), gap=4,
                              config=cfg, return_metrics=True)
    assert m.strategy == "banded"
    a1, _ = codec.decode(open(p, "rb").read())
    p2 = api.stitch_to_file(paths, str(tmp_path / "b2.png"), gap=4,
                            stream=False)
    a2, _ = codec.decode(open(p2, "rb").read())
    np.testing.assert_array_equal(a1, a2)


def test_stitch_to_file_stream_rejects_unstreamable_format(tmp_path):
    _, paths = _sources(tmp_path, 2)
    with pytest.raises(ValueError, match="streaming encoder"):
        api.stitch_to_file(paths, str(tmp_path / "x.webp"), stream=True)


def test_stitch_to_file_validates_arguments(tmp_path):
    _, paths = _sources(tmp_path, 2)
    with pytest.raises(ValueError, match="stream must be"):
        api.stitch_to_file(paths, str(tmp_path / "x.png"), stream="Auto")
    with pytest.raises(TypeError, match="keep_on_device"):
        api.stitch_to_file(paths, str(tmp_path / "x.png"),
                           keep_on_device=True)


@needs_native
def test_stitch_to_file_stream_true_rejects_grayscale(tmp_path):
    gray = [(rng.integers(0, 256, (40, 30), np.uint8), 1) for _ in range(2)]
    with pytest.raises(ValueError, match="RGB"):
        api.stitch_to_file(gray, str(tmp_path / "g.png"), stream=True)


@needs_native
def test_jpeg_stream_matches_monolithic(tmp_path):
    arr = _canvas(200, 160)
    p = str(tmp_path / "s.jpg")
    with native.JpegStreamWriter(p, 160, 200, quality=92) as w:
        w.write(arr[:77])
        w.write(arr[77:])
    assert open(p, "rb").read() == native.encode_jpeg(arr, quality=92)


@needs_native
def test_stitch_to_file_stream_jpeg(tmp_path):
    _, paths = _sources(tmp_path)
    p1, m1 = api.stitch_to_file(paths, str(tmp_path / "s.jpg"), gap=4,
                                quality=90, return_metrics=True)
    p2 = api.stitch_to_file(paths, str(tmp_path / "m.jpg"), gap=4,
                            quality=90, stream=False)
    assert m1.export_s > 0
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_stitch_to_file_native_fallback(tmp_path, monkeypatch):
    # native codec "missing": stream='auto' silently takes the monolithic
    # path (export is an optimization, never a requirement)
    _, paths = _sources(tmp_path, 2)
    monkeypatch.setattr(api, "_native_available", lambda: False)
    p = api.stitch_to_file(paths, str(tmp_path / "f.png"), gap=1)
    a1, _ = codec.decode(open(p, "rb").read())
    p2 = api.stitch_to_file(paths, str(tmp_path / "f2.png"), gap=1,
                            stream=False)
    a2, _ = codec.decode(open(p2, "rb").read())
    np.testing.assert_array_equal(a1, a2)


def test_keep_on_device_returns_jax_array(tmp_path):
    imgs, _ = _sources(tmp_path, 2)
    out = api.stitch_arrays(imgs[:2], keep_on_device=True)
    assert type(out).__module__.startswith("jax") or isinstance(
        out, np.ndarray)  # banded fallback may return numpy
    full = api.stitch_arrays(imgs[:2])
    np.testing.assert_array_equal(np.asarray(out), full)


@needs_native
def test_stream_to_png_fuzz_geometry(tmp_path):
    """Random canvas sizes x band sizes, host and device: always lossless."""
    import jax.numpy as jnp

    for trial in range(8):
        h = int(rng.integers(1, 400))
        w = int(rng.integers(1, 300))
        band = int(rng.integers(1, h + 32))
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        p = str(tmp_path / f"f{trial}.png")
        canvas = jnp.asarray(arr) if trial % 2 else arr
        export.stream_to_png(canvas, p, band_rows=band)
        back, _ = codec.decode(open(p, "rb").read())
        assert np.array_equal(back, arr), (h, w, band, trial)


@needs_native
def test_stitch_to_file_grayscale_falls_back(tmp_path):
    imgs = [rng.integers(0, 256, (40, 30), np.uint8) for _ in range(2)]
    p = api.stitch_to_file([(a, 1) for a in imgs], str(tmp_path / "g.png"))
    back = np.asarray(__import__("PIL.Image", fromlist=["open"]).open(p))
    assert back.shape[0] > 40


# ------------------------------------------------------- pure-blit export

def _oracle_file_check(paths_or_items, out_png, specs, opts, atol=0):
    from imagestitching.core import oracle
    from imagestitching.core.layout import solve
    plan = solve(specs, opts)
    imgs = []
    for it in paths_or_items:
        if isinstance(it, tuple):
            imgs.append(np.asarray(it[0]))
        elif isinstance(it, np.ndarray):
            imgs.append(it)
        else:
            imgs.append(codec.decode(open(it, "rb").read())[0])
    want = oracle.stitch(plan, imgs)
    got, _ = codec.decode(open(out_png, "rb").read())
    assert np.abs(got.astype(int) - want.astype(int)).max() <= atol
    return want


@needs_native
def test_blit_stream_equal_sizes_vertical(tmp_path):
    """Equal-size concat takes the zero-device-round-trip path, bit-exact."""
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec
    imgs = [rng.integers(0, 256, (120, 200, 3), np.uint8) for _ in range(4)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    p, m = api.stitch_to_file(paths, str(tmp_path / "v.png"), gap=7,
                              return_metrics=True)
    assert m.strategy == "host-blit-stream"
    assert m.compute_s == 0 and m.readback_s == 0
    _oracle_file_check(paths, p, [ImageSpec(200, 120) for _ in imgs],
                       StitchOptions(gap=7), atol=0)


@needs_native
def test_blit_stream_original_mode_offsets_background(tmp_path):
    """mode=original centers narrower images: col offsets + background
    margins, still a pure blit."""
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec
    imgs = [rng.integers(0, 256, (60, 200, 3), np.uint8),
            rng.integers(0, 256, (80, 120, 3), np.uint8)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    opts = StitchOptions(mode="original", gap=3,
                         background=(10, 200, 30))
    p, m = api.stitch_to_file(paths, str(tmp_path / "o.png"),
                              options=opts, return_metrics=True)
    assert m.strategy == "host-blit-stream"
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    _oracle_file_check(paths, p, specs, opts, atol=0)


@needs_native
def test_blit_stream_exif_orientation(tmp_path):
    """EXIF-rotated equal-display-size images still blit (orient_array on
    host), matching the oracle exactly."""
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec
    a = rng.integers(0, 256, (90, 140, 3), np.uint8)   # displays as 90x140
    b = rng.integers(0, 256, (140, 90, 3), np.uint8)   # rot90 -> 90x140
    items = [(a, 1), (b, 6)]
    opts = StitchOptions(mode="original", gap=2)
    p, m = api.stitch_to_file(items, str(tmp_path / "e.png"),
                              options=opts, return_metrics=True)
    assert m.strategy == "host-blit-stream"
    specs = [ImageSpec(140, 90, 1), ImageSpec(90, 140, 6)]
    _oracle_file_check(items, p, specs, opts, atol=0)


@needs_native
def test_blit_stream_horizontal(tmp_path):
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec
    imgs = [rng.integers(0, 256, (150, 90, 3), np.uint8) for _ in range(3)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    opts = StitchOptions(direction="horizontal", gap=4)
    p, m = api.stitch_to_file(paths, str(tmp_path / "h.png"),
                              options=opts, return_metrics=True)
    assert m.strategy == "host-blit-stream"
    specs = [ImageSpec(90, 150) for _ in imgs]
    _oracle_file_check(paths, p, specs, opts, atol=0)


@needs_native
def test_blit_stream_jpeg_extension(tmp_path):
    imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(2)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    p, m = api.stitch_to_file(paths, str(tmp_path / "j.jpg"), gap=2,
                              return_metrics=True)
    assert m.strategy == "host-blit-stream"
    got, _ = codec.decode(open(p, "rb").read())
    assert got.shape == (m.canvas_h, m.canvas_w, 3)


@needs_native
def test_blit_stream_skipped_for_resample_jobs(tmp_path):
    """Mixed sizes (mode=min rescales) must run the device pipeline."""
    _, paths = _sources(tmp_path)
    _, m = api.stitch_to_file(paths, str(tmp_path / "r.png"), gap=4,
                              return_metrics=True)
    assert m.strategy != "host-blit-stream"


@needs_native
def test_blit_stream_skipped_for_on_error_skip(tmp_path):
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    _, m = api.stitch_to_file(paths, str(tmp_path / "s.png"),
                              on_error="skip", return_metrics=True)
    assert m.strategy != "host-blit-stream"


@needs_native
def test_blit_stream_decode_failure_cleans_up(tmp_path):
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    # corrupt the SECOND file's pixel data after its header: probing (header
    # read) succeeds, decode fails mid-export
    raw = bytearray(open(paths[1], "rb").read())
    raw[40:] = b"\0" * (len(raw) - 40)
    open(paths[1], "wb").write(bytes(raw))
    out = str(tmp_path / "fail.png")
    with pytest.raises(Exception):
        api.stitch_to_file(paths, out)
    assert not os.path.exists(out)


@needs_native
def test_blit_stream_skipped_for_overlap_never(tmp_path):
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = [codec.encode(str(tmp_path / f"{i}.png"), a)
             for i, a in enumerate(imgs)]
    cfg = RuntimeConfig(overlap="never")
    _, m = api.stitch_to_file(paths, str(tmp_path / "n.png"), config=cfg,
                              return_metrics=True)
    assert m.strategy != "host-blit-stream"


@needs_native
def test_blit_stream_zero_area_corrupt_image_still_raises(tmp_path):
    """An image whose placement scales to zero area is never drawn, but a
    corrupt file there must still fail the job (device-path contract)."""
    wide = rng.integers(0, 256, (1, 1000, 3), np.uint8)   # scales to 0 rows
    tall = rng.integers(0, 256, (50, 50, 3), np.uint8)
    p_wide = codec.encode(str(tmp_path / "w.png"), wide)
    p_tall = codec.encode(str(tmp_path / "t.png"), tall)
    raw = bytearray(open(p_wide, "rb").read())
    raw[40:] = b"\0" * (len(raw) - 40)   # header probe ok, decode fails
    open(p_wide, "wb").write(bytes(raw))
    out = str(tmp_path / "z.png")
    with pytest.raises(Exception):
        api.stitch_to_file([p_tall, p_wide], out, mode="min")
    assert not os.path.exists(out)
