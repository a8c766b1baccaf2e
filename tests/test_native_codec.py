"""Native C++ codec (libjpeg/libpng via ctypes) vs Pillow parity."""

import io

import numpy as np
import pytest
from PIL import Image

from imagestitching.imgio import codec, native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native codec not built")

rng = np.random.default_rng(33)


def test_png_roundtrip_lossless():
    arr = rng.integers(0, 256, (37, 53, 3), np.uint8)
    data = native.encode_png(arr)
    back = native.decode_png(data)
    np.testing.assert_array_equal(back, arr)
    # and PIL can read what we wrote
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil, arr)


def test_png_alpha_composites_like_oracle():
    rgba = np.zeros((5, 5, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[..., 3] = 128
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "PNG")
    out = native.decode_png(buf.getvalue())
    # 200*128/255 + 255*127/255 = 227.39 -> 227 (round-half-up)
    assert out.shape == (5, 5, 3)
    np.testing.assert_array_equal(out[..., 0], np.full((5, 5), 227))
    np.testing.assert_array_equal(out[..., 1], np.full((5, 5), 127))


def test_png_palette_and_gray():
    gray = rng.integers(0, 256, (12, 9), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray, "L").save(buf, "PNG")
    out = native.decode_png(buf.getvalue())
    np.testing.assert_array_equal(out[..., 0], gray)
    np.testing.assert_array_equal(out[..., 1], gray)

    pal = Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).convert(
        "P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    out = native.decode_png(buf.getvalue())
    want = np.asarray(pal.convert("RGB"))
    np.testing.assert_array_equal(out, want)


def _white_composite(im: Image.Image) -> np.ndarray:
    rgba = np.asarray(im.convert("RGBA")).astype(np.uint32)
    a = rgba[..., 3:4]
    return ((2 * (rgba[..., :3] * a + 255 * (255 - a)) + 255)
            // 510).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_fast_decode_color_types(mode):
    """The libdeflate fast decode path is pixel-identical to the libpng
    path (and to Pillow+white-composite) for every 8-bit color type."""
    shape = {"RGB": (41, 29, 3), "RGBA": (41, 29, 4),
             "L": (41, 29), "LA": (41, 29, 2)}[mode]
    arr = rng.integers(0, 256, shape, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    data = buf.getvalue()
    got = native.decode_png(data)
    want = _white_composite(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, want)


def test_png_fast_decode_palette_trns():
    pal = Image.fromarray(rng.integers(0, 256, (16, 11, 3),
                                       np.uint8)).quantize(64)
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=bytes(range(64)))
    data = buf.getvalue()
    got = native.decode_png(data)
    want = _white_composite(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, want)


def _chunk(tag: bytes, body: bytes) -> bytes:
    import struct
    import zlib
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _palette_png(chunk_order) -> bytes:
    """Hand-built 3x2 palette PNG with chunks in the given order."""
    import struct
    import zlib
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 2, 8, 3, 0, 0, 0))
    plte = _chunk(b"PLTE", bytes([250, 10, 10, 10, 250, 10, 10, 10, 250]))
    trns = _chunk(b"tRNS", bytes([100, 200]))
    raw = bytes([0, 0, 1, 2, 0, 2, 1, 0])          # filter 0 + indices
    idat = _chunk(b"IDAT", zlib.compress(raw))
    parts = {"plte": plte, "trns": trns, "idat": idat}
    return (b"\x89PNG\r\n\x1a\n" + ihdr
            + b"".join(parts[k] for k in chunk_order)
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("order", [
    ("plte", "idat", "trns"),          # tRNS after IDAT (fuzz seed 532163)
    ("trns", "plte", "idat"),          # tRNS before PLTE (fuzz seed 534911)
    ("plte", "trns", "trns", "idat"),  # duplicate tRNS
    ("plte", "trns", "idat"),          # valid placement (control)
])
def test_png_fast_out_of_place_trns_matches_libpng(order, monkeypatch):
    """libpng benign-skips out-of-place/duplicate tRNS with a warning; the
    fast path must IGNORE those chunks too, not honor their alpha (r4s7
    codec-fuzz differential, seeds 532163/534911)."""
    data = _palette_png(order)
    fast = native.decode_png(data)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    slow = native.decode_png(data)
    np.testing.assert_array_equal(fast, slow)


def test_png_fast_oversized_trns_matches_libpng(monkeypatch):
    # tRNS longer than the palette: libpng skips it as invalid
    import struct
    import zlib
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 1, 8, 3, 0, 0, 0))
    plte = _chunk(b"PLTE", bytes([9, 9, 9, 200, 200, 200]))
    trns = _chunk(b"tRNS", bytes([10] * 5))        # 5 entries, 2 colors
    idat = _chunk(b"IDAT", zlib.compress(bytes([0, 0, 1])))
    data = (b"\x89PNG\r\n\x1a\n" + ihdr + plte + trns + idat
            + _chunk(b"IEND", b""))
    fast = native.decode_png(data)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    slow = native.decode_png(data)
    np.testing.assert_array_equal(fast, slow)


def test_png_fast_decode_matches_libpng_path(monkeypatch):
    """Force the libpng path via ISX_PNG_FAST=0 and compare."""
    arr = rng.integers(0, 256, (64, 51, 4), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, "PNG")
    fast = native.decode_png(buf.getvalue())
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    slow = native.decode_png(buf.getvalue())
    np.testing.assert_array_equal(fast, slow)


def test_jpeg_decode_matches_pil():
    arr = rng.integers(0, 256, (64, 48, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=92)
    data = buf.getvalue()
    ours = native.decode_jpeg(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.shape == pil.shape
    # same libjpeg under the hood -> identical output expected, allow 1
    assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 1


def test_jpeg_scale_denom():
    arr = rng.integers(0, 256, (256, 320, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    half = native.decode_jpeg(buf.getvalue(), scale_denom=2)
    assert half.shape == (128, 160, 3)
    eighth = native.decode_jpeg(buf.getvalue(), scale_denom=8)
    assert eighth.shape == (32, 40, 3)


def test_jpeg_encode_matches_pil_encoder():
    arr = rng.integers(0, 256, (40, 40, 3), np.uint8)
    data = native.encode_jpeg(arr, quality=95)
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    pil_back = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    # same libjpeg under the hood: the two encoders must agree
    np.testing.assert_array_equal(back, pil_back)


def test_corrupt_inputs_raise():
    with pytest.raises(ValueError, match="decode"):
        native.decode_png(b"\x89PNG\r\n\x1a\n" + b"garbage")
    with pytest.raises(ValueError, match="decode"):
        native.decode_jpeg(b"\xff\xd8garbage")


def test_codec_layer_uses_native(tmp_path):
    # decode through the public codec API (sniff -> native)
    arr = rng.integers(0, 256, (30, 20, 3), np.uint8)
    p = tmp_path / "x.png"
    Image.fromarray(arr).save(p)
    dec, o = codec.decode(p)
    np.testing.assert_array_equal(dec, arr)
    assert o == 1
    # encode through the public codec API
    out = codec.encode(tmp_path / "y.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), arr)


def test_codec_jpeg_exif_still_parsed(tmp_path):
    arr = rng.integers(0, 256, (30, 20, 3), np.uint8)
    img = Image.fromarray(arr)
    ex = img.getexif()
    ex[274] = 6
    p = tmp_path / "r.jpg"
    img.save(p, quality=95, exif=ex)
    dec, o = codec.decode(p)
    assert o == 6 and dec.shape == (30, 20, 3)


def test_png_mt_encoder_lossless_and_pil_readable():
    # pigz-style parallel-strip PNG: independent deflate streams joined by
    # full flushes; must decode bit-exact in any standard reader
    for (w, h) in [(5, 3), (257, 129), (1, 1), (640, 480)]:
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        data = native.encode_png(arr, threads=4)
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(back, arr, err_msg=f"{w}x{h}")
    # single-thread and MT agree on decodability (sizes differ slightly)
    arr = rng.integers(0, 256, (100, 100, 3), np.uint8)
    d1 = native.encode_png(arr, threads=1)
    d4 = native.encode_png(arr, threads=4)
    for d in (d1, d4):
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(d)).convert("RGB")), arr)


def test_png_fast_encode_mixed_content_size(monkeypatch):
    """Mixed flat+noise canvases must not bloat vs libpng (the stored-block
    decision is per-region, not one whole-buffer sample)."""
    flat = np.full((150, 800, 3), 200, np.uint8)
    noisy = rng.integers(0, 256, (60, 800, 3), np.uint8)
    arr = np.concatenate([flat, noisy, flat], axis=0)
    fast = native.encode_png(arr, compression=6)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    slow = native.encode_png(arr, compression=6)
    assert len(fast) <= len(slow) * 1.15, (len(fast), len(slow))
    back = native.decode_png(fast)
    np.testing.assert_array_equal(back, arr)


def test_png_fast_decode_rejects_corrupt_crc():
    """Bit flips inside IDAT must raise like libpng, never decode garbage."""
    good = native.encode_png(rng.integers(0, 256, (64, 64, 3), np.uint8),
                             compression=3)
    bad = bytearray(good)
    bad[80] ^= 0xFF
    with pytest.raises(ValueError):
        native.decode_png(bytes(bad))


def _chunk(tag, data):
    import struct
    import zlib
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def test_png_fast_decode_requires_iend(monkeypatch):
    """A truncated file missing IEND must fail on the fast path exactly as
    the libpng path does (ADVICE r2: it used to decode successfully)."""
    import struct
    import zlib

    h, w = 8, 8
    img = np.arange(h * w * 3, dtype=np.uint8).reshape(h, w, 3)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    base = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)))
    # sanity: WITH IEND both paths decode identically
    ok = base + _chunk(b"IEND", b"")
    fast = native.decode_png(ok)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    np.testing.assert_array_equal(fast, native.decode_png(ok))
    with pytest.raises(ValueError):
        native.decode_png(base)            # libpng: truncated input
    monkeypatch.setenv("ISX_PNG_FAST", "1")
    with pytest.raises(ValueError):
        native.decode_png(base)            # fast path must agree


def test_png_fast_decode_oob_palette_matches_libpng(monkeypatch):
    """Out-of-range palette indices (pal_n=4, indices up to 9) must decode
    identically on both paths — the fast path defers to libpng rather than
    applying its own zero-filled LUT (ADVICE r2)."""
    import struct
    import zlib

    h, w = 8, 8
    pal = bytes([255, 0, 0, 0, 255, 0, 0, 0, 255, 255, 255, 0])
    rows = b"".join(b"\x00" + bytes([(x + y) % 10 for x in range(w)])
                    for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
           + _chunk(b"PLTE", pal)
           + _chunk(b"IDAT", zlib.compress(rows, 6))
           + _chunk(b"IEND", b""))
    fast = native.decode_png(png)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    slow = native.decode_png(png)
    np.testing.assert_array_equal(fast, slow)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_fast_decode_avg_filter(channels):
    """Hand-built all-Average-filter PNG (no common encoder emits avg
    reliably): SIMD (bpp 3/4) and scalar (bpp 1/2) defilters must match
    libpng exactly."""
    import struct
    import zlib

    h, w = 97, 61
    img = rng.integers(0, 256, (h, w, channels), np.uint8)
    stride = w * channels
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(channels, np.int32), row[:-channels]])
        filt = ((row - ((left + prev) >> 1)) & 0xFF).astype(np.uint8)
        raw.append(3)
        raw.extend(filt.tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(bytes(raw), 6))
           + chunk(b"IEND", b""))
    got = native.decode_png(png)
    want = _white_composite(Image.open(io.BytesIO(png)))
    np.testing.assert_array_equal(got, want)
