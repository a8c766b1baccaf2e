"""Input-format coverage: the reference whitelist jpg/jpeg/png/webp/bmp/gif
(pages/index/index.js:4) plus grayscale/palette edge cases."""

import numpy as np
import pytest
from PIL import Image

import imagestitching as ist
from imagestitching.config import RuntimeConfig
from imagestitching.imgio import codec

rng = np.random.default_rng(44)


def arr(w=24, h=16):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("ext,lossless", [
    ("png", True), ("bmp", True), ("webp", False), ("gif", False),
    ("jpg", False),
])
def test_decode_formats(tmp_path, ext, lossless):
    a = arr()
    p = tmp_path / f"x.{ext}"
    img = Image.fromarray(a)
    if ext == "gif":
        img = img.convert("P", palette=Image.ADAPTIVE)
    img.save(p)
    dec, o = codec.decode(p)
    assert o == 1
    assert dec.shape[2] == 3 and dec.dtype == np.uint8
    if lossless:
        np.testing.assert_array_equal(dec, a)
    info = codec.get_image_info(p)
    assert info.supported, f"{info.format} should be whitelisted"


def test_grayscale_png_decodes_to_rgb(tmp_path):
    g = rng.integers(0, 256, (10, 12), np.uint8)
    p = tmp_path / "g.png"
    Image.fromarray(g, "L").save(p)
    dec, _ = codec.decode(p)
    assert dec.shape == (10, 12, 3)
    np.testing.assert_array_equal(dec[..., 0], g)


def test_animated_gif_uses_first_frame(tmp_path):
    frames = [Image.fromarray(np.full((8, 8, 3), v, np.uint8))
              for v in (10, 200)]
    p = tmp_path / "a.gif"
    frames[0].save(p, save_all=True, append_images=frames[1:], duration=100)
    dec, _ = codec.decode(p)
    assert dec.shape == (8, 8, 3)
    assert abs(int(dec[0, 0, 0]) - 10) <= 12  # palette quantization slack


def test_stitch_mixed_formats(tmp_path):
    paths = []
    for ext in ("png", "bmp", "webp"):
        p = tmp_path / f"m.{ext}"
        Image.fromarray(arr(20, 20)).save(p)
        paths.append(p)
    out = ist.stitch(paths, gap=1, config=RuntimeConfig(engine="xla"))
    assert out.shape == (20 * 3 + 2, 20, 3)


def test_16bit_png(tmp_path, monkeypatch):
    """16-bit gray PNG must decode to the HIGH byte (libpng strip_16 /
    browser semantics) on BOTH ladder rungs: Pillow's convert("RGB")
    clamps at 255 instead — everything bright went white until the
    formats soak (seed 110014) caught the fallback diverging from the
    native fast path."""
    a16 = (rng.integers(0, 65536, (6, 6), np.uint64)).astype(np.uint16)
    p = tmp_path / "d.png"
    Image.fromarray(a16, "I;16").save(p)
    want = (a16 >> 8).astype(np.uint8)
    dec, _ = codec.decode(p)            # native fast path (if built)
    assert dec.dtype == np.uint8 and dec.shape == (6, 6, 3)
    np.testing.assert_array_equal(dec[..., 0], want)
    from imagestitching.imgio import native
    monkeypatch.setattr(native, "available", lambda: False)
    dec2, _ = codec.decode(p)           # Pillow fallback rung
    np.testing.assert_array_equal(dec2, dec)
    sal, _ = codec.salvage_decode(str(p))
    np.testing.assert_array_equal(sal, dec)


def test_mode_i_png_dark_takes_high_byte():
    """Older Pillow versions open 16-bit gray PNG as generic mode "I".
    A dark frame (all samples <= 255) must STILL take the high byte:
    PNG has no 32-bit integer mode, so the samples are 16-bit by format,
    and the range-aware pass-through (correct for int32 TIFF) would make
    this rung diverge from libpng strip_16 (the native fast path) on the
    very same file."""
    dark = np.full((4, 4), 200, np.int32)       # high byte 0 -> black
    img = Image.fromarray(dark)                 # mode "I"
    img.format = "PNG"                          # as Pillow's PNG plugin sets
    out = codec._deep_gray_to_rgb(img)
    np.testing.assert_array_equal(out, np.zeros((4, 4, 3), np.uint8))
    img2 = Image.fromarray(dark)                # non-PNG container ("I" TIFF
    assert img2.format is None                  # analog): range pass-through
    out2 = codec._deep_gray_to_rgb(img2)
    np.testing.assert_array_equal(out2[..., 0], np.full((4, 4), 200,
                                                        np.uint8))


def test_mode_i_tiff_range_aware(tmp_path):
    """Generic mode "I" (32-bit container, no defined range): 8-bit-range
    data must pass through — the unconditional >>8 crushed it to black —
    while true 16-bit-range data still takes the high byte."""
    a8 = rng.integers(0, 256, (6, 6)).astype(np.int32)
    p8 = tmp_path / "i8.tif"
    Image.fromarray(a8).save(p8)        # int32 -> mode "I"
    with Image.open(p8) as probe:
        assert probe.mode == "I"        # precondition for the regression
    dec, _ = codec.decode(p8)
    np.testing.assert_array_equal(dec[..., 0], a8.astype(np.uint8))

    a16 = rng.integers(256, 65536, (6, 6)).astype(np.int32)
    p16 = tmp_path / "i16.tif"
    Image.fromarray(a16).save(p16)
    dec16, _ = codec.decode(p16)
    np.testing.assert_array_equal(dec16[..., 0], (a16 >> 8).astype(np.uint8))


def test_transcode_rung_deep_gray(tmp_path):
    """transcode_if_needed (the unknown-extension rung) must share the
    strict rung's conversion semantics: a 16-bit gray TIFF takes the high
    byte instead of convert("RGB")'s clamp-to-white."""
    a16 = np.full((8, 8), 30000, np.uint16)      # high byte 117; clamp = 255
    p = tmp_path / "deep.tif"
    Image.fromarray(a16).save(p)        # uint16 -> mode "I;16"
    out = codec.transcode_if_needed(p, workdir=str(tmp_path))
    assert out != str(p)
    dec, _ = codec.decode(out)
    assert abs(int(dec.mean()) - 117) <= 3       # JPEG q100 4:4:4 slack


def test_salvage_composites_alpha(tmp_path):
    """salvage_decode must composite alpha onto white like decode() (its
    convert("RGB") dropped alpha until the ladder unification)."""
    rgba = np.dstack([np.full((5, 5), 40, np.uint8)] * 3
                     + [np.full((5, 5), 128, np.uint8)])
    p = tmp_path / "a.png"
    Image.fromarray(rgba).save(p)       # (H, W, 4) uint8 -> RGBA
    strict, _ = codec.decode(p)
    sal, _ = codec.salvage_decode(str(p))
    np.testing.assert_array_equal(sal, strict)
    assert int(strict[0, 0, 0]) == 147           # round(40*128/255 + 127)


def test_pipeline_profile_flag(tmp_path, monkeypatch):
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.config import StitchOptions
    from imagestitching.runtime import pipeline
    monkeypatch.setenv("IMAGESTITCH_TRACE_DIR", str(tmp_path / "trace"))
    plan = solve([ImageSpec(16, 16)], StitchOptions(supersample=False))
    imgs = [arr(16, 16)]
    out, m = pipeline.run(plan, imgs,
                          RuntimeConfig(engine="xla", profile=True))
    assert out.shape == (16, 16, 3)
    assert (tmp_path / "trace").exists()


def test_native_webp_matches_pillow(tmp_path):
    """The native webp decoder (codec.cpp + libwebp) must agree with the
    Pillow rung bit-for-bit — lossless, lossy, and alpha-composited — so
    the ladder's answer never depends on which decoder fired."""
    from imagestitching.imgio import native

    if not native.webp_available():
        pytest.skip("native codec built without libwebp")
    rng_ = np.random.default_rng(11)
    base = (np.linspace(0, 255, 40 * 32 * 3).reshape(32, 40, 3)
            + rng_.normal(0, 25, (32, 40, 3))).clip(0, 255).astype(np.uint8)
    import io
    for lossless in (True, False):
        for alpha in (False, True):
            img = Image.fromarray(base)
            if alpha:
                img.putalpha(Image.fromarray(
                    rng_.integers(0, 256, (32, 40), np.uint8)))
            buf = io.BytesIO()
            img.save(buf, "WEBP", lossless=lossless, quality=80)
            data = buf.getvalue()
            nat = native.decode_webp(data)
            assert nat is not None
            got, o = codec.decode(data)       # dispatches to the native path
            np.testing.assert_array_equal(got, nat)
            assert o == 1
            pim = Image.open(io.BytesIO(data))
            if alpha:
                arr = np.asarray(pim.convert("RGBA"), np.float32)
                al = arr[:, :, 3:4] / 255.0
                ref = np.clip(np.floor(arr[:, :, :3] * al
                                       + 255.0 * (1 - al) + 0.5),
                              0, 255).astype(np.uint8)
            else:
                ref = np.asarray(pim.convert("RGB"))
            np.testing.assert_array_equal(
                nat, ref, err_msg=f"lossless={lossless} alpha={alpha}")


def test_animated_webp_falls_back_to_first_frame(tmp_path):
    """The native decoder refuses animation; the ladder must recover via
    Pillow (first frame), mirroring the GIF behavior."""
    from imagestitching.imgio import native

    frames = [Image.fromarray(np.full((8, 8, 3), v, np.uint8))
              for v in (10, 200)]
    p = tmp_path / "anim.webp"
    frames[0].save(p, save_all=True, append_images=frames[1:], duration=100)
    data = p.read_bytes()
    if native.webp_available():
        with pytest.raises(ValueError, match="animated"):
            native.decode_webp(data)
    dec, _ = codec.decode(p)
    assert dec.shape == (8, 8, 3)
    assert abs(int(dec[0, 0, 0]) - 10) <= 2


def test_webp_exif_orientation(tmp_path):
    """EXIF orientation embedded in a webp must surface through the native
    dispatch (header-only Pillow parse), as it does for jpeg."""
    a = arr()
    p = tmp_path / "o.webp"
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(a).save(p, "WEBP", lossless=True, exif=exif)
    dec, o = codec.decode(p)
    assert o == 6
    np.testing.assert_array_equal(dec, a)


def _pil_strict_rgb(data: bytes) -> np.ndarray:
    import io
    with Image.open(io.BytesIO(data)) as img:
        return np.ascontiguousarray(codec._img_to_rgb(img))


def test_native_bmp_matches_pillow():
    """The native BMP decoder (codec.cpp) must agree with the Pillow rung
    bit-for-bit across the shapes it accepts: 24-bit, 8-bit palette,
    8-bit grayscale-palette (Pillow mode L), plus hand-built 32-bit BGRX
    and top-down row order (Pillow never writes those)."""
    import io
    import struct

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")
    rng_ = np.random.default_rng(21)
    a = rng_.integers(0, 256, (13, 21, 3), np.uint8)
    cases = []
    for conv in (None, "P", "L"):
        img = Image.fromarray(a)
        if conv == "P":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=17)
        elif conv == "L":
            img = img.convert("L")
        buf = io.BytesIO()
        img.save(buf, "BMP")
        cases.append((f"pillow-{conv}", buf.getvalue()))

    def make_bmp(arr_, bpp, top_down):
        h, w = arr_.shape[:2]
        stride = ((w * bpp + 31) // 32) * 4
        rows = []
        for y in (range(h) if top_down else range(h - 1, -1, -1)):
            row = bytearray()
            for x in range(w):
                r, g, b = arr_[y, x]
                row += bytes([b, g, r] + ([0] if bpp == 32 else []))
            row += b"\0" * (stride - len(row))
            rows.append(bytes(row))
        pix = b"".join(rows)
        dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h,
                          1, bpp, 0, len(pix), 2835, 2835, 0, 0)
        return struct.pack("<2sIHHI", b"BM", 54 + len(pix), 0, 0, 54) \
            + dib + pix

    for bpp in (24, 32):
        for td in (False, True):
            cases.append((f"manual-{bpp}-{'td' if td else 'bu'}",
                          make_bmp(a, bpp, td)))
    for tag, data in cases:
        nat = native.decode_bmp(data)
        assert nat is not None, tag
        np.testing.assert_array_equal(nat, _pil_strict_rgb(data), err_msg=tag)
        got, o = codec.decode(data)        # dispatches to the native path
        assert o == 1
        np.testing.assert_array_equal(got, nat, err_msg=tag)


def test_native_bmp_rejects_exotic_variants_to_ladder():
    """RLE/16-bit/V4+ BMPs must raise in the native decoder (never return
    wrong pixels) and the ladder must still answer via Pillow."""
    import io
    import struct

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")
    rng_ = np.random.default_rng(22)
    a = rng_.integers(0, 256, (6, 9, 3), np.uint8)

    # 16-bit 555 (Pillow reads it; native must refuse -> Pillow rung)
    h, w = a.shape[:2]
    stride = ((w * 16 + 31) // 32) * 4
    rows = []
    for y in range(h - 1, -1, -1):
        row = bytearray()
        for x in range(w):
            r, g, b = (int(v) for v in a[y, x])
            row += struct.pack("<H",
                               ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3))
        row += b"\0" * (stride - len(row))
        rows.append(bytes(row))
    pix = b"".join(rows)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 0, len(pix),
                      2835, 2835, 0, 0)
    d16 = struct.pack("<2sIHHI", b"BM", 54 + len(pix), 0, 0, 54) + dib + pix
    with pytest.raises(ValueError, match="bit depth"):
        native.decode_bmp(d16)
    got, o = codec.decode(d16)
    assert o == 1
    np.testing.assert_array_equal(got, _pil_strict_rgb(d16))

    # RLE8 compression flag: refuse before touching pixel data
    buf = io.BytesIO()
    Image.fromarray(a).convert("P").save(buf, "BMP")
    rle = bytearray(buf.getvalue())
    rle[30:34] = struct.pack("<I", 1)
    with pytest.raises(ValueError, match="compressed"):
        native.decode_bmp(bytes(rle))


def test_native_gif_matches_pillow():
    """The native GIF decoder must agree with the Pillow rung bit-for-bit:
    plain palettes, small palettes, interlace, GCE transparency (white
    composite), animation (first frame = Pillow's no-seek open), and
    out-of-palette transparent indices."""
    import io

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")
    rng_ = np.random.default_rng(23)
    a = rng_.integers(0, 256, (17, 23, 3), np.uint8)
    cases = []
    for colors in (2, 5, 256):
        img = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE,
                                         colors=colors)
        for interlace in (False, True):
            for trans in (None, 0, 1):
                buf = io.BytesIO()
                kw = {"interlace": interlace}
                if trans is not None:
                    kw["transparency"] = trans
                img.save(buf, "GIF", **kw)
                cases.append((f"c{colors}-il{interlace}-t{trans}",
                              buf.getvalue()))
    # animated: frame 0 must match Pillow's no-seek open
    f0 = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE)
    f1 = Image.fromarray(rng_.integers(0, 256, (17, 23, 3), np.uint8)) \
        .convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    f0.save(buf, "GIF", save_all=True, append_images=[f1], duration=50)
    cases.append(("animated", buf.getvalue()))
    for tag, data in cases:
        nat = native.decode_gif(data)
        assert nat is not None, tag
        np.testing.assert_array_equal(nat, _pil_strict_rgb(data), err_msg=tag)
        got, o = codec.decode(data)        # dispatches to the native path
        assert o == 1
        np.testing.assert_array_equal(got, nat, err_msg=tag)


def test_native_gif_rejects_partial_and_corrupt_to_ladder():
    """Partial first frames and truncated LZW streams must raise (the
    Pillow ladder owns background/disposal semantics and salvage)."""
    import io
    import struct

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")
    rng_ = np.random.default_rng(24)
    a = rng_.integers(0, 256, (9, 11, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).convert("P", palette=Image.ADAPTIVE).save(buf, "GIF")
    g = bytearray(buf.getvalue())
    # walk to the image descriptor (palette bytes can alias 0x2C)
    pos = 13
    if g[10] & 0x80:
        pos += 3 * (2 << (g[10] & 7))
    while g[pos] == 0x21:
        pos += 2
        while g[pos] != 0:
            pos += 1 + g[pos]
        pos += 1
    assert g[pos] == 0x2C
    iw = struct.unpack("<H", bytes(g[pos + 5:pos + 7]))[0]
    g[pos + 5:pos + 7] = struct.pack("<H", iw - 1)
    with pytest.raises(ValueError, match="cover the screen"):
        native.decode_gif(bytes(g))

    whole = buf.getvalue()
    with pytest.raises(ValueError):
        native.decode_gif(whole[:len(whole) // 2])


def test_native_gif_refuses_decompression_bomb():
    """A few-KB GIF declaring a huge logical screen must be refused by the
    native layer (it would expand to ~17 GB of RGB) so the Pillow ladder's
    MAX_IMAGE_PIXELS bomb policy governs, as it did pre-native."""
    import struct

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")
    hdr = (b"GIF89a" + struct.pack("<HH", 65535, 65535)
           + bytes([0x00, 0, 0]))           # no global palette
    with pytest.raises(ValueError, match="pixel limit"):
        native.decode_gif(hdr + b"\x2c" + b"\x00" * 9)


def test_native_decoders_refuse_decompression_bombs(monkeypatch):
    """A few-KB JPEG/PNG/WEBP declaring huge dimensions must be refused by
    the native layer (it would expand to GBs of RGB) so the Pillow ladder's
    MAX_IMAGE_PIXELS bomb policy governs, as it did pre-native.  GIF has
    its own test above."""
    import io
    import struct
    import zlib

    from imagestitching.imgio import native

    if not native.available():
        pytest.skip("native codec unavailable")

    # JPEG: real small file with the SOF0 dimensions patched to 20000x20000
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    j = bytearray(buf.getvalue())
    sof = j.find(b"\xff\xc0")
    assert sof >= 0
    struct.pack_into(">HH", j, sof + 5, 20000, 20000)
    with pytest.raises(ValueError, match="pixel limit"):
        native.decode_jpeg(bytes(j))

    # PNG declaring 20000x20000: valid IHDR CRC so the fast path parses it
    # (rather than deferring to libpng) — then again on the libpng path
    ihdr = b"IHDR" + struct.pack(">II", 20000, 20000) + bytes([8, 2, 0, 0, 0])
    png = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + ihdr
    png += struct.pack(">I", zlib.crc32(ihdr))
    for tag in (b"IDAT", b"IEND"):
        png += struct.pack(">I", 0) + tag + struct.pack(">I", zlib.crc32(tag))
    with pytest.raises(ValueError, match="pixel limit"):
        native.decode_png(png)
    monkeypatch.setenv("ISX_PNG_FAST", "0")
    with pytest.raises(ValueError, match="pixel limit"):
        native.decode_png(png)

    # BMP declaring 16384x16384 (268 Mpx): policy parity with Pillow even
    # though an uncompressed BMP can't truly bomb
    bmp = bytearray(b"BM" + b"\x00" * 52)
    struct.pack_into("<I", bmp, 10, 54)          # pixel offset
    struct.pack_into("<I", bmp, 14, 40)          # BITMAPINFOHEADER
    struct.pack_into("<ii", bmp, 18, 16384, 16384)
    struct.pack_into("<H", bmp, 28, 24)          # 24-bit BI_RGB
    with pytest.raises(ValueError, match="pixel limit"):
        native.decode_bmp(bytes(bmp))

    # WEBP: hand-built VP8L header declaring 16383x16383 (268 Mpx)
    if native.webp_available():
        dims = 16382 | (16382 << 14)        # width-1 | height-1, 14b each
        payload = b"\x2f" + struct.pack("<I", dims) + b"\x00" * 16
        vp8l = b"VP8L" + struct.pack("<I", len(payload)) + payload
        webp = b"RIFF" + struct.pack("<I", 4 + len(vp8l)) + b"WEBP" + vp8l
        with pytest.raises(ValueError, match="pixel limit"):
            native.decode_webp(webp)
        # the FULL ladder also refuses: the Pillow rungs keep their own
        # MAX_IMAGE_PIXELS policy (salvage only toggles truncation
        # tolerance), so no rung ever allocates the declared gigabytes
        with pytest.raises(Exception):
            codec.decode(webp)
