"""Host-side image codecs: decode, EXIF parse, encode.

Framework equivalent of the decode/encode work the reference delegates to the
WeChat runtime (SURVEY.md §2b): image decode happens on ``img.src = path``
(utils/canvas.js:110) with metadata/EXIF from ``wx.getImageInfo``
(pages/index/index.js:685), and export via ``wx.canvasToTempFilePath`` PNG
encode (utils/canvas.js:205-242).  Here those are explicit host functions:

* :func:`get_image_info` — header-only probe (dims, format, EXIF orientation,
  file size) without full decode: the ``wx.getImageInfo`` analog used by the
  prepare pipeline.
* :func:`decode` — full decode to raw (un-oriented) RGB uint8 + orientation.
  Supports draft-mode DCT downscale-on-decode for JPEG (the analog of the
  reference's downscale-on-load memory mitigation).
* :func:`encode` / :func:`encode_bytes` — PNG/JPEG/WEBP output.
* :func:`transcode_if_needed` — HEIC/unknown-format fallback ladder
  (utils/canvas.js:244-267): re-encode to JPEG when the fast path can't read.

A C-native codec (native/codec.cpp, libjpeg/libpng) is used when built — see
:mod:`.native`; Pillow is the always-available fallback.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Optional, Tuple, Union

import numpy as np

from ..config import SUPPORTED_TYPES

try:
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = False
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False

_EXIF_ORIENTATION_TAG = 274

PathOrBytes = Union[str, os.PathLike, bytes]


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Header-level metadata (the ``wx.getImageInfo`` analog)."""

    raw_w: int
    raw_h: int
    orientation: int
    format: str            # lowercase: "jpeg", "png", ...
    file_size: int         # bytes (0 for in-memory inputs)
    path: Optional[str] = None

    @property
    def pixels(self) -> int:
        return self.raw_w * self.raw_h

    @property
    def supported(self) -> bool:
        fmt = "jpg" if self.format == "jpeg" else self.format
        return fmt in SUPPORTED_TYPES or self.format in SUPPORTED_TYPES


def _open(src: PathOrBytes) -> "Image.Image":
    if not _HAVE_PIL:
        raise RuntimeError("Pillow unavailable and native codec not built")
    if isinstance(src, bytes):
        return Image.open(_io.BytesIO(src))
    return Image.open(src)


def _read_orientation(img: "Image.Image") -> int:
    try:
        exif = img.getexif()
        o = int(exif.get(_EXIF_ORIENTATION_TAG, 1) or 1)
        return o if 1 <= o <= 8 else 1
    except Exception:
        return 1


def get_image_info(src: PathOrBytes) -> ImageInfo:
    """Probe dims/format/orientation without decoding pixel data."""
    size = 0
    path = None
    if not isinstance(src, bytes):
        path = os.fspath(src)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
    else:
        size = len(src)

    from . import heif
    head = src if isinstance(src, bytes) else open(path, "rb").read(32)
    if heif.is_heif(head) and heif.available():
        data = src if isinstance(src, bytes) else open(path, "rb").read()
        w, h = heif.probe(data)
        # libheif applies transforms during decode -> orientation is 1
        return ImageInfo(raw_w=w, raw_h=h, orientation=1, format="heic",
                         file_size=size, path=path)

    with _open(src) as img:
        return ImageInfo(
            raw_w=img.width, raw_h=img.height,
            orientation=_read_orientation(img),
            format=(img.format or "").lower(),
            file_size=size, path=path,
        )


def _sniff(data: bytes) -> str:
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:2] == b"BM":
        return "bmp"
    return ""


def _jpeg_scale_denom(w: int, h: int, max_pixels: Optional[int]) -> int:
    if max_pixels is None or w * h <= max_pixels:
        return 1
    scale = (w * h / max_pixels) ** 0.5
    denom = 1
    while denom < 8 and denom < scale:
        denom *= 2
    return denom


# >8-bit grayscale modes (16-bit PNG reads as I;16 or I depending on
# Pillow version).  ``convert("RGB")`` on these CLAMPS at 255 — every
# pixel above the low 8 bits goes white — where libpng strip_16 (the
# native fast path, codec.cpp) and browser canvases take the high byte.
# The ladder must agree regardless of which decoder answered
# (soak seed 110014 caught the fallback producing an all-white image).
_DEEP_GRAY_MODES = ("I", "I;16", "I;16B", "I;16L", "I;16N")


def _deep_gray_to_rgb(img: "Image.Image") -> np.ndarray:
    g = np.asarray(img)
    if g.dtype != np.uint8:
        # The I;16* modes are 16-bit by definition: take the high byte.
        # Generic "I" is a 32-bit container with no defined range — common
        # int32 TIFFs hold plain 8-bit data, where >>8 would crush every
        # pixel to 0; shift only when the data actually exceeds 8 bits.
        # EXCEPT for PNG sources: PNG has no >16-bit integer mode, so a
        # mode-"I" PNG (older Pillow versions open 16-bit gray that way)
        # is always 16-bit samples — a dark frame (all <= 255) must still
        # take the high byte or this rung diverges from libpng strip_16
        # (the native fast path) on the very same file.
        if (img.mode == "I" and img.format != "PNG"
                and (g.size == 0 or int(g.max()) <= 255)):
            g = np.clip(g, 0, 255).astype(np.uint8)
        else:
            g = np.clip(g.astype(np.int64) >> 8, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _img_to_rgb(img: "Image.Image") -> np.ndarray:
    """Mode-dispatch conversion shared by every decode rung.

    All rungs of the ladder (strict decode, salvage, transcode) must agree
    on conversion semantics or the ladder's answer depends on which rung
    fired: alpha composites onto white (the draw loop always targets the
    white-filled canvas, index.js:1423-1424), >8-bit grayscale takes the
    high byte, everything else converts to RGB.
    """
    if img.mode in ("RGBA", "LA", "PA") or (
            img.mode == "P" and "transparency" in img.info):
        rgba = img.convert("RGBA")
        arr = np.asarray(rgba, np.float32)
        alpha = arr[:, :, 3:4] / 255.0
        rgb = arr[:, :, :3] * alpha + 255.0 * (1.0 - alpha)
        return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)
    if img.mode in _DEEP_GRAY_MODES:
        return _deep_gray_to_rgb(img)
    return np.asarray(img.convert("RGB"))


def decode(src: PathOrBytes,
           max_pixels: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode to raw (un-oriented) RGB uint8 HWC + EXIF orientation.

    Uses the native codec (native/codec.cpp via ctypes; GIL-free decode on
    the prepare pool) for JPEG/PNG/WEBP/BMP/GIF — the reference runtime's
    full native whitelist (index.js:4) — falling back to Pillow for
    everything else or when the native library is unavailable.

    ``max_pixels``: if set and the image exceeds it, JPEGs are decoded with
    libjpeg draft (DCT-domain) downscaling — cheaper than decode-then-resize.
    This is the framework analog of the reference's downscale-on-load
    mitigation (its pixel budgets, index.js:6-7).  The returned orientation
    still applies to the downscaled raw.

    Alpha: canvases composite onto an opaque background; we pre-composite
    RGBA/LA/P-alpha onto white at decode (the draw loop always targets the
    white-filled canvas, index.js:1423-1424).
    """
    from . import heif, native

    data = src if isinstance(src, bytes) else open(os.fspath(src), "rb").read()
    if heif.is_heif(data) and heif.available():
        # native HEIC decode (no lossy transcode generation; the reference
        # must re-encode to JPEG first, utils/canvas.js:255-263)
        return heif.decode(data), 1
    fmt = _sniff(data)
    if fmt and native.available():
        # orientation still comes from the (cheap, header-only) EXIF parse
        orientation = 1
        try:
            if fmt == "jpeg":
                try:
                    with _open(data) as img:
                        orientation = _read_orientation(img)
                        denom = _jpeg_scale_denom(img.width, img.height,
                                                  max_pixels)
                except Exception:
                    denom = 1
                arr = native.decode_jpeg(data, denom)
            elif fmt == "webp":
                # reference whitelists webp natively (index.js:4); EXIF
                # orientation still comes from the cheap header-only parse
                try:
                    with _open(data) as img:
                        orientation = _read_orientation(img)
                except Exception:
                    orientation = 1
                arr = native.decode_webp(data)   # None without libwebp;
                #                 raises on animated -> Pillow first-frame
            elif fmt == "bmp":
                # reference whitelists bmp/gif natively too (index.js:4);
                # neither container carries EXIF -> orientation stays 1
                arr = native.decode_bmp(data)
            elif fmt == "gif":
                arr = native.decode_gif(data)    # first frame (= Pillow's
                #              no-seek open); raises on partial-frame GIFs
            else:
                arr = native.decode_png(data)
        except Exception:
            # fall through to Pillow — the creator-fallback ladder
            # (utils/canvas.js:44-50): a native decode error must not be
            # terminal while another decoder exists.
            arr = None
        if arr is not None:
            return arr, orientation

    _pil_gate.read_acquire()    # strict decode: exclude salvage's tolerance
    try:
        # decode from the bytes already read: re-opening the PATH here can
        # block forever on pipe-like inputs while holding the read gate
        with _open(data) as img:
            orientation = _read_orientation(img)
            if max_pixels is not None and img.format == "JPEG":
                denom = _jpeg_scale_denom(img.width, img.height, max_pixels)
                if denom > 1:
                    img.draft("RGB", (max(1, img.width // denom),
                                      max(1, img.height // denom)))
            return np.ascontiguousarray(_img_to_rgb(img)), orientation
    finally:
        _pil_gate.read_release()


def encode(path: Union[str, os.PathLike], array: np.ndarray,
           quality: int = 95, png_compression: int = 6) -> str:
    """Write uint8 HWC array to ``path``; format from extension (PNG default).

    The export analog of ``safeCanvasToTempFilePath`` (utils/canvas.js:205-242,
    reference exports PNG at quality 1.0, index.js:1579).  PNG is lossless;
    ``png_compression`` (zlib 0-9) trades encode time for file size only —
    level 3 encodes ~2x faster than 6 with a few percent larger files.
    """
    if not _HAVE_PIL:
        raise RuntimeError("Pillow unavailable and native codec not built")
    path = os.fspath(path)
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError("encode expects uint8")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    ext = os.path.splitext(path)[1].lower().lstrip(".")

    if arr.ndim == 3 and arr.shape[2] == 3:
        from . import native
        if native.available():
            data = None
            if ext in ("jpg", "jpeg"):
                data = native.encode_jpeg(arr, quality=quality)
            elif ext in ("png", ""):
                data = native.encode_png(arr, compression=png_compression)
            if data is not None:
                with open(path if ext else path + ".png", "wb") as f:
                    f.write(data)
                return path if ext else path + ".png"

    img = Image.fromarray(arr)
    if ext in ("jpg", "jpeg"):
        img.save(path, quality=quality)
    else:
        img.save(path)
    return path


def encode_bytes(array: np.ndarray, format: str = "png",
                 quality: int = 95) -> bytes:
    buf = _io.BytesIO()
    arr = np.asarray(array)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    img = Image.fromarray(arr)
    fmt = format.upper().replace("JPG", "JPEG")
    if fmt == "JPEG":
        img.save(buf, fmt, quality=quality)
    else:
        img.save(buf, fmt)
    return buf.getvalue()


class _PilGate:
    """Readers-writer gate around Pillow's process-global strictness flag.

    ``LOAD_TRUNCATED_IMAGES`` is module-global in Pillow: while a salvage
    decode holds it True, a concurrent *strict* decode would silently accept
    truncated data.  Strict decodes take the (concurrent) read side; salvage
    takes the exclusive write side.
    """

    def __init__(self):
        import threading
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    def read_acquire(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1

    def read_release(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def write_acquire(self):
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True

    def write_release(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


_pil_gate = _PilGate()


def salvage_decode(src: PathOrBytes) -> Tuple[np.ndarray, int]:
    """Second-chance decode for corrupt-but-known-extension inputs.

    The stitch-time retry ladder analog (pages/index/index.js:1464-1509): when
    every strict decoder rejected the bytes, retry with truncated-stream
    tolerance — recover the readable portion at quality cost rather than
    aborting the whole job.  Raises (chained) if even the tolerant pass fails.
    """
    if not _HAVE_PIL:
        raise RuntimeError("Pillow unavailable; cannot salvage-decode")
    # read the bytes BEFORE taking the gate: file I/O can block arbitrarily
    # (pipes, dead mounts) and must never stall every other decode
    data = src if isinstance(src, bytes) else open(os.fspath(src), "rb").read()
    _pil_gate.write_acquire()   # exclusive: the tolerance flag is global
    prev = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with _open(data) as img:
            orientation = _read_orientation(img)
            out = np.ascontiguousarray(_img_to_rgb(img))
        return out, orientation
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = prev
        _pil_gate.write_release()


def transcode_if_needed(path: Union[str, os.PathLike],
                        workdir: Optional[str] = None) -> str:
    """Fallback ladder for formats the fast path can't read.

    Analog of ``tryTranscodeIfNeeded`` (utils/canvas.js:255-267): known-safe
    extensions pass through untouched (no quality loss); anything else —
    HEIC/HEIF/unknown — is re-encoded to JPEG quality 100 next to the source
    (or in ``workdir``).  Raises with a clear message if no decoder exists.
    """
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in SUPPORTED_TYPES:
        return path
    if ext in ("heic", "heif"):
        from . import heif
        if heif.available():
            return path           # decode() reads HEIC natively — no transcode
    try:
        with _open(path) as img:
            # same conversion semantics as the strict/salvage rungs: a
            # 16-bit grayscale or alpha'd TIFF must not clamp to white /
            # drop alpha just because it arrived via the transcode rung
            img = Image.fromarray(_img_to_rgb(img))
            base = os.path.basename(path) + ".transcoded.jpg"
            out = os.path.join(workdir or os.path.dirname(path) or ".", base)
            # subsampling=0: at default 4:2:0 the "quality 100" transcode
            # still halves chroma resolution (measured mean err 7.3/255 on
            # saturated content, formats-soak seed 110034); 4:4:4 keeps the
            # last-resort re-encode near-lossless for ~20% more bytes
            img.save(out, "JPEG", quality=100, subsampling=0)
            return out
    except Exception as e:
        raise RuntimeError(
            f"cannot decode {path!r} ({ext or 'no extension'}): {e}. "
            "HEIC/HEIF needs a pillow-heif plugin or pre-transcoding."
        ) from e
