"""Streaming canvas export: device->host readback overlapped with encode.

The reference's export is one opaque native call (``wx.canvasToTempFilePath``,
utils/canvas.js:205-242).  A framework canvas can be 100+ MP, which makes the
monolithic fetch-then-encode form both a latency and a peak-RSS problem: the
readback is IO-bound (device link) and the PNG filter+deflate is CPU-bound,
so running them serially wastes one of the two resources the whole time.

:func:`stream_to_png` pipelines them: a producer thread fetches fixed-height
row bands of the (device-resident) canvas while the main thread feeds the
previous band to the native incremental PNG writer
(:class:`..imgio.native.PngStreamWriter`).  Both sides release the GIL for
their long operations (PJRT transfer / libpng deflate), so the overlap is
real even on a single host core.  Peak host memory is a few bands, never the
whole canvas.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from .jaxcfg import is_device_array
from .logger import get_logger

ProgressFn = Callable[[str, float], None]

# Target ~24 MB fetched per band: big enough to amortize per-transfer
# overhead on the device link, small enough that 2-3 in-flight bands stay
# cheap in host RAM.
_BAND_BYTES = 24 << 20


def _noop(phase: str, fraction: float) -> None:
    del phase, fraction


def band_rows_for(width: int, channels: int = 3,
                  target_bytes: int = _BAND_BYTES) -> int:
    rows = max(64, target_bytes // max(1, width * channels))
    return int(rows)


def stream_to_png(canvas, path: str, png_compression: int = 6,
                  band_rows: Optional[int] = None,
                  progress: ProgressFn = _noop) -> dict:
    """Write ``canvas`` (uint8 HWC, 3 channels) to ``path`` as PNG, banded.

    ``canvas`` may be a host numpy array (bands are encoded straight out of
    it) or a device array (bands are fetched by producer threads that run
    ahead of the encoder).  Returns a phase dict:
    ``{"readback_s", "encode_s", "wall_s", "overlapped": bool}`` —
    ``encode_s`` is the encoder's busy time, ``readback_s`` the fetch
    pipeline's wall, ``wall_s`` the elapsed export time (< their sum when
    the overlap engages).

    Raises if the native codec is unavailable — callers fall back to the
    monolithic :func:`..imgio.codec.encode` path (see ``api.stitch_to_file``).
    On any error the partial output file is removed.
    """
    return _stream_to_file(canvas, path, "png", png_compression, band_rows,
                           progress)


def stream_to_jpeg(canvas, path: str, quality: int = 95,
                   band_rows: Optional[int] = None,
                   progress: ProgressFn = _noop) -> dict:
    """JPEG twin of :func:`stream_to_png` (scanline-incremental libjpeg;
    bytes identical to the monolithic encoder at equal quality)."""
    return _stream_to_file(canvas, path, "jpeg", quality, band_rows,
                           progress)


def _stream_to_file(canvas, path: str, fmt: str, param: int,
                    band_rows: Optional[int],
                    progress: ProgressFn) -> dict:
    from ..imgio import native

    h, w = int(canvas.shape[0]), int(canvas.shape[1])
    channels = int(canvas.shape[2]) if canvas.ndim == 3 else 1
    if channels != 3:
        raise ValueError("streaming export requires a 3-channel canvas")
    band = min(h, band_rows or band_rows_for(w))
    t_wall = time.perf_counter()
    phases = {"readback_s": 0.0, "encode_s": 0.0,
              "overlapped": is_device_array(canvas)}

    cls = (native.PngStreamWriter if fmt == "png"
           else native.JpegStreamWriter)
    writer = cls(path, w, h, param)
    try:
        if not is_device_array(canvas):
            arr = np.asarray(canvas)
            for r in range(0, h, band):
                t0 = time.perf_counter()
                writer.write(arr[r: r + band])
                phases["encode_s"] += time.perf_counter() - t0
                progress("export", min(1.0, (r + band) / h))
            writer.close()
        else:
            _stream_device(canvas, writer, h, w, channels, band, phases,
                           progress)
    except BaseException:
        writer.abort()
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    phases["wall_s"] = time.perf_counter() - t_wall
    get_logger().event(
        f"export.stream_{fmt}", canvas=(w, h), band_rows=band,
        wall_s=round(phases["wall_s"], 3),
        readback_s=round(phases["readback_s"], 3),
        encode_s=round(phases["encode_s"], 3))
    return phases


def _stream_device(canvas, writer, h: int, w: int, channels: int, band: int,
                   phases: dict, progress: ProgressFn,
                   fetch_threads: int = 4) -> None:
    """Producer (device fetch) / consumer (PNG encode) pipeline.

    ``fetch_threads`` producers fetch interleaved bands concurrently, so
    several device->host transfers are in flight while the encoder works,
    and a reorder buffer hands bands to the encoder strictly top-to-bottom.
    ``readback_s`` reports the UNION of fetch in-flight intervals: it
    excludes producer stalls from encoder backpressure (a wall figure would
    misattribute encoder CPU to the link) and never double-counts
    concurrent transfers (a busy-sum would).
    """
    import jax

    @jax.jit
    def fetch(o, r):
        # dynamic_slice clamps the start, so the tail band re-reads rows the
        # producer then trims — one compile for every band including the last
        return jax.lax.dynamic_slice(o, (r, 0, 0), (band, w, channels))

    n_bands = -(-h // band)
    fetch_threads = max(1, min(fetch_threads, n_bands))
    depth = fetch_threads + 2          # bands buffered ahead of the encoder
    lock = threading.Condition()
    results: dict = {}
    consumed = [0]
    errs: list = []
    active = [0]                       # fetches in flight (interval union)
    t_open = [0.0]

    def producer(tid: int):
        try:
            for bi in range(tid, n_bands, fetch_threads):
                with lock:
                    while bi - consumed[0] >= depth and not errs:
                        lock.wait()
                    if errs:
                        return
                    if active[0] == 0:
                        t_open[0] = time.perf_counter()
                    active[0] += 1
                r = bi * band
                n = min(band, h - r)
                try:
                    arr = np.asarray(fetch(canvas, r))
                finally:
                    with lock:
                        active[0] -= 1
                        if active[0] == 0:
                            phases["readback_s"] += (time.perf_counter()
                                                     - t_open[0])
                with lock:
                    results[bi] = arr[band - n:] if n < band else arr
                    lock.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            with lock:
                errs.append(e)
                lock.notify_all()

    threads = [threading.Thread(target=producer, args=(i,), daemon=True,
                                name=f"stitch-readback-{i}")
               for i in range(fetch_threads)]
    for t in threads:
        t.start()
    try:
        for bi in range(n_bands):
            with lock:
                while bi not in results and not errs:
                    lock.wait()
                if bi not in results:
                    raise errs[0]
                arr = results.pop(bi)
                consumed[0] = bi + 1
                lock.notify_all()
            t0 = time.perf_counter()
            writer.write(arr)
            phases["encode_s"] += time.perf_counter() - t0
            progress("export", min(1.0, (bi + 1) / n_bands))
    except BaseException as e:
        with lock:                      # unblock producers waiting on depth
            errs.append(e)
            lock.notify_all()
        raise
    finally:
        for t in threads:
            t.join()
    writer.close()


def stream_blit_to_file(plan, loaders, path: str, fmt: str, param: int,
                        copies: dict, decode_threads: int,
                        decode_timeout_s: Optional[float] = None,
                        progress: ProgressFn = _noop,
                        window: Optional[int] = None) -> dict:
    """Pure-blit export: decode pool -> host band assembly -> native encode.

    When every drawn placement is an identity copy (equal-size concat —
    the reference's own hot path degenerates to drawImage blits there too,
    pages/index/index.js:1423-1431), the canvas never needs to exist on
    *either* side: bands are assembled straight from the decoded sources
    and fed to the streaming encoder, skipping H2D, device compositing and
    the D2H readback entirely.  ``copies`` is
    :func:`..core.geometry.plan_copy_offsets` for ``plan``.

    Decode runs on the watchdogged pool under an **ack window** (the
    parallel analog of the reference's serialized ingest,
    index.js:1125-1157): sources are *submitted in band-consumption order*
    and each decoded source holds a window slot until its rows are fully
    written, so peak decoded residency is O(window) regardless of job size
    — jobs of unbounded total source bytes stream in bounded RAM (this
    replaced the old ``api._BLIT_MAX_SRC_BYTES`` routing cap).  Returns
    ``{"decode_s", "encode_s", "wall_s", "overlapped": True}`` where
    ``decode_s`` is the decode time *exposed* in the band loop (decodes
    that land while earlier bands encode are genuinely overlapped).

    On any error the partial output file is removed and the error re-raised
    (decode failures abort the job — by stitch time geometry is committed,
    the reference aborts there too, index.js:1507-1509).
    """
    from ..core import geometry
    from ..imgio import native
    from . import decoding

    H, W = int(plan.canvas_h), int(plan.canvas_w)
    t_wall = time.perf_counter()
    phases = {"decode_s": 0.0, "encode_s": 0.0, "overlapped": True}
    band = min(H, band_rows_for(W))
    if window is None:
        window = decoding.default_window(decode_threads, len(loaders))

    # Submission order = the order bands will first need each source (first
    # intersecting band, stable by plan order within a band; never-drawn
    # sources last).  With FIFO dispatch this makes the windowed pool
    # deadlock-free — PROVIDED the window covers every source a single band
    # consumes concurrently, so the effective window is floored at the
    # plan's max per-band source count.  Vertical strips keep that small
    # (ceil(band/image_rows)+1); a horizontal strip needs every source in
    # every band, so its residency is inherently O(n) — same as the device
    # pipeline's source set, just in host RAM.
    def _is_drawn(p) -> bool:
        return (p.row_span[1] > p.row_span[0]
                and p.col_span[1] > p.col_span[0])

    drawn = {p.index for p in plan.placements if _is_drawn(p)}
    n_bands = -(-H // band)
    delta = [0] * (n_bands + 1)
    for p in plan.placements:
        if p.index in drawn:
            delta[p.row_span[0] // band] += 1
            delta[(min(p.row_span[1], H) - 1) // band + 1] -= 1
    peak_band_sources, acc = 1, 0
    for d in delta[:-1]:
        acc += d
        peak_band_sources = max(peak_band_sources, acc)
    window = max(window, peak_band_sources)
    order = [p.index for p in sorted(
        (p for p in plan.placements if _is_drawn(p)),
        key=lambda p: p.row_span[0] // band)]
    order += [p.index for p in plan.placements if p.index not in drawn]

    cls = (native.PngStreamWriter if fmt == "png"
           else native.JpegStreamWriter)
    writer = cls(path, W, H, param)
    gen = decoding.iter_decoded([loaders[i] for i in order], decode_threads,
                                decode_timeout_s, window=window,
                                indices=order)
    ready: dict = {}
    oriented: dict = {}

    def _get_oriented(p) -> np.ndarray:
        img = oriented.get(p.index)
        if img is not None:
            return img
        t0 = time.perf_counter()
        while p.index not in ready:
            i, raw, err = next(gen)    # original image index (indices=)
            if err is not None:
                raise err
            if i not in drawn:
                gen.ack()          # no band will consume it; free the slot
                continue
            ready[i] = np.asarray(raw)
        phases["decode_s"] += time.perf_counter() - t0
        raw = geometry.normalize_rgb(ready.pop(p.index))
        if raw is None or raw.shape[:2] != (p.raw_h, p.raw_w):
            raise ValueError(
                f"image {p.index}: decoded "
                f"{None if raw is None else raw.shape} but header said "
                f"{p.raw_w}x{p.raw_h}x3")
        img = geometry.orient_array(raw, p.orientation)
        oriented[p.index] = img
        return img

    bg = np.asarray(plan.background[:3], np.uint8)
    buf = np.empty((band, W, 3), np.uint8)
    try:
        for r0 in range(0, H, band):
            r1 = min(H, r0 + band)
            b = buf[: r1 - r0]
            geometry.fill_background(b, bg)
            for p in plan.placements:
                pr0, pr1 = p.row_span
                pc0, pc1 = p.col_span
                if (pr1 <= pr0 or pc1 <= pc0
                        or pr1 <= r0 or pr0 >= r1):
                    continue
                img = _get_oriented(p)
                sr0, sc0 = copies[p.index]
                a0, a1 = max(pr0, r0), min(pr1, r1)
                b[a0 - r0: a1 - r0, pc0:pc1] = img[
                    sr0 + (a0 - pr0): sr0 + (a1 - pr0),
                    sc0: sc0 + (pc1 - pc0)]
            t0 = time.perf_counter()
            writer.write(b)
            phases["encode_s"] += time.perf_counter() - t0
            progress("export", r1 / H)
            for p in plan.placements:   # release fully-written sources
                if (p.row_span[1] <= r1
                        and oriented.pop(p.index, None) is not None):
                    gen.ack()           # slot freed -> next decode submits
        # drain the pool before finalizing: images whose placements drew
        # nothing (zero-area spans) were still submitted — a corrupt or
        # hung one must fail the job exactly as the device path's prepare
        # would, not silently succeed
        for _, _, err in gen:
            gen.ack()
            if err is not None:
                raise err
        writer.close()
    except BaseException:
        writer.abort()
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    finally:
        gen.close()
    phases["wall_s"] = time.perf_counter() - t_wall
    get_logger().event(
        f"export.stream_blit_{fmt}", canvas=(W, H), band_rows=band,
        n=len(copies), window=window, wall_s=round(phases["wall_s"], 3),
        decode_s=round(phases["decode_s"], 3),
        encode_s=round(phases["encode_s"], 3))
    return phases
