"""High-level stitch API: files/arrays in -> stitched array/file out.

The L5 replacement for the reference's touch UI (SURVEY.md §1): what
``onChooseImages`` + ``onStitch`` (pages/index/index.js:1013,1186) do across
1,700 lines of orchestration becomes three functions — with the reference's
behavioral contract (prepare with failure isolation, geometry, background,
progress reporting, export) and device execution underneath.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import CanvasLimits, RuntimeConfig, StitchOptions
from .core import oracle as _oracle
from .core.layout import ImageSpec, solve
from .imgio import codec
from .runtime import decoding
from .runtime.jaxcfg import is_device_array
from .runtime.logger import get_logger

ArrayLike = np.ndarray
ImageInput = Union[str, os.PathLike, bytes, ArrayLike,
                   Tuple[ArrayLike, int]]  # (array, exif_orientation)

ProgressFn = Callable[[str, float], None]   # (phase, fraction 0..1)


def _noop_progress(phase: str, fraction: float) -> None:
    del phase, fraction


def _load_one(item: ImageInput,
              config: Optional[RuntimeConfig] = None) -> Tuple[np.ndarray, int]:
    """Normalize one input to (raw uint8 HWC array, orientation)."""
    if isinstance(item, tuple):
        arr, orientation = item
        return _as_uint8(arr), int(orientation)
    if isinstance(item, np.ndarray):
        return _as_uint8(item), 1
    if isinstance(item, (str, os.PathLike)):
        from .runtime.cache import get_cache
        budget = config.budget if config else None
        cache = get_cache(budget.host_cache_pixels if budget else 64_000_000,
                          budget.host_cache_entries if budget else 6)
        key = cache.file_key(os.fspath(item))
        if key is not None:
            hit = cache.get(key)
            if hit is not None:
                return hit
        store = akey = None
        if budget is not None and budget.artifact_dir:
            from .runtime.artifacts import get_store
            store = get_store(budget.artifact_dir,
                              budget.artifact_quota_bytes)
            akey = store.key_for(os.fspath(item))
            hit = store.get(akey) if akey else None
            if hit is not None:
                if key is not None:
                    cache.put(key, *hit)
                return hit
        path = codec.transcode_if_needed(item)
        arr, orientation = _decode_with_retry(path)
        if key is not None:
            cache.put(key, arr, orientation)
        if store is not None and akey is not None:
            store.put(akey, arr, orientation)
        return arr, orientation
    if isinstance(item, bytes):
        return _decode_with_retry(item)
    raise TypeError(f"unsupported image input {type(item)!r}")


def _decode_with_retry(src) -> Tuple[np.ndarray, int]:
    """Decode with the stitch-time second-chance ladder.

    The reference retries a failed load via transcode *inside the stitch
    loop* (index.js:1464-1509) — a decode error on a known extension gets one
    more, lossier, attempt before the job aborts.  Here the second chance is
    a truncated-tolerant salvage decode (:func:`codec.salvage_decode`).
    """
    try:
        return codec.decode(src)
    except Exception as e:
        get_logger().once("decode.salvage_attempt", error=repr(e))
        get_logger().event("decode.salvage", error=repr(e))
        return codec.salvage_decode(src)


def _flatten_alpha(arr: np.ndarray) -> np.ndarray:
    """Composite a straight-alpha uint8 HWC array (C in {2, 4}) onto white.

    Same formula and half-up rounding as the decode ladder
    (codec._img_to_rgb): the same pixels must stitch identically whether
    they arrive as an RGBA array or as encoded RGBA bytes."""
    a = arr[:, :, -1:].astype(np.float32) / 255.0
    color = arr[:, :, :-1].astype(np.float32) * a + 255.0 * (1.0 - a)
    return np.clip(np.floor(color + 0.5), 0, 255).astype(np.uint8)


def _as_uint8(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected HWC image, got shape {arr.shape}")
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating):
            arr = _oracle.to_uint8(arr)
        else:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.shape[2] in (2, 4):       # LA / RGBA: flatten like the decoder
        arr = _flatten_alpha(arr)
    if arr.shape[2] not in (1, 3):
        raise ValueError(
            f"expected 1/3-channel (or 2/4 with alpha) HWC image, got "
            f"{arr.shape[2]} channels")
    return arr


def _unify_channels(images: List[np.ndarray]) -> List[np.ndarray]:
    """Promote grayscale to RGB when one job mixes 1- and 3-channel images
    (a gray array next to a decoded RGB file is a normal mix, and one
    compiled program serves the whole job, so the channel count must be
    uniform).  All-gray jobs stay single-channel."""
    cs = {a.shape[2] for a in images}
    if len(cs) <= 1:
        return list(images)
    return [np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a
            for a in images]


def prepare(items: Sequence[ImageInput], config: RuntimeConfig,
            on_error: str = "raise",
            progress: ProgressFn = _noop_progress,
            ) -> Tuple[List[np.ndarray], List[ImageSpec], List[Tuple[int, Exception]]]:
    """Parallel decode + normalize with per-image failure isolation.

    The reference prepares strictly serially to avoid OOM
    (index.js:1125-1157); on a host with a real allocator we decode on a
    thread pool instead.  ``on_error``:

    * ``"raise"`` — first failure aborts the job (reference stitch-phase
      behavior, index.js:1507-1509);
    * ``"skip"``  — drop failed images and stitch the rest (reference
      prepare-phase behavior, index.js:1133-1149).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError("on_error must be 'raise' or 'skip'")
    log = get_logger()
    images: List[Optional[np.ndarray]] = [None] * len(items)
    orientations: List[int] = [1] * len(items)
    failures: List[Tuple[int, Exception]] = []
    done = 0
    jobs = [(lambda it=it: _load_one(it, config)) for it in items]
    pool = decoding.iter_decoded(jobs, config.decode_threads,
                                 config.decode_timeout_s)
    try:
        for i, value, err in pool:
            if err is not None:
                if not isinstance(err, Exception):
                    raise err     # KeyboardInterrupt etc. — never skippable
                log.event("prepare.fail", index=i, error=repr(err))
                if on_error == "raise":
                    raise err
                failures.append((i, err))
            else:
                images[i], orientations[i] = value
            done += 1
            progress("prepare", done / max(1, len(items)))
    finally:
        # the on_error="raise" path must cancel the pool promptly: abandoned
        # (its generator frame forms a self-cycle only gc collects), the
        # daemon workers would keep decoding every queued image meanwhile —
        # same class as the _stitch_blit_overlapped ADVICE r3 fix
        pool.close()

    kept_images: List[np.ndarray] = []
    specs: List[ImageSpec] = []
    for img, o in zip(images, orientations):
        if img is None:
            continue
        kept_images.append(img)
        specs.append(ImageSpec(raw_w=img.shape[1], raw_h=img.shape[0],
                               orientation=o))
    return kept_images, specs, failures


def stitch_arrays(images: Sequence[np.ndarray],
                  specs: Optional[Sequence[ImageSpec]] = None,
                  options: Optional[StitchOptions] = None,
                  config: Optional[RuntimeConfig] = None,
                  limits: Optional[CanvasLimits] = None,
                  progress: ProgressFn = _noop_progress,
                  return_metrics: bool = False,
                  keep_on_device: bool = False):
    """Stitch already-decoded raw arrays (uint8 HWC) into one strip.

    With ``return_metrics=True`` returns ``(array, StitchMetrics)`` — the
    per-phase timing/strategy record (observability analog of the
    reference's timing console.logs, index.js:1443-1616).

    ``keep_on_device=True`` skips the final device->host readback when the
    canvas ends up device-resident: the result is then a ``jax.Array``
    (``np.asarray`` it, keep computing on it, or stream-export it).  Host-
    compositing strategies (banded/oracle) still return numpy.
    """
    options = (options or StitchOptions()).validate()
    config = (config or RuntimeConfig()).validate()
    if limits is None:
        limits = config.limits          # explicit arg overrides the config
    images = _unify_channels([_as_uint8(a) for a in images])
    if specs is None:
        specs = [ImageSpec(a.shape[1], a.shape[0]) for a in images]
    log = get_logger()
    if options.merge_overlap:
        from .ops import overlap as _overlap
        images, specs, trims = _overlap.merge_arrays(images, specs, options)
        log.event("stitch.merge", trims=trims)
    plan = solve(specs, options, limits)
    log.event("stitch.plan", canvas=(plan.canvas_w, plan.canvas_h),
              n=len(images), mode=plan.mode, direction=plan.direction,
              supersample=plan.supersample, scale_down=plan.scale_down)
    from .runtime import pipeline
    out, metrics = pipeline.run(plan, images, config, progress,
                                keep_on_device=keep_on_device)
    log.event("stitch.done", shape=tuple(out.shape))
    if return_metrics:
        return out, metrics
    return out


def _probe_item(item: ImageInput) -> Optional[ImageSpec]:
    """Header-only ImageSpec for an input, or None if probing can't work."""
    try:
        if isinstance(item, tuple):
            arr, orientation = item
            arr = np.asarray(arr)
            return ImageSpec(arr.shape[1], arr.shape[0], int(orientation))
        if isinstance(item, np.ndarray):
            return ImageSpec(item.shape[1], item.shape[0], 1)
        if isinstance(item, (str, os.PathLike, bytes)):
            info = codec.get_image_info(item)
            return ImageSpec(info.raw_w, info.raw_h, info.orientation)
    except Exception:
        return None
    return None


def _overlappable_array(item: ImageInput) -> bool:
    """True when an array input can ride the overlapped executors, whose
    channel count is a compile-time constant 3.  RGBA qualifies (the
    loaders flatten it onto white, yielding 3 channels); gray/LA arrays
    (1 channel after normalization) take the prepare -> stitch_arrays
    path instead, which parameterizes channels.  Non-array inputs always
    decode to RGB."""
    arr = item[0] if isinstance(item, tuple) else item
    if isinstance(arr, np.ndarray):
        a = np.asarray(arr)
        return a.ndim == 3 and a.shape[2] in (3, 4)
    return True


def _is_big_task(items: Sequence[ImageInput]) -> bool:
    """Reference big-task thresholds: >=7 images or >=25 MB total
    (pages/index/index.js:1211-1212)."""
    if len(items) >= 7:
        return True
    total = 0
    for it in items:
        if isinstance(it, (str, os.PathLike)):
            try:
                total += os.path.getsize(os.fspath(it))
            except OSError:
                pass
        elif isinstance(it, bytes):
            total += len(it)
    return total >= 25 * 1024 * 1024


def stitch(items: Sequence[ImageInput],
           direction: str = "vertical", mode: str = "min", gap: float = 0.0,
           options: Optional[StitchOptions] = None,
           config: Optional[RuntimeConfig] = None,
           limits: Optional[CanvasLimits] = None,
           on_error: str = "raise",
           progress: ProgressFn = _noop_progress,
           return_metrics: bool = False,
           keep_on_device: bool = False):
    """Stitch image files/bytes/arrays into one strip (returns uint8 HWC).

    The one-call equivalent of the reference's full user flow: pick
    (onChooseImages) -> prepare (_prepareImages) -> stitch (onStitch).
    ``options`` overrides the individual direction/mode/gap arguments.

    For big jobs (or ``config.overlap="always"``) decode, H2D and device
    compositing are overlapped: the layout is solved from image headers and
    each image is placed the moment its decode lands.

    With ``return_metrics=True`` returns ``(array, StitchMetrics)``.
    """
    import time as _time

    if options is None:
        options = StitchOptions(direction=direction, mode=mode, gap=gap)
    config = (config or RuntimeConfig()).validate()
    if limits is None:
        limits = config.limits          # explicit arg overrides the config

    # merge_overlap needs every image's pixels before layout (the trims
    # change the specs), so it always takes the decode-everything path
    want_overlap = (not options.merge_overlap
                    and all(_overlappable_array(it) for it in items)
                    and (config.overlap == "always"
                         or (config.overlap == "auto"
                             and _is_big_task(items))))
    if want_overlap and on_error == "raise" and config.engine != "oracle":
        specs = [_probe_item(it) for it in items]
        if all(s is not None for s in specs):
            from .runtime import pipeline
            plan = solve(specs, options, limits)
            loaders = [(lambda it=it: _load_one(it, config)[0])
                       for it in items]
            copies = _blit_copies(plan, config, keep_on_device)
            if copies is not None:
                out, metrics = _stitch_blit_overlapped(
                    plan, loaders, config, progress, copies)
                return (out, metrics) if return_metrics else out
            out, metrics = pipeline.run_overlapped(
                plan, loaders, config, progress,
                keep_on_device=keep_on_device)
            return (out, metrics) if return_metrics else out
        # unprobeable input (needs transcode to even read the header):
        # fall through to the plain flow

    t0 = _time.perf_counter()
    images, specs, failures = prepare(items, config, on_error, progress)
    prepare_s = _time.perf_counter() - t0
    if not images:
        if failures:
            raise RuntimeError(
                f"all {len(failures)} images failed to prepare; "
                f"first: {failures[0][1]!r}")
        raise ValueError("no images to stitch")
    out, metrics = stitch_arrays(images, specs, options, config, limits,
                                 progress, return_metrics=True,
                                 keep_on_device=keep_on_device)
    metrics.prepare_s = prepare_s
    metrics.total_s += prepare_s
    return (out, metrics) if return_metrics else out


def stitch_to_file(items: Sequence[ImageInput], out_path: Union[str, os.PathLike],
                   quality: int = 95, png_compression: int = 6,
                   stream: Union[bool, str] = "auto",
                   return_metrics: bool = False, **kwargs) -> str:
    """Stitch and write the result (format from extension; PNG default).

    ``stream`` controls the export pipeline: ``"auto"`` (default) keeps the
    canvas on device and overlaps the banded device->host readback with the
    incremental native encode (PNG or JPEG by extension) whenever the
    native codec is available and the canvas is RGB — on big canvases the
    encode hides almost entirely under the transfer.  ``False`` forces the
    monolithic fetch-then-encode path; ``True`` requires streaming (raises
    if the native codec is missing, the format has no streaming encoder, or
    the canvas is not RGB).
    """
    import time as _time

    if stream not in (True, False, "auto"):
        raise ValueError(f"stream must be True/False/'auto', got {stream!r}")
    if "keep_on_device" in kwargs:
        raise TypeError("keep_on_device is managed by stitch_to_file; "
                        "use stitch()/stitch_arrays() for a device canvas")
    out_path = os.fspath(out_path)
    ext = os.path.splitext(out_path)[1].lower().lstrip(".")
    streamable = ext in ("png", "jpg", "jpeg", "")
    want_stream = stream is True or (stream == "auto" and streamable
                                     and _native_available())
    # the blit fast path plans from image HEADERS; merge_overlap trims are
    # pixel-derived, so it must go through the full stitch() flow instead
    opts = kwargs.get("options")
    merge_on = bool(opts is not None
                    and getattr(opts, "merge_overlap", False))
    if want_stream and streamable and _native_available() and not merge_on:
        blit = _blit_stream_attempt(items, out_path, ext, quality,
                                    png_compression, kwargs)
        if blit is not None:
            path, metrics = blit
            return (path, metrics) if return_metrics else path
    if want_stream:
        if not streamable:
            raise ValueError(
                f"stream=True has no streaming encoder for {ext!r}")
        out, metrics = stitch(items, return_metrics=True,
                              keep_on_device=True, **kwargs)
        path = out_path if ext else out_path + ".png"
        if out.ndim == 3 and out.shape[2] == 3:
            from .runtime import export
            progress = kwargs.get("progress", _noop_progress)
            if ext in ("jpg", "jpeg"):
                phases = export.stream_to_jpeg(out, path, quality,
                                               progress=progress)
            else:
                phases = export.stream_to_png(out, path, png_compression,
                                              progress=progress)
            metrics.readback_s += phases["readback_s"]
            metrics.encode_s += phases["encode_s"]
            metrics.export_s = phases["wall_s"]
            metrics.total_s += phases["wall_s"]
            return (path, metrics) if return_metrics else path
        if stream is True:
            raise ValueError("stream=True requires a 3-channel RGB canvas")
        # auto + non-RGB canvas: monolithic encoder; count the readback
        if is_device_array(out):
            t0 = _time.perf_counter()
            out = np.asarray(out)
            metrics.readback_s += _time.perf_counter() - t0
            metrics.total_s += _time.perf_counter() - t0
    else:
        out, metrics = stitch(items, return_metrics=True, **kwargs)
    t0 = _time.perf_counter()
    path = codec.encode(out_path, np.asarray(out), quality=quality,
                        png_compression=png_compression)
    metrics.encode_s += _time.perf_counter() - t0
    metrics.export_s = metrics.readback_s + metrics.encode_s
    metrics.total_s += _time.perf_counter() - t0
    return (path, metrics) if return_metrics else path


def _blit_copies(plan, config, keep_on_device: bool = False):
    """The copy offsets when ``pipeline.choose_engine`` picks the host
    blit for this plan, else None (use the device pipeline).  There is no
    total-source-bytes cap: the decode pool's ack window bounds resident
    decoded bytes at O(window) regardless of job size
    (runtime/decoding.DecodePool)."""
    from .runtime.pipeline import choose_engine
    engine, copies = choose_engine(plan, config,
                                   keep_on_device=keep_on_device)
    return copies if engine == "host-blit" else None


def _stitch_blit_overlapped(plan, loaders, config, progress, copies):
    """Overlapped stitch for pure-blit plans: paste each source into the
    host canvas the moment its decode lands.  No device round trip — the
    decode pool IS the pipeline (placement row spans are disjoint, so
    completion-order pasting is race-free)."""
    import time as _time

    from .core import geometry
    from .runtime.pipeline import StitchMetrics

    t0 = _time.perf_counter()
    m = StitchMetrics(strategy="host-blit", canvas_w=plan.canvas_w,
                      canvas_h=plan.canvas_h)
    canvas = np.empty((plan.canvas_h, plan.canvas_w, 3), np.uint8)
    geometry.fill_uncovered(canvas, plan, copies, plan.background[:3])
    n = len(loaders)
    done = 0
    # paste-on-arrival consumes in ANY order, so the ack window (acked
    # right after each paste) only bounds decode pile-up ahead of the
    # pasting loop — ordering is irrelevant here, unlike the band streamer
    gen = decoding.iter_decoded(
        loaders, config.decode_threads, config.decode_timeout_s,
        window=config.decode_window
        or decoding.default_window(config.decode_threads, n))
    try:
        for i, raw, err in gen:
            if err is not None:
                get_logger().event("pipeline.overlapped_decode_fail",
                                   index=i, error=repr(err))
                raise err
            p = plan.placements[i]
            raw = geometry.normalize_rgb(raw)
            if raw is None or raw.shape[:2] != (p.raw_h, p.raw_w):
                raise ValueError(
                    f"image {i}: decoded "
                    f"{None if raw is None else raw.shape} but header said "
                    f"{p.raw_w}x{p.raw_h}x3")
            if i in copies:
                geometry.paste_blit(
                    canvas, p, geometry.orient_array(raw, p.orientation),
                    copies[i])
            gen.ack()                   # pasted (or skipped): slot freed
            done += 1
            progress("composite", 0.30 + 0.60 * done / n)
    finally:
        # a decode error / shape mismatch must cancel the pool promptly —
        # abandoned, its daemon workers keep decoding queued images and
        # busy-poll the permit semaphore until a gc cycle pass finds the
        # self-referential generator (mirrors pipeline._run_overlapped_body)
        gen.close()
    m.prepare_s = _time.perf_counter() - t0
    m.total_s = _time.perf_counter() - t0
    get_logger().event("pipeline.done", strategy=m.strategy,
                       total_s=round(m.total_s, 4),
                       mp_per_sec=round(m.mp_per_sec, 1))
    progress("composite", 1.0)
    return canvas, m


def _blit_stream_attempt(items, out_path: str, ext: str, quality: int,
                         png_compression: int, kwargs: dict):
    """Zero-device-round-trip streamed export for pure-blit plans.

    When header probing succeeds and every drawn placement is an identity
    copy (:func:`core.geometry.plan_copy_offsets` — equal-size concat, the
    reference's own hot path, index.js:1423-1431), the canvas never needs
    to exist on either side of the PCIe link: bands are assembled from the
    decoded sources and streamed to the encoder.  Returns
    ``(path, StitchMetrics)`` or None when the conditions don't hold (the
    caller then runs the device pipeline).
    """
    from .runtime import export
    from .runtime.pipeline import StitchMetrics

    if not items or kwargs.get("on_error", "raise") != "raise":
        return None                     # empty input: canonical error path
    config = (kwargs.get("config") or RuntimeConfig()).validate()
    if config.overlap == "never":
        return None                     # user disabled pipelined execution
    if not all(_overlappable_array(it) for it in items):
        return None                     # gray/LA arrays: plain path
    options = kwargs.get("options") or StitchOptions(
        direction=kwargs.get("direction", "vertical"),
        mode=kwargs.get("mode", "min"),
        gap=kwargs.get("gap", 0.0))
    specs = [_probe_item(it) for it in items]
    if any(s is None for s in specs):
        return None
    lim = kwargs.get("limits")
    plan = solve(specs, options, config.limits if lim is None else lim)
    copies = _blit_copies(plan, config)
    if copies is None:
        return None
    loaders = [(lambda it=it: _load_one(it, config)[0]) for it in items]
    path = out_path if ext else out_path + ".png"
    fmt = "jpeg" if ext in ("jpg", "jpeg") else "png"
    param = quality if fmt == "jpeg" else png_compression
    progress = kwargs.get("progress", _noop_progress)
    get_logger().event("stitch.blit_stream", n=len(items),
                       canvas=(plan.canvas_w, plan.canvas_h), fmt=fmt)
    phases = export.stream_blit_to_file(
        plan, loaders, path, fmt, param, copies,
        config.decode_threads, config.decode_timeout_s, progress,
        window=config.decode_window)
    metrics = StitchMetrics(
        strategy="host-blit-stream",
        canvas_w=plan.canvas_w, canvas_h=plan.canvas_h,
        prepare_s=phases["decode_s"], encode_s=phases["encode_s"],
        export_s=phases["wall_s"], total_s=phases["wall_s"])
    return path, metrics


def _native_available() -> bool:
    from .imgio import native
    return native.available()


def stitch_grid(items: Sequence[ImageInput], cols: int = 3,
                options: Optional[StitchOptions] = None,
                config: Optional[RuntimeConfig] = None,
                limits: Optional[CanvasLimits] = None,
                on_error: str = "raise",
                progress: ProgressFn = _noop_progress,
                order: str = "balance", valign: str = "top",
                return_metrics: bool = False):
    """Masonry grid collage: ``cols`` columns, images resized ONCE to the
    common column width (framework extension — the reference app, despite
    its name "优雅拼图"/elegant collage, only produces 1-D strips,
    index.js:1526-1554).

    Each column is an ordinary vertical-strip job (every engine/memory
    strategy applies per column; see ``core/grid.py`` for the sizing
    contract), then columns are assembled write-once on a background
    canvas.  ``order``: "balance" = shortest-column masonry assignment,
    "preserve" = row-major input order.  ``valign``: "top" or "center" —
    where a shorter column sits against the tallest one.
    """
    import time as _time

    from .core.grid import plan_grid
    from .core.layout import _js_round

    if valign not in ("top", "center"):
        raise ValueError(f"valign must be 'top' or 'center', got {valign!r}")
    options = (options or StitchOptions()).validate()
    if options.merge_overlap:
        raise ValueError("merge_overlap composes with strips, not grids; "
                         "trim overlaps first (ops.overlap.detect_trims)")
    config = (config or RuntimeConfig()).validate()
    if limits is None:
        limits = config.limits          # explicit arg overrides the config
    t0 = _time.perf_counter()
    images, specs, failures = prepare(items, config, on_error, progress)
    prepare_s = _time.perf_counter() - t0
    if not images:
        if failures:
            raise RuntimeError(
                f"all {len(failures)} images failed to prepare; "
                f"first: {failures[0][1]!r}")
        raise ValueError("no images to stitch")
    from .core import geometry
    disp = []
    for img, s in zip(images, specs):
        # _as_uint8 flattens LA/RGBA onto white and guarantees C in {1, 3};
        # grid assembly is RGB-only, so grayscale promotes here
        a = geometry.orient_array(_as_uint8(img), s.orientation)
        if a.shape[2] == 1:
            a = np.repeat(a, 3, axis=2)
        disp.append(a)
    d_specs = [ImageSpec(a.shape[1], a.shape[0]) for a in disp]
    gplan = plan_grid(d_specs, cols, options, limits, order)
    log = get_logger()
    log.event("stitch.grid", canvas=(gplan.canvas_w, gplan.canvas_h),
              cols=gplan.cols, col_width=gplan.col_width, n=len(disp),
              scale_down=gplan.scale_down)

    from .runtime import pipeline
    canvas = np.empty((gplan.canvas_h, gplan.canvas_w, 3), np.uint8)
    canvas[:] = np.asarray(gplan.background, np.uint8)
    agg = pipeline.StitchMetrics(strategy="grid", prepare_s=prepare_s,
                                 canvas_w=gplan.canvas_w,
                                 canvas_h=gplan.canvas_h)
    gap_px = int(_js_round(gplan.gap))
    x = 0
    strategies = []
    for k, (idx_list, plan) in enumerate(zip(gplan.columns,
                                             gplan.col_plans)):
        col_imgs = [disp[i] for i in idx_list]
        out, m = pipeline.run(plan, col_imgs, config,
                              progress=lambda ph, f, _k=k: progress(
                                  "grid", (_k + f) / gplan.cols))
        out = np.asarray(out)
        y = ((gplan.canvas_h - out.shape[0]) // 2 if valign == "center"
             else 0)
        canvas[y:y + out.shape[0], x:x + out.shape[1]] = out
        x += gplan.col_width + gap_px
        strategies.append(m.strategy)
        for f in ("layout_s", "compute_s", "readback_s", "total_s",
                  "stage_wait_s", "h2d_bytes"):
            setattr(agg, f, getattr(agg, f) + getattr(m, f))
        agg.est_peak_bytes = max(agg.est_peak_bytes, m.est_peak_bytes)
        agg.stage_wait_max_s = max(agg.stage_wait_max_s, m.stage_wait_max_s)
    agg.strategy = "grid(" + ",".join(strategies) + ")"
    agg.total_s += prepare_s
    log.event("stitch.grid.done", shape=tuple(canvas.shape))
    return (canvas, agg) if return_metrics else canvas


def preview_size(width: int, height: int, box_w: int,
                 min_height: int = 180) -> Tuple[int, int]:
    """Fit-to-width preview dims with a minimum height.

    The ``calcPreviewHeight`` analog (utils/canvas.js:124-128): preview height
    follows the aspect ratio at the box width, floored at 180 px.  The
    reference keeps the height as a fractional CSS px; a raster preview
    needs an integer, so we round half-up (``Math.round``) like every other
    rounding in the layout contract (core.layout._js_round) — Python's
    banker's ``round`` would diverge by a full row at exact .5 ratios.
    """
    from .core.layout import _js_round
    h = max(min_height, _js_round(box_w * height / max(1, width)))
    return box_w, h


def make_preview(image: np.ndarray, box_w: int,
                 min_height: int = 180, device: bool = True) -> np.ndarray:
    """Downscaled preview of a stitched strip (reference preview draw,
    pages/index/index.js:1593-1609), using the same bilinear contract.

    Runs on device by default — a 100+ MP strip previews in milliseconds and
    only the preview-sized result crosses back to the host; ``device=False``
    forces the float64 host (oracle) path.
    """
    if not is_device_array(image):
        # normalize BEFORE the device/host split: LA/RGBA flattens onto
        # white on both paths (a host-fallback-only flatten would make the
        # preview's channel count depend on backend health).  Device-array
        # inputs are framework outputs, already 1/3-channel.
        image = _as_uint8(np.asarray(image))
    h, w = (image.shape[0], image.shape[1])
    pw, ph = preview_size(w, h, box_w, min_height)
    if device:
        try:
            return np.asarray(_device_resize(image, ph, pw))
        except Exception as e:  # noqa: BLE001 — host fallback ladder
            get_logger().once("preview.host_fallback", error=repr(e))
    image = _as_uint8(np.asarray(image))
    from .core import oracle as _o
    rows = _o.resample_axis(image.astype(np.float64), 0, 0, ph, 0.0, float(ph))
    full = _o.resample_axis(rows, 1, 0, pw, 0.0, float(pw))
    return _oracle.to_uint8(full)


_resize_jit = None


def _device_resize(image, ph: int, pw: int):
    """Jitted bilinear resize with the engine's tap contract (f32 on device).

    One module-level jit, cached by jax per (input, output) shape class; taps
    are runtime args so fractional scale changes never recompile.
    """
    global _resize_jit
    import jax
    import jax.numpy as jnp

    from .core import geometry
    from .ops import xla_compose

    if _resize_jit is None:
        def fn(img, ri0, rw, ci0, cw):
            x = img.astype(jnp.float32)
            x = xla_compose._ktap(x, {"i0": ri0, "w": rw}, 0)
            x = xla_compose._ktap(x, {"i0": ci0, "w": cw}, 1)
            return xla_compose.to_uint8(x)
        _resize_jit = jax.jit(fn)

    h, w = image.shape[0], image.shape[1]
    ri0, rw = geometry.filter_taps(0, ph, 0.0, float(ph), h, "bilinear")
    ci0, cw = geometry.filter_taps(0, pw, 0.0, float(pw), w, "bilinear")
    return _resize_jit(image if is_device_array(image) else jnp.asarray(image),
                       jnp.asarray(ri0), jnp.asarray(rw.astype(np.float32)),
                       jnp.asarray(ci0), jnp.asarray(cw.astype(np.float32)))
