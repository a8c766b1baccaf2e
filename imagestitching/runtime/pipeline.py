"""The stitch pipeline: prepare -> stage -> composite -> readback -> encode.

This is the L4 orchestrator (SURVEY.md §1): what ``onStitch``
(pages/index/index.js:1186-1633) does with progress phases, caches, flush
hacks and fallback ladders becomes an explicit pipeline with:

* a host decode pool (replacing serialized decodes, index.js:1125-1157),
* the HBM budget governor picking resident/streamed/banded execution
  (:mod:`.tiler`, replacing canvas caps + big-task mode),
* async H2D staging that overlaps the next image's upload with the current
  kernel (replacing the bitmap cache's load-ahead role, index.js:534-627),
* canvas donation between streamed updates (replacing the 1x1 getImageData
  flush + bmp.close() dance, index.js:1560-1571),
* per-phase wall-clock metrics feeding MP/s (the jax.profiler-friendly
  observability the reference's timing console.logs approximate).

Progress fractions mirror the reference's schedule: prepare 0.01-0.25,
layout 0.30, composite 0.30-0.90, export 0.96, done 1.0
(index.js:1193,1247,1358,1556-1557,1581,1611).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RuntimeConfig
from ..core import geometry, oracle
from ..core.layout import LayoutPlan
from ..ops import xla_compose
from . import tiler
from .logger import get_logger

ProgressFn = Callable[[str, float], None]


@dataclasses.dataclass
class StitchMetrics:
    """Per-phase wall clock + throughput for one job."""

    strategy: str = "resident"
    prepare_s: float = 0.0
    layout_s: float = 0.0
    compute_s: float = 0.0
    readback_s: float = 0.0
    encode_s: float = 0.0     # busy time in the file encoder (export paths)
    export_s: float = 0.0     # wall time of readback+encode; < readback_s +
                              # encode_s when the streaming overlap engages
    total_s: float = 0.0
    # host<->device round trip measured on the idle device at job start
    # (overlapped path): compute_s includes one such round trip, so it is
    # recorded separately to keep "device drain" numbers attributable.
    transport_rtt_s: float = 0.0
    # Host wall spent *blocked* in the per-image staging calls
    # (jnp.asarray H2D + compute enqueue) inside the overlapped decode
    # loop.  Enqueue is nominally async, so these should be ~0; when the
    # transfer queue backpressures (slow H2D) the block shows up here
    # instead of in compute_s — stage_wait_s ~ 0 with a large compute_s
    # means a genuine device drain, stage_wait_s large means transfer, and
    # stage_wait_max_s tells one slow image from a uniformly slow link.
    # Caveat: a cold shape class compiles inside the staging call, so
    # first-run stage_wait includes compile time — only warm-cache runs
    # attribute cleanly.
    stage_wait_s: float = 0.0
    stage_wait_max_s: float = 0.0
    h2d_bytes: int = 0
    canvas_w: int = 0
    canvas_h: int = 0
    est_peak_bytes: int = 0

    @property
    def out_megapixels(self) -> float:
        return self.canvas_w * self.canvas_h / 1e6

    @property
    def mp_per_sec(self) -> float:
        return self.out_megapixels / self.total_s if self.total_s else 0.0


def _noop(phase: str, fraction: float) -> None:
    del phase, fraction


# ---------------------------------------------------------------------------
# Streamed execution (canvas persists, donated between per-image updates)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _copy_update_exe(canvas_shape, src_shape, window_shape, orientation):
    """Shape-keyed blit executable: offsets are runtime args, so all
    same-shaped copy placements share ONE compile (a 9-equal-image job
    compiles once, not nine times)."""
    def fn(canvas, raw, offs):
        src = xla_compose.orient_jnp(raw, orientation)
        window = jax.lax.dynamic_slice(
            src, (offs[0], offs[1], 0), window_shape)
        return jax.lax.dynamic_update_slice(
            canvas, window, (offs[2], offs[3], 0))
    return jax.jit(fn, donate_argnums=(0,))


_ktap_axis = xla_compose.ktap_axis


@functools.lru_cache(maxsize=256)
def _resample_update_exe(canvas_shape, src_shape, region_shape, orientation):
    """Shape-keyed resample-and-place executable (XLA K-tap engine).

    Taps and the destination offset arrive as runtime arguments, so every
    placement with the same (source shape, region shape, orientation, K)
    shares ONE compile regardless of its position or exact scale.
    """
    def fn(canvas, raw, offs, taps):
        img = xla_compose.orient_jnp(raw, orientation).astype(jnp.float32)
        ri0, rw, ci0, cw = taps
        img = _ktap_axis(img, ri0, rw, 0)
        img = _ktap_axis(img, ci0, cw, 1)
        region = xla_compose.to_uint8(img)
        return jax.lax.dynamic_update_slice(
            canvas, region, (offs[0], offs[1], 0))
    return jax.jit(fn, donate_argnums=(0,))


def _streamed_update(plan, index: int, channels: int, canvas, src):
    """Apply placement ``index`` to the donated canvas (shape-keyed exes).

    Copy placements blit; resampled placements run the XLA K-tap
    executables — one compile per shape class either way.
    """
    p = plan.placements[index]
    copy_off = geometry.placement_copy_offsets(p, plan.filter)
    nr = p.row_span[1] - p.row_span[0]
    nc = p.col_span[1] - p.col_span[0]
    if copy_off is not None:
        exe = _copy_update_exe(canvas.shape, src.shape,
                               (nr, nc, channels), p.orientation)
        offs = jnp.asarray([copy_off[0], copy_off[1],
                            p.row_span[0], p.col_span[0]], jnp.int32)
        return exe(canvas, src, offs)
    disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    ri0, rw = geometry.filter_taps(*p.row_span, p.y0, p.h, disp_h,
                                   plan.filter)
    ci0, cw = geometry.filter_taps(*p.col_span, p.x0, p.w, disp_w,
                                   plan.filter)
    exe = _resample_update_exe(canvas.shape, src.shape, (nr, nc, channels),
                               p.orientation)
    offs = jnp.asarray([p.row_span[0], p.col_span[0]], jnp.int32)
    taps = (jnp.asarray(ri0), jnp.asarray(rw.astype(np.float32)),
            jnp.asarray(ci0), jnp.asarray(cw.astype(np.float32)))
    return exe(canvas, src, offs, taps)


def _fence_limit(plan: LayoutPlan, channels: int,
                 config: RuntimeConfig) -> int:
    """Staged-but-unfenced byte budget for the streamed paths.

    Half the budget headroom above the canvas, floored at 8 MB so ordinary
    jobs don't pay a fence (= one host<->device round trip) per small
    image — but the floor is itself capped at the headroom: a
    64 MB unconditional floor used to let staged sources pile PAST a tight
    budget in exactly the regime the fence exists to bound (r4s9 review).
    Zero headroom fences after every image, which is always safe (the
    update is already enqueued when the fence fires).
    """
    headroom = max(0, config.budget.hbm_bytes
                   - plan.canvas_h * plan.canvas_w * channels)
    return max(min(8 << 20, headroom), headroom // 2)


def _run_streamed(plan: LayoutPlan, images: Sequence[np.ndarray],
                  channels: int, config: RuntimeConfig,
                  progress: ProgressFn,
                  keep_on_device: bool = False) -> np.ndarray:
    bg = np.asarray(plan.background[:channels], np.uint8)
    canvas = jnp.broadcast_to(
        jnp.asarray(bg), (plan.canvas_h, plan.canvas_w, channels))
    canvas = jnp.array(canvas)  # materialize so it is donatable

    # async staging: upload image i+1 while image i computes.  Uploads and
    # updates ENQUEUE without blocking, so staged sources can pile up in
    # HBM faster than the device consumes them (r4s7 review; the tiler's
    # streamed model assumes a bounded window) — once staged-but-unfenced
    # bytes exceed the canvas' budget headroom, one tiny data-dependent
    # fetch drains the queue and frees the consumed sources.
    fence_limit = _fence_limit(plan, channels, config)
    inflight = 0
    staged = jnp.asarray(images[0]) if images else None
    n = len(images)
    for i in range(n):
        src = staged
        if i + 1 < n:
            staged = jnp.asarray(images[i + 1])  # async H2D
        p = plan.placements[i]
        if p.row_span[1] > p.row_span[0] and p.col_span[1] > p.col_span[0]:
            canvas = _streamed_update(plan, i, channels, canvas, src)
            inflight += images[i].nbytes
            if inflight > fence_limit:
                np.asarray(jax.device_get(canvas[:1, :1, :1]))
                inflight = 0
        progress("composite", 0.30 + 0.60 * (i + 1) / n)
    return canvas if keep_on_device else np.asarray(canvas)


# ---------------------------------------------------------------------------
# Banded execution (canvas never fully materializes on device)
# ---------------------------------------------------------------------------

class _BandedExecutor:
    """Composites the canvas in fixed-height row bands.

    For each band, every overlapping image contributes a host-cropped row
    window of its (oriented) pixels; per-band row taps are rebased to the
    crop and shipped as arguments, so ONE compiled program serves all bands.
    Column taps are band-invariant constants.
    """

    def __init__(self, plan: LayoutPlan, band_rows: int, channels: int):
        self.plan = plan
        self.band = band_rows
        self.channels = channels
        # per image: full-axis row taps (windows sliced per band) + fixed
        # worst-case crop height, and band-invariant column taps
        self.crop_rows: List[int] = []
        self.row_taps = []
        self.col_taps = []
        for p in plan.placements:
            disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                                   p.orientation)
            r0, r1 = p.row_span
            c0, c1 = p.col_span
            if c1 <= c0 or r1 <= r0:
                self.row_taps.append(None)
                self.col_taps.append(None)
                self.crop_rows.append(1)
                continue
            ri0, rw = geometry.filter_taps(r0, r1, p.y0, p.h, disp_h,
                                           plan.filter)
            ci0, cw = geometry.filter_taps(c0, c1, p.x0, p.w, disp_w,
                                           plan.filter)
            k_rows = rw.shape[1]
            # widest window any CANVAS-aligned band can need: bands start at
            # multiples of band_rows in canvas space, not at the image's
            # span start, so iterate the actual band intersections (a
            # span-aligned grouping undercovers wide-K filters at band
            # boundaries — caught by the lanczos3 soak)
            need = k_rows
            for lo, hi in tiler.band_ranges(plan, band_rows):
                br0, br1 = max(r0, lo), min(r1, hi)
                if br1 <= br0:
                    continue
                need = max(need, int(ri0[br1 - 1 - r0]) + k_rows
                           - int(ri0[br0 - r0]))
            self.crop_rows.append(min(disp_h, need))
            self.row_taps.append({"i0": ri0, "w": rw.astype(np.float32)})
            self.col_taps.append({"i0": ci0.astype(np.int32),
                                  "w": cw.astype(np.float32)})
        # Column taps are band-invariant but must NOT be baked into the
        # jitted program as closure constants: wide-K downscales make them
        # (canvas_w x K) f32 per image, and closure constants serialize
        # into the remote compile payload (CLAUDE.md: HTTP 413 at ~300 MB).
        # Uploaded ONCE here, then passed as (device-resident) jit args —
        # no per-band re-transfer, no compile-payload bloat.
        self._col_i0_dev = [jnp.asarray(ct["i0"]) if ct is not None
                            else jnp.zeros((1,), jnp.int32)
                            for ct in self.col_taps]
        self._col_w_dev = [jnp.asarray(ct["w"]) if ct is not None
                           else jnp.zeros((1, 1), jnp.float32)
                           for ct in self.col_taps]
        # non-intersecting (band, image) pairs feed a constant zero crop:
        # cache one device-resident buffer per image instead of faulting a
        # fresh host np.zeros + H2D per band (~90% of pairs on tall jobs)
        self._zero_crops: dict = {}
        self._jitted = jax.jit(self._compose)

    def _zero_crop(self, idx: int, shape) -> "jnp.ndarray":
        z = self._zero_crops.get(idx)
        if z is None or z.shape != shape:
            z = jnp.zeros(shape, jnp.uint8)
            self._zero_crops[idx] = z
        return z

    def _compose(self, crops, rows_i0, rows_w, rows_in, cols_i0, cols_w):
        plan, band, channels = self.plan, self.band, self.channels
        bg = jnp.asarray(plan.background[:channels], jnp.float32)
        canvas = jnp.broadcast_to(bg, (band, plan.canvas_w, channels))
        for idx, p in enumerate(plan.placements):
            tp = self.col_taps[idx]
            if tp is None:
                continue
            crop = crops[idx].astype(jnp.float32)
            rows = _ktap_axis(crop, rows_i0[idx], rows_w[idx], 0)
            full = _ktap_axis(rows, cols_i0[idx], cols_w[idx], 1)
            c0, c1 = p.col_span
            region = jax.lax.dynamic_update_slice(
                jnp.zeros((band, plan.canvas_w, channels), jnp.float32),
                full, (0, c0, 0))
            in_rows = rows_in[idx][:, None, None]
            col_ids = jax.lax.broadcasted_iota(
                jnp.int32, (1, plan.canvas_w, 1), 1)
            in_cols = ((col_ids >= c0) & (col_ids < c1)).astype(jnp.float32)
            mask = in_rows * in_cols
            canvas = canvas * (1.0 - mask) + region * mask
        return xla_compose.to_uint8(canvas)

    def run(self, oriented_images: Sequence[np.ndarray],
            progress: ProgressFn = _noop) -> np.ndarray:
        plan, band = self.plan, self.band
        out = np.empty((plan.canvas_h, plan.canvas_w, self.channels),
                       np.uint8)
        bands = tiler.band_ranges(plan, band)
        for bi, (lo, hi) in enumerate(bands):
            crops, r_i0, r_w, r_in = [], [], [], []
            for idx, p in enumerate(plan.placements):
                need = self.crop_rows[idx]
                img = oriented_images[idx]
                disp_h = img.shape[0]
                tp = self.row_taps[idx]
                k = tp["w"].shape[1] if tp is not None else 1
                i0 = np.zeros((band,), np.int32)
                w = np.zeros((band, k), np.float32)
                inb = np.zeros((band,), np.float32)
                r0, r1 = p.row_span
                br0, br1 = max(r0, lo), min(r1, hi)
                if tp is None or br1 <= br0:
                    crops.append(self._zero_crop(
                        idx, (need,) + img.shape[1:]))
                else:
                    # slice this band's windows from the full-axis taps
                    ri0 = tp["i0"][br0 - r0: br1 - r0]
                    rw = tp["w"][br0 - r0: br1 - r0]
                    s_lo = min(int(ri0[0]), max(0, disp_h - need))
                    crop = img[s_lo: s_lo + need]
                    if crop.shape[0] < need:      # short image
                        crop = np.pad(crop, ((0, need - crop.shape[0]),
                                             (0, 0), (0, 0)))
                    i0[br0 - lo: br1 - lo] = np.minimum(ri0 - s_lo, need - 1)
                    w[br0 - lo: br1 - lo] = rw
                    inb[br0 - lo: br1 - lo] = 1.0
                    crops.append(np.ascontiguousarray(crop))
                r_i0.append(i0)
                r_w.append(w)
                r_in.append(inb)
            band_out = np.asarray(self._jitted(
                [jnp.asarray(c) for c in crops],
                [jnp.asarray(x) for x in r_i0],
                [jnp.asarray(x) for x in r_w],
                [jnp.asarray(x) for x in r_in],
                self._col_i0_dev, self._col_w_dev))
            out[lo:hi] = band_out[: hi - lo]
            progress("composite", 0.30 + 0.60 * (bi + 1) / len(bands))
        return out


def _run_banded(plan: LayoutPlan, images: Sequence[np.ndarray],
                channels: int, band_rows: int,
                progress: ProgressFn) -> np.ndarray:
    oriented = [geometry.orient_array(np.asarray(img), p.orientation)
                for img, p in zip(images, plan.placements)]
    return _BandedExecutor(plan, band_rows, channels).run(oriented, progress)


# ---------------------------------------------------------------------------
# Overlapped execution: decode || H2D || compute
# ---------------------------------------------------------------------------


class _Profile:
    """Exception-safe jax.profiler trace: stop() is idempotent and MUST run
    on every exit path, or the process-global profiler stays started and
    every later profiled run raises 'Profile has already been started'."""

    def __init__(self, enabled: bool):
        self._ctx = None
        if enabled:
            trace_dir = os.environ.get("IMAGESTITCH_TRACE_DIR",
                                       "/tmp/imagestitching_trace")
            self._ctx = jax.profiler.trace(trace_dir)
            self._ctx.__enter__()

    def stop(self) -> None:
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(None, None, None)


def run_overlapped(plan: LayoutPlan, loaders, config: RuntimeConfig,
                   progress: ProgressFn = _noop,
                   keep_on_device: bool = False,
                   ) -> Tuple[np.ndarray, StitchMetrics]:
    """Streamed composite that overlaps host decode with device compute.

    ``loaders[i]()`` must return image i's raw uint8 HWC array (decode +
    normalize).  The layout is already solved from header metadata, so
    compositing starts as soon as the FIRST decode lands instead of the last
    — the answer to the reference's decode-then-draw serialization
    (pages/index/index.js:1439-1572).  Placements are independent, so images
    are placed in completion order; the canvas is donated between updates.

    The path runs under the same budget governor and OOM demotion ladder as
    :func:`run` (big jobs are exactly the ones that need it): if the plan or
    an actual OOM demands it, compositing demotes to the banded executor —
    decoded arrays are retained on host so the retry never re-decodes.

    Raises on any decode failure (including the watchdog's TimeoutError): by
    stitch time geometry is committed, the reference aborts there too
    (index.js:1507-1509).
    """
    config = config.validate()
    log = get_logger()
    m = StitchMetrics(canvas_w=plan.canvas_w, canvas_h=plan.canvas_h,
                      strategy="overlapped")
    t_start = time.perf_counter()
    channels = 3
    n = len(loaders)

    ex = tiler.plan_execution(plan, config.budget, channels)
    m.est_peak_bytes = ex.est_peak_bytes
    log.event("pipeline.plan", strategy=f"overlapped/{ex.strategy}",
              est_peak_mb=round(ex.est_peak_bytes / 1e6, 1),
              budget_mb=round(ex.budget_bytes / 1e6, 1),
              canvas=(plan.canvas_w, plan.canvas_h))

    prof = _Profile(config.profile)
    try:
        return _run_overlapped_body(plan, loaders, config, progress, m,
                                    ex, log, t_start, channels, n,
                                    keep_on_device)
    finally:
        prof.stop()


# Per-process cache for the idle-device transport round-trip probe: the
# rtt is an environment property, not a per-job one, so steady-state
# serving pays a probe at most once per TTL rather than per job.  A probe
# refreshed while the device happens to be busy overcounts (it queues
# behind in-flight work) — acceptable for an attribution metric.
_RTT_TTL_S = 300.0
_rtt_cache = {"at": float("-inf"), "rtt": 0.0}


def _transport_rtt() -> float:
    now = time.monotonic()
    if now - _rtt_cache["at"] > _RTT_TTL_S:
        t0 = time.perf_counter()
        np.asarray(jax.device_get(jnp.zeros((1,), jnp.uint8)))
        _rtt_cache["at"] = now
        _rtt_cache["rtt"] = time.perf_counter() - t0
    return _rtt_cache["rtt"]


def _run_overlapped_body(plan, loaders, config, progress, m, ex, log,
                         t_start, channels, n, keep_on_device=False):
    from . import decoding

    def _checked(i: int, raw: np.ndarray) -> np.ndarray:
        p = plan.placements[i]
        if raw.shape[:2] != (p.raw_h, p.raw_w):
            raise ValueError(
                f"image {i}: decoded {raw.shape[1]}x{raw.shape[0]} but "
                f"header said {p.raw_w}x{p.raw_h}")
        return raw

    # Host copies are kept only until an image is safely composited (or for
    # the banded path, which needs them); an OOM retry re-decodes the
    # already-released ones instead of pinning ~GBs of raw arrays for the
    # whole job.
    decoded: List[Optional[np.ndarray]] = [None] * n
    composited: List[bool] = [False] * n
    stream_ok = ex.strategy in ("resident", "streamed")
    canvas = None
    oom = None
    if stream_ok:
        bg = np.asarray(plan.background[:channels], np.uint8)
        try:
            canvas = jnp.array(jnp.broadcast_to(
                jnp.asarray(bg), (plan.canvas_h, plan.canvas_w, channels)))
        except Exception as e:  # noqa: BLE001 — OOM classification
            if not _is_oom(e):
                raise
            oom = e   # canvas itself doesn't fit: decode-and-retain, banded
            log.event("pipeline.oom_retry", failed="overlapped-alloc",
                      band=None)
    # Staged-source fence: jnp.asarray + update ENQUEUE without blocking, so
    # when decode outpaces the device the sources pile up in HBM unbounded
    # (r4s7 review; the tiler's streamed model assumes a bounded window).
    # Once staged-but-unfenced bytes exceed the canvas' budget headroom, one
    # tiny data-dependent fetch drains the queue and frees consumed sources.
    fence_limit = _fence_limit(plan, channels, config)
    inflight = 0

    gen = decoding.iter_decoded(loaders, config.decode_threads,
                                config.decode_timeout_s)
    done = 0
    t_decode = 0.0
    try:
        if stream_ok:
            # the transport round trip this job will pay once inside
            # compute_s at drain; probed AFTER the decode pool starts so
            # it rides under the first decode (cached per process — see
            # _transport_rtt — so steady-state serving pays nothing)
            m.transport_rtt_s = _transport_rtt()
        for i, raw, err in gen:
            if err is not None:
                log.event("pipeline.overlapped_decode_fail", index=i,
                          error=repr(err))
                raise err
            raw = _checked(i, np.asarray(raw))
            decoded[i] = raw
            t_decode = max(t_decode, time.perf_counter() - t_start)
            p = plan.placements[i]
            if (canvas is not None and oom is None
                    and p.row_span[1] > p.row_span[0]
                    and p.col_span[1] > p.col_span[0]):
                try:
                    t_stage = time.perf_counter()
                    src = jnp.asarray(raw)      # async H2D
                    canvas = _streamed_update(plan, i, channels, canvas,
                                              src)
                    inflight += raw.nbytes
                    if inflight > fence_limit:
                        np.asarray(jax.device_get(canvas[:1, :1, :1]))
                        inflight = 0
                    t_stage = time.perf_counter() - t_stage
                    m.stage_wait_s += t_stage
                    m.stage_wait_max_s = max(m.stage_wait_max_s, t_stage)
                    m.h2d_bytes += raw.nbytes
                    composited[i] = True
                    decoded[i] = None   # composited: release host copy
                except Exception as e:  # noqa: BLE001 — OOM classify
                    if not _is_oom(e):
                        raise
                    oom = e
                    canvas = None   # free the device canvas before retry
                    log.event("pipeline.oom_retry", failed="overlapped",
                              band=None)
            done += 1
            progress("composite", 0.30 + 0.60 * done / n)
    finally:
        # an error anywhere above (probe, decode, composite) must not
        # leave the eagerly-started workers decoding the rest of the job
        gen.close()
    m.prepare_s = t_decode

    t_drain = time.perf_counter()
    out = None
    if canvas is not None and oom is None:
        # compute_s = device drain exposed after the last decode (work that
        # ran *under* decode is genuinely overlapped and costs no wall
        # time).  block_until_ready returns at enqueue on some transports,
        # so force completion with a data-dependent 1-element fetch; it
        # overcounts compute by one transfer round trip.
        try:
            np.asarray(jax.device_get(canvas[:1, :1, :1]))
            m.compute_s = time.perf_counter() - t_drain
            if keep_on_device:
                out = canvas  # caller streams the readback (export overlap)
            else:
                t0 = time.perf_counter()
                out = np.asarray(canvas)
                m.readback_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — OOM classification
            # On the async transport an update's RESOURCE_EXHAUSTED can
            # first surface HERE (enqueue never blocked in the loop above);
            # classify it like the per-iteration handler so the banded
            # retry below still runs (r4s7 review).
            if not _is_oom(e):
                raise
            oom = e
            canvas = None
            log.event("pipeline.oom_retry", failed="overlapped-drain",
                      band=None)
    if out is None:
        # re-decode images released after successful streamed updates (rare
        # path: only reached when an OOM forces the banded retry)
        missing = [i for i in range(n) if decoded[i] is None
                   and composited[i]]
        if missing:
            log.event("pipeline.oom_redecode", n=len(missing))
            gen2 = decoding.iter_decoded(
                [loaders[j] for j in missing], config.decode_threads,
                config.decode_timeout_s)
            try:
                for k, raw2, err2 in gen2:
                    if err2 is not None:
                        raise err2
                    decoded[missing[k]] = _checked(missing[k],
                                                   np.asarray(raw2))
            finally:
                gen2.close()   # a failed redecode must cancel the workers
        # demotion ladder: banded compositing from the retained host arrays
        out = None
        for band in _banded_bands(ex, plan):
            try:
                out = _run_banded(plan, decoded, channels, band, progress)
                break
            except Exception as e:  # noqa: BLE001 — OOM classification
                if not _is_oom(e):
                    raise
                oom = e
                log.event("pipeline.oom_retry", failed="banded", band=band)
        if out is None:
            raise MemoryError(
                "overlapped stitch ran out of device memory on every "
                "strategy") from oom
        m.strategy = "overlapped/banded"
        m.compute_s = time.perf_counter() - t_drain
    m.total_s = time.perf_counter() - t_start
    log.event("pipeline.overlapped_done", n=n, strategy=m.strategy,
              total_s=round(m.total_s, 4),
              decode_wall_s=round(m.prepare_s, 4),
              compute_s=round(m.compute_s, 4),
              transport_rtt_s=round(m.transport_rtt_s, 4),
              stage_wait_s=round(m.stage_wait_s, 4),
              stage_wait_max_s=round(m.stage_wait_max_s, 4),
              h2d_mb=round(m.h2d_bytes / 1e6, 1),
              readback_s=round(m.readback_s, 4),
              mp_per_sec=round(m.mp_per_sec, 1))
    progress("composite", 1.0)
    return out, m


# ---------------------------------------------------------------------------
# Pipeline front door
# ---------------------------------------------------------------------------

# Wordings PJRT/XLA use for allocator exhaustion across backends — the
# structured absl status code does not survive into the Python exception
# (jaxlib renders it as the message prefix), so classification is
# type-first (MemoryError / RuntimeError, which JaxRuntimeError and
# XlaRuntimeError subclass) + status-prefix, with phrase matching as the
# fallback.  A phrasing miss would silently disable the whole elastic-
# recovery ladder (VERDICT r2 weak #3), so the list is deliberately broad;
# restricting to runtime-error types keeps programming errors (ValueError
# etc.) from ever demoting.
_OOM_STATUS_PREFIXES = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED")
_OOM_PHRASES = ("resource_exhausted", "out of memory", "ran out of memory",
                "allocation failure", "failed to allocate",
                "cannot allocate", "could not allocate", "memory exhausted",
                "exceeds the memory capacity", "insufficient memory",
                "oom while")


def _is_oom(e: Exception) -> bool:
    if isinstance(e, MemoryError):
        return True
    # XlaRuntimeError/JaxRuntimeError subclass RuntimeError in current jax,
    # but that has moved across versions — also accept the known names so a
    # backend re-parenting its exception type cannot silently disable the
    # whole elastic-recovery ladder (phrase fallback stays reachable).
    if not isinstance(e, RuntimeError) and type(e).__name__ not in (
            "XlaRuntimeError", "JaxRuntimeError"):
        return False
    msg = str(e)
    if msg.lstrip().upper().startswith(_OOM_STATUS_PREFIXES):
        return True
    low = msg.lower()
    return any(p in low for p in _OOM_PHRASES)


def _banded_bands(ex: "tiler.ExecutionPlan", plan: LayoutPlan):
    """Band heights for the banded demotion attempts, largest first.

    Floored at the canvas height: a 6-row canvas must still get its banded
    attempt (an empty ladder here used to surface as a bogus "out of memory
    on every strategy").  Shared by the front-door and overlapped ladders
    so the floors can't drift apart again.
    """
    band = ex.band_rows or min(plan.canvas_h, 2048)
    floor = max(1, min(8, plan.canvas_h))
    bands = []
    while band >= floor:
        bands.append(band)
        band //= 4
    return bands


def _strategy_ladder(ex: "tiler.ExecutionPlan", plan: LayoutPlan):
    """(strategy, band_rows) attempts, leanest-last, starting at the plan's."""
    order = ["resident", "streamed", "banded"]
    if ex.strategy == "oracle":
        return [("oracle", None)]
    ladder = []
    started = False
    for s in order:
        if s == ex.strategy:
            started = True
        if not started:
            continue
        if s == "banded":
            ladder.extend(("banded", band)
                          for band in _banded_bands(ex, plan))
        else:
            ladder.append((s, None))
    return ladder


def choose_engine(plan: LayoutPlan, config: RuntimeConfig,
                  channels: int = 3, keep_on_device: bool = False):
    """The one engine decision, made from the config and the plan.

    Returns ``(engine, copies)``:

    * ``("oracle", None)`` when the config asks for the float64 reference;
    * ``("host-blit", copies)`` for ``engine="auto"`` on one device with a
      host result, when every drawn placement is an identity copy
      (equal-size concat — the reference's own hot path,
      index.js:1423-1431): the canvas is sources + background, and
      memcpys beat any H2D -> compose -> D2H round trip.  ``copies`` maps
      placement index -> source offset (:func:`geometry.plan_copy_offsets`);
    * ``("xla", None)`` otherwise: the XLA gather engine on the default
      backend, under the budget governor's strategy ladder.
    """
    if config.engine == "oracle":
        return "oracle", None
    if (config.engine == "auto" and config.mesh is None
            and not keep_on_device and channels == 3):
        copies = geometry.plan_copy_offsets(plan)
        if copies is not None:
            return "host-blit", copies
    return "xla", None


def run(plan: LayoutPlan, images: Sequence[np.ndarray],
        config: Optional[RuntimeConfig] = None,
        progress: ProgressFn = _noop,
        keep_on_device: bool = False,
        ) -> Tuple[np.ndarray, StitchMetrics]:
    """Execute one solved stitch job under the configured budget.

    ``keep_on_device=True`` skips the final device->host readback when the
    winning strategy leaves the canvas device-resident (resident/streamed):
    the returned array is then a ``jax.Array`` for the caller to stream or
    keep processing on device.  Banded/oracle strategies composite on the
    host and return numpy either way.
    """
    config = (config or RuntimeConfig()).validate()
    log = get_logger()
    m = StitchMetrics(canvas_w=plan.canvas_w, canvas_h=plan.canvas_h)
    t_start = time.perf_counter()

    channels = 3
    if images:
        a0 = np.asarray(images[0])
        channels = a0.shape[2] if a0.ndim == 3 else 1

    engine, copies = choose_engine(plan, config, channels, keep_on_device)
    out = _host_blit(plan, images, copies) if engine == "host-blit" else None
    if out is not None:
        m.strategy = "host-blit"
        m.compute_s = time.perf_counter() - t_start
        m.total_s = time.perf_counter() - t_start
        log.event("pipeline.done", strategy=m.strategy,
                  compute_s=round(m.compute_s, 4),
                  mp_per_sec=round(m.mp_per_sec, 1))
        progress("layout", 1.0)
        progress("composite", 1.0)
        return out, m

    if engine == "oracle":
        ex = tiler.ExecutionPlan("oracle", 0, config.budget.hbm_bytes)
    else:
        ex = tiler.plan_execution(plan, config.budget, channels)
    m.strategy = ex.strategy
    m.est_peak_bytes = ex.est_peak_bytes
    log.event("pipeline.plan", strategy=ex.strategy,
              est_peak_mb=round(ex.est_peak_bytes / 1e6, 1),
              budget_mb=round(ex.budget_bytes / 1e6, 1),
              canvas=(plan.canvas_w, plan.canvas_h))
    progress("layout", 1.0)

    prof = _Profile(config.profile)
    try:
        return _run_body(plan, images, config, progress, m, ex, log,
                         t_start, channels, keep_on_device)
    finally:
        prof.stop()


def _host_blit(plan, images, copies) -> Optional[np.ndarray]:
    """Assemble a pure-blit canvas with memcpys (None -> caller falls back
    to the device path, e.g. on a shape/channel surprise)."""
    srcs = {}
    for p in plan.placements:       # validate before touching the canvas
        if p.index in copies:
            raw = geometry.normalize_rgb(images[p.index])
            if raw is None or raw.shape[:2] != (p.raw_h, p.raw_w):
                return None
            srcs[p.index] = raw
    canvas = np.empty((plan.canvas_h, plan.canvas_w, 3), np.uint8)
    # fill only what the pastes won't overwrite — on a gapless equal-size
    # strip that is nothing at all
    geometry.fill_uncovered(canvas, plan, copies, plan.background[:3])
    for p in plan.placements:
        if p.index in copies:
            geometry.paste_blit(
                canvas, p, geometry.orient_array(srcs[p.index],
                                                 p.orientation),
                copies[p.index])
    return canvas


def _run_body(plan, images, config, progress, m, ex, log, t_start,
              channels, keep_on_device=False):

    t0 = time.perf_counter()
    out = None
    last_oom = None

    mesh = config.mesh
    n_space = (getattr(mesh, "shape", {}).get("space", 1)
               if mesh is not None else 1)
    if (n_space > 1
            and tiler.sharded_peak_bytes(plan, n_space, channels)
            <= config.budget.hbm_bytes):
        # multi-device: shard this job's canvas row-bands over the space
        # axis (per-DEVICE byte accounting above: replicated sources + f32
        # band temporaries must fit each device's budget, else fall through
        # to the single-device strategy ladder)
        from ..parallel.sharding import ShardedStitch
        try:
            out = ShardedStitch(plan, mesh, channels)(images)
        except Exception as e:  # noqa: BLE001 — OOM classification
            if not _is_oom(e):
                raise
            # byte estimate admitted the mesh path but real execution
            # exhausted a device: recover on the single-chip ladder below
            # instead of failing a job banded execution would complete
            last_oom = e
            out = None
            log.event("pipeline.oom_retry", failed="space-sharded",
                      band=None)
        if out is not None:
            log.event("pipeline.space_sharded", shards=n_space)
            m.strategy = "space-sharded"
            m.compute_s = time.perf_counter() - t0
            m.total_s = time.perf_counter() - t_start
            log.event("pipeline.done", strategy=m.strategy,
                      compute_s=round(m.compute_s, 4),
                      mp_per_sec=round(m.mp_per_sec, 1))
            progress("composite", 1.0)
            return out, m
    elif n_space > 1:
        log.event("pipeline.sharded_budget_reject",
                  est_per_device_mb=round(
                      tiler.sharded_peak_bytes(plan, n_space, channels)
                      / 1e6, 1),
                  budget_mb=round(config.budget.hbm_bytes / 1e6, 1))

    for attempt_strategy, band in _strategy_ladder(ex, plan):
        try:
            if attempt_strategy == "oracle":
                out = oracle.stitch(plan, images)
            elif attempt_strategy == "resident":
                out = xla_compose.stitch(plan, images, device=keep_on_device)
            elif attempt_strategy == "streamed":
                out = _run_streamed(plan, images, channels, config, progress,
                                    keep_on_device)
            else:
                out = _run_banded(plan, images, channels, band, progress)
            if keep_on_device and out is not None \
                    and type(out).__module__.startswith("jax"):
                # dispatch is async: force execution with a 1-element fetch
                # so an OOM surfaces HERE, inside the demotion ladder, not
                # later at the caller's first use of the device canvas
                np.asarray(jax.device_get(out[:1, :1, :1]))
            m.strategy = attempt_strategy
            break
        except Exception as e:  # noqa: BLE001 — OOM classification below
            if not _is_oom(e):
                raise
            # Elastic recovery (the reference's graceful-degradation analog,
            # index.js:654-674): demote to a leaner strategy and retry.
            last_oom = e
            log.event("pipeline.oom_retry", failed=attempt_strategy,
                      band=band)
    if out is None:
        raise MemoryError(
            "stitch ran out of device memory on every strategy") from last_oom
    m.compute_s = time.perf_counter() - t0
    m.total_s = time.perf_counter() - t_start
    # m.strategy, not ex.strategy: after an OOM demotion the log must name
    # the strategy that actually won, matching the returned metrics
    log.event("pipeline.done", strategy=m.strategy,
              compute_s=round(m.compute_s, 4),
              mp_per_sec=round(m.mp_per_sec, 1))
    progress("composite", 1.0)
    return out, m
