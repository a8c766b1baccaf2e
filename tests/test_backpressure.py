"""Ack-window backpressure: unbounded-size blit jobs in O(window) RAM.

The reference bounds decoder memory by strictly serializing decodes with
per-item waits (pages/index/index.js:1125-1157,201-242).  The windowed
DecodePool is the parallel-pool equivalent; these tests measure *actual*
peak residency of decoded sources via weakref finalizers (refcount-exact
under CPython) — not just bookkeeping counters.
"""

import functools
import threading
import time
import weakref

import numpy as np
import pytest

from imagestitching.runtime import decoding


class _LiveTracker:
    """Counts live decoded arrays: +1 at creation, -1 at GC (finalizer)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live = 0
        self.peak = 0
        self.created = 0

    def make(self, shape, fill):
        arr = np.full(shape, fill, np.uint8)
        with self.lock:
            self.live += 1
            self.created += 1
            self.peak = max(self.peak, self.live)
        weakref.finalize(arr, self._dec)
        return arr

    def _dec(self):
        with self.lock:
            self.live -= 1


def test_pool_window_bounds_inflight_plus_unacked():
    tracker = _LiveTracker()
    n, window = 32, 4
    jobs = [(lambda k=k: tracker.make((16, 16, 3), k % 251))
            for k in range(n)]
    pool = decoding.iter_decoded(jobs, workers=8, window=window)
    got = set()
    for i, v, err in pool:
        assert err is None
        got.add(i)
        del v                       # consumer done with it
        time.sleep(0.002)           # slow consumer: pool must NOT run ahead
        pool.ack()
    assert got == set(range(n))
    assert tracker.created == n
    # in flight + yielded-unacked <= window; +1 slack for the loop-local
    # tuple that lives until the next iteration rebinding
    assert tracker.peak <= window + 1, tracker.peak


def test_pool_without_window_unchanged():
    tracker = _LiveTracker()
    n = 16
    jobs = [(lambda k=k: tracker.make((8, 8, 3), k)) for k in range(n)]
    got = [i for i, v, e in decoding.iter_decoded(jobs, workers=8)]
    assert sorted(got) == list(range(n))


def test_pool_window_caps_workers():
    # the caller's residency bound is honored exactly: window=1 decodes
    # strictly one at a time (the reference's serialized-ingest behavior)
    tracker = _LiveTracker()
    pool = decoding.DecodePool(
        [(lambda k=k: tracker.make((8, 8, 3), k)) for k in range(8)],
        workers=4, window=1)
    assert pool._window == 1
    for _, v, e in pool:
        assert e is None
        del v
        pool.ack()
    assert tracker.peak <= 2        # one live + loop-local slack


def test_pool_ack_contract_covers_errors():
    """Error results occupy a slot too (uniform contract) — a skip-policy
    consumer that acks every yielded item keeps draining."""
    def boom():
        raise ValueError("bad image")

    jobs = [boom if k % 3 == 0 else (lambda: k) for k in range(12)]
    pool = decoding.iter_decoded(jobs, workers=3, window=3)
    seen = 0
    for i, v, err in pool:
        seen += 1
        pool.ack()
    assert seen == 12


def test_pool_reports_caller_indices():
    """Reordered submission must report the CALLER's indices — including
    in watchdog timeouts — not pool-local slots."""
    order = [3, 0, 2, 1]
    pool = decoding.iter_decoded(
        [(lambda k=k: k * 10) for k in order], workers=2, window=4,
        indices=order)
    got = {}
    for i, v, e in pool:
        assert e is None
        got[i] = v
        pool.ack()
    assert got == {3: 30, 0: 0, 2: 20, 1: 10}


def test_pool_timeout_names_caller_index():
    ev = threading.Event()
    order = [7, 5]

    def hang():
        ev.wait(10)
        return None

    pool = decoding.iter_decoded([hang, lambda: 1], workers=1,
                                 timeout_s=0.2, indices=order)
    try:
        results = {}
        for i, v, e in pool:
            results[i] = e
        assert isinstance(results[7], TimeoutError)
        assert "image 7" in str(results[7])
        assert results[5] is None
    finally:
        ev.set()


def test_pool_close_before_iteration_stops_workers():
    """close() on a never-iterated pool must cancel the eagerly-started
    workers (they would otherwise drain the whole queue)."""
    started = threading.Event()
    release = threading.Event()
    done = []

    def first():
        started.set()
        release.wait(5)
        return 1

    def later(k):
        done.append(k)
        return k

    pool = decoding.iter_decoded(
        [first] + [functools.partial(later, k) for k in range(8)],
        workers=1)
    assert started.wait(5)          # worker is inside job 0
    pool.close()                    # cancel while job 0 still blocks
    release.set()                   # job 0 finishes; worker must then exit
    time.sleep(0.3)
    assert done == []               # no queued job was picked up after close


def test_pool_close_then_iterate_raises_stopiteration():
    """Iterating a pool AFTER close() must end immediately, not block: the
    lazily-created generator would otherwise wait forever on a result queue
    whose workers were all cancelled (review finding, round 4)."""
    pool = decoding.iter_decoded([lambda: 1, lambda: 2], workers=1)
    pool.close()
    assert list(pool) == []


def test_stream_blit_peak_residency_bounded(tmp_path):
    """A tall vertical strip streams with peak decoded sources ~= window,
    not O(n) — the property that replaced api._BLIT_MAX_SRC_BYTES."""
    from imagestitching.config import StitchOptions
    from imagestitching.core import geometry
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.imgio import codec, native
    from imagestitching.runtime import export

    if not native.available():
        pytest.skip("native codec unavailable")

    n, w, h = 24, 4096, 512        # 6.3 MB/source, 151 MB total
    tracker = _LiveTracker()
    specs = [ImageSpec(w, h) for _ in range(n)]
    plan = solve(specs, StitchOptions(direction="vertical", mode="min",
                                      supersample=False, max_images=None))
    copies = geometry.plan_copy_offsets(plan)
    assert copies is not None
    loaders = [(lambda k=k: tracker.make((h, w, 3), (7 * k + 3) % 251))
               for k in range(n)]
    out = tmp_path / "strip.png"
    window = 6
    phases = export.stream_blit_to_file(
        plan, loaders, str(out), "png", 1, copies,
        decode_threads=4, window=window)
    assert phases["wall_s"] > 0
    assert tracker.created == n
    # band = 2048 rows -> 5 sources/band peak; floor keeps window at 6.
    # +2 slack: the band loop's and _get_oriented's locals each pin one
    # released source until their next rebinding.
    assert tracker.peak <= window + 2, tracker.peak
    # content check: pure blit == concatenation, so probe rows of each image
    got, _ = codec.decode(str(out))
    assert got.shape == (plan.canvas_h, plan.canvas_w, 3)
    for k in (0, n // 2, n - 1):
        r = plan.placements[k].row_span[0] + h // 2
        assert (got[r] == (7 * k + 3) % 251).all(), k


def test_blit_routing_has_no_total_bytes_cap():
    """Jobs whose total source bytes exceed the old 4 GB cap now route to
    the streamed blit path (the window bounds RAM instead)."""
    from imagestitching import api
    from imagestitching.config import (CanvasLimits, RuntimeConfig,
                                           StitchOptions)
    from imagestitching.core.layout import ImageSpec, solve

    assert not hasattr(api, "_BLIT_MAX_SRC_BYTES")
    n, w, h = 200, 4000, 3000       # 200 x 36 MB = 7.2 GB raw, was rejected
    specs = [ImageSpec(w, h) for _ in range(n)]
    limits = CanvasLimits(max_side=1 << 24, max_pixels=1 << 34)
    plan = solve(specs, StitchOptions(direction="vertical", mode="min",
                                      supersample=False, max_images=None),
                 limits)
    assert plan.canvas_h == n * h   # no scale-down: a true pure-blit plan
    copies = api._blit_copies(plan, RuntimeConfig().validate())
    assert copies is not None and len(copies) == n


def test_stream_blit_decode_error_still_aborts(tmp_path):
    from imagestitching.config import StitchOptions
    from imagestitching.core import geometry
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.imgio import native
    from imagestitching.runtime import export

    if not native.available():
        pytest.skip("native codec unavailable")
    n, w, h = 6, 256, 64
    specs = [ImageSpec(w, h) for _ in range(n)]
    plan = solve(specs, StitchOptions(direction="vertical", mode="min",
                                      supersample=False))
    copies = geometry.plan_copy_offsets(plan)

    def bad():
        raise OSError("truncated")

    loaders = [(lambda: np.zeros((h, w, 3), np.uint8))] * (n - 1) + [bad]
    out = tmp_path / "x.png"
    with pytest.raises(OSError):
        export.stream_blit_to_file(plan, loaders, str(out), "png", 1,
                                   copies, decode_threads=3, window=3)
    assert not out.exists()


def test_abandoned_pool_freed_by_refcount_alone():
    """A consumer that drops the pool without close() must not leak its
    daemon workers: workers hold only a weak reference between jobs, so
    refcounting alone frees the pool and trips the __del__ cancel guard —
    no gc cycle pass needed (ADVICE r3)."""
    import threading
    import time
    import weakref

    from imagestitching.runtime import decoding

    gate = threading.Event()

    def slow():
        gate.wait(10)
        return 1

    pool = decoding.iter_decoded([slow] * 8, workers=2, timeout_s=None,
                                 window=2)
    cancelled = pool._cancelled
    ref = weakref.ref(pool)
    del pool        # never iterated, never closed; NO gc.collect()
    gate.set()
    deadline = time.monotonic() + 5.0
    while ref() is not None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ref() is None, "pool still referenced after consumer dropped it"
    assert cancelled.is_set()
