"""Batch stitch server: queue, signature bucketing, one device program per
flush (BASELINE config 5: 64 concurrent 9-image jobs).

The reference is strictly one-job-at-a-time behind the ``isStitching`` UI
mutex (pages/index/index.js:25,1193).  This server is its throughput-mode
replacement:

* jobs are grouped by ``plan.signature()`` — same signature => same compiled
  executable (see ops.xla_compose.CompiledStitch docstring);
* a bucket flushes when it reaches ``max_batch`` or when ``max_wait_s``
  elapses with work pending (classic dynamic batching);
* each flush runs ONE fused batched program
  (:class:`..parallel.batch.BatchedStitch`), optionally sharded over a
  ``jobs``-axis device mesh;
* per-job failure isolation: a bad job fails its own future, never the batch
  (the serving analog of per-image skip-and-continue, index.js:1133-1149).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CanvasLimits, RuntimeConfig, StitchOptions
from ..core.layout import ImageSpec, LayoutPlan, solve
from ..parallel.batch import BatchedStitch
from ..parallel import mesh as pmesh
from ..runtime.logger import get_logger


class ServerOverloaded(RuntimeError):
    """Raised at admission when the pending-job bound is hit (backpressure);
    clients should retry after a short delay."""


@dataclasses.dataclass
class _Job:
    images: List[np.ndarray]
    plan: LayoutPlan
    future: Future
    enqueued_at: float


@dataclasses.dataclass
class _Warmup:
    """Pre-compile request: build + execute the batch executable for
    ``plan`` at padded batch size ``batch`` with zero-filled inputs."""
    plan: LayoutPlan
    batch: int
    channels: int
    future: Future


def _job_channels(job: "_Job") -> int:
    return (job.images[0].shape[2]
            if job.images and job.images[0].ndim == 3 else 3)


class StitchServer:
    """Dynamic-batching stitch service.

    >>> server = StitchServer(max_batch=64, max_wait_s=0.005)
    >>> fut = server.submit([img_a, img_b], StitchOptions(gap=4))
    >>> strip = fut.result()
    """

    def __init__(self, max_batch: int = 64, max_wait_s: float = 0.005,
                 use_mesh: bool = False,
                 config: Optional[RuntimeConfig] = None,
                 max_queue: int = 1024, max_signatures: int = 32):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.config = (config or RuntimeConfig()).validate()
        self.mesh = pmesh.make_mesh() if use_mesh else None
        # bounded queue = explicit backpressure: reject at admission instead
        # of buffering unboundedly (the server analog of the reference's
        # isStitching mutex refusing re-entry, index.js:25,772)
        self.max_queue = max_queue
        # Signature-LRU over compiled batch executables: each BatchedStitch
        # owns its jax.jit closure, so evicting a signature really frees
        # its compiled programs.  Without a bound, a long-lived server fed
        # diverse geometry accretes one executable per (signature, padded
        # batch size) forever — the serving analog of the reference's
        # budgeted bitmap cache (pages/index/index.js:9-11).  Per
        # signature the inner dict stays <= log2(max_batch)+1 pow-2 sizes.
        self.max_signatures = max(1, max_signatures)
        self._pending = 0                  # submitted, future not yet set
        self._plock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        # sig -> {(batch_size, channels): BatchedStitch}
        self._compiled: ("collections.OrderedDict[Tuple, "
                         "Dict[Tuple[int, int], BatchedStitch]]") = \
            collections.OrderedDict()
        self._log = get_logger()
        # latency accounting (worker-thread-only mutation, like the
        # counters): queue_wait_* = submit -> flush-start wall per job (the
        # dynamic-batching cost a client actually pays), flush_s = flush
        # wall including stacking + executable lookup, so a cold
        # signature's trace+compile spike is visible — exactly what
        # warmup() exists to remove
        self._stats = {"jobs": 0, "batches": 0, "failed": 0, "warmups": 0,
                       "queue_wait_s": 0.0, "queue_wait_max_s": 0.0,
                       "flush_s": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._closed = False
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, images: Sequence[np.ndarray],
               options: Optional[StitchOptions] = None,
               limits: Optional[CanvasLimits] = None,
               orientations: Optional[Sequence[int]] = None) -> Future:
        """Enqueue one stitch job; resolves to the uint8 HWC strip.

        ``orientations``: per-image EXIF orientation (1-8) applied on
        device, matching api.stitch's behavior for decoded files.
        """
        if self._closed:
            raise RuntimeError("server is closed")
        from .. import api as _api
        options = (options or StitchOptions()).validate()
        if orientations is None:
            orientations = [1] * len(images)
        if len(orientations) != len(images):
            raise ValueError("orientations length must match images")
        # Reserve the queue slot BEFORE any expensive per-job work (channel
        # normalization is O(pixels), then overlap scoring, layout solve):
        # backpressure must bound what an overloaded server pays per
        # rejected request, not just what it buffers.
        self._admit()
        try:
            # same normalization as api.stitch_arrays: LA/RGBA flatten onto
            # white (decode-ladder formula), mixed gray+RGB promote to RGB —
            # so channel count is uniform per job and in {1, 3} (the
            # compiled program is parameterized by it; an un-normalized
            # 4-channel job used to die at trace time with a concat-shape
            # TypeError)
            imgs = _api._unify_channels(
                [np.ascontiguousarray(_api._as_uint8(a)) for a in images])
            specs = [ImageSpec(a.shape[1], a.shape[0], int(o))
                     for a, o in zip(imgs, orientations)]
            if options.merge_overlap:
                # pixel-derived trims change the specs, so merge runs in the
                # caller's thread before the job is keyed/batched by signature
                from ..ops import overlap as _overlap
                imgs, specs, trims = _overlap.merge_arrays(imgs, specs,
                                                           options)
                if any(trims):
                    self._log.event("serve.merge", trims=trims)
            plan = solve(specs, options,
                         self.config.limits if limits is None else limits)
            with self._plock:
                fut: Future = Future()
                # put under the lock so close() cannot interleave its
                # shutdown sentinel between our _closed check and the enqueue
                if self._closed:
                    raise RuntimeError("server is closed")
                self._queue.put(_Job(imgs, plan, fut, time.perf_counter()))
        except BaseException:
            self._release()
            raise
        return fut

    # -------------------------------------------------------- admission

    def _full_locked(self) -> None:
        # caller holds self._plock
        if self._pending >= self.max_queue:
            self._log.event("serve.queue_full", depth=self._pending)
            raise ServerOverloaded(
                f"server queue full ({self.max_queue} jobs pending); "
                "retry later")

    def _admit(self) -> None:
        """Reserve one queue slot; raises :class:`ServerOverloaded` when the
        pending-job bound is hit.  The slot is held until :meth:`_resolve`
        (batch jobs) or :meth:`_release` (errors / out-of-band jobs)."""
        with self._plock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._full_locked()
            self._pending += 1

    def _release(self) -> None:
        with self._plock:
            self._pending -= 1

    def ensure_capacity(self) -> None:
        """Cheap overload pre-check WITHOUT reserving a slot.

        Callers with expensive pre-submit work (the HTTP layer decodes
        every request image before submitting) probe this first so an
        overloaded server rejects before paying that work; the authoritative
        (slot-reserving) check is still :meth:`_admit` at submission."""
        with self._plock:
            self._full_locked()

    @contextlib.contextmanager
    def admission(self):
        """Hold one queue slot for an out-of-band job.

        The HTTP grid path runs grid jobs inline (they are one-shot
        multi-plan jobs, not batchable by signature) but they must count
        against the same ``max_queue`` bound as batch jobs — otherwise a
        flood of grid requests bypasses backpressure entirely and piles up
        unbounded concurrent pipelines."""
        self._admit()
        try:
            yield
        finally:
            self._release()

    def warmup(self, shapes: Sequence, options: Optional[StitchOptions] = None,
               limits: Optional[CanvasLimits] = None,
               orientations: Optional[Sequence[int]] = None,
               batch_sizes: Sequence[int] = (1,),
               timeout: Optional[float] = 300.0) -> dict:
        """Pre-compile the executables jobs of this geometry will need.

        A cold signature pays trace + XLA compile on its first flush — the
        serving analog of the
        reference pre-warming its canvas before first use rather than on
        the first stitch.  ``shapes`` is one ``(height, width)`` or
        ``(height, width, channels)`` per image; each entry of
        ``batch_sizes`` warms the pow-2-padded executable a flush of that
        many jobs would select (same padding rule, so the first real
        request of that size pays dispatch, not compile).  Runs on the
        worker thread (sole owner of the compiled-program cache) with
        zero-filled inputs; blocks until done.  Returns
        ``{"batches": [...], "signature_cached": True}``.
        """
        if self._closed:
            raise RuntimeError("server is closed")
        options = (options or StitchOptions()).validate()
        norm: List[Tuple[int, int, int]] = []
        for s in shapes:
            t = tuple(int(x) for x in s)
            if len(t) == 2:
                t = t + (3,)
            if len(t) != 3 or min(t) < 1:
                raise ValueError(f"bad warmup shape {s!r}: expected "
                                 "(height, width[, channels])")
            if t[2] not in (1, 3):
                raise ValueError(
                    f"warmup channels must be 1 or 3 (submit flattens "
                    f"alpha), got {t[2]}")
            norm.append(t)
        channels = max(shp[2] for shp in norm)   # mixed promotes to RGB
        if orientations is None:
            orientations = [1] * len(norm)
        if len(orientations) != len(norm):
            raise ValueError("orientations length must match shapes")
        specs = [ImageSpec(shp[1], shp[0], int(o))
                 for shp, o in zip(norm, orientations)]
        plan = solve(specs, options,
                     self.config.limits if limits is None else limits)
        try:
            sizes = [int(b) for b in batch_sizes]
        except TypeError as e:
            raise ValueError(
                f"batch_sizes must be a list of ints, got "
                f"{batch_sizes!r}") from e
        if not sizes:
            raise ValueError("batch_sizes must be non-empty")
        cap = self._effective_cap(plan, channels)
        targets = sorted({
            self._padded_batch(max(1, min(b, self.max_batch, cap)), cap)
            for b in sizes})
        futs: List[Tuple[int, Future]] = []
        for b in targets:
            self._admit()
            fut: Future = Future()
            try:
                with self._plock:
                    if self._closed:
                        raise RuntimeError("server is closed")
                    self._queue.put(_Warmup(plan, b, channels, fut))
            except BaseException:
                self._release()
                raise
            futs.append((b, fut))
        for _, fut in futs:
            fut.result(timeout=timeout)
        return {"batches": targets, "signature_cached": True}

    def _resolve(self, job, value=None, error=None) -> None:
        with self._plock:
            self._pending -= 1
        try:
            if error is not None:
                job.future.set_exception(error)
            else:
                job.future.set_result(value)
        except InvalidStateError:
            # Belt-and-braces: _start_or_drop transitions every dequeued
            # future to RUNNING (cancel() then returns False), so a resolve
            # should never find the future already settled.  Must not
            # propagate regardless: a throw mid-resolve-loop would
            # split-retry the whole batch, double-counting stats and
            # recomputing batch-mates.
            self._log.event("serve.resolve_dropped", cancelled=True)

    def _start_or_drop(self, job) -> bool:
        """Executor half of the Future cancellation protocol: transition a
        dequeued job's future to RUNNING, or — when the client cancelled it
        while it sat queued — notify the future's waiters of the
        cancellation and release the admission slot.

        ``Future.cancel()`` alone only moves PENDING -> CANCELLED; the
        CANCELLED -> CANCELLED_AND_NOTIFIED step that wakes
        ``concurrent.futures.wait``/``as_completed`` is reserved to the
        executor via ``set_running_or_notify_cancel()``.  Skipping it hung
        any client that waited on a future it had cancelled (found by the
        ``--stress`` soak, seed 999100), and silently burned a batch slot
        computing a result nobody could receive."""
        if job.future.set_running_or_notify_cancel():
            return True
        with self._plock:
            self._pending -= 1
        self._log.event("serve.job_cancelled")
        return False

    def stats(self) -> dict:
        with self._plock:
            pending = self._pending
        return {**self._stats, "pending": pending,
                "max_queue": self.max_queue,
                "signatures": len(self._compiled)}

    def close(self, timeout: float = 10.0) -> None:
        if not self._closed:
            with self._plock:
                self._closed = True
                self._queue.put(None)
            self._thread.join(timeout)
            # fail anything that still slipped in behind the sentinel
            while True:
                try:
                    job = self._queue.get_nowait()
                except queue.Empty:
                    break
                if job is not None and self._start_or_drop(job):
                    self._resolve(job, error=RuntimeError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _loop(self) -> None:
        buckets: Dict[Tuple, List[_Job]] = {}
        deadline: Optional[float] = None
        while True:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.perf_counter())
            try:
                job = self._queue.get(timeout=timeout)
            except queue.Empty:
                job = False       # timer fired: flush everything pending
            if job is None:
                for jobs in buckets.values():
                    self._flush(jobs)
                return
            if isinstance(job, _Warmup):
                self._warm(job)
                continue
            if job is not False:
                # channels joins the bucket key: same-geometry gray and RGB
                # jobs need different compiled programs (and np.stack of
                # mixed channel counts would die mid-flush)
                sig = (job.plan.signature(), _job_channels(job))
                buckets.setdefault(sig, []).append(job)
                if len(buckets[sig]) >= self.max_batch:
                    self._flush(buckets.pop(sig))
                if buckets and deadline is None:
                    deadline = time.perf_counter() + self.max_wait_s
                continue
            # flush on deadline
            for sig in list(buckets):
                self._flush(buckets.pop(sig))
            deadline = None

    def _warm(self, wj: "_Warmup") -> None:
        """Worker-thread half of :meth:`warmup`: compile + run one
        zero-filled batch so the executable (and the backend's compile
        cache) is hot before real traffic arrives."""
        if not self._start_or_drop(wj):
            return
        try:
            t0 = time.perf_counter()
            compiled = self._get_compiled(wj.plan, wj.batch, wj.channels)
            compiled.warm()
            self._stats["warmups"] += 1
            self._log.event("serve.warmup", batch=wj.batch,
                            canvas=(wj.plan.canvas_w, wj.plan.canvas_h),
                            wall_s=round(time.perf_counter() - t0, 3))
            self._resolve(wj, value={"batch": wj.batch})
        except Exception as e:  # noqa: BLE001 — isolation boundary
            self._log.event("serve.warmup_fail", batch=wj.batch,
                            error=repr(e))
            self._resolve(wj, error=e)

    def _get_compiled(self, plan: LayoutPlan, batch: int,
                      channels: int = 3) -> BatchedStitch:
        sig = plan.signature()
        per_size = self._compiled.setdefault(sig, {})
        self._compiled.move_to_end(sig)
        while len(self._compiled) > self.max_signatures:
            _, old_sizes = self._compiled.popitem(last=False)
            self._log.event("serve.signature_evicted",
                            sizes=sorted(old_sizes), kept=len(self._compiled))
        key = (batch, channels)
        if key not in per_size:
            per_size[key] = BatchedStitch(plan, batch, channels,
                                          mesh=self.mesh)
        return per_size[key]

    def _effective_cap(self, plan: LayoutPlan, channels: int) -> int:
        """Device-memory batch cap, rounded down to a jobs-axis multiple under a
        mesh.  Shared by :meth:`_flush` and :meth:`warmup`: a warmup
        clamped against the RAW cap could select a batch size no real
        flush ever uses (the flush splits at the mesh-rounded cap) and
        execute a zero batch larger than the HBM bound."""
        cap = self._batch_cap(plan, channels)
        if self.mesh is not None:
            unit = self.mesh.shape["jobs"]
            cap = max(unit, (cap // unit) * unit)
        return cap

    def _padded_batch(self, b: int, cap: int) -> int:
        """Pad a batch to a power-of-two bucket to bound the number of
        compiled batch sizes (recompilation governor); under a mesh the
        batch must also divide evenly across the jobs axis.  Shared by
        :meth:`_flush` and :meth:`warmup` so a warmed size is exactly the
        size a real flush of that many jobs selects."""
        padded = 1
        while padded < b:
            padded *= 2
        padded = min(padded, self.max_batch, max(1, cap))
        padded = max(padded, b)
        if self.mesh is not None:
            unit = self.mesh.shape["jobs"]
            padded = max(padded, unit)
            padded = ((padded + unit - 1) // unit) * unit
        return padded

    def _batch_cap(self, plan: LayoutPlan, channels: int) -> int:
        """Max jobs per launch under the device-memory budget (VERDICT r1 #7).

        Proactive version of the reference's canvas pixel caps
        (pages/index/index.js:1323-1357): bound the batched program's
        estimated peak *before* launch instead of relying on OOM bisection.
        A mesh multiplies the cap: the jobs axis shards the batch, so each
        device holds batch/unit jobs.
        """
        from ..runtime import tiler
        per_job = max(1, tiler.resident_peak_bytes(plan, channels))
        cap = max(1, int(self.config.budget.hbm_bytes // per_job))
        if self.mesh is not None:
            cap *= self.mesh.shape["jobs"]
        return cap

    def _flush(self, jobs: List[_Job]) -> None:
        # Cancellation gate exactly once per job (a second
        # set_running_or_notify_cancel on a RUNNING future raises), so the
        # cap-split/split-retry recursion below goes through _flush_started.
        self._flush_started([j for j in jobs if self._start_or_drop(j)])

    def _flush_started(self, jobs: List[_Job]) -> None:
        if not jobs:
            return
        plan = jobs[0].plan
        channels = _job_channels(jobs[0])
        cap = self._effective_cap(plan, channels)
        if len(jobs) > cap:
            self._log.event("serve.batch_capped", n=len(jobs), cap=cap,
                            canvas=(plan.canvas_w, plan.canvas_h))
            for lo in range(0, len(jobs), cap):
                self._flush_started(jobs[lo:lo + cap])
            return
        try:
            t0 = time.perf_counter()
            b = len(jobs)
            padded = self._padded_batch(b, cap)
            stacks = []
            for slot in range(len(plan.placements)):
                arrs = [j.images[slot] for j in jobs]
                while len(arrs) < padded:
                    arrs.append(arrs[0])          # pad with a copy
                stacks.append(np.stack(arrs))
            compiled = self._get_compiled(plan, padded, channels)
            out = compiled(stacks)
            # bump stats BEFORE resolving: a client woken by its future must
            # observe stats() that already include its own job (readers
            # synchronize on the futures, not on the worker thread).
            # Latency metrics accumulate only on this success path — the
            # split-retry recursion below would double-count waits.
            waits = [t0 - j.enqueued_at for j in jobs]
            self._stats["queue_wait_s"] += sum(waits)
            self._stats["queue_wait_max_s"] = max(
                self._stats["queue_wait_max_s"], max(waits))
            self._stats["flush_s"] += time.perf_counter() - t0
            self._stats["jobs"] += b
            self._stats["batches"] += 1
            for i, j in enumerate(jobs):
                self._resolve(j, value=out[i])
            self._log.event("serve.flush", batch=b, padded=padded,
                            canvas=(plan.canvas_w, plan.canvas_h))
        except Exception as e:  # noqa: BLE001 — isolation boundary
            # batch-level failure: retry jobs individually so one poisoned
            # job cannot take down its batch-mates
            if len(jobs) == 1:
                self._stats["failed"] += 1       # before resolve (see above)
                self._resolve(jobs[0], error=e)
                self._log.event("serve.job_fail", error=repr(e))
                return
            self._log.event("serve.batch_fail_retry_split", n=len(jobs),
                            error=repr(e))
            mid = len(jobs) // 2
            self._flush_started(jobs[:mid])
            self._flush_started(jobs[mid:])
