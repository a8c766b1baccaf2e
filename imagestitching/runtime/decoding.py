"""Host decode pool with a per-image watchdog and ack-window backpressure.

The reference wraps every image load in a per-attempt timeout that nulls the
handlers and retries via another creator (utils/canvas.js:68-81); its prepare
loop additionally isolates per-image failures (pages/index/index.js:1133-1149)
— and, crucially, its whole ingest design bounds decoder memory by strictly
serializing decodes with per-item waits (index.js:1125-1157,201-242).  The
framework decodes on a thread pool instead, so both properties are
reimplemented against in-flight jobs:

* **watchdog** — a decode that blocks forever (FIFO, dead NFS mount,
  adversarial stream) must not hang the whole job, or the interpreter at
  exit.  Python cannot kill a blocked thread, so an expired decode is
  *isolated*: a ``TimeoutError`` is reported for that image, the stuck
  worker is abandoned (threads are daemonic, so process exit never blocks
  on it) and a replacement worker is spawned so queued images behind the
  stuck one still run — the "retry via another creator" ladder, minus the
  retry.

* **ack window** — without backpressure, a consumer slower than the pool
  lets every decoded source pile up in the result queue (the old
  ``api._BLIT_MAX_SRC_BYTES`` cap existed solely to bound that worst case).
  With ``window=W``, at most W decodes are *in flight or yielded-but-
  unacked* at once: every yielded result (success, error, or timeout)
  occupies one slot until the consumer calls :meth:`DecodePool.ack`,
  and workers only start a new decode when a slot is free.  Peak decoded
  residency is O(window), independent of job size — the parallel-pool
  equivalent of the reference's serialized ingest.

The timeout budget is *per core-share*, not raw wall clock: when more
decodes run concurrently than the host has cores, each one's deadline is
stretched by the oversubscription factor — otherwise N slow-but-progressing
decodes on a small host would all "time out" at once despite making steady
progress.

Progress guarantee under a window: jobs are dispatched FIFO, so a consumer
that (a) submits jobs in its own consumption order and (b) acks each item
when done with it can never deadlock — the next item it needs is always
among the first ``window`` unacked submissions, hence in flight or already
yielded (worker concurrency is capped at the window, never above it).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

# (index, value, error): exactly one of value/error is meaningful
DecodeResult = Tuple[int, Any, Optional[Exception]]


class DecodePool:
    """Iterator over decode results in completion order, with optional
    ack-window backpressure.

    Yields ``(index, value, None)`` for successes and ``(index, None, exc)``
    for failures — including ``TimeoutError`` for decodes still running past
    their deadline (queued jobs never time out; each timeout spawns a
    replacement worker so they still get a turn).  The caller decides
    raise-vs-skip; :meth:`close` (or exhausting the iterator) stops workers
    from picking up further jobs.  ``BaseException``s that are not
    ``Exception`` (e.g. KeyboardInterrupt in a worker) are re-raised in the
    consumer regardless of any skip policy.

    With ``window`` set, each yielded item holds one window slot until the
    consumer calls :meth:`ack` — see the module docstring for the contract.
    The effective worker count is capped at the window (workers beyond it
    could never hold a permit concurrently).
    """

    def __init__(self, jobs: Sequence[Callable[[], Any]], workers: int,
                 timeout_s: Optional[float] = None,
                 window: Optional[int] = None,
                 indices: Optional[Sequence[int]] = None):
        n = len(jobs)
        self._n = n
        # ``indices``: caller-meaningful index reported for each job (a
        # consumer submitting jobs reordered passes its original indices so
        # yields and watchdog messages name the real image, not the slot)
        if indices is not None and len(indices) != n:
            raise ValueError("indices length must match jobs")
        self._indices = None if indices is None else [int(i)
                                                     for i in indices]
        workers = min(max(1, workers), max(1, n))
        if window is not None:
            # honor the caller's residency bound exactly: extra workers
            # beyond the window could never hold a permit concurrently
            window = max(1, int(window))
            workers = min(workers, window)
        self._window = window
        # core-share stretch: 8 threads on 1 core legitimately take ~8x
        # longer (workers is already capped at the window above)
        self._oversub = max(1.0, workers / max(1, os.cpu_count() or 1))
        self._timeout_s = timeout_s
        self._budget = (None if timeout_s is None
                        else timeout_s * self._oversub)
        self._jobq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._resq: "queue.SimpleQueue" = queue.SimpleQueue()
        for i, fn in enumerate(jobs):
            self._jobq.put((i, fn))
        self._cancelled = threading.Event()
        self._started: dict = {}
        self._permits = (None if window is None
                         else threading.Semaphore(window))
        if n:
            for _ in range(workers):
                self._spawn()
        # generator created lazily on first use: an eager generator's frame
        # references self (a self-cycle only a gc pass collects), so a pool
        # that is created but never iterated would keep its daemon workers
        # busy-polling until then (ADVICE r3); consumers that DO iterate
        # must still close() via try/finally — the cycle exists while live.
        self._gen = None

    # ------------------------------------------------------------ workers

    @staticmethod
    def _worker(cancelled: threading.Event, permits, jobq, resq,
                started: dict) -> None:
        # The thread references the pool's COMPONENTS, never the pool: a
        # bound-method target would keep an abandoned pool (consumer
        # dropped it without close()) alive while its workers busy-poll
        # the permit semaphore forever, so the __del__ leak guard could
        # never fire (ADVICE r3).  With no back-reference, refcounting
        # frees the pool the moment the consumer drops it, __del__ sets
        # ``cancelled``, and the workers exit here.
        while not cancelled.is_set():
            if permits is not None:
                # bounded acquire so cancellation is honored while blocked
                if not permits.acquire(timeout=0.1):
                    continue
            try:
                i, fn = jobq.get_nowait()
            except queue.Empty:
                if permits is not None:
                    permits.release()
                return
            started[i] = time.monotonic()
            try:
                resq.put((i, fn(), None))
            except Exception as e:  # noqa: BLE001 — isolation boundary
                resq.put((i, None, e))
            except BaseException as e:
                resq.put((i, None, e))
                raise
            # NOTE: the window slot acquired for this job is NOT released
            # here — it transfers to the yielded result and is freed by the
            # consumer's ack() (or by the watchdog transfer on timeout).

    def _spawn(self) -> None:
        t = threading.Thread(
            target=DecodePool._worker,
            args=(self._cancelled, self._permits, self._jobq, self._resq,
                  self._started),
            daemon=True, name="stitch-decode")
        t.start()

    # ----------------------------------------------------------- consumer

    def ack(self, n: int = 1) -> None:
        """Release ``n`` window slots (one per yielded item the consumer is
        done with).  No-op without a window."""
        if self._permits is not None:
            for _ in range(n):
                self._permits.release()

    def __iter__(self) -> Iterator[DecodeResult]:
        return self

    def __next__(self) -> DecodeResult:
        if self._gen is None:
            if self._cancelled.is_set():
                # closed (or __del__'d) before first iteration: the workers
                # are gone, so a fresh generator would wait forever for
                # results that will never arrive — match the closed-eager-
                # generator behavior this path replaced
                raise StopIteration
            self._gen = self._iterate()
        return next(self._gen)

    def close(self) -> None:
        # cancel directly too: on a never-iterated pool there is no
        # generator at all (and even a live one's finally may not have been
        # entered), so closing the generator alone would leave the
        # eagerly-started workers decoding (docstring contract)
        self._cancelled.set()
        if self._gen is not None:
            self._gen.close()

    def _ext(self, i: int) -> int:
        """Pool-local job slot -> the caller's reported index."""
        return i if self._indices is None else self._indices[i]

    def __del__(self):  # pragma: no cover — best-effort leak guard
        self._cancelled.set()

    # ------------------------------------------------------------- engine

    def _drain_ready(self) -> list:
        out = []
        while True:
            try:
                out.append(self._resq.get_nowait())
            except queue.Empty:
                return out

    def _iterate(self) -> Iterator[DecodeResult]:
        if self._n == 0:
            return
        budget = self._budget
        reported: set = set()
        # deque + popleft so a yielded value is referenced ONLY by the
        # consumer once it resumes — a plain list would pin every value of
        # a drain wave until the next wave, breaking the O(window)
        # residency bound the ack protocol exists to provide
        pending: deque = deque()
        try:
            while len(reported) < self._n:
                pending.extend(self._drain_ready())
                if not pending:
                    if budget is None:
                        pending.append(self._resq.get())
                    else:
                        now = time.monotonic()
                        deadlines = [t0 + budget for i, t0
                                     in list(self._started.items())
                                     if i not in reported]
                        wait_s = (max(0.01, min(deadlines) - now)
                                  if deadlines else 0.05)
                        try:
                            pending.append(self._resq.get(timeout=wait_s))
                        except queue.Empty:
                            pass
                # completed results ALWAYS beat the deadline scan — a decode
                # that finished moments before its deadline must not be
                # misreported as a timeout
                pending.extend(self._drain_ready())
                while pending:
                    item = pending.popleft()
                    if item[0] not in reported:  # drop late results of
                        reported.add(item[0])    # timed-out jobs (their
                        yield (self._ext(item[0]),) + item[1:]  # slot moved
                    del item
                if budget is not None:
                    now = time.monotonic()
                    for i, t0 in list(self._started.items()):
                        if i not in reported and now - t0 > budget:
                            reported.add(i)
                            self._spawn()  # stuck worker's replacement
                            # the stuck worker's window slot transfers to
                            # this yielded TimeoutError; consumer acks it
                            yield self._ext(i), None, TimeoutError(
                                f"decode of image {self._ext(i)} exceeded "
                                f"{self._timeout_s}s (x{self._oversub:.0f} "
                                "core-share stretch; watchdog, "
                                "utils/canvas.js:68-81 analog)")
        finally:
            self._cancelled.set()


def default_window(workers: int, n_jobs: int) -> int:
    """Default ack-window size: twice the effective worker count (decode
    runs ahead of consumption without unbounded pile-up), floored at 4 so
    tiny pools still overlap decode with encode."""
    return max(4, 2 * min(max(1, workers), max(1, n_jobs)))


def iter_decoded(jobs: Sequence[Callable[[], Any]], workers: int,
                 timeout_s: Optional[float] = None,
                 window: Optional[int] = None,
                 indices: Optional[Sequence[int]] = None) -> DecodePool:
    """Run ``jobs`` on daemon worker threads, yielding in completion order.

    Returns a :class:`DecodePool` (a ``DecodeResult`` iterator with
    ``close()``); pass ``window`` to enable ack-based backpressure and
    ``indices`` to report caller-meaningful indices for reordered jobs —
    see the class docstring for the slot contract.
    """
    return DecodePool(jobs, workers, timeout_s, window, indices)
