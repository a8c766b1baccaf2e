"""Benchmark: p50 latency of the flagship 9-image 12 MP stitch on one device.

BASELINE.md north star: stitch 9x 12 MP (4000x3000) photos into one strip in
<50 ms at bit-level parity (within rounding) with the Canvas-2D reference.
``vs_baseline`` is 50ms / p50 — >1.0 beats the target.

Measures the device program a serving system would run per job: sources
resident on device (the staging double-buffer's steady state), the XLA
orient+resample+place program, uint8 result materialized on device.
Host decode and transfers are reported to stderr but are not the headline
(see runtime/pipeline for the overlapped host pipeline).

Prints ONE final JSON line: {"metric", "value", "unit", "vs_baseline", ...} —
ALWAYS, no matter how the process dies:

* every device phase runs under a bounded transient-error retry
  (re-``device_put`` of the inputs between attempts), and an unrecoverable
  failure still emits the line with whatever fields completed plus an
  ``"errors"`` map (round 2 lost its scoreboard entry to one ``ABORTED``);
* a PARTIAL line (``"partial": true``) goes out right after the device phase,
  before the long host e2e phases, so a later kill cannot erase the headline;
* SIGTERM/SIGINT handlers and a daemon watchdog thread (hard self-deadline,
  ``BENCH_DEADLINE_S``, default 840 s — inside any plausible driver budget)
  emit the current partial result and exit: round 3 died to a driver SIGTERM,
  which does not run ``finally`` blocks, after ~25 min of host-only e2e
  against a dead backend;
* when the device phase failed, e2e degrades — the resample variant (which
  needs the device) is skipped and the host-blit variant is capped at 2 runs;
* e2e fixture JPEGs are cached in a content-keyed directory and reused
  across invocations (they are deterministic), so repeat runs skip the
  12 MP encodes.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import statistics
import sys
import threading
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ----------------------------------------------------------- emergency emit
#
# The driver's contract is "one parseable JSON line on stdout".  The normal
# path prints it from main()'s ``finally`` — but SIGTERM (driver timeout)
# does not run ``finally``, and a backend-init hang can wedge the main
# thread inside a C call where Python signal handlers never fire.  So the
# live result dict is published here, and two independent emergency paths
# can serialize it: signal handlers (fast path) and a watchdog thread with
# a hard self-deadline (survives a wedged main thread).

_EMIT_LOCK = threading.Lock()
_LIVE: dict = {"result": None, "errors": None, "final": False,
               "t_end": None}


def _render_line(extra: dict | None = None) -> str:
    for _ in range(3):      # result may be mutated concurrently; just retry
        try:
            r = dict(_LIVE["result"] or {})
            errs = _LIVE["errors"]
            if errs:
                r["errors"] = dict(errs)
            if extra:
                r.update(extra)
            return json.dumps(r, default=repr)
        except RuntimeError:        # pragma: no cover — torn dict iteration
            continue
    return json.dumps({"value": None, **(extra or {})})


def _emit_line(extra: dict | None = None) -> None:
    """Serialize the live result as one JSON line (normal path)."""
    with _EMIT_LOCK:
        print(_render_line(extra), flush=True)


def _emergency_emit(extra: dict) -> None:
    """Signal-safe emission: NO lock (a SIGTERM can interrupt the main
    thread while it holds ``_EMIT_LOCK`` inside ``_emit_line`` — taking it
    again here would deadlock the handler) and NO Python stdout buffer
    (``os._exit`` follows, which skips flushes).  The leading newline
    terminates any torn half-printed line so the LAST line stays parseable."""
    try:
        os.write(1, ("\n" + _render_line(extra) + "\n").encode())
    except OSError:  # pragma: no cover — stdout gone; nothing left to do
        pass


def _remaining_s() -> float:
    """Seconds until the self-deadline (inf when none is armed)."""
    t_end = _LIVE["t_end"]
    return float("inf") if t_end is None else t_end - time.monotonic()


def _install_emergency_emitters(deadline_s: float) -> None:
    def _on_signal(signum, frame):  # noqa: ARG001
        # The handler can land mid-write inside one of bench's buffered
        # stderr prints; a print() HERE then raises the reentrant-IO
        # RuntimeError at the interrupted frame and the emit never runs.
        # Emit first, then log via raw os.write only.
        name = signal.Signals(signum).name
        if not _LIVE["final"]:
            _emergency_emit({"aborted": name})
        try:
            os.write(2, f"\nbench: caught {name} — emitted partial "
                        "result line\n".encode())
        except OSError:  # pragma: no cover — stderr gone
            pass
        os._exit(128 + signum)

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(s, _on_signal)
        except (ValueError, OSError):  # pragma: no cover — non-main thread
            pass

    def _watchdog():
        while True:
            rem = _remaining_s()
            if _LIVE["final"]:
                return
            if rem <= 0:
                log(f"bench: self-deadline {deadline_s:.0f}s reached — "
                    "emitting partial result line")
                _emergency_emit(
                    {"aborted": f"self-deadline {deadline_s:.0f}s"})
                os._exit(3)
            time.sleep(min(rem, 1.0))

    threading.Thread(target=_watchdog, daemon=True,
                     name="bench-deadline").start()


def _is_transient(e: BaseException) -> bool:
    """Device/backend errors worth retrying (PJRT aborts).

    JaxRuntimeError subclasses RuntimeError; programming errors (ValueError,
    TypeError, tracer errors) must NOT be retried — they would just re-raise
    identically three times and hide the real traceback timing.
    """
    if isinstance(e, (ValueError, TypeError, NotImplementedError)):
        return False            # NotImplementedError subclasses RuntimeError
    # OOM is deterministic for a fixed workload — reuse the pipeline's
    # broad cross-backend classifier rather than one enum substring
    from imagestitching.runtime.pipeline import _is_oom
    if _is_oom(e):
        return False
    if isinstance(e, RuntimeError):
        return True
    # XlaRuntimeError has moved between modules across jax versions; match
    # by name so the check cannot rot.
    return type(e).__name__ in ("XlaRuntimeError", "JaxRuntimeError")


def _retry_transient(fn, *, attempts: int = 3, sleep_s: float = 5.0,
                     reset=None, label: str = "", on_retry=None):
    """Run ``fn`` with bounded retries on transient device errors.

    ``reset`` (optional) re-establishes device state between attempts —
    after a backend ABORT the old device buffers may be gone, so callers
    pass a re-``device_put`` of the host-staged inputs.  ``on_retry`` is
    invoked once per retry (timing code uses it to mark samples poisoned).
    """
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — predicate-gated re-raise
            if not _is_transient(e) or attempt == attempts - 1:
                raise
            log(f"bench[{label}]: transient device error "
                f"(attempt {attempt + 1}/{attempts}): {e!r}; "
                f"retrying in {sleep_s:.0f}s")
            if on_retry is not None:
                on_retry()
            time.sleep(sleep_s)
            if reset is not None:
                reset()
    raise AssertionError("unreachable")


def _slope_time(fn_impl, dev_imgs, k_lo: int = 2, k_hi: int = 52,
                rounds: int = 5):
    """Median per-call device time via scan-chained slope timing.

    Chaining mode matters (each defeats hoisting/DCE differently, with a
    different artifact):

    * carried-bump (this function): images ride the scan carry and get an
      in-place 1-element bump per step.  Near-zero overhead for BLIT-bound
      jobs — but carry-dependent kernel inputs serialize/deoptimize the
      Pallas resample path (config 3 measured 4.9 ms here vs 1.25 ms with
      distinct inputs; identical kernels).
    * distinct-inputs (:func:`_slope_time_distinct`): every step consumes
      its own pre-staged input set via scan-over-xs — matches steady-state
      serving, accurate for KERNEL-bound jobs, but each step pays one HBM
      pass of xs slicing, which would ~2x a pure-blit job.

    :func:`_slope_auto` picks per job: distinct when any placement runs the
    resample kernel, carried when the job is all blits.
    """
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=0)
    def run_chain(k, imgs):
        def step(carry, _):
            probe0, ims = carry
            # bump EVERY input (else XLA hoists the other placements out
            # of the loop); a FIXED carried element would let XLA dead-code-
            # eliminate every op not feeding it (measured 9x undercount on
            # multi-placement jobs).  The images ride the CARRY so the bump
            # is an aliased in-place 1-element update — bumping a scan
            # CLOSURE instead forces XLA to copy every source each step
            # (~1 ms for 324 MB: it DOUBLED config 4's reported time).
            ims = [im.at[(0,) * im.ndim].add(probe0) for im in ims]
            out = fn_impl(ims)
            # read a CARRY-DEPENDENT position: XLA cannot prove any region
            # dead (it must materialize the whole canvas) yet the probe is
            # O(1) — no artificial full-canvas checksum cost.
            c32 = probe0.astype(jnp.int32)
            mults = (40503, 48271, 12007, 9973)
            starts = tuple(
                jax.lax.rem(c32 * mults[d % 4] + d + 1,
                            out.shape[d]) for d in range(out.ndim))
            probe = jax.lax.dynamic_slice(out, starts, (1,) * out.ndim)
            return (probe.reshape(()).astype(jnp.uint8), ims), None
        (c, _), _ = jax.lax.scan(step, (jnp.uint8(0), list(imgs)), None,
                                 length=k)
        return c

    return _slope_run(run_chain, dev_imgs, k_lo, k_hi, rounds)


def _slope_run(run_chain, dev_imgs, k_lo, k_hi, rounds):
    # each fetch-forced chain invocation individually survives a transient
    # abort (dev_imgs still exist in this scope, so no reset is needed —
    # if they too were lost the retry re-raises to the caller's reset).
    # A retry that fires INSIDE a timed round would poison that sample
    # (the failed attempt + sleep land in t_lo/t_hi), so rounds where a
    # retry fired are discarded and re-run rather than entering the median.
    retried = [False]

    def _mark():
        retried[0] = True

    def call(k):
        return _retry_transient(lambda: int(run_chain(k, dev_imgs)),
                                attempts=2, sleep_s=3.0, label="chain",
                                on_retry=_mark)

    call(k_lo)       # compile + warm
    call(k_hi)
    samples = []
    ceilings = []
    attempts = 0
    while len(samples) < rounds and attempts < rounds * 3:
        attempts += 1
        retried[0] = False
        t0 = time.perf_counter()
        call(k_lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        call(k_hi)
        t_hi = time.perf_counter() - t0
        if retried[0]:
            continue    # poisoned timing: discard the whole round
        slope = (t_hi - t_lo) / (k_hi - k_lo) * 1000.0
        ceilings.append(t_hi / k_hi * 1000.0)
        if slope <= 0:
            # a neighbor inflating t_lo past t_hi makes the slope
            # non-positive — physically impossible per-call time, and a
            # negative `value` in the emitted JSON reads as a broken
            # artifact.  Discard the round like a retry-poisoned one.
            continue
        samples.append(slope)
    if not samples:
        if ceilings:
            # every round was contention-inverted: report the per-call
            # ceiling (total/k includes dispatch overhead, so it is a
            # conservative OVERestimate — but positive and real).  The
            # "ceiling" mode marks the JSON so consumers never mix the two
            # incomparable metrics silently.
            log("slope timing: all rounds contention-inverted; "
                "falling back to per-call ceiling")
            return (statistics.median(ceilings),
                    [round(s, 2) for s in ceilings], "ceiling")
        raise RuntimeError(
            "slope timing: every round hit a transient device error")
    return (statistics.median(samples), [round(s, 2) for s in samples],
            "slope")


def _probe_of(carry, out):
    """O(1) carry-dependent read: XLA must materialize the whole output
    (the position is unknown at compile time) but fetches one element."""
    import jax
    import jax.numpy as jnp

    c32 = carry.astype(jnp.int32)
    mults = (40503, 48271, 12007, 9973)
    starts = tuple(jax.lax.rem(c32 * mults[d % 4] + d + 1, out.shape[d])
                   for d in range(out.ndim))
    probe = jax.lax.dynamic_slice(out, starts, (1,) * out.ndim)
    return probe.reshape(()).astype(jnp.uint8)


def _slope_time_distinct(fn_impl, dev_imgs, k_hi: int = 16,
                         rounds: int = 3, max_stack_bytes: int = 6 << 30):
    """Slope timing over DISTINCT pre-staged input sets (scan-over-xs).

    See :func:`_slope_time` for when to use which.  Device memory holds
    ``k_hi`` copies of the inputs; ``k_hi`` is clamped so the stack stays
    under ``max_stack_bytes``.
    """
    import functools
    import jax
    import jax.numpy as jnp

    in_bytes = sum(int(np.prod(x.shape)) for x in dev_imgs)
    k_hi = max(4, min(k_hi, max_stack_bytes // max(1, in_bytes)))
    k_lo = max(2, k_hi // 4)

    # K copies of each input, stacked on device (values opaque to XLA, so
    # replication is as hoist-proof as distinct data)
    stack = jax.jit(lambda xs: [jnp.stack([x] * k_hi) for x in xs])
    stacks = stack(dev_imgs)
    jax.block_until_ready(stacks)

    @functools.partial(jax.jit, static_argnums=0)
    def run_chain(k, stks):
        xs = tuple(s[:k] for s in stks)
        def step(carry, ims):
            return _probe_of(carry, fn_impl(list(ims))), None
        c, _ = jax.lax.scan(step, jnp.uint8(0), xs)
        return c

    return _slope_run(run_chain, stacks, k_lo, k_hi, rounds)


def _xla_program(plan):
    """The resident stitch program for ``plan`` with its taps bound: a
    function of the device source list, for jit or scan chaining."""
    from imagestitching.ops import xla_compose
    params = [xla_compose.placement_params(p, plan.filter)
              for p in plan.placements]
    return functools.partial(xla_compose._stitch_impl, plan, 3,
                             params=params)


def _job_is_all_blits(plan) -> bool:
    from imagestitching.core import geometry
    return geometry.plan_copy_offsets(plan) is not None


def _slope_auto(plan, fn_impl, dev_imgs, **kw):
    """Pick the chaining mode by job kind (see _slope_time docstring)."""
    if _job_is_all_blits(plan):
        return _slope_time(fn_impl, dev_imgs, **kw)
    kw.pop("k_lo", None)
    return _slope_time_distinct(fn_impl, dev_imgs, **kw)


def main(n_images: int = 9, w: int = 4000, h: int = 3000,
         e2e: bool = True, guard_process: bool = False) -> None:
    """``guard_process`` arms the process-wide emergency emitters (signal
    handlers + deadline watchdog) — only the ``__main__`` entry sets it, so
    importing callers (tests) never have their signal disposition changed."""
    headline = (n_images, w, h) == (9, 4000, 3000)
    mp_each = w * h / 1e6
    result = {
        "metric": ("p50 latency, 9-image 12MP strip (device compute)"
                   if headline else
                   f"p50 latency, {n_images}-image {mp_each:.2f}MP strip "
                   "(SMOKE GEOMETRY — not the headline metric)"),
        "value": None,
        "unit": "ms",
        "vs_baseline": None,
        "backend": None,
    }
    if not headline:
        # the 50 ms north star is defined for the 9x12MP job only; a smoke
        # run must not emit a scoreboard-shaped vs_baseline
        result["smoke"] = True
    errors: dict = {}
    _LIVE.update(result=result, errors=errors, final=False, t_end=None)
    if guard_process:
        deadline_s = float(os.environ.get("BENCH_DEADLINE_S", "840"))
        _LIVE["t_end"] = time.monotonic() + deadline_s
        _install_emergency_emitters(deadline_s)
    try:
        try:
            _bench_device(result, errors, n_images, w, h)
        except Exception as e:  # noqa: BLE001 — the JSON line must go out
            errors["device"] = repr(e)
            log(f"device bench failed after retries: {e!r}")
        if e2e:
            # insurance line BEFORE the long host-side e2e phases: a driver
            # kill mid-e2e can no longer erase the device headline (round 3)
            _emit_line({"partial": True})
            try:
                _bench_end_to_end(result, n_images, w, h,
                                  device_dead="device" in errors)
            except Exception as e:  # noqa: BLE001
                errors["e2e"] = repr(e)
                log(f"e2e bench failed: {e!r}")
    finally:
        if errors:
            result["errors"] = errors
        print(json.dumps(result), flush=True)
        # Disarm the emergency emitters only AFTER the final line is safely
        # out: a SIGTERM landing mid-print with final already True would
        # leave a torn, unparseable last line with no repair emit.  A signal
        # in the window after the print just duplicates the final line —
        # harmless, the driver reads the last parseable one.
        _LIVE["final"] = True


def _bench_device(result: dict, errors: dict,
                  n_images: int, w: int, h: int) -> None:
    """Device-compute headline (slope-timed), filling ``result`` as phases
    land so a late failure still leaves the completed fields in the JSON."""
    import jax
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.runtime.jaxcfg import ensure_compile_cache

    forced = os.environ.get("BENCH_FORCE_PLATFORM")
    if forced:
        # tests use this to pin cpu or to point at a nonexistent platform
        # to exercise the dead-backend paths
        jax.config.update("jax_platforms", forced)
    ensure_compile_cache()
    backend, devices = jax.default_backend(), jax.devices()
    result["backend"] = backend
    log(f"backend: {backend}, devices: {devices}")

    # BASELINE config 4 geometry: 9x 12MP (4000x3000), vertical/min.
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
            for _ in range(n_images)]
    specs = [ImageSpec(w, h) for _ in imgs]
    plan = solve(specs, StitchOptions(direction="vertical", mode="min",
                                      supersample=False, max_images=None))
    out_mp = plan.canvas_w * plan.canvas_h / 1e6
    log(f"canvas: {plan.canvas_w}x{plan.canvas_h} = {out_mp:.1f} MP")

    fn_impl = _xla_program(plan)
    staged = imgs
    fn = jax.jit(fn_impl)

    # device inputs live in a holder so a retry's reset can re-stage them
    # after a backend abort invalidates the old buffers
    holder: dict = {}

    def _put_inputs():
        holder["dev"] = [jax.device_put(x) for x in staged]
        jax.block_until_ready(holder["dev"])

    t0 = time.perf_counter()
    _retry_transient(_put_inputs, label="h2d")
    log(f"H2D {sum(x.nbytes for x in staged) / 1e6:.0f} MB: "
        f"{time.perf_counter() - t0:.2f}s")

    def _first_call():
        o = fn(holder["dev"])
        o.block_until_ready()
        return o

    t0 = time.perf_counter()
    out = _retry_transient(_first_call, reset=_put_inputs, label="first")
    log(f"first call (compile+run): {time.perf_counter() - t0:.1f}s")

    # Run K stitches in one lax.scan with a device-side data dependency
    # (iteration k's input depends on k-1's output scalar) and fetch ONE
    # scalar — the device executes all K jobs serially inside a single
    # dispatch.  Per-job time = slope between two chain lengths.  Images
    # must be jit ARGUMENTS (a closure would bake 324 MB of constants into
    # the program).
    try:
        p50, samples, tmode = _retry_transient(
            lambda: _slope_auto(plan, fn_impl, holder["dev"]),
            reset=_put_inputs, label="slope")
        result["timing_mode"] = "slope_auto"
    except Exception as e:  # noqa: BLE001 — last-ditch cruder timing
        if not _is_transient(e):
            raise
        errors["slope_auto"] = repr(e)
        log(f"slope_auto failed after retries: {e!r}; "
            "falling back to short carried chain")
        _put_inputs()
        p50, samples, tmode = _retry_transient(
            lambda: _slope_time(fn_impl, holder["dev"], k_lo=2, k_hi=10,
                                rounds=3),
            attempts=2, reset=_put_inputs, label="slope-fallback")
        result["timing_mode"] = "carried_fallback"
    if tmode == "ceiling":
        # the value is a per-call ceiling (total/k), NOT a marginal slope:
        # machine-readable so BENCHMARKS regeneration / baseline diffs
        # never silently mix the two metrics
        result["ceiling_fallback"] = True
    log(f"per-job device time (slope): {p50:.2f} ms  "
        f"samples={['%.2f' % s for s in samples]}")
    log(f"({out_mp / (p50 / 1000):.0f} MP/s output, "
        f"{n_images * w * h / 1e6 / (p50 / 1000):.0f} MP/s input)")
    result.update({
        "value": round(p50, 3),
        # the 50 ms target is the 9x12MP headline's; smoke geometry gets none
        "vs_baseline": (None if result.get("smoke")
                        else round(50.0 / p50, 3)),
        "out_megapixels": round(out_mp, 1),
        "mp_per_sec_out": round(out_mp / (p50 / 1000.0), 1),
    })

    # secondary (stderr-only): resize-heavy variant — mixed sizes resample
    # every image (config-3-like), no copy fast path; headline geometry only
    if not result.get("smoke"):
        try:
            _bench_resize_heavy(rng)
        except Exception as e:  # noqa: BLE001 — stderr-only extra
            log(f"resize-heavy secondary failed: {e!r}")

    # parity spot check against the float64 oracle — three sampled bands
    # (band-windowed oracle: the full f64 pass on 108 MP takes ~100 s, so
    # neither side fetches/computes the whole canvas)
    try:
        from imagestitching.core import oracle
        band = min(256, plan.canvas_h)
        slice_fn = jax.jit(lambda o, r: jax.lax.dynamic_slice(
            o, (r, 0, 0), (band, plan.canvas_w, 3)))
        starts = sorted({0, max(0, plan.canvas_h // 2 - band // 2),
                         plan.canvas_h - band})
        diff = 0
        for r in starts:
            got_band = _retry_transient(
                lambda r=r: np.asarray(slice_fn(out, r)), label="parity")
            want_band = oracle.stitch_rows(plan, imgs, r, r + band)
            diff = max(diff, int(np.abs(got_band.astype(np.int16)
                                        - want_band.astype(np.int16)).max()))
        log(f"parity max|diff| vs oracle ({len(starts)} sampled bands): "
            f"{diff}")
        result["parity_max_diff"] = diff
    except Exception as e:  # noqa: BLE001 — keep the p50 even so
        errors["parity"] = repr(e)
        log(f"parity check failed: {e!r}")


def _bench_resize_heavy(rng) -> None:
    import jax
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec, solve

    sizes = [(4000, 3000), (3600, 2700), (3200, 2400), (2800, 2100),
             (4000, 2250), (3000, 3000), (3840, 2160), (2400, 3200),
             (3500, 2625)]
    imgs2 = [rng.integers(0, 256, (hh, ww, 3), np.uint8)
             for ww, hh in sizes]
    specs2 = [ImageSpec(ww, hh) for ww, hh in sizes]
    plan2 = solve(specs2, StitchOptions(direction="vertical", mode="min",
                                        supersample=False,
                                        max_images=None))
    fn2_impl = _xla_program(plan2)
    holder: dict = {}

    def _put():
        holder["dev"] = [jax.device_put(x) for x in imgs2]
        jax.block_until_ready(holder["dev"])

    _retry_transient(_put, label="h2d-2")
    p50_2, s2, tm2 = _retry_transient(
        lambda: _slope_auto(plan2, fn2_impl, holder["dev"], rounds=3),
        reset=_put, label="slope-2")
    mp2 = plan2.canvas_w * plan2.canvas_h / 1e6
    log(f"resize-heavy 9-image job ({mp2:.0f} MP out): {p50_2:.2f} ms "
        f"({mp2 / (p50_2 / 1000):.0f} MP/s)  samples={s2}"
        + (" [CEILING fallback]" if tm2 == "ceiling" else ""))


def _bench_end_to_end(result: dict, n_images: int, w: int, h: int,
                      runs: int = 3, budget_s: float = 240.0,
                      device_dead: bool = False) -> None:
    """Disk-to-disk wall clock for config 4, in two variants (VERDICT r1 #2).

    * ``e2e_*`` — the literal config 4 (9 equal 12 MP JPEGs).  Equal-size
      concat is a pure-blit plan, so `api.stitch_to_file(stream="auto")`
      takes the zero-device-round-trip path: decode pool -> host band
      assembly -> content-adaptive native PNG encode.  The canvas never
      exists on either side of the link (the reference's own hot path
      degenerates to drawImage blits there too, index.js:1423-1431).
    * ``e2e_resample_*`` — the same bytes-scale job with mixed sizes, which
      forces real resampling: decode pool -> H2D -> XLA composite ->
      streamed D2H overlapped with the incremental encode -> file.
      `e2e_resample_excl_readback_ms` is the same pipeline minus the
      readback.

    Time-bounded: each variant stops after its budget once >=2 runs landed
    (run 0 warms compiles), so a slow sandbox never starves the headline.
    Each variant's JSON carries ``_ms_min``/``_ms_max``/``_runs`` next to
    the p50 — a bare median hides the spread (VERDICT r2 weak #8).

    Degradation (VERDICT r3 #2): with the device phase failed, the blit
    variant is capped at 2 runs and the resample variant — which REQUIRES
    the device — is skipped outright.  Both variants also yield to the
    process self-deadline.  Results land in ``result`` variant-by-variant
    so an emergency emission carries whatever already completed.
    """
    hang = float(os.environ.get("BENCH_TEST_HANG_S", "0"))
    if hang:  # test hook: park here so kill/deadline paths are testable
        log(f"bench: test hook BENCH_TEST_HANG_S={hang:.0f} — sleeping")
        time.sleep(hang)
    if device_dead:
        runs = min(runs, 2)
        log("e2e: device phase failed — blit variant capped at 2 runs, "
            "resample variant skipped (it requires the device)")
    budget_s = min(budget_s, max(30.0, _remaining_s() - 60.0))
    result.update(_e2e_variant([(w, h)] * n_images, runs, budget_s, "e2e_"))
    if device_dead:
        result["e2e_resample_skipped"] = "device backend failed"
        return
    if _remaining_s() < 90.0:
        result["e2e_resample_skipped"] = "self-deadline too close"
        log("e2e: skipping resample variant — self-deadline too close")
        return
    mixed = [(4000, 3000), (3600, 2700), (3200, 2400), (2800, 2100),
             (4000, 2250), (3000, 3000), (3840, 2160), (2400, 3200),
             (3500, 2625)]
    result.update(_e2e_variant(mixed[:n_images], min(runs, 2),
                               min(budget_s / 2, _remaining_s() - 30.0),
                               "e2e_resample_"))


def _fixture_paths(sizes, quality: int = 90):
    """Deterministic e2e fixture JPEGs in a content-keyed cache dir.

    Generating 9x 12 MP JPEGs takes minutes on one core and the bytes are
    a pure function of (sizes, seed, quality).  The cache lives in
    ``.bench_fixtures/`` inside the checkout unless ``BENCH_FIXTURE_DIR``
    says otherwise.  Returns ``(paths, cached)``."""
    import hashlib
    import shutil
    import tempfile

    from imagestitching.imgio import codec

    key = hashlib.sha1(repr(("e2e-fixtures-v1", tuple(sizes), 7, quality))
                       .encode()).hexdigest()[:16]
    base = os.environ.get("BENCH_FIXTURE_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_fixtures")
    d = os.path.join(base, key)
    names = [f"{i}.jpg" for i in range(len(sizes))]
    paths = [os.path.join(d, n) for n in names]

    def _valid() -> bool:
        return os.path.exists(os.path.join(d, "COMPLETE")) and all(
            os.path.exists(p) and os.path.getsize(p) > 0 for p in paths)

    if _valid():
        return paths, True
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base, prefix=key + ".tmp.")
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    for i, (w, h) in enumerate(sizes):
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        codec.encode(os.path.join(tmp, names[i]), arr, quality=quality)
    with open(os.path.join(tmp, "COMPLETE"), "w"):
        pass
    try:
        os.rename(tmp, d)
    except OSError:
        # d already exists.  NEVER delete a VALID dir here — a concurrent
        # bench that passed the validity check may be mid-read of its
        # JPEGs (an unconditional rmtree-before-rename yanked a live cache
        # out from under it); adopt the winner's copy instead.  An invalid
        # leftover (stale partial, corrupt COMPLETE) has no possible live
        # reader — its check would have failed too — so replacing is safe.
        if _valid():
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            shutil.rmtree(d, ignore_errors=True)
            try:
                os.rename(tmp, d)
            except OSError:             # concurrent generator won after all
                shutil.rmtree(tmp, ignore_errors=True)
    log(f"fixtures: generated {len(sizes)} JPEGs in "
        f"{time.perf_counter() - t0:.1f}s -> {d}")
    return paths, False


def _e2e_variant(sizes, runs: int, budget_s: float, prefix: str) -> dict:
    import shutil
    import statistics as _stats
    import tempfile

    from imagestitching import api
    from imagestitching.config import MemoryBudget, RuntimeConfig

    d = tempfile.mkdtemp(prefix="stitch_e2e_")
    try:
        paths, cached = _fixture_paths(sizes)
        src_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        log(f"{prefix}: {len(sizes)} JPEGs on disk, {src_mb:.0f} MB "
            f"({'cached' if cached else 'generated'})")
        # no RAM bitmap cache: every run pays real decodes
        cfg = RuntimeConfig(overlap="always", budget=MemoryBudget(
            host_cache_pixels=0, host_cache_entries=0))

        results = []
        strategy = None
        t_all = time.perf_counter()
        canvas_shape = None
        for r in range(runs):               # run 0 warms compiles
            t0 = time.perf_counter()
            out_path = os.path.join(d, "out.png")
            # level 3: ~2x faster lossless encode, same bytes on noise
            _, m = api.stitch_to_file(paths, out_path, png_compression=3,
                                      config=cfg, return_metrics=True)
            t1 = time.perf_counter()
            canvas_shape = (m.canvas_h, m.canvas_w)
            strategy = m.strategy
            results.append({"total_ms": (t1 - t0) * 1000,
                            "decode_wall_ms": m.prepare_s * 1000,
                            "device_drain_ms": m.compute_s * 1000,
                            "transport_rtt_ms": m.transport_rtt_s * 1000,
                            "stage_wait_ms": m.stage_wait_s * 1000,
                            "stage_wait_max_ms": m.stage_wait_max_s * 1000,
                            "export_wall_ms": m.export_s * 1000,
                            "readback_busy_ms": m.readback_s * 1000,
                            "encode_busy_ms": m.encode_s * 1000})
            log(f"{prefix}run {r} [{strategy}]: "
                f"total {results[-1]['total_ms']:.0f} ms  "
                f"(decode {results[-1]['decode_wall_ms']:.0f}, "
                f"drain {results[-1]['device_drain_ms']:.0f}, "
                f"stage-wait {results[-1]['stage_wait_ms']:.0f}, "
                f"export {results[-1]['export_wall_ms']:.0f} = "
                f"readback {results[-1]['readback_busy_ms']:.0f} || "
                f"encode {results[-1]['encode_busy_ms']:.0f})")
            if len(results) >= 2 and time.perf_counter() - t_all > budget_s:
                log(f"{prefix}: time budget {budget_s:.0f}s reached after "
                    f"{len(results)} runs")
                break
            if _remaining_s() < 60.0:
                log(f"{prefix}: self-deadline too close after "
                    f"{len(results)} runs")
                break
        warm = results[1:] if len(results) > 1 else results
        totals = [r["total_ms"] for r in warm]
        p50 = _stats.median(totals)
        phases = {k: round(_stats.median(r[k] for r in warm), 1)
                  for k in warm[0]}
        mp = canvas_shape[0] * canvas_shape[1] / 1e6
        # with the export overlap, an instant link leaves decode + drain +
        # encode busy (NOT p50 minus readback — that would also subtract
        # encode time hidden under it)
        excl = (phases["decode_wall_ms"] + phases["device_drain_ms"]
                + phases["encode_busy_ms"])
        return {
            prefix + "fixtures_cached": cached,
            prefix + "ms": round(p50, 1),
            prefix + "ms_min": round(min(totals), 1),
            prefix + "ms_max": round(max(totals), 1),
            prefix + "runs": len(warm),
            prefix + "mp_per_sec": round(mp / (p50 / 1000), 1),
            prefix + "excl_readback_ms": round(excl, 1),
            prefix + "phases": phases,
            prefix + "strategy": strategy,
            prefix + "png_level": 3,
            prefix + "host_cores": os.cpu_count(),
        }
    except Exception as e:  # noqa: BLE001 — e2e must not kill the headline
        log(f"{prefix} bench failed: {e!r}")
        return {prefix + "ms": None, prefix + "error": repr(e)}
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    if "--smoke" in sys.argv[1:]:
        # tiny-geometry pass of the full structure (device + e2e), for
        # testing the resilience plumbing without 12 MP compiles
        main(n_images=2, w=96, h=64, guard_process=True)
    else:
        main(guard_process=True)
