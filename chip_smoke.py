"""Smoke test of the stitch pipeline on one GPU, through its user entry points.

    python chip_smoke.py [--seed N]       # every phase, one card
    python chip_smoke.py --four-cards     # the jobs and space mesh axes only

Phases (one line each; any failure exits non-zero without the final line):

1. setup      devices, the card's name and power limit, native codec build,
              Pillow;
2. compile    the config-3 resample program, with its memory analysis;
3. ladder     config 3 and a mixed ~12 MP job forced through the resident,
              streamed and banded strategies, plus config 4 on the device
              engine, each within one uint8 step of the float64 oracle on
              sampled row bands;
4. e2e        9 mixed ~12 MP JPEGs on disk -> ``api.stitch_to_file`` -> PNG;
5. serve      ``StitchServer(max_batch=64)`` warmed with config 5: 64 jobs of
              that signature plus a few of another, each against the one-job
              device path, 4 against the oracle, and one HTTP request;
6. merge      the overlap scorer on a screenshot chain against its float64
              twin;
7. kernel     warm device time of the XLA resample program for config 3 and
              config 5 at B=64 and its share of the card's bandwidth bound.

Fixtures are made from ``--seed``.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np


def _say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, from a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- sizes

@dataclasses.dataclass
class Sizes:
    """Job geometry of every phase: the BASELINE configs on the card,
    tiny stand-ins in the CPU tests."""

    compile_job: tuple          # (shapes, options) of the compile check
    ladder_jobs: list           # [(name, shapes, options)] per strategy
    blit_job: tuple             # config 4: equal sizes on engine="xla"
    e2e_sizes: list             # (w, h) of the JPEGs on disk
    serve_job: tuple            # the warmed served signature
    serve_batch: int
    other_job: tuple            # a second served signature
    n_other: int
    merge_width: int
    merge_heights: list
    merge_overlaps: list
    kernel_jobs: list           # [(name, shapes, options, batch)]
    space_job: tuple            # the space-sharded job of --four-cards
    jpeg_quality: int = 90


def full_sizes() -> Sizes:
    from benchmarks import configs as c
    from imagestitching.config import StitchOptions
    other = (c.CONFIG5[0][:5],
             StitchOptions(mode="max", gap=2, supersample=False))
    return Sizes(
        compile_job=c.CONFIG3,
        ladder_jobs=[("config3", *c.CONFIG3), ("mixed12mp", *c.MIXED_12MP)],
        blit_job=c.CONFIG4,
        e2e_sizes=[(w, h) for (w, h, _) in c.MIXED_12MP[0]],
        serve_job=c.CONFIG5, serve_batch=c.CONFIG5_BATCH,
        other_job=other, n_other=3,
        merge_width=1080, merge_heights=[2400, 2340, 2400, 2200, 2400, 1800],
        merge_overlaps=[610, 420, 900, 333, 700],
        kernel_jobs=[("config3", *c.CONFIG3, 1),
                     ("config5", *c.CONFIG5, c.CONFIG5_BATCH)],
        space_job=c.MIXED_12MP)


# --------------------------------------------------------------- helpers

def _images(rng, shapes):
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for (w, h, _) in shapes]


def _plan(shapes, options):
    from imagestitching.core.layout import ImageSpec, solve
    return solve([ImageSpec(w, h, o) for (w, h, o) in shapes], options)


def _bands(canvas_h: int, band: int = 64):
    band = min(band, canvas_h)
    return sorted({0, max(0, canvas_h // 2 - band // 2), canvas_h - band}), band


def sampled_parity(plan, images, out) -> int:
    """Max |out - oracle| over three row bands (top, middle, bottom)."""
    from imagestitching.core import oracle
    starts, band = _bands(plan.canvas_h)
    diff = 0
    for r in starts:
        got = np.asarray(out[r:r + band]).astype(np.int16)
        want = oracle.stitch_rows(plan, images, r, r + band).astype(np.int16)
        diff = max(diff, int(np.abs(got - want).max()))
    return diff


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def budget_for(strategy: str, plan, channels: int = 3):
    """A MemoryBudget under which the governor picks ``strategy``; for
    banded the tallest band that still demotes (fewest band calls)."""
    from imagestitching.config import MemoryBudget
    from imagestitching.runtime import tiler
    if strategy == "resident":
        return MemoryBudget(hbm_bytes=tiler.resident_peak_bytes(plan, channels))
    if strategy == "streamed":
        return MemoryBudget(
            hbm_bytes=tiler.resident_peak_bytes(plan, channels) - 1)
    for band in tiler._band_candidates(plan.canvas_h):
        b = MemoryBudget(hbm_bytes=tiler._banded_peak(plan, band, channels))
        if tiler.plan_execution(plan, b, channels).strategy == "banded":
            return b
    raise AssertionError("no budget demotes this plan to banded")


def device_peaks_mb():
    """Every device's allocator high-water mark in MB; None where the
    backend keeps no allocator statistics (the CPU)."""
    import jax
    stats = [d.memory_stats() for d in jax.devices()]
    if not all(stats):
        return None
    return [s["peak_bytes_in_use"] / 1e6 for s in stats]


def check_spread(peaks, what: str) -> None:
    """Device 0 holds no more than the others: a batch staged whole on the
    default device and resharded from there shows here as a device 0 peak
    several times the rest."""
    import jax
    if peaks is None:
        _check(jax.devices()[0].platform == "cpu",
               f"{what}: no allocator statistics on the card")
        return
    _check(peaks[0] <= 1.25 * max(peaks[1:]) + 64,
           f"{what}: device 0 peaked at {peaks[0]:.0f} MB, the others at "
           f"{[round(p) for p in peaks[1:]]} MB")


def check_model(peaks, bound_mb: float, what: str) -> None:
    """No device peaks above the tiler's estimate for the jobs it holds
    (10 % and 64 MB of slack): the server sizes batches by that estimate."""
    if peaks is None:
        return
    _check(max(peaks) <= 1.1 * bound_mb + 64,
           f"{what}: a device peaked at {max(peaks):.0f} MB, above the byte "
           f"model's {bound_mb:.0f} MB for the jobs it holds")


def _served_bound_mb(srv, plan, batch: int, devices: int) -> float:
    """The byte model's peak per device for the largest batch the server
    flushes from ``batch`` jobs of ``plan``."""
    from imagestitching.runtime import tiler
    jobs = min(batch, srv.max_batch, srv._effective_cap(plan, 3))
    return tiler.resident_peak_bytes(plan, 3) * -(-jobs // devices) / 1e6


def _fmt_peaks(peaks) -> str:
    return "not measured" if peaks is None else str([round(p) for p in peaks])


# ---------------------------------------------------------------- phases

def phase_setup(sizes: Sizes, seed: int) -> str:
    import jax
    from imagestitching.imgio import native

    d = jax.devices()[0]
    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    try:
        import PIL
        pil = f"Pillow {PIL.__version__}"
    except ImportError:
        pil = "Pillow missing"
    _check(built or pil != "Pillow missing",
           "no image codec: native build failed and Pillow is missing")
    return (f"devices {jax.devices()} kind {d.device_kind!r}; native codec "
            f"{'built' if built else 'FAILED to build'} ({build_s:.1f} s); "
            f"{pil}")


def phase_compile(sizes: Sizes, seed: int) -> str:
    import jax
    from bench import _xla_program

    shapes, options = sizes.compile_job
    plan = _plan(shapes, options)
    args = [jax.ShapeDtypeStruct((p.raw_h, p.raw_w, 3), np.uint8)
            for p in plan.placements]
    t0 = time.perf_counter()
    compiled = jax.jit(_xla_program(plan)).lower(args).compile()
    return (f"canvas {plan.canvas_w}x{plan.canvas_h} compiled in "
            f"{time.perf_counter() - t0:.2f} s; {compiled.memory_analysis()}")


def phase_ladder(sizes: Sizes, seed: int) -> str:
    from imagestitching import api
    from imagestitching.config import RuntimeConfig
    from imagestitching.core.layout import ImageSpec

    rng = np.random.default_rng(seed)
    parts = []
    for name, shapes, options in sizes.ladder_jobs:
        imgs = _images(rng, shapes)
        specs = [ImageSpec(w, h, o) for (w, h, o) in shapes]
        plan = _plan(shapes, options)
        for strategy in ("resident", "streamed", "banded"):
            cfg = RuntimeConfig(engine="xla",
                                budget=budget_for(strategy, plan))
            t0 = time.perf_counter()
            out, m = api.stitch_arrays(imgs, specs, options, cfg,
                                       return_metrics=True)
            wall = time.perf_counter() - t0
            _check(m.strategy == strategy,
                   f"{name}: asked {strategy}, ran {m.strategy}")
            diff = sampled_parity(plan, imgs, out)
            _check(diff <= 1, f"{name}/{strategy}: parity {diff}")
            parts.append(f"{name}/{strategy} parity {diff} {wall:.2f} s")
    shapes, options = sizes.blit_job
    imgs = _images(rng, shapes)
    plan = _plan(shapes, options)
    out, m = api.stitch_arrays(
        imgs, [ImageSpec(w, h, o) for (w, h, o) in shapes], options,
        RuntimeConfig(engine="xla"), return_metrics=True)
    _check(m.strategy in ("resident", "streamed", "banded"),
           f"config4 on engine=xla ran {m.strategy}")
    diff = sampled_parity(plan, imgs, out)
    _check(diff <= 1, f"config4: parity {diff}")
    parts.append(f"config4/{m.strategy} parity {diff} "
                 f"{m.compute_s:.2f} s")
    return "; ".join(parts)


def phase_e2e(sizes: Sizes, seed: int) -> str:
    from imagestitching import api
    from imagestitching.config import StitchOptions
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.imgio import codec, native

    rng = np.random.default_rng(seed + 4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        paths = []
        for i, (w, h) in enumerate(sizes.e2e_sizes):
            p = os.path.join(d, f"{i}.jpg")
            codec.encode(p, rng.integers(0, 256, (h, w, 3), np.uint8),
                         quality=sizes.jpeg_quality)
            paths.append(p)
        out_path = os.path.join(d, "out.png")
        t0 = time.perf_counter()
        _, m = api.stitch_to_file(paths, out_path, png_compression=1,
                                  return_metrics=True)
        wall = time.perf_counter() - t0
        srcs = [codec.decode(p)[0] for p in paths]
        got = codec.decode(out_path)[0]
    plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in srcs],
                 StitchOptions())
    _check(got.shape == (plan.canvas_h, plan.canvas_w, 3),
           f"PNG shape {got.shape}")
    diff = sampled_parity(plan, srcs, got)
    _check(diff <= 1, f"e2e parity {diff}")
    export = "streamed native" if native.available() else "monolithic"
    return (f"{len(paths)} JPEGs -> {got.shape[1]}x{got.shape[0]} PNG "
            f"[{m.strategy}, {export} export] wall {wall:.2f} s; decode "
            f"{m.prepare_s:.2f} s, compute {m.compute_s:.2f} s, readback "
            f"{m.readback_s:.2f} s, encode {m.encode_s:.2f} s, total "
            f"{m.total_s:.2f} s; parity {diff}")


def _served_jobs(rng, shapes, n):
    """``n`` distinct jobs of one geometry: shared noise plus a per-job
    stamp, so every job differs without ``n`` fresh noise draws."""
    base = _images(rng, shapes)
    jobs = []
    for j in range(n):
        imgs = [a.copy() for a in base]
        for a in imgs:
            a[: min(8, a.shape[0]), : min(8, a.shape[1])] = (j * 37) % 256
            a[-1] = rng.integers(0, 256, a.shape[1:], np.uint8)
        jobs.append(imgs)
    return jobs


def phase_serve(sizes: Sizes, seed: int) -> str:
    import base64
    import urllib.request

    from imagestitching.config import StitchOptions
    from imagestitching.core import oracle
    from imagestitching.imgio import codec
    from imagestitching.ops import xla_compose
    from imagestitching.serve.http import StitchHTTPServer
    from imagestitching.serve.server import StitchServer

    rng = np.random.default_rng(seed + 5)
    shapes, options = sizes.serve_job
    oshapes, ooptions = sizes.other_job
    jobs = _served_jobs(rng, shapes, sizes.serve_batch)
    others = _served_jobs(rng, oshapes, sizes.n_other)
    plan, oplan = _plan(shapes, options), _plan(oshapes, ooptions)
    # a deadline long enough for the whole submit loop: batches are then
    # set by the server's cap, not by how fast this host submits
    with StitchServer(max_batch=sizes.serve_batch, max_wait_s=1.0) as srv:
        t0 = time.perf_counter()
        srv.warmup([(h, w) for (w, h, _) in shapes], options,
                   batch_sizes=(sizes.serve_batch,))
        srv.warmup([(h, w) for (w, h, _) in oshapes], ooptions,
                   batch_sizes=(sizes.n_other,))
        warm_s = time.perf_counter() - t0
        warm_peaks = device_peaks_mb()
        t0 = time.perf_counter()
        futs = [srv.submit(j, options) for j in jobs]
        ofuts = [srv.submit(j, ooptions) for j in others]
        outs = [f.result(timeout=600) for f in futs]
        oouts = [f.result(timeout=600) for f in ofuts]
        serve_s = time.perf_counter() - t0
        serve_peaks = device_peaks_mb()
        bound = _served_bound_mb(srv, plan, len(jobs), 1)
        worst = 0
        for p, js, os_ in ((plan, jobs, outs), (oplan, others, oouts)):
            for imgs, out in zip(js, os_):
                one = xla_compose.stitch(p, imgs)
                worst = max(worst, int(np.abs(out.astype(np.int16)
                                              - one.astype(np.int16)).max()))
        _check(worst <= 1, f"served vs one-job device path: {worst}")
        picks = rng.choice(len(jobs), size=min(4, len(jobs)), replace=False)
        odiff = max(int(np.abs(outs[i].astype(np.int16) - oracle.stitch(
            plan, jobs[i]).astype(np.int16)).max()) for i in picks)
        _check(odiff <= 1, f"served vs oracle: {odiff}")

        # one HTTP request from a thread of this process
        small = [rng.integers(0, 256, (48, 64, 3), np.uint8),
                 rng.integers(0, 256, (40, 56, 3), np.uint8)]
        reply = {}
        with StitchHTTPServer(port=0, server=srv) as web:
            body = json.dumps({"images": [
                base64.b64encode(codec.encode_bytes(a, "png")).decode()
                for a in small], "gap": 2}).encode()

            def post():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{web.port}/stitch", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    reply["status"], reply["body"] = r.status, r.read()

            t = threading.Thread(target=post)
            t.start()
            t.join(timeout=300)
        _check(not t.is_alive() and reply.get("status") == 200,
               f"HTTP reply {reply.get('status')}")
        got = codec.decode(reply["body"])[0]
        want = oracle.stitch(_plan([(64, 48, 1), (56, 40, 1)],
                                   StitchOptions(gap=2)), small)
        hdiff = int(np.abs(got.astype(np.int16)
                           - want.astype(np.int16)).max())
        _check(hdiff <= 1, f"HTTP parity {hdiff}")
        stats = srv.stats()
    _check(stats["failed"] == 0 and stats["pending"] == 0, f"stats {stats}")
    check_model(serve_peaks, bound, "served batch")
    return (f"warmup {warm_s:.2f} s; {len(jobs)}+{len(others)} jobs served in "
            f"{serve_s:.2f} s; peak MB after warm-up {_fmt_peaks(warm_peaks)}"
            f", after serving {_fmt_peaks(serve_peaks)} (model {bound:.0f});"
            f" vs one-job path "
            f"{worst}, vs oracle {odiff}; HTTP 200 parity {hdiff}; "
            f"stats {stats}")


def screenshot_chain(rng, width, heights, overlaps):
    """A tall seeded 'page' cut into overlapping screenshots."""
    total = heights[0] + sum(h - o for h, o in zip(heights[1:], overlaps))
    page = rng.integers(0, 256, (total, width, 3), np.uint8)
    shots, top = [], 0
    for i, h in enumerate(heights):
        shots.append(page[top: top + h].copy())
        if i < len(overlaps):
            top += h - overlaps[i]
    return page, shots


def phase_merge(sizes: Sizes, seed: int) -> str:
    from imagestitching import api
    from imagestitching.config import StitchOptions
    from imagestitching.ops import overlap

    rng = np.random.default_rng(seed + 6)
    page, shots = screenshot_chain(rng, sizes.merge_width,
                                   sizes.merge_heights, sizes.merge_overlaps)
    worst = 0.0
    for a, b in zip(shots, shots[1:]):
        k = min(32, a.shape[0], b.shape[0])
        o_max = min(int(0.5 * min(a.shape[0], b.shape[0])), b.shape[0] - 1)
        region, template = a[a.shape[0] - o_max:], b[:k]
        dev = overlap._scores(region, template, device=True)
        ref = overlap._scores_numpy(region, template)
        _check(int(np.argmin(dev)) == int(np.argmin(ref)),
               "device and float64 scorers disagree on the best offset")
        worst = max(worst, float(np.abs(dev - ref).max()))
    # f32 at HIGHEST precision against float64: the row-energy cumsum over
    # <= a few thousand rows bounds the error near 1e-6; TF32 would not
    _check(worst <= 1e-4, f"scores differ by {worst:.2e} > 1e-4")
    trims = overlap.detect_trims(shots, "vertical")
    _check(trims == [0] + list(sizes.merge_overlaps), f"trims {trims}")
    out = api.stitch_arrays(shots, options=StitchOptions(
        merge_overlap=True, merge_threshold=0.0))
    _check(np.array_equal(out, page), "merged chain != the page")
    return (f"{len(shots)} screenshots {sizes.merge_width} wide: argmin "
            f"agrees, max |score - float64| {worst:.2e} (tolerance 1e-4), "
            f"trims {trims}, merged page exact")


def _device_ms(fn, args, n=20) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_kernel(sizes: Sizes, seed: int) -> str:
    import jax

    from benchmarks.peaks import bandwidth_share, peak
    from imagestitching.parallel.batch import BatchedStitch

    kind = jax.devices()[0].device_kind
    bw = peak(kind)["hbm_bytes_per_s"]
    key = jax.random.PRNGKey(seed)
    parts = []
    x = jax.numpy.zeros((1 << 30,), jax.numpy.uint8)
    copy_ms = _device_ms(jax.jit(lambda a: a + 1), (x,))
    del x
    parts.append(f"uint8 1 GiB copy {copy_ms:.3f} ms = "
                 f"{bandwidth_share(kind, 2 << 30, copy_ms / 1e3):.1%}")
    for name, shapes, options, batch in sizes.kernel_jobs:
        plan = _plan(shapes, options)
        stacks = [jax.random.randint(jax.random.fold_in(key, i),
                                     (batch, h, w, 3), 0, 256,
                                     jax.numpy.int32).astype(jax.numpy.uint8)
                  for i, (w, h, _) in enumerate(shapes)]
        fn = BatchedStitch(plan, batch)._jitted
        ms = _device_ms(fn, (stacks,))
        nbytes = (sum(int(s.size) for s in stacks)
                  + batch * plan.canvas_h * plan.canvas_w * 3)
        share = bandwidth_share(kind, nbytes, ms / 1e3)
        parts.append(f"{name} B={batch}: {ms:.3f} ms, {nbytes / 1e6:.1f} MB "
                     f"-> {nbytes / ms / 1e6:.0f} GB/s = {share:.1%} of "
                     f"{bw / 1e12:.2f} TB/s (memory-bound)")
        del stacks
    return "; ".join(parts)


PHASES = [("setup", phase_setup), ("compile", phase_compile),
          ("ladder", phase_ladder), ("e2e", phase_e2e),
          ("serve", phase_serve), ("merge", phase_merge),
          ("kernel", phase_kernel)]


# ------------------------------------------------------------ four cards

def phase_space_mesh(sizes: Sizes, seed: int) -> str:
    import jax

    from imagestitching import api
    from imagestitching.config import MemoryBudget, RuntimeConfig
    from imagestitching.core.layout import ImageSpec
    from imagestitching.parallel import mesh as pmesh
    from imagestitching.runtime import tiler

    rng = np.random.default_rng(seed + 7)
    shapes, options = sizes.space_job
    plan = _plan(shapes, options)
    imgs = _images(rng, shapes)
    n = len(jax.devices())
    per_card = tiler.sharded_peak_bytes(plan, n, 3)
    cfg = RuntimeConfig(mesh=pmesh.make_mesh((1, n)),
                        budget=MemoryBudget(hbm_bytes=per_card))
    t0 = time.perf_counter()
    out, m = api.stitch_arrays(imgs, [ImageSpec(w, h, o)
                                      for (w, h, o) in shapes], options,
                               cfg, return_metrics=True)
    wall = time.perf_counter() - t0
    peaks = device_peaks_mb()
    _check(m.strategy == "space-sharded", f"ran {m.strategy}")
    check_spread(peaks, "space-sharded job")
    diff = sampled_parity(plan, imgs, out)
    _check(diff <= 1, f"space-sharded parity {diff}")
    return (f"canvas {plan.canvas_w}x{plan.canvas_h} over {n} devices at "
            f"{per_card / 1e6:.0f} MB per card in {wall:.2f} s; peak MB per "
            f"device {_fmt_peaks(peaks)}; parity {diff}")


def phase_jobs_mesh(sizes: Sizes, seed: int) -> str:
    import jax

    from imagestitching.parallel.batch import BatchedStitch
    from imagestitching.serve.server import StitchServer

    rng = np.random.default_rng(seed + 5)
    shapes, options = sizes.serve_job
    plan = _plan(shapes, options)
    jobs = _served_jobs(rng, shapes, sizes.serve_batch)
    with StitchServer(max_batch=sizes.serve_batch, max_wait_s=1.0,
                      use_mesh=True) as srv:
        srv.warmup([(h, w) for (w, h, _) in shapes], options,
                   batch_sizes=(sizes.serve_batch,))
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [srv.submit(j, options) for j in jobs]]
        serve_s = time.perf_counter() - t0
        # read before anything else of this phase touches a device
        peaks = device_peaks_mb()
        n_dev = srv.mesh.shape["jobs"]
        bound = _served_bound_mb(srv, plan, len(jobs), n_dev)
        bs = srv._get_compiled(plan, sizes.serve_batch)
        stats = srv.stats()
    check_spread(peaks, "served batch")
    check_model(peaks, bound, "served batch")
    stacks = [np.stack([j[i] for j in jobs]) for i in range(len(shapes))]
    dev_out = bs._jitted(bs.stage(stacks))
    holders = {s.device for s in dev_out.addressable_shards}
    _check(len(holders) == len(jax.devices()),
           f"batch output on {len(holders)} of {len(jax.devices())} devices")
    del dev_out
    one = BatchedStitch(plan, sizes.serve_batch)(stacks)   # one card
    worst = max(int(np.abs(o.astype(np.int16)
                           - one[i].astype(np.int16)).max())
                for i, o in enumerate(outs))
    _check(worst <= 1, f"mesh-served vs one-card: {worst}")
    return (f"{len(jobs)} jobs over {n_dev} devices in {serve_s:.2f} s; "
            f"output shards on {len(holders)} devices; peak MB per device "
            f"after serving {_fmt_peaks(peaks)} (model {bound:.0f}); vs one "
            f"card {worst}; "
            f"stats {stats}")


# space first: peaks are lifetime high-water marks, and the served batch
# peaks higher, so only this order lets each phase's spread check see its
# own allocations
FOUR_CARD_PHASES = [("space-mesh", phase_space_mesh),
                    ("jobs-mesh", phase_jobs_mesh)]


# ------------------------------------------------------------------ main

def run_phases(phases, sizes: Sizes, seed: int) -> list:
    """Run every phase, printing one line each; returns the failed names."""
    failed = []
    for i, (name, fn) in enumerate(phases, 1):
        t0 = time.perf_counter()
        try:
            msg = fn(sizes, seed)
            _say(f"phase {i} {name}: ok ({time.perf_counter() - t0:.1f} s) "
                 f"{msg}")
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            failed.append(name)
            _say(f"phase {i} {name}: FAILED ({time.perf_counter() - t0:.1f} "
                 f"s) {type(e).__name__}: {e}")
            traceback.print_exc()
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the jobs- and space-mesh paths on 4 cards")
    args = ap.parse_args(argv)

    import jax

    import imagestitching  # noqa: F401 — fail before any phase without it
    from benchmarks import configs, peaks  # noqa: F401

    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"chip_smoke: needs {want} GPU(s), JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    devs = devs[:want]
    if not args.four_cards and len(jax.devices()) > 1:
        jax.config.update("jax_default_device", devs[0])
    _say(f"card: {card_line()}")
    _say(f"jax {jax.__version__}: {devs} kind {devs[0].device_kind!r}")
    phases = FOUR_CARD_PHASES if args.four_cards else PHASES
    failed = run_phases(phases, full_sizes(), args.seed)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    _say(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
