"""Measure the 5 BASELINE.md configs on the default JAX device.

Usage: python benchmarks/run_all.py  (run from the repo root, on the card)

Timing uses bench._slope_auto (scan-chained, dispatch-independent; chaining
mode picked per job kind — see bench._slope_time) for single-job configs and
chained dispatch timing for the large batched config.  Each config is
parity-checked against the float64 oracle.  Prints one markdown table
naming the device; writes no file.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bench import _bench_end_to_end, _slope_auto, _xla_program
    from benchmarks import configs
    from imagestitching.core import oracle
    from imagestitching.core.layout import solve
    from imagestitching.parallel import batch as pbatch
    from imagestitching.runtime.jaxcfg import ensure_compile_cache

    ensure_compile_cache()
    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    rows = []

    def single_job(name, config, parity_full=True):
        shapes, options = config
        plan = solve(configs.specs_of(shapes), options)
        imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
                for (w, h, _) in shapes]
        fn_impl = _xla_program(plan)
        dev_imgs = [jax.device_put(x) for x in imgs]
        jax.block_until_ready(dev_imgs)
        out = jax.jit(fn_impl)(dev_imgs)
        out.block_until_ready()
        p50, samples, tmode = _slope_auto(plan, fn_impl, dev_imgs,
                                          k_hi=104, rounds=3)
        if tmode == "ceiling":
            raise RuntimeError(
                "slope timing fell back to the per-call ceiling "
                "(contention-inverted rounds): rerun on an idle host")
        band = plan.canvas_h if parity_full else min(256, plan.canvas_h)
        got = np.asarray(out[:band])
        want = oracle.stitch_rows(plan, imgs, 0, band)
        diff = int(np.abs(got.astype(np.int16)
                          - want.astype(np.int16)).max())
        mp = plan.canvas_w * plan.canvas_h / 1e6
        rows.append((name, f"{plan.canvas_w}x{plan.canvas_h}",
                     f"{p50:.3f} ms", f"{mp / (p50 / 1000):.0f} MP/s", diff))
        log(f"{name}: {p50:.3f} ms parity={diff} samples={samples}")

    single_job("1: 2x 512x512 vertical/min", configs.CONFIG1)
    single_job("2: 9x 1920x1080 vertical/min", configs.CONFIG2)
    single_job("3: 9 mixed+EXIF horizontal/min", configs.CONFIG3,
               parity_full=False)
    single_job("4: 9x 4000x3000 vertical/min", configs.CONFIG4,
               parity_full=False)

    # ---- config 5: 64 concurrent 9-image jobs, one batched program
    B = configs.CONFIG5_BATCH
    shapes5, options5 = configs.CONFIG5
    plan5 = solve(configs.specs_of(shapes5), options5)
    stacks = [jax.device_put(rng.integers(0, 256, (B, h, w, 3), np.uint8))
              for w, h, _ in shapes5]
    jax.block_until_ready(stacks)
    fn5 = pbatch.BatchedStitch(plan5, B)._jitted
    # bump EVERY slot so no placement's work is loop-invariant (hoistable)
    bump = jax.jit(lambda ss, c: [s.at[0, 0, 0, 0].add(c) for s in ss])
    pick = jax.jit(lambda o: o[0, 0, 0, 0])
    out5 = fn5(stacks)
    out5.block_until_ready()

    def chain5(k):
        c = jnp.uint8(0)
        t0 = time.perf_counter()
        for _ in range(k):
            c = pick(fn5(bump(stacks, c)))
        int(c)
        return time.perf_counter() - t0

    chain5(1)
    s5 = [(chain5(5) - chain5(1)) / 4 * 1000 for _ in range(3)]
    p50_5 = statistics.median(s5)
    host = [np.asarray(s[3]) for s in stacks]
    want5 = oracle.stitch(plan5, host)
    diff5 = int(np.abs(np.asarray(out5[3]).astype(np.int16)
                       - want5.astype(np.int16)).max())
    mp5 = plan5.canvas_w * plan5.canvas_h * B / 1e6
    rows.append((f"5: {B}x 9-image batch",
                 f"{B}x {plan5.canvas_w}x{plan5.canvas_h}",
                 f"{p50_5:.1f} ms ({p50_5 / B * 1000:.0f} us/job)",
                 f"{mp5 / (p50_5 / 1000):.0f} MP/s, "
                 f"{B / (p50_5 / 1000):.0f} jobs/s", diff5))
    log(f"5: {p50_5:.1f} ms/batch parity={diff5}")

    # ---- end-to-end rows (disk JPEGs -> ... -> PNG on disk, config 4)
    e2e: dict = {}
    _bench_end_to_end(e2e, 9, 4000, 3000, runs=2)

    lines = [
        f"Device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
        "",
        "| BASELINE config | canvas | p50 | throughput | parity |",
        "|---|---|---|---|---|",
    ]
    lines += [f"| {n} | {c} | {p} | {t} | {d} |" for n, c, p, t, d in rows]
    lines += ["", "| e2e variant (strategy) | p50 | phases (ms) |",
              "|---|---|---|"]
    for prefix, label in (("e2e_", "config 4 (equal sizes)"),
                          ("e2e_resample_", "mixed sizes (resample)")):
        lines.append(f"| {label} ({e2e.get(prefix + 'strategy')}) "
                     f"| {e2e.get(prefix + 'ms')} ms "
                     f"| {e2e.get(prefix + 'phases')} |")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
