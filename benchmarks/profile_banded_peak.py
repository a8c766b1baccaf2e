"""Empirical check of the tiler's byte models against the device allocator.

The byte models were derived from code reasoning (which jit args are
simultaneously live — r4s7 f32-intermediates fix, r4s9 sum-over-images
fix); this measures the device allocator's actual high-water mark for one
_BandedExecutor run, and for one whole job forced through the streamed and
the resident strategy, and compares.  A model must BOUND the measured peak
(else plan_execution admits work that OOMs at runtime); the looser it is,
the more budget it wastes — both directions are reported.  Cases run from
the smallest peak to the largest, because the allocator's peak is a
lifetime high-water mark.

Run on the GPU (the CPU backend has no allocator stats):
    python benchmarks/profile_banded_peak.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from benchmarks import configs  # noqa: E402
from imagestitching import api  # noqa: E402
from imagestitching.config import (MemoryBudget, RuntimeConfig,  # noqa: E402
                                   StitchOptions)
from imagestitching.core.layout import ImageSpec, solve  # noqa: E402
from imagestitching.core import geometry  # noqa: E402
from imagestitching.runtime import pipeline, tiler  # noqa: E402


def _stats():
    d = jax.devices()[0]
    s = d.memory_stats()
    return s


def _peak_delta(run, model, label):
    """Run ``run()`` and print its allocator peak over what was resident
    before, beside ``model``; None when the peak did not advance."""
    before = _stats()
    run()
    after = _stats()
    # peak_bytes_in_use is a LIFETIME high-water mark: if an earlier case in
    # this process peaked higher, it never advances during this run and the
    # delta below would report the stale peak, not this case's — detect and
    # flag instead of printing garbage (r4s10 review)
    if after["peak_bytes_in_use"] <= before["peak_bytes_in_use"]:
        print(f"{label}: peak did not advance past an earlier case's "
              f"high-water ({before['peak_bytes_in_use']/1e6:.2f} MB) — run "
              f"this case alone in a fresh process", flush=True)
        return None
    # high-water delta over the run (fresh buffers only; the baseline holds
    # whatever earlier jobs left resident)
    peak = after["peak_bytes_in_use"] - before["bytes_in_use"]
    print(f"{label}: model {model/1e6:.2f} MB, measured peak delta "
          f"{peak/1e6:.2f} MB, model/measured {model/max(1, peak):.2f}x",
          flush=True)
    return peak


def measure(specs, band, filt="bilinear", label=""):
    plan = solve(specs, StitchOptions(supersample=False, filter=filt))
    rng = np.random.default_rng(11)
    oriented = [geometry.orient_array(
        rng.integers(0, 256, (s.height, s.width, 3), np.uint8), s.orientation)
        for s in specs]
    model = tiler._banded_peak(plan, band, 3)
    out = []
    peak = _peak_delta(
        lambda: out.append(pipeline._BandedExecutor(plan, band, 3)
                           .run(oriented)),
        model, f"{label or filt}: canvas {plan.canvas_w}x{plan.canvas_h} "
               f"band {band} n={len(specs)}")
    assert out[0].shape == (plan.canvas_h, plan.canvas_w, 3)
    return model, peak


def measure_strategy(shapes, options, strategy, label):
    """One whole job through ``api.stitch_arrays`` under a budget that
    makes the governor pick ``strategy``; the model is its estimate."""
    specs = [ImageSpec(w, h, o) for (w, h, o) in shapes]
    plan = solve(specs, options)
    resident = tiler.resident_peak_bytes(plan, 3)
    budget = MemoryBudget(
        hbm_bytes=resident if strategy == "resident" else resident - 1)
    ep = tiler.plan_execution(plan, budget, 3)
    assert ep.strategy == strategy, ep
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for (w, h, _) in shapes]
    got = []
    peak = _peak_delta(
        lambda: got.append(api.stitch_arrays(
            imgs, specs, options, RuntimeConfig(engine="xla", budget=budget),
            return_metrics=True)),
        ep.est_peak_bytes, f"{label}: canvas {plan.canvas_w}x"
                           f"{plan.canvas_h} n={len(specs)} {strategy}")
    out, m = got[0]
    assert m.strategy == strategy, m.strategy
    assert out.shape == (plan.canvas_h, plan.canvas_w, 3)
    return ep.est_peak_bytes, peak


def main():
    dev = jax.devices()[0]
    if dev.platform == "cpu" or not dev.memory_stats():
        print("needs an accelerator with allocator stats; aborting")
        return 1
    print(f"platform: {dev.platform} ({dev.device_kind})", flush=True)
    # multi-image: the r4s9 sum-over-images term dominates here
    measure([ImageSpec(1500, 1500)] * 6, 64, label="6x 1500^2 bilinear")
    # single image, deep downscale, wide filter: tap buffers + wide crops
    measure([ImageSpec(3000, 3000), ImageSpec(600, 600)], 128,
            filt="lanczos3", label="downscale lanczos3")
    # tall band (few, large calls)
    measure([ImageSpec(2000, 2000)] * 3, 512, label="3x 2000^2 band 512")
    # whole jobs, streamed below resident (the larger peak last)
    measure_strategy(*configs.MIXED_12MP, "streamed", "mixed 12 MP")
    measure_strategy(*configs.MIXED_12MP, "resident", "mixed 12 MP")
    return 0


if __name__ == "__main__":
    sys.exit(main())
