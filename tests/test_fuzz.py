"""Seeded fuzz: random jobs through every engine vs the float64 oracle.

The strongest safety net in the suite: any drift in layout rounding,
orientation swizzles, tap math, assembly, or engine numerics shows up here.
"""

import numpy as np
import pytest

from imagestitching.config import MemoryBudget, RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.runtime import pipeline


def random_job(rng):
    n = int(rng.integers(1, 6))
    specs, imgs = [], []
    for _ in range(n):
        w = int(rng.integers(3, 120))
        h = int(rng.integers(3, 120))
        o = int(rng.integers(1, 9))
        specs.append(ImageSpec(w, h, orientation=o))
        imgs.append(rng.integers(0, 256, (h, w, 3), np.uint8))
    options = StitchOptions(
        direction=str(rng.choice(["vertical", "horizontal"])),
        mode=str(rng.choice(["min", "max", "original"])),
        gap=float(rng.choice([0, 1, 3.5, 8, 20])),
        supersample=bool(rng.integers(0, 2)),
        background=tuple(int(x) for x in rng.integers(0, 256, 3)),
        filter=str(rng.choice(["bilinear", "bilinear", "triangle", "box"])),
        max_images=None,
    )
    return specs, imgs, options


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_engines_match_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    specs, imgs, options = random_job(rng)
    plan = solve(specs, options)
    if plan.canvas_pixels > 2_000_000:
        pytest.skip("fuzz drew an oversized supersampled canvas")
    want = oracle.stitch(plan, imgs)

    for engine in ("xla", "auto"):
        out, m = pipeline.run(plan, imgs, RuntimeConfig(engine=engine))
        diff = np.abs(out.astype(np.int16) - want.astype(np.int16)).max()
        assert diff <= 1, (
            f"seed {seed}: engine {engine} strategy {m.strategy} "
            f"diff {diff} (plan {plan.canvas_w}x{plan.canvas_h}, "
            f"{options})")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_budget_strategies_match(seed):
    rng = np.random.default_rng(2000 + seed)
    specs, imgs, options = random_job(rng)
    plan = solve(specs, options)
    if plan.canvas_pixels > 1_000_000:
        pytest.skip("oversized")
    want = oracle.stitch(plan, imgs)
    canvas = 3 * plan.canvas_pixels
    # floor tight budgets at the tiler's own minimum feasible peak — below
    # it the clean "raise the budget" MemoryError is the correct response
    from imagestitching.runtime import tiler
    floor = tiler.min_feasible_bytes(plan)
    for budget in [MemoryBudget(hbm_bytes=max(floor, 200_000, canvas * 2)),
                   MemoryBudget(hbm_bytes=max(floor, 150_000, canvas // 2))]:
        out, m = pipeline.run(plan, imgs,
                              RuntimeConfig(engine="xla", budget=budget))
        diff = np.abs(out.astype(np.int16) - want.astype(np.int16)).max()
        assert diff <= 1, (f"seed {seed} strategy {m.strategy} diff {diff}")
