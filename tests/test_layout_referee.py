"""Pin tests for the sealed layout referee (benchmarks/layout_referee.py)
and PARITY.md deviation #8 — the supersample guard-loop break edge.

The referee is a from-scratch transliteration of index.js:1251-1386,
1526-1554 importing nothing from the package; the soak's ``--layout`` mode
fuzzes ``core/layout.solve`` against it at volume.  These tests pin the one
documented divergence plus a few deterministic cross-checks so the referee
itself is covered by the ordinary suite.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks"))

from layout_referee import display_dims, referee_layout  # noqa: E402

from imagestitching.config import CanvasLimits, StitchOptions
from imagestitching.core.layout import ImageSpec, solve


def test_deviation_8_guard_loop_break_edge():
    """The reproduced divergence from VERDICT r4: target 1000x1000, pixel
    cap 1,040,000, max_supersample 2.2, supersample enabled.

    ratio = sqrt(1.04) = 1.0198 > 1.01, so superSample = 1.0198 and the
    initial rounded canvas is 1020x1020 = 1,040,400 px > cap.  The guard
    multiplies 1.0198 * 0.96 = 0.979 < 1 and the REFERENCE breaks leaving
    canvasOutW/H at the over-cap 1020x1020 (index.js:1379); the repo resets
    to the 1000x1000 target (PARITY.md deviation #8)."""
    limits = CanvasLimits(max_side=1 << 20, max_pixels=1_040_000,
                          max_supersample=2.2)
    ref = referee_layout([(1000, 1000)], "vertical", "original", 0.0,
                         max_side=limits.max_side,
                         max_pixels=limits.max_pixels,
                         max_supersample=limits.max_supersample,
                         supersample_enabled=True)
    assert (ref["canvas_w"], ref["canvas_h"]) == (1020, 1020)
    assert ref["canvas_w"] * ref["canvas_h"] > limits.max_pixels
    assert ref["guard_reset"] is True
    assert ref["super_sample"] == 1.0

    plan = solve([ImageSpec(1000, 1000)],
                 StitchOptions(direction="vertical", mode="original",
                               supersample=True),
                 limits=limits)
    assert (plan.canvas_w, plan.canvas_h) == (1000, 1000)
    assert plan.supersample == 1.0
    assert plan.canvas_pixels <= limits.max_pixels


def test_guard_loop_converging_iterations_match_exactly():
    """When the guard loop converges WITHOUT hitting the break edge, repo
    and reference agree bit-exact (floored shrink iterations included).
    ratio here is large enough that a few 0.96 steps stay >= 1."""
    limits = CanvasLimits(max_side=1 << 20, max_pixels=1_100_000,
                          max_supersample=2.2)
    ref = referee_layout([(1000, 1000)], "vertical", "original", 0.0,
                         max_side=limits.max_side,
                         max_pixels=limits.max_pixels,
                         max_supersample=limits.max_supersample,
                         supersample_enabled=True)
    plan = solve([ImageSpec(1000, 1000)],
                 StitchOptions(direction="vertical", mode="original",
                               supersample=True),
                 limits=limits)
    assert ref["guard_reset"] is False
    assert (plan.canvas_w, plan.canvas_h) == (ref["canvas_w"],
                                              ref["canvas_h"])
    assert plan.supersample == ref["super_sample"]
    assert plan.canvas_pixels <= limits.max_pixels


@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
@pytest.mark.parametrize("mode", ["min", "max", "original"])
@pytest.mark.parametrize("gap", [0.0, 7.0, 3.51])
def test_cross_check_all_modes(direction, mode, gap):
    """Deterministic referee-vs-solve agreement over every direction x mode,
    integer and fractional gaps, mixed orientations, with a tight side cap
    so scale_down < 1 (the floor-centering and rounded-dest-size paths)."""
    specs = [ImageSpec(640, 480), ImageSpec(480, 640, 6),
             ImageSpec(333, 777, 3), ImageSpec(1, 50), ImageSpec(1024, 768)]
    dims = [display_dims(s.raw_w, s.raw_h, s.orientation) for s in specs]
    limits = CanvasLimits(max_side=900, max_pixels=4_000_000,
                          max_supersample=2.6)
    options = StitchOptions(direction=direction, mode=mode, gap=gap,
                            supersample=True)
    plan = solve(specs, options, limits=limits)
    ref = referee_layout(dims, direction, mode, gap,
                         max_side=limits.max_side,
                         max_pixels=limits.max_pixels,
                         max_supersample=limits.max_supersample,
                         supersample_enabled=True)
    assert (plan.out_w, plan.out_h) == (ref["out_w"], ref["out_h"])
    assert plan.scale_down == ref["scale_down"]
    assert plan.supersample == ref["super_sample"]
    if not ref["guard_reset"]:
        assert (plan.canvas_w, plan.canvas_h) == (ref["canvas_w"],
                                                  ref["canvas_h"])
    for p, (dx, dy, dw, dh) in zip(plan.placements, ref["phys_rects"]):
        assert (p.x0, p.y0, p.w, p.h) == (dx, dy, dw, dh)


def test_accumulation_grouping_is_left_associative():
    """The reference's reduce groups ``(sum + draw) + gap`` left-to-right
    (index.js:1265-1269).  Pin solve() to the same grouping by direct
    comparison against the referee on a long fractional-gap strip where the
    two groupings drift through 11 accumulation steps.  (The drift is ULP-
    scale and only flips a rounding at exact .5 boundaries — the referee
    fuzz is the volume search for those; this pins the op order.)"""
    specs = [ImageSpec(997, 613)] * 12
    dims = [(997, 613)] * 12
    gap = 0.1  # not representable in binary — maximizes grouping sensitivity
    for direction, mode in (("vertical", "min"), ("horizontal", "max")):
        plan = solve(specs, StitchOptions(direction=direction, mode=mode,
                                          gap=gap, max_images=None))
        ref = referee_layout(dims, direction, mode, gap,
                             max_side=1 << 20, max_pixels=1 << 40,
                             max_supersample=2.2,
                             supersample_enabled=False)
        assert (plan.out_w, plan.out_h) == (ref["out_w"], ref["out_h"])
        for p, (dx, dy, dw, dh) in zip(plan.placements, ref["phys_rects"]):
            assert (p.x0, p.y0, p.w, p.h) == (dx, dy, dw, dh)


def test_js_round_exact_spec_semantics():
    """Both rounders implement ES-spec Math.round on the EXACT value, via
    DIFFERENT derivations (fractional-part test vs floor(2x) parity): the
    naive floor(x+0.5) carries 1-ULP-below-half doubles over the boundary
    (Math.round(0.49999999999999994) is 0 in every real JS engine, but
    floor(x+0.5) gives 1) — and a shared naive formula on both sides would
    have hidden that divergence class from the fuzz (r5 review)."""
    from layout_referee import _math_round

    from imagestitching.core.layout import _js_round

    below_half = 0.49999999999999994          # largest double < 0.5
    assert below_half < 0.5
    assert _js_round(below_half) == 0
    assert _math_round(below_half) == 0
    import math
    assert math.floor(below_half + 0.5) == 1  # the naive formula's bug
    cases = [(0.0, 0), (0.5, 1), (1.5, 2), (2.5, 3), (0.75, 1),
             (2.4999999999999996, 2), (3.4999999999999996, 3),
             (1e15 + 0.5, 10**15 + 1), (123.0, 123)]
    for x, want in cases:
        assert _js_round(x) == want, x
        assert _math_round(x) == want, x
