"""Layout-solver property tests (SURVEY.md §4(2)).

The geometry is pure math, so we sweep directions x modes x gaps x degenerate
inputs and assert the reference's exact rounding schedule
(pages/index/index.js:1251-1386, 1526-1554).
"""

import math
import itertools

import pytest

from imagestitching.config import CanvasLimits, StitchOptions
from imagestitching.core.layout import ImageSpec, solve

NO_SS = CanvasLimits(max_supersample=1.0)


def opts(**kw):
    kw.setdefault("supersample", False)
    return StitchOptions(**kw)


def test_vertical_min_two_images():
    specs = [ImageSpec(400, 300), ImageSpec(200, 100)]
    plan = solve(specs, opts(direction="vertical", mode="min", gap=0))
    assert plan.out_w == 200
    # unrounded: 300*(200/400) + 100*(200/200) = 150 + 100 = 250
    assert plan.out_h == 250
    p0, p1 = plan.placements
    assert (p0.x0, p0.y0, p0.w, p0.h) == (0.0, 0.0, 200.0, 150.0)
    assert (p1.x0, p1.y0, p1.w, p1.h) == (0.0, 150.0, 200.0, 100.0)


def test_vertical_min_gap():
    specs = [ImageSpec(100, 100), ImageSpec(100, 100), ImageSpec(100, 100)]
    plan = solve(specs, opts(gap=8))
    assert plan.out_w == 100
    assert plan.out_h == 100 * 3 + 8 * 2
    assert plan.placements[1].y0 == 108.0
    assert plan.placements[2].y0 == 216.0
    # gap rows are background-only
    assert plan.placements[0].row_span == (0, 100)
    assert plan.placements[1].row_span == (108, 208)


def test_vertical_max_upscales():
    specs = [ImageSpec(100, 50), ImageSpec(400, 100)]
    plan = solve(specs, opts(mode="max"))
    assert plan.out_w == 400
    # 50*(400/100) + 100*(400/400) = 200 + 100
    assert plan.out_h == 300


def test_vertical_original_centers_with_floor():
    specs = [ImageSpec(101, 50), ImageSpec(400, 100)]
    plan = solve(specs, opts(mode="original"))
    assert plan.out_w == 400 and plan.out_h == 150
    p0 = plan.placements[0]
    # dx = floor((400-101)/2) = 149
    assert p0.x0 == 149.0 and p0.w == 101.0


def test_horizontal_mirrors_vertical():
    specs = [ImageSpec(300, 400), ImageSpec(100, 200)]
    plan = solve(specs, opts(direction="horizontal", mode="min"))
    assert plan.out_h == 200
    # widths: 300*(200/400)=150, 100*(200/200)=100
    assert plan.out_w == 250
    assert plan.placements[1].x0 == 150.0


def test_unrounded_accumulation_then_final_round():
    # three images whose scaled heights are x.33 each: JS keeps floats and
    # rounds only the final sum (index.js:1265-1270, 1318).
    specs = [ImageSpec(300, 100)] * 3
    plan = solve(specs, opts(mode="min"))
    # each drawH = 100*(300/300) = 100 -> trivial; use width 301 for fractions
    specs = [ImageSpec(301, 100)] * 3
    plan = solve(specs, opts(mode="min"))
    per = 100 * (301 / 301)
    assert plan.out_h == max(1, math.floor(3 * per + 0.5))


def test_fractional_sum_rounding_matches_js():
    # heights 100*(250/301) = 83.056...; sum = 249.17 -> round 249, but each
    # drawn image is round(83.056)=83 -> cursor drift is intentional.
    specs = [ImageSpec(301, 100), ImageSpec(250, 100), ImageSpec(301, 100)]
    plan = solve(specs, opts(mode="min"))
    assert plan.out_w == 250
    h0 = 100 * (250 / 301)
    h1 = 100.0
    expected = math.floor(h0 + h1 + h0 + 0.5)
    assert plan.out_h == expected
    assert plan.placements[0].h == round(h0)  # drawn size is rounded
    assert plan.placements[1].y0 == float(round(h0))


def test_orientation_swaps_layout_dims():
    # a 4000x3000 raw image with orientation 6 displays as 3000x4000
    specs = [ImageSpec(4000, 3000, orientation=6), ImageSpec(3000, 4000)]
    plan = solve(specs, opts(mode="min"))
    assert plan.out_w == 3000
    assert plan.out_h == 4000 + 4000


def test_degenerate_1x1():
    for d, m in itertools.product(("vertical", "horizontal"),
                                  ("min", "max", "original")):
        plan = solve([ImageSpec(1, 1), ImageSpec(1, 1)],
                     opts(direction=d, mode=m, gap=3))
        assert plan.canvas_w >= 1 and plan.canvas_h >= 1
        assert plan.out_w >= 1 and plan.out_h >= 1


def test_side_cap_scale_down():
    limits = CanvasLimits(max_side=1000, max_pixels=10**9, max_supersample=1.0)
    specs = [ImageSpec(2000, 2000), ImageSpec(2000, 2000)]
    plan = solve(specs, opts(), limits=limits)
    # out 2000x4000 -> scale = min(1000/2000, 1000/4000) = 0.25
    assert plan.scale_down == 0.25
    assert plan.out_w == 500 and plan.out_h == 1000


def test_pixel_cap_scale_down_floor():
    limits = CanvasLimits(max_side=10**6, max_pixels=1_000_000,
                          max_supersample=1.0)
    specs = [ImageSpec(2000, 1000)]
    plan = solve(specs, opts(), limits=limits)
    s = math.sqrt(1_000_000 / (2000 * 1000))
    assert plan.out_w == max(1, math.floor(2000 * s))
    assert plan.out_h == max(1, math.floor(1000 * s))
    assert plan.out_w * plan.out_h <= 1_000_000


def test_supersample_applies_and_guards():
    limits = CanvasLimits(max_side=10_000, max_pixels=1_000_000,
                          max_supersample=2.2)
    plan = solve([ImageSpec(400, 400)],
                 StitchOptions(supersample=True), limits=limits)
    # ratio = sqrt(1e6/160000) = 2.5 -> ss = 2.2
    assert plan.supersample == pytest.approx(2.2)
    assert plan.canvas_w == round(400 * 2.2)
    assert plan.canvas_w * plan.canvas_h <= 1_000_000
    # placements are in physical pixels
    assert plan.placements[0].w == pytest.approx(400 * 2.2)


def test_supersample_guard_loop_shrinks():
    # pick sizes where round() pushes past the cap so the *0.96 loop runs
    limits = CanvasLimits(max_side=10**6, max_pixels=160_801,  # 401^2
                          max_supersample=2.2)
    plan = solve([ImageSpec(400, 400)], StitchOptions(supersample=True),
                 limits=limits)
    assert plan.canvas_w * plan.canvas_h <= 160_801
    assert plan.supersample >= 1.0


def test_max_images_cap():
    specs = [ImageSpec(10, 10)] * 10
    with pytest.raises(ValueError):
        solve(specs, opts())
    plan = solve(specs, opts(max_images=None))
    assert len(plan.placements) == 10


def test_empty_and_invalid():
    with pytest.raises(ValueError):
        solve([], opts())
    with pytest.raises(ValueError):
        solve([ImageSpec(0, 10)], opts())
    with pytest.raises(ValueError):
        solve([ImageSpec(10, 10, orientation=9)], opts())
    with pytest.raises(ValueError):
        solve([ImageSpec(10, 10)], StitchOptions(direction="diagonal"))


def test_signature_stable_and_hashable():
    specs = [ImageSpec(400, 300), ImageSpec(200, 100)]
    a = solve(specs, opts()).signature()
    b = solve(specs, opts()).signature()
    assert a == b
    assert hash(a) == hash(b)


def test_signature_separates_fractional_offsets():
    """Same integer spans, different sub-pixel tap phase => different key.

    gap=0.51 vs gap=0.69 on these specs round to identical pixel spans and
    canvas dims, but the second image sits at y0=50.51 vs 50.69 — different
    bilinear weights.  Engines bake weights per signature (Pallas at trace
    time, CompiledStitch/BatchedStitch at construction), so collapsing these
    to one key ran job B with job A's weights (45 uint8 levels off its
    oracle; r4 review)."""
    specs = [ImageSpec(100, 50), ImageSpec(100, 60)]
    pa = solve(specs, StitchOptions(gap=0.51))
    pb = solve(specs, StitchOptions(gap=0.69))
    # the collision precondition: shape-identical plans
    assert (pa.canvas_w, pa.canvas_h) == (pb.canvas_w, pb.canvas_h)
    assert all(a.col_span == b.col_span and a.row_span == b.row_span
               for a, b in zip(pa.placements, pb.placements))
    assert pa.placements[1].y0 != pb.placements[1].y0
    assert pa.signature() != pb.signature()
