"""XLA engine vs NumPy-oracle parity (SURVEY.md §4(1),(3)).

The oracle uses float64 direct-gather sampling; the XLA engine uses float32
take/matmul formulations.  Contract: uint8 outputs agree within 1 step.
"""

import numpy as np
import pytest

from imagestitching.config import CanvasLimits, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.ops import xla_compose

rng = np.random.default_rng(42)


def rand_img(w, h, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def assert_parity(plan, images, atol=1):
    want = oracle.stitch(plan, images)
    got = xla_compose.stitch(plan, images)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= atol, f"max diff {diff.max()} at {np.unravel_index(diff.argmax(), diff.shape)}"


def plan_for(specs, **kw):
    kw.setdefault("supersample", False)
    limits = kw.pop("limits", None)
    return solve(specs, StitchOptions(**kw), limits)


def test_identity_concat():
    imgs = [rand_img(32, 16), rand_img(32, 24)]
    plan = plan_for([ImageSpec(32, 16), ImageSpec(32, 24)])
    # identical widths -> pure concat: must be *exact*
    assert_parity(plan, imgs, atol=0)


def test_downscale_parity():
    imgs = [rand_img(64, 48), rand_img(32, 32)]
    plan = plan_for([ImageSpec(64, 48), ImageSpec(32, 32)], mode="min")
    assert_parity(plan, imgs)


def test_upscale_parity():
    imgs = [rand_img(16, 16), rand_img(48, 32)]
    plan = plan_for([ImageSpec(16, 16), ImageSpec(48, 32)], mode="max")
    assert_parity(plan, imgs)


def test_horizontal_with_gap():
    imgs = [rand_img(30, 40), rand_img(50, 20)]
    plan = plan_for([ImageSpec(30, 40), ImageSpec(50, 20)],
                    direction="horizontal", mode="min", gap=7)
    assert_parity(plan, imgs)


def test_original_mode_centering():
    imgs = [rand_img(31, 17), rand_img(50, 23)]
    plan = plan_for([ImageSpec(31, 17), ImageSpec(50, 23)], mode="original",
                    gap=3)
    assert_parity(plan, imgs)


@pytest.mark.parametrize("orientation", list(range(1, 9)))
def test_all_orientations(orientation):
    raw = rand_img(24, 18)   # raw 24x18
    specs = [ImageSpec(24, 18, orientation=orientation), ImageSpec(18, 24)]
    imgs = [raw, rand_img(18, 24)]
    plan = plan_for(specs, mode="min")
    assert_parity(plan, imgs)


def test_supersampled_fractional_rects():
    # supersample produces fractional dest rects — the hard sampling case
    limits = CanvasLimits(max_side=10_000, max_pixels=40_000,
                          max_supersample=2.2)
    specs = [ImageSpec(64, 48), ImageSpec(80, 60)]
    imgs = [rand_img(64, 48), rand_img(80, 60)]
    plan = solve(specs, StitchOptions(supersample=True), limits)
    assert plan.supersample > 1.0
    assert_parity(plan, imgs)


def test_scale_down_fractional_gap():
    limits = CanvasLimits(max_side=64, max_pixels=10**9, max_supersample=1.0)
    specs = [ImageSpec(100, 100), ImageSpec(100, 50)]
    imgs = [rand_img(100, 100), rand_img(100, 50)]
    plan = plan_for(specs, gap=13, limits=limits)
    assert plan.scale_down < 1.0
    assert_parity(plan, imgs)


@pytest.mark.parametrize("kind", ["triangle", "box"])
def test_matrix_filters(kind):
    imgs = [rand_img(64, 48), rand_img(32, 32)]
    plan = plan_for([ImageSpec(64, 48), ImageSpec(32, 32)], mode="min",
                    filter=kind)
    assert_parity(plan, imgs)


def test_nine_images_mixed():
    shapes = [(40, 30), (33, 44), (55, 21), (28, 28), (64, 48),
              (17, 19), (50, 50), (23, 61), (45, 27)]
    orients = [1, 3, 6, 8, 2, 4, 5, 7, 1]
    specs = [ImageSpec(w, h, orientation=o)
             for (w, h), o in zip(shapes, orients)]
    imgs = [rand_img(w, h) for (w, h) in shapes]
    plan = plan_for(specs, direction="horizontal", mode="min", gap=2)
    assert_parity(plan, imgs)


def test_grayscale_single_channel():
    imgs = [rand_img(32, 16, 1), rand_img(48, 24, 1)]
    plan = plan_for([ImageSpec(32, 16), ImageSpec(48, 24)], mode="min")
    assert_parity(plan, imgs)


def test_compile_cache_reuse():
    specs = [ImageSpec(32, 16), ImageSpec(32, 24)]
    p1 = plan_for(specs)
    p2 = plan_for(specs)
    c1 = xla_compose.get_compiled(p1)
    c2 = xla_compose.get_compiled(p2)
    assert c1 is c2  # same signature -> same executable


def test_shape_mismatch_raises():
    plan = plan_for([ImageSpec(32, 16)])
    with pytest.raises(ValueError):
        xla_compose.stitch(plan, [rand_img(16, 32)])


def test_lanczos3_filter_all_engines_match_oracle():
    """Lanczos3 rides the same K-tap machinery as every other filter, in
    the resident program and the streamed per-image updates alike."""
    from imagestitching.config import RuntimeConfig
    from imagestitching.runtime import pipeline

    specs = [ImageSpec(97, 64), ImageSpec(48, 80, orientation=6)]
    imgs = [rng.integers(0, 256, (64, 97, 3), np.uint8),
            rng.integers(0, 256, (80, 48, 3), np.uint8)]
    plan = solve(specs, StitchOptions(gap=2, filter="lanczos3",
                                      supersample=False))
    want = oracle.stitch(plan, imgs)
    got_xla = xla_compose.stitch(plan, imgs)
    assert np.abs(got_xla.astype(int) - want.astype(int)).max() <= 1
    got_s = pipeline._run_streamed(plan, imgs, 3, RuntimeConfig(),
                                   lambda *a: None)
    assert np.abs(got_s.astype(int) - want.astype(int)).max() <= 1


def test_lanczos3_constant_image_stays_constant():
    # partition of unity: rows sum to 1 even with negative lobes
    specs = [ImageSpec(200, 150)]
    img = np.full((150, 200, 3), 119, np.uint8)
    for limits_w in (77, 450):   # down- and upscale
        plan = solve(specs, StitchOptions(filter="lanczos3",
                                          supersample=False),
                     CanvasLimits(max_side=limits_w))
        out = xla_compose.stitch(plan, [img])
        assert np.abs(out.astype(int) - 119).max() <= 1


def test_cached_engine_not_shared_across_fractional_offsets():
    """Two plans with identical pixel spans but different sub-pixel phases
    (gap=0.51 vs 0.69) must each match THEIR OWN oracle through the
    signature-keyed compiled cache.  Pre-fix, plan B reused plan A's tap
    weights and came out 45 uint8 levels off (r4 review)."""
    specs = [ImageSpec(100, 50), ImageSpec(100, 60)]
    imgs = [rand_img(100, 50), rand_img(100, 60)]
    pa = plan_for(specs, gap=0.51)
    pb = plan_for(specs, gap=0.69)
    assert pa.signature() != pb.signature()
    assert_parity(pa, imgs)
    assert_parity(pb, imgs)


def test_fractional_variants_share_one_compiled_program():
    """Restored design property: taps are jit ARGS, so plans differing only
    in fractional offsets share the jitted program (shape_signature-keyed)
    while each CompiledStitch binds its own plan's weights."""
    specs = [ImageSpec(100, 50), ImageSpec(100, 60)]
    pa = plan_for(specs, gap=0.51)
    pb = plan_for(specs, gap=0.69)
    assert pa.shape_signature() == pb.shape_signature()
    ca = xla_compose.get_compiled(pa)
    cb = xla_compose.get_compiled(pb)
    assert ca is not cb                      # distinct params bindings
    assert ca._jitted is cb._jitted          # one shared program
    wa = np.concatenate([t["rows"]["w"] for t in ca.params], axis=None)
    wb = np.concatenate([t["rows"]["w"] for t in cb.params], axis=None)
    assert not np.array_equal(wa, wb)        # genuinely different weights


def test_list_background_normalized_and_hashable():
    """StitchOptions.validate() canonicalizes background so a list/ndarray
    background neither breaks signature hashing nor splits cache keys from
    its tuple twin (r4 review)."""
    specs = [ImageSpec(40, 20), ImageSpec(40, 30)]
    pl_list = plan_for(specs, gap=2, background=[10, 20, 30])
    pl_tup = plan_for(specs, gap=2, background=(10, 20, 30))
    assert pl_list.background == (10, 20, 30)
    assert hash(pl_list.signature()) == hash(pl_tup.signature())
    imgs = [rand_img(40, 20), rand_img(40, 30)]
    assert_parity(pl_list, imgs, atol=0)
    with pytest.raises(ValueError):
        plan_for(specs, background=(0, 0))
    with pytest.raises(ValueError):
        plan_for(specs, background=(0, 0, 999))
    with pytest.raises(ValueError):
        plan_for(specs, background="white")
