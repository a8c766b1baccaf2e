"""HBM budget governor + pipeline strategy tests (SURVEY.md §4(4)).

Budget accounting must pick resident/streamed/banded correctly, and every
strategy must produce oracle-parity output.
"""

import numpy as np
import pytest

from imagestitching.config import MemoryBudget, RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.runtime import pipeline, tiler

rng = np.random.default_rng(5)


def rand_img(w, h, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def plan_for(specs, **kw):
    kw.setdefault("supersample", False)
    return solve(specs, StitchOptions(**kw))


def budget(mb):
    return MemoryBudget(hbm_bytes=int(mb * 1e6))


# ----------------------------------------------------------------- tiler

def test_resident_when_plenty():
    plan = plan_for([ImageSpec(100, 100), ImageSpec(100, 100)])
    ex = tiler.plan_execution(plan, budget(1000))
    assert ex.strategy == "resident"
    assert ex.est_peak_bytes <= ex.budget_bytes


def test_streamed_when_sources_dont_fit():
    specs = [ImageSpec(1000, 1000)] * 5
    plan = plan_for(specs)
    canvas = 3 * plan.canvas_w * plan.canvas_h
    # canvas is 15 MB; sources are 5x(3+3.x) MB; give enough for canvas +
    # one source but not all five
    ex = tiler.plan_execution(plan, MemoryBudget(hbm_bytes=2 * canvas + 9_000_000))
    assert ex.strategy == "streamed"


def test_banded_when_canvas_dominates():
    specs = [ImageSpec(2000, 2000)] * 2
    plan = plan_for(specs)
    canvas = 3 * plan.canvas_w * plan.canvas_h      # 24 MB
    ex = tiler.plan_execution(plan, MemoryBudget(hbm_bytes=canvas // 2))
    assert ex.strategy == "banded"
    assert ex.band_rows is not None and ex.band_rows < plan.canvas_h
    assert ex.est_peak_bytes <= ex.budget_bytes


def test_impossible_budget_raises():
    plan = plan_for([ImageSpec(4000, 4000)])
    with pytest.raises(MemoryError):
        tiler.plan_execution(plan, MemoryBudget(hbm_bytes=100_000))


def test_banded_peak_sums_per_image_args():
    # EVERY image's crop + tap buffers are simultaneously-live jit args of
    # one band call (_BandedExecutor.run), so the model must SUM them over
    # images — a max-only model under-counted n-image bands (r4s9 review):
    # n copies of one image must cost strictly more than one, by at least
    # the n-1 extra uint8 crops
    one = plan_for([ImageSpec(1500, 1500)])
    six = plan_for([ImageSpec(1500, 1500)] * 6)
    band = 64
    p1 = tiler._banded_peak(one, band, 3)
    p6 = tiler._banded_peak(six, band, 3)
    # identical per-image geometry: 10*band_canvas differs (canvas_h only
    # affects ranges, canvas_w equal), crops/taps scale with n
    scale = one.placements[0].h / 1500
    support = 1.0 * max(1.0, 1.0 / scale)
    import math
    rows_needed = min(1500, int(math.ceil(band / scale + 2 * support)) + 2)
    crop = 3 * rows_needed * 1500
    assert p6 - p1 >= 5 * crop


def test_banded_model_bounds_live_arg_bytes():
    # reality link on any backend (benchmarks/profile_banded_peak.py checks
    # the whole model against a device allocator): the model's non-canvas terms must
    # bound the ACTUAL bytes of every band call's jit args (all live at
    # once), for multi-image plans and a wide-K filter
    from imagestitching.core import geometry
    specs = [ImageSpec(700, 500), ImageSpec(600, 800), ImageSpec(640, 640)]
    plan = plan_for(specs, filter="lanczos3")
    band = 64
    ex = pipeline._BandedExecutor(plan, band, 3)
    captured = []
    orig = ex._jitted

    def wrap(crops, ri0, rw, rin, ci0, cw):
        captured.append(sum(int(a.nbytes)
                            for lst in (crops, ri0, rw, rin, ci0, cw)
                            for a in lst))
        return orig(crops, ri0, rw, rin, ci0, cw)

    ex._jitted = wrap
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    oriented = [geometry.orient_array(a, s.orientation)
                for a, s in zip(imgs, specs)]
    out = ex.run(oriented)
    parity(out, oracle.stitch(plan, oriented))
    assert captured
    model = tiler._banded_peak(plan, band, 3)
    band_canvas = 3 * plan.canvas_w * band
    assert model - 10 * band_canvas >= max(captured)


def test_fence_limit_capped_at_headroom():
    # the fence floor must never exceed the budget headroom above the
    # canvas: a 64 MB unconditional floor let staged sources pile past a
    # tight budget (r4s9 review)
    plan = plan_for([ImageSpec(1000, 1000)] * 3)
    canvas = 3 * plan.canvas_w * plan.canvas_h
    tight = RuntimeConfig(budget=MemoryBudget(hbm_bytes=canvas + (6 << 20)))
    lim = pipeline._fence_limit(plan, 3, tight)
    assert lim <= tight.budget.hbm_bytes - canvas
    # zero headroom: fence after every image (always safe)
    assert pipeline._fence_limit(
        plan, 3, RuntimeConfig(budget=MemoryBudget(hbm_bytes=canvas))) == 0
    # plentiful budget: floor never binds, headroom//2 as before
    big = RuntimeConfig(budget=MemoryBudget(hbm_bytes=canvas + (1 << 30)))
    assert pipeline._fence_limit(plan, 3, big) == (1 << 30) // 2


def test_band_source_rows_cover_taps():
    plan = plan_for([ImageSpec(100, 333), ImageSpec(50, 100)], mode="min")
    p = plan.placements[0]
    win = tiler.band_source_rows(p, 10, 74)
    assert win is not None
    br0, br1, s_lo, s_hi = win
    from imagestitching.core import geometry
    i0, i1, _ = geometry.bilinear_taps(br0, br1, p.y0, p.h, 333)
    assert s_lo <= i0.min() and s_hi > i1.max()


# ----------------------------------------------------------------- pipeline

def parity(got, want, atol=1):
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= atol


def test_pipeline_resident_matches_oracle():
    specs = [ImageSpec(64, 48), ImageSpec(48, 64, orientation=6)]
    imgs = [rand_img(64, 48), rand_img(48, 64)]
    plan = plan_for(specs, gap=4)
    out, metrics = pipeline.run(plan, imgs, RuntimeConfig(engine="xla"))
    assert metrics.strategy == "resident"
    parity(out, oracle.stitch(plan, imgs))
    assert metrics.total_s > 0 and metrics.mp_per_sec > 0


def test_pipeline_streamed_matches_oracle():
    specs = [ImageSpec(200, 150), ImageSpec(150, 200, orientation=8),
             ImageSpec(180, 120)]
    imgs = [rand_img(200, 150), rand_img(150, 200), rand_img(180, 120)]
    plan = plan_for(specs, mode="min", gap=3)
    # one byte under the resident peak: resident rejected, streamed accepted
    # (budget derived from the model so the pick survives model retuning)
    from imagestitching.runtime import tiler
    cfg = RuntimeConfig(
        engine="xla",
        budget=MemoryBudget(hbm_bytes=tiler.resident_peak_bytes(plan) - 1))
    out, metrics = pipeline.run(plan, imgs, cfg)
    assert metrics.strategy == "streamed"
    parity(out, oracle.stitch(plan, imgs))


def test_pipeline_banded_matches_oracle():
    specs = [ImageSpec(300, 400), ImageSpec(240, 360, orientation=3)]
    imgs = [rand_img(300, 400), rand_img(240, 360)]
    plan = plan_for(specs, mode="min", gap=7)
    canvas = 3 * plan.canvas_w * plan.canvas_h
    cfg = RuntimeConfig(engine="xla",
                        budget=MemoryBudget(hbm_bytes=canvas // 2))
    out, metrics = pipeline.run(plan, imgs, cfg)
    assert metrics.strategy == "banded"
    parity(out, oracle.stitch(plan, imgs))


def test_pipeline_banded_with_upscale_and_orientations():
    specs = [ImageSpec(300, 400, orientation=o) for o in (1, 5, 6, 7)]
    imgs = [rand_img(300, 400) for _ in specs]
    plan = plan_for(specs, mode="max", gap=2)
    canvas = 3 * plan.canvas_w * plan.canvas_h
    cfg = RuntimeConfig(engine="xla",
                        budget=MemoryBudget(hbm_bytes=canvas // 2))
    out, metrics = pipeline.run(plan, imgs, cfg)
    assert metrics.strategy == "banded"
    parity(out, oracle.stitch(plan, imgs))


def test_pipeline_progress_phases():
    specs = [ImageSpec(64, 64)] * 3
    imgs = [rand_img(64, 64) for _ in range(3)]
    plan = plan_for(specs)
    seen = []
    canvas = 3 * plan.canvas_w * plan.canvas_h
    cfg = RuntimeConfig(engine="xla",
                        budget=MemoryBudget(hbm_bytes=canvas + 200_000))
    pipeline.run(plan, imgs, cfg, progress=lambda ph, f: seen.append((ph, f)))
    comp = [f for ph, f in seen if ph == "composite"]
    assert comp and comp == sorted(comp) and comp[-1] == 1.0


def test_banded_windowed_matches_oracle():
    """The banded strategy with bands much shorter than each placement
    (host-cropped row windows, rebased taps), both directions and modes."""
    from imagestitching.core import geometry
    from imagestitching.runtime.pipeline import _run_banded

    specs = [ImageSpec(90, 70), ImageSpec(60, 120, orientation=6),
             ImageSpec(75, 75)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    for direction in ("vertical", "horizontal"):
        for mode in ("min", "original"):
            plan = solve(specs, StitchOptions(direction=direction, mode=mode,
                                              gap=3, supersample=False))
            # small band_rows to force several bands per placement
            got = _run_banded(plan, imgs, 3, 16, lambda *a: None)
            want = oracle.stitch(plan, imgs)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, \
                (direction, mode)


def test_banded_copy_blit():
    # equal sizes -> identity taps: the banded gather reproduces the
    # sources bit for bit
    from imagestitching.runtime.pipeline import _run_banded

    specs = [ImageSpec(40, 30)] * 3
    imgs = [rng.integers(0, 256, (30, 40, 3), np.uint8) for _ in specs]
    plan = solve(specs, StitchOptions(gap=2, supersample=False))
    got = _run_banded(plan, imgs, 3, 8, lambda *a: None)
    want = oracle.stitch(plan, imgs)
    np.testing.assert_array_equal(got, want)


def test_streamed_update_matches_oracle():
    """The streamed strategy's per-image update executables."""
    from imagestitching.runtime.pipeline import _run_streamed

    specs = [ImageSpec(80, 60), ImageSpec(50, 90, orientation=8)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    plan = solve(specs, StitchOptions(gap=2, supersample=False))
    got = _run_streamed(plan, imgs, 3, RuntimeConfig(), lambda *a: None)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_profile_trace_released_on_failure(monkeypatch, tmp_path):
    """A failing profiled run must not leak the process-global profiler
    (review finding: 'Profile has already been started')."""
    import os
    monkeypatch.setenv("IMAGESTITCH_TRACE_DIR", str(tmp_path / "t"))
    from imagestitching.ops import xla_compose
    from imagestitching.runtime import pipeline

    def broken(plan, images, **kw):
        raise ValueError("boom")

    specs = [ImageSpec(16, 16)]
    imgs = [rng.integers(0, 256, (16, 16, 3), np.uint8)]
    plan = solve(specs, StitchOptions(supersample=False))
    monkeypatch.setattr(xla_compose, "stitch", broken)
    with pytest.raises(ValueError):
        pipeline.run(plan, imgs, RuntimeConfig(engine="xla", profile=True))
    monkeypatch.undo()
    monkeypatch.setenv("IMAGESTITCH_TRACE_DIR", str(tmp_path / "t2"))
    # a second profiled run must work (no leaked active profile)
    out, m = pipeline.run(plan, imgs,
                          RuntimeConfig(engine="xla", profile=True))
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_banded_xla_wide_filter_band_alignment():
    """Soak-caught bug: the XLA banded executor sized crops over groups
    aligned to each image's span start, but bands are CANVAS-aligned — at
    band boundaries wide-K filters (lanczos3/box) got undercovered crops and
    clamped taps (errors up to 33 uint8 levels)."""
    from imagestitching.core import geometry
    from imagestitching.runtime.pipeline import _BandedExecutor

    rng2 = np.random.default_rng(1065)
    for kind in ("lanczos3", "box", "triangle"):
        # spans deliberately NOT aligned to the band size (gap offsets them)
        specs = [ImageSpec(119, 50, 2), ImageSpec(52, 67, 2),
                 ImageSpec(76, 73, 2), ImageSpec(97, 86, 5)]
        imgs = [rng2.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
                for s in specs]
        plan = solve(specs, StitchOptions(mode="max", gap=3, filter=kind,
                                          supersample=False))
        oriented = [geometry.orient_array(a, p.orientation)
                    for a, p in zip(imgs, plan.placements)]
        got = _BandedExecutor(plan, 128, 3).run(oriented)
        want = oracle.stitch(plan, imgs)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, kind


def test_banded_ladder_short_canvas(monkeypatch):
    """Canvases shorter than 8 rows must still get a banded attempt
    (regression: the ladder's band floor produced an empty ladder and a
    bogus 'out of memory on every strategy' MemoryError)."""
    from imagestitching import api
    from imagestitching.core import oracle as _oracle
    from imagestitching.core.layout import solve as _solve

    rng2 = np.random.default_rng(5)
    imgs = [rng2.integers(0, 256, (6, 45, 3), np.uint8),
            rng2.integers(0, 256, (39, 42, 3), np.uint8)]
    specs = [ImageSpec(45, 6, 3), ImageSpec(42, 39, 5)]
    opts = StitchOptions(direction="horizontal", mode="min", gap=2,
                         supersample=False)
    # on a 6-row canvas banded is never the leanest plan, so drive the
    # ladder down to it with device OOMs in the resident and streamed rungs
    def oom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory (simulated)")

    monkeypatch.setattr(pipeline.xla_compose, "stitch", oom)
    monkeypatch.setattr(pipeline, "_run_streamed", oom)
    cfg = RuntimeConfig(engine="xla")
    out, m = api.stitch_arrays(imgs, specs, opts, cfg, return_metrics=True)
    assert m.strategy == "banded"
    want = _oracle.stitch(_solve(specs, opts), imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_overlapped_drain_oom_demotes_to_banded(monkeypatch):
    """r4s7 review: on the async transport a streamed update's OOM first
    surfaces at the DRAIN fetch — it must trigger the banded retry (with
    redecode of released sources), not escape to the caller."""
    import jax

    specs = [ImageSpec(120, 90), ImageSpec(100, 80)]
    imgs = [rand_img(120, 90), rand_img(100, 80)]
    plan = plan_for(specs, mode="min", gap=2)
    loaders = [(lambda a=a: a) for a in imgs]

    real_get = jax.device_get
    fired = []

    def oom_once(x):
        # fire only on the drain's (1,1,1) canvas probe, not the transport
        # rtt probe that runs earlier in the same body
        if not fired and getattr(x, "shape", None) == (1, 1, 1):
            fired.append(True)
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory "
                               "allocating canvas (simulated)")
        return real_get(x)

    monkeypatch.setattr(jax, "device_get", oom_once)
    out, m = pipeline.run_overlapped(
        plan, loaders, RuntimeConfig(engine="xla"))
    assert fired                       # the drain really hit the fake OOM
    assert m.strategy == "overlapped/banded"
    parity(out, oracle.stitch(plan, imgs))


def test_sharded_oom_falls_back_to_single_chip(monkeypatch):
    """r4s7 review: a runtime OOM inside the space-sharded compose (the
    byte estimate admitted it) must recover on the single-chip ladder."""
    from imagestitching.parallel import mesh as pmesh
    from imagestitching.parallel import sharding as psharding

    class Boom:
        def __init__(self, *a, **k):
            pass

        def __call__(self, images):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory on "
                               "device shard (simulated)")

    monkeypatch.setattr(psharding, "ShardedStitch", Boom)
    specs = [ImageSpec(100, 80), ImageSpec(90, 70)]
    imgs = [rand_img(100, 80), rand_img(90, 70)]
    plan = plan_for(specs, mode="min", gap=1)
    mesh = pmesh.make_mesh((1, 8))
    out, m = pipeline.run(plan, imgs,
                          RuntimeConfig(engine="xla", mesh=mesh))
    assert m.strategy != "space-sharded"
    parity(out, oracle.stitch(plan, imgs))


# ------------------------------------------------- strategy parity matrix

def _budget_for(strategy, plan):
    """A budget under which the governor picks ``strategy`` for ``plan``
    (the one ``chip_smoke.py`` forces the strategies with on the card)."""
    from chip_smoke import budget_for
    budget = budget_for(strategy, plan)
    assert tiler.plan_execution(plan, budget).strategy == strategy
    return budget


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("strategy", ["resident", "streamed", "banded"])
def test_strategy_orientation_parity(strategy, orientation):
    """Every EXIF orientation through every strategy, within one uint8
    step of the float64 oracle."""
    specs = [ImageSpec(48, 72, orientation=orientation), ImageSpec(40, 60),
             ImageSpec(44, 30, orientation=9 - orientation), ImageSpec(36, 50)]
    imgs = [rand_img(s.raw_w, s.raw_h) for s in specs]
    plan = plan_for(specs, mode="min", gap=2)
    out, m = pipeline.run(plan, imgs, RuntimeConfig(
        engine="xla", budget=_budget_for(strategy, plan)))
    assert m.strategy == strategy
    parity(out, oracle.stitch(plan, imgs))


@pytest.mark.parametrize("filter_kind",
                         ["bilinear", "triangle", "box", "lanczos3"])
@pytest.mark.parametrize("strategy", ["resident", "streamed", "banded"])
def test_strategy_filter_parity(strategy, filter_kind):
    """Every filter through every strategy, upscaling three of four
    sources to the widest (max mode)."""
    specs = [ImageSpec(150, 90), ImageSpec(120, 100), ImageSpec(100, 80),
             ImageSpec(64, 64)]
    imgs = [rand_img(s.raw_w, s.raw_h) for s in specs]
    plan = plan_for(specs, mode="max", gap=1, filter=filter_kind)
    out, m = pipeline.run(plan, imgs, RuntimeConfig(
        engine="xla", budget=_budget_for(strategy, plan)))
    assert m.strategy == strategy
    parity(out, oracle.stitch(plan, imgs))


# ------------------------------------------------------- engine choice

@pytest.mark.parametrize("case,want", [
    ("oracle", "oracle"),        # the float64 reference on request
    ("auto-blit", "host-blit"),  # equal sizes, one device, host result
    ("auto-resample", "xla"),    # mixed sizes need the device engine
    ("xla-blit", "xla"),         # an explicit engine pins the device path
    ("auto-blit-mesh", "xla"),   # a mesh always runs on the devices
    ("auto-blit-device", "xla"),  # keep_on_device wants a device canvas
    ("auto-blit-gray", "xla"),   # the host blit assembles RGB only
])
def test_choose_engine(case, want):
    from imagestitching.parallel import mesh as pmesh
    blit = plan_for([ImageSpec(40, 30)] * 3)
    resample = plan_for([ImageSpec(40, 30), ImageSpec(50, 20)])
    plan = resample if case == "auto-resample" else blit
    cfg = RuntimeConfig(
        engine=case.split("-")[0],
        mesh=pmesh.make_mesh((1, 8)) if case.endswith("mesh") else None)
    engine, copies = pipeline.choose_engine(
        plan, cfg, channels=1 if case.endswith("gray") else 3,
        keep_on_device=case.endswith("device"))
    assert engine == want
    assert (copies is not None) == (engine == "host-blit")
    if copies is not None:
        assert copies == {0: (0, 0), 1: (0, 0), 2: (0, 0)}


@pytest.mark.parametrize("stats,want", [
    (None, 2 * (1 << 30)),                        # CPU: no allocator stats
    ({"bytes_limit": 80_000_000_000}, 48_000_000_000),
])
def test_memory_budget_from_device(monkeypatch, stats, want):
    import jax

    class FakeDevice:
        def memory_stats(self):
            return stats

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    assert MemoryBudget.from_device().hbm_bytes == want
    if stats is None:
        monkeypatch.undo()
        assert MemoryBudget.from_device().hbm_bytes == want   # real CPU
