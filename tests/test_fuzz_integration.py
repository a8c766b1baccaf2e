"""Cross-layer integration fuzz: random jobs through the FULL public API.

Every (engine x strategy x overlap x filter x direction/mode x orientation)
combination must land within 1 uint8 step of the float64 oracle — this is
the cross-layer complement to tests/test_fuzz.py's engine-level fuzz.
"""

import numpy as np
import pytest
from PIL import Image

import imagestitching as ist
from imagestitching.config import (MemoryBudget, RuntimeConfig,
                                       StitchOptions)
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve


def _case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    specs, imgs = [], []
    for _ in range(n):
        w = int(rng.integers(5, 90))
        h = int(rng.integers(5, 90))
        o = int(rng.integers(1, 9))
        specs.append(ImageSpec(w, h, o))
        imgs.append(rng.integers(0, 256, (h, w, 3), np.uint8))
    options = StitchOptions(
        direction=str(rng.choice(["vertical", "horizontal"])),
        mode=str(rng.choice(["min", "max", "original"])),
        gap=float(rng.integers(0, 9)),
        filter=str(rng.choice(["bilinear", "triangle", "lanczos3"])),
        background=tuple(int(x) for x in rng.integers(0, 256, 3)),
        supersample=False)
    return rng, specs, imgs, options


@pytest.mark.parametrize("seed", range(8))
def test_full_api_fuzz(seed, tmp_path):
    rng, specs, imgs, options = _case(seed)
    plan = solve(specs, options)
    want = oracle.stitch(plan, imgs)

    # random runtime config: engine, budget tightness, overlap policy
    engine = str(rng.choice(["xla", "auto"]))
    budget_scale = float(rng.choice([1.0, 0.001, 0.0003]))
    cfg = RuntimeConfig(
        engine=engine,
        overlap=str(rng.choice(["never", "always"])),
        budget=MemoryBudget(hbm_bytes=max(100_000,
                                          int(2e9 * budget_scale))))

    # mixed input kinds: lossless files (orientation 1 only — PNG has no
    # EXIF; re-decoded bytes must be identical) and (array, exif) tuples
    items = []
    for i, (s, a) in enumerate(zip(specs, imgs)):
        if s.orientation == 1 and rng.random() < 0.5:
            p = tmp_path / f"{seed}_{i}.png"
            Image.fromarray(a).save(p)
            items.append(p)
        else:
            items.append((a, s.orientation))
    out = ist.stitch(items, options=options, config=cfg)
    assert out.shape == want.shape, (options, cfg.overlap)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1, \
        (seed, options.direction, options.mode, options.filter, engine,
         budget_scale, cfg.overlap)


@pytest.mark.parametrize("seed", range(6))
def test_blit_stream_fuzz(seed, tmp_path):
    """Random pure-blit jobs (equal display sizes per axis) through
    stitch_to_file must take the host-blit-stream path and match the
    oracle bit-exactly."""
    from imagestitching import api
    from imagestitching.core import geometry
    from imagestitching.imgio import codec, native

    if not native.available():
        pytest.skip("native codec unavailable")

    rng = np.random.default_rng(1000 + seed)
    direction = str(rng.choice(["vertical", "horizontal"]))
    mode = str(rng.choice(["min", "original"]))
    n = int(rng.integers(2, 6))
    if mode == "min":
        # equal display widths (vertical) / heights (horizontal) -> blits
        common = int(rng.integers(20, 90))
        dims = [(common, int(rng.integers(20, 90))) if direction == "vertical"
                else (int(rng.integers(20, 90)), common) for _ in range(n)]
    else:
        dims = [(int(rng.integers(20, 90)), int(rng.integers(20, 90)))
                for _ in range(n)]
    specs, imgs, items = [], [], []
    for i, (dw, dh) in enumerate(dims):
        o = int(rng.integers(1, 9))
        # raw dims so that the oriented display size is (dw, dh)
        rw, rh = (dw, dh) if o <= 4 else (dh, dw)
        a = rng.integers(0, 256, (rh, rw, 3), np.uint8)
        specs.append(ImageSpec(rw, rh, o))
        imgs.append(a)
        items.append((a, o))
    options = StitchOptions(
        direction=direction, mode=mode, gap=float(rng.integers(0, 7)),
        background=tuple(int(x) for x in rng.integers(0, 256, 3)),
        supersample=False)
    plan = solve(specs, options)
    if geometry.plan_copy_offsets(plan) is None:
        pytest.skip("random geometry produced a resample plan")
    out = tmp_path / f"blit_{seed}.png"
    p, m = api.stitch_to_file(items, out, options=options,
                              return_metrics=True)
    assert m.strategy == "host-blit-stream", (seed, direction, mode)
    got, _ = codec.decode(open(p, "rb").read())
    want = oracle.stitch(plan, imgs)
    assert np.array_equal(got, want), (seed, direction, mode)
