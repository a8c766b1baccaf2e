"""Overlapped decode||compute pipeline (SURVEY.md §7 'Overlap')."""

import numpy as np
import pytest
from PIL import Image

import imagestitching as ist
from imagestitching import api
from imagestitching.config import RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.runtime import pipeline

rng = np.random.default_rng(13)


def make_png(path, w, h):
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def make_exif_jpg(path, w, h, orientation):
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    img = Image.fromarray(arr)
    ex = img.getexif()
    ex[274] = orientation
    img.save(path, quality=95, exif=ex)


def test_overlapped_matches_plain(tmp_path):
    paths, arrays = [], []
    for i in range(8):                    # >=7 -> auto big-task overlap
        p = tmp_path / f"{i}.png"
        arrays.append(make_png(p, 60 + i, 40 + i))
        paths.append(p)
    cfg_o = RuntimeConfig(engine="xla", overlap="always")
    cfg_p = RuntimeConfig(engine="xla", overlap="never")
    out_o = ist.stitch(paths, gap=2, config=cfg_o)
    out_p = ist.stitch(paths, gap=2, config=cfg_p)
    np.testing.assert_array_equal(out_o, out_p)


def test_overlap_auto_threshold():
    assert api._is_big_task([None] * 7)
    assert not api._is_big_task([None] * 3)


def test_overlapped_exif_jpeg(tmp_path):
    p = tmp_path / "r.jpg"
    make_exif_jpg(p, 40, 30, 6)
    q = tmp_path / "s.png"
    make_png(q, 30, 40)
    out = ist.stitch([p, q], config=RuntimeConfig(engine="xla",
                                                  overlap="always"))
    # orientation 6: display 30x40 -> min width 30; heights 40 + 40
    assert out.shape == (80, 30, 3)


def test_overlapped_truncated_input_salvaged(tmp_path):
    # Header readable, body truncated: the second-chance salvage decode
    # (index.js:1464-1509 analog) recovers the readable portion instead of
    # aborting the job.
    from imagestitching.runtime.logger import get_logger
    good = tmp_path / "g.png"
    make_png(good, 16, 16)
    bad = tmp_path / "bad.png"
    data = good.read_bytes()
    bad.write_bytes(data[:80])
    get_logger().clear()
    out = ist.stitch([good, bad], config=RuntimeConfig(engine="xla",
                                                       overlap="always"))
    assert out.shape == (32, 16, 3)
    tags = [r["tag"] for r in get_logger().ring()]
    assert "decode.salvage" in tags


def test_overlapped_hopeless_corruption_raises(tmp_path):
    good = tmp_path / "g.png"
    make_png(good, 16, 16)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)  # magic + garbage
    with pytest.raises(Exception):
        ist.stitch([good, bad], config=RuntimeConfig(engine="xla",
                                                     overlap="always"))


def test_run_overlapped_metrics(tmp_path):
    ps = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        make_png(p, 32, 32)
        ps.append(str(p))
    specs = [ImageSpec(32, 32) for _ in ps]
    plan = solve(specs, StitchOptions(gap=1, supersample=False))
    from imagestitching.imgio import codec
    loaders = [(lambda p=p: codec.decode(p)[0]) for p in ps]
    out, m = pipeline.run_overlapped(plan, loaders,
                                     RuntimeConfig(engine="xla"))
    assert m.strategy == "overlapped"
    assert out.shape == (plan.canvas_h, plan.canvas_w, 3)
    assert m.total_s > 0
    # drain attribution: the idle-device transport round trip is recorded
    # so compute_s spreads across rounds are explainable (round-4 note)
    assert m.transport_rtt_s > 0
    assert m.transport_rtt_s < m.total_s
    # per-image staging waits: all 3 images staged, bytes accounted, and
    # the max single wait is bounded by the sum
    assert m.h2d_bytes == 3 * 32 * 32 * 3
    assert m.stage_wait_s >= m.stage_wait_max_s > 0
    assert m.stage_wait_s < m.total_s


def test_overlapped_dimension_mismatch(tmp_path):
    # loader returns wrong dims vs header-derived plan
    specs = [ImageSpec(32, 32)]
    plan = solve(specs, StitchOptions(supersample=False))
    loaders = [lambda: np.zeros((16, 16, 3), np.uint8)]
    with pytest.raises(ValueError, match="header said"):
        pipeline.run_overlapped(plan, loaders, RuntimeConfig(engine="xla"))


def test_overlapped_budget_demotes_to_banded():
    """VERDICT r1 #3: a big overlapped job under a tight budget must demote
    to banded via the governor and still match the oracle."""
    from imagestitching.config import MemoryBudget
    from imagestitching.runtime import tiler

    specs = [ImageSpec(120, 90), ImageSpec(90, 140), ImageSpec(100, 100)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    plan = solve(specs, StitchOptions(gap=2, supersample=False))
    channels = 3
    canvas = channels * plan.canvas_w * plan.canvas_h
    streamed_peak = canvas + max(
        tiler._src_bytes(p, channels) + tiler._region_bytes(p, channels)
        for p in plan.placements)
    budget = MemoryBudget(hbm_bytes=streamed_peak - 1)
    assert tiler.plan_execution(plan, budget).strategy == "banded"

    cfg = RuntimeConfig(engine="xla", budget=budget)
    loaders = [(lambda a=a: a) for a in imgs]
    out, m = pipeline.run_overlapped(plan, loaders, cfg)
    assert m.strategy == "overlapped/banded"
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_overlapped_oom_midstream_demotes(monkeypatch):
    """An actual OOM during streamed updates retries banded from the
    retained host arrays."""
    specs = [ImageSpec(50, 40), ImageSpec(40, 50)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    plan = solve(specs, StitchOptions(supersample=False))

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: synthetic")

    monkeypatch.setattr(pipeline, "_streamed_update", boom)
    loaders = [(lambda a=a: a) for a in imgs]
    out, m = pipeline.run_overlapped(plan, loaders,
                                     RuntimeConfig(engine="xla"))
    assert m.strategy == "overlapped/banded"
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
