"""Batched serving + mesh-sharded execution on the 8-device CPU mesh
(SURVEY.md §4(5): multi-device without a cluster)."""

import numpy as np
import pytest

import jax

from imagestitching.config import StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.parallel import batch as pbatch
from imagestitching.parallel import mesh as pmesh
from imagestitching.parallel.sharding import ShardedStitch

rng = np.random.default_rng(11)


def rand_stack(b, w, h, c=3):
    return rng.integers(0, 256, (b, h, w, c), np.uint8)


def plan_for(specs, **kw):
    kw.setdefault("supersample", False)
    return solve(specs, StitchOptions(**kw))


def oracle_batch(plan, stacks):
    outs = []
    for b in range(stacks[0].shape[0]):
        outs.append(oracle.stitch(plan, [s[b] for s in stacks]))
    return np.stack(outs)


# ------------------------------------------------------------------- mesh

def test_make_mesh_default():
    m = pmesh.make_mesh()
    assert m.shape["jobs"] == 8 and m.shape["space"] == 1


def test_make_mesh_2d():
    m = pmesh.make_mesh((2, 4))
    assert m.shape["jobs"] == 2 and m.shape["space"] == 4
    with pytest.raises(ValueError):
        pmesh.make_mesh((3, 2))


# ------------------------------------------------------------------- batch

@pytest.mark.parametrize("filter_kind",
                         ["bilinear", "triangle", "box", "lanczos3"])
def test_batched_matches_oracle(filter_kind):
    specs = [ImageSpec(48, 32), ImageSpec(32, 40)]
    plan = plan_for(specs, gap=3, filter=filter_kind)
    stacks = [rand_stack(4, 48, 32), rand_stack(4, 32, 40)]
    got = pbatch.stitch_batch(plan, stacks)
    want = oracle_batch(plan, stacks)
    assert got.shape == want.shape == (4, plan.canvas_h, plan.canvas_w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_with_orientation():
    specs = [ImageSpec(48, 32, orientation=6), ImageSpec(32, 48)]
    plan = plan_for(specs, mode="min")
    stacks = [rand_stack(3, 48, 32), rand_stack(3, 32, 48)]
    got = pbatch.stitch_batch(plan, stacks)
    want = oracle_batch(plan, stacks)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_sharded_over_jobs_mesh():
    mesh = pmesh.make_mesh()           # 8 devices on jobs axis
    specs = [ImageSpec(40, 24), ImageSpec(24, 24)]
    plan = plan_for(specs)
    stacks = [rand_stack(16, 40, 24), rand_stack(16, 24, 24)]
    got = pbatch.stitch_batch(plan, stacks, mesh=mesh)
    want = oracle_batch(plan, stacks)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_jobs_mesh_partitions_without_collectives():
    """Under a jobs mesh each device holds its own slice of the batch and
    the program has no collectives: jobs are independent."""
    import re

    mesh = pmesh.make_mesh()           # 8 devices on jobs axis
    # mixed sizes -> real resample, not only blits
    specs = [ImageSpec(48, 32), ImageSpec(32, 40)]
    plan = plan_for(specs, gap=2)
    stacks = [rand_stack(16, 48, 32), rand_stack(16, 32, 40)]
    bs = pbatch.BatchedStitch(plan, 16, mesh=mesh)
    dev = bs.stage(stacks)
    out_dev = bs._jitted(dev)
    shapes = {tuple(s.data.shape) for s in out_dev.addressable_shards}
    assert shapes == {(2, plan.canvas_h, plan.canvas_w, 3)}, shapes
    assert len({s.device for s in out_dev.addressable_shards}) == 8
    hlo = bs._jitted.lower(dev).compile().as_text()
    assert not re.search(r"all-gather|all-reduce|all-to-all", hlo)
    want = oracle_batch(plan, stacks)
    assert np.abs(np.asarray(out_dev).astype(int)
                  - want.astype(int)).max() <= 1


@pytest.mark.parametrize("entry", ["call", "warm", "space"])
def test_four_device_mesh_stages_each_device_its_share(entry):
    """Inputs reach the program already in its sharding: a served batch and
    the warm-up batch give each device only its B/N jobs, and a space-sharded
    job replicates its sources and splits its taps by band.  Nothing is
    staged whole on the default device and resharded from there."""
    devs = jax.devices()[:4]
    plan = plan_for([ImageSpec(40, 24), ImageSpec(24, 24)])
    seen = []
    if entry == "space":
        runner = ShardedStitch(plan, pmesh.make_mesh((1, 4), devices=devs))
    else:
        runner = pbatch.BatchedStitch(
            plan, 8, mesh=pmesh.make_mesh((4, 1), devices=devs))
    real = runner._jitted

    def spy(*args):
        seen.append(args)
        return real(*args)

    runner._jitted = spy
    if entry == "call":
        runner([rand_stack(8, 40, 24), rand_stack(8, 24, 24)])
    elif entry == "warm":
        runner.warm()
    else:
        runner([rand_stack(1, 40, 24)[0], rand_stack(1, 24, 24)[0]])
    (args,) = seen
    ids = sorted(d.id for d in devs)
    leaves = jax.tree_util.tree_leaves(args)
    assert leaves and all(isinstance(a, jax.Array) for a in leaves)
    for a in leaves:
        assert sorted(s.device.id for s in a.addressable_shards) == ids
    if entry == "space":
        images, taps = args
        assert all(a.sharding.is_fully_replicated for a in images)
        for a in jax.tree_util.tree_leaves(taps):
            assert {s.data.shape[0] for s in a.addressable_shards} == {1}
    else:
        for a in leaves:
            assert {s.data.shape[0] for s in a.addressable_shards} == {2}


def test_batched_validates_shapes():
    plan = plan_for([ImageSpec(16, 16)])
    b = pbatch.BatchedStitch(plan, batch_size=2)
    with pytest.raises(ValueError):
        b([rand_stack(3, 16, 16)])     # wrong batch
    with pytest.raises(ValueError):
        b([rand_stack(2, 8, 16)])      # wrong dims


@pytest.mark.parametrize("axis", ["jobs", "space"])
def test_four_device_mesh_matches_oracle(axis):
    """Both mesh axes on four devices (the four-card layout): the jobs axis
    shards a served batch, the space axis one job's canvas rows."""
    devs = jax.devices()[:4]
    specs = [ImageSpec(64, 100), ImageSpec(80, 133, orientation=6)]
    plan = plan_for(specs, mode="min", gap=3)
    if axis == "jobs":
        mesh = pmesh.make_mesh((4, 1), devices=devs)
        stacks = [rand_stack(8, 64, 100), rand_stack(8, 80, 133)]
        got = pbatch.stitch_batch(plan, stacks, mesh=mesh)
        want = oracle_batch(plan, stacks)
    else:
        mesh = pmesh.make_mesh((1, 4), devices=devs)
        imgs = [rand_stack(1, 64, 100)[0], rand_stack(1, 80, 133)[0]]
        got = ShardedStitch(plan, mesh)(imgs)
        want = oracle.stitch(plan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ------------------------------------------------------------------- shard

def test_sharded_rows_match_oracle():
    mesh = pmesh.make_mesh((1, 8))     # all devices on space axis
    specs = [ImageSpec(64, 100), ImageSpec(80, 133)]
    plan = plan_for(specs, mode="min", gap=5)
    imgs = [rng.integers(0, 256, (100, 64, 3), np.uint8),
            rng.integers(0, 256, (133, 80, 3), np.uint8)]
    sh = ShardedStitch(plan, mesh)
    got = sh(imgs)
    want = oracle.stitch(plan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_band_seams_with_orientations():
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(40, 64, orientation=8), ImageSpec(64, 48)]
    plan = plan_for(specs, mode="max", gap=2)
    imgs = [rng.integers(0, 256, (64, 40, 3), np.uint8),
            rng.integers(0, 256, (48, 64, 3), np.uint8)]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_uneven_rows():
    # canvas_h not divisible by 8 -> padded bands, output sliced back
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(32, 61)]
    plan = plan_for(specs)
    assert plan.canvas_h % 8 != 0
    imgs = [rng.integers(0, 256, (61, 32, 3), np.uint8)]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pipeline_space_mesh_integration():
    # RuntimeConfig.mesh with a space axis routes through ShardedStitch
    from imagestitching import api
    from imagestitching.config import RuntimeConfig
    mesh = pmesh.make_mesh((1, 8))
    imgs = [rng.integers(0, 256, (100, 64, 3), np.uint8),
            rng.integers(0, 256, (133, 80, 3), np.uint8)]
    out, m = api.stitch_arrays(
        imgs, options=StitchOptions(mode="min", gap=5, supersample=False),
        config=RuntimeConfig(engine="xla", mesh=mesh), return_metrics=True)
    assert m.strategy == "space-sharded"
    plan = plan_for([ImageSpec(64, 100), ImageSpec(80, 133)], mode="min",
                    gap=5)
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_sharded_triangle_filter():
    # K-tap windows through shard_map: AA filter sharded over space axis
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(200, 160), ImageSpec(64, 48)]
    plan = plan_for(specs, mode="min", gap=2, filter="triangle")
    imgs = [rng.integers(0, 256, (160, 200, 3), np.uint8),
            rng.integers(0, 256, (48, 64, 3), np.uint8)]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_mixed_blit_and_resample_placements():
    """Blit and resample placements in one space-sharded job, each shard
    composing its own canvas band, parity vs the oracle."""
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(64, 100), ImageSpec(80, 133),
             ImageSpec(48, 64, orientation=6)]
    imgs = [rand_stack(1, 64, 100)[0], rand_stack(1, 80, 133)[0],
            rand_stack(1, 48, 64)[0]]
    plan = plan_for(specs, mode="min", gap=3)
    from imagestitching.core import geometry
    copies = [geometry.placement_copy_offsets(p, plan.filter) is not None
              for p in plan.placements]
    assert copies == [True, False, True]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_placement_in_middle_bands_only():
    """A placement confined to the middle of a tall canvas: shards whose
    bands miss it must still run the SPMD program (zero-weight taps) and
    compose pure background."""
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(96, 40), ImageSpec(64, 48)]
    plan = plan_for(specs, mode="max", gap=200)   # huge gap: empty bands
    imgs = [rand_stack(1, 96, 40)[0], rand_stack(1, 64, 48)[0]]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_deep_downscale_more_than_64_taps():
    """lanczos3 at a 1/16 downscale needs ~97 taps per output row; the
    gather engine has no tap limit, so the sharded job just runs."""
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(4096, 64), ImageSpec(256, 40)]
    plan = plan_for(specs, mode="min", filter="lanczos3")   # 4096 -> 256
    from imagestitching.core import geometry
    p = plan.placements[0]
    _, w = geometry.filter_taps(*p.col_span, p.x0, p.w, 4096, "lanczos3")
    assert w.shape[1] > 64
    imgs = [rand_stack(1, 4096, 64)[0], rand_stack(1, 256, 40)[0]]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_wide_k_filter():
    """lanczos3 deep downscale: wide tap windows across shard bands still
    match the oracle."""
    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(400, 96), ImageSpec(100, 80)]
    plan = plan_for(specs, mode="min", filter="lanczos3")
    imgs = [rand_stack(1, 400, 96)[0], rand_stack(1, 100, 80)[0]]
    got = ShardedStitch(plan, mesh)(imgs)
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pipeline_space_mesh_auto_engine_on_blit_job():
    """engine='auto' with a space mesh takes the sharded device path even
    for an all-blit job (the host blit is for one device only)."""
    from imagestitching import api
    from imagestitching.config import RuntimeConfig

    mesh = pmesh.make_mesh((1, 8))
    specs = [ImageSpec(64, 100), ImageSpec(64, 100)]
    imgs = [rand_stack(1, 64, 100)[0], rand_stack(1, 64, 100)[0]]
    opts = StitchOptions(mode="min", gap=2, supersample=False)
    got, m = api.stitch_arrays(
        imgs, specs, opts, config=RuntimeConfig(engine="auto", mesh=mesh),
        return_metrics=True)
    assert m.strategy == "space-sharded"
    want = oracle.stitch(solve(specs, opts), imgs)
    np.testing.assert_array_equal(got, want)


def test_space_sharded_budget_reject_falls_back():
    """VERDICT r1 weak #6: sharding engages only when the per-device peak
    (replicated sources + f32 band temporaries) fits the budget."""
    from imagestitching.config import MemoryBudget, RuntimeConfig
    from imagestitching.runtime import pipeline, tiler
    from imagestitching.runtime.logger import get_logger

    mesh = pmesh.make_mesh((1, 4), devices=jax.devices()[:4])
    specs = [ImageSpec(60, 40), ImageSpec(40, 60)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    plan = solve(specs, StitchOptions(gap=2, supersample=False))
    peak = tiler.sharded_peak_bytes(plan, 4, 3)
    get_logger().clear()
    cfg = RuntimeConfig(engine="xla", mesh=mesh,
                        budget=MemoryBudget(hbm_bytes=peak - 1))
    out, m = pipeline.run(plan, imgs, cfg)
    assert m.strategy != "space-sharded"
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
    tags = [r["tag"] for r in get_logger().ring()]
    assert "pipeline.sharded_budget_reject" in tags

    # with an adequate budget the same job engages sharding
    cfg2 = RuntimeConfig(engine="xla", mesh=mesh,
                         budget=MemoryBudget(hbm_bytes=peak * 4))
    out2, m2 = pipeline.run(plan, imgs, cfg2)
    assert m2.strategy == "space-sharded"
    assert np.abs(out2.astype(int) - want.astype(int)).max() <= 1


def test_batch_on_2d_mesh_jobs_axis():
    """Batched serving on a 2D (jobs, space) mesh: batch shards over jobs,
    replicates over space — a config change, not a redesign (SURVEY §2c)."""
    mesh = pmesh.make_mesh((4, 2))
    specs = [ImageSpec(40, 24), ImageSpec(24, 32)]
    plan = solve(specs, StitchOptions(gap=1, supersample=False))
    b = 8
    stacks = [rng.integers(0, 256, (b, 24, 40, 3), np.uint8),
              rng.integers(0, 256, (b, 32, 24, 3), np.uint8)]
    out = pbatch.stitch_batch(plan, stacks, mesh=mesh)
    want = np.stack([oracle.stitch(plan, [s[i] for s in stacks])
                     for i in range(b)])
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_batched_accepts_empty_span_placement():
    """A plan with a zero-area placement (rounded draw height 0) batches:
    the empty placement draws nothing."""
    plan = plan_for([ImageSpec(33, 4), ImageSpec(4, 4)], mode="min")
    assert any(p.row_span[0] == p.row_span[1] for p in plan.placements)
    bs = pbatch.BatchedStitch(plan, 2)
    stacks = [rand_stack(2, 33, 4), rand_stack(2, 4, 4)]
    got = np.asarray(bs(stacks))
    want = oracle_batch(plan, stacks)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
