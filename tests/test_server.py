"""Batch server tests: bucketing, dynamic flush, failure isolation."""

import numpy as np
import pytest

from imagestitching.config import StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.serve.server import StitchServer

rng = np.random.default_rng(21)


def rand_img(w, h):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def test_server_single_job():
    with StitchServer(max_batch=8, max_wait_s=0.002) as s:
        imgs = [rand_img(32, 24), rand_img(24, 24)]
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=60)
        plan = solve([ImageSpec(32, 24), ImageSpec(24, 24)],
                     StitchOptions(gap=2))
        want = oracle.stitch(plan, imgs)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_server_batches_same_signature():
    with StitchServer(max_batch=4, max_wait_s=0.01) as s:
        jobs = []
        for _ in range(8):
            imgs = [rand_img(40, 20), rand_img(20, 30)]
            jobs.append((imgs, s.submit(imgs)))
        for imgs, fut in jobs:
            out = fut.result(timeout=60)
            plan = solve([ImageSpec(40, 20), ImageSpec(20, 30)],
                         StitchOptions())
            want = oracle.stitch(plan, imgs)
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        st = s.stats()
        assert st["jobs"] == 8
        assert st["batches"] <= 4  # bucketed, not per-job


def test_server_mixed_signatures():
    with StitchServer(max_batch=8, max_wait_s=0.005) as s:
        a = [rand_img(16, 16)]
        b = [rand_img(24, 16), rand_img(24, 8)]
        fa = s.submit(a)
        fb = s.submit(b, StitchOptions(direction="horizontal"))
        ra = fa.result(timeout=60)
        rb = fb.result(timeout=60)
        assert ra.shape == (16, 16, 3)
        plan_b = solve([ImageSpec(24, 16), ImageSpec(24, 8)],
                       StitchOptions(direction="horizontal"))
        assert rb.shape == (plan_b.canvas_h, plan_b.canvas_w, 3)


def test_server_background_not_shared_across_jobs():
    """Same-geometry jobs with DIFFERENT backgrounds must not share a
    compiled program: assemble_canvas bakes plan.background in as a
    constant, so plan.signature() must include it — omitting it handed
    the second client the first client's background (r4 serve review)."""
    o_black = StitchOptions(gap=6, background=(0, 0, 0))
    o_red = StitchOptions(gap=6, background=(255, 0, 0))
    specs = [ImageSpec(20, 12), ImageSpec(20, 10)]
    assert (solve(specs, o_black).signature()
            != solve(specs, o_red).signature())
    with StitchServer(max_batch=8, max_wait_s=0.01) as s:
        imgs1 = [rand_img(20, 12), rand_img(20, 10)]
        imgs2 = [rand_img(20, 12), rand_img(20, 10)]
        f1 = s.submit(imgs1, o_black)
        f2 = s.submit(imgs2, o_red)
        out1 = f1.result(timeout=60)
        out2 = f2.result(timeout=60)
        # the gap rows show the background
        assert tuple(out1[12, 0]) == (0, 0, 0)
        assert tuple(out2[12, 0]) == (255, 0, 0)
        want2 = oracle.stitch(solve(specs, o_red), imgs2)
        assert np.abs(out2.astype(int) - want2.astype(int)).max() <= 1


def test_server_failure_isolation():
    with StitchServer(max_batch=4, max_wait_s=0.005) as s:
        good = [rand_img(16, 16)]
        futs = [s.submit(good) for _ in range(3)]
        # poison: submit images that mismatch their own plan by mutating
        # after solve is not possible via submit; instead trigger a solver
        # error directly
        with pytest.raises(ValueError):
            s.submit([], StitchOptions())
        for f in futs:
            assert f.result(timeout=60).shape == (16, 16, 3)


def test_server_close_flushes():
    s = StitchServer(max_batch=64, max_wait_s=30.0)
    imgs = [rand_img(16, 16)]
    fut = s.submit(imgs)
    s.close()
    assert fut.result(timeout=5).shape == (16, 16, 3)
    with pytest.raises(RuntimeError):
        s.submit(imgs)


def test_server_resample_jobs_match_oracle():
    with StitchServer(max_batch=4, max_wait_s=0.005) as s:
        imgs_a = [rand_img(40, 30), rand_img(30, 20)]
        imgs_b = [rand_img(40, 30), rand_img(30, 20)]
        fa, fb = s.submit(imgs_a), s.submit(imgs_b)
        plan = solve([ImageSpec(40, 30), ImageSpec(30, 20)], StitchOptions())
        for imgs, fut in [(imgs_a, fa), (imgs_b, fb)]:
            want = oracle.stitch(plan, imgs)
            got = fut.result(timeout=120)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_server_mesh_with_default_engine():
    """StitchServer(use_mesh=True) on the 8-device CPU mesh: the jobs-
    sharded path must serve real jobs with parity (VERDICT r2 #8)."""
    with StitchServer(max_batch=8, max_wait_s=0.01, use_mesh=True) as s:
        # mixed sizes -> real resampling, not only blits
        jobs = []
        for _ in range(9):              # not a jobs-axis multiple: pad path
            imgs = [rand_img(48, 32), rand_img(32, 40)]
            jobs.append((imgs, s.submit(imgs, StitchOptions(gap=2))))
        plan = solve([ImageSpec(48, 32), ImageSpec(32, 40)],
                     StitchOptions(gap=2))
        for imgs, fut in jobs:
            got = fut.result(timeout=180)
            want = oracle.stitch(plan, imgs)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert s.stats()["jobs"] == 9


def test_server_budget_caps_batch_proactively():
    """VERDICT r1 #7: a large batch of big canvases splits under the HBM
    budget BEFORE launch (no OOM-driven bisection involved)."""
    from imagestitching.config import MemoryBudget, RuntimeConfig
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.runtime import tiler
    from imagestitching.runtime.logger import get_logger

    specs = [ImageSpec(64, 48), ImageSpec(48, 64)]
    plan = solve(specs, StitchOptions(gap=2))
    per_job = tiler.resident_peak_bytes(plan, 3)
    # budget fits ~3 jobs per launch
    cfg = RuntimeConfig(budget=MemoryBudget(hbm_bytes=3 * per_job + 1))
    get_logger().clear()
    with StitchServer(max_batch=64, max_wait_s=0.05,
                      config=cfg) as s:
        jobs = []
        for _ in range(10):
            imgs = [rand_img(64, 48), rand_img(48, 64)]
            jobs.append((imgs, s.submit(imgs, StitchOptions(gap=2))))
        for imgs, fut in jobs:
            out = fut.result(timeout=60)
            want = oracle.stitch(plan, imgs)
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        st = s.stats()
        assert st["jobs"] == 10
        assert st["batches"] >= 4          # ceil(10/3) launches at minimum
    tags = [r["tag"] for r in get_logger().ring()]
    assert "serve.batch_capped" in tags


def test_server_queue_backpressure():
    # bounded admission by PENDING count (not raw queue depth — the batcher
    # drains the queue into buckets immediately): the 4th submit is rejected
    s = StitchServer(max_batch=8, max_wait_s=30.0, max_queue=3)
    try:
        jobs = []
        for _ in range(3):
            jobs.append(s.submit([rand_img(8, 8)]))
        import pytest as _pytest
        with _pytest.raises(RuntimeError, match="queue full"):
            s.submit([rand_img(8, 8)])
    finally:
        s.close()
        for f in jobs:
            assert f.result(timeout=60).shape == (8, 8, 3)


def test_server_randomized_stress():
    """40 random jobs with ~8 distinct signatures submitted concurrently:
    bucketing, padding, deadline flushes and result routing all hold — every
    strip matches its own oracle (no cross-job bleed)."""
    r = np.random.default_rng(77)
    sig_shapes = [tuple((int(r.integers(12, 50)), int(r.integers(12, 50)))
                        for _ in range(int(r.integers(1, 4))))
                  for _ in range(8)]
    jobs = []
    for k in range(40):
        shapes = sig_shapes[int(r.integers(0, len(sig_shapes)))]
        gap = int(r.integers(0, 4))
        imgs = [r.integers(0, 256, (h, w, 3), np.uint8)
                for (w, h) in shapes]
        jobs.append((imgs, shapes, gap))
    with StitchServer(max_batch=8, max_wait_s=0.01) as s:
        futs = [s.submit(imgs, StitchOptions(gap=gap))
                for imgs, _, gap in jobs]
        outs = [f.result(timeout=300) for f in futs]
    for (imgs, shapes, gap), out in zip(jobs, outs):
        plan = solve([ImageSpec(w, h) for (w, h) in shapes],
                     StitchOptions(gap=gap))
        want = oracle.stitch(plan, imgs)
        assert out.shape == want.shape
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
    assert s.stats()["jobs"] >= 40


def test_server_signature_lru_bounded():
    """A long-lived server fed diverse geometry must not accrete compiled
    executables forever: the signature LRU keeps at most max_signatures
    entries, and an evicted signature recompiles correctly on return."""
    with StitchServer(max_batch=2, max_wait_s=0.0,
                      max_signatures=2) as s:
        first = [rand_img(10, 10)]
        assert s.submit(first).result(timeout=60).shape == (10, 10, 3)
        for w in (12, 14, 16, 18):          # 4 more distinct signatures
            assert s.submit([rand_img(w, 8)]).result(
                timeout=60).shape == (8, w, 3)
        assert len(s._compiled) <= 2
        # the first signature was evicted; resubmitting recompiles + works
        out = s.submit(first).result(timeout=60)
        want = oracle.stitch(solve([ImageSpec(10, 10)], StitchOptions()),
                             first)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_server_cancelled_future_does_not_poison_batch():
    """A client cancelling its queued future (cancel() wins while the job
    sits queued; the worker marks futures RUNNING only at flush) must not
    poison the batch: the cancelled job is DROPPED from the batch (its
    compute is never paid), the batch-mates still resolve, its admission
    slot is released, and — the --stress-soak finding — its waiters are
    notified: concurrent.futures.wait() on the cancelled future must
    return, which requires the executor-side CANCELLED_AND_NOTIFIED
    transition (set_running_or_notify_cancel), not just cancel()."""
    from concurrent.futures import wait as fwait
    # max_wait_s far above any 1-core scheduling stall: the flush must come
    # from the batch-FULL trigger (4th submit below), never the deadline —
    # a deadline flush racing the cancel() would set_result first and make
    # cancel() legitimately return False (not the behavior under test)
    with StitchServer(max_batch=4, max_wait_s=5.0) as s:
        imgs = [rand_img(20, 12)]
        f_cancel = s.submit(imgs)
        assert f_cancel.cancel()            # still queued: cancel wins
        mates = [s.submit([rand_img(20, 12)]) for _ in range(3)]
        for f in mates:
            assert f.result(timeout=60).shape == (12, 20, 3)
        # the pre-fix server left the future in CANCELLED forever and this
        # wait() blocked until timeout (waiters are only woken by the
        # executor-side notify step)
        done, not_done = fwait([f_cancel], timeout=30)
        assert not not_done and f_cancel.cancelled()
        st = s.stats()
        assert st["pending"] == 0           # the dropped job freed its slot
        s.close()
        st = s.stats()
        assert st["jobs"] == 3              # cancelled job never computed
        assert st["failed"] == 0


def test_server_serves_more_than_64_tap_signature():
    """A downscale whose filter window needs more than 64 taps (4->64
    min-mode lanczos3: K=97) is served like any other job."""
    opts = StitchOptions(mode="min", filter="lanczos3", supersample=False)
    imgs = [rand_img(4, 4), rand_img(64, 64)]
    specs = [ImageSpec(4, 4), ImageSpec(64, 64)]
    with StitchServer(max_batch=2, max_wait_s=0.0) as s:
        out = s.submit(imgs, opts).result(timeout=120)
        want = oracle.stitch(solve(specs, opts), imgs)
        assert out.shape == want.shape
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        assert s.stats()["failed"] == 0


def test_server_bare_default_works_on_cpu_backend():
    """StitchServer() with every default serves jobs on a CPU backend."""
    with StitchServer(max_batch=4, max_wait_s=0.0) as s:
        imgs = [rand_img(32, 24), rand_img(30, 20)]
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=60)
        plan = solve([ImageSpec(32, 24), ImageSpec(30, 20)],
                     StitchOptions(gap=2))
        want = oracle.stitch(plan, imgs)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        assert s.stats()["failed"] == 0


def test_server_empty_span_placement():
    """A min-mode plan where one source's rounded draw height is 0 (the
    reference draws it as a no-op, pages/index/index.js:1526-1554) is
    served like the single-job pipeline serves it."""
    specs = [ImageSpec(33, 4), ImageSpec(4, 4)]
    opts = StitchOptions(direction="vertical", mode="min")
    plan = solve(specs, opts)
    assert any(p.row_span[0] == p.row_span[1] for p in plan.placements), \
        "expected a zero-height placement in this reproducer"
    imgs = [rand_img(33, 4), rand_img(4, 4)]
    with StitchServer(max_batch=2, max_wait_s=0.002) as s:
        out = s.submit(imgs, opts).result(timeout=120)
        assert s.stats()["failed"] == 0
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_server_compiles_once_per_batch_size():
    """One BatchedStitch per (signature, padded batch, channels): a repeat
    lookup reuses it, another batch size builds its own."""
    s = StitchServer(max_batch=8, max_wait_s=30.0)
    try:
        plan = solve([ImageSpec(24, 16), ImageSpec(16, 12)], StitchOptions())
        one = s._get_compiled(plan, 1)
        assert s._get_compiled(plan, 1) is one
        two = s._get_compiled(plan, 2)
        assert two is not one and two.batch_size == 2
        assert set(s._compiled[plan.signature()]) == {(1, 3), (2, 3)}
    finally:
        s.close()


def test_server_overload_rejects_before_merge_scoring(monkeypatch):
    # r4s7 review: admission must happen BEFORE the expensive per-job work
    # (overlap scoring, layout solve) — a full server used to pay the whole
    # SSD-scoring pass per rejected request
    from imagestitching.ops import overlap as _overlap
    from imagestitching.serve.server import ServerOverloaded

    def boom(*a, **k):
        raise AssertionError("merge_arrays ran on a rejected submit")

    monkeypatch.setattr(_overlap, "merge_arrays", boom)
    s = StitchServer(max_batch=8, max_wait_s=30.0, max_queue=0)
    try:
        with pytest.raises(ServerOverloaded):
            s.submit([rand_img(16, 24), rand_img(16, 24)],
                     StitchOptions(merge_overlap=True))
        assert s.stats()["pending"] == 0     # rejected submit freed its slot
    finally:
        s.close()


def test_server_admission_slots_shared_with_out_of_band_jobs():
    # admission() (the HTTP grid path) holds a real queue slot: batch
    # submits see the occupancy, and the slot is returned on exit
    from imagestitching.serve.server import ServerOverloaded
    s = StitchServer(max_batch=8, max_wait_s=30.0, max_queue=1)
    try:
        with s.admission():
            assert s.stats()["pending"] == 1
            with pytest.raises(ServerOverloaded):
                s.submit([rand_img(8, 8)])
        assert s.stats()["pending"] == 0
        # slot free again: a normal submit is admitted
        assert s.submit([rand_img(8, 8)]).result(timeout=60).shape == (
            8, 8, 3)
    finally:
        s.close()


def test_server_config_limits_are_applied():
    # r4s7 review: RuntimeConfig.limits was a dead field — submit() now
    # defaults to it when no explicit limits argument is given
    from imagestitching.config import CanvasLimits, RuntimeConfig
    with StitchServer(max_batch=4, max_wait_s=0.005,
                      config=RuntimeConfig(
                          limits=CanvasLimits(max_side=40))) as s:
        out = s.submit([rand_img(64, 80)]).result(timeout=60)
        assert max(out.shape[:2]) <= 40


def _flat_white(arr):
    """Float64 straight-alpha-onto-white twin of api._flatten_alpha."""
    a = arr[:, :, -1:].astype(np.float64) / 255.0
    color = arr[:, :, :-1].astype(np.float64) * a + 255.0 * (1.0 - a)
    return np.clip(np.floor(color + 0.5), 0, 255).astype(np.uint8)


def test_server_rgba_flattens_like_decode():
    """An RGBA array job composites onto white (decode-ladder semantics)
    instead of dying at trace time with a concat-shape TypeError."""
    imgs = [rng.integers(0, 256, (24, 32, 4), np.uint8),
            rng.integers(0, 256, (20, 28, 4), np.uint8)]
    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=60)
    plan = solve([ImageSpec(32, 24), ImageSpec(28, 20)],
                 StitchOptions(gap=2))
    want = oracle.stitch(plan, [_flat_white(a) for a in imgs])
    assert out.shape[2] == 3
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_server_mixed_gray_rgb_promotes():
    imgs = [rng.integers(0, 256, (24, 32), np.uint8),
            rng.integers(0, 256, (20, 28, 3), np.uint8)]
    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=60)
    plan = solve([ImageSpec(32, 24), ImageSpec(28, 20)],
                 StitchOptions(gap=2))
    want = oracle.stitch(
        plan, [np.repeat(imgs[0][:, :, None], 3, axis=2), imgs[1]])
    assert out.shape[2] == 3
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_server_gray_and_rgb_same_geometry_bucket_separately():
    """Same plan.signature() with different channel counts must compile
    separate programs (np.stack of mixed channels would die mid-flush)."""
    g = [rng.integers(0, 256, (24, 32, 1), np.uint8)]
    c = [rng.integers(0, 256, (24, 32, 3), np.uint8)]
    with StitchServer(max_batch=8, max_wait_s=0.05) as s:
        fg, fc = s.submit(g), s.submit(c)
        og, oc = fg.result(timeout=60), fc.result(timeout=60)
    assert og.shape == (24, 32, 1)
    assert oc.shape == (24, 32, 3)
    assert np.array_equal(og, g[0])
    assert np.array_equal(oc, c[0])


def test_warmup_precompiles_then_serves():
    with StitchServer(max_batch=8, max_wait_s=0.002) as s:
        info = s.warmup([(24, 32), (20, 28)], StitchOptions(gap=2),
                        batch_sizes=(1, 5))
        # 5 pads to the same pow-2 bucket a real 5-job flush selects
        assert info == {"batches": [1, 8], "signature_cached": True}
        assert s.stats()["warmups"] == 2
        assert s.stats()["signatures"] == 1
        # the warmed signature holds exactly the padded (batch, channels)
        # executables a real flush will look up
        per_size, = s._compiled.values()
        assert set(per_size) == {(1, 3), (8, 3)}
        imgs = [rng.integers(0, 256, (24, 32, 3), np.uint8),
                rng.integers(0, 256, (20, 28, 3), np.uint8)]
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=60)
        plan = solve([ImageSpec(32, 24), ImageSpec(28, 20)],
                     StitchOptions(gap=2))
        want = oracle.stitch(plan, imgs)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        # the real 1-job flush reused the warmed executable
        per_size, = s._compiled.values()
        assert set(per_size) == {(1, 3), (8, 3)}


def test_warmup_validates_shapes():
    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        with pytest.raises(ValueError, match="warmup shape"):
            s.warmup([(24,)])
        with pytest.raises(ValueError, match="channels"):
            s.warmup([(24, 32, 4)])
        with pytest.raises(ValueError, match="orientations"):
            s.warmup([(24, 32)], orientations=[1, 1])
        assert s.stats()["warmups"] == 0


def test_warmup_under_jobs_mesh():
    """warm() must execute through the jobs-sharded path too: the padded
    batch rounds to a jobs-axis multiple and the zero-filled execution
    runs per-device shards, same as a real mesh flush."""
    with StitchServer(max_batch=16, max_wait_s=0.002, use_mesh=True) as s:
        unit = s.mesh.shape["jobs"]
        info = s.warmup([(24, 32), (20, 28)], StitchOptions(gap=2),
                        batch_sizes=(1, 3))
        assert all(b % unit == 0 for b in info["batches"]), info
        assert s.stats()["warmups"] == len(info["batches"])
        imgs = [rng.integers(0, 256, (24, 32, 3), np.uint8),
                rng.integers(0, 256, (20, 28, 3), np.uint8)]
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=120)
        plan = solve([ImageSpec(32, 24), ImageSpec(28, 20)],
                     StitchOptions(gap=2))
        want = oracle.stitch(plan, imgs)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_submit_rejects_before_paying_normalization(monkeypatch):
    """Backpressure must fire BEFORE the O(pixels) channel normalization
    (review r4s11: the flatten ran ahead of _admit, so an overloaded
    server paid full-image compositing per rejected request)."""
    import imagestitching.api as api_mod
    from imagestitching.serve.server import ServerOverloaded

    s = StitchServer(max_batch=2, max_wait_s=30.0,
                     max_queue=1)
    try:
        with s.admission():           # hold the only slot
            def boom(a):
                raise AssertionError("normalization ran before admission")
            monkeypatch.setattr(api_mod, "_as_uint8", boom)
            with pytest.raises(ServerOverloaded):
                s.submit([rng.integers(0, 256, (8, 8, 4), np.uint8)])
    finally:
        s.close()


def test_warmup_clamps_to_mesh_rounded_cap(monkeypatch):
    """warmup must clamp against the same mesh-rounded cap _flush splits
    at — the raw cap could warm a batch size no real flush ever selects
    (and execute a zero batch above the HBM bound)."""
    with StitchServer(max_batch=16, max_wait_s=30.0,
                      use_mesh=True) as s:
        unit = s.mesh.shape["jobs"]            # 8 on the virtual CPU mesh
        assert unit == 8
        monkeypatch.setattr(s, "_batch_cap", lambda plan, ch: 10)
        assert s._effective_cap(None, 3) == 8
        info = s.warmup([(16, 16)], batch_sizes=(10,))
        assert info["batches"] == [8]          # not 16 (raw-cap rounding)


def test_warmup_rejects_bad_batch_sizes():
    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        with pytest.raises(ValueError, match="non-empty"):
            s.warmup([(16, 16)], batch_sizes=())
        with pytest.raises(ValueError, match="batch_sizes"):
            s.warmup([(16, 16)], batch_sizes=3)
        assert s.stats()["warmups"] == 0


def test_server_concurrent_clients_with_cancels():
    """pytest twin of the --stress soak's core invariant: N client threads
    submitting (and sometimes cancelling) concurrently must leave every
    future notified — wait() returns, no deadlock — with admission slots
    quiesced to zero and jobs+failed+cancelled == admitted.  Cancel
    outcomes are inherently racy (a cancel can lose to the flush), so the
    test asserts coherence, not specific winners."""
    import threading
    from concurrent.futures import wait as fwait

    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        lock = threading.Lock()
        jobs = []

        def client(tid):
            trng = np.random.default_rng(100 + tid)
            for k in range(4):
                imgs = [trng.integers(0, 256, (12, 20, 3), np.uint8)]
                fut = s.submit(imgs, StitchOptions(gap=float(tid)))
                with lock:
                    jobs.append((imgs, float(tid), fut))
                if k == 1:
                    fut.cancel()      # may win (queued) or lose (flushed)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        done, not_done = fwait([f for _, _, f in jobs], timeout=120)
        assert not not_done, f"{len(not_done)} futures never notified"
        st = s.stats()
        assert st["pending"] == 0, st
        n_cancelled = 0
        for imgs, gap, fut in jobs:
            if fut.cancelled():
                n_cancelled += 1
                continue
            out = fut.result(timeout=0)
            plan = solve([ImageSpec(20, 12)], StitchOptions(gap=gap))
            want = oracle.stitch(plan, imgs)
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        assert st["jobs"] + st["failed"] + n_cancelled == len(jobs), \
            (st, n_cancelled, len(jobs))
        assert st["failed"] == 0


def test_server_latency_metrics():
    """stats() exposes dynamic-batching latency: queue_wait_* (submit ->
    flush-start, what a client pays for batching) and flush_s (flush wall
    incl. executable lookup, so cold-compile spikes are visible). Warmup
    batches must not pollute them."""
    with StitchServer(max_batch=4, max_wait_s=0.002) as s:
        s.warmup([(16, 16)], batch_sizes=(4,))
        st = s.stats()
        assert st["flush_s"] == 0.0 and st["queue_wait_s"] == 0.0
        futs = [s.submit([rand_img(16, 16)]) for _ in range(3)]
        for f in futs:
            f.result(timeout=60)
        st = s.stats()
        assert st["flush_s"] > 0.0
        assert 0.0 <= st["queue_wait_max_s"] <= st["queue_wait_s"]
        assert st["jobs"] == 3
