"""End-to-end API / CLI / codec tests (SURVEY.md §4(3))."""

import json
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import imagestitching as ist
from imagestitching import api
from imagestitching.config import RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.imgio import codec

rng = np.random.default_rng(7)


def make_png(path, w, h):
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def make_jpeg_with_exif(path, w, h, orientation):
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    img = Image.fromarray(arr)
    exif = img.getexif()
    exif[274] = orientation
    img.save(path, quality=95, exif=exif)
    return arr


# ------------------------------------------------------------------- codec

def test_codec_roundtrip_png(tmp_path):
    p = tmp_path / "x.png"
    arr = make_png(p, 33, 21)
    info = codec.get_image_info(p)
    assert (info.raw_w, info.raw_h, info.orientation) == (33, 21, 1)
    assert info.format == "png"
    dec, o = codec.decode(p)
    assert o == 1
    np.testing.assert_array_equal(dec, arr)


def test_codec_exif_orientation(tmp_path):
    p = tmp_path / "x.jpg"
    make_jpeg_with_exif(p, 40, 30, 6)
    info = codec.get_image_info(p)
    assert info.orientation == 6
    assert (info.raw_w, info.raw_h) == (40, 30)  # raw dims, not display
    dec, o = codec.decode(p)
    assert o == 6 and dec.shape == (30, 40, 3)


def test_codec_rgba_composites_on_white(tmp_path):
    p = tmp_path / "a.png"
    arr = np.zeros((4, 4, 4), np.uint8)
    arr[..., 0] = 200            # red
    arr[..., 3] = 128            # half alpha
    Image.fromarray(arr, "RGBA").save(p)
    dec, _ = codec.decode(p)
    # 200*128/255 + 255*(1-128/255) = 227.4 -> 227
    assert dec.shape == (4, 4, 3)
    np.testing.assert_array_equal(dec[..., 0], np.full((4, 4), 227))
    np.testing.assert_array_equal(dec[..., 1], np.full((4, 4), 127))


def test_codec_draft_downscale(tmp_path):
    p = tmp_path / "big.jpg"
    make_jpeg_with_exif(p, 640, 480, 1)
    dec, _ = codec.decode(p, max_pixels=100 * 100)
    # 640*480 / 1e4 = 30.7 -> denom 8 -> 80x60
    assert dec.shape[0] <= 480 // 4 and dec.shape[1] <= 640 // 4


def test_codec_encode_jpeg_quality(tmp_path):
    arr = rng.integers(0, 256, (32, 32, 3), np.uint8)
    p = codec.encode(tmp_path / "o.jpg", arr, quality=90)
    assert codec.get_image_info(p).format == "jpeg"


def test_transcode_passthrough_and_unknown(tmp_path):
    p = tmp_path / "x.png"
    make_png(p, 8, 8)
    assert codec.transcode_if_needed(p) == str(p)
    bad = tmp_path / "x.heic"
    bad.write_bytes(b"not an image")
    from imagestitching.imgio import heif
    if heif.available():
        # heic passes through (decoded natively later); garbage then fails
        # at decode time with a clear error
        assert codec.transcode_if_needed(bad) == str(bad)
        with pytest.raises(Exception):
            codec.decode(bad)
    else:
        with pytest.raises(RuntimeError, match="cannot decode"):
            codec.transcode_if_needed(bad)
    # a mislabeled-but-decodable file gets transcoded to jpg
    odd = tmp_path / "y.weird"
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(
        odd, format="PNG")
    out = codec.transcode_if_needed(odd)
    assert out.endswith(".transcoded.jpg")


# ------------------------------------------------------------------- API

def test_stitch_files_vs_oracle(tmp_path):
    p1, p2 = tmp_path / "a.png", tmp_path / "b.png"
    a1 = make_png(p1, 64, 48)
    a2 = make_png(p2, 32, 32)
    out = ist.stitch([p1, p2], direction="vertical", mode="min",
                     config=RuntimeConfig(engine="xla"))
    plan = ist.solve([ist.ImageSpec(64, 48), ist.ImageSpec(32, 32)],
                     StitchOptions(direction="vertical", mode="min"))
    want = oracle.stitch(plan, [a1, a2])
    diff = np.abs(out.astype(int) - want.astype(int))
    assert diff.max() <= 1


def test_stitch_applies_exif(tmp_path):
    p = tmp_path / "r.jpg"
    make_jpeg_with_exif(p, 40, 30, 6)
    out = ist.stitch([p], config=RuntimeConfig(engine="xla"),
                     options=StitchOptions(supersample=False))
    # orientation 6: display is 30x40
    assert out.shape == (40, 30, 3)


def test_stitch_arrays_and_mixed_inputs(tmp_path):
    p = tmp_path / "a.png"
    make_png(p, 16, 16)
    arr = rng.integers(0, 256, (16, 16, 3), np.uint8)
    out = ist.stitch([p, arr, (arr, 3)], gap=2,
                     config=RuntimeConfig(engine="xla"))
    assert out.shape == (16 * 3 + 4, 16, 3)


def test_on_error_skip(tmp_path):
    good = tmp_path / "g.png"
    make_png(good, 16, 16)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"garbage")
    out = ist.stitch([good, bad, good], on_error="skip",
                     config=RuntimeConfig(engine="xla"))
    assert out.shape == (32, 16, 3)
    with pytest.raises(Exception):
        ist.stitch([good, bad], on_error="raise")


def test_all_failed_raises(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="failed to prepare"):
        ist.stitch([bad], on_error="skip")


def test_progress_callback(tmp_path):
    p = tmp_path / "a.png"
    make_png(p, 8, 8)
    phases = []
    ist.stitch([p, p], progress=lambda ph, f: phases.append((ph, f)),
               config=RuntimeConfig(engine="xla"))
    names = [ph for ph, _ in phases]
    assert "prepare" in names and "layout" in names and "composite" in names
    fracs = [f for ph, f in phases if ph == "prepare"]
    assert fracs == sorted(fracs) and fracs[-1] == 1.0


def test_engine_oracle_matches_xla(tmp_path):
    arrs = [rng.integers(0, 256, (24, 31, 3), np.uint8) for _ in range(3)]
    o1 = api.stitch_arrays(arrs, config=RuntimeConfig(engine="oracle"))
    o2 = api.stitch_arrays(arrs, config=RuntimeConfig(engine="xla"))
    assert np.abs(o1.astype(int) - o2.astype(int)).max() <= 1


def test_stitch_to_file(tmp_path):
    p = tmp_path / "a.png"
    make_png(p, 16, 16)
    outp = api.stitch_to_file([p, p], tmp_path / "out.png",
                              config=RuntimeConfig(engine="xla"))
    info = codec.get_image_info(outp)
    assert (info.raw_w, info.raw_h) == (16, 32)


# ------------------------------------------------------------------- CLI

def run_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "imagestitching.cli", *map(str, argv)],
        capture_output=True, text=True,
        env={"PYTHONPATH": ".", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": "/tmp"})


def test_cli_basic(tmp_path):
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    make_png(a, 32, 16)
    make_png(b, 32, 24)
    out = tmp_path / "out.png"
    r = run_cli(a, b, "-o", out, "--engine", "xla", "--json")
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout)
    assert (res["width"], res["height"]) == (32, 40)
    assert codec.get_image_info(out).raw_h == 40


def test_cli_options(tmp_path):
    a = tmp_path / "a.png"
    make_png(a, 20, 10)
    out = tmp_path / "o.png"
    r = run_cli(a, a, "-o", out, "--direction", "horizontal", "--mode",
                "original", "--gap", "5", "--background", "0,0,0",
                "--engine", "oracle", "--json")
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout)
    assert (res["width"], res["height"]) == (45, 10)


def test_cli_stream_matches_no_stream(tmp_path):
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    make_png(a, 32, 16)
    make_png(b, 40, 24)
    o1, o2 = tmp_path / "s.png", tmp_path / "m.png"
    r1 = run_cli(a, b, "-o", o1, "--engine", "xla", "--gap", "3", "--json")
    r2 = run_cli(a, b, "-o", o2, "--engine", "xla", "--gap", "3",
                 "--no-stream", "--json")
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stderr, r2.stderr)
    i1, _ = codec.decode(o1.read_bytes())
    i2, _ = codec.decode(o2.read_bytes())
    np.testing.assert_array_equal(i1, i2)


def test_cli_bad_inputs(tmp_path):
    a = tmp_path / "a.png"
    make_png(a, 8, 8)
    r = run_cli(a, "-o", tmp_path / "o.png", "--background", "purple")
    assert r.returncode == 2 and "background" in r.stderr
    r = run_cli(tmp_path / "missing.png", "-o", tmp_path / "o.png",
                "--engine", "oracle")
    assert r.returncode == 1 and "error" in r.stderr.lower()


def test_cli_max_pixels_scale_down(tmp_path):
    a = tmp_path / "a.png"
    make_png(a, 100, 100)
    out = tmp_path / "o.png"
    r = run_cli(a, a, "-o", out, "--max-pixels", "5000",
                "--engine", "oracle", "--json")
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout)
    assert res["width"] * res["height"] <= 5000


def test_stitch_arrays_return_metrics():
    arrs = [rng.integers(0, 256, (16, 16, 3), np.uint8)] * 2
    out, m = api.stitch_arrays(arrs, config=RuntimeConfig(engine="xla"),
                               return_metrics=True)
    assert out.shape == (32, 16, 3)
    assert m.strategy == "resident" and m.total_s > 0
    assert m.out_megapixels > 0


def test_cli_runtime_flags(tmp_path):
    """VERDICT r1 #10: --hbm-budget/--decode-threads/--overlap/--metrics."""
    import json as _json
    a = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 256, (40, 60, 3), np.uint8)).save(a)
    out = tmp_path / "o.png"
    r = run_cli(a, a, "-o", out, "--engine", "xla",
                "--hbm-budget", "0.001", "--decode-threads", "2",
                "--decode-timeout", "15", "--overlap", "never",
                "--metrics", "--json")
    assert r.returncode == 0, r.stderr
    res = _json.loads(r.stdout)
    assert res["width"] == 60 and res["height"] == 80
    m = res["metrics"]
    assert m["strategy"] in ("resident", "streamed", "banded")
    assert m["canvas_w"] == 60 and m["canvas_h"] == 80
    assert "prepare_s" in m and "mp_per_sec" in m


def test_cli_overlap_always_metrics(tmp_path):
    import json as _json
    a = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 256, (30, 30, 3), np.uint8)).save(a)
    out = tmp_path / "o.png"
    r = run_cli(a, a, a, "-o", out, "--engine", "xla",
                "--overlap", "always", "--metrics", "--json")
    assert r.returncode == 0, r.stderr
    res = _json.loads(r.stdout)
    assert res["metrics"]["strategy"].startswith("overlapped")


def test_stitch_return_metrics(tmp_path):
    a = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 256, (24, 24, 3), np.uint8)).save(a)
    out, m = ist.stitch([a, a], config=RuntimeConfig(engine="xla"),
                        return_metrics=True)
    assert out.shape == (48, 24, 3)
    assert m.total_s > 0 and m.prepare_s >= 0


def test_lazy_exports_stay_jax_free():
    import subprocess as sp
    code = (
        "import sys\n"
        "import imagestitching as ist\n"
        "assert 'jax' not in sys.modules, 'import must stay JAX-free'\n"
        "assert ist.StitchHTTPServer and ist.ArtifactStore and "
        "ist.StitchServer and ist.StitchMetrics\n"
        "print('ok')\n")
    import os
    # inherit the environment (never rebuild it from scratch), with the
    # repo first on the path
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["JAX_PLATFORMS"] = "cpu"
    r = sp.run([sys.executable, "-c", code], capture_output=True, text=True,
               env=env)
    assert r.returncode == 0, r.stderr
    assert "ok" in r.stdout


def test_many_images_strip():
    # 30-image job (way past the reference's 9-cap) through the full API
    imgs = [rng.integers(0, 256, (12, 10 + (i % 3), 3), np.uint8)
            for i in range(30)]
    opts = StitchOptions(gap=1, supersample=False, max_images=None)
    out = ist.stitch(imgs, options=opts,
                     config=RuntimeConfig(engine="xla", overlap="never"))
    specs = [api.ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    from imagestitching.core.layout import solve as _solve
    plan = _solve(specs, opts)
    want = oracle.stitch(plan, imgs)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_budget_from_device():
    from imagestitching.config import MemoryBudget
    b = MemoryBudget.from_device()
    assert b.hbm_bytes > 0        # probed or default, never zero/crash
    b2 = MemoryBudget.from_device(fraction=0.1)
    assert b2.hbm_bytes <= max(b.hbm_bytes, 2 << 30)


def test_cli_hbm_budget_auto(tmp_path):
    a = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).save(a)
    out = tmp_path / "o.png"
    r = run_cli(a, "-o", out, "--engine", "xla", "--hbm-budget", "auto",
                "--json")
    assert r.returncode == 0, r.stderr


def test_stitch_host_blit_fast_path(tmp_path):
    """Equal-size concat with engine=auto never touches the device: the
    canvas is assembled with memcpys, bit-exact vs the oracle."""
    imgs = [rng.integers(0, 256, (40, 64, 3), np.uint8) for _ in range(3)]
    out, m = ist.stitch(imgs, gap=5, return_metrics=True)
    assert m.strategy == "host-blit"
    from imagestitching.config import StitchOptions
    from imagestitching.core import oracle
    from imagestitching.core.layout import ImageSpec, solve
    plan = solve([ImageSpec(64, 40) for _ in imgs], StitchOptions(gap=5))
    np.testing.assert_array_equal(out, oracle.stitch(plan, imgs))


def test_stitch_host_blit_overlapped_big_task(tmp_path):
    """>=7 equal-size images route through the overlapped branch and still
    take the host-blit path (paste-on-decode)."""
    imgs = [rng.integers(0, 256, (30, 48, 3), np.uint8) for _ in range(8)]
    paths = []
    for i, a in enumerate(imgs):
        p = tmp_path / f"blit{i}.png"
        Image.fromarray(a).save(p)
        paths.append(p)
    out, m = ist.stitch(paths, gap=2, return_metrics=True)
    assert m.strategy == "host-blit"
    from imagestitching.config import StitchOptions
    from imagestitching.core import oracle
    from imagestitching.core.layout import ImageSpec, solve
    plan = solve([ImageSpec(48, 30) for _ in imgs], StitchOptions(gap=2))
    np.testing.assert_array_equal(out, oracle.stitch(plan, imgs))


def test_stitch_host_blit_respects_engine_pin():
    imgs = [rng.integers(0, 256, (16, 16, 3), np.uint8) for _ in range(2)]
    _, m = ist.stitch(imgs, config=RuntimeConfig(engine="xla"),
                      return_metrics=True)
    assert m.strategy != "host-blit"


def test_concurrent_stitch_threads():
    """Race coverage for the public entry point itself: the framework's
    race-freedom story is structural (pure functions + lru_cache'd
    compiles + the Pillow gate), but nothing drove api.stitch_arrays from
    several threads at once.  Mixed signatures force both cache hits and
    concurrent first-compiles; every result must still match the oracle."""
    import threading

    from imagestitching.core.layout import ImageSpec, solve

    rng_ = np.random.default_rng(77)
    jobs = []
    for k in range(8):
        n = 1 + k % 3
        sizes = [(16 + 4 * ((k + i) % 3), 12 + 4 * (i % 2))
                 for i in range(n)]
        imgs = [rng_.integers(0, 256, (h, w, 3), np.uint8)
                for w, h in sizes]
        opts = StitchOptions(direction="vertical" if k % 2 else "horizontal",
                             gap=k % 4)
        jobs.append((imgs, [ImageSpec(w, h) for w, h in sizes], opts))
    results = [None] * len(jobs)
    errors = []

    def work(i):
        try:
            imgs, specs, opts = jobs[i]
            results[i] = api.stitch_arrays(
                imgs, specs, opts, RuntimeConfig(engine="xla"))
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    for (imgs, specs, opts), out in zip(jobs, results):
        want = oracle.stitch(solve(specs, opts), imgs)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_cli_decode_window_zero_usage_error(tmp_path):
    """--decode-window 0 must be a clean argparse usage error (rc 2), not a
    raw RuntimeConfig ValueError traceback (ADVICE r3)."""
    a = tmp_path / "a.png"
    make_png(a, 8, 8)
    r = run_cli(a, a, "-o", tmp_path / "o.png", "--decode-window", "0")
    assert r.returncode == 2
    assert "decode-window" in r.stderr
    assert "Traceback" not in r.stderr


def test_blit_overlapped_decode_error_closes_pool(monkeypatch):
    """A decode error on the overlapped host-blit path must cancel the
    decode pool promptly (ADVICE r3: an abandoned pool's daemon workers
    keep decoding and busy-poll the permit semaphore until gc)."""
    from imagestitching.core import geometry
    from imagestitching.core.layout import ImageSpec, solve
    from imagestitching.runtime import decoding

    plan = solve([ImageSpec(48, 30)] * 3, StitchOptions())
    copies = geometry.plan_copy_offsets(plan)
    assert copies is not None
    good = np.zeros((30, 48, 3), np.uint8)

    def bad():
        raise RuntimeError("decode exploded")

    loaders = [lambda: good, bad, lambda: good]
    pools = []
    real = decoding.iter_decoded

    def spy(*a, **kw):
        pools.append(real(*a, **kw))
        return pools[-1]

    monkeypatch.setattr(decoding, "iter_decoded", spy)
    with pytest.raises(RuntimeError, match="decode exploded"):
        api._stitch_blit_overlapped(plan, loaders, RuntimeConfig(),
                                    lambda *a: None, copies)
    assert len(pools) == 1
    assert pools[0]._cancelled.is_set()


def test_stitch_arrays_rgba_flattens_onto_white():
    """Array-input RGBA composites onto white exactly like the same pixels
    arriving as encoded RGBA bytes (codec._img_to_rgb formula)."""
    a = rng.integers(0, 256, (24, 32, 4), np.uint8)
    b = rng.integers(0, 256, (20, 28, 4), np.uint8)

    def flat(arr):
        al = arr[:, :, 3:].astype(np.float32) / 255.0
        rgb = arr[:, :, :3].astype(np.float32) * al + 255.0 * (1.0 - al)
        return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)

    cfg = RuntimeConfig(engine="xla")
    got = api.stitch_arrays([a, b], options=StitchOptions(gap=2), config=cfg)
    want = api.stitch_arrays([flat(a), flat(b)],
                             options=StitchOptions(gap=2), config=cfg)
    assert np.array_equal(got, want)
    # and byte-path equivalence: PNG round-trip of the RGBA pixels
    import io
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="png")
    decoded, _ = codec.decode(buf.getvalue())
    assert np.array_equal(decoded, flat(a))


def test_stitch_arrays_mixed_gray_rgb():
    g = rng.integers(0, 256, (24, 32), np.uint8)
    c = rng.integers(0, 256, (20, 28, 3), np.uint8)
    cfg = RuntimeConfig(engine="xla")
    got = api.stitch_arrays([g, c], options=StitchOptions(gap=2), config=cfg)
    want = api.stitch_arrays([np.repeat(g[:, :, None], 3, axis=2), c],
                             options=StitchOptions(gap=2), config=cfg)
    assert got.shape[2] == 3
    assert np.array_equal(got, want)


def test_stitch_arrays_rejects_weird_channel_counts():
    with pytest.raises(ValueError, match="channels"):
        api.stitch_arrays([rng.integers(0, 256, (8, 8, 5), np.uint8)],
                          options=StitchOptions())


def test_make_preview_rgba_consistent_across_paths():
    """Channel normalization happens BEFORE the device/host split: the
    preview of an RGBA array must not depend on backend health."""
    rgba = rng.integers(0, 256, (64, 96, 4), np.uint8)
    dev = api.make_preview(rgba, 48)
    host = api.make_preview(rgba, 48, device=False)
    assert dev.shape == host.shape and dev.shape[2] == 3
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


def test_stitch_overlapped_gray_arrays_take_plain_path():
    """>=7 gray arrays used to crash in run_overlapped (channels is a
    compile-time 3 there); they now route to the plain path and keep the
    single-channel output contract of the identical smaller job."""
    imgs = [rng.integers(0, 256, (16, 24), np.uint8) for _ in range(7)]
    out = api.stitch(imgs, gap=2, config=RuntimeConfig(engine="xla"))
    small = api.stitch(imgs[:2], gap=2, config=RuntimeConfig(engine="xla"))
    assert out.shape[2] == 1 and small.shape[2] == 1
    assert np.array_equal(out[:16], imgs[0][:, :, None])


def test_stitch_overlapped_rgba_arrays_still_overlap():
    """RGBA arrays stay eligible for the overlapped/blit fast paths: the
    loaders flatten them onto white, yielding the compile-time 3 channels."""
    imgs = [rng.integers(0, 256, (16, 24, 4), np.uint8) for _ in range(7)]
    cfg = RuntimeConfig(engine="auto", overlap="always")
    out, metrics = api.stitch(imgs, gap=0, config=cfg, return_metrics=True)
    assert metrics.strategy in ("host-blit", "overlapped")
    want = api.stitch_arrays(list(imgs), options=StitchOptions(gap=0),
                             config=RuntimeConfig(engine="xla"))
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
