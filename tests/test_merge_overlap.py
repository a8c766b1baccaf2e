"""Auto-overlap merge (StitchOptions.merge_overlap, ops/overlap.py).

Framework extension — the reference concatenates verbatim (index.js:
1526-1554); these tests pin the detection contract (exact-verified,
deterministic) and its composition with the stitch pipeline.
"""

import numpy as np
import pytest

from imagestitching import api
from imagestitching.config import RuntimeConfig, StitchOptions
from imagestitching.core import geometry, oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.ops import overlap

rng = np.random.default_rng(99)


def noise(h, w, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def split_with_overlap(base, heights, o):
    """Cut ``base`` into strips of the given heights where consecutive
    strips share exactly ``o`` rows."""
    out, top = [], 0
    for h in heights:
        out.append(base[top:top + h])
        top += h - o
    return out


# ---------------------------------------------------------------- detection

def test_detect_pair_exact_overlap():
    base = noise(600, 80)
    a, b = split_with_overlap(base, [300, 250], 70)
    assert overlap.detect_pair(a, b) == 70


def test_detect_pair_no_overlap():
    assert overlap.detect_pair(noise(200, 64), noise(200, 64)) == 0


def test_detect_pair_respects_threshold():
    base = noise(400, 64)
    a, b = split_with_overlap(base, [200, 200], 60)
    b = b.copy()
    # +-1-level noise over the overlap: accepted at the default JPEG-ish
    # threshold, rejected at exact-only
    wob = rng.integers(-1, 2, b[:60].shape)
    b[:60] = np.clip(b[:60].astype(np.int16) + wob, 0, 255).astype(np.uint8)
    assert overlap.detect_pair(a, b, threshold=2.0) == 60
    assert overlap.detect_pair(a, b, threshold=0.0) == 0


def test_detect_pair_shape_mismatch_and_tiny():
    assert overlap.detect_pair(noise(200, 64), noise(200, 65)) == 0
    assert overlap.detect_pair(noise(3, 64), noise(3, 64)) == 0


def test_detect_pair_never_empties_b():
    # b's top hb-1 rows duplicate a's tail; even at max_frac=1.0 the trim
    # is capped at hb-1 so a merge can never produce an empty image
    a = noise(300, 48)
    b = np.concatenate([a[261:], noise(1, 48)], axis=0)   # 40 rows
    t = overlap.detect_pair(a, b, max_frac=1.0)
    assert t == b.shape[0] - 1 == 39


def test_detect_trims_chain_and_apply():
    base = noise(860, 72)
    parts = split_with_overlap(base, [300, 320, 340], 50)
    trims = overlap.detect_trims(parts, "vertical")
    assert trims == [0, 50, 50]
    cropped = overlap.apply_trims(parts, trims, "vertical")
    assert np.array_equal(np.concatenate(cropped, axis=0), base)


def test_detect_trims_horizontal():
    base = noise(80, 700)
    a, b = base[:, :380], base[:, 330:]
    trims = overlap.detect_trims([a, b], "horizontal")
    assert trims == [0, 50]
    cropped = overlap.apply_trims([a, b], trims, "horizontal")
    assert np.array_equal(np.concatenate(cropped, axis=1), base)


def test_scores_numpy_matches_device_argmin():
    base = noise(500, 64)
    a, b = split_with_overlap(base, [260, 240], 80)
    region, template = a[260 - 130:], b[:32]
    s_np = overlap._scores_numpy(region, template)
    s_dev = overlap._scores(region, template, device=True)
    assert s_np.shape == s_dev.shape
    assert int(np.argmin(s_np)) == int(np.argmin(s_dev))
    # XLA:CPU default-precision f32 matmul is bf16-grade (CLAUDE.md):
    # tolerance covers it; behavior never depends on these raw scores
    assert np.allclose(s_np, s_dev, atol=5e-3)


# ------------------------------------------------------------- integration

def test_stitch_arrays_merge_matches_pretrimmed():
    base = noise(680, 96)
    parts = split_with_overlap(base, [250, 260, 250], 40)
    opts = StitchOptions(merge_overlap=True)
    got = api.stitch_arrays(parts, options=opts)
    want = api.stitch_arrays(
        [parts[0], parts[1][40:], parts[2][40:]],
        options=StitchOptions())
    assert np.array_equal(got, want)
    # equal widths + zero gap: the merged strip IS the original capture
    assert np.array_equal(got, base)


def test_stitch_arrays_merge_with_orientation():
    base = noise(600, 64)
    a, b = split_with_overlap(base, [300, 350], 50)
    # feed b rotated 180 with the matching EXIF tag: merge must orient
    # before detecting
    b_rot = b[::-1, ::-1].copy()
    specs = [ImageSpec(a.shape[1], a.shape[0], 1),
             ImageSpec(b_rot.shape[1], b_rot.shape[0], 3)]
    got = api.stitch_arrays([a, b_rot], specs=specs,
                            options=StitchOptions(merge_overlap=True))
    assert np.array_equal(got, base)


def test_stitch_merge_mixed_widths_resampled():
    # different widths: detection skips the pair (no pixel-exact overlap
    # can exist), and the job still stitches through the resample path
    imgs = [noise(120, 100), noise(130, 80)]
    opts = StitchOptions(merge_overlap=True)
    got = api.stitch_arrays(imgs, options=opts)
    specs = [ImageSpec(i.shape[1], i.shape[0]) for i in imgs]
    plan = solve(specs, StitchOptions())
    want = oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stitch_files_merge_end_to_end(tmp_path):
    from PIL import Image
    base = noise(640, 90)
    parts = split_with_overlap(base, [280, 260, 220], 60)
    paths = []
    for i, p in enumerate(parts):
        f = tmp_path / f"s{i}.png"
        Image.fromarray(p).save(f)
        paths.append(str(f))
    got = api.stitch(paths, options=StitchOptions(merge_overlap=True))
    assert np.array_equal(got, base)
    # stitch_to_file must skip the header-planned blit path and still work
    out = api.stitch_to_file(paths, tmp_path / "out.png",
                             options=StitchOptions(merge_overlap=True))
    assert np.array_equal(np.asarray(Image.open(out)), base)


def test_server_merge_overlap():
    from imagestitching.serve.server import StitchServer
    base = noise(500, 64)
    a, b = split_with_overlap(base, [260, 290], 50)
    with StitchServer(max_batch=4) as srv:
        fut = srv.submit([a, b], StitchOptions(merge_overlap=True))
        out = fut.result(timeout=120)
    assert np.array_equal(out, base)


def test_cli_merge_overlap(tmp_path):
    import subprocess
    import sys
    from PIL import Image
    base = noise(420, 70)
    a, b = split_with_overlap(base, [240, 230], 50)
    pa, pb = tmp_path / "a.png", tmp_path / "b.png"
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    out = tmp_path / "o.png"
    # clean env (same pattern as test_api_cli.run_cli), held to the CPU
    r = subprocess.run(
        [sys.executable, "-m", "imagestitching.cli", str(pa), str(pb),
         "-o", str(out), "--merge-overlap"],
        capture_output=True, text=True,
        env={"PYTHONPATH": ".", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert np.array_equal(np.asarray(Image.open(out)), base)


def test_http_merge_overlap():
    import base64
    import io
    import json
    import urllib.request
    from PIL import Image
    from imagestitching.imgio import codec
    from imagestitching.serve.http import StitchHTTPServer

    base = noise(460, 72)
    a, b = split_with_overlap(base, [250, 260], 50)
    payload = {
        "images": [base64.b64encode(codec.encode_bytes(x, "png")).decode()
                   for x in (a, b)],
        "merge_overlap": "true",
    }
    with StitchHTTPServer(port=0, max_wait_s=0.005) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())))
    assert np.array_equal(out, base)


def test_merge_threshold_validation():
    with pytest.raises(ValueError):
        StitchOptions(merge_threshold=-1.0).validate()
