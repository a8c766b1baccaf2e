"""Grid collage (api.stitch_grid, core/grid.py) — framework extension."""

import numpy as np
import pytest

from imagestitching import api
from imagestitching.config import CanvasLimits, RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.grid import plan_grid
from imagestitching.core.layout import ImageSpec

rng = np.random.default_rng(31)


def noise(h, w, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def grid_oracle(gplan, disp, valign="top"):
    """Independent assembly: oracle-stitch each column plan, paste on a
    background canvas (duplicates the api's assembly math on purpose)."""
    canvas = np.empty((gplan.canvas_h, gplan.canvas_w, 3), np.uint8)
    canvas[:] = np.asarray(gplan.background, np.uint8)
    gap_px = int(np.floor(gplan.gap + 0.5))
    x = 0
    for idx_list, plan in zip(gplan.columns, gplan.col_plans):
        col = oracle.stitch(plan, [disp[i] for i in idx_list])
        y = ((gplan.canvas_h - col.shape[0]) // 2 if valign == "center"
             else 0)
        canvas[y:y + col.shape[0], x:x + col.shape[1]] = col
        x += gplan.col_width + gap_px
    return canvas


# ------------------------------------------------------------------ planner

def test_plan_grid_balance_vs_preserve():
    specs = [ImageSpec(100, 300), ImageSpec(100, 50), ImageSpec(100, 50),
             ImageSpec(100, 50)]
    bal = plan_grid(specs, 2, StitchOptions())
    # balance: the tall image owns column 0; the three short ones stack
    # in column 1
    assert bal.columns == ((0,), (1, 2, 3))
    pre = plan_grid(specs, 2, StitchOptions(), order="preserve")
    assert pre.columns == ((0, 2), (1, 3))


def test_plan_grid_cols_clamped_and_widths_identical():
    specs = [ImageSpec(80, 60), ImageSpec(120, 90)]
    g = plan_grid(specs, 5, StitchOptions(gap=4))
    assert g.cols == 2
    assert len({p.canvas_w for p in g.col_plans}) == 1
    assert g.col_plans[0].canvas_w == g.col_width == 80   # mode=min


def test_plan_grid_validation():
    specs = [ImageSpec(10, 10)]
    with pytest.raises(ValueError):
        plan_grid(specs, 0, StitchOptions())
    with pytest.raises(ValueError):
        plan_grid(specs, 2, StitchOptions(direction="horizontal"))
    with pytest.raises(ValueError):
        plan_grid(specs, 2, StitchOptions(supersample=True))
    with pytest.raises(ValueError):
        plan_grid(specs, 2, StitchOptions(), order="shuffle")
    with pytest.raises(ValueError):
        plan_grid([], 2, StitchOptions())
    with pytest.raises(ValueError):
        plan_grid([ImageSpec(10, 10)] * 10, 3, StitchOptions())  # max_images


# ---------------------------------------------------------------- stitching

def test_stitch_grid_equal_tiles_exact():
    # four equal tiles, 2 cols, no gap: the grid is a pure blit mosaic
    imgs = [noise(50, 40) for _ in range(4)]
    got = api.stitch_grid(imgs, cols=2, options=StitchOptions(gap=0))
    # balance with equal heights deals 0,2 -> col0 and 1,3 -> col1
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    assert np.array_equal(got, want)


def test_stitch_grid_parity_vs_oracle_columns():
    imgs = [noise(int(rng.integers(40, 160)), int(rng.integers(30, 120)))
            for _ in range(7)]
    opts = StitchOptions(gap=5, background=(10, 200, 30))
    got = api.stitch_grid(imgs, cols=3, options=opts,
                          config=RuntimeConfig(engine="xla"))
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    gplan = plan_grid(specs, 3, opts)
    want = grid_oracle(gplan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stitch_grid_original_mode_and_fractional_gap():
    imgs = [noise(60, 50), noise(40, 30), noise(80, 70)]
    opts = StitchOptions(mode="original", gap=2.5, background=(0, 0, 0))
    got = api.stitch_grid(imgs, cols=2, options=opts)
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    gplan = plan_grid(specs, 2, opts)
    assert gplan.col_width == 70                 # original -> max width
    want = grid_oracle(gplan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stitch_grid_canvas_caps_scale_whole_grid():
    imgs = [noise(300, 200) for _ in range(4)]
    limits = CanvasLimits(max_side=250)
    got = api.stitch_grid(imgs, cols=2, options=StitchOptions(gap=4),
                          limits=limits)
    assert max(got.shape[:2]) <= 250
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    gplan = plan_grid(specs, 2, StitchOptions(gap=4), limits=limits)
    assert gplan.scale_down < 1.0
    want = grid_oracle(gplan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stitch_grid_valign_center():
    imgs = [noise(200, 50), noise(50, 50)]
    opts = StitchOptions(gap=0, background=(255, 0, 0))
    got = api.stitch_grid(imgs, cols=2, options=opts, valign="center")
    # column 1 is 50 rows in a 200-row canvas -> 75 red rows above it
    assert np.array_equal(got[:75, 50:], np.broadcast_to(
        [255, 0, 0], (75, 50, 3)))
    assert np.array_equal(got[75:125, 50:], imgs[1])


def test_stitch_grid_grayscale_and_rgba():
    gray = rng.integers(0, 256, (40, 40), np.uint8)
    rgb = noise(40, 40)
    got = api.stitch_grid([gray, rgb], cols=2, options=StitchOptions(gap=0))
    assert np.array_equal(got[:, :40], np.repeat(gray[:, :, None], 3, 2))
    # RGBA flattens onto white at the api boundary (decode-ladder
    # semantics) instead of the pre-r4 "composite alpha first" rejection
    rgba = noise(40, 40, 4)
    got4 = api.stitch_grid([rgba], cols=1, options=StitchOptions(gap=0))
    al = rgba[:, :, 3:].astype(np.float32) / 255.0
    flat = np.clip(np.floor(rgba[:, :, :3] * al + 255.0 * (1 - al) + 0.5),
                   0, 255).astype(np.uint8)
    assert np.array_equal(got4, flat)


def test_stitch_grid_rejects_merge_overlap():
    with pytest.raises(ValueError):
        api.stitch_grid([noise(40, 40)], cols=1,
                        options=StitchOptions(merge_overlap=True))


def test_stitch_grid_exif_orientation():
    a = noise(60, 40)
    b_disp = noise(80, 40)
    b_raw = b_disp[::-1, ::-1].copy()        # EXIF 3 = rotate 180
    got = api.stitch_grid([a, (b_raw, 3)], cols=1,
                          options=StitchOptions(gap=0))
    assert np.array_equal(got, np.concatenate([a, b_disp], axis=0))


def test_stitch_grid_under_space_mesh():
    """Grid columns compose with the sharded pipeline unchanged: a space
    mesh shards each column's canvas row-bands across devices."""
    from imagestitching.parallel import mesh as pmesh
    # mixed widths: columns RESAMPLE (equal widths would blit host-side
    # and never touch the mesh)
    imgs = [noise(180, 90), noise(150, 120), noise(160, 100),
            noise(140, 110)]
    opts = StitchOptions(gap=3, background=(5, 5, 5))
    mesh = pmesh.make_mesh((1, 8))              # all devices on space axis
    got = api.stitch_grid(imgs, cols=2, options=opts,
                          config=RuntimeConfig(mesh=mesh))
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    gplan = plan_grid(specs, 2, opts)
    want = grid_oracle(gplan, imgs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_http_grid():
    import base64
    import io
    import json
    import urllib.request
    from PIL import Image
    from imagestitching.imgio import codec
    from imagestitching.serve.http import StitchHTTPServer

    imgs = [noise(50, 40) for _ in range(4)]
    payload = {
        "images": [base64.b64encode(codec.encode_bytes(a, "png")).decode()
                   for a in imgs],
        "grid_cols": 2, "gap": 0,
    }
    with StitchHTTPServer(port=0, max_wait_s=0.005) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())))
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    assert np.array_equal(out, want)


def test_plan_grid_rounding_never_overshoots_caps():
    # r4s7 review: scale_down came from the ROUNDED aggregate grid width,
    # but assembly sums per-gap half-up roundings — 3x70 + 2*round(0.7) =
    # 212 passed the cap check against round(211.4) = 211, then overshot.
    specs = [ImageSpec(70, 50)] * 3
    g = plan_grid(specs, 3, StitchOptions(gap=0.7),
                  limits=CanvasLimits(max_side=211))
    assert max(g.canvas_w, g.canvas_h) <= 211
    g2 = plan_grid(specs, 3, StitchOptions(gap=0.7),
                   limits=CanvasLimits(max_pixels=10550))
    assert g2.canvas_w * g2.canvas_h <= 10550
    # randomized sweep: the assembled canvas never exceeds either cap
    r = np.random.default_rng(4207)
    for _ in range(60):
        n = int(r.integers(1, 8))
        sp = [ImageSpec(int(r.integers(5, 200)), int(r.integers(5, 200)))
              for _ in range(n)]
        lim = CanvasLimits(max_side=int(r.integers(20, 400)),
                           max_pixels=int(r.integers(2_000, 200_000)))
        gp = plan_grid(sp, int(r.integers(1, 5)),
                       StitchOptions(gap=float(r.uniform(0, 9))), limits=lim)
        assert max(gp.canvas_w, gp.canvas_h) <= lim.max_side
        assert gp.canvas_w * gp.canvas_h <= lim.max_pixels


def test_stitch_grid_aggregates_stage_wait_max(monkeypatch):
    # r4s7 review: stage_wait_max_s stayed 0.0 in grid metrics even when
    # columns reported per-image stalls (summed fields were aggregated,
    # the max field was not)
    from imagestitching.runtime import pipeline as _pipeline
    real_run = _pipeline.run
    vals = iter([0.25, 0.75, 0.5])

    def run_patched(plan, imgs, config, progress=None, **kw):
        out, m = real_run(plan, imgs, config, progress, **kw)
        m.stage_wait_max_s = next(vals, 0.0)
        return out, m

    monkeypatch.setattr(_pipeline, "run", run_patched)
    _, m = api.stitch_grid([noise(40, 30) for _ in range(6)], cols=3,
                           options=StitchOptions(gap=0),
                           return_metrics=True)
    assert m.stage_wait_max_s == 0.75


def test_http_grid_inherits_server_config_and_admission():
    """Grid jobs over HTTP inherit the server's RuntimeConfig (here: canvas
    caps via config.limits) and count against max_queue (503 when full)."""
    import base64
    import io
    import json
    import urllib.error
    import urllib.request
    from PIL import Image
    from imagestitching.imgio import codec
    from imagestitching.serve.http import StitchHTTPServer
    from imagestitching.serve.server import StitchServer

    imgs = [noise(120, 100) for _ in range(4)]
    payload = {
        "images": [base64.b64encode(codec.encode_bytes(a, "png")).decode()
                   for a in imgs],
        "grid_cols": 2, "gap": 2,
    }

    def post(port):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.asarray(Image.open(io.BytesIO(r.read())))

    capped = StitchServer(config=RuntimeConfig(
        limits=CanvasLimits(max_side=64)))
    with StitchHTTPServer(port=0, server=capped) as srv:
        out = post(srv.port)
        assert max(out.shape[:2]) <= 64
    capped.close()

    full = StitchServer(max_queue=0)
    with StitchHTTPServer(port=0, server=full) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(srv.port)
        assert ei.value.code == 503
    full.close()


def test_cli_grid(tmp_path):
    import subprocess
    import sys
    from PIL import Image
    paths = []
    imgs = [noise(60, 50) for _ in range(4)]
    for i, a in enumerate(imgs):
        f = tmp_path / f"g{i}.png"
        Image.fromarray(a).save(f)
        paths.append(str(f))
    out = tmp_path / "grid.png"
    r = subprocess.run(
        [sys.executable, "-m", "imagestitching.cli", *paths,
         "-o", str(out), "--grid-cols", "2", "--gap", "0", "--json"],
        capture_output=True, text=True,
        env={"PYTHONPATH": ".", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": "/tmp"})
    assert r.returncode == 0, r.stderr
    got = np.asarray(Image.open(out))
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    assert np.array_equal(got, want)
