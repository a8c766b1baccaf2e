"""Randomized parity soak: hundreds of random jobs through every public
entry point, each checked against the float64 oracle.

Usage:  python benchmarks/soak.py [N] [SEED_BASE]          (default 200, base 10000)
        python benchmarks/soak.py --large [N] [SEED_BASE]  (default 200, base 80000)
        python benchmarks/soak.py --formats [N] [SEED_BASE]  (default 200, base 110000)
        python benchmarks/soak.py --serve [N] [SEED_BASE]    (default 100, base 120000)
        python benchmarks/soak.py --cli [N] [SEED_BASE]      (default 150, base 150000)
        python benchmarks/soak.py --http [N] [SEED_BASE]     (default 40, base 160000)
        python benchmarks/soak.py --preview [N] [SEED_BASE]  (default 200, base 170000)
        python benchmarks/soak.py --export [N] [SEED_BASE]   (default 150, base 180000)
        python benchmarks/soak.py --merge [N] [SEED_BASE]    (default 200, base 190000)
        python benchmarks/soak.py --grid [N] [SEED_BASE]     (default 200, base 200000)
        python benchmarks/soak.py --stress [N] [SEED_BASE]   (default 60, base 210000)
        python benchmarks/soak.py --layout [N] [SEED_BASE]   (default 2000, base 220000)

``--large`` probes the geometry the small soak cannot reach (VERDICT r2 #4):
sides 256-2048 biased to tile/band boundary crossings (the 128/256/512/
1024/2048 multiples where band and mesh-shard seams live), n up to 12,
wide-K filters over-represented, and a slice of cases routed through the
space-sharded mesh compose.  Band seams and ladder floors were found only
when geometry crossed such boundaries.

Runs on the 8-device virtual CPU mesh (same forcing as tests/conftest.py).
Any parity failure
or unexpected crash prints the seed and counts as a failure; tiny budgets
exercising the demotion ladders are part of the space (a designed
MemoryError raise would be a failure here because every generated job fits
banded compositing).

Found in round 2: the empty banded ladder on sub-8-row canvases (seeds
10064/10097).
"""

import dataclasses
import os
import sys
import tempfile
import traceback

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

import imagestitching as ist  # noqa: E402
from imagestitching import api  # noqa: E402
from imagestitching.config import (MemoryBudget, RuntimeConfig,  # noqa: E402
                                       StitchOptions)
from imagestitching.core import oracle  # noqa: E402
from imagestitching.core.layout import ImageSpec, solve  # noqa: E402


def _flatten_white(arr: np.ndarray) -> np.ndarray:
    """Independent float64 twin of api._flatten_alpha: straight alpha onto
    white, half-up rounding.  1/3-channel arrays pass through."""
    if arr.ndim != 3 or arr.shape[2] not in (2, 4):
        return arr
    a = arr[:, :, -1:].astype(np.float64) / 255.0
    color = arr[:, :, :-1].astype(np.float64) * a + 255.0 * (1.0 - a)
    return np.clip(np.floor(color + 0.5), 0, 255).astype(np.uint8)


def _rand_gap(rng, hi: int) -> float:
    """Integer gaps ~70% of the time, fractional the rest.  Sub-pixel gap
    phases are what the r4s5 signature-collision class hid behind (two
    plans with IDENTICAL pixel spans but shifted tap weights, collapsed to
    one compiled-program cache key) — the generators' integer-only gaps
    kept ~6k ledgered cases blind to it.  Fractional gaps also exercise
    the float cursor accumulation against the oracle."""
    g = float(rng.integers(0, hi))
    if rng.random() < 0.3:
        g += float(rng.random())
    return g


def run(n_cases: int, base: int = 10_000) -> int:
    fails = 0
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n = int(rng.integers(1, 7))
            equalize = rng.random() < 0.4      # bias toward blit plans
            direction = str(rng.choice(["vertical", "horizontal"]))
            common = int(rng.integers(8, 80))
            specs, imgs = [], []
            for _ in range(n):
                w = (common if (equalize and direction == "vertical")
                     else int(rng.integers(4, 80)))
                h = (common if (equalize and direction == "horizontal")
                     else int(rng.integers(4, 80)))
                o = int(rng.integers(1, 9))
                specs.append(ImageSpec(w, h, o))
                imgs.append(rng.integers(0, 256, (h, w, 3), np.uint8))
            options = StitchOptions(
                direction=direction,
                mode=str(rng.choice(["min", "max", "original"])),
                gap=_rand_gap(rng, 11),
                filter=str(rng.choice(["bilinear", "bilinear", "triangle",
                                       "box", "lanczos3"])),
                background=tuple(int(x) for x in rng.integers(0, 256, 3)),
                supersample=bool(rng.random() < 0.1))
            plan = solve(specs, options)
            want = oracle.stitch(plan, imgs)
            # tight budgets floored at the tiler's own minimum feasible
            # peak: below it the clean "raise the budget" MemoryError is
            # the correct product response, not ladder coverage
            from imagestitching.runtime import tiler as _tiler
            floor = _tiler.min_feasible_bytes(plan)
            cfg = RuntimeConfig(
                engine=str(rng.choice(["auto", "xla"])),
                overlap=str(rng.choice(["auto", "never", "always"])),
                budget=MemoryBudget(hbm_bytes=max(floor, int(
                    rng.choice([2_000_000_000, 3_000_000, 300_000])))))
            items = [(a, s.orientation) for a, s in zip(imgs, specs)]
            mode = rng.integers(0, 3)
            if mode == 0:
                out = ist.stitch(items, options=options, config=cfg)
            elif mode == 1:
                with tempfile.TemporaryDirectory() as d:
                    p = os.path.join(d, "o.png")
                    api.stitch_to_file(items, p, options=options,
                                       config=cfg)
                    out = np.asarray(Image.open(p).convert("RGB"))
            else:
                out = api.stitch_arrays(imgs, specs, options, cfg)
            assert out.shape == want.shape, (out.shape, want.shape)
            diff = np.abs(out.astype(int) - want.astype(int)).max()
            assert diff <= 1, f"diff={diff}"
            if seed % 25 == 0:
                print(f"seed {base + seed}: ok (mode={mode})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} cases, {fails} failures", flush=True)
    return fails


def _boundary_biased(rng, lo: int, hi: int) -> int:
    """Half the draws land within +-2 of a tile/band boundary multiple
    (128/256/512/1024/2048) — where chunk, band and shard seams live."""
    if rng.random() < 0.5:
        b = int(rng.choice([128, 256, 512, 1024, 2048]))
        m = int(rng.integers(1, max(1, hi // b) + 1))
        v = m * b + int(rng.integers(-2, 3))
        return int(np.clip(v, lo, hi))
    return int(rng.integers(lo, hi + 1))


def run_large(n_cases: int, base: int = 80_000) -> int:
    from imagestitching.parallel import mesh as pmesh

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n = int(rng.integers(2, 13))
            equalize = rng.random() < 0.3
            direction = str(rng.choice(["vertical", "horizontal"]))
            common = _boundary_biased(rng, 256, 1024)
            specs, imgs = [], []
            for _ in range(n):
                w = (common if (equalize and direction == "vertical")
                     else _boundary_biased(rng, 256, 2048))
                h = (common if (equalize and direction == "horizontal")
                     else _boundary_biased(rng, 256, 2048))
                o = int(rng.integers(1, 9))
                specs.append(ImageSpec(w, h, o))
                imgs.append(rng.integers(0, 256, (h, w, 3), np.uint8))
            options = StitchOptions(
                direction=direction,
                mode=str(rng.choice(["min", "max", "original"])),
                gap=_rand_gap(rng, 33),
                # wide-K over-represented: the widest tap windows
                filter=str(rng.choice(["bilinear", "triangle", "lanczos3",
                                       "lanczos3", "box"])),
                background=tuple(int(x) for x in rng.integers(0, 256, 3)),
                supersample=False, max_images=None)
            plan = solve(specs, options)
            want = oracle.stitch(plan, imgs)
            mode = int(rng.integers(0, 4))
            if mode == 3:
                # space-sharded mesh compose
                cfg = RuntimeConfig(engine="xla",
                                    mesh=pmesh.make_mesh((1, 8)))
                out = api.stitch_arrays(imgs, specs, options, cfg)
            else:
                from imagestitching.runtime import tiler as _tiler
                cfg = RuntimeConfig(
                    engine=str(rng.choice(["auto", "xla"])),
                    overlap=str(rng.choice(["auto", "never", "always"])),
                    budget=MemoryBudget(hbm_bytes=max(
                        _tiler.min_feasible_bytes(plan), int(
                            rng.choice([2_000_000_000, 2_000_000_000,
                                        64_000_000])))))
                items = [(a, s.orientation) for a, s in zip(imgs, specs)]
                if mode == 0:
                    out = ist.stitch(items, options=options, config=cfg)
                elif mode == 1:
                    with tempfile.TemporaryDirectory() as d:
                        p = os.path.join(d, "o.png")
                        api.stitch_to_file(items, p, options=options,
                                           config=cfg, png_compression=1)
                        out = np.asarray(Image.open(p).convert("RGB"))
                else:
                    out = api.stitch_arrays(imgs, specs, options, cfg)
            assert out.shape == want.shape, (out.shape, want.shape)
            diff = np.abs(out.astype(int) - want.astype(int)).max()
            assert diff <= 1, f"diff={diff}"
            print(f"seed {base + seed}: ok (mode={mode}, n={n}, "
                  f"canvas={plan.canvas_w}x{plan.canvas_h}, "
                  f"{options.filter})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} large cases, {fails} failures",
          flush=True)
    return fails


def _ref_decode(data: bytes) -> np.ndarray:
    """Pillow-strict reference replicating codec.decode's conversion
    semantics (RGBA/LA/P-alpha composited onto white, floor(+0.5)).

    Deliberately does NOT import the codec's own conversion helpers: the
    reference must stay an independent statement of the contract (>8-bit
    grayscale takes the high byte; generic mode "I" holding 8-bit-range
    data passes through) so a helper regression cannot hide from the soak.
    """
    import io

    with Image.open(io.BytesIO(data)) as img:
        if img.mode in ("I", "I;16", "I;16B", "I;16L", "I;16N"):
            g = np.asarray(img)
            if g.dtype != np.uint8:
                # PNG mode-"I" is always 16-bit samples (PNG has no 32-bit
                # integer mode): high byte unconditionally, like strip_16
                if (img.mode == "I" and img.format != "PNG"
                        and (g.size == 0 or int(g.max()) <= 255)):
                    g = np.clip(g, 0, 255).astype(np.uint8)
                else:
                    g = np.clip(g.astype(np.int64) >> 8, 0,
                                255).astype(np.uint8)
            return np.ascontiguousarray(np.repeat(g[:, :, None], 3, axis=2))
        if img.mode in ("RGBA", "LA", "PA") or (
                img.mode == "P" and "transparency" in img.info):
            rgba = img.convert("RGBA")
            a = np.asarray(rgba, np.float32)
            alpha = a[:, :, 3:4] / 255.0
            rgb = a[:, :, :3] * alpha + 255.0 * (1.0 - alpha)
            return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(np.asarray(img.convert("RGB")))


def _smooth(rng, w: int, h: int) -> np.ndarray:
    """Low-frequency content for lossy-codec cases (noise has no usable
    tolerance bound under HEVC/JPEG)."""
    fx, fy = rng.uniform(0.5, 3.0, 2)
    x = np.linspace(0, fx * np.pi, w, dtype=np.float32)[None, :]
    y = np.linspace(0, fy * np.pi, h, dtype=np.float32)[:, None]
    chans = [127.5 + 127.5 * np.sin(x + p) * np.cos(y + q)
             for p, q in rng.uniform(0, 6.3, (3, 2))]
    return np.clip(np.stack([np.broadcast_to(c, (h, w)) for c in chans],
                            -1), 0, 255).astype(np.uint8)


def _jpg_parity_ok(plan) -> bool:
    """q95 JPEG loss is only boundable when every placed region spans at
    least two 8-px DCT blocks: measured on smooth content, span-8 planes
    reach mean err 27 (downscale raises the frequency content) while
    span>=16 stays under 12.  Sub-16 spans -> shape-only checking."""
    sides = [min(p.row_span[1] - p.row_span[0],
                 p.col_span[1] - p.col_span[0])
             for p in plan.placements
             if p.row_span[1] > p.row_span[0]
             and p.col_span[1] > p.col_span[0]]
    sides += [plan.canvas_h, plan.canvas_w]
    return min(sides) >= 16


def _corrupt(rng, data: bytes) -> bytes:
    kind = rng.integers(0, 3)
    if kind == 0 and len(data) > 16:            # truncate
        return data[:int(len(data) * rng.uniform(0.2, 0.97))]
    if kind == 1 and len(data) > 64:            # zero a window
        b = bytearray(data)
        at = int(rng.integers(32, len(b) - 16))
        ln = int(rng.integers(4, min(256, len(b) - at)))
        b[at:at + ln] = bytes(ln)
        return bytes(b)
    b = bytearray(data)                          # flip scattered bytes
    for _ in range(int(rng.integers(1, 12))):
        b[int(rng.integers(8, len(b)))] ^= int(rng.integers(1, 256))
    return bytes(b)


def run_formats(n_cases: int, base: int = 110_000) -> int:
    """Codec-ladder soak (round-3 candidate): every container/mode the
    ingest whitelist admits, plus corruption through the salvage ladder.

    Clean files: ``codec.decode`` must match the Pillow-strict reference
    conversion exactly (lossless containers) or within 1 (JPEG: same
    libjpeg, different call sequence); ``get_image_info`` must agree on
    dims/orientation without decoding; decode must be deterministic.
    Corrupt files: decode either raises cleanly or yields a valid
    header-shaped uint8 HWC3 array; the salvage second chance likewise —
    anything else (hang, segfault, wrong-shape return) is the bug class
    this soak exists to catch (native chunk-walker / defilter edges).
    """
    import io

    from PIL.PngImagePlugin import PngInfo

    from imagestitching.imgio import codec, heif, native

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            w = int(rng.integers(1, 97))
            h = int(rng.integers(1, 97))
            noise = rng.integers(0, 256, (h, w, 3), np.uint8)
            kind = str(rng.choice(
                ["png_pil", "png_pil", "png_native", "jpeg", "jpeg",
                 "webp", "bmp", "gif", "heic", "transcode"]))
            tol = 0
            orientation = 1
            buf = io.BytesIO()
            if kind == "png_native":
                data = native.encode_png(
                    noise, compression=int(rng.integers(0, 10)),
                    threads=int(rng.choice([1, 4])))
            elif kind == "png_pil":
                mode = str(rng.choice(["RGB", "RGBA", "L", "LA", "P",
                                       "Ptrans", "1", "I;16"]))
                img = Image.fromarray(noise)
                if mode in ("L", "LA", "1", "I;16"):
                    img = img.convert("L")
                    if mode == "LA":
                        img = img.convert("LA")
                    elif mode == "1":
                        img = img.convert("1")
                    elif mode == "I;16":
                        img = img.convert("I").point(
                            lambda v: v * 257, "I").convert("I;16")
                elif mode == "RGBA":
                    img = img.convert("RGBA")
                    img.putalpha(Image.fromarray(
                        rng.integers(0, 256, (h, w), np.uint8)))
                elif mode in ("P", "Ptrans"):
                    img = img.convert(
                        "P", palette=Image.ADAPTIVE,
                        colors=int(rng.integers(2, 257)))
                kw = {}
                if rng.random() < 0.5:       # extra ancillary chunks
                    pi = PngInfo()
                    pi.add_text("Comment", "x" * int(rng.integers(1, 999)))
                    kw["pnginfo"] = pi
                if mode == "Ptrans":
                    kw["transparency"] = int(rng.integers(0, 2))
                img.save(buf, "PNG",
                         compress_level=int(rng.integers(0, 10)), **kw)
                data = buf.getvalue()
            elif kind == "jpeg":
                mode = str(rng.choice(["RGB", "RGB", "L", "CMYK"]))
                img = Image.fromarray(noise).convert(mode)
                kw = {"quality": int(rng.integers(30, 96)),
                      "progressive": bool(rng.random() < 0.3),
                      "subsampling": int(rng.integers(0, 3))}
                if rng.random() < 0.4:       # EXIF orientation propagation
                    orientation = int(rng.integers(1, 9))
                    exif = Image.Exif()
                    exif[274] = orientation
                    kw["exif"] = exif
                img.save(buf, "JPEG", **kw)
                data = buf.getvalue()
                tol = 1 if mode != "CMYK" else 2
            elif kind == "webp":
                Image.fromarray(noise).save(
                    buf, "WEBP", lossless=bool(rng.random() < 0.5),
                    quality=int(rng.integers(30, 101)))
                data = buf.getvalue()
            elif kind == "bmp":
                mode = str(rng.choice(["RGB", "P", "L"]))
                img = Image.fromarray(noise)
                if mode == "P":
                    img = img.convert("P", palette=Image.ADAPTIVE,
                                      colors=int(rng.integers(2, 257)))
                elif mode == "L":
                    img = img.convert("L")
                img.save(buf, "BMP")
                data = buf.getvalue()
            elif kind == "gif":
                img = Image.fromarray(noise).convert(
                    "P", palette=Image.ADAPTIVE,
                    colors=int(rng.integers(2, 257)))
                kw = {"interlace": bool(rng.random() < 0.4)}
                if rng.random() < 0.4:      # GCE transparency -> white
                    kw["transparency"] = int(rng.integers(0, 4))
                if rng.random() < 0.3:      # animated: frame 0 contract
                    f1 = Image.fromarray(rng.integers(
                        0, 256, (h, w, 3), np.uint8)).convert(
                        "P", palette=Image.ADAPTIVE)
                    kw.update(save_all=True, append_images=[f1],
                              duration=50)
                img.save(buf, "GIF", **kw)
                data = buf.getvalue()
            elif kind == "heic":
                if not heif.available():
                    continue
                # dims floored at 16: HEVC pads tiny planes to coded block
                # size and reconstructs their edges poorly (62x7 at q84
                # measured mean err 21 — codec loss, not a decode bug)
                smooth = _smooth(rng, max(w, 16), max(h, 16))
                with tempfile.TemporaryDirectory() as d:
                    p = os.path.join(d, "x.heic")
                    heif.encode_to_file(p, smooth,
                                        quality=int(rng.integers(85, 96)))
                    data = open(p, "rb").read()
                if rng.random() < 0.3:
                    # corrupt HEVC through the libheif ctypes path: must
                    # reject cleanly or return a valid frame — never crash
                    bad = _corrupt(rng, data)
                    try:
                        dec, o = codec.decode(bad)
                        assert (dec.dtype == np.uint8 and dec.ndim == 3
                                and dec.shape[2] == 3), dec.shape
                    except Exception:
                        pass
                    print(f"seed {base + seed}: ok (corrupt heic)",
                          flush=True)
                    continue
                dec, o = codec.decode(data)
                assert o == 1 and dec.shape == smooth.shape
                # sanity bound, not a quality bound: HEVC loss on small
                # high-frequency planes measures mean err up to ~14
                # (seed 111120: 78x16 q87 -> 13.9); a channel swap or
                # stride bug on sinusoid content measures ~85
                assert np.abs(dec.astype(int)
                              - smooth.astype(int)).mean() < 20
                assert heif.probe(data) == (dec.shape[1], dec.shape[0])
                print(f"seed {base + seed}: ok (heic "
                      f"{w}x{h})", flush=True)
                continue
            else:                            # unknown ext -> transcode
                smooth = _smooth(rng, w, h)
                with tempfile.TemporaryDirectory() as d:
                    p = os.path.join(d, "x.tif")
                    Image.fromarray(smooth).save(p, "TIFF")
                    out_p = codec.transcode_if_needed(p)
                    assert out_p != p and out_p.endswith(".jpg")
                    dec, _ = codec.decode(out_p)
                assert dec.shape == smooth.shape
                assert np.abs(dec.astype(int)
                              - smooth.astype(int)).mean() < 4
                print(f"seed {base + seed}: ok (transcode {w}x{h})",
                      flush=True)
                continue

            if rng.random() < 0.3:           # corruption slice
                bad = _corrupt(rng, data)
                for dec_fn in (codec.decode, codec.salvage_decode):
                    try:
                        dec, o = dec_fn(bad)
                    except Exception:
                        continue             # clean rejection is fine
                    assert (dec.dtype == np.uint8 and dec.ndim == 3
                            and dec.shape[2] == 3), dec.shape
                print(f"seed {base + seed}: ok (corrupt {kind})",
                      flush=True)
                continue

            want = _ref_decode(data)
            dec, o = codec.decode(data)
            assert o == orientation, (o, orientation)
            assert dec.shape == want.shape, (dec.shape, want.shape)
            diff = np.abs(dec.astype(int) - want.astype(int)).max()
            assert diff <= tol, f"diff={diff} tol={tol} kind={kind}"
            dec2, _ = codec.decode(data)     # determinism
            assert np.array_equal(dec, dec2)
            info = codec.get_image_info(data)
            assert (info.raw_w, info.raw_h) == (want.shape[1],
                                                want.shape[0])
            assert info.orientation == orientation
            assert info.supported, info.format
            print(f"seed {base + seed}: ok ({kind} {w}x{h} tol={tol})",
                  flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} format cases, {fails} failures",
          flush=True)
    return fails


def run_serve(n_cases: int, base: int = 120_000) -> int:
    """Serving-path soak: each case is one StitchServer session fed a
    randomized job mix; every result parity-checked against the oracle.

    Probes what the unit tests can't sweep: random signature-class mixes
    (bucketing), random max_batch/max_wait (deadline flush vs batch-full
    flush), pow-2 padding at odd job counts, jobs-mesh on/off, submit-side
    rejects interleaved with good jobs, and stats-counter consistency at
    close."""
    from concurrent.futures import wait

    from imagestitching.serve.server import StitchServer

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n_classes = int(rng.integers(1, 5))
            classes = []
            for _ in range(n_classes):
                k = int(rng.integers(1, 5))
                specs = [(int(rng.integers(4, 65)), int(rng.integers(4, 65)),
                          int(rng.integers(1, 9))) for _ in range(k)]
                options = StitchOptions(
                    direction=str(rng.choice(["vertical", "horizontal"])),
                    mode=str(rng.choice(["min", "max", "original"])),
                    gap=_rand_gap(rng, 9),
                    filter=str(rng.choice(["bilinear", "triangle",
                                           "lanczos3"])),
                    supersample=False)
                # r4s11: channel classes — submit flattens RGBA onto white
                # (decode-ladder formula) and keeps all-gray jobs 1-channel
                chans = int(rng.choice([1, 3, 4], p=[0.15, 0.7, 0.15]))
                classes.append((specs, options, chans))
            srv = StitchServer(
                max_batch=int(rng.choice([2, 3, 4, 8, 16])),
                max_wait_s=float(rng.choice([0.0, 0.001, 0.02])),
                use_mesh=bool(rng.random() < 0.3),
                # down to 1: force signature-LRU evict/recompile cycles
                # mid-session (default 32 never evicts at <=4 classes)
                max_signatures=int(rng.choice([1, 2, 32])))
            jobs = []
            try:
                if rng.random() < 0.3:
                    # warmup slice: pre-compile one class's executables;
                    # subsequent real jobs of that class must still parity
                    wspecs, wopts, wch = classes[int(rng.integers(n_classes))]
                    info = srv.warmup(
                        [(h, w, max(1, min(wch, 3))) for w, h, _ in wspecs],
                        wopts, orientations=[o for _, _, o in wspecs],
                        batch_sizes=(int(rng.integers(1, 6)),))
                    assert info["batches"], info
                for _ in range(int(rng.integers(4, 17))):
                    specs, options, chans = \
                        classes[int(rng.integers(n_classes))]
                    imgs = [rng.integers(0, 256, (h, w, chans), np.uint8)
                            for w, h, _ in specs]
                    ors = [o for _, _, o in specs]
                    jobs.append((imgs, specs, options,
                                 srv.submit(imgs, options,
                                            orientations=ors)))
                    if rng.random() < 0.15:   # reject mid-stream
                        try:
                            srv.submit([], StitchOptions())
                        except ValueError:
                            pass
                wait([f for _, _, _, f in jobs], timeout=600)
                st = srv.stats()
            finally:
                srv.close()
            for imgs, specs, options, fut in jobs:
                plan = solve([ImageSpec(w, h, o) for w, h, o in specs],
                             options)
                out = fut.result(timeout=60)
                want = oracle.stitch(plan, [_flatten_white(a) for a in imgs])
                assert out.shape == want.shape, (out.shape, want.shape)
                diff = np.abs(out.astype(int) - want.astype(int)).max()
                assert diff <= 1, f"diff={diff}"
            assert st["jobs"] == len(jobs), (st, len(jobs))
            assert st["failed"] == 0, st
            assert 1 <= st["batches"] <= len(jobs), st
            print(f"seed {base + seed}: ok ({len(jobs)} jobs, "
                  f"{n_classes} classes, {st['batches']} batches)",
                  flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} serve cases, {fails} failures",
          flush=True)
    return fails


def run_stress(n_cases: int, base: int = 210_000) -> int:
    """Concurrency stress soak: T client threads hammer ONE StitchServer
    simultaneously — the race surface the single-threaded ``--serve`` mode
    never touches.

    Each case spawns 2-5 threads that concurrently submit jobs from mixed
    signature classes while also racing: ``warmup`` against live flushes,
    ``Future.cancel`` against the worker's resolve, ``stats()`` probes,
    ``ensure_capacity``/``admission()`` (grid-style out-of-band slot
    holders) against the tiny ``max_queue`` bound, and — in one slice —
    ``close()`` under live traffic.  Asserts what no interleaving may
    break: every future completes (deadlock freedom, bounded wall),
    admission-slot accounting quiesces to pending==0, the stats counters
    cohere (jobs+failed == admitted jobs), and every successful result is
    oracle-exact regardless of which batch shape the races produced.
    The reference avoids races structurally with a single isStitching
    mutex (pages/index/index.js:25,1193); this server replaces that with
    real locking, so the soak is its sanitizer."""
    import threading as _th
    import time
    from concurrent.futures import CancelledError, wait

    from imagestitching.serve.server import ServerOverloaded, StitchServer

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n_classes = int(rng.integers(1, 4))
            classes = []
            for _ in range(n_classes):
                k = int(rng.integers(1, 4))
                specs = [(int(rng.integers(4, 41)), int(rng.integers(4, 41)),
                          int(rng.integers(1, 9))) for _ in range(k)]
                options = StitchOptions(
                    direction=str(rng.choice(["vertical", "horizontal"])),
                    mode=str(rng.choice(["min", "max", "original"])),
                    gap=_rand_gap(rng, 7),
                    filter=str(rng.choice(["bilinear", "triangle"])),
                    supersample=False)
                chans = int(rng.choice([1, 3, 4], p=[0.15, 0.7, 0.15]))
                classes.append((specs, options, chans))
            close_slice = bool(rng.random() < 0.25)
            srv = StitchServer(
                max_batch=int(rng.choice([2, 4, 8])),
                max_wait_s=float(rng.choice([0.0, 0.001, 0.01])),
                use_mesh=bool(rng.random() < 0.2),
                # small queues make ServerOverloaded reachable under racing
                # submitters; slot accounting must still quiesce to zero
                max_queue=int(rng.choice([4, 8, 64])),
                max_signatures=int(rng.choice([1, 2, 32])))
            n_threads = int(rng.integers(2, 6))
            jobs_lock = _th.Lock()
            jobs = []          # (imgs, specs, options, future)
            counters = {"rejected": 0, "closed_refused": 0, "warmups": 0}

            def client(tid: int) -> None:
                trng = np.random.default_rng([base + seed, tid])
                for _ in range(int(trng.integers(3, 9))):
                    specs, options, chans = \
                        classes[int(trng.integers(n_classes))]
                    imgs = [trng.integers(0, 256, (h, w, chans), np.uint8)
                            for w, h, _ in specs]
                    ors = [o for _, _, o in specs]
                    r = trng.random()
                    try:
                        if r < 0.08:
                            # warmup racing live flushes (worker-thread
                            # serialized with real batches by design)
                            info = srv.warmup(
                                [(h, w, max(1, min(chans, 3)))
                                 for w, h, _ in specs],
                                options, orientations=ors,
                                batch_sizes=(int(trng.integers(1, 5)),))
                            with jobs_lock:
                                counters["warmups"] += 1
                            assert info["batches"], info
                        elif r < 0.14:
                            # grid-style out-of-band slot holder
                            with srv.admission():
                                time.sleep(float(trng.random()) * 0.002)
                        elif r < 0.18:
                            srv.ensure_capacity()   # non-reserving probe
                        else:
                            fut = srv.submit(imgs, options, orientations=ors)
                            with jobs_lock:
                                jobs.append((imgs, specs, options, fut))
                            if trng.random() < 0.12:
                                fut.cancel()    # may lose the race: fine
                    except ServerOverloaded:
                        with jobs_lock:
                            counters["rejected"] += 1
                        time.sleep(0.001)
                    except RuntimeError as e:
                        if "closed" in str(e) and close_slice:
                            with jobs_lock:
                                counters["closed_refused"] += 1
                            return
                        raise
                    if trng.random() < 0.2:
                        st = srv.stats()
                        assert st["pending"] <= srv.max_queue, st

            threads = [_th.Thread(target=client, args=(t,), daemon=True)
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            if close_slice:
                time.sleep(float(rng.random()) * 0.02)
                srv.close()
            for t in threads:
                t.join(timeout=600)
                assert not t.is_alive(), "client thread deadlocked"
            try:
                futs = [f for _, _, _, f in jobs]
                done, not_done = wait(futs, timeout=600)
                assert not not_done, f"{len(not_done)} futures never resolved"
                st = srv.stats()
            finally:
                srv.close()
            # every future done => every _resolve ran => slots quiesced
            assert st["pending"] == 0, st
            n_ok = n_err = n_cancelled = 0
            for imgs, specs, options, fut in jobs:
                if fut.cancelled():
                    n_cancelled += 1
                    continue
                try:
                    out = fut.result(timeout=0)
                except CancelledError:
                    n_cancelled += 1
                    continue
                except RuntimeError as e:
                    assert close_slice and "closed" in str(e), e
                    n_err += 1
                    continue
                plan = solve([ImageSpec(w, h, o) for w, h, o in specs],
                             options)
                want = oracle.stitch(plan, [_flatten_white(a) for a in imgs])
                assert out.shape == want.shape, (out.shape, want.shape)
                diff = np.abs(out.astype(int) - want.astype(int)).max()
                assert diff <= 1, f"diff={diff}"
                n_ok += 1
            # counter coherence: every admitted job was counted exactly once
            # by the worker OR dropped as cancelled (never computed, never
            # counted); jobs drained by close() behind the sentinel resolve
            # with the closed error WITHOUT a stats bump, so the close slice
            # asserts <= instead of ==
            admitted = len(jobs)
            counted = st["jobs"] + st["failed"] + n_cancelled
            if close_slice:
                assert counted <= admitted, (st, n_cancelled, admitted)
            else:
                assert counted == admitted, (st, n_cancelled, admitted)
            assert st["warmups"] == counters["warmups"], (st, counters)
            print(f"seed {base + seed}: ok ({n_threads} threads, "
                  f"{admitted} jobs: {n_ok} ok/{n_err} err/"
                  f"{n_cancelled} cancelled, rejected "
                  f"{counters['rejected']}"
                  f"{', CLOSED' if close_slice else ''})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} stress cases, {fails} failures",
          flush=True)
    return fails


def run_http(n_cases: int, base: int = 160_000) -> int:
    """HTTP-surface soak: each case boots a real ``StitchHTTPServer`` on a
    loopback socket and drives it with randomized concurrent clients.

    Covers the wire path end to end — multipart vs JSON-base64 bodies,
    query-string vs JSON-field options, mixed containers with EXIF
    orientation, PNG/JPEG response encoding — every response parity-checked
    against the oracle over the same decoded blobs.  Error slices assert
    the HTTP contract: 400 on empty/corrupt/bad-option requests, 404 on
    unknown routes, 413 (with dropped connection) on oversized bodies, and
    /stats counter consistency after the jobs land."""
    import base64 as _b64
    import http.client
    import io
    import json
    from concurrent.futures import ThreadPoolExecutor

    from imagestitching.serve.http import StitchHTTPServer

    def encode_blob(rng, arr, orientation):
        buf = io.BytesIO()
        kind = str(rng.choice(["png", "jpeg", "webp", "bmp"]))
        if kind == "jpeg":
            kw = {"quality": int(rng.integers(55, 96))}
            if orientation != 1:
                exif = Image.Exif()
                exif[274] = orientation
                kw["exif"] = exif
            Image.fromarray(arr).save(buf, "JPEG", **kw)
        else:
            if kind == "webp":
                Image.fromarray(arr).save(buf, "WEBP", lossless=True)
            else:
                Image.fromarray(arr).save(buf, kind.upper())
        return buf.getvalue()

    def multipart_body(blobs, rng):
        boundary = f"soakboundary{int(rng.integers(1e9))}"
        out = bytearray()
        for i, b in enumerate(blobs):
            out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"file{i}\"; filename=\"img{i}\"\r\n"
                    "Content-Type: application/octet-stream\r\n\r\n"
                    ).encode()
            out += b + b"\r\n"
        out += f"--{boundary}--\r\n".encode()
        return bytes(out), f"multipart/form-data; boundary={boundary}"

    def request(port, method, path, body=None, ctype=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            headers = {"Content-Type": ctype} if ctype else {}
            conn.request(method, path, body=body, headers=headers)
            r = conn.getresponse()
            return r.status, r.read(), r.getheader("Content-Type")
        finally:
            conn.close()

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            srv = StitchHTTPServer(
                port=0,
                max_request_bytes=int(rng.choice([1 << 16, 256 << 20])),
                max_batch=int(rng.choice([2, 4, 8])),
                max_wait_s=float(rng.choice([0.0, 0.005, 0.02])),
                use_mesh=bool(rng.random() < 0.25))
            try:
                st, body, _ = request(srv.port, "GET", "/healthz")
                assert st == 200 and b'"ok": true' in body, (st, body)

                # tiny-limit profile: keep legit job bodies well under the
                # 64 KB cap (4x 64px base64 noise PNGs would exceed it)
                tiny = srv.max_request_bytes == 1 << 16
                n_jobs = int(rng.integers(2, 7))
                jobs = []
                for _ in range(n_jobs):
                    k = int(rng.integers(1, 3 if tiny else 5))
                    # jpg responses: smooth content (q95 loss on noise
                    # measures mean err ~25-34) with dims floored at 16 —
                    # a sub-8px canvas side puts whole features inside one
                    # DCT block (16x5 canvas measured mean 14.8 on smooth)
                    fmt = "jpg" if rng.random() < 0.2 else "png"
                    lo = 16 if fmt == "jpg" else 4
                    blobs = []
                    for _ in range(k):
                        w = int(rng.integers(lo, 33 if tiny else 65))
                        h = int(rng.integers(lo, 33 if tiny else 65))
                        arr = (_smooth(rng, w, h) if fmt == "jpg" else
                               rng.integers(0, 256, (h, w, 3), np.uint8))
                        o = (int(rng.integers(1, 9))
                             if rng.random() < 0.4 else 1)
                        blob = encode_blob(rng, arr, o)
                        blobs.append(blob)
                    options = StitchOptions(
                        direction=str(rng.choice(["vertical",
                                                  "horizontal"])),
                        mode=str(rng.choice(["min", "max", "original"])),
                        gap=_rand_gap(rng, 9),
                        filter=str(rng.choice(["bilinear", "triangle",
                                               "lanczos3"])),
                        background=tuple(int(x)
                                         for x in rng.integers(0, 256, 3)),
                        supersample=False)
                    wire = str(rng.choice(["multipart", "json"]))
                    jobs.append((blobs, options, fmt, wire))

                def fire(job, jrng_seed):
                    jrng = np.random.default_rng(jrng_seed)
                    blobs, options, fmt, wire = job
                    qs = (f"direction={options.direction}"
                          f"&mode={options.mode}&gap={options.gap}"
                          f"&filter={options.filter}"
                          f"&background={','.join(map(str, options.background))}"
                          f"&format={fmt}&quality=95"
                          f"&png_level={int(jrng.integers(0, 7))}")
                    if wire == "multipart":
                        body, ctype = multipart_body(blobs, jrng)
                        return request(srv.port, "POST", f"/stitch?{qs}",
                                       body, ctype)
                    payload = {"images": [_b64.b64encode(b).decode()
                                          for b in blobs],
                               "direction": options.direction,
                               "mode": options.mode, "gap": options.gap,
                               "filter": options.filter,
                               "background": list(options.background),
                               "format": fmt, "quality": 95}
                    return request(srv.port, "POST", "/stitch",
                                   json.dumps(payload).encode(),
                                   "application/json")

                with ThreadPoolExecutor(max_workers=4) as pool:
                    futs = [pool.submit(fire, j, base + seed * 97 + i)
                            for i, j in enumerate(jobs)]
                    replies = [f.result(timeout=600) for f in futs]

                from imagestitching.imgio import codec as _codec
                for (blobs, options, fmt, _), (st, body, ctype) in zip(
                        jobs, replies):
                    decoded = [_codec.decode(b) for b in blobs]
                    specs = [ImageSpec(a.shape[1], a.shape[0], o)
                             for a, o in decoded]
                    plan = solve(specs, options)
                    assert st == 200, (st, body[:200])
                    want = oracle.stitch(plan, [a for a, _ in decoded])
                    out = np.asarray(Image.open(
                        io.BytesIO(body)).convert("RGB"))
                    assert out.shape == want.shape, (out.shape, want.shape)
                    diff = np.abs(out.astype(int) - want.astype(int))
                    if fmt == "png":
                        assert ctype == "image/png", ctype
                        assert diff.max() <= 1, f"diff={diff.max()}"
                    else:
                        assert ctype == "image/jpeg", ctype
                        if _jpg_parity_ok(plan):
                            assert diff.mean() < 12, \
                                f"mean={diff.mean():.1f}"

                if rng.random() < 0.5:
                    # grid-collage wire: bypasses the batch server (one-
                    # shot api job), so server stats below are unaffected
                    from imagestitching.core.grid import plan_grid
                    g_imgs = [rng.integers(0, 256,
                                           (int(rng.integers(8, 40)),
                                            int(rng.integers(8, 40)), 3),
                                           np.uint8)
                              for _ in range(int(rng.integers(1, 6)))]
                    g_opts = StitchOptions(
                        gap=_rand_gap(rng, 5),
                        background=tuple(int(x)
                                         for x in rng.integers(0, 256, 3)))
                    g_cols = int(rng.integers(1, 4))
                    g_valign = str(rng.choice(["top", "center"]))
                    g_order = str(rng.choice(["balance", "preserve"]))
                    payload = {
                        "images": [_b64.b64encode(_codec.encode_bytes(
                            a, "png")).decode() for a in g_imgs],
                        "gap": g_opts.gap,
                        "background": list(g_opts.background),
                        "grid_cols": g_cols, "grid_order": g_order,
                        "valign": g_valign}
                    st, body, ctype = request(
                        srv.port, "POST", "/stitch",
                        json.dumps(payload).encode(), "application/json")
                    assert st == 200, (st, body[:200])
                    g_specs = [ImageSpec(a.shape[1], a.shape[0])
                               for a in g_imgs]
                    gplan = plan_grid(g_specs, g_cols, g_opts,
                                      order=g_order)
                    want = np.empty((gplan.canvas_h, gplan.canvas_w, 3),
                                    np.uint8)
                    want[:] = np.asarray(gplan.background, np.uint8)
                    g_px = int(np.floor(gplan.gap + 0.5))
                    x = 0
                    for idx_list, gp in zip(gplan.columns,
                                            gplan.col_plans):
                        col = oracle.stitch(gp, [g_imgs[i]
                                                 for i in idx_list])
                        y = ((gplan.canvas_h - col.shape[0]) // 2
                             if g_valign == "center" else 0)
                        want[y:y + col.shape[0], x:x + col.shape[1]] = col
                        x += gplan.col_width + g_px
                    out = np.asarray(Image.open(io.BytesIO(body)))
                    assert out.shape == want.shape, (out.shape, want.shape)
                    assert np.abs(out.astype(int)
                                  - want.astype(int)).max() <= 1

                # error slices against the live server
                st, body, _ = request(srv.port, "POST", "/stitch",
                                      b"{}", "application/json")
                assert st == 400, (st, body)
                st, body, _ = request(srv.port, "GET", "/nope")
                assert st == 404, st
                st, body, _ = request(
                    srv.port, "POST", "/stitch",
                    json.dumps({"images": [_b64.b64encode(
                        b"garbagegarbage").decode()]}).encode(),
                    "application/json")
                assert st == 400, (st, body)
                if tiny and rng.random() < 0.5:
                    # body just over the limit: fits loopback buffers, so
                    # the response lands before the unread-body close races
                    # the client's send
                    st, body, _ = request(srv.port, "POST", "/stitch",
                                          b"x" * ((1 << 16) + 1),
                                          "application/json")
                    assert st == 413, (st, body)
                if rng.random() < 0.5:
                    # internal-failure slice (r4s10): a server-side error
                    # must surface as 500, never the old blanket 400
                    _orig_submit = srv.server.submit

                    def _boom(*a, **kw):
                        raise RuntimeError("soak-injected backend failure")

                    srv.server.submit = _boom
                    try:
                        st, body, _ = request(
                            srv.port, "POST", "/stitch",
                            json.dumps({"images": [_b64.b64encode(
                                encode_blob(rng, rng.integers(
                                    0, 256, (8, 8, 3), np.uint8), 1)
                            ).decode()]}).encode(), "application/json")
                        assert st == 500, (st, body)
                        assert b"soak-injected" in body, body[:200]
                    finally:
                        srv.server.submit = _orig_submit

                if rng.random() < 0.4:
                    # warmup slice (r4s11): randomized geometry through
                    # POST /warmup, plus the malformed-payload 400 contract
                    wn = int(rng.integers(1, 4))
                    wshapes = [[int(rng.integers(8, 80)),
                                int(rng.integers(8, 80))] for _ in range(wn)]
                    st, body, _ = request(
                        srv.port, "POST", "/warmup",
                        json.dumps({"shapes": wshapes,
                                    "gap": float(rng.integers(0, 5)),
                                    "batch_sizes":
                                        [int(rng.integers(1, 5))]}).encode(),
                        "application/json")
                    assert st == 200, (st, body)
                    assert json.loads(body)["batches"], body
                    bad = str(rng.choice(["[1]", '{"shapes": []}',
                                          '{"shapes": [[8, 8]], '
                                          '"batch_sizes": 2}']))
                    st, body, _ = request(srv.port, "POST", "/warmup",
                                          bad.encode(), "application/json")
                    assert st == 400, (st, body, bad)

                st, body, _ = request(srv.port, "GET", "/stats")
                assert st == 200, st
                stats = json.loads(body)["server"]
                assert stats["jobs"] >= n_jobs, (stats, n_jobs)
                assert stats["failed"] == 0, stats
                print(f"seed {base + seed}: ok ({n_jobs} jobs, "
                      f"{stats['batches']} batches)", flush=True)
            finally:
                srv.close()
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} http cases, {fails} failures", flush=True)
    return fails


def run_cli(n_cases: int, base: int = 150_000) -> int:
    """CLI-surface soak: randomized in-process ``cli.main(argv)`` calls.

    The other soak modes drive the library API; this one covers the wiring
    only unit tests touch — argument parsing, background/limits/profile
    plumbing, the on_error ladder, the --json/--metrics output contract,
    and the file-in/file-out round trip (mixed containers, EXIF
    orientation, lossy sources).  The oracle decodes the SAME files via
    ``codec.decode``, so lossy sources cost no tolerance; lossless PNG
    output means the written file must match the canvas exactly.  A slice
    of cases exercises the documented failure exits (bad --background ->
    rc 2, max_images violation / undecodable input -> rc 1) and the
    --on-error skip path against an oracle over the decodable subset."""
    import contextlib
    import dataclasses as _dc
    import io
    import json as _json

    from imagestitching import cli
    from imagestitching.config import CanvasLimits
    from imagestitching.imgio import codec, native

    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            with tempfile.TemporaryDirectory() as d:
                n = int(rng.integers(1, 7))
                # jpg output: smooth content, dims floored at 16 — q95
                # chroma loss on noise measures mean 14-34 (unboundable),
                # and sub-8px canvases put whole features in one DCT block
                out_ext = "jpg" if rng.random() < 0.15 else "png"
                lo = 16 if out_ext == "jpg" else 4
                paths = []
                for i in range(n):
                    w = int(rng.integers(lo, 65))
                    h = int(rng.integers(lo, 65))
                    arr = (_smooth(rng, w, h) if out_ext == "jpg" else
                           rng.integers(0, 256, (h, w, 3), np.uint8))
                    kind = str(rng.choice(
                        ["png", "png_native", "bmp", "jpeg", "webp"]))
                    if kind == "png_native":
                        p = os.path.join(d, f"{i}.png")
                        with open(p, "wb") as f:
                            f.write(native.encode_png(
                                arr, compression=int(rng.integers(0, 7))))
                    elif kind == "jpeg":
                        p = os.path.join(d, f"{i}.jpg")
                        kw = {"quality": int(rng.integers(40, 96))}
                        if rng.random() < 0.4:
                            exif = Image.Exif()
                            exif[274] = int(rng.integers(1, 9))
                            kw["exif"] = exif
                        Image.fromarray(arr).save(p, "JPEG", **kw)
                    elif kind == "webp":
                        p = os.path.join(d, f"{i}.webp")
                        Image.fromarray(arr).save(
                            p, "WEBP", lossless=bool(rng.random() < 0.5),
                            quality=int(rng.integers(50, 101)))
                    else:
                        ext = "png" if kind == "png" else "bmp"
                        p = os.path.join(d, f"{i}.{ext}")
                        Image.fromarray(arr).save(p)
                    paths.append(p)

                failure_kind = None
                if rng.random() < 0.18:
                    failure_kind = str(rng.choice(
                        ["bad_background", "max_images", "corrupt_raise",
                         "corrupt_skip"]))
                if failure_kind in ("corrupt_raise", "corrupt_skip"):
                    # pure garbage: fails decode AND the salvage ladder
                    bad = os.path.join(d, "bad.png")
                    with open(bad, "wb") as f:
                        f.write(bytes(rng.integers(0, 256, 24,
                                                   np.uint8).tobytes()))
                    paths.insert(int(rng.integers(0, len(paths) + 1)), bad)

                options = StitchOptions(
                    direction=str(rng.choice(["vertical", "horizontal"])),
                    mode=str(rng.choice(["min", "max", "original"])),
                    gap=_rand_gap(rng, 13),
                    filter=str(rng.choice(["bilinear", "bilinear",
                                           "triangle", "box", "lanczos3"])),
                    background=tuple(int(x) for x in rng.integers(0, 256, 3)),
                    supersample=bool(rng.random() < 0.15),
                    max_images=None)
                out_path = os.path.join(d, f"out.{out_ext}")
                argv = list(paths) + ["-o", out_path,
                                      "--direction", options.direction,
                                      "--mode", options.mode,
                                      "--gap", str(options.gap),
                                      "--filter", options.filter,
                                      "--background",
                                      ",".join(map(str, options.background)),
                                      "--engine",
                                      str(rng.choice(["auto", "auto", "xla",
                                                      "oracle"])),
                                      "--overlap",
                                      str(rng.choice(["auto", "always",
                                                      "never"])),
                                      "--png-level",
                                      str(int(rng.integers(0, 10)))]
                if options.supersample:
                    argv.append("--supersample")
                profile = None
                if rng.random() < 0.2:
                    profile = str(rng.choice(["ios", "android"]))
                    argv += ["--parity-profile", profile]
                limits = (CanvasLimits.reference_ios() if profile == "ios"
                          else CanvasLimits.reference_android()
                          if profile == "android" else None)
                limits_kw = {}
                if rng.random() < 0.25:
                    limits_kw["max_side"] = int(rng.integers(16, 200))
                    argv += ["--max-side", str(limits_kw["max_side"])]
                if rng.random() < 0.25:
                    limits_kw["max_pixels"] = int(rng.integers(400, 30_000))
                    argv += ["--max-pixels", str(limits_kw["max_pixels"])]
                if limits_kw:
                    limits = _dc.replace(limits or CanvasLimits(),
                                         **limits_kw)
                artifact_dir = None
                if rng.random() < 0.2 and failure_kind is None:
                    # artifact-store slice: run the SAME argv twice — the
                    # second invocation must serve decodes from the disk
                    # store (runtime/artifacts) and still match the oracle
                    artifact_dir = os.path.join(d, "acache")
                    argv += ["--artifact-cache", artifact_dir]
                if rng.random() < 0.3:
                    argv += ["--decode-threads",
                             str(int(rng.integers(1, 4)))]
                if rng.random() < 0.3:
                    argv += ["--decode-window", str(int(rng.integers(1, 4)))]
                if rng.random() < 0.25:
                    argv.append("--no-stream")
                style = rng.integers(0, 4)
                as_json = style == 1
                if style == 0:
                    argv.append("--quiet")
                elif style == 1:
                    argv.append("--json")
                if rng.random() < 0.5:
                    argv.append("--metrics")

                if failure_kind == "bad_background":
                    argv[argv.index("--background") + 1] = str(rng.choice(
                        ["256,0,0", "1,2", "a,b,c", "-1,0,0", "1,2,3,4"]))
                elif failure_kind == "max_images":
                    argv += ["--max-images", str(len(paths) - 1)]
                elif failure_kind == "corrupt_skip":
                    argv += ["--on-error", "skip"]

                so, se = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(so), \
                        contextlib.redirect_stderr(se):
                    try:
                        rc = cli.main(argv)
                    except SystemExit as e:
                        # argparse rejections (e.g. a dash-leading
                        # --background value parsed as an option) exit(2)
                        # instead of returning; same rc-2 contract
                        rc = int(e.code or 0)

                if failure_kind == "bad_background":
                    assert rc == 2, (rc, se.getvalue())
                    assert "background" in se.getvalue()
                    print(f"seed {base + seed}: ok (rc2 bad background)",
                          flush=True)
                    continue
                if failure_kind in ("max_images", "corrupt_raise"):
                    assert rc == 1, (rc, se.getvalue())
                    assert "error:" in se.getvalue()
                    print(f"seed {base + seed}: ok (rc1 {failure_kind})",
                          flush=True)
                    continue
                assert rc == 0, (rc, se.getvalue())

                imgs, specs = [], []
                for p in paths:
                    try:
                        img, o = codec.decode(p)
                    except Exception:
                        assert failure_kind == "corrupt_skip"
                        continue
                    imgs.append(img)
                    specs.append(ImageSpec(img.shape[1], img.shape[0], o))
                plan = solve(specs, options, limits)
                want = oracle.stitch(plan, imgs)
                out = np.asarray(Image.open(out_path).convert("RGB"))
                assert out.shape == want.shape, (out.shape, want.shape)
                diff = np.abs(out.astype(int) - want.astype(int))
                if out_ext == "png":
                    assert diff.max() <= 1, f"diff={diff.max()}"
                elif _jpg_parity_ok(plan):
                    assert diff.mean() < 12, f"jpeg mean={diff.mean():.1f}"
                if as_json:
                    res = _json.loads(so.getvalue())
                    assert (res["width"], res["height"]) == (
                        want.shape[1], want.shape[0]), res
                    assert ("metrics" in res) == ("--metrics" in argv), res
                if artifact_dir is not None:
                    # second identical run: clear the process-global RAM
                    # bitmap cache so decodes MUST come from the disk
                    # artifact store's read path, and still match
                    from imagestitching.runtime import cache as _rc
                    assert os.listdir(artifact_dir), "store never written"
                    _rc.get_cache().clear()
                    with contextlib.redirect_stdout(io.StringIO()), \
                            contextlib.redirect_stderr(io.StringIO()):
                        rc2 = cli.main(argv)
                    assert rc2 == 0, rc2
                    out2 = np.asarray(Image.open(out_path).convert("RGB"))
                    if out_ext == "png":
                        d2 = np.abs(out2.astype(int) - want.astype(int))
                        assert d2.max() <= 1, f"store rerun diff={d2.max()}"
                tag = "store" if artifact_dir is not None else (
                    failure_kind or "clean")
                print(f"seed {base + seed}: ok (n={len(specs)}, "
                      f"{plan.canvas_w}x{plan.canvas_h}, {out_ext}, "
                      f"{tag})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} cli cases, {fails} failures", flush=True)
    return fails


def run_preview(n_cases: int, base: int = 170_000) -> int:
    """Randomized soak of the preview surface (``api.make_preview`` /
    ``api.preview_size``) — the one public entry point the job-shaped soak
    modes never reach.  Device path (XLA gather-engine resize, f32) vs the
    float64 host oracle path within 1 uint8 step; the ``preview_size``
    contract (fit-to-width, 180 px floor — utils/canvas.js:124-128) is
    asserted on the output shape.  Degenerate shapes (1-px sides, extreme
    aspect, upscales where box_w > source width) are over-represented: the
    resize taps, not the compositor, are under test here."""
    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            shape_kind = rng.integers(0, 4)
            if shape_kind == 0:      # degenerate: a 1-px side
                w, h = (1, int(rng.integers(1, 400))) if rng.random() < .5 \
                    else (int(rng.integers(1, 400)), 1)
            elif shape_kind == 1:    # extreme aspect (strip-like)
                w, h = int(rng.integers(300, 2000)), int(rng.integers(2, 40))
                if rng.random() < 0.5:
                    w, h = h, w
            else:                    # ordinary
                w, h = int(rng.integers(2, 700)), int(rng.integers(2, 700))
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            box_w = int(rng.integers(1, 600))
            min_height = (180 if rng.random() < 0.5
                          else int(rng.integers(1, 400)))
            # bound the preview to ~2 MP: a 1-px-wide source makes
            # ph = box_w*h/w explode, and the float64 oracle path would
            # hold 8x that in intermediates
            while box_w > 1 and box_w * api.preview_size(
                    w, h, box_w, min_height)[1] > 2_000_000:
                box_w //= 2
            pw, ph = api.preview_size(w, h, box_w, min_height)
            # independent half-up formula (NOT Python round — banker's)
            import math as _math
            assert pw == box_w and ph == max(
                min_height,
                _math.floor(box_w * h / max(1, w) + 0.5)), (pw, ph)
            # Exercise the device resize DIRECTLY first: make_preview's
            # blanket host-fallback would otherwise mask a broken device
            # path (got == want trivially, all seeds green).  Any raise
            # here is a soak failure.
            direct = np.asarray(api._device_resize(img, ph, pw))
            got = api.make_preview(img, box_w, min_height, device=True)
            assert np.array_equal(got, direct), (
                "make_preview(device=True) took the host fallback")
            want = api.make_preview(img, box_w, min_height, device=False)
            assert got.shape == (ph, pw, 3) == want.shape, (
                got.shape, want.shape, (ph, pw))
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            assert diff <= 1, f"diff={diff}"
            if seed % 25 == 0:
                print(f"seed {base + seed}: ok ({w}x{h} -> {pw}x{ph}, "
                      f"diff={diff})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} preview cases, {fails} failures",
          flush=True)
    return fails


def run_export(n_cases: int, base: int = 180_000) -> int:
    """Randomized soak of the export surface: ``api.stitch_to_file``'s
    stream/monolithic fork and the banded streaming encoders in
    ``runtime/export`` — the one public surface without a dedicated slice
    (the job-shaped modes only ever hit ``stream="auto"`` PNG).

    Invariants per case:
      * streamed and monolithic exports of the SAME job are byte-identical
        for JPEG (both feed libjpeg identical canvas rows at identical
        settings — export.py's documented contract) and decode-identical
        for PNG (filter/compressor choices legitimately differ; pixels
        may not), each within 1 uint8 step of the float64 oracle;
      * the export layer round-trips random canvases bit-exactly at
        adversarial ``band_rows`` (1, 3, h-1, h, h+7, 64 — band seams are
        where a row-order bug would live), host- and device-resident;
      * ``stream=True`` raises the documented errors for non-streamable
        formats.
    """
    from imagestitching.imgio import codec, native
    from imagestitching.runtime import export

    if not native.available():
        print("native codec unavailable — export soak is vacuous")
        return 1
    fails = 0
    seed = -1
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            kind = rng.random()
            if kind < 0.55:          # full jobs through stitch_to_file
                n = int(rng.integers(1, 6))
                equalize = rng.random() < 0.4
                direction = str(rng.choice(["vertical", "horizontal"]))
                common = int(rng.integers(8, 90))
                specs, imgs = [], []
                for _ in range(n):
                    w = (common if (equalize and direction == "vertical")
                         else int(rng.integers(4, 90)))
                    h = (common if (equalize and direction == "horizontal")
                         else int(rng.integers(4, 90)))
                    o = int(rng.integers(1, 9))
                    specs.append(ImageSpec(w, h, o))
                    imgs.append(rng.integers(0, 256, (h, w, 3), np.uint8))
                options = StitchOptions(
                    direction=direction,
                    mode=str(rng.choice(["min", "max", "original"])),
                    gap=_rand_gap(rng, 9),
                    filter=str(rng.choice(["bilinear", "triangle",
                                           "box", "lanczos3"])),
                    background=tuple(int(x)
                                     for x in rng.integers(0, 256, 3)))
                plan = solve(specs, options)
                want = oracle.stitch(plan, imgs)
                cfg = RuntimeConfig()
                items = [(a, s.orientation) for a, s in zip(imgs, specs)]
                ext = str(rng.choice(["png", "jpg"]))
                q = int(rng.integers(60, 96))
                lvl = int(rng.choice([0, 1, 6]))
                with tempfile.TemporaryDirectory() as d:
                    pm = os.path.join(d, f"m.{ext}")
                    ps = os.path.join(d, f"s.{ext}")
                    api.stitch_to_file(items, pm, stream=False, quality=q,
                                       png_compression=lvl, options=options,
                                       config=cfg)
                    _, met = api.stitch_to_file(
                        items, ps, stream=True, quality=q,
                        png_compression=lvl, options=options, config=cfg,
                        return_metrics=True)
                    assert met.export_s >= 0
                    bm = open(pm, "rb").read()
                    bs = open(ps, "rb").read()
                    am = np.asarray(Image.open(pm).convert("RGB"))
                    if ext == "jpg":
                        assert bm == bs, (
                            f"jpeg stream/monolithic bytes differ "
                            f"({len(bm)} vs {len(bs)})")
                    else:
                        a_s = np.asarray(Image.open(ps).convert("RGB"))
                        assert np.array_equal(am, a_s), \
                            "png stream/monolithic pixels differ"
                        diff = np.abs(am.astype(int)
                                      - want.astype(int)).max()
                        assert diff <= 1, f"png diff={diff}"
                    assert am.shape == want.shape, (am.shape, want.shape)
                note = f"job {ext} n={n}"
            elif kind < 0.9:         # export layer at adversarial bands
                h = int(rng.integers(1, 220))
                w = int(rng.integers(1, 220))
                canvas = rng.integers(0, 256, (h, w, 3), np.uint8)
                br = rng.choice([1, 3, max(1, h - 1), h, h + 7, 64, 0])
                br = int(br) or None      # 0 -> None (auto sizing)
                on_device = rng.random() < 0.4
                src = jax.numpy.asarray(canvas) if on_device else canvas
                fmt = str(rng.choice(["png", "jpg"]))
                q = int(rng.integers(60, 96))
                lvl = int(rng.choice([0, 1, 6]))
                with tempfile.TemporaryDirectory() as d:
                    p = os.path.join(d, f"o.{fmt}")
                    if fmt == "png":
                        export.stream_to_png(src, p, lvl, band_rows=br)
                        got = np.asarray(Image.open(p).convert("RGB"))
                        assert np.array_equal(got, canvas), \
                            f"png band round-trip mismatch (band_rows={br})"
                    else:
                        export.stream_to_jpeg(src, p, q, band_rows=br)
                        p2 = os.path.join(d, "whole.jpg")
                        codec.encode(p2, canvas, quality=q)
                        assert (open(p, "rb").read()
                                == open(p2, "rb").read()), \
                            f"jpeg banded != monolithic (band_rows={br})"
                note = (f"bands {fmt} {w}x{h} br={br}"
                        f"{' dev' if on_device else ''}")
            else:                    # documented error contracts
                img = rng.integers(0, 256, (12, 13, 3), np.uint8)
                with tempfile.TemporaryDirectory() as d:
                    try:
                        api.stitch_to_file([(img, 1)],
                                           os.path.join(d, "o.webp"),
                                           stream=True)
                        raise AssertionError(
                            "stream=True accepted a non-streamable format")
                    except ValueError:
                        pass
                    try:
                        api.stitch_to_file([(img, 1)],
                                           os.path.join(d, "o.png"),
                                           stream="yes")
                        raise AssertionError("bad stream value accepted")
                    except ValueError:
                        pass
                note = "error contracts"
            if seed % 25 == 0:
                print(f"seed {base + seed}: ok ({note})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
            if fails >= 3:
                break
    ran = seed + 1 if n_cases else 0
    print(f"done: {ran}/{n_cases} export cases, {fails} failures",
          flush=True)
    return fails


def _build_merge_chain(rng, full: bool = True):
    """Synthetic screenshot chain (canonical vertical space) with KNOWN
    constructed overlaps.  Returns (parts, expected_trims, kinds).
    ``full=True`` includes every contract-boundary kind (sub-strip,
    beyond-cap, over-threshold reject, width change); ``full=False`` keeps
    the chip-friendly core (exact / noisy-within-threshold / fresh)."""
    n = int(rng.integers(2, 6))
    cur_w = int(rng.integers(24, 180))
    h0 = int(rng.integers(90, 380))
    parts = [rng.integers(0, 256, (h0, cur_w, 3), np.uint8)]
    expected = [0]
    kinds = ["seed"]
    for _ in range(1, n):
        h = int(rng.integers(90, 380))
        ha = parts[-1].shape[0]
        o_cap = min(int(0.5 * min(ha, h)), h - 1, ha)
        r = float(rng.random())
        fresh = rng.integers(0, 256, (h, cur_w, 3), np.uint8)
        if full and r < 0.12:                   # width change: no match
            cur_w = max(8, cur_w + int(rng.integers(5, 25)))
            parts.append(rng.integers(0, 256, (h, cur_w, 3), np.uint8))
            expected.append(0)
            kinds.append("width")
            continue
        if r < 0.24 or o_cap < 32:              # fresh content
            part, exp, kind = fresh, 0, "fresh"
        elif full and r < 0.36:                 # sub-strip overlap
            o = int(rng.integers(1, 32))
            fresh[:o] = parts[-1][ha - o:]
            part, exp, kind = fresh, 0, "tiny"
        elif full and r < 0.46:                 # beyond-cap overlap
            o = o_cap + int(rng.integers(1, 9))
            fresh[:o] = parts[-1][ha - o:]
            part, exp, kind = fresh, 0, "beyond"
        elif r < 0.64:                          # noisy, within threshold
            o = int(rng.integers(32, o_cap + 1))
            wob = rng.choice([-1, 1], (o, cur_w, 3))
            fresh[:o] = np.clip(
                parts[-1][ha - o:].astype(np.int16) + wob,
                0, 255).astype(np.uint8)
            part, exp, kind = fresh, o, "noisy"
        elif full and r < 0.76:                 # perturbed past threshold
            o = int(rng.integers(32, o_cap + 1))
            wob = rng.choice([-4, 4], (o, cur_w, 3))
            fresh[:o] = np.clip(
                parts[-1][ha - o:].astype(np.int16) + wob,
                0, 255).astype(np.uint8)
            part, exp, kind = fresh, 0, "reject"
        else:                                   # exact duplicate strip
            o = int(rng.integers(32, o_cap + 1))
            fresh[:o] = parts[-1][ha - o:]
            part, exp, kind = fresh, o, "exact"
        parts.append(part)
        expected.append(exp)
        kinds.append(kind)
    return parts, expected, kinds


def run_merge(n_cases: int, base: int = 190_000) -> int:
    """Randomized soak of the auto-overlap merge (``StitchOptions.
    merge_overlap``, ops/overlap.py).  Each case builds a synthetic
    screenshot chain in canonical space with KNOWN constructed overlaps —
    exact duplicates, within-threshold noisy duplicates (+-1 level),
    over-threshold perturbations (+-4, must be rejected), sub-strip
    overlaps (<32 rows, undetectable by contract), beyond-cap overlaps
    (> max_frac * min(h), undetectable by contract), width-mismatch and
    fresh-content controls — then asserts:

    1. device-scored ``detect_trims`` == the float64 numpy twin == the
       constructed expectation (the exact-verify contract makes this
       deterministic — no tolerance);
    2. the full merged stitch equals the float64 oracle stitch of the
       pre-trimmed chain within 1 uint8 step, across random direction /
       mode / gap (fractional included) / filter / EXIF orientations /
       canvas limits (forcing the resample engines) / engine choice.
    """
    from imagestitching.core import geometry
    from imagestitching.ops import overlap as ovl

    _ORIENT_GROUP = list(range(1, 9))

    def _raw_for(display, orient):
        """A raw array whose display form under EXIF tag ``orient`` is
        ``display``: search the 8-element orientation group for g with
        f_orient(g(display)) == display (D4 is closed, so one exists)."""
        if orient == 1:
            return display
        for g in _ORIENT_GROUP:
            cand = geometry.orient_array(display, g)
            if (geometry.orient_array(cand, orient).shape == display.shape
                    and np.array_equal(geometry.orient_array(cand, orient),
                                       display)):
                return np.ascontiguousarray(cand)
        raise AssertionError(f"no inverse for orientation {orient}")

    fails = 0
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            direction = ("vertical" if rng.random() < 0.7 else "horizontal")
            parts, expected, kinds = _build_merge_chain(rng, full=True)
            n = len(parts)

            displays = ([p for p in parts] if direction == "vertical"
                        else [p.transpose(1, 0, 2) for p in parts])
            trims_dev = ovl.detect_trims(displays, direction)
            trims_np = ovl.detect_trims(displays, direction, device=False)
            assert trims_dev == expected, \
                f"device {trims_dev} != expected {expected} kinds={kinds}"
            assert trims_np == expected, \
                f"numpy {trims_np} != expected {expected} kinds={kinds}"

            # EXIF: feed some images as raw + orientation tag
            raws, specs = [], []
            for d in displays:
                orient = (int(rng.integers(2, 9)) if rng.random() < 0.25
                          else 1)
                raw = _raw_for(d, orient)
                raws.append(raw)
                specs.append(ImageSpec(raw.shape[1], raw.shape[0], orient))

            options = StitchOptions(
                direction=direction,
                mode=str(rng.choice(["min", "max", "original"])),
                gap=_rand_gap(rng, 9),
                filter=str(rng.choice(["bilinear", "triangle", "lanczos3"])),
                background=tuple(int(x) for x in rng.integers(0, 256, 3)),
                merge_overlap=True)
            limits = (ist.CanvasLimits(max_side=int(rng.integers(200, 900)))
                      if rng.random() < 0.5 else None)
            engine = str(rng.choice(["auto", "auto", "xla"]))
            got = api.stitch_arrays(raws, specs=specs, options=options,
                                    config=RuntimeConfig(engine=engine),
                                    limits=limits)

            trimmed = ovl.apply_trims(displays, expected, direction)
            t_specs = [ImageSpec(a.shape[1], a.shape[0]) for a in trimmed]
            plan = solve(t_specs,
                         dataclasses.replace(options, merge_overlap=False),
                         limits)
            want = oracle.stitch(plan, trimmed)
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            assert diff <= 1, f"diff={diff} kinds={kinds}"
            if seed % 25 == 0:
                print(f"seed {base + seed}: ok (n={n}, {direction}, "
                      f"kinds={','.join(kinds[1:])}, "
                      f"canvas={plan.canvas_w}x{plan.canvas_h})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
    print(f"done: {n_cases - fails}/{n_cases} merge cases, "
          f"{fails} failures", flush=True)
    return fails


def _assemble_grid_oracle(gplan, disp, valign):
    """Independent float64-oracle assembly of a grid plan: per-column
    oracle stitches placed write-once on a hand-built background canvas
    (the verification twin of core/grid._assemble)."""
    want = np.empty((gplan.canvas_h, gplan.canvas_w, 3), np.uint8)
    want[:] = np.asarray(gplan.background, np.uint8)
    gap_px = int(np.floor(gplan.gap + 0.5))
    x = 0
    for idx_list, plan in zip(gplan.columns, gplan.col_plans):
        col = oracle.stitch(plan, [disp[i] for i in idx_list])
        y = ((gplan.canvas_h - col.shape[0]) // 2
             if valign == "center" else 0)
        want[y:y + col.shape[0], x:x + col.shape[1]] = col
        x += gplan.col_width + gap_px
    return want


def run_grid(n_cases: int, base: int = 200_000) -> int:
    """Randomized soak of the grid collage (``api.stitch_grid``,
    core/grid.py): random image sets (grayscale and EXIF-tagged inputs
    included), cols/order/valign/mode/gap (fractional)/background/limits/
    engine, each checked against an INDEPENDENT assembly of per-column
    float64 oracle stitches on a hand-built background canvas."""
    from imagestitching.core import geometry
    from imagestitching.core.grid import plan_grid

    fails = 0
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n = int(rng.integers(1, 10))
            items, disp = [], []
            for _ in range(n):
                h = int(rng.integers(8, 220))
                w = int(rng.integers(8, 180))
                if rng.random() < 0.1:              # grayscale input
                    g = rng.integers(0, 256, (h, w), np.uint8)
                    items.append(g)
                    disp.append(np.repeat(g[:, :, None], 3, axis=2))
                    continue
                a = rng.integers(0, 256, (h, w, 3), np.uint8)
                if rng.random() < 0.2:              # EXIF-tagged input
                    orient = int(rng.integers(2, 9))
                    # feed a raw whose display form is ``a``
                    for g8 in range(1, 9):
                        cand = geometry.orient_array(a, g8)
                        if (geometry.orient_array(cand, orient).shape
                                == a.shape
                                and np.array_equal(
                                    geometry.orient_array(cand, orient),
                                    a)):
                            items.append((np.ascontiguousarray(cand),
                                          orient))
                            break
                    else:
                        items.append(a)
                else:
                    items.append(a)
                disp.append(a)
            cols = int(rng.integers(1, 6))
            order = str(rng.choice(["balance", "preserve"]))
            valign = str(rng.choice(["top", "center"]))
            options = StitchOptions(
                mode=str(rng.choice(["min", "max", "original"])),
                gap=_rand_gap(rng, 9),
                filter=str(rng.choice(["bilinear", "triangle",
                                       "lanczos3"])),
                background=tuple(int(x) for x in rng.integers(0, 256, 3)),
                max_images=None)
            roll = rng.random()
            if roll < 0.25:
                limits = ist.CanvasLimits(max_side=int(rng.integers(100, 500)))
            elif roll < 0.4:
                # pixel cap too: the r4s7 overshoot bug lived exactly in the
                # rounding gap between the cap check and the assembled size
                limits = ist.CanvasLimits(
                    max_side=int(rng.integers(100, 500)),
                    max_pixels=int(rng.integers(5_000, 150_000)))
            else:
                limits = None
            engine = str(rng.choice(["auto", "auto", "xla"]))
            got = api.stitch_grid(items, cols=cols, options=options,
                                  config=RuntimeConfig(engine=engine),
                                  limits=limits, order=order, valign=valign)
            if limits is not None:
                assert max(got.shape[:2]) <= limits.max_side, got.shape
                assert got.shape[0] * got.shape[1] <= limits.max_pixels, \
                    got.shape

            specs = [ImageSpec(a.shape[1], a.shape[0]) for a in disp]
            gplan = plan_grid(specs, cols, options, limits, order)
            want = _assemble_grid_oracle(gplan, disp, valign)
            assert got.shape == want.shape, (got.shape, want.shape)
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            assert diff <= 1, f"diff={diff}"
            if seed % 25 == 0:
                print(f"seed {base + seed}: ok (n={n}, cols={gplan.cols}, "
                      f"{order}/{valign}, mode={options.mode}, "
                      f"canvas={gplan.canvas_w}x{gplan.canvas_h}, "
                      f"sd={gplan.scale_down:.3f})", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
    print(f"done: {n_cases - fails}/{n_cases} grid cases, "
          f"{fails} failures", flush=True)
    return fails


def run_layout(n_cases: int, base: int = 220_000) -> int:
    """Independent-referee layout fuzz (VERDICT r4 #1): ``core/layout.solve``
    vs the SEALED reference transliteration (benchmarks/layout_referee.py —
    written from index.js:1251-1386,1526-1554 with no imports from the
    package, so no bug can be shared by construction).  Every other soak
    mode checks engines against ``oracle.stitch(plan)``, but the plan itself
    comes from ``solve`` — this mode is the only referee for the plan.

    Exact-equality contract: out size, scale_down, supersample factor and
    every fractional placement rect must match BIT-EXACT (both sides are
    float64 in the reference's operation order — any mismatch is a real
    transcription divergence, the class the left-assoc grouping fix came
    from).  Canvas size matches exactly except on the index.js:1379 guard
    break edge, where the documented deviation (PARITY.md #8) is asserted
    instead: repo canvas == target, reference canvas > max_pixels.

    A third of cases steer the pixel-headroom ratio into (1.005, 1.06) to
    saturate the guard-loop/deviation window random dims almost never hit.
    Pure host math — no JAX, thousands of cases per minute."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from layout_referee import display_dims, referee_layout
    fails = 0
    for seed in range(n_cases):
        rng = np.random.default_rng(base + seed)
        try:
            n = int(rng.integers(1, 13))
            dim_kind = rng.random()
            specs = []
            for _ in range(n):
                if dim_kind < 0.15:          # degenerate sides
                    w = int(rng.choice([1, 1, 2, 3]))
                    h = int(rng.integers(1, 50))
                elif dim_kind < 0.3:         # huge (cap-triggering)
                    w = int(rng.integers(2_000, 20_000))
                    h = int(rng.integers(2_000, 20_000))
                else:                        # ordinary
                    w = int(rng.integers(1, 4_000))
                    h = int(rng.integers(1, 4_000))
                if rng.random() < 0.5:
                    w, h = h, w
                specs.append(ImageSpec(w, h, int(rng.integers(1, 9))))
            direction = str(rng.choice(["vertical", "horizontal"]))
            mode = str(rng.choice(["min", "max", "original"]))
            gap = _rand_gap(rng, 40)
            if rng.random() < 0.1:
                gap = float(rng.integers(0, 500))   # beyond the UI clamp
            max_ss = float(rng.choice([1.0, 1.3, 2.2, 2.6, 4.0]))
            dims = [display_dims(s.raw_w, s.raw_h, s.orientation)
                    for s in specs]

            cap_kind = rng.random()
            if cap_kind < 0.34:
                # targeted guard-window slice: place the headroom ratio
                # sqrt(max_pixels/base) in/around (1.01, 1.042) where the
                # guard loop and the deviation edge live.  Derive the
                # uncapped target first so scale_down stays 1.
                free = referee_layout(
                    dims, direction, mode, gap,
                    max_side=1 << 30, max_pixels=1 << 60,
                    max_supersample=1.0, supersample_enabled=False)
                tw, th = free["out_w"], free["out_h"]
                if tw * th > 200_000_000:
                    limits = ist.CanvasLimits()   # too big to steer; generic
                else:
                    ratio = 1.005 + rng.random() * 0.055
                    mp = int(tw * th * ratio * ratio) + int(
                        rng.integers(-1, 2))
                    limits = ist.CanvasLimits(
                        max_side=1 << 20, max_pixels=max(1, mp),
                        max_supersample=max_ss)
            elif cap_kind < 0.67:
                limits = ist.CanvasLimits(
                    max_side=int(rng.integers(32, 16_384)),
                    max_pixels=int(rng.integers(1_024, 16_000_000)),
                    max_supersample=max_ss)
            else:
                preset = rng.random()
                if preset < 0.4:
                    limits = ist.CanvasLimits.reference_ios()
                elif preset < 0.8:
                    limits = ist.CanvasLimits.reference_android()
                else:
                    limits = ist.CanvasLimits(max_supersample=max_ss)

            ss_on = bool(rng.random() < (0.7 if cap_kind < 0.34 else 0.3))
            options = StitchOptions(direction=direction, mode=mode, gap=gap,
                                    supersample=ss_on, max_images=None)
            plan = solve(specs, options, limits=limits)
            ref = referee_layout(
                dims, direction, mode, gap,
                max_side=limits.max_side, max_pixels=limits.max_pixels,
                max_supersample=limits.max_supersample,
                supersample_enabled=ss_on)

            assert plan.out_w == ref["out_w"], (plan.out_w, ref["out_w"])
            assert plan.out_h == ref["out_h"], (plan.out_h, ref["out_h"])
            assert plan.scale_down == ref["scale_down"], \
                (plan.scale_down, ref["scale_down"])
            assert plan.supersample == ref["super_sample"], \
                (plan.supersample, ref["super_sample"])
            if ref["guard_reset"]:
                # PARITY.md deviation #8: reference leaves an over-cap
                # canvas; repo resets to the target size.
                assert ref["canvas_w"] * ref["canvas_h"] \
                    > limits.max_pixels, ref
                assert (plan.canvas_w, plan.canvas_h) \
                    == (plan.out_w, plan.out_h), plan
            else:
                assert (plan.canvas_w, plan.canvas_h) \
                    == (ref["canvas_w"], ref["canvas_h"]), \
                    ((plan.canvas_w, plan.canvas_h),
                     (ref["canvas_w"], ref["canvas_h"]))
            assert len(plan.placements) == len(ref["phys_rects"])
            for p, (dx, dy, dw, dh) in zip(plan.placements,
                                           ref["phys_rects"]):
                assert (p.x0, p.y0, p.w, p.h) == (dx, dy, dw, dh), \
                    (p.index, (p.x0, p.y0, p.w, p.h), (dx, dy, dw, dh))
            if seed % 200 == 0:
                print(f"seed {base + seed}: ok (n={n}, {direction}/{mode}, "
                      f"gap={gap:.2f}, ss={plan.supersample:.3f}, "
                      f"canvas={plan.canvas_w}x{plan.canvas_h}"
                      f"{' [guard-reset]' if ref['guard_reset'] else ''})",
                      flush=True)
        except Exception:
            fails += 1
            print(f"FAIL seed={base + seed}", flush=True)
            traceback.print_exc()
    print(f"done: {n_cases - fails}/{n_cases} layout cases, "
          f"{fails} failures", flush=True)
    return fails


def _fresh_base() -> int:
    """Fresh-base discipline (CLAUDE.md): a bare invocation must not
    silently re-burn an already-ledgered seed range, so when SEED_BASE
    isn't given, default to a time-derived base in the reserved >=1M band
    (ledgered manual bases live below 1M).  The printed base reproduces
    the run."""
    import time
    base = 1_000_000 + int(time.time()) % 8_000_000
    print(f"SEED_BASE not given — using fresh base {base} "
          f"(pass N BASE to reproduce)", flush=True)
    return base


if __name__ == "__main__":
    argv = sys.argv[1:]
    _MODES = {"--export": (run_export, 150), "--preview": (run_preview, 200),
              "--http": (run_http, 40),
              "--cli": (run_cli, 150), "--serve": (run_serve, 100),
              "--formats": (run_formats, 200), "--large": (run_large, 200),
              "--merge": (run_merge, 200), "--grid": (run_grid, 200),
              "--stress": (run_stress, 60), "--layout": (run_layout, 2000)}
    if argv and argv[0].startswith("--") and argv[0] not in _MODES:
        print(f"unknown mode {argv[0]}; usage: soak.py "
              f"[{'|'.join(sorted(_MODES))}] [N] [SEED_BASE]",
              file=sys.stderr)
        sys.exit(2)
    if argv and argv[0] in _MODES:
        fn, default_n = _MODES[argv[0]]
        n = int(argv[1]) if len(argv) > 1 else default_n
        base = int(argv[2]) if len(argv) > 2 else _fresh_base()
        sys.exit(1 if fn(n, base) else 0)
    n = int(argv[0]) if argv else 200
    base = int(argv[1]) if len(argv) > 1 else _fresh_base()
    sys.exit(1 if run(n, base) else 0)
