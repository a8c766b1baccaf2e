"""SEALED second-source transliteration of the reference's layout math.

This module is the independent referee for ``core/layout.solve`` (VERDICT r4
missing #2): a from-scratch, line-faithful transcription of the reference's
output-geometry + draw-loop blocks, written directly from the JS source and
importing NOTHING from ``imagestitching`` so no bug can be shared by
construction.  The soak's ``--layout`` mode fuzzes ``solve()`` against it
across directions x modes x gaps x caps x supersample x degenerate dims.

Transliterated blocks (reference = /root/reference/miniprogram-stitch/
miniprogram/pages/index/index.js):

* out-size accumulation   index.js:1251-1315  (reduce with the JS grouping
  ``(sum + draw) + gap`` — left-to-right, NOT ``sum + (draw + gap)``)
* final round             index.js:1317-1319  ``Math.max(1, Math.round(.))``
* canvas caps             index.js:1337-1357  side cap, sqrt pixel cap,
  floor-applied when < 1
* supersample + guard     index.js:1360-1386  including the exact break-edge
  semantics at index.js:1379: when ``superSample *= 0.96`` falls below 1 the
  reference breaks WITHOUT recomputing canvasOutW/H, leaving the canvas at
  its previous (over-cap) value.  The repo deliberately deviates there
  (PARITY.md deviation #8): it resets the canvas to target_w x target_h.
  The referee reports the reference-exact value plus a ``guard_reset`` flag
  so the comparator can assert the documented deviation and nothing else.
* draw loop               index.js:1432-1554  float cursor, rounded dest
  sizes, floor centering, ``ctx.scale(superSample)`` transform

Pure float64 Python (= JS doubles); deterministic; no third-party imports.
"""

from __future__ import annotations

import math


def _math_round(x: float) -> int:
    """JS ``Math.round``: half-up on the EXACT value (ES spec semantics).

    Deliberately a different derivation from core.layout._js_round (which
    tests the exact fractional part): doubling is exact for doubles, so
    ``floor(2x)`` parity decides the tie side without ever forming
    ``x + 0.5`` — the naive ``floor(x + 0.5)`` rounds the 1-ULP-below-half
    doubles (e.g. 0.49999999999999994) UP where every real JS engine
    returns the lower integer, and a shared naive formula on both sides
    would have hidden exactly that divergence class from the fuzz."""
    return (math.floor(2.0 * x) + 1) // 2


def referee_layout(nat_dims, direction, mode, gap, *, max_side, max_pixels,
                   max_supersample, supersample_enabled):
    """Run the reference's geometry math over display ("natural") dims.

    ``nat_dims``: sequence of (naturalWidth, naturalHeight) ints (already
    orientation-corrected, the reference's probe output, index.js:1203-1247).
    Returns a dict with every intermediate the parity contract covers:

    ``out_w/out_h``       rounded + cap-shrunk logical output size
    ``scale_down``        uniform shrink factor (1.0 when uncapped)
    ``super_sample``      final supersample factor after the guard loop
    ``canvas_w/canvas_h`` physical canvas size — REFERENCE-EXACT, i.e. may
                          exceed max_pixels on the index.js:1379 break edge
    ``guard_reset``       True iff that break edge fired (superSample fell
                          below 1 inside the guard loop) — the one place the
                          repo documents a deviation (PARITY.md #8)
    ``rects``             per-image logical (dx, dy, dw, dh) floats
    ``phys_rects``        the same under the supersample transform
    """
    # --- 2) output size (index.js:1251-1315) -----------------------------
    all_w = [w for (w, h) in nat_dims if w > 0]
    all_h = [h for (w, h) in nat_dims if h > 0]
    if not all_w or not all_h:
        raise ValueError("image dims unavailable")
    gap_px = gap or 0.0

    out_w = 0.0
    out_h = 0.0
    if direction == "vertical":
        if mode == "min":
            out_w = float(min(all_w))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                iw = max(1, iw0 or 1)
                ih = max(1, ih0 or 1)
                draw_h = ih * (out_w / iw)
                s = s + draw_h + (gap_px if idx else 0.0)
            out_h = s
        elif mode == "max":
            out_w = float(max(all_w))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                iw = max(1, iw0 or 1)
                ih = max(1, ih0 or 1)
                draw_h = ih * (out_w / iw)
                s = s + draw_h + (gap_px if idx else 0.0)
            out_h = s
        else:  # 'original'
            out_w = float(max(all_w))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                ih = max(1, ih0 or 1)
                s = s + ih + (gap_px if idx else 0.0)
            out_h = s
    else:
        if mode == "min":
            out_h = float(min(all_h))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                iw = max(1, iw0 or 1)
                ih = max(1, ih0 or 1)
                draw_w = iw * (out_h / ih)
                s = s + draw_w + (gap_px if idx else 0.0)
            out_w = s
        elif mode == "max":
            out_h = float(max(all_h))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                iw = max(1, iw0 or 1)
                ih = max(1, ih0 or 1)
                draw_w = iw * (out_h / ih)
                s = s + draw_w + (gap_px if idx else 0.0)
            out_w = s
        else:  # 'original'
            out_h = float(max(all_h))
            s = 0.0
            for idx, (iw0, ih0) in enumerate(nat_dims):
                iw = max(1, iw0 or 1)
                s = s + iw + (gap_px if idx else 0.0)
            out_w = s

    # index.js:1317-1319
    out_w = max(1, _math_round(out_w))
    out_h = max(1, _math_round(out_h))
    if not out_w or not out_h:
        raise ValueError("output size computation failed")

    # --- canvas caps (index.js:1337-1357) --------------------------------
    scale_down = 1.0
    if out_w > max_side or out_h > max_side:
        scale_down = min(max_side / out_w, max_side / out_h)
    total_pixels = out_w * out_h
    if total_pixels > max_pixels:
        pixel_scale = math.sqrt(max_pixels / total_pixels)
        scale_down = min(scale_down, pixel_scale)
    if scale_down < 1:
        out_w = max(1, math.floor(out_w * scale_down))
        out_h = max(1, math.floor(out_h * scale_down))

    # --- supersample + guard loop (index.js:1360-1386) -------------------
    target_w = out_w
    target_h = out_h
    base_pixels = target_w * target_h
    max_ss = max_supersample if supersample_enabled else 1
    super_sample = 1.0
    if base_pixels > 0 and base_pixels < max_pixels:
        ratio = math.sqrt(max_pixels / base_pixels)
        if ratio > 1.01:
            side_cap = min(max_side / target_w, max_side / target_h)
            super_sample = min(max_ss, ratio, side_cap)
    if not math.isfinite(super_sample) or super_sample < 1:
        super_sample = 1.0
    canvas_out_w = max(1, _math_round(target_w * super_sample))
    canvas_out_h = max(1, _math_round(target_h * super_sample))
    guard = 0
    guard_reset = False
    while canvas_out_w * canvas_out_h > max_pixels and guard < 20:
        super_sample *= 0.96
        if super_sample < 1:
            # index.js:1379 — the reference breaks HERE without touching
            # canvasOutW/H: the canvas keeps its previous, over-cap value.
            super_sample = 1.0
            guard_reset = True
            break
        canvas_out_w = max(1, math.floor(target_w * super_sample))
        canvas_out_h = max(1, math.floor(target_h * super_sample))
        guard += 1

    # --- draw loop (index.js:1432-1554) ----------------------------------
    scaled_gap = gap_px * scale_down
    cursor_x = 0.0
    cursor_y = 0.0
    rects = []
    for (nw0, nh0) in nat_dims:
        natural_w = max(1, nw0 or 1)
        natural_h = max(1, nh0 or 1)
        if direction == "vertical":
            if mode == "original":
                dw = _math_round(natural_w * scale_down)
                dh = _math_round(natural_h * scale_down)
                dx = math.floor((out_w - dw) / 2)
                rects.append((float(dx), cursor_y, float(dw), float(dh)))
                cursor_y += dh + scaled_gap
            else:
                draw_h = _math_round(natural_h * (out_w / natural_w))
                rects.append((0.0, cursor_y, float(out_w), float(draw_h)))
                cursor_y += draw_h + scaled_gap
        else:
            if mode == "original":
                dw = _math_round(natural_w * scale_down)
                dh = _math_round(natural_h * scale_down)
                dy = math.floor((out_h - dh) / 2)
                rects.append((cursor_x, float(dy), float(dw), float(dh)))
                cursor_x += dw + scaled_gap
            else:
                draw_w = _math_round(natural_w * (out_h / natural_h))
                rects.append((cursor_x, 0.0, float(draw_w), float(out_h)))
                cursor_x += draw_w + scaled_gap

    # index.js:1426-1428: the draw happens under ctx.scale(superSample)
    # (a no-op transform when superSample === 1).
    phys_rects = [(dx * super_sample, dy * super_sample,
                   dw * super_sample, dh * super_sample)
                  for (dx, dy, dw, dh) in rects]

    return {
        "out_w": out_w, "out_h": out_h,
        "scale_down": scale_down,
        "super_sample": super_sample,
        "canvas_w": canvas_out_w, "canvas_h": canvas_out_h,
        "guard_reset": guard_reset,
        "rects": rects, "phys_rects": phys_rects,
    }


def display_dims(raw_w, raw_h, orientation):
    """EXIF display dims, independently of core/geometry: orientations 5-8
    are the transposed family (canvas.js:162-176), so width/height swap."""
    if orientation in (5, 6, 7, 8):
        return raw_h, raw_w
    return raw_w, raw_h
