"""XLA compositing engine: orient -> separable resize -> place, all under jit.

This is the plain-XLA reference path of the device compute core (SURVEY.md
§7(4c)) — the device replacement for the reference's per-image
``drawWithOrientation`` calls into the platform canvas
(pages/index/index.js:1526-1554, utils/canvas.js:153-202):

* EXIF orientation  -> static flips/transpose (index permutations, free-ish
  under XLA fusion).
* Bilinear resize   -> exact 2-tap separable gather: tap indices/weights are
  computed host-side by :mod:`..core.geometry` (the same math the NumPy
  oracle uses) and shipped as tiny jit ARGUMENTS, so plans that differ only
  in fractional offsets share one compiled program (keyed on
  plan.shape_signature via _program_cache) while each CompiledStitch binds
  its own plan's weights (keyed on the full plan.signature — the two-tier
  keying is the fix for the r4 stale-weights collision; see
  LayoutPlan.signature).
* General filters   -> K-tap gathers with K > 2 (triangle/box/lanczos3 AA).
* Placement         -> ``lax.dynamic_update_slice`` at static offsets into the
  background-filled canvas (the ``fillRect`` analog, index.js:1423-1424).

This is the one device engine on every backend: XLA fuses the gather, the
lerp and the quantize.  It must match the oracle within 1 uint8 step (f32
vs f64 accumulation).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..core import geometry
from ..core.layout import LayoutPlan, Placement


# ---------------------------------------------------------------------------
# Orientation as static index permutation (jnp twin of geometry.orient_array)
# ---------------------------------------------------------------------------

def orient_jnp(img: jnp.ndarray, orientation: int) -> jnp.ndarray:
    if orientation in (0, 1):
        return img
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1, :]
    axes = (1, 0) + tuple(range(2, img.ndim))
    t = jnp.transpose(img, axes)
    if orientation == 5:
        return t
    if orientation == 6:
        return t[:, ::-1]
    if orientation == 7:
        return t[::-1, ::-1]
    if orientation == 8:
        return t[::-1, :]
    raise ValueError(f"invalid EXIF orientation {orientation}")


# ---------------------------------------------------------------------------
# Host-side tap/matrix preparation (one small pytree per placement)
# ---------------------------------------------------------------------------

def _axis_params(lo: int, hi: int, a: float, length: float, m: int,
                 kind: str):
    """Per-axis K-tap resample params (bilinear is K=2).

    Same ``filter_taps`` windows as the streamed and banded executables —
    every strategy computes weights identically, so
    strategy choice never changes the output bits.
    """
    i0, w = geometry.filter_taps(lo, hi, a, length, m, kind)
    return {"i0": i0, "w": w.astype(np.float32)}


def placement_params(p: Placement, kind: str) -> dict:
    """All device-shippable resample params for one placement."""
    disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    return {
        "rows": _axis_params(r0, r1, p.y0, p.h, disp_h, kind),
        "cols": _axis_params(c0, c1, p.x0, p.w, disp_w, kind),
    }


# ---------------------------------------------------------------------------
# Device-side resample + composite
# ---------------------------------------------------------------------------

def ktap_axis(img: jnp.ndarray, i0, w, axis: int) -> jnp.ndarray:
    """K-tap separable resample along ``axis`` via gathers (the one shared
    gather-engine primitive; out-of-range taps carry zero weight, so clipped
    indices are harmless).  ``i0 (n,) int32`` window starts, ``w (n, K)``."""
    m = img.shape[axis]
    i0 = jnp.asarray(i0)
    acc = None
    for k in range(w.shape[1]):
        shape = [1] * img.ndim
        shape[axis] = w.shape[0]
        term = jnp.take(img, jnp.clip(i0 + k, 0, m - 1),
                        axis=axis) * jnp.asarray(w[:, k]).reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def _ktap(img: jnp.ndarray, prm: dict, axis: int) -> jnp.ndarray:
    return ktap_axis(img, prm["i0"], prm["w"], axis)


def _resample_axis0(img: jnp.ndarray, prm: dict) -> jnp.ndarray:
    return _ktap(img, prm, 0)


def _resample_axis1(img: jnp.ndarray, prm: dict) -> jnp.ndarray:
    return _ktap(img, prm, 1)


def to_uint8(x: jnp.ndarray) -> jnp.ndarray:
    """Framework-wide float->uint8 contract (oracle.to_uint8 twin)."""
    return jnp.clip(jnp.floor(x + 0.5), 0.0, 255.0).astype(jnp.uint8)


def _stitch_impl(plan: LayoutPlan, channels: int, images: Sequence[jnp.ndarray],
                 params: Sequence[dict]) -> jnp.ndarray:
    from .assemble import assemble_canvas

    regions = {}
    for idx, (raw, p, prm) in enumerate(zip(images, plan.placements, params)):
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if r1 <= r0 or c1 <= c0:
            continue
        img = orient_jnp(raw, p.orientation).astype(jnp.float32)
        img = _resample_axis0(img, prm["rows"])
        img = _resample_axis1(img, prm["cols"])
        regions[idx] = to_uint8(img)
    return assemble_canvas(plan, channels, regions)


class CompiledStitch:
    """One jit-compiled stitch executable for a fixed layout signature.

    The analog of the reference's per-job canvas setup (index.js:1388-1428),
    except compiled once and reused for every job with the same signature —
    the serving layer buckets jobs by ``plan.signature()`` to exploit this.
    """

    def __init__(self, plan: LayoutPlan, channels: int = 3):
        from ..runtime.jaxcfg import ensure_compile_cache
        ensure_compile_cache()
        self.plan = plan
        self.channels = channels
        self.params = [placement_params(p, plan.filter)
                       for p in plan.placements]
        # The jitted PROGRAM is shared per shape_signature: taps are runtime
        # args, so plans differing only in fractional offsets (same spans,
        # shifted sub-pixel phase) reuse one compile — each CompiledStitch
        # instance binds its OWN plan's params to the shared program.
        self._jitted = _program_cache(_ShapeKey(plan), channels)

    def __call__(self, images: Sequence[np.ndarray],
                 device: bool = False) -> np.ndarray:
        """Run the job; ``device=True`` returns the canvas as a jax.Array
        without the final device->host readback (streaming export path)."""
        if len(images) != len(self.plan.placements):
            raise ValueError("image count does not match plan")
        dev_images: List[jnp.ndarray] = []
        for arr, p in zip(images, self.plan.placements):
            arr = np.asarray(arr)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.shape[:2] != (p.raw_h, p.raw_w):
                raise ValueError(
                    f"image {p.index}: got {arr.shape[1]}x{arr.shape[0]}, "
                    f"plan says {p.raw_w}x{p.raw_h}")
            if arr.shape[2] != self.channels:
                raise ValueError(
                    f"image {p.index}: {arr.shape[2]} channels, "
                    f"expected {self.channels}")
            dev_images.append(jnp.asarray(arr))
        out = self._jitted(dev_images, self.params)
        return out if device else np.asarray(out)


@functools.lru_cache(maxsize=64)
def _compiled_cache(plan_key: "_PlanKey", channels: int) -> CompiledStitch:
    return CompiledStitch(plan_key.plan, channels)


@functools.lru_cache(maxsize=64)
def _program_cache(shape_key: "_ShapeKey", channels: int):
    """One jitted program per shape_signature.  Closing over the
    representative plan is safe: the trace reads only fields the
    shape_signature pins (spans, raw dims, orientation, canvas dims,
    background, filter) — weights arrive as arguments."""
    plan = shape_key.plan

    def fn(images, params):
        return _stitch_impl(plan, channels, images, params)

    return jax.jit(fn)


class _PlanKey:
    """Hash/eq by full signature so lru_cache can key on the plan."""

    __slots__ = ("plan", "_sig")

    def __init__(self, plan: LayoutPlan):
        self.plan = plan
        self._sig = plan.signature()

    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, _PlanKey) and self._sig == other._sig


class _ShapeKey:
    """Hash/eq by shape_signature (the traced-program key)."""

    __slots__ = ("plan", "_sig")

    def __init__(self, plan: LayoutPlan):
        self.plan = plan
        self._sig = plan.shape_signature()

    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, _ShapeKey) and self._sig == other._sig


def get_compiled(plan: LayoutPlan, channels: int = 3) -> CompiledStitch:
    """Fetch (or build) the compiled executable for this layout signature."""
    return _compiled_cache(_PlanKey(plan), channels)


def stitch(plan: LayoutPlan, images: Sequence[np.ndarray],
           device: bool = False) -> np.ndarray:
    """One-shot convenience: compile (cached) and run."""
    channels = 3
    if images and np.asarray(images[0]).ndim == 3:
        channels = np.asarray(images[0]).shape[2]
    elif images and np.asarray(images[0]).ndim == 2:
        channels = 1
    return get_compiled(plan, channels)(images, device=device)
