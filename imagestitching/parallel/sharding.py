"""Sharded single-job stitching: spatial row-band parallelism.

The domain's scaling axis is output-canvas pixels (SURVEY.md §5
"long-context"): the reference *refuses* big canvases (scaleDown clamp,
pages/index/index.js:1323-1357).  Here one giant job is split across devices by
canvas **row bands** — each device composites its own band.  Because every
output pixel depends on at most 2x2 source taps, bands are independent:
sources are replicated (small next to a giant canvas) and the compute has
**zero collectives**; only the final gather of disjoint bands crosses the
device interconnect (a pure all-gather of independent data).

Implementation: ``shard_map`` over the ``space`` mesh axis.  Each shard
composites its band with its own host-exact (float64) taps, so the sharded
result is bit-identical to the single-device result — band seams cannot
drift because taps are per-output-row constants, not accumulated state.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import geometry
from ..core.layout import LayoutPlan
from ..ops import xla_compose


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


_ktap = xla_compose.ktap_axis


def _shard_taps(plan: LayoutPlan, n_shards: int, band: int) -> List[dict]:
    """Per-image stacked K-tap arrays, one row per shard.

    For shard k covering canvas rows [k*band, (k+1)*band): row tap windows
    for the intersection with each image's row span (padded to ``band``),
    column windows (shard-invariant, repeated), and the in-span mask.
    """
    out = []
    for p in plan.placements:
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        ncols = max(1, c1 - c0)
        disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                               p.orientation)
        if c1 > c0 and r1 > r0:
            ci0, cw = geometry.filter_taps(c0, c1, p.x0, p.w, disp_w,
                                           plan.filter)
            fri0, frw = geometry.filter_taps(r0, r1, p.y0, p.h, disp_h,
                                             plan.filter)
        else:
            ci0, cw = np.zeros(1, np.int32), np.zeros((1, 1))
            fri0, frw = np.zeros(1, np.int32), np.zeros((1, 1))
        k_rows = frw.shape[1]
        rows_i0 = np.zeros((n_shards, band), np.int32)
        rows_w = np.zeros((n_shards, band, k_rows), np.float32)
        rows_in = np.zeros((n_shards, band), np.float32)  # in-span mask
        for k in range(n_shards):
            lo, hi = k * band, (k + 1) * band
            br0, br1 = max(r0, lo), min(r1, hi)
            if br1 <= br0 or c1 <= c0:
                continue
            # taps placed at their band-relative positions — the device never
            # shifts rows, it just masks
            rows_i0[k, br0 - lo: br1 - lo] = fri0[br0 - r0: br1 - r0]
            rows_w[k, br0 - lo: br1 - lo] = frw[br0 - r0: br1 - r0]
            rows_in[k, br0 - lo: br1 - lo] = 1.0
        out.append({
            "rows_i0": rows_i0, "rows_w": rows_w, "rows_in": rows_in,
            "cols_i0": np.broadcast_to(ci0.astype(np.int32),
                                       (n_shards, ncols)).copy(),
            "cols_w": np.broadcast_to(cw.astype(np.float32),
                                      (n_shards,) + cw.shape).copy(),
        })
    return out


def _compose_band(plan: LayoutPlan, channels: int, band: int,
                  images, taps):
    """Runs per shard: images replicated, taps carry this shard's rows
    (already band-positioned host-side; columns land at the static offset
    c0 and out-of-span rows are masked off)."""
    bg = jnp.asarray(plan.background[:channels], jnp.float32)
    canvas = jnp.broadcast_to(bg, (band, plan.canvas_w, channels))
    for raw, p, tp in zip(images, plan.placements, taps):
        c0, c1 = p.col_span
        if c1 <= c0:
            continue
        img = xla_compose.orient_jnp(raw, p.orientation).astype(jnp.float32)
        rows = _ktap(img, tp["rows_i0"][0], tp["rows_w"][0], 0)
        full = _ktap(rows, tp["cols_i0"][0], tp["cols_w"][0], 1)
        region = jax.lax.dynamic_update_slice(
            jnp.zeros((band, plan.canvas_w, channels), jnp.float32),
            full, (0, c0, 0))
        in_rows = tp["rows_in"][0][:, None, None]
        col_ids = jax.lax.broadcasted_iota(jnp.int32,
                                           (1, plan.canvas_w, 1), 1)
        in_cols = (col_ids >= c0) & (col_ids < c1)
        mask = in_rows * in_cols.astype(jnp.float32)
        canvas = canvas * (1.0 - mask) + region * mask
    return xla_compose.to_uint8(canvas)


class ShardedStitch:
    """One job's canvas row-banded across the mesh's ``space`` axis: each
    shard composes its own band with the K-tap gather engine (shard_map)."""

    def __init__(self, plan: LayoutPlan, mesh: Mesh, channels: int = 3,
                 axis: str = "space"):
        from ..runtime.jaxcfg import ensure_compile_cache
        ensure_compile_cache()
        self.plan = plan
        self.mesh = mesh
        self.channels = channels
        n = mesh.shape[axis]
        self.n_shards = n
        self.band = _cdiv(plan.canvas_h, n)
        self.taps = _shard_taps(plan, n, self.band)

        # sources replicated, taps split by band: uploaded in these
        # shardings, so no device stages more than its own share
        self.replicated = NamedSharding(mesh, P())
        self.banded = NamedSharding(mesh, P(axis))

        n_img = len(plan.placements)
        fn = functools.partial(_compose_band, plan, channels, self.band)
        taps_spec = jax.tree_util.tree_map(lambda _: P(axis), self.taps)
        self._jitted = jax.jit(shard_map(
            fn, mesh=mesh,
            in_specs=(tuple([P()] * n_img), taps_spec),
            out_specs=P(axis),
            check_vma=False))

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        if len(images) != len(self.plan.placements):
            raise ValueError("image count does not match plan")
        arrs = []
        for arr, p in zip(images, self.plan.placements):
            arr = np.asarray(arr)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.shape[:2] != (p.raw_h, p.raw_w):
                raise ValueError(
                    f"image {p.index}: got {arr.shape[1]}x{arr.shape[0]}, "
                    f"plan says {p.raw_w}x{p.raw_h}")
            arrs.append(arr)
        out = self._jitted(jax.device_put(tuple(arrs), self.replicated),
                           jax.device_put(self.taps, self.banded))
        return np.asarray(out)[: self.plan.canvas_h]
