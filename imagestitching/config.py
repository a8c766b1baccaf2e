"""Typed configuration for the stitching framework.

The reference app (Iamctb/ImageStitching) keeps its configuration as
compile-time constants at the top of ``pages/index/index.js:4-11`` plus
per-platform branches on ``getSystemInfoSync().platform`` scattered through the
code (``index.js:130-137,1325-1336,1363``).  Here the same knobs become typed,
immutable dataclasses with hardware-profile defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Directions and modes mirror the reference's user-facing settings
# (index.js:17-20, the settings modal index.js:791-885).
DIRECTIONS = ("vertical", "horizontal")
MODES = ("min", "max", "original")

# Supported input formats (reference whitelist at index.js:4; HEIC/HEIF are
# handled by a transcode fallback, canvas.js:255-267).
SUPPORTED_TYPES = ("jpg", "jpeg", "png", "webp", "bmp", "gif")

# "auto": host memcpy assembly for pure-blit jobs, else the XLA gather
# engine; "xla": always the device engine; "oracle": the float64 reference
# (runtime.pipeline.choose_engine makes the one decision).
ENGINES = ("auto", "xla", "oracle")


@dataclasses.dataclass(frozen=True)
class CanvasLimits:
    """Output-canvas size governor.

    Analog of the reference's device canvas caps (``index.js:1323-1357``): a
    max side length, a max total pixel count and a supersampling ceiling.
    Here they bound device memory of the output buffer rather than a phone
    canvas limit; they are configurable rather than probed.
    """

    max_side: int = 65536
    max_pixels: int = 1 << 30          # ~1 Gpx default; effectively "unlimited"
    max_supersample: float = 2.2       # reference: 2.2 iOS / 2.6 android (index.js:1363)

    @staticmethod
    def reference_ios() -> "CanvasLimits":
        # index.js:1325-1329 — side 12288, pixel cap 16384*1400
        return CanvasLimits(max_side=12288, max_pixels=16384 * 1400,
                            max_supersample=2.2)

    @staticmethod
    def reference_android(max_side: int = 4096) -> "CanvasLimits":
        # index.js:1325,1330-1332 — side 4096, pixel cap side*min(side,8192)
        return CanvasLimits(max_side=max_side,
                            max_pixels=max_side * min(max_side, 8192),
                            max_supersample=2.6)


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Device-memory budget governor (replaces reference pixel caps +
    big-task mode).

    ``hbm_bytes`` bounds the device working set of one stitch job: output
    canvas + staged source(s) + intermediates.  The tiler
    (:mod:`imagestitching.runtime.tiler`) picks a streaming/banding plan so
    peak device memory stays under this bound — the answer to the reference's
    ``scaleDown`` clamping (index.js:1323-1357) and big-task serial flushes
    (index.js:1560-1571): never shrink the user's output, just tile it.
    """

    hbm_bytes: int = 2 * (1 << 30)     # BASELINE config 4: 2 GB
    host_cache_pixels: int = 64 * 1_000_000  # bitmap-cache analog (index.js:6-7)
    host_cache_entries: int = 6              # (index.js:8-9)
    # Disk prepared-artifact store (the saveFile + storage-quota governor
    # analog, index.js:629-676): decode results persisted across processes,
    # LRU-evicted to this byte quota.  None disables persistence.
    artifact_dir: Optional[str] = None
    artifact_quota_bytes: int = 512 << 20

    @staticmethod
    def from_device(fraction: float = 0.6) -> "MemoryBudget":
        """Budget a fraction of the device memory the allocator may use.

        The reference *probes* device limits by trial-allocating canvases
        and caches the answer (index.js:345-448); here the runtime just
        knows: ``memory_stats()["bytes_limit"]`` of the default device.
        Falls back to the 2 GB default where the backend reports no
        allocator stats (the CPU backend).
        """
        import jax
        stats = jax.devices()[0].memory_stats() or {}
        total = stats.get("bytes_limit")
        if not total:
            return MemoryBudget()
        return MemoryBudget(hbm_bytes=int(total * fraction))


@dataclasses.dataclass(frozen=True)
class StitchOptions:
    """User-facing stitch parameters (reference: direction/mode/gap,
    index.js:17-20,824-832; gap clamped to [0, 20] at index.js:824-832)."""

    direction: str = "vertical"
    mode: str = "min"
    gap: float = 0.0
    # The reference supersamples by default for phone-display sharpness
    # (index.js:1360-1386); as a framework default that 2.2x output-size
    # surprise is wrong, so it is opt-in here (parity mode: pass True).
    supersample: bool = False
    background: Tuple[int, int, int] = (255, 255, 255)  # white fill (index.js:1423-1424)
    filter: str = "bilinear"           # "bilinear" | "triangle" | "box" | "lanczos3"
    max_images: Optional[int] = 9      # MAX_IMAGES (index.js:311); None = unlimited
    # Auto-overlap merge (framework extension — the reference concatenates
    # verbatim and users hand-trim overlapping screenshots): detect the
    # duplicated strip between consecutive images along the stitch axis and
    # trim it before layout (ops/overlap.py).  merge_threshold is the max
    # mean-abs-diff (uint8 levels) for an overlap to count as a duplicate
    # (2.0 tolerates JPEG recompression; 0.0 = exact only).
    merge_overlap: bool = False
    merge_threshold: float = 2.0

    def validate(self) -> "StitchOptions":
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, got {self.direction!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.gap < 0:
            raise ValueError(f"gap must be >= 0, got {self.gap}")
        if self.filter not in ("bilinear", "triangle", "box", "lanczos3"):
            raise ValueError(f"unknown filter {self.filter!r}")
        if self.merge_threshold < 0:
            raise ValueError(f"merge_threshold must be >= 0, "
                             f"got {self.merge_threshold}")
        # Normalize background to a hashable (int, int, int): it flows into
        # plan.signature(), which every compiled-program cache hashes — a
        # list/ndarray background must not blow up there (and must compare
        # equal to its tuple twin so equal jobs share one compile).
        try:
            bg = tuple(int(v) for v in self.background)
        except (TypeError, ValueError):
            raise ValueError(f"background must be an RGB triple, "
                             f"got {self.background!r}")
        if len(bg) != 3 or any(not (0 <= v <= 255) for v in bg):
            raise ValueError(f"background must be three ints in [0, 255], "
                             f"got {self.background!r}")
        if bg != self.background:
            return dataclasses.replace(self, background=bg)
        return self


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine/runtime knobs."""

    engine: str = "auto"               # "auto" | "xla" | "oracle"
    # Default canvas caps for every entry point that doesn't pass an
    # explicit ``limits=`` argument (the explicit argument wins).
    limits: CanvasLimits = dataclasses.field(default_factory=CanvasLimits)
    budget: MemoryBudget = dataclasses.field(default_factory=MemoryBudget)
    profile: bool = False              # enable jax.profiler traces per phase
    decode_threads: int = 8            # host codec pool (replaces serial decode,
                                       # index.js:1125-1157, with true parallelism)
    # Per-image decode watchdog (the reference's per-attempt load timeout,
    # utils/canvas.js:68-81; 3-9 s on phones, index.js:1437): a decode still
    # running after this many seconds is isolated as a TimeoutError for that
    # image.  None disables the watchdog.
    decode_timeout_s: Optional[float] = 30.0
    # Ack-window backpressure for the host-blit paths: max decoded sources
    # in flight or held-unconsumed at once (the parallel-pool analog of the
    # reference's serialized ingest, index.js:1125-1157).  None -> auto
    # (2x effective decode workers, floor 4; runtime/decoding.default_window).
    decode_window: Optional[int] = None
    # decode||H2D||compute overlap: "auto" enables it for big jobs (the
    # reference's big-task thresholds: >=7 images or >=25 MB total,
    # index.js:1211-1212), "always"/"never" force it.
    overlap: str = "auto"
    # Optional jax.sharding.Mesh: a "space" axis >1 shards a single job's
    # canvas row-bands across chips (parallel.sharding.ShardedStitch); the
    # serving layer uses the "jobs" axis for batch data-parallelism.
    mesh: Optional[object] = None

    def validate(self) -> "RuntimeConfig":
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.overlap not in ("auto", "always", "never"):
            raise ValueError(f"overlap must be auto/always/never, "
                             f"got {self.overlap!r}")
        if self.decode_timeout_s is not None and self.decode_timeout_s <= 0:
            raise ValueError("decode_timeout_s must be positive or None, "
                             f"got {self.decode_timeout_s}")
        if self.decode_window is not None and self.decode_window < 1:
            raise ValueError("decode_window must be >= 1 or None, "
                             f"got {self.decode_window}")
        return self
