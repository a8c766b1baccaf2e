"""imagestitching — an accelerator image stitching framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
WeChat mini-program Iamctb/ImageStitching ("优雅拼图"): EXIF-aware decode,
bilinear resize to a common edge, and vertical/horizontal concatenation with
configurable gaps into one output strip — rebuilt as a production framework:

* pure-functional layout solver with the reference's exact rounding schedule,
* a K-tap separable resample engine that XLA fuses with the placement,
* a device-memory-budget tiler replacing the app's canvas caps / big-task mode,
* host codec pool with decode→stage double-buffering,
* vmapped batch serving and mesh-sharded multi-device execution,
* a NumPy Canvas-2D golden model anchoring bit-level parity tests.
"""

from .config import (CanvasLimits, MemoryBudget, RuntimeConfig, StitchOptions,
                     DIRECTIONS, MODES, SUPPORTED_TYPES)
from .core import ImageSpec, LayoutPlan, Placement, solve

__version__ = "0.1.0"

__all__ = [
    "CanvasLimits", "MemoryBudget", "RuntimeConfig", "StitchOptions",
    "DIRECTIONS", "MODES", "SUPPORTED_TYPES",
    "ImageSpec", "LayoutPlan", "Placement", "solve",
    "stitch", "stitch_arrays", "stitch_to_file", "stitch_grid",
]


def __getattr__(name):  # lazy: keep `import imagestitching` JAX-free
    if name in ("stitch", "stitch_arrays", "stitch_to_file", "stitch_grid",
                "make_preview", "preview_size", "prepare"):
        from . import api
        return getattr(api, name)
    if name == "StitchServer":
        from .serve.server import StitchServer
        return StitchServer
    if name == "StitchHTTPServer":
        from .serve.http import StitchHTTPServer
        return StitchHTTPServer
    if name == "ArtifactStore":
        from .runtime.artifacts import ArtifactStore
        return ArtifactStore
    if name == "StitchMetrics":
        from .runtime.pipeline import StitchMetrics
        return StitchMetrics
    raise AttributeError(name)
