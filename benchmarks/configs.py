"""The BASELINE.md job geometries, shared by the benchmark scripts and
``chip_smoke.py`` (one definition each).

Shapes are ``(width, height, exif_orientation)`` per image.
"""

from __future__ import annotations

from imagestitching.config import StitchOptions

# config 1: 2-image vertical concat, 512x512
CONFIG1 = ([(512, 512, 1)] * 2, StitchOptions(mode="min", supersample=False))

# config 2: 9-image vertical strip at 1080p
CONFIG2 = ([(1920, 1080, 1)] * 9,
           StitchOptions(mode="min", supersample=False, max_images=None))

# config 3: 9-image horizontal, mixed aspect + EXIF rotations
CONFIG3 = ([(1920, 1080, 1), (1080, 1920, 6), (1440, 1080, 3),
            (1280, 960, 8), (2000, 1500, 1), (1080, 1080, 5),
            (1600, 1200, 2), (1200, 1600, 7), (1920, 1440, 4)],
           StitchOptions(direction="horizontal", mode="min", gap=4,
                         supersample=False, max_images=None))

# config 4: 9x 12 MP vertical/min (a pure-blit plan: equal sizes)
CONFIG4 = ([(4000, 3000, 1)] * 9,
           StitchOptions(mode="min", supersample=False, max_images=None))

# config 5: the per-job geometry of 64 concurrent 9-image served jobs
CONFIG5_BATCH = 64
CONFIG5 = ([(1920, 1080, 1)] * 5 + [(1280, 720, 1), (1600, 900, 1),
                                    (1920, 1200, 1), (1024, 768, 1)],
           StitchOptions(mode="min", gap=4, supersample=False,
                         max_images=None))

# mixed-size ~12 MP job (bench.py's resize-heavy and e2e-resample variant):
# every placement resamples
MIXED_12MP = ([(4000, 3000, 1), (3600, 2700, 1), (3200, 2400, 1),
               (2800, 2100, 1), (4000, 2250, 1), (3000, 3000, 1),
               (3840, 2160, 1), (2400, 3200, 1), (3500, 2625, 1)],
              StitchOptions(mode="min", supersample=False, max_images=None))


def specs_of(shapes):
    from imagestitching.core.layout import ImageSpec
    return [ImageSpec(w, h, o) for (w, h, o) in shapes]
