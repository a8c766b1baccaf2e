"""Frozen golden regression: semantics must never drift across rounds.

The golden output was produced by the float64 oracle at freeze time
(tests/data/golden_v1.npz). Oracle must reproduce it bit-exactly; device
engines within 1 step. If an intentional semantics change ever requires
regenerating this file, say so loudly in the commit message.
"""

import os

import numpy as np

from imagestitching.config import RuntimeConfig, StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.runtime import pipeline

_DATA = os.path.join(os.path.dirname(__file__), "data", "golden_v1.npz")
_SHAPES = [(40, 30, 1), (24, 36, 6), (32, 32, 3), (28, 44, 8)]
_OPTS = dict(direction="horizontal", mode="min", gap=3.5, supersample=False,
             background=(250, 128, 7))


def _load():
    z = np.load(_DATA)
    imgs = [z[f"img{i}"] for i in range(len(_SHAPES))]
    return imgs, z["out"]


def test_oracle_reproduces_golden_bitexact():
    imgs, want = _load()
    plan = solve([ImageSpec(w, h, o) for (w, h, o) in _SHAPES],
                 StitchOptions(**_OPTS))
    out = oracle.stitch(plan, imgs)
    np.testing.assert_array_equal(out, want)


def test_engines_reproduce_golden_within_one():
    imgs, want = _load()
    plan = solve([ImageSpec(w, h, o) for (w, h, o) in _SHAPES],
                 StitchOptions(**_OPTS))
    for engine in ("xla", "auto"):
        out, _ = pipeline.run(plan, imgs, RuntimeConfig(engine=engine))
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1, engine
