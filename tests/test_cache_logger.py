"""Host bitmap cache + crash-safe logger tests (reference #10, #13)."""

import json
import threading

import numpy as np
import pytest
from PIL import Image

from imagestitching.runtime.cache import BitmapCache, get_cache, set_cache
from imagestitching.runtime.logger import StitchLogger

rng = np.random.default_rng(17)


def img(px):
    side = int(px ** 0.5)
    return rng.integers(0, 256, (side, side, 3), np.uint8)


# --------------------------------------------------------------------- cache

def test_cache_hit_and_lru_eviction():
    c = BitmapCache(max_pixels=100 * 100 * 2 + 50, max_entries=10)
    a, b, d = img(100 * 100), img(100 * 100), img(100 * 100)
    c.put(("a",), a, 1)
    c.put(("b",), b, 6)
    assert c.get(("a",))[1] == 1
    # adding a third exceeds the pixel budget; LRU victim is "b"
    c.put(("d",), d, 1)
    assert c.get(("b",)) is None
    assert c.get(("a",)) is not None and c.get(("d",)) is not None
    assert c.evictions >= 1


def test_cache_entry_cap():
    c = BitmapCache(max_pixels=10**9, max_entries=2)
    for i in range(4):
        c.put((i,), img(16), 1)
    assert c.stats()["entries"] == 2


def test_cache_rejects_oversized():
    c = BitmapCache(max_pixels=10, max_entries=5)
    c.put(("big",), img(10000), 1)
    assert c.stats()["entries"] == 0


def test_cache_file_key_changes_on_rewrite(tmp_path):
    p = tmp_path / "x.png"
    Image.fromarray(img(64)).save(p)
    k1 = BitmapCache.file_key(str(p))
    data = img(256)
    Image.fromarray(data).save(p)
    k2 = BitmapCache.file_key(str(p))
    assert k1 != k2
    assert BitmapCache.file_key(str(tmp_path / "missing.png")) is None


def test_api_uses_cache(tmp_path):
    import imagestitching as ist
    from imagestitching.config import RuntimeConfig
    set_cache(None)
    cache = get_cache()
    cache.clear()
    h0 = cache.hits
    p = tmp_path / "c.png"
    Image.fromarray(img(64)).save(p)
    cfg = RuntimeConfig(engine="oracle")
    ist.stitch([p, p], config=cfg)       # same path twice -> second is a hit
    ist.stitch([p, p], config=cfg)
    assert cache.hits > h0


def test_cache_thread_safety():
    c = BitmapCache(max_pixels=10**7, max_entries=8)

    def worker(k):
        for i in range(50):
            c.put((k, i % 4), img(100), 1)
            c.get((k, (i + 1) % 4))

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert c.stats()["entries"] <= 8


# -------------------------------------------------------------------- logger

def test_logger_ring_bounded():
    log = StitchLogger(ring_size=5)
    for i in range(20):
        log.event("t", i=i)
    ring = log.ring()
    assert len(ring) == 5 and ring[-1]["i"] == 19


def test_logger_file_sink_and_truncation(tmp_path):
    p = tmp_path / "s.log"
    log = StitchLogger(str(p))
    log.event("alpha", x=1)
    log.event("beta", y=[1, 2])
    lines = [json.loads(l) for l in p.read_text().splitlines()]
    assert lines[0]["tag"] == "alpha" and lines[1]["y"] == [1, 2]
    # oversized log is truncated at init, keeping the tail
    big = tmp_path / "big.log"
    big.write_bytes(b"x" * 400 * 1024)
    log2 = StitchLogger(str(big), max_bytes=300 * 1024)
    assert big.stat().st_size <= 200 * 1024
    log2.event("after", ok=True)
    assert b"after" in big.read_bytes()


def test_logger_survives_unwritable_path(tmp_path):
    log = StitchLogger(str(tmp_path / "nodir" / "x.log"))
    log.event("works", a=1)              # must not raise
    assert log.ring()[-1]["tag"] == "works"


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the program
    sets no other directory; unset, the cache is the fixed .jax_cache
    directory inside the checkout (never under the home directory)."""
    import os

    import jax

    from imagestitching.runtime import jaxcfg

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcfg.DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "set-by-jax")
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxcfg, "_configured", False)
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        jaxcfg.ensure_compile_cache()
        got = jax.config.jax_compilation_cache_dir
        if env_set:
            assert jaxcfg.compile_cache_dir() is None
            assert got == sentinel              # left as JAX set it
        else:
            assert jaxcfg.compile_cache_dir() == jaxcfg.DEFAULT_CACHE_DIR
            assert got == jaxcfg.DEFAULT_CACHE_DIR
            assert os.path.isdir(got)
    finally:
        monkeypatch.setattr(jaxcfg, "_configured", False)
        jax.config.update("jax_compilation_cache_dir", old)


def test_logger_once_keys_bounded():
    """once() dedup keys may carry per-signature suffixes — the set must
    be bounded in a long-lived server fed a
    stream of unique signatures (ADVICE r4 review)."""
    log = StitchLogger()
    log._once_cap = 8
    for i in range(20):
        assert log.once(f"k{i}") is True
    assert len(log._onced) == 8
    assert log.once("k19") is False      # recent keys still dedup
    assert log.once("k0") is True        # evicted key re-arms — documented
