"""Disk prepared-artifact store: quota governor + eviction + fail-open
(reference saveFile/storage-quota analog, pages/index/index.js:629-676)."""

import os
import time

import numpy as np
from PIL import Image

from imagestitching import api
from imagestitching.config import MemoryBudget, RuntimeConfig
from imagestitching.runtime.artifacts import ArtifactStore

rng = np.random.default_rng(31)


def test_roundtrip(tmp_path):
    st = ArtifactStore(tmp_path / "a")
    arr = rng.integers(0, 256, (20, 30, 3), np.uint8)
    st.put("k1", arr, 6)
    got = st.get("k1")
    assert got is not None
    np.testing.assert_array_equal(got[0], arr)
    assert got[1] == 6
    assert st.get("missing") is None


def test_key_tracks_mtime(tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(b"one")
    k1 = ArtifactStore.key_for(f)
    time.sleep(0.01)
    f.write_bytes(b"two!")
    k2 = ArtifactStore.key_for(f)
    assert k1 != k2
    assert ArtifactStore.key_for(tmp_path / "nope") is None


def test_quota_evicts_oldest(tmp_path):
    arr = np.zeros((100, 100, 3), np.uint8)      # ~30 KB/entry
    st = ArtifactStore(tmp_path / "a", quota_bytes=10_000_000)
    for i in range(6):
        st.put(f"k{i}", arr, 1)
        os.utime(st._file(f"k{i}"),
                 (time.time() + i, time.time() + i))  # deterministic LRU
    st.quota, st.soft_limit = 100_000, 60_000
    st._evict_to_quota()
    assert st.total_bytes() <= 100_000
    # oldest entries went first
    assert st.get("k0") is None
    assert st.get("k5") is not None


def test_write_failure_disables_fail_open(tmp_path, monkeypatch):
    st = ArtifactStore(tmp_path / "a")
    monkeypatch.setattr(os, "replace",
                        lambda *a: (_ for _ in ()).throw(OSError("disk full")))
    st.put("k", np.zeros((4, 4, 3), np.uint8), 1)
    assert st.disabled
    # further puts/gets are silent no-ops
    st.put("k2", np.zeros((4, 4, 3), np.uint8), 1)
    assert st.get("k2") is None


def test_load_one_uses_store(tmp_path, monkeypatch):
    img = rng.integers(0, 256, (24, 36, 3), np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(img).save(p)
    cfg = RuntimeConfig(budget=MemoryBudget(
        artifact_dir=str(tmp_path / "store"),
        host_cache_pixels=0, host_cache_entries=0))  # disable RAM cache

    calls = {"n": 0}
    from imagestitching.imgio import codec
    real = codec.decode

    def counting(src, **kw):
        calls["n"] += 1
        return real(src, **kw)

    monkeypatch.setattr(codec, "decode", counting)
    a1, o1 = api._load_one(p, cfg)
    a2, o2 = api._load_one(p, cfg)
    assert calls["n"] == 1                      # second hit came from disk
    np.testing.assert_array_equal(a1, img)
    np.testing.assert_array_equal(a2, img)
    assert o1 == o2 == 1
