"""Decode watchdog: hung decodes are isolated, never hang the job.

Reference behavior being mirrored: per-attempt load timeouts that null the
handlers and retry via another creator (utils/canvas.js:68-81), and per-image
skip-and-continue during prepare (pages/index/index.js:1133-1149).
"""

import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

import imagestitching as ist
from imagestitching import api
from imagestitching.config import RuntimeConfig
from imagestitching.runtime import decoding

rng = np.random.default_rng(21)


def make_png(path, w, h):
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def test_iter_decoded_timeout_isolates_hang():
    release = threading.Event()

    def hang():
        release.wait(30)
        return "late"

    jobs = [hang, lambda: "ok"]
    try:
        got = dict()
        for i, v, e in decoding.iter_decoded(jobs, workers=2, timeout_s=0.3):
            got[i] = (v, e)
        assert got[1] == ("ok", None)
        assert isinstance(got[0][1], TimeoutError)
    finally:
        release.set()


def test_iter_decoded_replacement_worker_drains_queue():
    release = threading.Event()

    def hang():
        release.wait(30)
        return "late"

    # 1 worker: the hang occupies it; the replacement must run job 1
    jobs = [hang, lambda: "ok"]
    try:
        got = dict()
        for i, v, e in decoding.iter_decoded(jobs, workers=1, timeout_s=0.3):
            got[i] = (v, e)
        assert got[1] == ("ok", None)
        assert isinstance(got[0][1], TimeoutError)
    finally:
        release.set()


def test_iter_decoded_no_timeout_plain():
    out = sorted(decoding.iter_decoded(
        [lambda: 1, lambda: 2], workers=4, timeout_s=None))
    assert out == [(0, 1, None), (1, 2, None)]


def test_prepare_skips_hanging_fifo(tmp_path):
    good = tmp_path / "g.png"
    want = make_png(good, 20, 20)
    fifo = tmp_path / "hang.png"          # known extension, blocking open
    os.mkfifo(fifo)
    cfg = RuntimeConfig(decode_timeout_s=0.5)
    try:
        t0 = time.monotonic()
        images, specs, failures = api.prepare([good, fifo], cfg,
                                              on_error="skip")
        assert time.monotonic() - t0 < 10
        assert len(images) == 1
        np.testing.assert_array_equal(images[0], want)
        assert len(failures) == 1 and failures[0][0] == 1
        assert isinstance(failures[0][1], TimeoutError)
    finally:
        # unblock the abandoned daemon reader so nothing lingers
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            os.close(fd)
        except OSError:
            pass  # no reader blocked anymore


def test_stitch_raises_on_hanging_fifo(tmp_path):
    good = tmp_path / "g.png"
    make_png(good, 20, 20)
    fifo = tmp_path / "hang.png"
    os.mkfifo(fifo)
    cfg = RuntimeConfig(decode_timeout_s=0.5, overlap="never")
    try:
        with pytest.raises(TimeoutError):
            ist.stitch([good, fifo], config=cfg)
    finally:
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            os.close(fd)
        except OSError:
            pass  # no reader blocked anymore


def test_prepare_raise_cancels_pool(tmp_path, monkeypatch):
    # on_error="raise" must cancel the decode pool promptly (try/finally
    # close), not abandon it to gc — an abandoned pool's daemon workers
    # keep decoding every queued image meanwhile (r4s10; the prepare twin
    # of the _stitch_blit_overlapped ADVICE r3 fix)
    good = tmp_path / "g.png"
    make_png(good, 20, 20)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    pools = []
    orig = decoding.iter_decoded

    def capture(*a, **kw):
        pool = orig(*a, **kw)
        pools.append(pool)
        return pool

    monkeypatch.setattr(decoding, "iter_decoded", capture)
    with pytest.raises(Exception):
        api.prepare([str(good), str(bad)] + [str(good)] * 6,
                    RuntimeConfig(decode_threads=1), on_error="raise")
    assert pools and pools[0]._cancelled.is_set()
