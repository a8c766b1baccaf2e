"""HTTP serving front end: JSON + multipart stitch, health, stats."""

import base64
import json
import urllib.request

import numpy as np
import pytest
from PIL import Image

from imagestitching.config import StitchOptions
from imagestitching.core import oracle
from imagestitching.core.layout import ImageSpec, solve
from imagestitching.imgio import codec
from imagestitching.serve.http import StitchHTTPServer

rng = np.random.default_rng(41)


@pytest.fixture(scope="module")
def srv():
    with StitchHTTPServer(port=0, max_wait_s=0.005) as s:
        yield s


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _get_json(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return json.loads(r.read())


def test_healthz_and_stats(srv):
    h = _get_json(srv, "/healthz")
    assert h["ok"] is True and h["backend"]
    st = _get_json(srv, "/stats")
    assert "server" in st and "log_tail" in st


def _png_bytes(arr):
    return codec.encode_bytes(arr, "png")


def test_stitch_json_roundtrip(srv):
    imgs = [rng.integers(0, 256, (40, 60, 3), np.uint8),
            rng.integers(0, 256, (50, 45, 3), np.uint8)]
    payload = {
        "images": [base64.b64encode(_png_bytes(a)).decode() for a in imgs],
        "direction": "vertical", "mode": "min", "gap": 4,
    }
    req = urllib.request.Request(
        _url(srv, "/stitch"), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = np.asarray(Image.open(__import__("io").BytesIO(r.read())))
    plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs],
                 StitchOptions(gap=4))
    want = oracle.stitch(plan, imgs)
    assert out.shape == want.shape
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_stitch_multipart_jpeg_out(srv):
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8)] * 2
    boundary = "xXbOuNdArYxX"
    parts = []
    for i, a in enumerate(imgs):
        parts.append(
            (f"--{boundary}\r\n"
             f'Content-Disposition: form-data; name="file{i}"; '
             f'filename="{i}.png"\r\n'
             f"Content-Type: image/png\r\n\r\n").encode()
            + _png_bytes(a) + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        _url(srv, "/stitch?direction=horizontal&format=jpg&quality=92"),
        data=body,
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "image/jpeg"
        out = np.asarray(Image.open(__import__("io").BytesIO(r.read())))
    assert out.shape == (32, 64, 3)


def test_stitch_bad_request(srv):
    req = urllib.request.Request(
        _url(srv, "/stitch"), data=b"{}",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())


def test_unknown_route(srv):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=30)
    assert ei.value.code == 404


def test_stitch_json_exif_orientation(srv):
    # EXIF orientation must be honored by the HTTP path (review finding):
    # a rotated JPEG lands upright in the strip
    arr = rng.integers(0, 256, (40, 30, 3), np.uint8)
    import io as _io
    buf = _io.BytesIO()
    img = Image.fromarray(arr)
    ex = img.getexif()
    ex[274] = 6                      # 90-degree rotation: display 40x30
    img.save(buf, "JPEG", quality=95, exif=ex)
    payload = {"images": [base64.b64encode(buf.getvalue()).decode()],
               "direction": "vertical"}
    req = urllib.request.Request(
        _url(srv, "/stitch"), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = np.asarray(Image.open(__import__("io").BytesIO(r.read())))
    assert out.shape == (30, 40, 3)  # oriented dims, not raw 40x30


def test_stitch_json_array_background(srv):
    # JSON array background (review finding: list params must survive)
    imgs = [rng.integers(0, 256, (20, 20, 3), np.uint8) for _ in range(2)]
    payload = {
        "images": [base64.b64encode(_png_bytes(a)).decode() for a in imgs],
        "background": [10, 200, 30], "gap": 4,
    }
    req = urllib.request.Request(
        _url(srv, "/stitch"), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = np.asarray(Image.open(__import__("io").BytesIO(r.read())))
    assert out.shape == (44, 20, 3)            # 20 + 4 gap + 20 rows
    np.testing.assert_array_equal(out[21, 0], [10, 200, 30])  # gap row


def test_request_size_limit():
    with StitchHTTPServer(port=0,
                          max_request_bytes=1000) as small:
        req = urllib.request.Request(
            f"http://{small.host}:{small.port}/stitch",
            data=b"x" * 2000,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 413


def test_overload_maps_to_503():
    with StitchHTTPServer(port=0, max_queue=0) as tiny:
        imgs = [rng.integers(0, 256, (8, 8, 3), np.uint8)]
        payload = {"images": [base64.b64encode(_png_bytes(a)).decode()
                              for a in imgs]}
        req = urllib.request.Request(
            f"http://{tiny.host}:{tiny.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After")


def test_overloaded_server_rejects_before_decode(monkeypatch):
    # r4s7: an overloaded server must not pay per-request decode work just
    # to reject — stitch_blobs probes capacity before touching the blobs
    from imagestitching.imgio import codec as _codec

    def boom(*a, **k):
        raise AssertionError("decode ran on a rejected request")

    with StitchHTTPServer(port=0, max_queue=0) as tiny:
        monkeypatch.setattr(_codec, "decode", boom)
        imgs = [rng.integers(0, 256, (8, 8, 3), np.uint8)]
        payload = {"images": [base64.b64encode(_png_bytes(a)).decode()
                              for a in imgs]}
        req = urllib.request.Request(
            f"http://{tiny.host}:{tiny.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503   # a 400 would mean boom() fired


def test_concurrent_mixed_requests(srv):
    """16 concurrent clients with differing geometries: every response is
    the right strip (batching buckets by plan signature; no cross-job pixel
    bleed), and the stats counters add up."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    def one(k):
        r = np.random.default_rng(500 + k)
        imgs = [r.integers(0, 256, (20 + (k % 3) * 8, 30, 3), np.uint8)
                for _ in range(2)]
        payload = {
            "images": [base64.b64encode(_png_bytes(a)).decode()
                       for a in imgs],
            "direction": "vertical", "mode": "min", "gap": k % 5,
        }
        req = urllib.request.Request(
            _url(srv, "/stitch"), data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = np.asarray(Image.open(io.BytesIO(resp.read())))
        plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs],
                     StitchOptions(gap=k % 5))
        want = oracle.stitch(plan, imgs)
        assert out.shape == want.shape, k
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1, k
        return True

    with ThreadPoolExecutor(16) as ex:
        assert all(ex.map(one, range(16)))
    st = _get_json(srv, "/stats")
    assert st["server"]["jobs"] >= 16


def test_internal_failure_maps_to_500(srv, monkeypatch):
    # a dead device / runtime failure is the server's problem: 500, not the
    # pre-r4s10 blanket 400 that told clients their request was malformed
    def boom(*a, **kw):
        raise RuntimeError("device exploded")

    monkeypatch.setattr(srv.server, "submit", boom)
    img = base64.b64encode(_png_bytes(
        rng.integers(0, 256, (8, 8, 3), np.uint8))).decode()
    req = urllib.request.Request(
        _url(srv, "/stitch"), data=json.dumps({"images": [img]}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 500
    assert "device exploded" in json.loads(ei.value.read())["error"]


def test_status_mapping():
    from imagestitching.serve.http import BadImage, _status_for
    assert _status_for(ValueError("x")) == 400
    assert _status_for(BadImage("x")) == 400
    assert _status_for(TimeoutError("slow")) == 504      # job deadline
    import concurrent.futures as cf
    assert _status_for(cf.TimeoutError()) == 504
    assert _status_for(RuntimeError("x")) == 500
    assert _status_for(MemoryError()) == 500


def test_http_warmup(srv):
    req = urllib.request.Request(
        _url(srv, "/warmup"),
        data=json.dumps({"shapes": [[24, 32], [20, 28]], "gap": 2,
                         "batch_sizes": [1]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        info = json.loads(r.read())
    assert info == {"batches": [1], "signature_cached": True}
    assert srv.server.stats()["warmups"] >= 1


def test_http_warmup_requires_shapes(srv):
    req = urllib.request.Request(
        _url(srv, "/warmup"), data=b"{}",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert "shapes" in json.loads(ei.value.read())["error"]


def test_http_warmup_non_dict_body_is_400(srv):
    req = urllib.request.Request(
        _url(srv, "/warmup"), data=b"[1, 2]",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_http_warmup_bad_batch_sizes_is_400(srv):
    req = urllib.request.Request(
        _url(srv, "/warmup"),
        data=json.dumps({"shapes": [[16, 16]], "batch_sizes": 8}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
