"""HTTP front end for the batch stitch server (stdlib-only).

The reference's "serving surface" is a phone UI; the framework's is a
network service.  This module exposes :class:`.server.StitchServer` over
HTTP so concurrent clients feed the dynamic batcher (requests arriving
within ``max_wait_s`` of each other share one device program):

* ``POST /stitch``  — images in request order, either
  ``multipart/form-data`` file parts or JSON ``{"images": ["<base64>", ..]}``;
  stitch options via query string or JSON fields (``direction``, ``mode``,
  ``gap``, ``filter``, ``background="R,G,B"``, ``merge_overlap``,
  ``merge_threshold``, ``grid_cols`` (+ ``grid_order``/``valign`` — grid
  collage instead of a strip), ``format=png|jpg``,
  ``quality``, ``png_level``).  Responds with the encoded strip.
* ``POST /warmup``  — pre-compile the executables for an expected job
  geometry (JSON ``{"shapes": [[h, w], ...], "batch_sizes": [1, 8], ...}``
  plus the same option fields as ``/stitch``) so the first real request
  pays dispatch, not trace + XLA compile.
* ``GET /healthz``  — liveness + backend info.
* ``GET /stats``    — batcher counters plus the logger ring tail
  (crash-safe-log analog of the reference, pages/index/index.js:76-124).

Uses only the standard library (ThreadingHTTPServer + email for multipart);
per-request decode runs on the HTTP worker thread, so the GIL-free native
codec keeps decodes parallel while the StitchServer thread owns the device.
"""

from __future__ import annotations

import base64
import json
import threading
from email.message import Message
from email.parser import BytesParser
from email.policy import HTTP as _HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..config import StitchOptions
from ..imgio import codec
from ..runtime.logger import get_logger
from .server import ServerOverloaded, StitchServer


class BadImage(ValueError):
    """A request image failed to decode — the client's bytes, their 400."""


def _status_for(e: Exception) -> int:
    """Map a request failure to an HTTP status.

    Client-attributable errors (bad options, undecodable images) are 400;
    a job that outlives the result deadline is 504; anything else is a
    server-side failure and reports 500 — blaming the client for a dead
    device (the pre-r4s10 behavior: every exception was a 400) misdirects
    the operator AND the client's retry logic."""
    if isinstance(e, ValueError):
        return 400
    if isinstance(e, TimeoutError):      # concurrent.futures alias too
        return 504
    return 500


def _parse_multipart(content_type: str, body: bytes) -> List[bytes]:
    """File parts, in order, from a multipart/form-data body."""
    head = (f"Content-Type: {content_type}\r\n"
            "MIME-Version: 1.0\r\n\r\n").encode()
    msg: Message = BytesParser(policy=_HTTP_POLICY).parsebytes(head + body)
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data")
    return [part.get_payload(decode=True)
            for part in msg.iter_parts()
            if part.get_payload(decode=True)]


def _options_from(params: dict) -> Tuple[StitchOptions, dict]:
    def one(key, default=None):
        v = params.get(key)
        # parse_qs wraps each value in a single-element str list; JSON
        # arrays (e.g. "background": [250, 250, 250]) pass through intact
        if isinstance(v, list) and len(v) == 1 and isinstance(v[0], str):
            v = v[0]
        return default if v is None else v

    bg = one("background", "255,255,255")
    if isinstance(bg, str):
        bg = [int(x) for x in bg.split(",")]
    bg = tuple(int(x) for x in bg)
    options = StitchOptions(
        direction=one("direction", "vertical"),
        mode=one("mode", "min"),
        gap=float(one("gap", 0.0)),
        filter=one("filter", "bilinear"),
        background=tuple(bg),
        supersample=str(one("supersample", "")).lower() in ("1", "true"),
        merge_overlap=str(one("merge_overlap", "")).lower()
        in ("1", "true"),
        merge_threshold=float(one("merge_threshold", 2.0)),
    ).validate()
    out = {
        "format": str(one("format", "png")).lower(),
        "quality": int(one("quality", 95)),
        "png_level": int(one("png_level", 6)),
        "grid_cols": (int(one("grid_cols")) if one("grid_cols") is not None
                      else None),
        "grid_order": str(one("grid_order", "balance")),
        "valign": str(one("valign", "top")),
    }
    if out["format"] not in ("png", "jpg", "jpeg"):
        raise ValueError(f"unknown format {out['format']!r}")
    if out["grid_cols"] is not None and out["grid_cols"] < 1:
        raise ValueError(f"grid_cols must be >= 1, got {out['grid_cols']}")
    return options, out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "imagestitching"

    # quiet by default; the structured logger is the observability surface
    def log_message(self, fmt, *args):  # noqa: D102
        del fmt, args

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        app = self.server.app          # type: ignore[attr-defined]
        if path == "/healthz":
            self._send_json(200, {"ok": True, "backend": app.backend()})
        elif path == "/stats":
            self._send_json(200, {
                "server": app.server.stats(),
                "log_tail": get_logger().ring()[-20:],
            })
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        if url.path not in ("/stitch", "/warmup"):
            self._send_json(404, {"error": f"no route {url.path}"})
            return
        app = self.server.app          # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > app.max_request_bytes:
                # the unread body would corrupt a keep-alive connection
                # (parsed as the next request line) — drop the connection
                self.close_connection = True
                self._send_json(413, {
                    "error": f"request {length} B exceeds the "
                             f"{app.max_request_bytes} B limit"})
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            params = {k: v for k, v in parse_qs(url.query).items()}
            if url.path == "/warmup":
                # pre-compile the executables for an expected job geometry:
                # JSON {"shapes": [[h, w], ...], "batch_sizes": [1, 8],
                # "orientations": [...], <stitch option fields>}
                payload = json.loads(body or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("warmup body must be a JSON object")
                params = {**payload, **params}
                options, _ = _options_from(params)
                shapes = payload.get("shapes") or []
                if not shapes:
                    raise ValueError("no shapes in warmup request")
                info = app.server.warmup(
                    shapes, options,
                    orientations=payload.get("orientations"),
                    batch_sizes=payload.get("batch_sizes", (1,)))
                self._send_json(200, info)
                return
            if ctype.startswith("multipart/form-data"):
                blobs = _parse_multipart(ctype, body)
            else:
                payload = json.loads(body or b"{}")
                blobs = [base64.b64decode(b)
                         for b in payload.get("images", [])]
                params = {**payload, **params}
            if not blobs:
                raise ValueError("no images in request")
            options, enc = _options_from(params)
            data, ctype_out = app.stitch_blobs(blobs, options, enc)
            self._send(200, data, ctype_out)
        except ServerOverloaded as e:
            # backpressure is overload, not a client error: 503 +
            # Retry-After so well-behaved clients retry
            get_logger().event("http.overloaded", error=repr(e))
            self.send_response(503)
            self.send_header("Retry-After", "1")
            body = json.dumps({"error": str(e)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # noqa: BLE001 — request isolation boundary
            code = _status_for(e)
            get_logger().event("http.request_fail", error=repr(e),
                               status=code)
            self._send_json(code, {"error": str(e)})


class StitchHTTPServer:
    """HTTP wrapper around :class:`StitchServer`.

    >>> with StitchHTTPServer(port=0) as srv:
    ...     print(srv.port)   # serve until closed
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 server: Optional[StitchServer] = None,
                 max_request_bytes: int = 256 << 20, **server_kw):
        self.max_request_bytes = max_request_bytes
        self.server = server or StitchServer(**server_kw)
        self._own_server = server is None
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.app = self         # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="stitch-http")
        self._thread.start()
        get_logger().event("http.listen", host=self.host, port=self.port)

    @staticmethod
    def backend() -> str:
        try:
            import jax
            return jax.default_backend()
        except Exception:  # pragma: no cover
            return "unavailable"

    def stitch_blobs(self, blobs: List[bytes], options: StitchOptions,
                     enc: dict) -> Tuple[bytes, str]:
        """Decode request images, run one batched job, encode the strip."""
        # overload pre-check before paying per-request decode work (the
        # authoritative slot-reserving check still happens at submission)
        self.server.ensure_capacity()
        try:
            decoded = [codec.decode(b) for b in blobs]
        except Exception as e:   # noqa: BLE001 — any failure here is the
            raise BadImage(f"image decode failed: {e}") from e  # client's
        images = [d[0] for d in decoded]
        orientations = [d[1] for d in decoded]   # EXIF applied on device
        if enc.get("grid_cols"):
            # grid collage: a one-shot multi-plan job — runs through the
            # api (per-column strip pipeline), not the batching server.
            # It still holds a server admission slot (same max_queue
            # backpressure as batch jobs) and inherits the server's FULL
            # RuntimeConfig (budget/limits/decode knobs/mesh).
            from .. import api
            with self.server.admission():
                out = api.stitch_grid(
                    list(zip(images, orientations)), cols=enc["grid_cols"],
                    options=options, config=self.server.config,
                    order=enc["grid_order"], valign=enc["valign"])
        else:
            out = self.server.submit(images, options,
                                     orientations=orientations).result(
                                         timeout=300)
        if enc["format"] in ("jpg", "jpeg"):
            data = codec.encode_bytes(out, "jpeg", quality=enc["quality"])
            return data, "image/jpeg"
        from ..imgio import native
        png = (native.encode_png(out, compression=enc["png_level"])
               if native.available() and out.shape[2] == 3 else None)
        if png is None:
            png = codec.encode_bytes(out, "png")
        return png, "image/png"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._own_server:
            self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """``python -m imagestitching.serve.http [--port N] [--host H]``"""
    import argparse

    p = argparse.ArgumentParser(prog="imagestitching-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    args = p.parse_args(argv)
    srv = StitchHTTPServer(args.host, args.port,
                           max_batch=args.max_batch,
                           max_wait_s=args.max_wait_ms / 1000.0)
    print(f"serving on http://{srv.host}:{srv.port}  "
          f"(POST /stitch, GET /healthz, GET /stats)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
