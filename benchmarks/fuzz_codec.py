"""Native-codec fuzzer: mutated containers through the C decoders, isolated.

The --formats soak corrupts ~30% of its cases and compares against Pillow;
this harness is the volume complement for the native layer ALONE — the
hand-written binary parsers in native/codec.cpp (PNG fast-path chunk walker,
GIF LZW, BMP header, WEBP/JPEG/PNG dimension parsing) are the one place in
the framework where untrusted bytes meet C++ pointer arithmetic, so they get
orders of magnitude more corrupt inputs than the soak can afford
(reference analog: the decode fallback ladder is the reference's *only*
corruption handling, pages/index/index.js:1464-1509 — here the native layer
must additionally never crash the process).

Contract per case: decode raises a clean Python exception OR returns a
well-formed (h, w, 3) uint8 array with h, w > 0.  Segfaults/aborts/hangs are
what the harness exists to catch, so cases run in BATCHED SUBPROCESSES: a
batch that dies on a signal (or times out) is re-run case-by-case to isolate
the crashing seed, and the offending input is written next to the log.

Usage:
    python benchmarks/fuzz_codec.py [N] [SEED_BASE]       # parent (default 5000)
    python benchmarks/fuzz_codec.py --child SEED COUNT    # internal
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 500
CHILD_TIMEOUT_S = 240          # a whole batch; ~10s typical on the 1-core host
CASE_TIMEOUT_S = 30            # single-case isolation reruns

_FORMATS = ("jpeg", "png", "png_fast", "png_struct", "webp", "bmp", "gif",
            "heic")


def _png_chunks(data: bytes):
    """Parse a valid PNG into [(tag, body)]."""
    import struct
    out = []
    pos = 8
    while pos + 12 <= len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        out.append((tag, data[pos + 8:pos + 8 + ln]))
        pos += 12 + ln
    return out


def _png_build(chunks) -> bytes:
    import struct
    import zlib
    out = [b"\x89PNG\r\n\x1a\n"]
    for tag, body in chunks:
        out.append(struct.pack(">I", len(body)) + tag + body
                   + struct.pack(">I", zlib.crc32(tag + body)))
    return b"".join(out)


def _mutate_png_struct(rng, data: bytes) -> bytes:
    """Structure-aware PNG mutation: corrupt chunk CONTENTS but keep CRCs
    valid, so inputs get PAST the fast path's CRC gates and into the
    hand-written inflate/defilter/palette logic (random byte flips die at
    the first CRC check and only ever fuzz the libpng fallback)."""
    chunks = _png_chunks(data)
    if not chunks:
        return data
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(0, 6))
        i = int(rng.integers(0, len(chunks)))
        tag, body = chunks[i]
        b = bytearray(body)
        if kind == 0 and tag == b"IHDR" and len(b) == 13:
            f = int(rng.integers(0, 5))           # depth/ctype/interlace/dims
            if f == 0:
                b[8] = int(rng.choice([1, 2, 4, 8, 16, 3, 250]))
            elif f == 1:
                b[9] = int(rng.choice([0, 2, 3, 4, 6, 1, 5, 7, 9]))
            elif f == 2:
                b[12] = int(rng.choice([0, 1, 2, 255]))
            else:                                  # nudge a dimension
                at = 0 if f == 3 else 4
                import struct
                w = struct.unpack(">I", bytes(b[at:at + 4]))[0]
                w = max(0, w + int(rng.integers(-3, 30)))
                b[at:at + 4] = struct.pack(">I", w)
            chunks[i] = (tag, bytes(b))
        elif kind == 1 and b:                      # flip body bytes (any tag)
            for _ in range(int(rng.integers(1, 10))):
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            chunks[i] = (tag, bytes(b))
        elif kind == 2 and b:                      # truncate/extend body
            if rng.random() < 0.5:
                chunks[i] = (tag, bytes(b[:int(rng.integers(0, len(b)))]))
            else:
                chunks[i] = (tag, bytes(b) + bytes(
                    rng.integers(0, 256, int(rng.integers(1, 64)),
                                 dtype="uint8")))
        elif kind == 3:                            # drop a chunk
            if len(chunks) > 1:
                chunks.pop(i)
        elif kind == 4:                            # duplicate / reorder
            chunks.insert(int(rng.integers(0, len(chunks) + 1)),
                          chunks[i])
        else:                                      # inject PLTE/tRNS/junk
            tag2 = bytes(rng.choice([b"PLTE", b"tRNS", b"gAMA", b"IDAT"]))
            body2 = bytes(rng.integers(0, 256,
                                       int(rng.choice([0, 1, 3, 6, 255,
                                                       768, 780])),
                                       dtype="uint8"))
            chunks.insert(int(rng.integers(0, len(chunks) + 1)),
                          (tag2, body2))
    return _png_build(chunks)


def _make_valid(rng, fmt: str) -> bytes:
    """A small valid container to mutate (Pillow encodes; native decodes)."""
    import numpy as np
    from PIL import Image

    # heic: HEVC needs non-degenerate dims; others go down to 1x1
    h = int(rng.integers(16, 48) if fmt == "heic" else rng.integers(1, 40))
    w = int(rng.integers(16, 48) if fmt == "heic" else rng.integers(1, 40))
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    if fmt == "heic":          # libheif encode (Pillow has no HEIF writer)
        import tempfile

        from imagestitching.imgio import heif
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.heic")
            heif.encode_to_file(p, arr, quality=int(rng.integers(20, 95)))
            with open(p, "rb") as f:
                return f.read()
    img = Image.fromarray(arr)
    buf = io.BytesIO()
    if fmt == "jpeg":
        img.save(buf, "JPEG", quality=int(rng.integers(5, 99)))
    elif fmt in ("png", "png_fast", "png_struct"):
        if rng.random() < 0.3:
            img = img.convert("P", palette=Image.ADAPTIVE)
        elif rng.random() < 0.3:
            img = img.convert("RGBA")
        img.save(buf, "PNG")
    elif fmt == "webp":
        img.save(buf, "WEBP", lossless=bool(rng.random() < 0.5),
                 quality=int(rng.integers(5, 99)))
    elif fmt == "bmp":
        img.save(buf, "BMP")
    else:
        img.convert("P", palette=Image.ADAPTIVE).save(buf, "GIF")
    return buf.getvalue()


def _mutate(rng, data: bytes) -> bytes:
    """1-3 mutations, biased toward headers (dimension/palette/chunk
    parsing lives in the first dozens of bytes)."""
    b = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(0, 5))
        if kind == 0 and len(b) > 12:                    # truncate
            b = b[:int(rng.integers(8, len(b)))]
        elif kind == 1:                                  # header byte flips
            for _ in range(int(rng.integers(1, 8))):
                at = int(rng.integers(0, min(64, len(b))))
                b[at] ^= int(rng.integers(1, 256))
        elif kind == 2 and len(b) > 20:                  # body byte flips
            for _ in range(int(rng.integers(1, 12))):
                b[int(rng.integers(8, len(b)))] ^= int(rng.integers(1, 256))
        elif kind == 3 and len(b) > 32:                  # zero a window
            at = int(rng.integers(0, len(b) - 16))
            ln = int(rng.integers(4, min(128, len(b) - at)))
            b[at:at + ln] = bytes(ln)
        else:                                            # splice random tail
            at = int(rng.integers(0, len(b)))
            b = b[:at] + bytes(rng.integers(0, 256,
                                            int(rng.integers(4, 96)),
                                            dtype="uint8"))
    return bytes(b)


def _case_bytes(seed: int):
    """Deterministic (fmt, mutated bytes) for one seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    fmt = _FORMATS[int(rng.integers(0, len(_FORMATS)))]
    if fmt == "heic":
        from imagestitching.imgio import heif
        if not heif.available():
            fmt = "png"        # deterministic stand-in off this host
    data = _make_valid(rng, fmt)
    if fmt == "png_struct":      # CRC-valid structural mutations
        data = _mutate_png_struct(rng, data)
    elif rng.random() < 0.06:    # pure-noise slice with a valid magic prefix
        magic = data[:int(rng.integers(2, 16))]
        data = magic + bytes(rng.integers(0, 256, int(rng.integers(8, 512)),
                                          dtype="uint8"))
    else:
        data = _mutate(rng, data)
    return fmt, data


def _run_case(seed: int) -> None:
    from imagestitching.imgio import heif, native

    fmt, data = _case_bytes(seed)
    if fmt == "heic":
        try:
            heif.probe(data)               # header-only path
            out = heif.decode(data)        # full libheif/HEVC path
        except Exception:
            return
        assert out.ndim == 3 and out.shape[2] == 3
        assert out.dtype.name == "uint8"
        return
    if fmt == "png_struct":
        # differential: the fast path (which silently falls back to libpng
        # for shapes it refuses) must agree byte-for-byte with libpng
        # whenever BOTH accept the input — the "pixel-identical" contract
        import numpy as np
        res = []
        for flag in ("1", "0"):
            os.environ["ISX_PNG_FAST"] = flag
            try:
                res.append(native.decode_png(data))
            except Exception:
                res.append(None)
        fast, slow = res
        if fast is not None:
            assert fast.ndim == 3 and fast.shape[2] == 3
            assert fast.dtype.name == "uint8"
        if fast is not None and slow is not None:
            assert fast.shape == slow.shape, (fast.shape, slow.shape)
            assert np.array_equal(fast, slow)
        return
    os.environ["ISX_PNG_FAST"] = "0" if fmt == "png" else "1"
    fn = {"jpeg": native.decode_jpeg, "png": native.decode_png,
          "png_fast": native.decode_png, "webp": native.decode_webp,
          "bmp": native.decode_bmp, "gif": native.decode_gif}[fmt]
    try:
        out = fn(data)
    except Exception:
        return                    # clean refusal is a pass
    if out is None:               # codec/libwebp unavailable
        return
    assert out.ndim == 3 and out.shape[2] == 3 and out.dtype.name == "uint8"
    assert out.shape[0] > 0 and out.shape[1] > 0


def _child(seed0: int, count: int) -> int:
    # Isolation reruns set ISX_FUZZ_SAVE: write the EXACT bytes this process
    # is about to decode before touching the native layer, so a segfault/hang
    # still leaves the true repro input behind (regenerating in the parent is
    # not equivalent — HEVC encode is not guaranteed bit-deterministic, and
    # generation itself can fail on hosts without an encoder plugin).
    save = os.environ.get("ISX_FUZZ_SAVE")
    for s in range(seed0, seed0 + count):
        if save:
            try:
                _, data = _case_bytes(s)
                with open(save, "wb") as f:
                    f.write(data)
            except Exception:
                pass               # _run_case will surface the same error
        _run_case(s)
    return 0


def _parent(n: int, base: int) -> int:
    from imagestitching.imgio import native
    if not native.available():
        print("native codec unavailable — nothing to fuzz")
        return 1
    env = dict(os.environ)
    fails = 0
    done = 0
    while done < n:
        cnt = min(BATCH, n - done)
        seed0 = base + done
        cmd = [sys.executable, os.path.abspath(__file__),
               "--child", str(seed0), str(cnt)]
        try:
            r = subprocess.run(cmd, env=env, timeout=CHILD_TIMEOUT_S,
                               capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            r = None
        if r is not None and r.returncode == 0:
            done += cnt
            print(f"batch {seed0}..{seed0 + cnt - 1} ok "
                  f"({done}/{n})", flush=True)
            continue
        # isolate: re-run the batch case-by-case
        why = "timeout" if r is None else f"rc={r.returncode}"
        print(f"batch {seed0}.. {why} — isolating", flush=True)
        for s in range(seed0, seed0 + cnt):
            path = f"/tmp/fuzz_codec_fail_{s}.bin"
            env_case = dict(env)
            env_case["ISX_FUZZ_SAVE"] = path
            try:
                rr = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--child", str(s), "1"],
                    env=env_case, timeout=CASE_TIMEOUT_S,
                    capture_output=True, text=True)
                bad = rr.returncode != 0
                tag = f"rc={rr.returncode}"
                err = rr.stderr[-800:]
            except subprocess.TimeoutExpired:
                bad, tag, err = True, "timeout", ""
            if bad:
                fails += 1
                # prefer the child-saved bytes (exact); regeneration here is
                # best-effort and must never kill the run — a seed whose
                # failure is in case GENERATION still gets recorded
                if os.path.exists(path):
                    where = f"input={path}"
                else:
                    try:
                        fmt, data = _case_bytes(s)
                        with open(path, "wb") as f:
                            f.write(data)
                        where = f"input={path} (parent-regenerated)"
                    except Exception as e:
                        where = f"input unavailable (generation failed: {e})"
                print(f"FAIL seed={s} {tag} {where}\n{err}", flush=True)
            elif os.path.exists(path):
                os.unlink(path)    # clean case: drop its pre-saved input
        done += cnt
        if fails >= 5:
            break
    print(f"done: {done}/{n} fuzz cases, {fails} failures", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv and argv[0] == "--child":
        sys.exit(_child(int(argv[1]), int(argv[2])))
    if len(argv) > 1:
        base = int(argv[1])
    else:
        # Fresh-base discipline (CLAUDE.md): a bare invocation must not
        # silently re-burn an already-ledgered range, so default to a
        # time-derived base in the reserved >=1M band (ledgered manual
        # bases live below 1M).  The printed base reproduces the run.
        import time
        base = 1_000_000 + int(time.time()) % 8_000_000
        print(f"SEED_BASE not given — using fresh base {base} "
              f"(pass N BASE to reproduce)", flush=True)
    sys.exit(_parent(int(argv[0]) if argv else 5000, base))
