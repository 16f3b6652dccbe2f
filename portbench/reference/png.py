"""A PNG encoder and decoder for 8-bit RGB images (stdlib ``zlib``), and
the upstream renderer's float-to-byte conversion (``u8fromfloat``,
maths.h:126-130)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_u8(x):
    """``x * 255.99`` saturated at 255, truncated toward zero."""
    v = np.asarray(x, np.float32) * np.float32(255.99)
    return np.where(v >= 255.0, 255, v.astype(np.uint8)).astype(np.uint8)


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode(rgb) -> bytes:
    """The PNG of (H, W, 3) u8 ``rgb``, row 0 the top, no filtering."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 3 * w + 1), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) u8 of an 8-bit RGB, non-interlaced PNG, row 0 the top."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {hdr}")
    w, h = hdr[0], hdr[1]
    stride = 3 * w
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        elif f in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - 3] if x >= 3 else 0
                c = prev[x - 3] if x >= 3 else 0
                pred = (a if f == 1 else (a + prev[x]) // 2 if f == 3
                        else _paeth(a, prev[x], c))
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)
