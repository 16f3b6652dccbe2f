"""Image IO: PNG write with the reference's u8 conversion.

``saveImgFile`` (main.cpp:251-266) writes img_Data bytes produced by
``u8fromfloat`` (maths.h:126-130): ``x*255.99`` saturated at 255.  The
render buffer is y-up (row 0 = bottom scanline); PNG is y-down, so flip.
The PNG codec is the standard library's ``zlib`` and ``struct``: 8-bit RGB,
no interlace.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def to_u8(img: np.ndarray) -> np.ndarray:
    v = np.asarray(img, np.float32) * 255.99
    return np.where(v >= 255.0, 255, v.astype(np.uint8)).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(rgb_u8: np.ndarray) -> bytes:
    """PNG file bytes of an (H, W, 3) u8 image whose row 0 is the bottom
    scanline (flipped here, as the viewer's frames are)."""
    rgb = np.asarray(rgb_u8, np.uint8)[::-1]
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3), got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    return b"".join((
        _SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")))


def write_png(path: str, img):
    """img: (H, W, 3) float in [0,1], row 0 at the bottom."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    data = png_bytes(to_u8(np.asarray(img)))
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the five PNG scanline filters for 3 bytes per pixel."""
    bpp, stride = 3, w * 3
    out = np.zeros((h, stride), np.int32)
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        for x in range(stride if ftype not in (0, 2) else 0):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            elif ftype == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"bad PNG filter type {ftype}")
            cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, 3)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG to (H, W, 3) float, row 0 at the bottom."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {hdr}")
    w, h = hdr[0], hdr[1]
    rgb = _unfilter(zlib.decompress(idat), h, w)
    return rgb[::-1].astype(np.float32) / 255.99
