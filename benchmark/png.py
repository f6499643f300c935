"""Read back an 8-bit RGB PNG (the images the pipeline saves), with the
standard library and numpy."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color != 2 or interlace:
        raise ValueError(f"{path}: only 8-bit RGB without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y else np.zeros(3 * w, np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 2:
            cur = (row + prev) & 255
        else:
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                c = prev[x - 3] if x >= 3 else 0
                pred = {1: a, 3: (a + prev[x]) // 2,
                        4: int(_paeth(np.int32(a), prev[x], np.int32(c)))}[int(ftype)]
                cur[x] = (row[x] + pred) & 255
        out[y] = cur
    return out.reshape(h, w, 3).astype(np.uint8)
