"""Image input and output: uint8 conversions, image loading, PNG save with
per-workflow counters.

Counterpart of lightdiffusion_next_tpu/utils/image.py (``to_uint8``,
``from_uint8``, ``load_image``, ``SaveImage`` and its
``<prefix>_NNNNN_.png`` counter). PNG is encoded and decoded with the
standard library (zlib, struct): the port does not need PIL for it. The
decoder reads 8-bit gray, RGB and RGBA, non-interlaced, with the row
filters 0-4; other images go through PIL where it can be imported.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Optional

import numpy as np


def to_uint8(images) -> np.ndarray:
    """float [0, 1] NHWC -> uint8 NHWC."""
    return np.clip(np.asarray(images) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def from_uint8(images) -> np.ndarray:
    return np.asarray(images, dtype=np.float32) / 255.0


_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _image_format(head: bytes) -> str:
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WEBP"
    return next((name for magic, name in _MAGIC if head.startswith(magic)), "unknown")


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG rows (each a filter byte, then ``stride`` bytes) with their
    filters undone (0 none, 1 sub, 2 up, 3 average, 4 Paeth): (h, stride)
    uint8."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG: image data too short")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for i in range(0, stride, bpp):
                up = prev[i:i + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                left = cur[i:i + bpp] = (cur[i:i + bpp] + pred) & 255
                up_left = up
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray), 3 (RGB) or 4 (RGBA).
    Raises ``ValueError`` on what the decoder does not read (other bit
    depths, palettes, gray with alpha, interlacing)."""
    if not data.startswith(_MAGIC[0][0]):
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG with bit depth {depth}, color type {color}, interlace "
                         f"{interlace}: the decoder reads 8-bit gray, RGB and RGBA, "
                         f"non-interlaced")
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    return rows.reshape(h, w, channels)


def load_image(path: str) -> np.ndarray:
    """An image file -> (1, H, W, 3) float32 in [0, 1]: gray repeated to
    three channels, alpha dropped. PNG through ``decode_png`` (PIL where
    that decoder refuses one), other formats through PIL; without PIL those
    raise ``ValueError`` naming the format."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _image_format(data[:16])
    try:
        if fmt != "PNG":
            raise ValueError(f"{path}: {fmt} images need PIL")
        img = decode_png(data)
        img = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]
    except ValueError as err:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"{path}: {err}, and PIL cannot be imported") from None
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    return from_uint8(img)[None]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, text: Optional[dict] = None,
               compress_level: int = 4) -> bytes:
    """(H, W) gray or (H, W, 3|4) RGB(A) uint8 -> PNG bytes, with optional
    tEXt entries (latin-1)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        color = 2 if img.shape[-1] == 3 else 6
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00"
                          + str(value).encode("latin-1", errors="replace")))
    out.append(_chunk(b"IDAT", zlib.compress(raw, compress_level)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def get_save_image_path(filename_prefix: str, output_dir: str) -> tuple:
    """Counter continuation across files: scans '<prefix>_NNNNN_.png'."""
    subfolder = os.path.dirname(os.path.normpath(filename_prefix))
    filename = os.path.basename(os.path.normpath(filename_prefix))
    full_output_folder = os.path.join(output_dir, subfolder)
    os.makedirs(full_output_folder, exist_ok=True)
    pattern = re.compile(r"^" + re.escape(filename) + r"_(\d+)_\.(png|jpg|jpeg|webp)$")
    counter = 0
    for f in os.listdir(full_output_folder):
        m = pattern.match(f)
        if m:
            counter = max(counter, int(m.group(1)))
    return full_output_folder, filename, counter + 1


class SaveImage:
    """Save NHWC float images in [0, 1] as numbered PNGs."""

    def __init__(self, output_dir: str = "./output"):
        self.output_dir = output_dir

    def save_images(self, images, filename_prefix: str = "LD",
                    prompt: Optional[str] = None,
                    extra_pnginfo: Optional[dict] = None) -> List[str]:
        arr = np.asarray(images, dtype=np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[-1] not in (1, 3, 4) and arr.shape[1] in (1, 3, 4):
            arr = np.transpose(arr, (0, 2, 3, 1))  # NCHW input tolerance
        folder, filename, counter = get_save_image_path(filename_prefix, self.output_dir)
        text = {}
        if prompt is not None:
            text["prompt"] = prompt
        if extra_pnginfo:
            import json

            text.update({k: json.dumps(v) for k, v in extra_pnginfo.items()})
        paths = []
        for img in to_uint8(arr):
            path = os.path.join(folder, f"{filename}_{counter:05}_.png")
            with open(path, "wb") as f:
                f.write(encode_png(img, text))
            paths.append(path)
            counter += 1
        return paths
