"""Image output: uint8 conversion and PNG save with per-workflow counters.

Counterpart of lightdiffusion_next_tpu/utils/image.py (``to_uint8``,
``SaveImage`` and its ``<prefix>_NNNNN_.png`` counter). The PNG encoder is
written with the standard library (zlib, struct): the port does not need
PIL.
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
