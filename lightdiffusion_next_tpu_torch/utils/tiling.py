"""Tiled application of image-to-image networks, with feathered overlaps.

Counterpart of lightdiffusion_next_tpu/utils/tiling.py
(``get_tiled_scale_steps``, the feather mask, ``tiled_apply_2d``): the same
tile grid, the edge tiles shifted inward so every tile has one shape, and
the same linear ramp over the overlap. The loop runs on the host; the
tiles, the blended output and its weights stay on the input's device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def get_tiled_scale_steps(width: int, height: int, tile_x: int, tile_y: int,
                          overlap: int) -> int:
    return math.ceil(height / (tile_y - overlap)) * math.ceil(width / (tile_x - overlap))


def _feather_mask(h: int, w: int, overlap: int) -> np.ndarray:
    """A linear ramp over ``overlap`` pixels on every edge, host f32."""
    mask = np.ones((h, w), dtype=np.float32)
    if overlap > 0:
        ramp = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
        mask[:overlap, :] *= ramp[:, None]
        mask[-overlap:, :] *= ramp[::-1][:, None]
        mask[:, :overlap] *= ramp[None, :]
        mask[:, -overlap:] *= ramp[None, ::-1]
    return mask


def _starts(size: int, tile: int, stride: int):
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def tiled_apply_2d(fn: Callable, x, tile: int = 64, overlap: int = 8, upscale: int = 1,
                   out_channels: int = 3) -> torch.Tensor:
    """Apply ``fn`` (NHWC -> NHWC, scaled by ``upscale``) to overlapping
    ``tile`` x ``tile`` tiles of ``x`` (NHWC tensor or numpy) and blend the
    outputs by the feathered weights. Returns f32 on ``x``'s device."""
    x = torch.as_tensor(x)
    b, h, w, _ = x.shape
    tile = min(tile, h, w)
    stride = max(tile - overlap, 1)
    size = tile * upscale
    out = torch.zeros((b, h * upscale, w * upscale, out_channels), dtype=torch.float32,
                      device=x.device)
    weight = torch.zeros((b, h * upscale, w * upscale, 1), dtype=torch.float32,
                         device=x.device)
    mask = torch.from_numpy(_feather_mask(size, size, overlap * upscale))[None, :, :, None]
    mask = mask.to(x.device)
    for y0 in _starts(h, tile, stride):
        for x0 in _starts(w, tile, stride):
            tile_out = torch.as_tensor(fn(x[:, y0:y0 + tile, x0:x0 + tile, :]))
            yo, xo = y0 * upscale, x0 * upscale
            out[:, yo:yo + size, xo:xo + size, :] += tile_out.to(out) * mask
            weight[:, yo:yo + size, xo:xo + size, :] += mask
    return out / torch.clamp(weight, min=1e-8)
