"""Latent upscaling: bislerp (spherical) and nearest/bilinear, NHWC.

Counterpart of lightdiffusion_next_tpu/utils/upscale.py (``bislerp``,
``common_upscale``, ``LatentUpscale``). bislerp stays host numpy, the same
arithmetic in the same order, so it equals the JAX package's bit for bit:
it slerps channel vectors along w, then along h, at the sample coordinates
of torch's bilinear interpolation. The hires-fix latent it resizes is
small ((1, 128, 128, 4) at 1024^2).
"""

from __future__ import annotations

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.utils import profiling


def _bilinear_1d(arr: np.ndarray, length_new: int) -> np.ndarray:
    """torch ``F.interpolate(mode="bilinear", align_corners=False)`` of a
    1-D sequence."""
    length_old = arr.shape[0]
    x = (np.arange(length_new, dtype=np.float64) + 0.5) * (length_old / length_new) - 0.5
    x = np.clip(x, 0, length_old - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, length_old - 1)
    w = x - lo
    return arr[lo] * (1 - w) + arr[hi] * w


def _coords(length_old: int, length_new: int):
    ramp = np.arange(length_old, dtype=np.float32)
    c1f = _bilinear_1d(ramp, length_new)
    ratios = (c1f - np.floor(c1f)).astype(np.float32)
    coords_1 = c1f.astype(np.int64)
    ramp2 = ramp + 1
    ramp2[-1] -= 1
    coords_2 = _bilinear_1d(ramp2, length_new).astype(np.int64)
    return ratios, coords_1, coords_2


def _slerp(b1: np.ndarray, b2: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Spherical lerp of channel vectors; the plain lerp where they point
    opposite ways, ``b1`` where they point the same way."""
    b1_norm = np.linalg.norm(b1, axis=-1, keepdims=True)
    b2_norm = np.linalg.norm(b2, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        b1n = np.where(b1_norm == 0, 0.0, b1 / np.maximum(b1_norm, 1e-30))
        b2n = np.where(b2_norm == 0, 0.0, b2 / np.maximum(b2_norm, 1e-30))
        dot = np.sum(b1n * b2n, axis=-1)
        omega = np.arccos(np.clip(dot, -1.0, 1.0))
        so = np.sin(omega)
        res = (np.sin((1.0 - r[:, 0]) * omega) / so)[:, None] * b1n + (
            np.sin(r[:, 0] * omega) / so)[:, None] * b2n
    res = res * (b1_norm * (1.0 - r) + b2_norm * r)
    same = dot > 1 - 1e-5
    res[same] = b1[same]
    opp = dot < 1e-5 - 1
    res[opp] = (b1 * (1.0 - r) + b2 * r)[opp]
    return res


def bislerp(samples, width: int, height: int) -> np.ndarray:
    """NHWC spherical-bilinear resize of host numpy (or a tensor, read
    back to the host) to (height, width); returns numpy."""
    if isinstance(samples, torch.Tensor):
        with profiling.span("sync.upscale_readback"):
            samples = samples.detach().float().cpu().numpy()
    x = np.asarray(samples, dtype=np.float32)
    n, h, w, c = x.shape

    ratios, c1, c2 = _coords(w, width)
    p1 = x[:, :, c1, :].reshape(-1, c)
    p2 = x[:, :, c2, :].reshape(-1, c)
    r = np.tile(ratios[None, None, :], (n, h, 1)).reshape(-1, 1)
    x = _slerp(p1, p2, r).reshape(n, h, width, c)

    ratios, c1, c2 = _coords(h, height)
    p1 = x[:, c1, :, :].reshape(-1, c)
    p2 = x[:, c2, :, :].reshape(-1, c)
    r = np.tile(ratios[None, :, None], (n, 1, width)).reshape(-1, 1)
    return _slerp(p1, p2, r).reshape(n, height, width, c)


def common_upscale(samples, width: int, height: int, method: str = "bislerp"):
    """"bislerp" (what the pipelines use), "nearest" or "bilinear"; returns
    numpy."""
    if method == "bislerp":
        return bislerp(samples, width, height)
    from lightdiffusion_next_tpu_torch.ops import nn

    x = torch.as_tensor(np.asarray(samples, dtype=np.float32))
    if method == "nearest":
        n, h, w, c = x.shape
        ys = torch.from_numpy((np.arange(height) * h // height).astype(np.int64))
        xs = torch.from_numpy((np.arange(width) * w // width).astype(np.int64))
        return x[:, ys][:, :, xs].numpy()
    if method == "bilinear":
        return nn.interpolate_bilinear(x, (height, width)).numpy()
    raise ValueError(f"unknown upscale method {method!r}")


class LatentUpscale:
    """The LatentUpscale node: pixel sizes, each at least 64, to a bislerp
    of the latent at 1/8 of them."""

    def upscale(self, latent, width: int, height: int):
        if width == 0 and height == 0:
            return latent
        width = max(64, width)
        height = max(64, height)
        return bislerp(latent, width // 8, height // 8)
