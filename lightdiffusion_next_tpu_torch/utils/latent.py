"""Latent formats, the empty latent and the linear-RGB latent preview.

Counterpart of lightdiffusion_next_tpu/utils/latent.py: the SD1.5, SD3 and
Flux formats with their preview colour factors and TAESD decoder files,
``fix_empty_latent_channels`` and ``latent_preview_rgb`` (the preview when
no TAESD decoder is present).

One deviation: the JAX formats name their decoder (``taesd_decoder_name``,
read nowhere) while its pipeline hard-codes each stage's file; here
``taesd_decoder_file`` is the file under ``vae_approx/`` that the previews
load, the downloader's name for it (None: no decoder is fetched for the
format, its previews use the linear RGB map).
Latents are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LatentFormat:
    """Scale/shift between model-space and VAE-space latents; process_in
    maps a VAE latent into model space."""

    scale_factor: float = 1.0
    shift_factor: float = 0.0
    latent_channels: int = 4
    latent_rgb_factors: Optional[Tuple[Tuple[float, float, float], ...]] = None
    taesd_decoder_file: Optional[str] = None

    def process_in(self, latent):
        if self.shift_factor:
            return (latent - self.shift_factor) * self.scale_factor
        return latent * self.scale_factor

    def process_out(self, latent):
        if self.shift_factor:
            return latent / self.scale_factor + self.shift_factor
        return latent / self.scale_factor


SD15 = LatentFormat(
    scale_factor=0.18215,
    latent_channels=4,
    latent_rgb_factors=(
        (0.3512, 0.2297, 0.3227),
        (0.3250, 0.4974, 0.2350),
        (-0.2829, 0.1762, 0.2721),
        (-0.2120, -0.2616, -0.7177),
    ),
    taesd_decoder_file="taesd_decoder.safetensors",
)

SD3 = LatentFormat(
    scale_factor=1.5305,
    shift_factor=0.0609,
    latent_channels=16,
    latent_rgb_factors=(
        (-0.0645, 0.0177, 0.1052), (0.0028, 0.0312, 0.0650),
        (0.1848, 0.0762, 0.0360), (0.0944, 0.0360, 0.0889),
        (0.0897, 0.0506, -0.0364), (-0.0020, 0.1203, 0.0284),
        (0.0855, 0.0118, 0.0283), (-0.0539, 0.0658, 0.1047),
        (-0.0057, 0.0116, 0.0700), (-0.0412, 0.0281, -0.0039),
        (0.1106, 0.1171, 0.1220), (-0.0248, 0.0682, -0.0481),
        (0.0815, 0.0846, 0.1207), (-0.0120, -0.0055, -0.0867),
        (-0.0749, -0.0634, -0.0456), (-0.1418, -0.1457, -0.1259),
    ),
)

FLUX1 = LatentFormat(
    scale_factor=0.3611,
    shift_factor=0.1159,
    latent_channels=16,
    latent_rgb_factors=(
        (-0.0404, 0.0159, 0.0609), (0.0043, 0.0298, 0.0850),
        (0.0328, -0.0749, -0.0503), (-0.0245, 0.0085, 0.0549),
        (0.0966, 0.0894, 0.0530), (0.0035, 0.0399, 0.0123),
        (0.0583, 0.1184, 0.1262), (-0.0191, -0.0206, -0.0306),
        (-0.0324, 0.0055, 0.1001), (0.0955, 0.0659, -0.0545),
        (-0.0504, 0.0231, -0.0013), (0.0500, -0.0008, -0.0088),
        (0.0982, 0.0941, 0.0976), (-0.1233, -0.0280, -0.0897),
        (-0.0005, -0.0530, -0.0020), (-0.1273, -0.0932, -0.0680),
    ),
    taesd_decoder_file="diffusion_pytorch_model.safetensors",  # taef1, diffusers' layout
)


def empty_latent(width: int, height: int, batch_size: int = 1, channels: int = 4,
                 device=None):
    """NHWC f32 zeros latent of H/8 x W/8."""
    return torch.zeros((batch_size, height // 8, width // 8, channels), device=device)


def fix_empty_latent_channels(latent_format: LatentFormat, latent):
    """Pad with zeros or trim the channel dim to the format's
    latent_channels."""
    c = latent_format.latent_channels
    if latent.shape[-1] == c:
        return latent
    if latent.shape[-1] < c:
        pad = latent.new_zeros(tuple(latent.shape[:-1]) + (c - latent.shape[-1],))
        return torch.cat([latent, pad], dim=-1)
    return latent[..., :c]


def latent_preview_rgb(latent_format: LatentFormat, latent) -> np.ndarray:
    """Latent -> RGB in [0, 1] through the format's linear map (host f32
    numpy, NHWC)."""
    if isinstance(latent, torch.Tensor):
        latent = latent.detach().float().cpu().numpy()
    fac = np.asarray(latent_format.latent_rgb_factors, dtype=np.float32)
    rgb = np.asarray(latent, dtype=np.float32) @ fac
    rgb = (rgb + 1.0) / 2.0
    return np.clip(rgb, 0.0, 1.0)
