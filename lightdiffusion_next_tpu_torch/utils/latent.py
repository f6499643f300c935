"""Latent formats and the empty latent.

Counterpart of lightdiffusion_next_tpu/utils/latent.py (the SD1.5 and Flux
formats; the preview colour factors come with the previews, ROADMAP
Queue 1, item 8).
Latents are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LatentFormat:
    """Scale/shift between model-space and VAE-space latents; process_in
    maps a VAE latent into model space."""

    scale_factor: float = 1.0
    shift_factor: float = 0.0
    latent_channels: int = 4

    def process_in(self, latent):
        if self.shift_factor:
            return (latent - self.shift_factor) * self.scale_factor
        return latent * self.scale_factor

    def process_out(self, latent):
        if self.shift_factor:
            return latent / self.scale_factor + self.shift_factor
        return latent / self.scale_factor


SD15 = LatentFormat(scale_factor=0.18215, latent_channels=4)
FLUX1 = LatentFormat(scale_factor=0.3611, shift_factor=0.1159, latent_channels=16)


def empty_latent(width: int, height: int, batch_size: int = 1, channels: int = 4,
                 device=None):
    """NHWC f32 zeros latent of H/8 x W/8."""
    return torch.zeros((batch_size, height // 8, width // 8, channels), device=device)
