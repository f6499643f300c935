"""AutoHDR post-processing: luminance shaping in Lab space.

Counterpart of lightdiffusion_next_tpu/utils/hdr.py. ``apply_hdr_batch``
computes what the JAX package's jitted ``_apply_hdr_jax`` computes, in f32
on the images' device, the contrast mean taken per image.
``apply_hdr`` is the float64 numpy version, the tests' oracle. sRGB <-> Lab
uses the D50 colorimetric transform.

The JAX package runs its 3x3 colour transforms at "highest" precision; here
each is three multiply-adds per channel (``_mat3``), which no TF32 switch
touches. ``jnp.cbrt`` becomes a sign-safe cube root through ``pow`` (within
an ulp or so of a correctly rounded one).
"""

from __future__ import annotations

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.utils import profiling

SRGB_TO_XYZ = ((0.4360747, 0.3850649, 0.1430804),
               (0.2225045, 0.7168786, 0.0606169),
               (0.0139322, 0.0971045, 0.7141733))
XYZ_TO_SRGB = ((3.1338561, -1.6168667, -0.4906146),
               (-0.9787684, 1.9161415, 0.0334540),
               (0.0719453, -0.2289914, 1.4052427))
WHITE_D50 = (0.9642957, 1.0, 0.8251046)
LUMA = (0.299, 0.587, 0.114)
EPS = 216 / 24389
KAPPA = 24389 / 27


def _srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """rgb float [0,1] HWC -> Lab (L in [0,100]), float64."""
    r = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    xyz = r @ np.array(SRGB_TO_XYZ, dtype=np.float64).T
    xyz = xyz / np.array(WHITE_D50)
    f = np.where(xyz > EPS, np.cbrt(xyz), (KAPPA * xyz + 16) / 116)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def _lab_to_srgb(lab: np.ndarray) -> np.ndarray:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200

    def finv(f):
        f3 = f**3
        return np.where(f3 > EPS, f3, (116 * f - 16) / KAPPA)

    xyz = np.stack([finv(fx), finv(fy), finv(fz)], axis=-1) * np.array(WHITE_D50)
    r = np.clip(xyz @ np.array(XYZ_TO_SRGB, dtype=np.float64).T, 0.0, 1.0)
    return np.where(r <= 0.0031308, r * 12.92, 1.055 * r ** (1 / 2.4) - 0.055)


def apply_hdr(image: np.ndarray, hdr_intensity: float = 0.75,
              shadow_intensity: float = 0.25, highlight_intensity: float = 0.5,
              gamma_intensity: float = 0.25, contrast: float = 0.1,
              enhance_color: float = 0.25) -> np.ndarray:
    """One (H, W, 3) float [0, 1] image -> the same, in float64 (returned
    as f32)."""
    lab = _srgb_to_lab(np.asarray(image, dtype=np.float64))
    base = lab[..., 0] * 255.0 / 100.0
    scaled_shadow = shadow_intensity**2 * hdr_intensity
    scaled_highlight = highlight_intensity**2 * hdr_intensity
    shadow_mask = np.clip((1 - base / 255) ** 2, 0, 1)
    highlight_mask = np.clip((base / 255) ** 2, 0, 1)
    adjusted_shadows = np.clip(base * (1 - shadow_mask * scaled_shadow), 0, 255)
    adjusted_highlights = np.clip(base + (255 - base) * highlight_mask * scaled_highlight,
                                  0, 255)
    adjusted = np.clip(adjusted_shadows + adjusted_highlights - base, 0, 255)
    final_lum = np.clip(base * (1 - hdr_intensity) + adjusted * hdr_intensity, 0, 255)
    if gamma_intensity != 0:
        g = 1 / (1.1 - gamma_intensity)
        final_lum = 255 * ((final_lum / 255) ** g)
    lab_out = lab.copy()
    lab_out[..., 0] = final_lum * 100.0 / 255.0
    rgb = _lab_to_srgb(lab_out)
    mean = float(np.mean(rgb @ np.array(LUMA)))
    rgb = np.clip(mean + (rgb - mean) * (1 + contrast), 0, 1)
    gray = (rgb @ np.array(LUMA))[..., None]
    rgb = np.clip(gray + (rgb - gray) * (1 + enhance_color * 0.2), 0, 1)
    return rgb.astype(np.float32)


def _mat3(x: torch.Tensor, m) -> torch.Tensor:
    """(..., 3) times m^T, as three f32 multiply-adds per output channel."""
    return torch.stack([x[..., 0] * row[0] + x[..., 1] * row[1] + x[..., 2] * row[2]
                        for row in m], dim=-1)


def _dot3(x: torch.Tensor, w) -> torch.Tensor:
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def apply_hdr_batch(images, hdr_intensity: float = 0.75, shadow_intensity: float = 0.25,
                    highlight_intensity: float = 0.5, gamma_intensity: float = 0.25,
                    contrast: float = 0.1, enhance_color: float = 0.25) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] images (a tensor, or numpy for the CPU) -> the
    same, f32, on their device."""
    rgb_in = torch.as_tensor(images).float().clamp(0.0, 1.0)
    r = torch.where(rgb_in <= 0.04045, rgb_in / 12.92, ((rgb_in + 0.055) / 1.055) ** 2.4)
    with profiling.span("sync.hdr_white"):
        white = torch.tensor(WHITE_D50, dtype=torch.float32, device=rgb_in.device)
    xyz = _mat3(r, SRGB_TO_XYZ) / white
    f = torch.where(xyz > EPS, _cbrt(xyz), (KAPPA * xyz + 16) / 116)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])

    base = L * 255.0 / 100.0
    scaled_shadow = shadow_intensity**2 * hdr_intensity
    scaled_highlight = highlight_intensity**2 * hdr_intensity
    shadow_mask = torch.clamp((1 - base / 255) ** 2, 0, 1)
    highlight_mask = torch.clamp((base / 255) ** 2, 0, 1)
    adjusted_shadows = torch.clamp(base * (1 - shadow_mask * scaled_shadow), 0, 255)
    adjusted_highlights = torch.clamp(base + (255 - base) * highlight_mask * scaled_highlight,
                                      0, 255)
    adjusted = torch.clamp(adjusted_shadows + adjusted_highlights - base, 0, 255)
    final_lum = torch.clamp(base * (1 - hdr_intensity) + adjusted * hdr_intensity, 0, 255)
    if gamma_intensity != 0:
        final_lum = 255 * ((final_lum / 255) ** (1 / (1.1 - gamma_intensity)))

    fy = (final_lum * 100.0 / 255.0 + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200

    def finv(fv):
        f3 = fv**3
        return torch.where(f3 > EPS, f3, (116 * fv - 16) / KAPPA)

    xyz2 = torch.stack([finv(fx), finv(fy), finv(fz)], dim=-1) * white
    rgb = torch.clamp(_mat3(xyz2, XYZ_TO_SRGB), 0.0, 1.0)
    rgb = torch.where(rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1 / 2.4) - 0.055)

    mean = _dot3(rgb, LUMA).mean(dim=(1, 2), keepdim=True)[..., None]
    rgb = torch.clamp(mean + (rgb - mean) * (1 + contrast), 0, 1)
    gray = _dot3(rgb, LUMA)[..., None]
    return torch.clamp(gray + (rgb - gray) * (1 + enhance_color * 0.2), 0, 1)
