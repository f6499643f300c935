"""UltimateSDUpscale: the model upscale, a tiled img2img redraw and the
half-tile seam fix.

Counterpart of lightdiffusion_next_tpu/pipelines/upscaler.py (``USDUConfig``,
``UltimateSDUpscale``), with the same choices:

- each redraw tile is denoised on its padded crop: the tile grown by
  ``padding`` on both sides, matched to the model tile's aspect and grown
  inside the image to at least the model tile (``region_for_rect``), whose
  static shape is ceil((tile + 2 * padding) / 8) * 8, clamped to the image
  (``_model_tile``); only crops of images smaller than that are resized;
- only the feathered tile rectangle is composited back, in place, into the
  pass's own copy of the image;
- the seam pass runs half-tile offset bands between rows, then between
  columns, with triangular band masks, its own denoise and padding
  (``seam_fix_denoise``, ``seam_fix_padding``);
- the mask feathering is a box blur by cumulative sums (a stand-in for the
  reference's Gaussian blur), restricted to the rectangle plus twice the
  blur.

The image, its masks and the composite are host numpy f32, as in the JAX
package (the mask code is a copy of its); each crop goes to the VAE's
device for the encode, the sampler and the decode, and comes back. At
2048^2 with the default 512 tiles that is 16 redraw and 24 seam tiles of
576^2 (a 72 x 72 latent).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.sampling import ksampler as ks
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod


@dataclasses.dataclass
class USDUConfig:
    upscale_by: float = 2.0
    tile_width: int = 512
    tile_height: int = 512
    mask_blur: int = 8
    padding: int = 32
    seam_fix_mode: str = "half_tile"  # "none" | "half_tile"
    seam_fix_denoise: float = 0.2
    seam_fix_mask_blur: int = 16
    seam_fix_padding: int = 32


def _box_blur_1d(arr: np.ndarray, radius: int, axis: int) -> np.ndarray:
    """Mean filter over a 2r+1 window by cumulative sums, clamped at the
    edges."""
    if radius <= 0:
        return arr
    arr = np.moveaxis(arr, axis, 0)
    n = arr.shape[0]
    csum = np.cumsum(arr, axis=0, dtype=np.float64)
    csum = np.concatenate([np.zeros_like(csum[:1]), csum], axis=0)
    idx = np.arange(n)
    hi = np.minimum(idx + radius + 1, n)
    lo = np.maximum(idx - radius, 0)
    out = (csum[hi] - csum[lo]) / (hi - lo).reshape((-1,) + (1,) * (arr.ndim - 1))
    return np.moveaxis(out.astype(np.float32), 0, axis)


def _feather(mask: np.ndarray, blur: int) -> np.ndarray:
    """Separable box blur of a mask."""
    if blur <= 0:
        return mask.astype(np.float32)
    out = _box_blur_1d(mask.astype(np.float32), blur, 0)
    out = _box_blur_1d(out, blur, 1)
    return np.clip(out, 0.0, 1.0)


def _feather_rect(mask: np.ndarray, blur: int, rect) -> np.ndarray:
    """Feather a mask that is zero outside ``rect``, blurring only the
    rectangle plus twice the blur (in place)."""
    if blur <= 0:
        return mask.astype(np.float32)
    x1, y1, x2, y2 = rect
    ry1, ry2 = max(y1 - 2 * blur, 0), min(y2 + 2 * blur, mask.shape[0])
    rx1, rx2 = max(x1 - 2 * blur, 0), min(x2 + 2 * blur, mask.shape[1])
    mask = mask.astype(np.float32)
    mask[ry1:ry2, rx1:rx2] = _feather(mask[ry1:ry2, rx1:rx2], blur)
    return mask


def expand_region(region: Tuple[int, int, int, int], W: int, H: int, target_w: int,
                  target_h: int) -> Tuple[int, int, int, int]:
    """Grow a region to (target_w, target_h) inside the image, the half that
    does not fit spilling to the other side."""
    x1, y1, x2, y2 = region
    x2 = min(x2 + (target_w - (x2 - x1)) // 2, W)
    x1 = max(x1 - (target_w - (x2 - x1)), 0)
    x2 = min(x2 + (target_w - (x2 - x1)), W)
    y2 = min(y2 + (target_h - (y2 - y1)) // 2, H)
    y1 = max(y1 - (target_h - (y2 - y1)), 0)
    y2 = min(y2 + (target_h - (y2 - y1)), H)
    return x1, y1, x2, y2


def region_for_rect(rect: Tuple[int, int, int, int], W: int, H: int, pad: int,
                    model_w: int, model_h: int) -> Tuple[int, int, int, int]:
    """A tile rectangle -> the crop it is denoised on: padded, matched to
    the model tile's aspect, grown in the image to at least the model
    tile."""
    x1 = max(rect[0] - pad, 0)
    y1 = max(rect[1] - pad, 0)
    x2 = min(rect[2] + pad, W)
    y2 = min(rect[3] + pad, H)
    cw, ch = x2 - x1, y2 - y1
    p_ratio = model_w / model_h
    if cw / max(ch, 1) > p_ratio:
        target_w, target_h = cw, round(cw / p_ratio)
    else:
        target_w, target_h = round(ch * p_ratio), ch
    target_w = max(target_w, min(model_w, W))
    target_h = max(target_h, min(model_h, H))
    return expand_region((x1, y1, x2, y2), W, H, target_w, target_h)


def _tri(n: int) -> np.ndarray:
    """A band's profile: 0 up to 1 at the middle and back to 0."""
    return np.concatenate([np.linspace(0, 1, n // 2, dtype=np.float32),
                           np.linspace(1, 0, n - n // 2, dtype=np.float32)])


class UltimateSDUpscale:
    """Upscale with ``upscale_model`` (an ``esrgan.UpscaleModel``, or none),
    then redraw and seam-fix with ``model`` (an SD1.5 ``DiffusionModel``)
    and ``vae``."""

    def __init__(self, model, vae, upscale_model=None, cfg: Optional[USDUConfig] = None):
        self.model = model
        self.vae = vae
        self.upscale_model = upscale_model
        self.cfg = cfg if cfg is not None else USDUConfig()

    def model_upscale(self, image: np.ndarray) -> np.ndarray:
        """The model's upscale (x4 for ESRGAN), resized to ``upscale_by``,
        clipped to [0, 1]; host numpy."""
        target_h = int(image.shape[1] * self.cfg.upscale_by)
        target_w = int(image.shape[2] * self.cfg.upscale_by)
        up = torch.as_tensor(image)
        if self.upscale_model is not None:
            up = self.upscale_model.upscale(up)
        if up.shape[1] != target_h or up.shape[2] != target_w:
            up = self._resize(up, target_h, target_w)
        return np.clip(up.cpu().numpy(), 0.0, 1.0)

    @staticmethod
    def _resize(img, h: int, w: int):
        """Bilinear resize (torch's, align_corners=False), numpy or a tensor
        in, the same kind out."""
        if isinstance(img, torch.Tensor):
            return nn.interpolate_bilinear(img, (h, w))
        return nn.interpolate_bilinear(torch.from_numpy(np.asarray(img)), (h, w)).numpy()

    def _model_tile(self, image: np.ndarray, pad: int) -> Tuple[int, int]:
        """The static denoise shape: ceil((tile + 2 * pad) / 8) * 8, clamped
        to the image."""
        H, W = image.shape[1:3]
        mh = math.ceil((self.cfg.tile_height + 2 * pad) / 8) * 8
        mw = math.ceil((self.cfg.tile_width + 2 * pad) / 8) * 8
        return min(mh, H // 8 * 8 or H), min(mw, W // 8 * 8 or W)

    def _grid(self, image: np.ndarray) -> Tuple[int, int]:
        """Rows and columns of config-sized tiles."""
        H, W = image.shape[1:3]
        return (max(1, math.ceil(H / self.cfg.tile_height)),
                max(1, math.ceil(W / self.cfg.tile_width)))

    def _process_region(self, image, mask_full, rect, model_hw, pad, positive, negative,
                        seed, steps, cfg_scale, sampler_name, scheduler, denoise,
                        callback=None):
        """One tile: the padded crop (resized to the model tile if it differs)
        -> encode -> ksample -> decode -> (resized back) -> composited into
        ``image`` in place through ``mask_full``."""
        H, W = image.shape[1:3]
        mh, mw = model_hw
        x1, y1, x2, y2 = region_for_rect(rect, W, H, pad, mw, mh)
        crop = image[:, y1:y2, x1:x2, :]
        resized = crop.shape[1:3] != (mh, mw)
        crop_in = self._resize(crop, mh, mw) if resized else crop

        latent = self.vae.encode(crop_in)
        result = ks.ksample(self.model, seed=seed, steps=steps, cfg_scale=cfg_scale,
                            sampler_name=sampler_name, scheduler=scheduler,
                            positive=positive, negative=negative, latent_image=latent,
                            denoise=denoise, callback=callback)
        decoded = self.vae.decode(result.latent)
        if resized:
            decoded = self._resize(decoded, y2 - y1, x2 - x1)
        decoded = decoded.cpu().numpy()
        m = mask_full[y1:y2, x1:x2][None, :, :, None]
        image[:, y1:y2, x1:x2, :] = decoded * m + crop * (1.0 - m)
        return image

    def redraw(self, image, positive, negative, seed, steps, cfg_scale, sampler_name,
               scheduler, denoise, callback=None) -> np.ndarray:
        """Each tile rectangle masked, feathered and denoised on its padded
        crop, row by row, into a copy of ``image``."""
        image = np.array(image, dtype=np.float32)
        H, W = image.shape[1:3]
        rows, cols = self._grid(image)
        model_hw = self._model_tile(image, self.cfg.padding)
        for yi in range(rows):
            for xi in range(cols):
                rect = (xi * self.cfg.tile_width, yi * self.cfg.tile_height,
                        min((xi + 1) * self.cfg.tile_width, W),
                        min((yi + 1) * self.cfg.tile_height, H))
                if rect[0] >= rect[2] or rect[1] >= rect[3]:
                    continue
                if samplers_mod.callback_requests_stop(callback):
                    return image
                mask = np.zeros((H, W), dtype=np.float32)
                mask[rect[1]:rect[3], rect[0]:rect[2]] = 1.0
                mask = _feather_rect(mask, self.cfg.mask_blur, rect)
                image = self._process_region(image, mask, rect, model_hw, self.cfg.padding,
                                             positive, negative, seed, steps, cfg_scale,
                                             sampler_name, scheduler, denoise, callback)
        return image

    def seam_fix(self, image, positive, negative, seed, steps, cfg_scale, sampler_name,
                 scheduler, callback=None) -> np.ndarray:
        """Half-tile offset bands over the seams between rows, then between
        columns, into a copy of ``image``."""
        if self.cfg.seam_fix_mode == "none":
            return image
        image = np.array(image, dtype=np.float32)
        H, W = image.shape[1:3]
        rows, cols = self._grid(image)
        tw = min(self.cfg.tile_width, W)
        th = min(self.cfg.tile_height, H)
        model_hw = self._model_tile(image, self.cfg.seam_fix_padding)

        def band_pass(rect, band: np.ndarray):
            x1, y1, x2, y2 = rect
            if x1 >= x2 or y1 >= y2 or samplers_mod.callback_requests_stop(callback):
                return image
            mask = np.zeros((H, W), dtype=np.float32)
            mask[y1:y2, x1:x2] = band[:y2 - y1, :x2 - x1]
            mask = _feather_rect(mask, self.cfg.seam_fix_mask_blur, rect)
            return self._process_region(image, mask, rect, model_hw, self.cfg.seam_fix_padding,
                                        positive, negative, seed, steps, cfg_scale,
                                        sampler_name, scheduler, self.cfg.seam_fix_denoise,
                                        callback)

        h_band = np.tile(_tri(th)[:, None], (1, tw))  # peaks along y
        for yi in range(rows - 1):
            for xi in range(cols):
                x1 = xi * self.cfg.tile_width
                y1 = yi * self.cfg.tile_height + self.cfg.tile_height // 2
                image = band_pass((x1, y1, min(x1 + tw, W), min(y1 + th, H)), h_band)
        v_band = np.tile(_tri(tw)[None, :], (th, 1))  # peaks along x
        for yi in range(rows):
            for xi in range(cols - 1):
                x1 = xi * self.cfg.tile_width + self.cfg.tile_width // 2
                y1 = yi * self.cfg.tile_height
                image = band_pass((x1, y1, min(x1 + tw, W), min(y1 + th, H)), v_band)
        return image

    def upscale(self, image, positive, negative, seed: int = 0, steps: int = 8,
                cfg_scale: float = 6.0, sampler_name: str = "dpmpp_2m_cfgpp",
                scheduler: str = "karras", denoise: float = 0.3,
                callback=None) -> np.ndarray:
        """The model upscale, the redraw, the seam fix: (B, H, W, 3) in
        [0, 1] -> (B, H * upscale_by, W * upscale_by, 3), host numpy."""
        image = self.model_upscale(np.asarray(image, dtype=np.float32))
        image = self.redraw(image, positive, negative, seed, steps, cfg_scale, sampler_name,
                            scheduler, denoise, callback)
        return self.seam_fix(image, positive, negative, seed, steps, cfg_scale, sampler_name,
                             scheduler, callback)
