"""ADetailer: detect segments (people, faces) and re-diffuse each one.

Counterpart of lightdiffusion_next_tpu/pipelines/detailer.py: ``SEG``, the
detectors (``UltralyticsDetector`` behind its optional ``ultralytics``
import, ``StaticMaskDetector`` for given masks), ``segs_from_yolo_result``
(the model's segmentation masks where it gives them, else the box),
``dilate_masks``, ``crop_region_with_factor``, ``_bucket_size``,
``DetailerConfig`` and ``Detailer``.

Each segment's crop (its box grown by ``crop_factor``, clipped to the
image) is resized bilinearly to a bucket size (the short side scaled to
``guide_size``, the long side capped at ``max_size``, both snapped up to
multiples of 64, so the UNet sees few distinct shapes), encoded by the
VAE, re-diffused by ``ksample`` under the segment's mask at ``denoise``
(with differential diffusion when ``feather`` > 0), decoded, resized back
and pasted through the feathered mask. The image, the masks, the crops
and the paste are host numpy f32, as in the JAX package; the resizes,
the VAE and the UNet run on the VAE's and the model's device. Detection
runs on the host too.

Two knobs of the JAX signatures are left out because nothing reads them:
``StaticMaskDetector``'s ``threshold_area`` and ``Detailer``'s ``clip``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.pipelines import upscaler
from lightdiffusion_next_tpu_torch.sampling import ksampler as ks
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod


@dataclasses.dataclass
class SEG:
    """One detected segment: its box, crop region, mask and score."""

    bbox: Tuple[int, int, int, int]  # x0, y0, x1, y1
    crop_region: Tuple[int, int, int, int]
    mask: np.ndarray  # (H, W) float over the whole image
    confidence: float
    label: str = ""


def _resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    if mask.shape == (h, w):
        return mask.astype(np.float32)
    m = torch.from_numpy(np.asarray(mask, dtype=np.float32))[None, :, :, None]
    return nn.interpolate_bilinear(m, (h, w))[0, :, :, 0].numpy()


def _polygon_mask(polys, h: int, w: int) -> Optional[np.ndarray]:
    """Rasterize polygon contours (image coordinates) with PIL; None when
    none has three points."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    drew = False
    for poly in polys:
        pts = np.asarray(poly, dtype=np.float32).reshape(-1, 2)
        if len(pts) >= 3:
            draw.polygon([(float(x), float(y)) for x, y in pts], fill=1)
            drew = True
    if not drew:
        return None
    return np.asarray(img, dtype=np.float32)


def segs_from_yolo_result(result, h: int, w: int) -> List[SEG]:
    """An ultralytics result -> SEGs. The mask is, in order of preference:
    the segmentation polygon (``masks.xy``, in image coordinates), the
    segmentation mask (``masks.data``) when its aspect is the image's (it
    is in the letterboxed input space otherwise), the box filled."""
    boxes = np.asarray(result.boxes.xyxy.cpu().numpy())
    confs = np.asarray(result.boxes.conf.cpu().numpy())
    seg_masks = seg_polys = None
    masks = getattr(result, "masks", None)
    if masks is not None:
        try:
            seg_polys = list(masks.xy)
        except Exception:
            seg_polys = None
        try:
            seg_masks = np.asarray(masks.data.cpu().numpy())
        except Exception:
            seg_masks = None
    if seg_masks is not None and len(seg_masks):
        mh, mw = seg_masks.shape[-2:]
        if abs(mh / mw - h / w) > 0.02:
            seg_masks = None

    segs: List[SEG] = []
    for i, (box, conf) in enumerate(zip(boxes, confs)):
        x0, y0, x1, y1 = (int(v) for v in box)
        mask = None
        if seg_polys is not None and i < len(seg_polys):
            mask = _polygon_mask([seg_polys[i]], h, w)
        if mask is None and seg_masks is not None and i < len(seg_masks):
            m = (_resize_mask(seg_masks[i], h, w) > 0.5).astype(np.float32)
            if m.any():
                mask = m
        if mask is None:
            mask = np.zeros((h, w), dtype=np.float32)
            mask[y0:y1, x0:x1] = 1.0
        segs.append(SEG((x0, y0, x1, y1), (x0, y0, x1, y1), mask, float(conf)))
    return segs


class UltralyticsDetector:
    """A YOLO detector from ``model_path``; needs the optional
    ``ultralytics`` package (``RuntimeError`` without it)."""

    def __init__(self, model_path: str):
        try:
            from ultralytics import YOLO
        except ImportError as e:
            raise RuntimeError("ultralytics is not installed; use a provided-mask "
                               "detector") from e
        self.model = YOLO(model_path)

    def detect(self, image: np.ndarray, threshold: float = 0.5) -> List[SEG]:
        from PIL import Image

        pil = Image.fromarray(np.clip(np.asarray(image[0]) * 255, 0, 255).astype(np.uint8))
        pred = self.model(pil, conf=threshold)
        h, w = image.shape[1:3]
        return segs_from_yolo_result(pred[0], h, w)


class StaticMaskDetector:
    """A detector that returns given (H, W) masks, each with its bounding
    box (empty masks dropped)."""

    def __init__(self, masks: Sequence[np.ndarray]):
        self.masks = list(masks)

    def detect(self, image: np.ndarray, threshold: float = 0.5) -> List[SEG]:
        segs = []
        for m in self.masks:
            ys, xs = np.where(m > 0.5)
            if len(ys) == 0:
                continue
            bbox = (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)
            segs.append(SEG(bbox, bbox, m.astype(np.float32), 1.0))
        return segs


def dilate_masks(segs: List[SEG], dilation: int) -> List[SEG]:
    """Each mask dilated by a disc of radius ``dilation`` (a maximum
    filter)."""
    if dilation <= 0:
        return segs
    out = []
    for s in segs:
        m, k = s.mask, dilation
        padded = np.pad(m, k, mode="constant")
        dil = np.zeros_like(m)
        for dy in range(-k, k + 1):
            for dx in range(-k, k + 1):
                if dy * dy + dx * dx > k * k:
                    continue
                dil = np.maximum(dil, padded[k + dy:k + dy + m.shape[0],
                                             k + dx:k + dx + m.shape[1]])
        out.append(dataclasses.replace(s, mask=dil))
    return out


def crop_region_with_factor(bbox: Tuple[int, int, int, int], crop_factor: float,
                            hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """The box grown by ``crop_factor`` about its centre, clipped to the
    image and truncated to ints."""
    x0, y0, x1, y1 = bbox
    bw, bh = x1 - x0, y1 - y0
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    nw, nh = bw * crop_factor, bh * crop_factor
    H, W = hw
    return (int(max(0, cx - nw / 2)), int(max(0, cy - nh / 2)),
            int(min(W, cx + nw / 2)), int(min(H, cy + nh / 2)))


def _bucket_size(w: int, h: int, guide: int, maxs: int) -> Tuple[int, int]:
    """The processing size of a w x h crop: scaled so its short side is
    ``guide``, then down so its long side is at most ``maxs``, each side
    snapped up to a multiple of 64 (at least 64)."""
    scale = guide / max(min(w, h), 1)
    nw, nh = w * scale, h * scale
    if max(nw, nh) > maxs:
        scale = maxs / max(nw, nh)
        nw, nh = nw * scale, nh * scale

    def snap(v):
        return max(64, int(math.ceil(v / 64)) * 64)

    return snap(nw), snap(nh)


@dataclasses.dataclass
class DetailerConfig:
    guide_size: int = 512
    max_size: int = 768
    seed: int = 0
    steps: int = 20
    cfg_scale: float = 7.5
    sampler_name: str = "dpmpp_2m_cfgpp"
    scheduler: str = "karras"
    denoise: float = 0.5
    feather: int = 5
    crop_factor: float = 2.0
    threshold: float = 0.5
    dilation: int = 10
    drop_size: int = 10


class Detailer:
    """Detect and re-diffuse each segment, image by image: ``model`` an
    SD1.5 ``DiffusionModel``, ``vae`` a ``models.vae.VAE``."""

    def __init__(self, model, vae, cfg: Optional[DetailerConfig] = None):
        self.model = model
        self.vae = vae
        self.cfg = cfg if cfg is not None else DetailerConfig()

    def enhance_detail(self, image: np.ndarray, seg: SEG, positive, negative,
                       callback=None) -> np.ndarray:
        """``image`` (1, H, W, 3) host f32 with ``seg`` re-diffused: a new
        array, equal to ``image`` outside the crop region."""
        H, W = image.shape[1:3]
        x0, y0, x1, y1 = crop_region_with_factor(seg.bbox, self.cfg.crop_factor, (H, W))
        crop = image[:, y0:y1, x0:x1, :]
        ch, cw = crop.shape[1:3]
        pw, ph = _bucket_size(cw, ch, self.cfg.guide_size, self.cfg.max_size)

        dev = self.vae.device
        up = nn.interpolate_bilinear(torch.from_numpy(np.ascontiguousarray(crop)).to(dev),
                                     (ph, pw))
        latent = self.vae.encode(up)
        m = np.ascontiguousarray(seg.mask[y0:y1, x0:x1], dtype=np.float32)
        m_lat = nn.interpolate_bilinear(torch.from_numpy(m)[None, :, :, None].to(dev),
                                        (latent.shape[1], latent.shape[2]))
        result = ks.ksample(
            self.model,
            seed=self.cfg.seed,
            steps=self.cfg.steps,
            cfg_scale=self.cfg.cfg_scale,
            sampler_name=self.cfg.sampler_name,
            scheduler=self.cfg.scheduler,
            positive=positive,
            negative=negative,
            latent_image=latent,
            denoise=self.cfg.denoise,
            denoise_mask=m_lat,
            # as the reference, whenever the paste is feathered
            differential_diffusion=self.cfg.feather > 0,
            callback=callback,
        )
        decoded = self.vae.decode(result.latent)
        back = nn.interpolate_bilinear(decoded, (ch, cw)).cpu().numpy()

        paste_mask = m
        if self.cfg.feather > 0:
            paste_mask = upscaler._feather(paste_mask, self.cfg.feather)
        paste_mask = paste_mask[None, :, :, None]
        out = image.copy()
        out[:, y0:y1, x0:x1, :] = back * paste_mask + crop * (1 - paste_mask)
        return out

    def detail(self, image: np.ndarray, detector, positive, negative, sam=None,
               callback=None) -> Tuple[np.ndarray, List[SEG]]:
        """Detect and enhance each image of the batch on its own detections
        (SAM-refined when ``sam`` is given; segments under ``drop_size``
        dropped); stops between segments when ``callback``'s
        ``should_stop`` says so. Returns (the images, every kept SEG)."""
        out = np.asarray(image, dtype=np.float32).copy()
        all_segs: List[SEG] = []
        for bi in range(out.shape[0]):
            frame = out[bi:bi + 1]
            segs = dilate_masks(detector.detect(frame, self.cfg.threshold), self.cfg.dilation)
            if sam is not None:
                from lightdiffusion_next_tpu_torch.pipelines.sam import (
                    make_sam_mask,
                    segs_bitwise_and_mask,
                )

                segs = segs_bitwise_and_mask(segs, make_sam_mask(sam, segs, frame))
            segs = [s for s in segs
                    if (s.bbox[2] - s.bbox[0]) >= self.cfg.drop_size
                    and (s.bbox[3] - s.bbox[1]) >= self.cfg.drop_size]
            for seg in segs:
                if samplers_mod.callback_requests_stop(callback):
                    return out, all_segs
                frame = self.enhance_detail(frame, seg, positive, negative, callback)
            out[bi] = frame[0]
            all_segs.extend(segs)
        return out, all_segs
