"""SAM mask refinement for ADetailer.

Counterpart of lightdiffusion_next_tpu/pipelines/sam.py: ``center_of_bbox``,
``SAMWrapper`` (needs the optional ``segment_anything`` package,
``RuntimeError`` without it), ``make_sam_mask`` (one mask from the
per-segment predictions with a centre-point hint) and
``segs_bitwise_and_mask``. SAM runs on the host, beside the detector, as in
the JAX package; without it the detector's masks pass through.

``make_sam_mask`` has the one setting the pipeline gives the JAX function
(``detection_hint="center-1"``, ``dilation=0``, ``threshold=0.93``) built in
rather than as arguments.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from lightdiffusion_next_tpu_torch.pipelines.detailer import SEG

# the least score of a SAM mask that is used
SAM_THRESHOLD = 0.93


def center_of_bbox(bbox) -> tuple:
    x0, y0, x1, y1 = bbox
    return ((x0 + x1) / 2, (y0 + y1) / 2)


class SAMWrapper:
    """The SAM predictor from a checkpoint (``model_type`` "vit_b" for
    sam_vit_b_01ec64.pth)."""

    def __init__(self, model_path: str, model_type: str = "vit_b"):
        try:
            from segment_anything import SamPredictor, sam_model_registry
        except ImportError as e:
            raise RuntimeError("segment-anything is not installed") from e
        sam = sam_model_registry[model_type](checkpoint=model_path)
        self.predictor = SamPredictor(sam)
        self._image_key = None

    def set_image(self, image_u8: np.ndarray) -> None:
        """Run the image encoder once per distinct image: it is SAM's main
        cost, the same for every segment of a frame."""
        key = (image_u8.shape, hashlib.md5(image_u8.tobytes()).hexdigest())
        if key != self._image_key:
            self.predictor.set_image(image_u8)
            self._image_key = key

    def predict(self, image_u8: np.ndarray, points: Optional[Sequence] = None,
                labels: Optional[Sequence] = None,
                bbox: Optional[Sequence] = None) -> Optional[np.ndarray]:
        """The best-scoring mask at or above ``SAM_THRESHOLD`` (f32), or
        None."""
        self.set_image(image_u8)
        masks, scores, _ = self.predictor.predict(
            point_coords=np.asarray(points) if points else None,
            point_labels=np.asarray(labels) if labels else None,
            box=np.asarray(bbox) if bbox is not None else None,
        )
        best, best_score = None, SAM_THRESHOLD
        for m, s in zip(masks, scores):
            if s >= best_score:
                best, best_score = m, s
        return best.astype(np.float32) if best is not None else None


def make_sam_mask(sam: Optional[SAMWrapper], segs: List[SEG],
                  image: np.ndarray) -> Optional[np.ndarray]:
    """The maximum of SAM's per-segment masks over ``image`` (1, H, W, 3) in
    [0, 1], each predicted from the segment's box and its centre as a
    positive point; None without SAM or segments."""
    if sam is None or not segs:
        return None
    img_u8 = np.clip(image[0] * 255, 0, 255).astype(np.uint8)
    H, W = img_u8.shape[:2]
    total = np.zeros((H, W), dtype=np.float32)
    for seg in segs:
        mask = sam.predict(img_u8, [center_of_bbox(seg.bbox)], [1], seg.bbox)
        if mask is not None:
            total = np.maximum(total, mask)
    return total


def segs_bitwise_and_mask(segs: List[SEG], mask: Optional[np.ndarray]) -> List[SEG]:
    """Each segment's mask ANDed (minimum) with ``mask``; unchanged for
    None."""
    if mask is None:
        return segs
    return [SEG(seg.bbox, seg.crop_region, np.minimum(seg.mask, mask.astype(np.float32)),
                seg.confidence, seg.label) for seg in segs]
