"""ADetailer (``pipelines.detailer``, ``pipelines.sam``) in the port against
the JAX package.

- Host code, equal to the JAX package's: ``segs_from_yolo_result`` on fake
  ultralytics results (segmentation masks, polygons, letterboxed data, box
  fill; tests/test_detailer_masks.py's), ``dilate_masks``,
  ``crop_region_with_factor`` and ``_bucket_size`` over a grid of boxes
  and crops (the bucket exactly: it sets the UNet's shapes), SAM's
  ``make_sam_mask`` and ``segs_bitwise_and_mask`` with a fake predictor,
  ``StaticMaskDetector``; the optional packages' absence raises
  ``RuntimeError`` in both.
- ``Detailer.detail`` with ``StaticMaskDetector`` on the tiny UNet and VAE
  (tests/test_torch_img2img.py's) against the JAX ``Detailer``: two images,
  each with its own segments (a square and a non-square bucket), 3 steps:
  images to 1e-4 relative RMS and within one uint8 level; the pixels
  outside every crop region bit for bit the input, those inside a mask
  changed; the loop stops between segments through ``should_stop``.
- The whole flows (``pipeline(..., adetailer=True)``, the CLI) are in
  tests/test_torch_adetailer_previews.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.base import sd15_model as jsd15_model
from lightdiffusion_next_tpu.pipelines import detailer as jdet
from lightdiffusion_next_tpu.pipelines import sam as jsam
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.base import sd15_model as tsd15_model
from lightdiffusion_next_tpu_torch.pipelines import detailer as tdet
from lightdiffusion_next_tpu_torch.pipelines import sam as tsam
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.utils import image as timage

VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
                 transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
                 num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_rmse(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)))


def _same_segs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.bbox, g.crop_region, g.confidence, g.label) == (
            w.bbox, w.crop_region, w.confidence, w.label)
        np.testing.assert_array_equal(g.mask, w.mask)


# --------------------------------------------------------------------------
# Host code
# --------------------------------------------------------------------------


class _T:
    """A torch tensor's stand-in with .cpu().numpy()."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)

    def cpu(self):
        return self

    def numpy(self):
        return self._arr


class _Boxes:
    def __init__(self, xyxy, conf):
        self.xyxy, self.conf = _T(xyxy), _T(conf)


class _Masks:
    def __init__(self, data, xy=None):
        self.data = _T(data)
        if xy is not None:
            self.xy = xy


class _Result:
    def __init__(self, xyxy, conf, masks=None):
        self.boxes = _Boxes(xyxy, conf)
        self.masks = masks


def _results():
    yy, xx = np.mgrid[0:32, 0:32]
    circle = (((yy - 16) ** 2 + (xx - 16) ** 2) <= 10**2).astype(np.float32)
    tri = np.asarray([[10.0, 10.0], [40.0, 10.0], [10.0, 40.0]])
    return {
        "segm": (_Result([[8.0, 8.0, 56.0, 56.0], [2.5, 3.7, 20.2, 9.9]], [0.9, 0.4],
                         _Masks(np.stack([circle, circle[::-1]]))), 64, 64),
        "box": (_Result([[4.0, 6.0, 20.0, 30.0]], [0.7]), 64, 64),
        "empty_segm": (_Result([[4.0, 4.0, 12.0, 12.0]], [0.5],
                               _Masks(np.zeros((1, 64, 64), np.float32))), 64, 64),
        "polygon": (_Result([[10.0, 10.0, 40.0, 40.0]], [0.8],
                            _Masks(np.ones((1, 64, 64), np.float32), xy=[tri])), 48, 96),
        "letterboxed": (_Result([[8.0, 8.0, 24.0, 24.0]], [0.6],
                                _Masks(np.ones((1, 64, 64), np.float32))), 48, 96),
    }


@pytest.mark.parametrize("case", sorted(_results()))
def test_segs_from_yolo_result_equal_jax(case):
    result, h, w = _results()[case]
    got = tdet.segs_from_yolo_result(result, h, w)
    _same_segs(got, jdet.segs_from_yolo_result(result, h, w))
    assert all(s.mask.shape == (h, w) and s.mask.dtype == np.float32 for s in got)


def test_dilate_and_static_detector_equal_jax():
    rng = np.random.default_rng(3)
    masks = [(rng.random((40, 56)) > 0.97).astype(np.float32), np.zeros((40, 56), np.float32)]
    masks[1][10:20, 5:30] = 0.7
    img = np.zeros((1, 40, 56, 3), np.float32)
    got = tdet.StaticMaskDetector(masks).detect(img)
    want = jdet.StaticMaskDetector(masks).detect(img)
    _same_segs(got, want)
    assert len(got) == 2 and got[1].bbox == (5, 10, 30, 20)
    for k in (0, 1, 3, 10):
        _same_segs(tdet.dilate_masks(got, k), jdet.dilate_masks(want, k))
    assert tdet.StaticMaskDetector([np.zeros((8, 8), np.float32)]).detect(img) == []


def test_crop_regions_and_buckets_equal_jax():
    """Every box of a grid, clipped at the borders, and every crop size of a
    grid (thin, square, capped at 768): the same crop region and bucket."""
    for H, W in ((1024, 1024), (768, 1280), (1000, 600)):
        for x0 in range(0, W, 97):
            for y0 in range(0, H, 89):
                for bw, bh in ((7, 9), (60, 80), (150, 110), (333, 517), (900, 40)):
                    bbox = (x0, y0, min(W, x0 + bw), min(H, y0 + bh))
                    for f in (1.0, 1.5, 2.0, 3.0):
                        got = tdet.crop_region_with_factor(bbox, f, (H, W))
                        assert got == jdet.crop_region_with_factor(bbox, f, (H, W))
    for w in list(range(1, 40, 3)) + list(range(40, 1400, 23)):
        for h in list(range(1, 40, 7)) + list(range(40, 1400, 37)):
            for guide, maxs in ((512, 768), (64, 128)):
                got = tdet._bucket_size(w, h, guide, maxs)
                assert got == jdet._bucket_size(w, h, guide, maxs), (w, h)
                assert got[0] % 64 == 0 and got[1] % 64 == 0
                assert max(got) <= max(maxs, 64) + 64
    assert tdet._bucket_size(400, 500, 512, 768) == (512, 640)
    assert tdet._bucket_size(300, 600, 512, 768) == (384, 768)


class _FakePredictor:
    """segment_anything's SamPredictor stand-in: three masks around the
    point hint, scored by their size (``low``: every score under 0.93)."""

    def __init__(self, low=False):
        self.images, self.low = 0, low

    def set_image(self, image):
        self.images += 1
        self.shape = image.shape[:2]

    def predict(self, point_coords=None, point_labels=None, box=None):
        h, w = self.shape
        cx, cy = point_coords[0]
        masks, scores = [], []
        for r, s in ((3, 0.95), (6, 0.97), (12, 0.9)):
            yy, xx = np.mgrid[0:h, 0:w]
            masks.append(((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r)
            scores.append(s - 0.1 if self.low else s)
        return np.stack(masks), np.asarray(scores), None


def _sam(mod, low):
    sam = object.__new__(mod.SAMWrapper)
    sam.predictor, sam._image_key = _FakePredictor(low), None
    return sam


@pytest.mark.parametrize("low_scores", [False, True])
def test_sam_mask_and_bitwise_and_equal_jax(low_scores):
    """The port's ``make_sam_mask`` has the JAX defaults built in (the
    centre hint, no dilation, threshold 0.93): equal to the JAX function
    called with them, with masks above the threshold and with none."""
    rng = np.random.default_rng(4)
    image = rng.random((1, 32, 40, 3)).astype(np.float32)
    masks = [np.zeros((32, 40), np.float32), np.zeros((32, 40), np.float32)]
    masks[0][4:20, 6:18] = 1.0
    masks[1][10:30, 20:38] = 0.8
    tsegs = tdet.StaticMaskDetector(masks).detect(image)
    jsegs = jdet.StaticMaskDetector(masks).detect(image)
    tsam_, jsam_ = _sam(tsam, low_scores), _sam(jsam, low_scores)
    got = tsam.make_sam_mask(tsam_, tsegs, image)
    want = jsam.make_sam_mask(jsam_, jsegs, image, detection_hint="center-1", dilation=0,
                              threshold=0.93)
    np.testing.assert_array_equal(got, want)
    assert got.any() != low_scores
    assert tsam_.predictor.images == 1  # one image encode for both segments
    _same_segs(tsam.segs_bitwise_and_mask(tsegs, got), jsam.segs_bitwise_and_mask(jsegs, want))
    assert tsam.make_sam_mask(None, tsegs, image) is None
    assert tsam.make_sam_mask(tsam_, [], image) is None
    assert tsam.segs_bitwise_and_mask(tsegs, None) is tsegs
    assert tsam.center_of_bbox((2, 4, 7, 10)) == jsam.center_of_bbox((2, 4, 7, 10)) == (4.5, 7.0)


def test_optional_packages_raise_runtime_error(tmp_path):
    for mod in (tdet, jdet):
        with pytest.raises(RuntimeError, match="ultralytics"):
            mod.UltralyticsDetector(str(tmp_path / "x.pt"))
    for mod in (tsam, jsam):
        with pytest.raises(RuntimeError, match="segment-anything"):
            mod.SAMWrapper(str(tmp_path / "x.pth"))


# --------------------------------------------------------------------------
# Detailer.detail on the tiny models
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def detail_runs():
    """Both packages' ``Detailer.detail`` on two 96 x 128 images: image 0
    with a square and a non-square segment, image 1 with one segment."""
    unet_p = junet.init_params(junet.UNetConfig(**TINY_UNET), seed=0)
    vae_p = jvae.init_params(jvae.VAEConfig(**VAE_CFG), seed=1)
    rng = np.random.default_rng(5)
    c, u = (rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2))
    image = rng.random((2, 96, 128, 3)).astype(np.float32)
    masks = [np.zeros((96, 128), np.float32) for _ in range(2)]
    masks[0][20:44, 24:48] = 1.0
    masks[1][50:90, 70:90] = 1.0

    class PerImage:
        """Image 0 gets both masks, image 1 the second only."""

        def __init__(self, mod):
            self.mod, self.calls = mod, 0

        def detect(self, frame, threshold):
            self.calls += 1
            return self.mod.StaticMaskDetector(masks if self.calls == 1 else masks[1:]).detect(
                frame, threshold)

    cfg = dict(steps=3, guide_size=64, max_size=128, denoise=0.5, seed=5, dilation=2)
    jd = jdet.Detailer(jsd15_model(unet_p, cfg=junet.UNetConfig(**TINY_UNET)), None,
                       jvae.VAE(vae_p, jvae.VAEConfig(**VAE_CFG)), jdet.DetailerConfig(**cfg))
    ref, jsegs = jd.detail(image, PerImage(jdet), jcfg.CondInput(jnp.asarray(c)),
                           jcfg.CondInput(jnp.asarray(u)))
    td = tdet.Detailer(tsd15_model(from_jax(unet_p), cfg=tunet.UNetConfig(**TINY_UNET),
                                   device="cpu"),
                       tvae.VAE(from_jax(vae_p), tvae.VAEConfig(**VAE_CFG), device="cpu"),
                       tdet.DetailerConfig(**cfg))
    conds = (tcfg.CondInput(torch.from_numpy(c)), tcfg.CondInput(torch.from_numpy(u)))
    out, segs = td.detail(image, PerImage(tdet), *conds)
    return dict(image=image, out=out, segs=segs, ref=ref, jsegs=jsegs, td=td, conds=conds,
                masks=masks, PerImage=PerImage)


def test_detail_matches_jax(detail_runs):
    r = detail_runs
    _same_segs(r["segs"], r["jsegs"])
    assert len(r["segs"]) == 3
    assert r["out"].shape == r["image"].shape and r["out"].dtype == np.float32
    assert _rel_rmse(r["out"], r["ref"]) < 1e-4
    diff = timage.to_uint8(r["out"]).astype(int) - timage.to_uint8(r["ref"])
    assert np.abs(diff).max() <= 1


def test_detail_buckets(detail_runs):
    """The crops' buckets: 48 x 48 -> (64, 64); 26 x 84 clipped at the
    border -> a non-square bucket."""
    H, W = detail_runs["image"].shape[1:3]
    cfg = detail_runs["td"].cfg
    sizes = []
    for seg in detail_runs["segs"]:
        x0, y0, x1, y1 = tdet.crop_region_with_factor(seg.bbox, cfg.crop_factor, (H, W))
        sizes.append(tdet._bucket_size(x1 - x0, y1 - y0, cfg.guide_size, cfg.max_size))
    assert sizes[0] == (64, 64) and sizes[1][0] != sizes[1][1]


def test_detail_changes_only_the_crops(detail_runs):
    r = detail_runs
    H, W = r["image"].shape[1:3]
    cfg = r["td"].cfg
    for bi, segs in ((0, r["segs"][:2]), (1, r["segs"][2:])):
        outside = np.ones((H, W), bool)
        for seg in segs:
            x0, y0, x1, y1 = tdet.crop_region_with_factor(seg.bbox, cfg.crop_factor, (H, W))
            outside[y0:y1, x0:x1] = False
            inside = seg.mask > 0.5
            assert np.abs(r["out"][bi][inside] - r["image"][bi][inside]).mean() > 1e-3
        np.testing.assert_array_equal(r["out"][bi][outside], r["image"][bi][outside])


def test_detail_stops_between_segments(detail_runs):
    r = detail_runs
    steps = []

    class Hook:
        def __call__(self, info):
            steps.append(info["i"])

        def should_stop(self):
            return len(steps) >= 3

    # as in the JAX package, the image whose segments were cut short comes
    # back as it was, and the images after it are not started
    out, segs = r["td"].detail(r["image"], r["PerImage"](tdet), *r["conds"], callback=Hook())
    assert steps == [0, 1, 2] and segs == []
    np.testing.assert_array_equal(out, r["image"])
