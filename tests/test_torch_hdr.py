"""The port's AutoHDR against the JAX package's.

``apply_hdr_batch`` (f32, on the images' device) is held within 1e-5 of the
JAX package's jitted ``apply_hdr_batch`` and within 1e-4 of the float64
``apply_hdr`` oracle: the 3x3 transforms are three multiply-adds per
channel where XLA may fuse them, the cube root goes through ``pow`` (an
ulp from ``jnp.cbrt``), and the per-image mean sums in another order.
The inputs sit on the edges of the piecewise laws: the sRGB knee (0.04045),
the grays whose luminance is the Lab epsilon (216/24389), 0 and 1, and
random pixels; each image of a batch gets its own mean.
"""

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.utils import hdr as jhdr
from lightdiffusion_next_tpu_torch.utils import hdr as thdr


def _eps_gray():
    """The sRGB gray whose linear value is the Lab epsilon."""
    lin = 216 / 24389
    return 1.055 * lin ** (1 / 2.4) - 0.055


def _images():
    rng = np.random.default_rng(0)
    knee, eps = 0.04045, _eps_gray()
    edges = np.array([0.0, 1.0, knee, np.nextafter(np.float32(knee), 1, dtype=np.float32),
                      np.nextafter(np.float32(knee), 0, dtype=np.float32), eps,
                      eps * (1 + 1e-6), eps * (1 - 1e-6), 0.5], np.float32)
    a = rng.random((2, 12, 10, 3)).astype(np.float32)
    a[0, :3, :3] = edges[:9].reshape(3, 3, 1)  # grays on the edges
    a[0, 3, :9] = np.stack([edges, np.roll(edges, 1), np.roll(edges, 2)], -1)
    a[1] *= 0.2  # a dark image: another mean, most pixels in the linear branches
    return a


@pytest.mark.parametrize("kwargs", [{}, dict(gamma_intensity=0.0, contrast=0.3),
                                    dict(hdr_intensity=1.0, enhance_color=1.0)])
def test_apply_hdr_batch_matches_jax_and_oracle(kwargs):
    imgs = _images()
    out = thdr.apply_hdr_batch(torch.from_numpy(imgs), **kwargs)
    assert out.dtype == torch.float32 and out.shape == imgs.shape
    out = out.numpy()
    ref = jhdr.apply_hdr_batch(imgs, **kwargs)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    oracle = np.stack([jhdr.apply_hdr(im, **kwargs) for im in imgs])
    np.testing.assert_allclose(out, oracle, atol=1e-4, rtol=0)


def test_float64_oracle_matches_jax():
    imgs = _images()
    for im in imgs:
        np.testing.assert_allclose(thdr.apply_hdr(im), jhdr.apply_hdr(im), atol=1e-12, rtol=0)


def test_lab_round_trip():
    rgb = np.random.default_rng(1).random((8, 8, 3))
    back = thdr._lab_to_srgb(thdr._srgb_to_lab(rgb))
    np.testing.assert_allclose(back, rgb, atol=1e-6)


def test_per_image_mean():
    """A batch is the images done one at a time (to 2e-6: the mean's sum
    runs in another order over a batch)."""
    imgs = _images()
    both = thdr.apply_hdr_batch(imgs).numpy()
    for i in range(len(imgs)):
        np.testing.assert_allclose(both[i], thdr.apply_hdr_batch(imgs[i:i + 1]).numpy()[0],
                                   atol=2e-6, rtol=0)
