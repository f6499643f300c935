"""SD1.5 img2img with UltimateSDUpscale in the port against the JAX
package: its modules, USDU end to end, then the whole flow.

- ``load_image``: the port's standard-library PNG decoder against PIL, bit
  for bit (gray, RGB, RGBA; rows under each of the five filters).
- f32 forwards, atol/rtol 1e-4: the VAE encoder and ``VAE.encode`` (mode
  and sample), ``decode_tiled`` (against the JAX package's, and against
  ``decode`` where one tile covers the latent), ESRGAN at ``num_body=2``,
  ``tiled_apply_2d`` (exact on an identity function without overlap).
- The torch file loader on RealESRGAN's ``params_ema`` nesting.
- USDU end to end on a 64-pixel image with 32-pixel tiles and a tiny
  ESRGAN: 16 redraw and 24 seam tiles, each started from the JAX package's
  image before it (the test says why). The PNGs within one uint8 level,
  every tile's sampled latent and image to 1e-4 relative RMS.
- ``pipeline(png, 128, 128, img2img=True)`` from the tiny checkpoint of
  scripts/make_tiny_assets.py and a tiny ``ESRGAN/RealESRGAN_x4plus.pth``,
  in both packages with Python's ``random`` seeded alike: the PNGs within
  one uint8 level.
"""

import os
import random
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lightdiffusion_next_tpu.models import esrgan as jesrgan
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.base import sd15_model as jsd15_model
from lightdiffusion_next_tpu.ops import nn as jnn
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu.pipelines import upscaler as jusdu
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.utils import image as jimage
from lightdiffusion_next_tpu.utils import state_dict as jsd
from lightdiffusion_next_tpu.utils import tiling as jtiling
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.models import esrgan as tesrgan
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.base import sd15_model as tsd15_model
from lightdiffusion_next_tpu_torch.ops import nn as tnn
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines import upscaler as tusdu
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.utils import image as timage
from lightdiffusion_next_tpu_torch.utils import state_dict as tsd
from lightdiffusion_next_tpu_torch.utils import tiling as ttiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny checkpoint's VAE: 8x down, as the SD VAE
VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
                 transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
                 num_heads=2)
TINY_ESRGAN = dict(num_body=1, nf=8, gc=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tiny models are thousands of small ops: with one torch thread
    they run as fast as with many, and do not crowd the other test workers'
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_rmse(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2))


# --------------------------------------------------------------------------
# load_image
# --------------------------------------------------------------------------


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose row y is filtered with ``filters[y % 5]``."""
    h, w, c = img.shape
    bpp, stride = c, w * c
    rows = img.reshape(h, stride).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        raw += bytes([kind]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_load_image_png_filters_match_pil(channels, filters, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 11, channels), dtype=np.uint8)
    img[3:6] = 200  # flat runs, where the predictors differ most
    path = tmp_path / "x.png"
    path.write_bytes(_filtered_png(img, filters))
    np.testing.assert_array_equal(timage.decode_png(path.read_bytes()), img)
    got = timage.load_image(str(path))
    assert got.dtype == np.float32 and got.shape == (1, 13, 11, 3)
    np.testing.assert_array_equal(got, jimage.load_image(str(path)))


def test_load_image_of_a_port_png_matches_pil(tmp_path):
    """A PNG the port's writer made, read by the port and by the JAX
    package's loader (PIL)."""
    imgs = np.random.default_rng(1).random((1, 40, 24, 3)).astype(np.float32)
    path = timage.SaveImage(str(tmp_path)).save_images(imgs, "Classic/LD", prompt="x")[0]
    got = timage.load_image(path)
    np.testing.assert_array_equal(got, jimage.load_image(path))
    np.testing.assert_array_equal(timage.to_uint8(got), timage.to_uint8(imgs))
    np.testing.assert_array_equal(timage.from_uint8(timage.to_uint8(imgs)),
                                  jimage.from_uint8(jimage.to_uint8(imgs)))


def test_load_image_other_formats(tmp_path, monkeypatch):
    """JPEG through PIL where it can be imported; without PIL a ValueError
    naming the format. A 16-bit PNG goes to PIL too."""
    img = (np.random.default_rng(2).random((16, 16, 3)) * 255).astype(np.uint8)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(img).save(jpg, quality=95)
    np.testing.assert_array_equal(timage.load_image(str(jpg)), jimage.load_image(str(jpg)))
    deep = tmp_path / "deep.png"
    Image.fromarray((img[..., 0].astype(np.uint16) * 257)).save(deep)
    with pytest.raises(ValueError, match="bit depth 16"):
        timage.decode_png(deep.read_bytes())
    np.testing.assert_array_equal(timage.load_image(str(deep)), jimage.load_image(str(deep)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="JPEG"):
        timage.load_image(str(jpg))
    with pytest.raises(ValueError, match="bit depth 16"):
        timage.load_image(str(deep))


# --------------------------------------------------------------------------
# VAE encoder, tiled decode, tiling, ESRGAN
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vaes():
    params = jvae.init_params(jvae.VAEConfig(**VAE_CFG), seed=4)
    return (jvae.VAE(params, jvae.VAEConfig(**VAE_CFG)),
            tvae.VAE(from_jax(params), tvae.VAEConfig(**VAE_CFG), device="cpu"))


def test_vae_encode_matches_jax(vaes):
    jv, tv = vaes
    rng = np.random.default_rng(3)
    px = rng.random((2, 48, 40, 3)).astype(np.float32)
    x = px * 2.0 - 1.0
    moments = tvae.apply_encoder(tv.params, torch.from_numpy(x), tv.cfg).numpy()
    ref = np.asarray(jvae.apply_encoder(jv.params, jnp.asarray(x), jv.cfg))
    assert moments.shape == (2, 6, 5, 8)
    np.testing.assert_allclose(moments, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tv.encode(px).numpy(), np.asarray(jv.encode(jnp.asarray(px))),
                               atol=1e-4, rtol=1e-4)
    noise = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tv.encode(px, noise=noise).numpy(),
                               np.asarray(jv.encode(jnp.asarray(px), noise=jnp.asarray(noise))),
                               atol=1e-4, rtol=1e-4)


def test_decode_tiled_matches_jax_and_decode(vaes):
    jv, tv = vaes
    rng = np.random.default_rng(4)
    z = rng.standard_normal((1, 20, 14, 4)).astype(np.float32)
    got = tv.decode_tiled(z, tile=8, overlap=2)
    assert tuple(got.shape) == (1, 160, 112, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jv.decode_tiled(z, tile=8, overlap=2)),
                               atol=1e-4, rtol=1e-4)
    # one tile covers the latent: the tiled decode is the decode
    np.testing.assert_allclose(tv.decode_tiled(z[:, :12, :12], overlap=4).numpy(),
                               tv.decode(z[:, :12, :12]).numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tv.decode(z).numpy(), np.asarray(jv.decode(jnp.asarray(z))),
                               atol=1e-4, rtol=1e-4)


def test_decode_falls_back_to_tiles_only_on_oom(vaes, monkeypatch):
    """A decode that runs out of device memory decodes in tiles; any other
    error propagates. Sub-batches follow the free memory."""
    _, tv = vaes
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 10, 10, 4))
                         .astype(np.float32))
    want = tv.decode(z)
    real = tv._decode_scaled
    seen = []

    def oom_above_tile(x):
        seen.append(tuple(x.shape))
        if x.shape[1] > 8:
            raise torch.OutOfMemoryError("out of memory")
        return real(x)

    monkeypatch.setattr(tv, "_decode_scaled", oom_above_tile)
    monkeypatch.setattr(tv, "decode_tiled", lambda s, tile=8, overlap=2:
                        tvae.VAE.decode_tiled(tv, s, tile=8, overlap=2))
    got = tv.decode(z)
    assert seen[0] == (3, 10, 10, 4) and all(s[1:3] == (8, 8) for s in seen[1:])
    assert tuple(got.shape) == (3, 80, 80, 3) and torch.isfinite(got).all()

    def broken(x):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(tv, "_decode_scaled", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        tv.decode(z)
    # 160 KiB a latent pixel in the 8 GiB assumed on the CPU: a 2048^2
    # image's latent decodes one at a time
    assert tv._max_decode_batch((3, 10, 10, 4)) > 3
    assert tv._max_decode_batch((2, 256, 256, 4)) == 1
    seen.clear()
    monkeypatch.setattr(tv, "_decode_scaled", lambda x: seen.append(x.shape[0]) or real(x))
    monkeypatch.setattr(tv, "_max_decode_batch", lambda shape: 2)
    np.testing.assert_allclose(tv.decode(z).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    assert seen == [2, 1]


def test_tiled_apply_identity_is_exact_and_matches_jax():
    """The identity comes back exactly where tiles do not overlap, and to
    the rounding of the weighted mean where they do."""
    x = np.random.default_rng(6).random((1, 37, 29, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttiling.tiled_apply_2d(lambda t: t, x, tile=16, overlap=0)
                                  .numpy(), x)
    np.testing.assert_allclose(ttiling.tiled_apply_2d(lambda t: t, x, tile=16, overlap=4)
                               .numpy(), x, atol=0, rtol=3e-7)

    def up2(t):  # a nonlinear x2 upscaler in each package's array type
        if isinstance(t, torch.Tensor):
            return torch.tanh(tnn.interpolate_nearest(t, 2) * 3.0)
        return np.tanh(np.repeat(np.repeat(np.asarray(t), 2, 1), 2, 2) * 3.0)

    got = ttiling.tiled_apply_2d(up2, x, tile=16, overlap=4, upscale=2)
    ref = jtiling.tiled_apply_2d(up2, x, tile=16, overlap=4, upscale=2)
    assert tuple(got.shape) == (1, 74, 58, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert ttiling.get_tiled_scale_steps(512, 384, 64, 64, 8) == \
        jtiling.get_tiled_scale_steps(512, 384, 64, 64, 8)


def _old_arch(sd):
    """RealESRGAN keys -> the old ESRGAN layout."""
    n = tesrgan.num_blocks(sd)
    names = {"conv_first": "model.0", "conv_body": f"model.1.sub.{n}", "conv_up1": "model.3",
             "conv_up2": "model.6", "conv_hr": "model.8", "conv_last": "model.10"}
    out = {}
    for k, v in sd.items():
        head, tail = k.rsplit(".", 1)
        if head.startswith("body."):
            _, i, rdb, conv = head.split(".")
            out[f"model.1.sub.{i}.RDB{rdb[-1]}.conv{conv[-1]}.0.{tail}"] = v
        else:
            out[f"{names[head]}.{tail}"] = v
    return out


def test_esrgan_matches_jax():
    """RRDBNet at num_body=2 (nf 64, gc 32), the old keys mapped as the JAX
    package maps them, and the tiled upscale over a 36 x 44 image in
    16-pixel tiles."""
    params = jesrgan.init_params(num_body=2, seed=7)
    tparams = tesrgan.init_params(num_body=2, seed=7)
    np.testing.assert_array_equal(tparams["body.1.rdb3.conv5.weight"],
                                  np.transpose(params["body.1.rdb3.conv5.weight"], (3, 2, 0, 1)))
    old = _old_arch(tparams)
    assert tesrgan.normalize_esrgan_keys(old).keys() == tparams.keys()
    assert jesrgan.normalize_esrgan_keys(old).keys() == tparams.keys()
    x = np.random.default_rng(8).random((1, 36, 44, 3)).astype(np.float32)
    tm = tesrgan.UpscaleModel(old, device="cpu")
    jm = jesrgan.UpscaleModel(params)
    out = tesrgan.apply_rrdbnet(tm.params, torch.from_numpy(x[:, :16, :16])).numpy()
    ref = np.asarray(jesrgan.apply_rrdbnet(jm.params, jnp.asarray(x[:, :16, :16])))
    assert out.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    got = tm.upscale(x, tile=16, overlap=4)
    assert tuple(got.shape) == (1, 144, 176, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jm.upscale(x, tile=16, overlap=4),
                               atol=1e-4, rtol=1e-4)


def test_esrgan_file_loader_unwraps_params_ema(tmp_path):
    """The published RealESRGAN files nest their tensors under
    ``params_ema``: the port's loader unwraps it. The JAX package's loader
    keeps only top-level tensors and returns nothing for such a file
    (ROADMAP Queue 3); both read the flat layout alike."""
    sd = {k: torch.from_numpy(v) for k, v in tesrgan.init_params(**TINY_ESRGAN).items()}
    nested, flat = tmp_path / "nested.pth", tmp_path / "flat.pth"
    torch.save({"params_ema": sd}, nested)
    torch.save(sd, flat)
    got = tsd.load_torch_file(str(nested))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    assert jsd.load_torch_file(str(nested)) == {}
    ref = jsd.load_torch_file(str(flat))
    got = tsd.load_torch_file(str(flat))
    assert got.keys() == ref.keys()
    assert all(np.array_equal(got[k].numpy(), ref[k]) for k in ref)


def test_resize_is_the_jax_bilinear():
    """USDU's resize (the port's ``nn.interpolate_bilinear``) against JAX
    ``ops/nn.interpolate_bilinear`` with align_corners=False, up and down."""
    x = np.random.default_rng(9).random((1, 30, 22, 3)).astype(np.float32)
    for size in ((60, 44), (17, 9)):
        got = tusdu.UltimateSDUpscale._resize(x, *size)
        np.testing.assert_allclose(got, np.asarray(jnn.interpolate_bilinear(jnp.asarray(x), size)),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tusdu.UltimateSDUpscale._resize(torch.from_numpy(x), *size)
                                   .numpy(), got, atol=0, rtol=0)


# --------------------------------------------------------------------------
# USDU end to end
# --------------------------------------------------------------------------


def _record(monkeypatch, obj, name, into, before=None):
    """Wrap ``obj.name`` to append what each call returns to ``into`` (with
    ``before(args, kwargs)`` run first)."""
    real = getattr(obj, name)

    def recording(*args, **kwargs):
        if before is not None:
            before(args, kwargs)
        out = real(*args, **kwargs)
        into.append(np.array(out.latent if hasattr(out, "latent") else out))
        return out

    monkeypatch.setattr(obj, name, recording)


def test_usdu_matches_jax(monkeypatch):
    """A 64-pixel image, ESRGAN x4 then resized to 128, 32-pixel tiles (4 x 4
    redraw tiles, 12 + 12 seam bands) with padding 8: every tile at the
    48-pixel model shape, 8 steps of dpmpp_2m_cfgpp.

    Each tile redraws an overlap of the tiles before it, and the tiny random
    encoder, sampler and decoder multiply a last-bit difference by about 3
    a tile (measured on the CPU: 7.7e-6 relative RMS after the first tile's
    sampler, 0.08 after the sixteenth). So each of the port's tiles starts
    from the JAX package's image before that tile, and its sampled latent
    and its image after the composite are held to the JAX package's."""
    cfg = dict(upscale_by=2.0, tile_width=32, tile_height=32, mask_blur=4, padding=8,
               seam_fix_mask_blur=8, seam_fix_padding=8)
    unet_p = junet.init_params(junet.UNetConfig(**TINY_UNET), seed=0)
    vae_p = jvae.init_params(jvae.VAEConfig(**VAE_CFG), seed=1)
    esr_p = jesrgan.init_params(**TINY_ESRGAN, seed=2)
    rng = np.random.default_rng(10)
    c, u = (rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2))
    image = rng.random((1, 64, 64, 3)).astype(np.float32)

    j_in, j_lat, j_out, t_lat, t_out = [], [], [], [], []
    _record(monkeypatch, jusdu.UltimateSDUpscale, "_process_region", j_out,
            before=lambda a, k: j_in.append(np.array(a[1])))
    _record(monkeypatch, jks, "ksample", j_lat)
    j = jusdu.UltimateSDUpscale(jsd15_model(unet_p, cfg=junet.UNetConfig(**TINY_UNET)),
                                jvae.VAE(vae_p, jvae.VAEConfig(**VAE_CFG)),
                                jesrgan.UpscaleModel(esr_p), jusdu.USDUConfig(**cfg))
    ref = j.upscale(image, jcfg.CondInput(jnp.asarray(c)), jcfg.CondInput(jnp.asarray(u)),
                    seed=123)

    def teacher(args, kwargs):  # the tile starts from the JAX image before it
        args[1][...] = j_in[len(t_out)]

    _record(monkeypatch, tusdu.UltimateSDUpscale, "_process_region", t_out, before=teacher)
    _record(monkeypatch, tks, "ksample", t_lat)
    t = tusdu.UltimateSDUpscale(
        tsd15_model(from_jax(unet_p), cfg=tunet.UNetConfig(**TINY_UNET), device="cpu"),
        tvae.VAE(from_jax(vae_p), tvae.VAEConfig(**VAE_CFG), device="cpu"),
        tesrgan.UpscaleModel(from_jax(esr_p), device="cpu"), tusdu.USDUConfig(**cfg))
    up = t.model_upscale(image)
    np.testing.assert_allclose(up, j.model_upscale(image), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(up, j_in[0], atol=1e-4, rtol=1e-4)
    out = t.upscale(image, tcfg.CondInput(torch.from_numpy(c)),
                    tcfg.CondInput(torch.from_numpy(u)), seed=123)
    assert out.shape == (1, 128, 128, 3) and out.dtype == np.float32
    assert len(t_lat) == len(j_lat) == len(t_out) == len(j_out) == 16 + 24
    assert all(x.shape == (1, 6, 6, 4) for x in t_lat)
    assert max(_rel_rmse(a, b) for a, b in zip(t_lat, j_lat)) < 1e-4
    assert max(_rel_rmse(a, b) for a, b in zip(t_out, j_out)) < 1e-4
    diff = np.abs(timage.to_uint8(out).astype(np.int32) - jimage.to_uint8(ref).astype(np.int32))
    assert diff.max() <= 1
    assert not np.array_equal(out, up)  # the redraw changed the upscale


def test_usdu_regions_match_jax():
    for W, H, pad, mw, mh in ((2048, 2048, 32, 576, 576), (128, 96, 8, 48, 48),
                              (100, 300, 16, 64, 96)):
        for rect in ((0, 0, 32, 32), (W - 32, H - 40, W, H), (40, 8, 72, 40)):
            assert tusdu.region_for_rect(rect, W, H, pad, mw, mh) == \
                jusdu.region_for_rect(rect, W, H, pad, mw, mh)
    mask = np.zeros((64, 80), np.float32)
    mask[10:30, 20:50] = 1.0
    np.testing.assert_array_equal(tusdu._feather_rect(mask.copy(), 6, (20, 10, 50, 30)),
                                  jusdu._feather_rect(mask.copy(), 6, (20, 10, 50, 30)))


# --------------------------------------------------------------------------
# The whole flow
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_tiny_assets
    finally:
        sys.path.pop(0)
    make_tiny_assets.main(str(root))
    (root / "ESRGAN").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in tesrgan.init_params(**TINY_ESRGAN).items()},
               root / "ESRGAN" / "RealESRGAN_x4plus.pth")
    image = np.random.default_rng(11).random((1, 64, 64, 3)).astype(np.float32)
    png = timage.SaveImage(str(root)).save_images(image, "input/in")[0]
    mp = pytest.MonkeyPatch()
    mp.setenv("LDT_ASSET_ROOT", str(root))
    mp.setenv("LDT_OFFLINE", "1")
    try:
        random.seed(21)
        port = tpipe.pipeline(png, 128, 128, img2img=True, device="cpu",
                              output_dir=str(root / "port"))
        random.seed(21)
        ref = jpipe.pipeline(png, 128, 128, img2img=True, output_dir=str(root / "jax"))
        yield dict(root=root, png=png, port=port, ref=ref)
    finally:
        mp.undo()


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


def test_img2img_pipeline_png_matches_jax(flow):
    assert [os.path.basename(p) for p in flow["port"]] == ["LD_00001_.png"]
    assert os.path.dirname(flow["port"][0]).endswith("Img2Img")
    ours, theirs = _png(flow["port"][0]), _png(flow["ref"][0])
    assert ours.shape == theirs.shape == (128, 128, 3)
    assert np.abs(ours - theirs).max() <= 1
    assert ours.std() > 0


def test_cli_img2img_end_to_end(flow, capsys):
    """``--img2img`` through the CLI takes the image's path as its prompt and
    the ESRGAN from the model cache."""
    esr = os.path.join(str(flow["root"]), "ESRGAN", "RealESRGAN_x4plus.pth")
    cached = tloader.load_upscale_model(esr, device="cpu")
    out_dir = str(flow["root"] / "cli")
    assert tcli.main([flow["png"], "64", "64", "--img2img", "--output-dir", out_dir],
                     device="cpu") == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [os.path.join(out_dir, "Img2Img", "LD_00001_.png")]
    assert _png(printed[0]).shape == (128, 128, 3)
    assert tloader.load_upscale_model(esr, device="cpu") is cached
