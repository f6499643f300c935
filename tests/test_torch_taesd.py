"""TAESD and the latent formats' preview in the port against the JAX
package.

- ``init_params``: the port's draw equals the JAX one through
  ``weights.from_jax`` (HWIO -> OIHW), bit for bit.
- ``decode``, ``encode`` (with a scale and shift) and ``decode_preview`` on
  the same numpy-seeded inputs, f32: atol 1e-4, rtol 1e-4 (about 50 convs
  at 64 channels; XLA's and oneDNN's convolutions sum in other orders).
- ``normalize_decoder_params`` on its three checkpoint layouts (the keys
  and tensors equal to the JAX package's), a partial one and a foreign
  one (None in both).
- ``latent_preview_rgb`` for SD15 and FLUX1 (host numpy matmul in both:
  bit for bit), ``fix_empty_latent_channels``, and the format tables (each
  format's TAESD decoder file one the downloader fetches, where the JAX
  formats carry a name that nothing reads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import taesd as jtaesd
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch.models import taesd as ttaesd
from lightdiffusion_next_tpu_torch.pipelines import downloader
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.utils import latent as tlatent

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jtaesd.init_params(seed=3)
    return jp, from_jax(jp)


def test_init_params_equal_jax_through_from_jax(params):
    jp, tp = params
    ours = ttaesd.init_params(seed=3)
    assert ours.keys() == tp.keys() == jp.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v, tp[k].numpy(), err_msg=k)
    flux = ttaesd.init_params(seed=1, latent_channels=16)
    assert flux["decoder.1.weight"].shape == (64, 16, 3, 3)
    assert flux["encoder.14.weight"].shape == (16, 64, 3, 3)


@pytest.mark.parametrize("shape", [(1, 8, 8, 4), (2, 5, 7, 4)])
def test_decode_and_preview_match_jax(params, shape):
    jp, tp = params
    lat = np.random.default_rng(4).standard_normal(shape).astype(np.float32) * 2
    ref = np.asarray(jtaesd.decode(jp, jnp.asarray(lat)))
    out = ttaesd.decode(tp, torch.from_numpy(lat))
    assert tuple(out.shape) == (shape[0], shape[1] * 8, shape[2] * 8, 3)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    prev = ttaesd.decode_preview(tp, torch.from_numpy(lat))
    assert isinstance(prev, np.ndarray) and prev.min() >= 0 and prev.max() <= 1
    np.testing.assert_allclose(prev, jtaesd.decode_preview(jp, jnp.asarray(lat)), **TOL)
    # numpy params (the port's own draw) give the same image
    np.testing.assert_allclose(ttaesd.decode(ttaesd.init_params(seed=3), lat).numpy(),
                               out.numpy(), atol=0, rtol=0)


def test_encode_matches_jax(params):
    jp, tp = params
    img = np.random.default_rng(5).uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jtaesd.encode(jp, jnp.asarray(img), vae_scale=2.0, vae_shift=0.25))
    out = ttaesd.encode(tp, torch.from_numpy(img), vae_scale=2.0, vae_shift=0.25)
    assert tuple(out.shape) == (1, 4, 6, 4)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    dec = ttaesd.decode(tp, out, vae_scale=2.0, vae_shift=0.25).numpy()
    np.testing.assert_allclose(dec, np.asarray(jtaesd.decode(jp, jnp.asarray(ref), 2.0, 0.25)),
                               atol=1e-3, rtol=1e-3)


def test_scale_latents_match_jax():
    x = np.linspace(-8, 8, 33, dtype=np.float32)
    np.testing.assert_array_equal(ttaesd.scale_latents(torch.from_numpy(x)).numpy(),
                                  np.asarray(jtaesd.scale_latents(jnp.asarray(x))))
    np.testing.assert_allclose(ttaesd.unscale_latents(ttaesd.scale_latents(
        torch.from_numpy(x[10:23]))).numpy(), x[10:23], atol=1e-5)


def _layouts(dec):
    bare = {k[len("decoder."):]: v for k, v in dec.items()}
    diffusers = {}
    for k, v in dec.items():
        idx, _, tail = k[len("decoder."):].partition(".")
        diffusers[f"decoder.layers.{int(idx) - 1}.{tail}"] = v
    encoder = {"encoder.0.weight": np.zeros((1,), np.float32)}
    return {"prefixed": {**dec, **encoder}, "bare": bare, "diffusers": diffusers}


@pytest.mark.parametrize("layout", ["prefixed", "bare", "diffusers"])
def test_normalize_decoder_params_layouts(params, layout):
    jp, tp = params
    dec = {k: v for k, v in tp.items() if k.startswith("decoder.")}
    jdec = {k: v for k, v in jp.items() if k.startswith("decoder.")}
    got = ttaesd.normalize_decoder_params(_layouts(dec)[layout])
    want = jtaesd.normalize_decoder_params(_layouts(jdec)[layout])
    assert got.keys() == want.keys() == dec.keys()
    for k in dec:
        assert got[k] is dec[k]
    # the result decodes
    assert ttaesd.decode(got, torch.zeros(1, 2, 2, 4)).shape == (1, 16, 16, 3)


def test_normalize_decoder_params_refuses_other_layouts(params):
    _, tp = params
    w = tp["decoder.1.weight"]
    for sd in ({"foo.weight": w}, {"decoder.1.weight": w}, {},
               {"decoder.layers.x.weight": w}):
        assert ttaesd.normalize_decoder_params(sd) is None
        assert jtaesd.normalize_decoder_params(
            {k: v.numpy() for k, v in sd.items()}) is None


# the TAESD decoder file of each format: the files the JAX pipeline's
# stages pass for SD1.5 and Flux (the downloader's), none for SD3
DECODER_FILES = {"SD15": "taesd_decoder.safetensors", "SD3": None,
                 "FLUX1": "diffusion_pytorch_model.safetensors"}


@pytest.mark.parametrize("name", ["SD15", "SD3", "FLUX1"])
def test_latent_formats_equal_jax(name):
    t, j = getattr(tlatent, name), getattr(jlatent, name)
    assert (t.scale_factor, t.shift_factor, t.latent_channels, t.latent_rgb_factors) == (
        j.scale_factor, j.shift_factor, j.latent_channels, j.latent_rgb_factors)
    assert t.taesd_decoder_file == DECODER_FILES[name]
    fetched = {(name, sub) for _, name, sub in downloader.SD_ASSETS + downloader.FLUX_ASSETS}
    assert t.taesd_decoder_file is None or (t.taesd_decoder_file, "vae_approx") in fetched


@pytest.mark.parametrize("name,c", [("SD15", 4), ("FLUX1", 16)])
def test_latent_preview_rgb_equal_jax(name, c):
    lat = np.random.default_rng(6).standard_normal((2, 6, 10, c)).astype(np.float32) * 3
    want = jlatent.latent_preview_rgb(getattr(jlatent, name), lat)
    for x in (lat, torch.from_numpy(lat)):
        got = tlatent.latent_preview_rgb(getattr(tlatent, name), x)
        assert got.shape == (2, 6, 10, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [2, 4, 6])
def test_fix_empty_latent_channels_equal_jax(c):
    lat = np.random.default_rng(7).standard_normal((1, 3, 5, c)).astype(np.float32)
    for name in ("SD15", "FLUX1"):
        got = tlatent.fix_empty_latent_channels(getattr(tlatent, name), torch.from_numpy(lat))
        want = jlatent.fix_empty_latent_channels(getattr(jlatent, name), jnp.asarray(lat))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
