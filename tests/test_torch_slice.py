"""The port's SD1.5 txt2img slice as a whole, against the JAX package's
functions composed the same way, plus the port's packaging rules.

The port runs its real entry point, ``pipeline()``, on a tiny UNet, VAE and
CLIP (prompt weights, clip-skip -2, dpmpp_2m_cfgpp over 20 karras steps,
the default multi-scale plan with half-res steps, MSW-MSA with its sigma
gate, a 32x32 latent). The JAX side runs the same functions as its
``_sd15_generate`` at the function level (its ``pipeline()`` loads a
checkpoint from disk). Both draw the same noise from the seed.

Tolerance: the uint8 images may differ by one level (f32 on both sides,
summation order differs over 20 steps, and a value near a rounding edge
can land on either side); the final latents agree to 1e-4 relative RMS.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.clip import facade as jfacade
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.ops import window as jwin
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.utils import image as jimage
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import facade as tfacade
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1,
            context_dim=64, num_heads=2)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
PROMPT = "a (cute:1.2) cat on a mat"
SEED = 20261016


def _read_png(path):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.read_png(path)


def test_slice_matches_jax_composition(tmp_path):
    ucfg_j, ucfg_t = junet.UNetConfig(**TINY), tunet.UNetConfig(**TINY)
    vcfg_j, vcfg_t = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    unet_p = junet.init_params(ucfg_j, seed=0)
    vae_p = jvae.init_params(vcfg_j, seed=1)
    clip_p = jte.init_params(num_layers=2, width=64, heads=4, seed=2)

    # --- the port, through its entry point
    model = tbase.sd15_model(from_jax(unet_p), cfg=ucfg_t, device="cpu")
    vae = tvae.VAE(from_jax(vae_p), vcfg_t, device="cpu")
    clip = tfacade.sd1_clip_from_params(from_jax(clip_p), device="cpu")
    latents = []
    paths = tpipe.pipeline(
        PROMPT, 256, 256, prio_speed=True, autohdr=False, model=model, clip=clip,
        vae=vae, seed=SEED, output_dir=str(tmp_path),
        progress_callback=lambda info: latents.append(info["x"]),
    )
    assert len(latents) == 20
    port_img = _read_png(paths[0])
    assert port_img.shape == (64, 64, 3)  # the tiny VAE upsamples 2x, not 8x
    assert os.path.basename(paths[0]) == "LD_00001_.png"

    # --- the JAX package's functions, composed as its _sd15_generate
    jclip = jfacade.CLIPSetLastLayer().set_last_layer(
        jfacade.sd1_clip_from_state_dict(clip_p), -2)
    enc = jfacade.CLIPTextEncode()
    pos, neg = enc.encode(jclip, PROMPT), enc.encode(jclip, tpipe.DEFAULT_NEGATIVE)
    jmodel = jbase.sd15_model(unet_p, cfg=ucfg_j)
    jmodel = jmodel.with_options(attn1_override_factory=jwin.make_msw_msa_factory(
        model_sampling=jmodel.model_sampling))
    res = jks.ksample(
        jmodel, seed=SEED, steps=20, cfg_scale=7.0, sampler_name="dpmpp_2m_cfgpp",
        scheduler="karras", positive=pos, negative=neg,
        latent_image=jlatent.empty_latent(256, 256, 1), denoise=1.0,
        ms=jsamp.MultiScale(enabled=True), callback=lambda info: None,
    )
    jimg = jimage.to_uint8(np.asarray(jvae.VAE(vae_p, vcfg_j).decode(res.latent)))[0]

    ref_raw = np.asarray(res.raw)
    out_raw = latents[-1].numpy()
    rel = np.sqrt(np.mean((out_raw - ref_raw) ** 2) / np.mean(ref_raw**2))
    assert rel < 1e-4
    diff = np.abs(port_img.astype(np.int32) - jimg.astype(np.int32))
    assert diff.max() <= 1


def test_png_writer_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 7, 5, 3)).astype(np.float32)
    saver = timage.SaveImage(output_dir=str(tmp_path))
    paths = saver.save_images(imgs, "Classic/LD", prompt="a cat")
    assert [os.path.basename(p) for p in paths] == ["LD_00001_.png", "LD_00002_.png"]
    for p, img in zip(paths, timage.to_uint8(imgs)):
        np.testing.assert_array_equal(_read_png(p), img)
    more = saver.save_images(imgs[:1], "Classic/LD")
    assert os.path.basename(more[0]) == "LD_00003_.png"
    np.testing.assert_array_equal(timage.to_uint8(imgs), jimage.to_uint8(imgs))
    with open(paths[0], "rb") as f:
        assert b"tEXtprompt\x00a cat" in f.read()


@pytest.mark.parametrize(
    "kwargs",
    [dict(hires_fix=True), dict(adetailer=True), dict(img2img=True),
     dict(flux_enabled=True), dict(flux_enabled=True, hires_fix=True),
     dict(realistic_model=True, adetailer=True), dict(enhance_prompt=True)],
)
def test_unported_pipeline_arguments_raise(kwargs, tmp_path, monkeypatch):
    """With every other default and no models, each still-unported argument
    raises before anything is read: the asset root holds no checkpoint, so
    a load would raise FileNotFoundError instead. Flux, hires-fix, img2img
    and ADetailer are ported and load, in the JAX package's dispatch order:
    Flux first (it ignores hires_fix) raises for its missing files,
    hires-fix, img2img and ADetailer for the missing SD1.5 checkpoint."""
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    monkeypatch.setenv("LDT_OFFLINE", "1")
    if kwargs.get("flux_enabled"):
        with pytest.raises(FileNotFoundError, match="flux asset missing"):
            tpipe.pipeline("a cat", 64, 64, seed=1, device="cpu", **kwargs)
    elif kwargs in (dict(hires_fix=True), dict(img2img=True), dict(adetailer=True),
                    dict(realistic_model=True, adetailer=True)):
        with pytest.raises(FileNotFoundError, match="checkpoint missing"):
            tpipe.pipeline("a cat", 64, 64, seed=1, device="cpu", **kwargs)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.pipeline("a cat", 64, 64, seed=1, device="cpu", **kwargs)
    with pytest.raises(FileNotFoundError):
        tpipe.pipeline("a cat", 64, 64, seed=1, device="cpu")


def _tiny_sd15():
    ucfg, vcfg = tunet.UNetConfig(**TINY), tvae.VAEConfig(**TINY_VAE)
    model = tbase.sd15_model(from_jax(junet.init_params(junet.UNetConfig(**TINY), seed=0)),
                             cfg=ucfg, device="cpu")
    vae = tvae.VAE(from_jax(jvae.init_params(jvae.VAEConfig(**TINY_VAE), seed=1)), vcfg,
                   device="cpu")
    clip = tfacade.sd1_clip_from_params(
        from_jax(jte.init_params(num_layers=2, width=64, heads=4, seed=2)), device="cpu")
    return model, clip, vae


def _tiny_flux():
    from lightdiffusion_next_tpu_torch.models import flux as tflux
    from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as tte

    fcfg = tflux.FluxConfig(hidden_size=256, num_heads=2, depth=1, depth_single_blocks=1,
                            context_in_dim=256, vec_in_dim=64, axes_dim=(16, 56, 56))
    t5cfg = tt5.T5Config(d_model=256, d_ff=512, num_heads=4, num_layers=1)
    model = tbase.flux_model(tflux.random_params(fcfg, seed=3, device="cpu",
                                                 dtype=torch.float32), cfg=fcfg, device="cpu")
    t5 = tt5.T5XXLModel(tt5.random_params(t5cfg, seed=4, device="cpu", dtype=torch.float32),
                        cfg=t5cfg, device="cpu")
    clip = tte.SDClipModel(from_jax(jte.init_params(num_layers=1, width=64, heads=4, seed=5,
                                                    with_projection=True)),
                           num_layers=1, heads=4, device="cpu")
    vcfg = tvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16,
                          has_quant_conv=False)
    vae = tvae.VAE(tvae.init_params(vcfg, seed=6), vcfg, device="cpu")
    return model, clip, vae, t5


@pytest.mark.parametrize("kwargs", [dict(prio_speed=True, autohdr=True),
                                    dict(prio_speed=False, autohdr=False),
                                    dict(flux_enabled=True, autohdr=True)])
def test_default_flags_run(kwargs, tmp_path):
    """The flags that raised before this slice (AutoHDR, ``prio_speed=False``
    and Flux's AutoHDR) run with given models: 20 steps (dpmpp_sde_cfgpp
    with ``prio_speed=False``: 39 model calls), and the PNG is the decode
    of the final latent, through AutoHDR when it is on."""
    from lightdiffusion_next_tpu_torch.utils import hdr as thdr

    if kwargs.get("flux_enabled"):
        model, clip, vae, t5 = _tiny_flux()
        extra = dict(t5=t5)
    else:
        (model, clip, vae), extra = _tiny_sd15(), {}
    calls = []
    real = model.apply_fn
    model = dataclasses.replace(model, apply_fn=lambda *a, **k: calls.append(1) or real(*a, **k))
    latents = []
    paths = tpipe.pipeline(PROMPT, 128, 128, model=model, clip=clip, vae=vae, seed=SEED,
                           device="cpu", output_dir=str(tmp_path),
                           progress_callback=lambda info: latents.append(info["x"]), **extra,
                           **kwargs)
    assert len(latents) == 20
    if not kwargs.get("flux_enabled"):
        assert len(calls) == (20 if kwargs["prio_speed"] else 39)
    pixels = vae.decode(model.latent_format.process_out(latents[-1]))
    if kwargs["autohdr"]:
        pixels = thdr.apply_hdr_batch(pixels)
    np.testing.assert_array_equal(_read_png(paths[0]), timage.to_uint8(pixels.numpy())[0])


def test_entry_points_default_to_cuda():
    """Without a GPU the default device raises instead of running on the
    CPU; the CPU is used only when asked for."""
    assert tconfig.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert tconfig.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tconfig.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvae.VAE(tvae.init_params(tvae.VAEConfig(**TINY_VAE)), tvae.VAEConfig(**TINY_VAE))


def test_dtype_policy():
    cpu = tconfig.DtypePolicy.for_device("cpu")
    gpu = tconfig.DtypePolicy.for_device("cuda")
    assert {cpu.compute_dtype, cpu.vae_dtype, cpu.text_encoder_dtype} == {torch.float32}
    assert (gpu.compute_dtype, gpu.param_dtype, gpu.vae_dtype, gpu.text_encoder_dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with JAX and the
    JAX package made unimportable, in a fresh process (this one has JAX
    loaded already); the Flux slice's modules are among them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lightdiffusion_next_tpu'] = None\n"
        "import lightdiffusion_next_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "flux = ['ops.ggml', 'ops.quant_matmul', 'models.flux', 'models.clip.t5',\n"
        "        'models.clip.t5_tokenizer', 'sampling.fbcache']\n"
        "assert all(pkg.__name__ + '.' + m in names for m in flux), names\n"
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'lightdiffusion_next_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 34
