"""pipeline(): SD1.5 txt2img on the GPU.

Counterpart of lightdiffusion_next_tpu/pipelines/pipeline.py ``pipeline``
with its ``_sd15_generate`` flow: CLIP-L with clip-skip -2 encodes the
prompt and the negative prompt, the UNet runs ``dpmpp_2m_cfgpp`` for 20
karras steps under the batched CFG denoiser with the multi-scale plan and
MSW-MSA windowing, the VAE decodes, and the image is saved as a PNG.

It takes the JAX function's arguments plus the models, built from params
(``model``, ``clip``, ``vae``), since checkpoint loading is not ported yet,
and an optional ``seed``. Arguments whose modules are not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.clip import facade as clip_facade
from lightdiffusion_next_tpu_torch.ops import window
from lightdiffusion_next_tpu_torch.sampling import ksampler as ks
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod
from lightdiffusion_next_tpu_torch.utils import image as image_utils
from lightdiffusion_next_tpu_torch.utils import latent as latent_mod

DEFAULT_NEGATIVE = (
    "(worst quality, low quality:1.4), (zombie, sketch, interlocked fingers, "
    "comic), (embedding:EasyNegative), (embedding:badhandv4), (embedding:lr), "
    "(embedding:ng_deepnegative_v1_75t)"
)

_NOT_PORTED = {
    "hires_fix": "hires-fix (ROADMAP Queue 1, item 8)",
    "adetailer": "ADetailer (ROADMAP Queue 1, item 8)",
    "img2img": "img2img / UltimateSDUpscale (ROADMAP Queue 1, item 8)",
    "flux_enabled": "Flux (ROADMAP Queue 1, item 9)",
    "autohdr": "AutoHDR (ROADMAP Queue 1, item 7)",
    "enhance_prompt": "prompt enhancement (ROADMAP Queue 1, item 10)",
}


def _seed_file() -> str:
    return os.path.join(_config.asset_root(), "last_seed.txt")


def load_last_seed() -> int:
    try:
        with open(_seed_file()) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def save_last_seed(seed: int) -> None:
    os.makedirs(os.path.dirname(_seed_file()), exist_ok=True)
    with open(_seed_file(), "w") as f:
        f.write(str(seed))


def pipeline(
    prompt: str,
    w: int,
    h: int,
    number: int = 1,
    batch: int = 1,
    hires_fix: bool = False,
    adetailer: bool = False,
    enhance_prompt: bool = False,
    img2img: bool = False,
    stable_fast: bool = False,  # accepted for API parity
    reuse_seed: bool = False,
    flux_enabled: bool = False,
    prio_speed: bool = False,
    autohdr: bool = True,
    realistic_model: bool = False,  # chooses a checkpoint; the models are given here
    negative_prompt: Optional[str] = None,
    multiscale_preset: Optional[str] = None,
    enable_multiscale: bool = True,
    multiscale_factor: float = 0.5,
    multiscale_fullres_start: int = 3,
    multiscale_fullres_end: int = 8,
    multiscale_intermittent_fullres: bool = False,
    output_dir: str = "./output",
    progress_callback=None,
    hidiffusion: bool = True,
    *,
    model,
    clip,
    vae,
    seed: Optional[int] = None,
) -> List[str]:
    """Run SD1.5 txt2img; returns the saved image paths. ``model`` is a
    ``models.base.DiffusionModel``, ``clip`` a ``models.clip.facade.CLIP``,
    ``vae`` a ``models.vae.VAE``. With ``seed`` given, no seed file is read
    or written; otherwise the JAX package's seed handling applies.
    ``progress_callback`` is called after every sampler step with the
    step's dict (``x``, ``i``, ``sigma``, ``denoised``)."""
    requested = {
        "hires_fix": hires_fix, "adetailer": adetailer, "img2img": img2img,
        "flux_enabled": flux_enabled, "autohdr": autohdr,
        "enhance_prompt": enhance_prompt,
    }
    for name, on in requested.items():
        if on:
            raise NotImplementedError(f"{name}=True: {_NOT_PORTED[name]} is not ported yet")
    if not prio_speed:
        raise NotImplementedError(
            "prio_speed=False runs dpmpp_sde_cfgpp, which is not ported yet "
            "(ROADMAP Queue 1, item 5)"
        )

    if multiscale_preset is not None:
        ms = samplers_mod.MultiScale.preset(multiscale_preset)
    else:
        ms = samplers_mod.MultiScale(
            enabled=enable_multiscale,
            factor=multiscale_factor,
            fullres_start=multiscale_fullres_start,
            fullres_end=multiscale_fullres_end,
            intermittent=multiscale_intermittent_fullres,
        )
    if negative_prompt is None or not negative_prompt.strip():
        negative_prompt = DEFAULT_NEGATIVE

    if seed is None:
        seed = load_last_seed() if reuse_seed else random.randint(1, 2**63 - 1)
        save_last_seed(seed)

    saver = image_utils.SaveImage(output_dir=output_dir)
    saved: List[str] = []
    for _ in range(number):
        saved += _sd15_generate(prompt, negative_prompt, w, h, batch, seed, ms,
                                saver, progress_callback, hidiffusion,
                                model, clip, vae)
        seed = random.randint(1, 2**63 - 1)
    return saved


def _sd15_generate(prompt, negative_prompt, w, h, batch, seed, ms, saver,
                   callback, hidiffusion, model, clip, vae):
    clip = clip_facade.CLIPSetLastLayer().set_last_layer(clip, -2)
    encode = clip_facade.CLIPTextEncode()
    positive = encode.encode(clip, prompt)
    negative = encode.encode(clip, negative_prompt)

    if hidiffusion:
        model = model.with_options(
            attn1_override_factory=window.make_msw_msa_factory(
                model_sampling=model.model_sampling
            )
        )

    result = ks.ksample(
        model,
        seed=seed,
        steps=20,
        cfg_scale=7.0,
        sampler_name="dpmpp_2m_cfgpp",
        scheduler="karras",
        positive=positive,
        negative=negative,
        latent_image=latent_mod.empty_latent(w, h, batch, device=model.device),
        denoise=1.0,
        ms=ms,
        callback=callback,
    )
    images = vae.decode(result.latent).cpu().numpy()
    return saver.save_images(images, "Classic/LD", prompt=prompt)
