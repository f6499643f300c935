"""KSampler facade: schedule, noise (with the SDE samplers' Brownian-tree
noise), CFG denoiser, sampler loop.

Counterpart of lightdiffusion_next_tpu/sampling/ksampler.py ``ksample``,
with the FBCache dispatch (``fbcache=`` or the model's ``"fbcache"``
option), without denoise masks and differential diffusion (ROADMAP Queue 1,
item 8). Latents are NHWC in and out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.models.base import DiffusionModel
from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod
from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
from lightdiffusion_next_tpu_torch.sampling import noise as noise_mod
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod
from lightdiffusion_next_tpu_torch.sampling import schedules

SAMPLERS = samplers_mod.SAMPLER_NAMES
SCHEDULERS = schedules.SCHEDULERS


def sigmas_for(model_sampling, scheduler: str, steps: int,
               denoise: float = 1.0) -> np.ndarray:
    """Schedule plus denoise < 1 slicing: keep the last steps+1 sigmas of a
    longer schedule."""
    if denoise is None or denoise > 0.9999:
        return schedules.calculate_sigmas(model_sampling, scheduler, steps)
    if denoise <= 0.0:
        return np.zeros((0,), dtype=np.float32)
    new_steps = int(steps / denoise)
    sigmas = schedules.calculate_sigmas(model_sampling, scheduler, new_steps)
    return sigmas[-(steps + 1):]


def trim_sigmas(sigmas: np.ndarray, start_step: Optional[int] = None,
                last_step: Optional[int] = None,
                force_full_denoise: bool = False) -> np.ndarray:
    """start/last-step trimming."""
    sigmas = np.asarray(sigmas)
    if last_step is not None and last_step < (len(sigmas) - 1):
        sigmas = sigmas[: last_step + 1].copy()
        if force_full_denoise:
            sigmas[-1] = 0
    if start_step is not None:
        if start_step < (len(sigmas) - 1):
            sigmas = sigmas[start_step:]
        else:
            return sigmas[:0]
    return sigmas


@dataclasses.dataclass
class KSampleResult:
    latent: torch.Tensor  # decoded-format latent (process_out applied)
    raw: torch.Tensor  # model-space latent


def ksample(
    model: DiffusionModel,
    *,
    seed: int,
    steps: int,
    cfg_scale: float,
    sampler_name: str,
    scheduler: str,
    positive: cfg_mod.CondInput,
    negative: Optional[cfg_mod.CondInput],
    latent_image,
    denoise: float = 1.0,
    start_step: Optional[int] = None,
    last_step: Optional[int] = None,
    force_full_denoise: bool = False,
    ms: Optional[samplers_mod.MultiScale] = None,
    sampler_opts: Optional[samplers_mod.SamplerOptions] = None,
    callback: Optional[Callable] = None,
    fbcache: Optional[fb_mod.FBCacheConfig] = None,
) -> KSampleResult:
    """Returns the latent in decoded (VAE) space, on the model's device."""
    lf = model.latent_format
    msampling = model.model_sampling
    device = model.device
    latent_image = torch.as_tensor(latent_image).to(device=device, dtype=torch.float32)

    sigmas = trim_sigmas(sigmas_for(msampling, scheduler, steps, denoise),
                         start_step, last_step, force_full_denoise)
    if len(sigmas) < 2:
        return KSampleResult(latent=latent_image, raw=lf.process_in(latent_image))

    # the JAX package's "torch" rng mode (the only mode ported): drawn on
    # the CPU in the latent's own NHWC shape, as that package does
    shape = tuple(latent_image.shape)
    init_noise = noise_mod.prepare_noise(shape, seed)
    opts = (
        dataclasses.replace(sampler_opts, cfg_scale=cfg_scale)
        if sampler_opts is not None
        else samplers_mod.SamplerOptions(cfg_scale=cfg_scale)
    )
    sde_noise = None
    if samplers_mod.SAMPLER_ALIASES.get(sampler_name, sampler_name) in (
            "dpmpp_sde", "dpmpp_sde_cfgpp"):
        # the Brownian-tree noise of every step, on the host before the loop
        sde_noise = noise_mod.sde_noise_for_steps(
            shape, sigmas, r=samplers_mod.R, eta=samplers_mod.ETA, seed=seed)

    max_denoise = (
        abs(float(msampling.sigma_max) - float(sigmas[0])) < 1e-4
        or float(sigmas[0]) > float(msampling.sigma_max)
    )
    latent_in = lf.process_in(latent_image)
    sigma0 = torch.tensor(float(sigmas[0]), dtype=torch.float32, device=device)
    x = msampling.noise_scaling(sigma0, init_noise.to(device), latent_in,
                                max_denoise=max_denoise)

    def on_device(c):
        if c is None:
            return None
        pooled = None if c.pooled is None else torch.as_tensor(c.pooled).to(device)
        return dataclasses.replace(
            c, cross_attn=torch.as_tensor(c.cross_attn).to(device), pooled=pooled)

    fbcache = fbcache or model.model_options.get("fbcache")
    if fbcache is not None:
        denoise_fn = fb_mod.for_model(model, on_device(positive), on_device(negative),
                                      cfg_scale, fbcache)
    else:
        denoise_fn = cfg_mod.make_cfg_denoiser(
            model.apply_fn, model.params, msampling, on_device(positive),
            on_device(negative), cfg_scale,
            attn1_override_factory=model.model_options.get("attn1_override_factory"),
        )
    out = samplers_mod.sample(
        denoise_fn, x, sigmas, sampler=sampler_name,
        ms=ms if ms is not None else samplers_mod.MultiScale(),
        opts=opts, callback=callback, sde_noise=sde_noise,
    )
    sigma_last = torch.tensor(float(sigmas[-1]), dtype=torch.float32, device=device)
    raw = msampling.inverse_noise_scaling(sigma_last, out)
    return KSampleResult(latent=lf.process_out(raw), raw=raw)
