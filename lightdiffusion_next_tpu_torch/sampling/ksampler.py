"""KSampler facade: schedule, noise (with the ancestral samplers' per-step
noise and the SDE samplers' Brownian-tree noise), CFG denoiser, sampler
loop.

Counterpart of lightdiffusion_next_tpu/sampling/ksampler.py ``ksample``,
with the noise in ``RuntimeConfig.rng_mode``, the FBCache dispatch
(``fbcache=`` or the model's ``"fbcache"`` option, on Flux or the UNet), the
denoise mask with differential diffusion (``_MaskedDenoiser``, ADetailer's
inpainting), and the JAX ``ksample``'s ComfyUI hooks: ``sigmas_override``,
``disable_noise``, ``model_wrapper`` and the model's
``model_function_wrapper`` and ``disable_cfg1_optimization`` options.
Latents are NHWC in and out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.base import DiffusionModel
from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod
from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
from lightdiffusion_next_tpu_torch.sampling import noise as noise_mod
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod
from lightdiffusion_next_tpu_torch.sampling import schedules
from lightdiffusion_next_tpu_torch.utils import profiling

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


class _MaskedDenoiser:
    """A denoiser whose output is the inner one's inside the mask and the
    base latent outside: ``den * m + base * (1 - m)`` on the denoised
    prediction only (the uncond output and an FBCache state pass through).
    A model call at a reduced resolution (a multi-scale low-res step, a dy
    half-res step) blends against the mask and the base resized to its
    shape (bilinear). With ``differential`` the mask is hardened each call:
    ``m >= thr``, thr = (timestep(max sigma) - ts_to) / max(ts_from - ts_to,
    1e-9), with ``ts_from`` and ``ts_to`` the host floats of the f32
    timesteps of the first sigma and of sigma_min, and the call's timestep
    computed in f32 on the mask's device: no value is read back to the
    host."""

    def __init__(self, inner, mask, base, model_sampling, sigma_start: float,
                 differential: bool):
        self._inner = inner
        if hasattr(inner, "init_state"):
            self.init_state = inner.init_state
        self.mask = mask
        self.base = base
        self.differential = differential
        if differential:
            self._timestep = model_sampling.timestep
            ts_from = float(model_sampling.timestep(
                torch.tensor(float(sigma_start), dtype=torch.float32)))
            ts_to = float(model_sampling.timestep(
                torch.tensor(float(model_sampling.sigma_min), dtype=torch.float32)))
            self._ts_to = torch.tensor(ts_to, dtype=torch.float32, device=mask.device)
            self._span = torch.tensor(max(ts_from - ts_to, 1e-9), dtype=torch.float32,
                                      device=mask.device)

    def mask_at(self, sigma, hw):
        """(mask, base) for a model call at ``sigma`` whose output is
        ``hw``."""
        m, base = self.mask, self.base
        if tuple(m.shape[1:3]) != tuple(hw):
            m = nn.interpolate_bilinear(m, hw)
            base = nn.interpolate_bilinear(base, hw)
        if self.differential:
            sig = torch.as_tensor(sigma, dtype=torch.float32, device=m.device)
            thr = (self._timestep(torch.max(sig)) - self._ts_to) / self._span
            m = (m >= thr).float()
        return m, base

    def __call__(self, x, sigma, *state):
        den, *rest = self._inner(x, sigma, *state)
        m, base = self.mask_at(sigma, den.shape[1:3])
        return (den * m + base * (1.0 - m), *rest)


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
    denoise_mask=None,
    differential_diffusion: bool = False,
    disable_noise: bool = False,
    sigmas_override=None,
    model_wrapper: Optional[Callable] = None,
) -> KSampleResult:
    """Returns the latent in decoded (VAE) space, on the model's device.
    ``denoise_mask``: an NHWC [0, 1] mask at the latent's size (1 =
    resample, 0 = keep the input latent), hardened along the trajectory
    with ``differential_diffusion``. ``sigmas_override``: the schedule to
    run instead of ``scheduler``'s (still trimmed by ``start_step`` and
    ``last_step``); ``disable_noise``: start from the latent without the
    initial noise. ``model_wrapper(apply, x, t, context, y)`` (else the
    model's ``model_function_wrapper`` option) wraps every model call;
    under FBCache only the option is read, as in the JAX ``ksample``."""
    with profiling.span("sampling.ksample"):
        lf = model.latent_format
        msampling = model.model_sampling
        device = model.device
        latent_image = torch.as_tensor(latent_image).to(device=device, dtype=torch.float32)

        if sigmas_override is not None:
            sigmas = np.asarray(sigmas_override, dtype=np.float32)
        else:
            sigmas = sigmas_for(msampling, scheduler, steps, denoise)
        sigmas = trim_sigmas(sigmas, start_step, last_step, force_full_denoise)
        if len(sigmas) < 2:
            return KSampleResult(latent=latent_image, raw=lf.process_in(latent_image))

        # drawn on the CPU in the latent's own NHWC shape, in the configured
        # rng mode, as the JAX package does
        rng_mode = _config.get_config().rng_mode
        shape = tuple(latent_image.shape)
        opts = (
            dataclasses.replace(sampler_opts, cfg_scale=cfg_scale)
            if sampler_opts is not None
            else samplers_mod.SamplerOptions(cfg_scale=cfg_scale)
        )
        sde_noise = step_noise = None
        name = samplers_mod.SAMPLER_ALIASES.get(sampler_name, sampler_name)
        with profiling.span("sampling.noise"):
            if disable_noise:
                init_noise = torch.zeros(shape, dtype=torch.float32)
            else:
                init_noise = noise_mod.prepare_noise(shape, seed, mode=rng_mode)
            if name in samplers_mod.ANCESTRAL:
                step_noise = noise_mod.step_noise_batch(shape, len(sigmas) - 1, seed,
                                                        mode=rng_mode)
            if name in ("dpmpp_sde", "dpmpp_sde_cfgpp"):
                # the Brownian-tree noise of every step, on the host before the loop
                sde_noise = noise_mod.sde_noise_for_steps(
                    shape, sigmas, r=samplers_mod.R, eta=samplers_mod.ETA, seed=seed,
                    mode=rng_mode)

        max_denoise = (
            abs(float(msampling.sigma_max) - float(sigmas[0])) < 1e-4
            or float(sigmas[0]) > float(msampling.sigma_max)
        )
        latent_in = lf.process_in(latent_image)
        with profiling.span("sync.sigma"):
            sigma0 = torch.tensor(float(sigmas[0]), dtype=torch.float32, device=device)
        with profiling.span("sync.noise_upload"):
            x = msampling.noise_scaling(sigma0, init_noise.to(device), latent_in,
                                        max_denoise=max_denoise)

        def on_device(c):
            if c is None:
                return None
            pooled = None if c.pooled is None else torch.as_tensor(c.pooled).to(device)
            return dataclasses.replace(
                c, cross_attn=torch.as_tensor(c.cross_attn).to(device), pooled=pooled)

        options = model.model_options
        fbcache = fbcache or options.get("fbcache")
        if fbcache is not None:
            denoise_fn = fb_mod.for_model(model, on_device(positive), on_device(negative),
                                          cfg_scale, fbcache)
        else:
            denoise_fn = cfg_mod.make_cfg_denoiser(
                model.apply_fn, model.params, msampling, on_device(positive),
                on_device(negative), cfg_scale,
                attn1_override_factory=options.get("attn1_override_factory"),
                model_wrapper=model_wrapper or options.get("model_function_wrapper"),
                disable_cfg1_optimization=options.get("disable_cfg1_optimization", False),
            )
        if denoise_mask is not None:
            mask = torch.as_tensor(denoise_mask).to(device=device, dtype=torch.float32)
            denoise_fn = _MaskedDenoiser(denoise_fn, mask, latent_in, msampling,
                                         float(sigmas[0]), differential_diffusion)
        out = samplers_mod.sample(
            denoise_fn, x, sigmas, sampler=sampler_name,
            ms=ms if ms is not None else samplers_mod.MultiScale(),
            opts=opts, callback=callback, sde_noise=sde_noise, step_noise=step_noise,
        )
        with profiling.span("sync.sigma"):
            sigma_last = torch.tensor(float(sigmas[-1]), dtype=torch.float32, device=device)
        raw = msampling.inverse_noise_scaling(sigma_last, out)
        return KSampleResult(latent=lf.process_out(raw), raw=raw)
