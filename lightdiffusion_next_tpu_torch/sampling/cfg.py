"""Classifier-free guidance denoiser.

Counterpart of lightdiffusion_next_tpu/sampling/cfg.py: cond and uncond are
batched into one model call, then combined by the CFG lerp; at cfg 1.0 only
the cond branch runs, unless ``disable_cfg1_optimization`` keeps the
uncond pass. The pooled text vector goes to the model as ``y`` (Flux's
vector input; a UNet's label embedding when its params hold one, else
ignored, as in the JAX package), and Flux's distilled guidance strength as
``guidance``. ``model_wrapper(apply, x, t, context, y)`` (ComfyUI's
``model_function_wrapper``) wraps every model call. The JAX package's
jit-argument bundle, runner cache keys and the ``model_uid`` and
``latent_format`` that only key them exist for its compiled loops; eager
PyTorch needs none of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from lightdiffusion_next_tpu_torch.utils import profiling


@dataclasses.dataclass
class CondInput:
    """One conditioning entry: cross-attention context (1 or B, L, ctx_dim),
    the pooled text vector and Flux's distilled guidance strength."""

    cross_attn: Any
    pooled: Optional[Any] = None
    guidance: Optional[float] = None


def _ctx_for_batch(c, batch: int):
    if c.shape[0] == 1 and batch > 1:
        c = c.repeat(batch, 1, 1)
    return c


def pad_cross_attn_to_match(a, b):
    """Pad the shorter context to the LCM token length by repeating it."""
    la, lb = a.shape[1], b.shape[1]
    if la == lb:
        return a, b
    lcm = math.lcm(la, lb)
    if la < lcm:
        a = torch.cat([a] * (lcm // la), dim=1)
    if lb < lcm:
        b = torch.cat([b] * (lcm // lb), dim=1)
    return a, b


def cfg_result(cond_pred, uncond_pred, cond_scale: float):
    """lerp(uncond, cond, scale), skipping the math at scale == 1."""
    if uncond_pred is None or abs(cond_scale - 1.0) < 1e-9:
        return cond_pred
    return uncond_pred + (cond_pred - uncond_pred) * cond_scale


def _pool_for_batch(p, batch: int):
    p = torch.as_tensor(p)
    return p.expand((batch,) + tuple(p.shape[-1:]))


def make_cfg_denoiser(
    apply_model: Callable,
    params: Dict,
    model_sampling,
    cond: CondInput,
    uncond: Optional[CondInput],
    cond_scale: float,
    attn1_override_factory: Optional[Callable] = None,
    first_block_hook: Optional[Callable] = None,
    model_wrapper: Optional[Callable] = None,
    disable_cfg1_optimization: bool = False,
):
    """``denoise(x, sigma) -> (cfg_denoised, uncond_denoised)``: input
    scaling, timestep lookup, one (batched cond/uncond, or cond-only at
    cfg 1.0 unless ``disable_cfg1_optimization``) forward, through
    ``model_wrapper`` when given, output scaling, CFG lerp. ``x`` is an
    NHWC f32 latent, ``sigma`` a scalar, or a (B,) f32 tensor on its
    device."""
    use_uncond = uncond is not None and (
        abs(cond_scale - 1.0) > 1e-9 or disable_cfg1_optimization)
    has_pooled = cond.pooled is not None and (
        not use_uncond or uncond.pooled is not None)

    def apply(x, t, context, y, guidance):
        extra = {}
        if attn1_override_factory is not None:
            extra["attn1_override"] = attn1_override_factory(t)
        if first_block_hook is not None:
            extra["first_block_hook"] = first_block_hook
        if guidance is not None:
            extra["guidance"] = guidance
        if model_wrapper is not None:
            return model_wrapper(
                lambda xx, tt, cc, yy: apply_model(params, xx, tt, cc, y=yy, **extra),
                x, t, context, y)
        return apply_model(params, x, t, context, y=y, **extra)

    def denoise(x, sigma):
        if isinstance(sigma, torch.Tensor) and sigma.device == x.device:
            sigma = sigma.float()
        else:  # a host value: its copy to the device waits for the device
            with profiling.span("sync.sigma"):
                sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        if sigma.dim() == 0:
            sigma = sigma.expand(x.shape[0])
        xin = model_sampling.calculate_input(sigma, x)
        t = model_sampling.timestep(sigma)
        batch = x.shape[0]
        c_ctx = _ctx_for_batch(cond.cross_attn, batch)
        guidance = None
        if cond.guidance is not None:
            guidance = torch.full((batch,), cond.guidance, dtype=torch.float32,
                                  device=x.device)
        if use_uncond:
            u_ctx = _ctx_for_batch(uncond.cross_attn, batch)
            c_ctx, u_ctx = pad_cross_attn_to_match(c_ctx, u_ctx)
            y = None
            if has_pooled:
                y = torch.cat([_pool_for_batch(cond.pooled, batch),
                               _pool_for_batch(uncond.pooled, batch)])
            out = apply(torch.cat([xin, xin]), torch.cat([t, t]),
                        torch.cat([c_ctx, u_ctx]), y,
                        None if guidance is None else torch.cat([guidance, guidance]))
            den = model_sampling.calculate_denoised(
                torch.cat([sigma, sigma]), out.float(), torch.cat([x, x])
            )
            cond_pred, uncond_pred = den[:batch], den[batch:]
        else:
            y = _pool_for_batch(cond.pooled, batch) if has_pooled else None
            out = apply(xin, t, c_ctx, y, guidance)
            cond_pred = model_sampling.calculate_denoised(sigma, out.float(), x)
            uncond_pred = None
        cfg_denoised = cfg_result(cond_pred, uncond_pred, cond_scale)
        return cfg_denoised, (uncond_pred if uncond_pred is not None else cfg_denoised)

    return denoise
