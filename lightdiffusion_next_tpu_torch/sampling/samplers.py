"""Sampler loop: DPM++(2M) with its CFG++ name, Euler with its dy CFG++
variant (``euler_cfgpp``), and the multi-scale plan.

Counterpart of lightdiffusion_next_tpu/sampling/samplers.py. Every
schedule-derived scalar is computed on the host from the numpy sigma table
(``_step_consts``, float32 as in the JAX package); the loop is a Python
loop over steps (the JAX package runs ``lax.scan`` segments). Multi-scale
steps run the model at a reduced resolution: the carried latent stays at
full resolution and only the model call is resized, bilinear down and up.

CFG++ parity: ``true_cfgpp=False`` (the default) is the reference's
effective behaviour, the plain CFG output; ``old_denoised`` starts as NaN.

``euler_dy_cfg_pp`` (alias ``euler_cfgpp``, the Flux path's) runs every
step at full resolution and, at steps 2 and 3, an extra Euler update of the
(1, 1) pixel of every 2x2 block with the model at half resolution
(``_dy_extra_step``). A stateful denoiser (FBCache: ``init_state`` and a
``(x, sigma, state)`` call) has its state threaded through the loop, made
anew when the model-call resolution changes; each dy extra call gets a
fresh state of its own and leaves the loop's untouched, as in the JAX
driver.

Not ported yet: euler, euler_ancestral and the ancestral CFG++ variants,
dpmpp_sde and dpmpp_sde_cfgpp (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import nn

SAMPLER_NAMES = ("euler_dy_cfg_pp", "dpmpp_2m", "dpmpp_2m_cfgpp")
SAMPLER_ALIASES = {"euler_cfgpp": "euler_dy_cfg_pp"}


class SampleInterrupted(Exception):
    """Raised by a sampler callback to stop; the loop returns the current
    latent."""


@dataclasses.dataclass(frozen=True)
class MultiScale:
    """Multi-scale diffusion settings."""

    enabled: bool = False
    factor: float = 0.5
    fullres_start: int = 3
    fullres_end: int = 8
    intermittent: bool = False

    @staticmethod
    def preset(name: str) -> "MultiScale":
        presets = {
            "quality": MultiScale(True, 0.5, 10, 8, True),
            "performance": MultiScale(True, 0.25, 5, 8, True),
            "balanced": MultiScale(True, 0.5, 5, 8, True),
            "disabled": MultiScale(False, 1.0, 0, 0, False),
        }
        return presets[name]


def scaled_dims(h: int, w: int, factor: float) -> Tuple[int, int]:
    """Latent dims snapped to multiples of 8."""
    return (
        int(max(8, ((h * factor) // 8) * 8)),
        int(max(8, ((w * factor) // 8) * 8)),
    )


def fullres_flags(n_steps: int, ms: MultiScale, h: int, w: int) -> np.ndarray:
    """Per-step full-resolution booleans."""
    if not ms.enabled or not (0.1 <= ms.factor <= 1.0):
        return np.ones(n_steps, dtype=bool)
    if scaled_dims(h, w, ms.factor) == (h, w):
        return np.ones(n_steps, dtype=bool)
    flags = np.zeros(n_steps, dtype=bool)
    for i in range(n_steps):
        if i < ms.fullres_start or i >= n_steps - ms.fullres_end:
            flags[i] = True
        elif ms.intermittent:
            flags[i] = (i - ms.fullres_start) % 2 == 0
    return flags


def segment_flags(flags: np.ndarray) -> List[Tuple[int, int, bool]]:
    """Contiguous (start, end, fullres) runs."""
    segs = []
    i = 0
    n = len(flags)
    while i < n:
        j = i
        while j < n and flags[j] == flags[i]:
            j += 1
        segs.append((i, j, bool(flags[i])))
        i = j
    return segs


def _step_consts(sigmas: np.ndarray) -> dict:
    """Per-step constants of the DPM++(2M) update, as float32 numpy arrays
    (the subset of the JAX package's table that this sampler reads,
    computed the same way)."""
    sig = np.asarray(sigmas, dtype=np.float64)
    c = {"sigma": sig[:-1], "sigma_next": sig[1:],
         "is_last": (sig[1:] == 0).astype(np.float64)}
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig, 1e-38))
        h = t[1:] - t[:-1]
        c["ratio"] = np.where(sig[:-1] > 0, sig[1:] / sig[:-1], 0.0)
        c["h_expm1"] = np.expm1(-np.minimum(h, 80.0))
        h_prev = np.concatenate([[np.nan], h[:-1]])
        c["h_ratio"] = np.where(np.isfinite(h_prev / (2 * h)), h_prev / (2 * h), 0.0)
    return {k: np.asarray(v, dtype=np.float32) for k, v in c.items()}


def _cfg_combine(denoised, uncond, old_den, old_unc, cs, cfg_w, true_cfgpp,
                 momentum_fn):
    """Reference-effective (identity) or true-CFG++ combination."""
    if not true_cfgpp:
        return denoised
    momentum = momentum_fn(denoised, old_den)
    uncond_momentum = momentum_fn(uncond, old_unc)
    cfgpp = uncond_momentum + (momentum - uncond_momentum) * cfg_w
    if bool(torch.isnan(old_unc.sum())) or cs["is_last"] > 0:
        return denoised
    return cfgpp


def to_d(x, sigma, denoised):
    """Euler derivative."""
    return (x - denoised) / sigma


def _euler_step(carry, cs, denoise, *, true_cfgpp, cfg_w):
    x, old_den, old_unc = carry
    denoised, uncond = denoise(x, cs["sigma"])
    cfg_den = _cfg_combine(
        denoised, uncond, old_den, old_unc, cs, cfg_w, true_cfgpp,
        momentum_fn=lambda d, od: d,
    )
    x = x + to_d(x, cs["sigma"], cfg_den) * (cs["sigma_next"] - cs["sigma"])
    return (x, denoised, uncond)


def _dy_extra_step(x, denoise_half, cs):
    """Euler update of the (1, 1) pixel of every 2x2 block, with the model
    at half resolution; an odd trailing row or column is left as it is."""
    b, h, w, ch = x.shape
    m, n = h // 2, w // 2
    c = x[:, 1:2 * m:2, 1:2 * n:2, :]
    denoised, _ = denoise_half(c, cs["sigma"])
    c = c + to_d(c, cs["sigma"], denoised) * (cs["sigma_next"] - cs["sigma"])
    x = x.clone()
    x[:, 1:2 * m:2, 1:2 * n:2, :] = c
    return x


def _dpmpp_2m_step(carry, cs, denoise, *, true_cfgpp, cfg_w):
    x, old_den, old_unc = carry
    denoised, uncond = denoise(x, cs["sigma"])
    cfg_den = _cfg_combine(
        denoised, uncond, old_den, old_unc, cs, cfg_w, true_cfgpp,
        momentum_fn=lambda d, od: (1 + cs["h_ratio"]) * d - cs["h_ratio"] * od,
    )
    x = cs["ratio"] * x - cs["h_expm1"] * cfg_den
    return (x, denoised, uncond)


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    """The CFG++ schedule (read only with ``true_cfgpp``)."""

    cfg_scale: float = 7.5
    cfg_min: float = 1.0
    cfg_x0_scale: float = 1.0
    true_cfgpp: bool = False


def sample(
    denoise_fn: Callable,
    x,
    sigmas: np.ndarray,
    sampler: str = "dpmpp_2m_cfgpp",
    ms: MultiScale = MultiScale(),
    opts: SamplerOptions = SamplerOptions(),
    callback: Optional[Callable] = None,
):
    """Run the sampler loop. ``denoise_fn(x, sigma) -> (denoised, uncond)``
    is the CFG guider, or a stateful one (``init_state``; ``(x, sigma,
    state) -> (denoised, uncond, state)``); ``x`` is the NHWC latent at full
    resolution. Returns the final latent (f32)."""
    sampler = SAMPLER_ALIASES.get(sampler, sampler)
    if sampler not in SAMPLER_NAMES:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet (ROADMAP Queue 1, item 5): "
            f"ported are {SAMPLER_NAMES}"
        )
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n_steps = len(sigmas) - 1
    if n_steps <= 0:
        return x

    b, h, w, ch = x.shape
    is_dy = sampler == "euler_dy_cfg_pp"
    flags = (np.ones(n_steps, dtype=bool) if is_dy
             else fullres_flags(n_steps, ms, h, w))
    sh, sw = scaled_dims(h, w, ms.factor) if ms.enabled else (h, w)
    consts = _step_consts(sigmas)
    steps = np.arange(n_steps, dtype=np.float32)
    cfg_sched = (
        opts.cfg_scale + (opts.cfg_min - opts.cfg_scale) * steps / max(n_steps, 1)
    ) * opts.cfg_x0_scale
    stateful = hasattr(denoise_fn, "init_state")
    dy_extra_steps = {
        i for i in range(n_steps)
        if is_dy and sigmas[i + 1] > 0 and i // 2 == 1
    }

    def with_state(box):
        """denoise(x, sigma) over a stateful denoiser's state in box[0]."""
        if not stateful:
            return denoise_fn

        def den(xx, ss):
            d, u, box[0] = denoise_fn(xx, ss, box[0])
            return d, u

        return den

    def scaled(den):
        def run(xx, ss):
            d, u = den(nn.interpolate_bilinear(xx, (sh, sw)), ss)
            return nn.interpolate_bilinear(d, (h, w)), nn.interpolate_bilinear(u, (h, w))

        return run

    def fresh_state(shape):
        return denoise_fn.init_state(torch.zeros(shape, device=x.device)) if stateful else None

    x = x.float()
    nanfill = torch.full_like(x, float("nan"))
    inner = (x, nanfill, nanfill)
    box, box_fullres = [None], None
    for i in range(n_steps):
        fullres = bool(flags[i])
        if fullres != box_fullres:
            box = [fresh_state((b, h, w, ch) if fullres else (b, sh, sw, ch))]
            box_fullres = fullres
        den = with_state(box) if fullres else scaled(with_state(box))
        if is_dy:
            # f32 host scalars: the values the JAX scan reads per step
            cs = {k: np.float32(v[i]) for k, v in consts.items()}
            inner = _euler_step(inner, cs, den, true_cfgpp=opts.true_cfgpp,
                                cfg_w=float(cfg_sched[i]))
            if i in dy_extra_steps:
                half = [fresh_state((b, h // 2, w // 2, ch))]
                inner = (_dy_extra_step(inner[0], with_state(half), cs),) + inner[1:]
        else:
            cs = {k: float(v[i]) for k, v in consts.items()}
            cs["sigma"] = torch.tensor(cs["sigma"], dtype=torch.float32, device=x.device)
            inner = _dpmpp_2m_step(inner, cs, den, true_cfgpp=opts.true_cfgpp,
                                   cfg_w=float(cfg_sched[i]))
        if callback is not None:
            try:
                callback({"x": inner[0], "i": i, "sigma": float(sigmas[i]),
                          "denoised": inner[1]})
            except SampleInterrupted:
                break
    return inner[0]
