"""Sampler loop: Euler and Euler-ancestral with their CFG++ and dy CFG++
variants, DPM++(2M) and DPM++ SDE with their CFG++ names, and the
multi-scale plan.

Counterpart of lightdiffusion_next_tpu/sampling/samplers.py. Every
schedule-derived scalar is computed on the host from the numpy sigma table
(``_step_consts``, float32 as in the JAX package); the loop is a Python
loop over steps (the JAX package runs ``lax.scan`` segments). Multi-scale
steps run the model at a reduced resolution: the carried latent stays at
full resolution and only the model call is resized, bilinear down and up.

CFG++ parity: ``true_cfgpp=False`` (the default) is the reference's
effective behaviour, the plain CFG output; ``old_denoised`` starts as NaN.

The Euler family steps with f32 host constants, as the JAX scan reads
them. ``euler`` and ``euler_ancestral`` follow the multi-scale plan; the
CFG++ variants run every step at full resolution, as in the JAX package.
The ancestral samplers (``euler_ancestral``, ``euler_ancestral_cfg_pp``,
``euler_ancestral_dy_cfg_pp``, alias ``euler_ancestral_cfgpp``: the
hires-fix pass's) step to ``sigma_down`` and add the step's noise
(``noise.step_noise_batch``, passed as ``step_noise``) times ``sigma_up``.
``euler_ancestral_dy_cfg_pp`` takes no checkerboard extra steps: neither
does the reference's, despite its name.

``euler_dy_cfg_pp`` (alias ``euler_cfgpp``, the Flux path's) runs every
step at full resolution and, at steps 2 and 3, an extra Euler update of the
(1, 1) pixel of every 2x2 block with the model at half resolution
(``_dy_extra_step``). A stateful denoiser (FBCache: ``init_state`` and a
``(x, sigma, state)`` call) has its state threaded through the loop, made
anew when the model-call resolution changes; each dy extra call gets a
fresh state of its own and leaves the loop's untouched, as in the JAX
driver.

``dpmpp_sde`` (and ``dpmpp_sde_cfgpp``) calls the model twice a step, the
second time at the midpoint sigma ``sde_sigma_mid`` on the step's own
full-res or low-res route, with the two Brownian noises drawn beforehand
(``noise.sde_noise_for_steps``, passed as ``sde_noise``); its last step
(sigma_next = 0) is one Euler step, chosen on the host from the f32
constants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.sampling import schedules

SAMPLER_NAMES = ("euler", "euler_ancestral", "euler_cfg_pp", "euler_ancestral_cfg_pp",
                 "euler_dy_cfg_pp", "euler_ancestral_dy_cfg_pp", "dpmpp_2m",
                 "dpmpp_2m_cfgpp", "dpmpp_sde", "dpmpp_sde_cfgpp")
SAMPLER_ALIASES = {"euler_cfgpp": "euler_dy_cfg_pp",
                   "euler_ancestral_cfgpp": "euler_ancestral_dy_cfg_pp"}
ANCESTRAL = ("euler_ancestral", "euler_ancestral_cfg_pp", "euler_ancestral_dy_cfg_pp")
# the samplers that follow the multi-scale plan; the other Euler variants
# run every step at full resolution
MULTISCALE = ("euler", "euler_ancestral", "dpmpp_2m", "dpmpp_2m_cfgpp", "dpmpp_sde",
              "dpmpp_sde_cfgpp")
# DPM++ SDE's ancestral eta, noise scale and midpoint ratio: the JAX
# package's SamplerOptions defaults, which no caller changes
ETA = 1.0
S_NOISE = 1.0
R = 0.5


class SampleInterrupted(Exception):
    """Raised by a sampler callback to stop; the loop returns the current
    latent."""


def callback_requests_stop(callback) -> bool:
    """Poll a callback's optional ``should_stop`` hook: loops over units of
    work (pipeline passes, USDU tiles) call it between units. An error the
    hook raises propagates (the JAX package reads it as "keep running")."""
    fn = getattr(callback, "should_stop", None)
    return bool(fn and fn())


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


def _step_consts(sigmas: np.ndarray, eta: float = ETA, r: float = R) -> dict:
    """Per-step constants of every sampler, as float32 numpy arrays,
    computed as the JAX package computes them: the ancestral split, the
    DPM++(2M) exponential integrator and the two stages of DPM++ SDE
    (``sde_*``; on the last step, sigma_next = 0, they are 0 and
    ``sde_sigma_mid`` is sigma)."""
    sig = np.asarray(sigmas, dtype=np.float64)
    n = len(sig) - 1
    c = {"sigma": sig[:-1], "sigma_next": sig[1:],
         "is_last": (sig[1:] == 0).astype(np.float64)}
    sd = np.zeros(n)
    su = np.zeros(n)
    for i in range(n):
        sd[i], su[i] = schedules.get_ancestral_step(sig[i], sig[i + 1], eta)
    c["sigma_down"], c["sigma_up"] = sd, su
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig, 1e-38))
        h = t[1:] - t[:-1]
        c["ratio"] = np.where(sig[:-1] > 0, sig[1:] / sig[:-1], 0.0)
        c["h_expm1"] = np.expm1(-np.minimum(h, 80.0))
        c["h"] = h
        h_prev = np.concatenate([[np.nan], h[:-1]])
        c["h_ratio"] = np.where(np.isfinite(h_prev / (2 * h)), h_prev / (2 * h), 0.0)
        t_, t_next = t[:-1], t[1:]
        sig_s = np.exp(-(t_ + (t_next - t_) * r))
        sd1, su1, sd2, su2 = (np.zeros(n) for _ in range(4))
        for i in range(n):
            if sig[i + 1] == 0:
                continue
            sd1[i], su1[i] = schedules.get_ancestral_step(sig[i], sig_s[i], eta)
            sd2[i], su2[i] = schedules.get_ancestral_step(sig[i], sig[i + 1], eta)
        s_ = -np.log(np.maximum(sd1, 1e-38))
        t_next_ = -np.log(np.maximum(sd2, 1e-38))
        last = sig[1:] == 0
        c["sde_sigma_mid"] = np.where(last, sig[:-1], sig_s)
        c["sde_fac1"] = np.where(last, 0.0, sd1 / np.maximum(sig[:-1], 1e-38))
        c["sde_expm1_1"] = np.where(last, 0.0, np.expm1(np.maximum(t_ - s_, -80.0)))
        c["sde_su1"] = su1
        c["sde_fac2"] = np.where(last, 0.0, sd2 / np.maximum(sig[:-1], 1e-38))
        c["sde_expm1_2"] = np.where(last, 0.0, np.expm1(np.maximum(t_ - t_next_, -80.0)))
        c["sde_su2"] = su2
        # the true-CFG++ momentum ratio (t - s_) / (2 (t - t_next)): both
        # negative, so guarded by |den|
        den = 2.0 * (t_ - t_next)
        safe_den = np.where(np.abs(den) > 1e-12, den, 1.0)
        c["sde_h_ratio"] = np.where((sig[1:] > 0) & (np.abs(den) > 1e-12),
                                    (t_ - s_) / safe_den, 0.0)
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


def _euler_step(carry, cs, denoise, *, true_cfgpp, cfg_w, noise=None):
    """Euler step to sigma_next, or with ``noise`` (ancestral) to
    sigma_down, then the noise times sigma_up."""
    x, old_den, old_unc = carry
    sigma = cs["sigma"]
    denoised, uncond = denoise(x, sigma)
    cfg_den = _cfg_combine(
        denoised, uncond, old_den, old_unc, cs, cfg_w, true_cfgpp,
        momentum_fn=lambda d, od: d,
    )
    d = to_d(x, sigma, cfg_den)
    if noise is None:
        x = x + d * (cs["sigma_next"] - sigma)
    else:
        x = x + d * (cs["sigma_down"] - sigma)
        x = x + noise * (S_NOISE * cs["sigma_up"])
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


def _dpmpp_sde_step(carry, cs, denoise, noise1, noise2, *, true_cfgpp, cfg_w):
    """Two-stage DPM++ SDE step; the last step is one Euler step."""
    x, old_den, old_unc = carry
    sigma = cs["sigma"]
    denoised, uncond = denoise(x, sigma)
    if cs["is_last"] > 0:
        return (x + to_d(x, sigma, denoised) * (cs["sigma_next"] - sigma), denoised, uncond)

    def momentum(d, od):
        return (1 + cs["sde_h_ratio"]) * d - cs["sde_h_ratio"] * od

    cfg_den = _cfg_combine(denoised, uncond, old_den, old_unc, cs, cfg_w, true_cfgpp,
                           momentum_fn=momentum)
    x2 = (cs["sde_fac1"] * x - cs["sde_expm1_1"] * cfg_den
          + noise1 * (S_NOISE * cs["sde_su1"]))
    denoised2, uncond2 = denoise(x2, cs["sde_sigma_mid"])
    cfg_den2 = _cfg_combine(denoised2, uncond2, denoised, uncond, cs, cfg_w, true_cfgpp,
                            momentum_fn=momentum)
    mix = (1 - 1 / (2 * R)) * cfg_den + (1 / (2 * R)) * cfg_den2
    x = cs["sde_fac2"] * x - cs["sde_expm1_2"] * mix + noise2 * (S_NOISE * cs["sde_su2"])
    return (x, denoised, uncond)


def chunk_marks(n_steps: int, flags, dy_extra_steps, chunk: int) -> set:
    """The step counts after which a callback with ``chunk`` > 1 fires (the
    ends of the JAX package's compiled chunks): 0 and ``n_steps``, the
    multi-scale segment bounds, each dy extra step's (i, i + 1), and every
    ``chunk``-th step. Empty for ``chunk`` <= 1: the callback fires after
    every step."""
    if chunk <= 1:
        return set()
    marks = {0, n_steps}
    for i0, i1, _ in segment_flags(flags):
        marks.update((i0, i1))
    for i in dy_extra_steps:
        marks.update((i, i + 1))
    marks.update(range(chunk, n_steps, chunk))
    return marks


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
    sde_noise: Optional[Tuple] = None,
    step_noise=None,
):
    """Run the sampler loop. ``denoise_fn(x, sigma) -> (denoised, uncond)``
    is the CFG guider, or a stateful one (``init_state``; ``(x, sigma,
    state) -> (denoised, uncond, state)``); ``x`` is the NHWC latent at full
    resolution. ``sde_noise``: dpmpp_sde's (noise1, noise2), each (n_steps,
    *x.shape); ``step_noise``: the ancestral samplers' (n_steps, *x.shape);
    each moved to x's device once (zeros when not given). ``callback(info)``
    gets the step's ``x``, ``i``, ``sigma`` and ``denoised`` after every
    step, or, when it carries ``chunk`` > 1, only after the steps that end
    a chunk (``chunk_marks``), with ``"chunk"`` in ``info``: the steps the
    JAX package's chunked mode reports. Returns the final
    latent (f32)."""
    sampler = SAMPLER_ALIASES.get(sampler, sampler)
    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler!r}")
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n_steps = len(sigmas) - 1
    if n_steps <= 0:
        return x

    b, h, w, ch = x.shape
    is_dy = sampler == "euler_dy_cfg_pp"
    is_euler = sampler.startswith("euler")
    flags = (fullres_flags(n_steps, ms, h, w) if sampler in MULTISCALE
             else np.ones(n_steps, dtype=bool))
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

    is_sde = sampler in ("dpmpp_sde", "dpmpp_sde_cfgpp")
    if is_sde:
        noise1, noise2 = (
            (torch.zeros((n_steps,) + tuple(x.shape), device=x.device),) * 2
            if sde_noise is None
            else (torch.as_tensor(n).to(device=x.device, dtype=torch.float32)
                  for n in sde_noise))

    if sampler not in ANCESTRAL:
        step_noise = None
    elif step_noise is None:
        step_noise = torch.zeros((n_steps,) + tuple(x.shape), device=x.device)
    else:
        step_noise = torch.as_tensor(step_noise).to(device=x.device, dtype=torch.float32)

    chunk = int(getattr(callback, "chunk", 0) or 0)
    marks = chunk_marks(n_steps, flags, dy_extra_steps, chunk)
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
        if is_euler:
            # f32 host scalars: the values the JAX scan reads per step
            cs = {k: np.float32(v[i]) for k, v in consts.items()}
            inner = _euler_step(inner, cs, den, true_cfgpp=opts.true_cfgpp,
                                cfg_w=float(cfg_sched[i]),
                                noise=None if step_noise is None else step_noise[i])
            if i in dy_extra_steps:
                half = [fresh_state((b, h // 2, w // 2, ch))]
                inner = (_dy_extra_step(inner[0], with_state(half), cs),) + inner[1:]
        else:
            cs = {k: float(v[i]) for k, v in consts.items()}
            for key in ("sigma", "sde_sigma_mid"):
                cs[key] = torch.tensor(cs[key], dtype=torch.float32, device=x.device)
            if is_sde:
                inner = _dpmpp_sde_step(inner, cs, den, noise1[i], noise2[i],
                                        true_cfgpp=opts.true_cfgpp,
                                        cfg_w=float(cfg_sched[i]))
            else:
                inner = _dpmpp_2m_step(inner, cs, den, true_cfgpp=opts.true_cfgpp,
                                       cfg_w=float(cfg_sched[i]))
        if callback is not None and (not marks or i + 1 in marks):
            info = {"x": inner[0], "i": i, "sigma": float(sigmas[i]), "denoised": inner[1]}
            if marks:
                info["chunk"] = chunk
            try:
                callback(info)
            except SampleInterrupted:
                break
    return inner[0]
