"""First-block residual cache (WaveSpeed FBCache).

Counterpart of lightdiffusion_next_tpu/sampling/fbcache.py:

- after the model's first block, the residual r = h_first - h_prev is
  compared with the previous call's: mean|r - r_prev| / mean|r_prev|, in
  f32, below the threshold means "similar";
- on a hit every remaining block is skipped and the cached final residual
  is added back; on a miss the remaining blocks run and their residual is
  cached;
- hits need a previous residual, the sigma window and, if set, fewer than
  the maximum consecutive hits;
- the state is made anew whenever the model-call resolution changes, and
  a call on its own state (the dy sampler's extra half-res call) leaves
  the main loop's state untouched.

The cache sits at the model's first-block boundary: Flux's double block 0,
or the UNet's input blocks 0 and 1 (``unet.apply_unet``'s
``first_block_hook``). The JAX package carries the state through its
compiled loop and decides
with ``lax.cond``; here the loop is eager, so the decision is taken on the
host, with one ``.item()`` of the f32 ratio per call that can hit, and
only the branch taken runs. Every decision is appended to ``history``
(True for a hit) so a run can be checked against its launch plan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.utils import profiling

# every hit (True) or miss (False), in call order; cleared by whoever reads it
history: List[bool] = []


@dataclasses.dataclass(frozen=True)
class FBCacheConfig:
    residual_diff_threshold: float = 0.12
    start: float = 0.0  # share of sampling where caching becomes active
    end: float = 1.0
    max_consecutive_cache_hits: int = -1  # < 0: unlimited

    def sigma_window(self, model_sampling) -> Tuple[float, float]:
        """(sigma_start, sigma_end): the cache may hit while
        sigma_end <= sigma <= sigma_start."""
        return (float(model_sampling.percent_to_sigma(self.start)),
                float(model_sampling.percent_to_sigma(self.end)))


@dataclasses.dataclass
class FBCacheState:
    prev_first_residual: Any
    cached_residual: Any
    consecutive_hits: int
    valid: bool  # a previous residual exists


def init_state(first_shape, residual_shape, device=None) -> FBCacheState:
    return FBCacheState(
        prev_first_residual=torch.zeros(first_shape, dtype=torch.float32, device=device),
        cached_residual=torch.zeros(residual_shape, dtype=torch.float32, device=device),
        consecutive_hits=0,
        valid=False,
    )


def make_hook(state_box, cfg: FBCacheConfig, gate: bool):
    """A ``first_block_hook(h_prev, h_first, run_rest)`` that reads and
    replaces the state in ``state_box[0]``. ``gate``: the sigma window."""

    def hook(h_prev, h_first, run_rest):
        state: FBCacheState = state_box[0]
        first_residual = (h_first - h_prev).float()
        hits_ok = (cfg.max_consecutive_cache_hits < 0
                   or state.consecutive_hits < cfg.max_consecutive_cache_hits)
        can_use = state.valid and hits_ok and gate
        if can_use:
            mean_diff = (first_residual - state.prev_first_residual).abs().mean()
            mean_prev = state.prev_first_residual.abs().mean()
            diff = mean_diff / torch.clamp(mean_prev, min=1e-12)
            with profiling.span("sync.fbcache_gate"):
                can_use = bool((diff < cfg.residual_diff_threshold).item())
        history.append(can_use)
        if can_use:
            h = h_first + state.cached_residual.to(h_first.dtype)
            state_box[0] = dataclasses.replace(
                state, consecutive_hits=state.consecutive_hits + 1, valid=True)
            return h
        h = run_rest(h_first)
        state_box[0] = FBCacheState(
            prev_first_residual=first_residual,
            cached_residual=(h - h_first).float(),
            consecutive_hits=0,
            valid=True,
        )
        return h

    return hook


class FBCachedDenoiser:
    """Stateful denoiser: ``(x, sigma, state) -> (denoised, uncond,
    state)``; ``init_state(x)`` makes the state for a model call at x's
    shape (``samplers.sample`` threads it through its loop)."""

    def __init__(self, make_denoise_with_hook, cfg: FBCacheConfig, model_sampling,
                 state_shapes_fn):
        self._make = make_denoise_with_hook
        self.cfg = cfg
        self.sigma_start, self.sigma_end = cfg.sigma_window(model_sampling)
        self._shapes_fn = state_shapes_fn

    def init_state(self, x) -> FBCacheState:
        first_shape, residual_shape = self._shapes_fn(x)
        return init_state(first_shape, residual_shape, device=x.device)

    def __call__(self, x, sigma, state: FBCacheState):
        if isinstance(sigma, torch.Tensor):
            with profiling.span("sync.fbcache_sigma"):
                sig = np.float32(sigma.max().item())
        else:
            sig = np.float32(np.max(sigma))
        # f32 comparisons, as the JAX package compares an f32 sigma
        gate = bool(np.float32(self.sigma_end) <= sig <= np.float32(self.sigma_start))
        box = [state]
        den, unc = self._make(make_hook(box, self.cfg, gate))(x, sigma)
        return den, unc, box[0]


def for_model(model, cond, uncond, cfg_scale: float,
              fb_cfg: FBCacheConfig = FBCacheConfig()) -> FBCachedDenoiser:
    """A stateful CFG denoiser with the cache at the model's first-block
    boundary (Flux's double block 0, the UNet's input block 1), with the
    model's options: its attention override (MSW-MSA),
    ``model_function_wrapper`` and ``disable_cfg1_optimization``. The state
    is f32 in the shape of that boundary's output: Flux's (B, tokens,
    hidden), the UNet's (B, H, W, model_channels), B doubled under CFG.
    The JAX package's cache key has no counterpart: the port keeps no
    compiled runners to key."""
    from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod

    opts = model.model_options
    disable_cfg1 = opts.get("disable_cfg1_optimization", False)
    batched_uncond = uncond is not None and (abs(cfg_scale - 1.0) > 1e-9 or disable_cfg1)
    model_cfg = model.config

    def make(hook):
        return cfg_mod.make_cfg_denoiser(
            model.apply_fn, model.params, model.model_sampling, cond, uncond,
            cfg_scale, first_block_hook=hook,
            attn1_override_factory=opts.get("attn1_override_factory"),
            model_wrapper=opts.get("model_function_wrapper"),
            disable_cfg1_optimization=disable_cfg1,
        )

    def shapes_fn(x):
        b = x.shape[0] * (2 if batched_uncond else 1)
        if model.model_type == "flux":
            shape = (b, (x.shape[1] // 2) * (x.shape[2] // 2), model_cfg.hidden_size)
        else:
            shape = (b, x.shape[1], x.shape[2], model_cfg.model_channels)
        return shape, shape

    return FBCachedDenoiser(make, fb_cfg, model.model_sampling, shapes_fn)
