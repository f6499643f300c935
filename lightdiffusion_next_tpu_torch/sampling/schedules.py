"""Sigma schedules and timestep embeddings.

Counterpart of lightdiffusion_next_tpu/sampling/schedules.py. Schedules are
small host computations in numpy (float32/float64 exactly as the JAX
package computes them); the timestep embedding runs in torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def append_zero(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros((1,), dtype=x.dtype)])


def make_beta_schedule(
    n_timestep: int, linear_start: float = 1e-4, linear_end: float = 2e-2
) -> np.ndarray:
    """Linear-sqrt beta schedule (float64)."""
    return (
        np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
        ** 2
    )


def sigmas_from_betas(betas: np.ndarray) -> np.ndarray:
    """sigma_t = sqrt((1-acum)/acum): the EPS discrete sigma table."""
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod).astype(np.float32)


def get_sigmas_karras(
    n: int, sigma_min: float, sigma_max: float, rho: float = 7.0
) -> np.ndarray:
    ramp = np.linspace(0, 1, n, dtype=np.float32)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas.astype(np.float32))


SCHEDULERS = ("karras",)


def calculate_sigmas(model_sampling, scheduler_name: str, steps: int) -> np.ndarray:
    """Schedule entry. Only "karras" (the SD1.5 path's) is ported."""
    if scheduler_name == "karras":
        return get_sigmas_karras(
            steps,
            sigma_min=float(model_sampling.sigma_min),
            sigma_max=float(model_sampling.sigma_max),
        )
    raise NotImplementedError(
        f"scheduler {scheduler_name!r} is not ported yet (ROADMAP Queue 1, "
        "item 5): only 'karras' is"
    )


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal embedding, [cos|sin] order. ``timesteps``: (B,) tensor.
    Returns (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(0, half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
