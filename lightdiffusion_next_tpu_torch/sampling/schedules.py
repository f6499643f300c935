"""Sigma schedules and timestep embeddings.

Counterpart of lightdiffusion_next_tpu/sampling/schedules.py. Schedules are
small host computations in numpy (float32/float64 exactly as the JAX
package computes them); the timestep embeddings run in torch.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def normal_scheduler(model_sampling, steps: int) -> np.ndarray:
    """Timesteps evenly spaced from sigma_max's to sigma_min's, each mapped
    back to its sigma (the hires-fix pass's schedule)."""
    s = model_sampling
    start = float(s.timestep(np.asarray(s.sigma_max, dtype=np.float32)))
    end = float(s.timestep(np.asarray(s.sigma_min, dtype=np.float32)))
    timesteps = np.linspace(start, end, steps, dtype=np.float32)
    sigs = [float(s.sigma(np.asarray(ts, dtype=np.float32))) for ts in timesteps]
    sigs.append(0.0)
    return np.asarray(sigs, dtype=np.float32)


def simple_scheduler(model_sampling, steps: int) -> np.ndarray:
    """Every (len(sigmas) / steps)-th sigma of the table, from the top."""
    s = model_sampling
    sigs = []
    ss = len(s.sigmas) / steps
    for x in range(steps):
        sigs.append(float(s.sigmas[-(1 + int(x * ss))]))
    sigs.append(0.0)
    return np.asarray(sigs, dtype=np.float32)


def beta_scheduler(model_sampling, steps: int, alpha: float = 0.6,
                   beta: float = 0.6) -> np.ndarray:
    """Beta-distribution timestep spacing (arXiv 2407.12173), the Flux
    path's schedule; needs scipy."""
    import scipy.stats

    total_timesteps = len(model_sampling.sigmas) - 1
    ts_normalized = np.linspace(0, 1, steps, endpoint=False)
    ts_beta = scipy.stats.beta.ppf(1 - ts_normalized, alpha, beta)
    ts_indices = np.rint(ts_beta * total_timesteps).astype(np.int32)
    unique_ts, indices = np.unique(ts_indices, return_index=True)
    ordered_unique_ts = unique_ts[np.argsort(indices)]
    sigs = [float(model_sampling.sigmas[idx]) for idx in ordered_unique_ts]
    sigs.append(0.0)
    return np.asarray(sigs, dtype=np.float32)


SCHEDULERS = ("karras", "normal", "simple", "beta")


def calculate_sigmas(model_sampling, scheduler_name: str, steps: int) -> np.ndarray:
    """Schedule entry: "karras" (SD1.5's txt2img and img2img), "normal"
    (hires-fix), "simple" and "beta" (Flux's)."""
    if scheduler_name == "karras":
        return get_sigmas_karras(
            steps,
            sigma_min=float(model_sampling.sigma_min),
            sigma_max=float(model_sampling.sigma_max),
        )
    if scheduler_name == "normal":
        return normal_scheduler(model_sampling, steps)
    if scheduler_name == "simple":
        return simple_scheduler(model_sampling, steps)
    if scheduler_name == "beta":
        return beta_scheduler(model_sampling, steps)
    raise ValueError(f"invalid scheduler {scheduler_name!r}")


def get_ancestral_step(sigma_from: float, sigma_to: float,
                       eta: float = 1.0) -> Tuple[float, float]:
    """(sigma_down, sigma_up) split of an ancestral step."""
    if not eta:
        return sigma_to, 0.0
    sigma_up = min(
        sigma_to,
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


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


def timestep_embedding_flux(t, dim: int, max_period: int = 10000,
                            time_factor: float = 1000.0):
    """Flux's variant: t scaled by 1000, [cos|sin], zero-padded to an odd
    ``dim``. Returns (B, dim) float32."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(0, half, dtype=torch.float32, device=t.device)
        / half
    )
    args = t[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
