"""Model-sampling parameterization: EPS over the discrete 1000-step table.

Counterpart of lightdiffusion_next_tpu/sampling/model_sampling.py: ``EPS``
with ``ModelSamplingDiscrete`` (SD1.5) and the rectified-flow ``CONST``
with ``ModelSamplingFlux`` (Flux). The sigma tables are host numpy; the
per-call math runs on torch tensors in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.sampling import schedules


def _bcast(sigma, like):
    """View sigma as (B, 1, 1, ...) to broadcast over ``like``."""
    sigma = torch.as_tensor(sigma, device=like.device)
    if sigma.dim() == 0:
        sigma = sigma[None]
    return sigma.reshape(sigma.shape[:1] + (1,) * (like.dim() - 1))


class EPS:
    """Noise-prediction parameterization."""

    sigma_data = 1.0

    def calculate_input(self, sigma, noise):
        sigma = _bcast(sigma, noise)
        return noise / (sigma**2 + self.sigma_data**2) ** 0.5

    def calculate_denoised(self, sigma, model_output, model_input):
        sigma = _bcast(sigma, model_output)
        return model_input - model_output * sigma

    def noise_scaling(self, sigma, noise, latent_image, max_denoise: bool = False):
        if max_denoise:
            noise = noise * torch.sqrt(1.0 + sigma**2.0)
        else:
            noise = noise * _bcast(sigma, noise)
        return noise + latent_image

    def inverse_noise_scaling(self, sigma, latent):
        return latent


class ModelSamplingDiscrete(EPS):
    """Discrete 1000-step sigma table from the linear beta schedule;
    sigma_min = sigmas[0], sigma_max = sigmas[-1]."""

    def __init__(
        self,
        beta_schedule: str = "linear",
        linear_start: float = 0.00085,
        linear_end: float = 0.012,
        timesteps: int = 1000,
    ):
        betas = schedules.make_beta_schedule(
            timesteps, linear_start=linear_start, linear_end=linear_end
        )
        self.num_timesteps = timesteps
        self.linear_start = linear_start
        self.linear_end = linear_end
        self.sigmas = schedules.sigmas_from_betas(betas)
        self.log_sigmas = np.log(self.sigmas)
        self._log_sigmas_on: Dict[torch.device, torch.Tensor] = {}

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def _table(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._log_sigmas_on:
            self._log_sigmas_on[device] = torch.from_numpy(self.log_sigmas).to(device)
        return self._log_sigmas_on[device]

    def timestep(self, sigma):
        """sigma (f32 tensor) -> nearest discrete timestep index, as f32."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        dists = torch.log(sigma)[..., None] - self._table(sigma.device)
        return dists.abs().argmin(dim=-1).float()

    def sigma(self, timestep):
        """timestep (possibly fractional) -> sigma via log-space lerp (host)."""
        t = np.clip(np.asarray(timestep, dtype=np.float32), 0, len(self.sigmas) - 1)
        low_idx = np.floor(t).astype(np.int64)
        high_idx = np.ceil(t).astype(np.int64)
        w = t - np.floor(t)
        log_sigma = (1 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx]
        return np.exp(log_sigma).astype(np.float32)

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        percent = 1.0 - percent
        return float(self.sigma(np.asarray(percent * 999.0)))


class CONST:
    """Rectified-flow parameterization (Flux)."""

    def calculate_input(self, sigma, noise):
        return noise

    def calculate_denoised(self, sigma, model_output, model_input):
        sigma = _bcast(sigma, model_output)
        return model_input - model_output * sigma

    def noise_scaling(self, sigma, noise, latent_image, max_denoise: bool = False):
        return sigma * noise + (1.0 - sigma) * latent_image

    def inverse_noise_scaling(self, sigma, latent):
        return latent / (1.0 - sigma)


def flux_time_shift(mu: float, sigma: float, t):
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


class ModelSamplingFlux(CONST):
    """Flux's sigma table, sigma(t) = e^mu / (e^mu + (1/t - 1)), shift mu
    1.15 by default, over 10000 steps."""

    def __init__(self, shift: float = 1.15, timesteps: int = 10000):
        self.shift = shift
        ts = np.arange(1, timesteps + 1, dtype=np.float64) / timesteps
        self.sigmas = np.asarray(
            [flux_time_shift(shift, 1.0, float(t)) for t in ts], dtype=np.float32
        )

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    def timestep(self, sigma):
        return sigma

    def sigma(self, timestep):
        t = np.asarray(timestep, dtype=np.float64)
        return np.asarray(
            math.exp(self.shift) / (math.exp(self.shift) + (1 / t - 1) ** 1.0),
            dtype=np.float32,
        )

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 1.0
        if percent >= 1.0:
            return 0.0
        return 1.0 - percent
