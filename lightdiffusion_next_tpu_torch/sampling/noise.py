"""Seeded initial noise.

Counterpart of lightdiffusion_next_tpu/sampling/noise.py ``prepare_noise``
in its "torch" mode: torch's CPU generator, seeded per call, gives the JAX
package's noise bit for bit. The noise is drawn in the shape of the latent
the caller passes, which is NHWC here as in the JAX package; drawing NCHW
and transposing gives different numbers.

Not ported yet: the "jax" mode, the batch-repeat ``noise_inds``, the
ancestral per-step noise and the Brownian-tree noise of the SDE samplers
(ROADMAP Queue 1, item 2).
"""

from __future__ import annotations

from typing import Sequence

import torch


def prepare_noise(shape: Sequence[int], seed: int) -> torch.Tensor:
    """Initial latent noise, f32 on the CPU."""
    generator = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(tuple(shape), generator=generator)
