"""Parameter layout conversion from the JAX package.

The JAX package keeps a flat dict of numpy arrays keyed by checkpoint names,
with conv kernels as HWIO. The port keeps the same keys with conv weights
as OIHW. This holds for the UNet, the VAE and CLIP alike (CLIP has no conv).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_jax(params_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-layout params -> the port's: 4-D HWIO -> OIHW, the rest as is
    (f32 CPU tensors; the model constructors cast and place them)."""
    out = {}
    for key, value in params_np.items():
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
