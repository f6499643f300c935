"""Parameter layout conversion from the JAX package.

The JAX package keeps a flat dict of numpy arrays keyed by checkpoint names,
with conv kernels as HWIO. The port keeps the same keys with conv weights
as OIHW. This holds for the UNet, the VAE, CLIP, T5 and the Flux DiT alike.
The JAX package's Q8_0 records (``QTensor8``, ``QTensor8T``) become the
port's, with the same layout: codes int8, scales f32. Its W8A8 record
(``QTensor8W``: codes (K, N), ``col_scales`` (1, N)) becomes the port's,
whose codes are (N, K), K-contiguous. The scan layout's nested dicts
(``__double_stack__``, ``__single_stack__``, ``__t5_block_stack__``) carry
across with their stacked records: ``StackedQTensor8T`` as it is,
``StackedQTensor8W`` with its (D, K, N) codes transposed per block to
(D, N, K).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import ggml


def _tensor(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=dtype)))


def from_jax(params_np: Dict) -> Dict:
    """JAX-layout params -> the port's: 4-D HWIO -> OIHW, Q8_0 and W8A8
    records as the port's records (matched by their fields, so this module needs no
    JAX), the rest as is (f32 CPU tensors; the model constructors cast and
    place them)."""
    out = {}
    for key, value in params_np.items():
        if isinstance(value, dict):
            out[key] = from_jax(value)
            continue
        if hasattr(value, "qt3") and hasattr(value, "col_scales3"):
            q3 = np.ascontiguousarray(np.asarray(value.qt3, np.int8).transpose(0, 2, 1))
            out[key] = ggml.StackedQTensor8W(q3=torch.from_numpy(q3),
                                             col_scales3=_tensor(value.col_scales3, np.float32),
                                             shape=tuple(value.shape))
            continue
        if hasattr(value, "qt3") and hasattr(value, "scales3"):
            out[key] = ggml.StackedQTensor8T(qt3=_tensor(value.qt3, np.int8),
                                             scales3=_tensor(value.scales3, np.float32),
                                             shape=tuple(value.shape))
            continue
        if hasattr(value, "qt") and hasattr(value, "col_scales"):
            # W8A8: the JAX record's codes are (K, N); the port's (N, K)
            q = np.ascontiguousarray(np.asarray(value.qt, np.int8).T)
            out[key] = ggml.QTensor8W(q=torch.from_numpy(q),
                                      col_scales=_tensor(value.col_scales, np.float32),
                                      shape=tuple(value.shape))
            continue
        if hasattr(value, "qt") and hasattr(value, "scales_t"):
            out[key] = ggml.QTensor8T(qt=_tensor(value.qt, np.int8),
                                      scales_t=_tensor(value.scales_t, np.float32),
                                      shape=tuple(value.shape))
            continue
        if hasattr(value, "q") and hasattr(value, "scales"):
            out[key] = ggml.QTensor8(q=_tensor(value.q, np.int8),
                                     scales=_tensor(value.scales, np.float32),
                                     shape=tuple(value.shape))
            continue
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
