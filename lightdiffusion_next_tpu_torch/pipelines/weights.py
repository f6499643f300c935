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
(D, N, K). A ``QTensorLoRA`` carries its base record and its f32 factors.

A TP-laid-out Flux dict (``parallel.layout.to_tp_layout``, in either
package) maps to one rank's shards with ``shard=(rank, tp)``: each leaf is
cut as ``parallel.sharding.flux_param_spec`` says, the slice a JAX array
sharded by that spec holds at that "model" coordinate.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import ggml


def _tensor(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=dtype)))


def from_jax(params_np: Dict, shard=None) -> Dict:
    """JAX-layout params -> the port's: 4-D HWIO -> OIHW, Q8_0, W8A8 and
    LoRA records as the port's records (matched by their fields, so this
    module needs no JAX), the rest as is (f32 CPU tensors; the model
    constructors cast and place them). ``shard``: (rank, tp), this rank's
    slices of a TP-laid-out Flux dict."""
    out = {key: _leaf(value) for key, value in params_np.items()}
    if shard is not None:
        from lightdiffusion_next_tpu_torch.parallel import sharding

        out = {key: sharding.shard_leaf(v, sharding.flux_param_spec(key), *shard)
               for key, v in out.items()}
    return out


def _leaf(value):
    if isinstance(value, dict):
        return from_jax(value)
    if all(hasattr(value, f) for f in ("base", "up", "down")):
        return ggml.QTensorLoRA(base=_leaf(value.base), up=_tensor(value.up, np.float32),
                                down=_tensor(value.down, np.float32))
    if hasattr(value, "qt3") and hasattr(value, "col_scales3"):
        q3 = np.ascontiguousarray(np.asarray(value.qt3, np.int8).transpose(0, 2, 1))
        return ggml.StackedQTensor8W(q3=torch.from_numpy(q3),
                                     col_scales3=_tensor(value.col_scales3, np.float32),
                                     shape=tuple(value.shape))
    if hasattr(value, "qt3") and hasattr(value, "scales3"):
        return ggml.StackedQTensor8T(qt3=_tensor(value.qt3, np.int8),
                                     scales3=_tensor(value.scales3, np.float32),
                                     shape=tuple(value.shape))
    if hasattr(value, "qt") and hasattr(value, "col_scales"):
        # W8A8: the JAX record's codes are (K, N); the port's (N, K)
        q = np.ascontiguousarray(np.asarray(value.qt, np.int8).T)
        return ggml.QTensor8W(q=torch.from_numpy(q),
                              col_scales=_tensor(value.col_scales, np.float32),
                              shape=tuple(value.shape))
    if hasattr(value, "qt") and hasattr(value, "scales_t"):
        return ggml.QTensor8T(qt=_tensor(value.qt, np.int8),
                              scales_t=_tensor(value.scales_t, np.float32),
                              shape=tuple(value.shape))
    if hasattr(value, "q") and hasattr(value, "scales"):
        return ggml.QTensor8(q=_tensor(value.q, np.int8),
                             scales=_tensor(value.scales, np.float32),
                             shape=tuple(value.shape))
    arr = np.asarray(value, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))
