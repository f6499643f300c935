"""Functional NN ops over flat state-dict params.

Counterpart of lightdiffusion_next_tpu/ops/nn.py. Parameters are flat dicts
keyed by the checkpoint names; forward passes are plain functions indexing
them.

``ParamView`` scopes a flat dict by key prefix; ``StackView`` does the same
over the stacked block params of the scan layout at one block index.

Layouts: activations are NHWC at every public function, as in the JAX
package. Convolution weights are OIHW (PyTorch's own layout); ``conv2d``
hands cuDNN an NCHW view of the NHWC tensor (channels-last strides, no
copy) and returns an NHWC view of its output. Linear weights are (out, in).
Norms compute their statistics in f32 whatever the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x, w, b=None):
    """x: (..., in), w: (out, in) or a Q8_0 record, b: (out,)."""
    if isinstance(w, torch.Tensor):
        y = torch.matmul(x, w.t())
    elif hasattr(w, "fused_matmul"):
        y = w.fused_matmul(x)
    else:
        y = torch.matmul(x, w.dequantize(x.dtype).t())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0):
    """x: NHWC, w: OIHW, returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """NHWC group norm, statistics in f32 (torch GroupNorm parity)."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim, statistics in f32."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def rms_norm(x, scale=None, eps: float = 1e-6):
    """RMSNorm over the last dim, in f32."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        xf = xf * scale.float()
    return xf.to(x.dtype)


def silu(x):
    return F.silu(x)


def gelu(x, approximate: bool = False):
    """GELU; ``approximate`` is the tanh form (``jax.nn.gelu``'s)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def embedding_lookup(ids, table, dtype=None):
    """ids: int (...,), table: (vocab, dim) or a row-layout Q8_0
    ``QTensor8``, dequantized after the gather (only the looked-up rows are
    formed) to ``dtype`` (bf16 by default for a quantized table)."""
    if isinstance(table, torch.Tensor):
        rows = table[ids]
        return rows if dtype is None else rows.to(dtype)
    if hasattr(table, "qt"):
        raise TypeError(
            "embedding table was laid out as a matmul QTensor8T; keep its key "
            "in to_device_quantized(embed_keys=...) so it stays row-major"
        )
    rows = table.q[ids].float() * table.scales[ids].float()[..., None]
    rows = rows.reshape(tuple(ids.shape) + (table.shape[-1],))
    return rows.to(dtype or torch.bfloat16)


def geglu(x, w, b):
    """GEGLU gate: Linear -> split -> val * gelu(gate), exact erf GELU."""
    val, gate = linear(x, w, b).chunk(2, dim=-1)
    return val * F.gelu(gate)


def interpolate_nearest(x, scale: int = 2):
    """NHWC nearest-neighbour upsample by an integer factor."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def interpolate_bilinear(x, size):
    """NHWC bilinear resize: torch's ``F.interpolate(mode="bilinear",
    align_corners=False)`` without antialias, which is what the JAX package
    reimplements."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class ParamView:
    """Prefix-scoped view over a flat param dict: p('in_layers.0.weight')."""

    __slots__ = ("params", "prefix")

    def __init__(self, params: dict, prefix: str = ""):
        self.params = params
        self.prefix = prefix

    def __call__(self, key: str):
        return self.params[self.prefix + key]

    def get(self, key: str, default=None):
        return self.params.get(self.prefix + key, default)

    def has(self, key: str) -> bool:
        return (self.prefix + key) in self.params

    def scope(self, sub: str) -> "ParamView":
        return ParamView(self.params, self.prefix + sub)


class StackView:
    """``ParamView`` over a stacked block-param dict at block ``idx`` (an
    int), for the scan layout's forwards (models/flux.py,
    models/clip/t5.py): a stacked quantized leaf returns its ``at_index``
    view, whose matmuls read block ``idx`` of the stack in place; a dense
    stacked leaf returns ``leaf[idx]``, a view, not a copy."""

    __slots__ = ("params", "idx", "prefix")

    def __init__(self, params: dict, idx: int, prefix: str = ""):
        self.params = params
        self.idx = idx
        self.prefix = prefix

    def _slice(self, leaf):
        if hasattr(leaf, "at_index"):
            return leaf.at_index(self.idx)
        return leaf[self.idx]

    def __call__(self, key: str):
        return self._slice(self.params[self.prefix + key])

    def get(self, key: str, default=None):
        leaf = self.params.get(self.prefix + key)
        return default if leaf is None else self._slice(leaf)

    def scope(self, sub: str) -> "StackView":
        return StackView(self.params, self.idx, self.prefix + sub)
