"""Attention entry points and their dispatch.

Counterpart of lightdiffusion_next_tpu/ops/attention.py. Long sequences
(``flash_attention.supported``: Lq, Lk >= 512 and D <= 512) go to the
hand-written kernels: all of them to the int8 attention K4
(``sage_attention``) when ``sage_attention`` is on, else head dims up to 64
to K1 (``packed_flash_attention``) when ``packed_attn`` resolves on for the
tensors' device, the rest to
K2 (``flash_attention``). The VAE's attention (``vae_attention_core``)
always takes K2. Everything
else (cross-attention over 77 text tokens, CLIP's causal attention, the
UNet's middle block, masked calls) goes to ``sdpa``.

``sdpa`` is the plain form that XLA computes for the JAX package: f32
logits, softmax in f32, probabilities rounded to v's dtype, then the second
product. No library attention kernel is called.

Functions take folded (B, L, heads*dim) tensors, except ``sdpa`` and
``attention_heads`` which take (B, H, L, D).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.ops import sage_attention as sa


def _unfold_heads(x, heads: int):
    b, l, inner = x.shape
    return x.reshape(b, l, heads, inner // heads).transpose(1, 2)


def _fold_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def sdpa(q, k, v, mask: Optional[torch.Tensor] = None):
    """(B, H, Lq, D) x (B, H, Lk, D) attention with f32 logits and softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention_xla(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """Plain attention on folded tensors (the JAX name is kept so each
    counterpart is easy to find)."""
    q, k, v = (_unfold_heads(t, heads) for t in (q, k, v))
    return _fold_heads(sdpa(q, k, v, mask=mask))


def _flash_kernel(head_dim: int, device: _config.DeviceLike = None):
    """The long-sequence kernel on ``device`` (None: the GPU): K4 when
    ``sage_attention`` is on (ahead of the packed kernel, as in the JAX
    package), else K1 or K2."""
    cfg = _config.get_config()
    if cfg.sage_attention:
        return sa.sage_attention
    if cfg.resolve_packed_attn(device) and fa.pack_group(head_dim) >= 2:
        return fa.packed_flash_attention
    return fa.flash_attention


def attention_heads(q, k, v, mask: Optional[torch.Tensor] = None):
    """Dispatching attention on head-major (B, H, L, D) tensors, returning
    folded (B, L, H*D)."""
    backend = _config.get_config().attention_backend
    if backend == "flash" and mask is None and fa.supported(q, k, v):
        return _fold_heads(_flash_kernel(q.shape[-1], q.device)(q, k, v))
    return _fold_heads(sdpa(q, k, v, mask=mask))


def attention(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """Dispatching attention on folded (B, L, heads*dim) tensors."""
    q4, k4, v4 = (_unfold_heads(t, heads) for t in (q, k, v))
    return attention_heads(q4, k4, v4, mask=mask)


def vae_attention_core(q, k, v):
    """q, k, v: (B, H, W, C) -> single-head attention over the H*W tokens.
    At a 1024^2 decode that is 16 384 tokens at C = 512 in f32: K2 runs it
    without forming the 1 GiB logits matrix."""
    b, h, w, c = q.shape
    qf, kf, vf = (t.reshape(b, 1, h * w, c) for t in (q, k, v))
    backend = _config.get_config().attention_backend
    if backend == "flash" and fa.supported(qf, kf, vf):
        out = fa.flash_attention(qf, kf, vf)
    else:
        out = sdpa(qf, kf, vf)
    return out.reshape(b, h, w, c)
