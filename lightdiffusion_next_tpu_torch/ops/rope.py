"""Multi-axis rotary position embeddings (Flux's), for the unfused attention.

Counterpart of lightdiffusion_next_tpu/ops/rope.py: ``rope``, ``embed_nd``
and ``apply_rope``, a real 2x2 rotation of each interleaved feature pair.
The angles are computed in float64, as the JAX function asks for, and the
rotation matrices kept in f32. The fused attention (K3) takes its tables
from ``models.flux.rope_cos_sin`` instead.
"""

from __future__ import annotations

from typing import Sequence

import torch


def rope(pos, dim: int, theta: int = 10000):
    """pos: (..., n) -> (..., n, dim/2, 2, 2) f32 rotation matrices."""
    if dim % 2:
        raise ValueError(f"rope: odd dim {dim}")
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    omega = 1.0 / (theta**scale)
    out = pos.double()[..., None] * omega
    cos, sin = torch.cos(out), torch.sin(out)
    mat = torch.stack([cos, -sin, sin, cos], dim=-1)
    return mat.reshape(mat.shape[:-1] + (2, 2)).float()


def embed_nd(ids, axes_dim: Sequence[int], theta: int = 10000):
    """ids: (B, L, n_axes) -> pe (B, 1, L, sum(axes_dim)/2, 2, 2)."""
    embs = [rope(ids[..., i], axes_dim[i], theta) for i in range(ids.shape[-1])]
    return torch.cat(embs, dim=-3)[:, None]


def apply_rope(xq, xk, freqs_cis):
    """xq, xk: (B, H, L, D); freqs_cis: (B, 1, L, D/2, 2, 2). The rotation
    runs in f32 and the result is rounded to the input's dtype."""

    def rot(x):
        xf = x.float().reshape(x.shape[:-1] + (-1, 1, 2))
        out = freqs_cis[..., 0] * xf[..., 0] + freqs_cis[..., 1] * xf[..., 1]
        return out.reshape(x.shape).to(x.dtype)

    return rot(xq), rot(xk)
