"""MSW-MSA windowed self-attention (HiDiffusion).

Counterpart of lightdiffusion_next_tpu/ops/window.py: a 2x2 Swin-style
window partition with a per-step shift, applied to attn1 of the SD1.5
preset's blocks (input 1, 2 / output 9, 10, 11). The shift index is a
deterministic function of the timestep, and a sigma-window gate turns the
windowing off for the first part of the trajectory.

The JAX package selects the windowed or plain branch with ``lax.cond`` on a
traced gate; here the gate is read on the host once per UNet call.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.utils import profiling

SD15_BLOCKS = (("input", 1), ("input", 2), ("output", 9), ("output", 10), ("output", 11))


def window_partition(x, hw: Tuple[int, int], shift: Tuple[int, int]):
    """(B, H*W, C) -> (B*4, H/2*W/2, C), rolled by -shift."""
    b, _, c = x.shape
    h, w = hw
    wh, ww = h // 2, w // 2
    x = x.reshape(b, h, w, c)
    x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    x = x.reshape(b, 2, wh, 2, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * 4, wh * ww, c)


def window_reverse(windows, hw: Tuple[int, int], shift: Tuple[int, int]):
    """Inverse of window_partition."""
    h, w = hw
    wh, ww = h // 2, w // 2
    b4, _, c = windows.shape
    b = b4 // 4
    x = windows.reshape(b, 2, 2, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    x = torch.roll(x.reshape(b, h, w, c), shifts=(shift[0], shift[1]), dims=(1, 2))
    return x.reshape(b, h * w, c)


def shift_for_index(hw: Tuple[int, int], idx: int) -> Tuple[int, int]:
    """Shift sizes for index 0-3."""
    wh, ww = hw[0] // 2, hw[1] // 2
    return ((wh // 4) * idx, (ww // 4) * idx)


def _rescale_tokens(x, src_hw: Tuple[int, int], dst_hw: Tuple[int, int]):
    """Resample a (B, H*W, C) token grid (the odd-dim workaround).
    ``jax.image.resize(method="nearest")`` is half-pixel centred, which is
    torch's "nearest-exact"."""
    b, _, c = x.shape
    g = x.reshape(b, src_hw[0], src_hw[1], c).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=dst_hw, mode="nearest-exact")
    return g.permute(0, 2, 3, 1).reshape(b, dst_hw[0] * dst_hw[1], c)


def make_msw_msa_override(blocks=SD15_BLOCKS, shift_idx: int = 0,
                          active: bool = True):
    """attn1 override: windowed attention on the listed blocks when
    ``active``, plain attention otherwise."""
    core = attn_ops.attention
    block_set = set(blocks)

    def override(q, k, v, heads: int, block=None, hw=None):
        applies = block in block_set and hw is not None and q.shape == k.shape
        if not (applies and active):
            return core(q, k, v, heads)
        h, w = hw
        eh, ew = ((h + 1) // 2) * 2, ((w + 1) // 2) * 2
        if (eh, ew) != (h, w):
            q, k, v = (_rescale_tokens(x, (h, w), (eh, ew)) for x in (q, k, v))
        shift = shift_for_index((eh, ew), shift_idx)
        out = core(
            window_partition(q, (eh, ew), shift),
            window_partition(k, (eh, ew), shift),
            window_partition(v, (eh, ew), shift),
            heads,
        )
        out = window_reverse(out, (eh, ew), shift)
        if (eh, ew) != (h, w):
            out = _rescale_tokens(out, (eh, ew), (h, w))
        return out

    return override


def msw_gate_bounds(model_sampling, start_percent: float = 0.2,
                    end_percent: float = 1.0) -> Tuple[float, float]:
    """(t_lo, t_hi): the timestep window in which windowing is active
    (active iff end_sigma <= sigma <= start_sigma; timestep() is monotone in
    sigma). Computed on the host from f32 sigmas, as the JAX package does."""
    start_sigma = float(model_sampling.percent_to_sigma(start_percent))
    end_sigma = float(model_sampling.percent_to_sigma(end_percent))
    t_hi = float(model_sampling.timestep(torch.tensor(start_sigma, dtype=torch.float32)))
    t_lo = float(
        model_sampling.timestep(torch.tensor(max(end_sigma, 1e-20), dtype=torch.float32))
    )
    return t_lo, t_hi


def msw_step_state(t, bounds=None) -> Tuple[int, bool]:
    """(shift index, active) for a UNet call at timesteps ``t``: the index
    is floor(max(t)) mod 4 and the gate is t_lo <= max(t) <= t_hi, both in
    f32 as in the JAX package (a float64 host value can land on the other
    side of a floor or a bound)."""
    tm = torch.max(torch.as_tensor(t).float())
    with profiling.span("sync.msw_shift"):
        idx = int(torch.remainder(torch.floor(tm).to(torch.int32), 4))
    if bounds is None:
        return idx, True
    with profiling.span("sync.msw_gate"):
        active = bool((tm <= bounds[1]) & (tm >= bounds[0]))
    return idx, active


def make_msw_msa_factory(blocks=SD15_BLOCKS, model_sampling=None,
                         start_percent: float = 0.2, end_percent: float = 1.0):
    """Timestep-indexed factory for the CFG denoiser: ``factory(t)`` returns
    the override for a UNet call at timesteps ``t``. With ``model_sampling``
    the sigma-window gate applies; without it windowing is always on."""
    bounds = (
        msw_gate_bounds(model_sampling, start_percent, end_percent)
        if model_sampling is not None else None
    )

    def factory(t):
        idx, active = msw_step_state(t, bounds)
        return make_msw_msa_override(blocks=blocks, shift_idx=idx, active=active)

    factory.bounds = bounds
    return factory
