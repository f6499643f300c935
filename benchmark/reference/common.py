"""Plain PyTorch arithmetic shared by the reference models.

Everything here computes in float32 with TF32 off. ``Precision`` says in
which precision an operation stated by the configuration is carried out:
the reference (``control=False``) computes every operation in f32; the
control (``control=True``) computes each one step below the precision the
configuration states for it, the step a later change might be tempted to
take:

- an operation stated in bf16 or f16 takes fp8 (e4m3) operands, each
  tensor scaled by its own absolute maximum;
- an operation stated in int8 (W8A8 weights and activations, Q8_0
  weights) takes int4 codes under the same quantization law;
- an operation stated in f32 with TF32 off takes TF32 operands (the
  mantissa rounded to 10 bits), as TF32 tensor cores would read them.

Layouts: activations are NHWC or (B, L, C); conv weights OIHW; linear
weights (out, in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # e4m3's largest finite value


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Values through e4m3 with a per-tensor scale, back in f32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def quantize_sym(x: torch.Tensor, qmax: int, dim: int = -1):
    """Symmetric quantization along ``dim``: (codes as f32, scales) with
    scale = max(absmax, 1e-12) * (1 / qmax) and codes = clip(round(x / scale))."""
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) * (1.0 / qmax)
    return torch.clamp(torch.round(x / scale), -qmax, qmax), scale


class Precision:
    """The reference's precision, or the control's one step below."""

    def __init__(self, control: bool = False):
        self.control = control
        # the int8 law's largest code, or int4's in the control
        self.qmax = 7 if control else 127

    def bf16(self, t):
        """An operand of an operation stated in bf16 (or f16)."""
        return fp8_round(t) if self.control else t.float()

    def f32(self, t):
        """An operand of an operation stated in f32."""
        return tf32_round(t) if self.control else t.float()


def linear(x, w, b=None, prec: Precision = None, stated: str = "bf16"):
    """x (..., in) @ w (out, in)^T + b in f32, operands in ``stated``'s
    precision (see ``Precision``)."""
    rnd = getattr(prec, stated) if prec is not None else (lambda t: t.float())
    y = torch.matmul(rnd(x), rnd(w).t())
    return y if b is None else y + b.float()


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0, prec: Precision = None,
           stated: str = "bf16"):
    """NHWC x, OIHW w -> NHWC, f32."""
    rnd = getattr(prec, stated) if prec is not None else (lambda t: t.float())
    y = F.conv2d(rnd(x).permute(0, 3, 1, 2), rnd(w), None, stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.float()


def w8a8_linear(x, w_codes, w_scales, b=None, prec: Precision = None):
    """The W8A8 product: x quantized per row, the weight given as its
    per-output-column codes (out, in) and scales (out, 1), the product of
    the codes summed in f32 (exact products; sums rounded in f32), then
    scaled. In the control both sides are requantized to int4 first."""
    qmax = prec.qmax if prec is not None else 127
    if qmax != 127:
        w_codes, w_scales = quantize_sym(w_codes * w_scales, qmax, dim=1)
    xq, sx = quantize_sym(x, qmax, dim=-1)
    y = torch.matmul(xq, w_codes.t()) * sx * w_scales.reshape(1, -1)
    return y if b is None else y + b.float()


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """NHWC group norm in f32."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return xf * scale.float() + bias.float()


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        xf = xf * scale.float()
    return xf if bias is None else xf + bias.float()


def rms_norm(x, scale=None, eps: float = 1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf if scale is None else xf * scale.float()


def attention(q, k, v, scale=None, bias=None, mask=None, prec: Precision = None,
              stated: str = "bf16", block: int = 4096):
    """(B, H, Lq, D) attention in f32, queries in blocks of ``block`` rows
    so that a 65 536-token call never forms its whole logits matrix.
    ``bias`` (broadcast to (B, H, Lq, Lk)) and ``mask`` are additive."""
    rnd = getattr(prec, stated) if prec is not None else (lambda t: t.float())
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    k, v = rnd(k), rnd(v)
    outs = []
    for s in range(0, q.shape[2], block):
        logits = torch.matmul(rnd(q[:, :, s:s + block]), k.transpose(-1, -2)) * scale
        if bias is not None:
            logits = logits + bias[..., s:s + block, :].float()
        if mask is not None:
            logits = logits + mask[..., s:s + block, :].float()
        outs.append(torch.matmul(rnd(torch.softmax(logits, dim=-1)), v))
    return torch.cat(outs, dim=2)


def bilinear(x, size):
    """NHWC bilinear resize, half-pixel centres, no antialiasing."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def rel_rms(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    g, w = got.double(), want.double().to(got.device)
    return float((g - w).norm() / w.norm().clamp(min=1e-300))
