"""Int8 ("sage") attention: the hand-written CUDA kernel K4 and its plain
version. Opt-in (``RuntimeConfig.sage_attention``), as in the JAX package.

Counterpart of lightdiffusion_next_tpu/ops/sage_attention.py
``sage_attention`` with ``int8_mxu=True, pv_int8=True``, the configuration
its dispatch calls. The scheme: K and V are centred over tokens (exact for
the softmax, and V's mean is added back after normalisation); Q and K are
quantized to int8 per token, V per channel, 1/sqrt(d) folded into Q's
scale; the kernel multiplies int8 by int8 with exact int32 sums, runs the
online softmax in f32 with the natural exp, quantizes P as round(p * 127)
and multiplies it by V in int8 again.

The preparation runs in plain PyTorch in the JAX package's f32 operations
(``prepare``), before the kernel; for the card it also lays the codes out
as the kernel reads them (``_kernel_operands``: d padded to the next
multiple of 32 with zero codes for Q and K, V transposed to (d, Lk) with its
tokens reordered per group of 32). The V mean is added after the kernel,
in the output's dtype.

The online softmax quantizes P against the running maximum after each
block of kv tokens, so the block width is part of the function. The kernel
and the plain version take the JAX kernel's (``softmax_block``: 1024
tokens at SD1.5's lengths); the kernel visits a block as tiles of 64
tokens (``TILE``), twice: once for the maxima, once for the rest.

Not ported (ROADMAP Queue 2): the ``pv_int8=False`` quality variant (bf16
P.V on unquantized V) and the ``int8_mxu=False`` variant (the int8 codes
multiplied at the bf16 rate); the configuration reaches neither.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch.ops import cuda_build
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30  # the masked score, as in the JAX kernel
TILE = 64  # kv tokens per tile of the kernel
HEAD_DIMS = (32, 40, 64, 80, 128, 160)  # head dims the kernel is built for

# The kernel's token order of V within each group of 32 (csrc/
# sage_attention.cu, kPermNote): stored position 4t + i holds token
# (2t, 2t+1, 8+2t, 9+2t)[i], and 16 + the same in the group's second half.
_V_ORDER = [16 * h + (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)[i]
            for h in range(2) for t in range(4) for i in range(4)]

# The kernel against its plain version on the same inputs (bf16 out). Both
# take the same softmax blocks and the same f32 operations; the sums over a
# block (of p, and of the P.V products into the accumulator) run in another
# order, and a p near a rounding edge of round(p * 127) can take the
# neighbouring code. Limits: three bf16 ulps at max |plain| and a relative
# RMS error of 1e-2, as for K1 and K2 (``flash_attention.agreement``);
# chip_smoke.py logs the measured values. The planted faults (the last kv
# tile skipped, sk not applied) must fail them.
MAX_ULPS = fa.BF16_MAX_ULPS
REL_RMSE_LIMIT = 1e-2


def _exact_block(length: int, preferred: int) -> int:
    """The divisor of ``length`` nearest ``preferred`` within [preferred/2,
    3 preferred/2], a multiple of 16; 0 if none (the JAX package's rule)."""
    if length % 16:
        return 0
    lo = max(preferred // 2, 16)
    hi = min(preferred + preferred // 2, length)
    best = 0
    for b in range(lo - lo % -16, hi + 1, 16):
        if length % b == 0 and (not best or abs(b - preferred) <= abs(best - preferred)):
            best = b
    return best


def softmax_block(lk: int, preferred: int = 1024) -> int:
    """The JAX kernel's kv block for ``lk`` tokens: an exact divisor near
    1024 that is a multiple of 128, else 1024 or ``lk`` rounded up to 128,
    whichever is smaller. Always a multiple of the kernel's tile."""
    b = _exact_block(lk, preferred)
    if b and b % 128 == 0:
        return b
    return min(preferred, -(-lk // 128) * 128)


def _quant_rows(x):
    """Per-row symmetric int8 of f32 x (..., L, D): (codes, scales (..., L,
    1)) with x ~= codes * scales."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) * (1.0 / 127.0)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def prepare(q, k, v):
    """The JAX wrapper's preparation, in f32: (qq, sq, kq, sk, vq, svs, vmu)
    with Q and the centred K quantized per token (sq holding 1/sqrt(d)),
    the centred V per channel (svs = sv * (1/127), the kernel's P.V scale)
    and V's mean over tokens. Shapes (B, H, L, D) for the codes, (B, H, L,
    1) for sq and sk, (B, H, 1, D) for svs and vmu."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    kf = kf - kf.mean(dim=2, keepdim=True)
    vmu = vf.mean(dim=2, keepdim=True)
    vf = vf - vmu
    qq, sq = _quant_rows(qf)
    kq, sk = _quant_rows(kf)
    sv = torch.clamp(vf.abs().amax(dim=2, keepdim=True), min=1e-12) * (1.0 / 127.0)
    vq = torch.clamp(torch.round(vf / sv), -127, 127).to(torch.int8)
    return qq, sq * (1.0 / math.sqrt(d)), kq, sk, vq, sv * (1.0 / 127.0), vmu


def _core_plain(qq, sq, kq, sk, vq, svs, block_k: int, out_dtype):
    """The kernel's arithmetic on prepared operands, one kv block of
    ``block_k`` tokens at a time. The int8 products are taken in f32, which
    is exact here: every partial sum is an integer below 2^24 (127 * 127 *
    160 for Q.K^T, 127 * 127 * 1024 for P.V)."""
    lk = kq.shape[2]
    qf = qq.float()
    m = torch.full(sq.shape, NEG_INF, dtype=torch.float32, device=qq.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qq.shape[:-1] + (vq.shape[-1],), dtype=torch.float32, device=qq.device)
    for k0 in range(0, lk, block_k):
        s = torch.matmul(qf, kq[:, :, k0:k0 + block_k].float().transpose(-1, -2))
        s = s * sq * sk[:, :, k0:k0 + block_k].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(torch.round(p * 127.0), vq[:, :, k0:k0 + block_k].float())
        acc = acc * alpha + pv * svs
        m = m_new
    return (acc / l).to(out_dtype)


def sage_attention_plain(q, k, v, block_k=None):
    """Plain PyTorch version of K4: q (B, H, Lq, D), k/v (B, H, Lk, D) ->
    (B, H, Lq, D) in q's dtype, the JAX kernel's f32 arithmetic written as
    tensor ops over kv blocks of ``block_k`` tokens (``softmax_block`` by
    default, the kernel's and the JAX kernel's)."""
    qq, sq, kq, sk, vq, svs, vmu = prepare(q, k, v)
    block_k = block_k or softmax_block(k.shape[2])
    out = _core_plain(qq, sq, kq, sk, vq, svs, block_k, q.dtype)
    return (out + vmu.to(out.dtype)).to(q.dtype)


def _kernel_operands(qq, sq, kq, sk, vq, svs):
    """The prepared operands in the kernel's layout (csrc/sage_attention.cu):
    (B*H, L, DP) codes, V transposed to (B*H, D, Lkp) in the kernel's token
    order, the scales as (B*H, L) and (B*H, D) rows."""
    b, h, lq, d = qq.shape
    lk = kq.shape[2]
    dp = -(-d // 32) * 32
    lkp = -(-lk // TILE) * TILE
    bh = b * h
    qq = F.pad(qq, (0, dp - d)).reshape(bh, lq, dp)
    kq = F.pad(kq, (0, dp - d)).reshape(bh, lk, dp)
    order = torch.as_tensor(_V_ORDER, device=vq.device)
    vt = F.pad(vq, (0, 0, 0, lkp - lk)).reshape(bh, lkp // 32, 32, d)[:, :, order]
    vt = vt.permute(0, 3, 1, 2).reshape(bh, d, lkp)
    return (qq.contiguous(), kq.contiguous(), vt.contiguous(), sq.reshape(bh, lq).contiguous(),
            sk.reshape(bh, lk).contiguous(), svs.reshape(bh, d).contiguous())


def _launch(q, ops, kv_tiles=None, use_sk=True):
    """Launch K4 on the kernel-layout operands ``ops`` with the JAX
    kernel's softmax block; the output is a (B, H, Lq, D) view of a (B, Lq,
    H, D) buffer. ``kv_tiles`` fewer than ceil(Lk / 64), or ``use_sk``
    False, plant a fault (for the checks)."""
    b, h, lq, d = q.shape
    qq, kq, vt, sq, sk, svs = ops
    lk = kq.shape[1]
    if not all(t.is_cuda for t in ops):
        raise ValueError(f"sage_attention: no kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"sage_attention: head dim {d} not among {HEAD_DIMS}")
    out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=q.device)
    tiles = -(-lk // TILE)
    rc = cuda_build.entry_point("sage_attention")(
        *(t.data_ptr() for t in ops), out.data_ptr(), b, h, lq, lk, d,
        out.stride(0), out.stride(2), out.stride(1),
        tiles if kv_tiles is None else kv_tiles, softmax_block(lk) // TILE, int(use_sk),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("sage_attention kernel failed: "
                           + cuda_build.error_string("sage_attention", rc))
    return out.permute(0, 2, 1, 3)


def sage_attention(q, k, v):
    """K4: q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D) in q's dtype.
    On the GPU, bf16 in and out."""
    if q.device.type == "cpu":
        return sage_attention_plain(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError("sage_attention: the kernel takes bf16 q, k, v")
    qq, sq, kq, sk, vq, svs, vmu = prepare(q, k, v)
    out = _launch(q, _kernel_operands(qq, sq, kq, sk, vq, svs))
    sage_attention.launches += 1
    return out + vmu.to(out.dtype)


sage_attention.launches = 0
