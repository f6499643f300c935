"""Int8 ("sage") attention: the hand-written CUDA kernel K4, its flag
variants, its preparation kernel, and their plain versions. Opt-in
(``RuntimeConfig.sage_attention``), as in the JAX package.

Counterpart of lightdiffusion_next_tpu/ops/sage_attention.py
``sage_attention``; K4 is its default, ``int8_mxu=True, pv_int8=True``,
the configuration its dispatch calls. The scheme: K and V are centred over
tokens (exact for the softmax, and V's mean is added back after
normalisation); Q and K are
quantized to int8 per token, V per channel, 1/sqrt(d) folded into Q's
scale; the kernel multiplies int8 by int8 with exact int32 sums, runs the
online softmax in f32, quantizes P as round(p * 127) and multiplies it by V
in int8 again.

On the card a call is two hand-written steps (csrc/sage_attention.cu):

- the preparation kernel (``prepare_kernel``; plain version
  ``prepare_plain``: ``prepare``, the JAX package's f32 operations, then
  ``pack_operands``) reads q, k and v through their strides and writes the
  int8 codes and f32 scales as the tile images K4 copies (layout below),
  with V's per-channel scale and mean beside them;
- K4 (``_launch``) attends over those images on integer ``wgmma`` and adds
  V's mean in f32 before the output's one bf16 rounding.

The images, in bytes per (batch, head): ``q_images(lq)`` q images of 64
rows (Q's codes [slices][64][32 bytes], then the rows' sq in f32) and
``ceil(lk / BN)`` kv images of BN tokens (K's codes [slices][BN][32 bytes],
sk[BN] f32, then V), every 32-byte row 32-byte-swizzled (its two 16-byte
halves swap in rows 4-7 of each 8 rows). A slice of Q's and K's rows is 32
int8 codes (DP = d padded to 32), or with ``int8_mxu=False`` 16 codes
widened to bf16 (KP = d padded to 16; ``row_elems``). V for K4 is its codes
transposed, [BN / 32][DV][32 bytes], each group of 32 tokens in
``_V_ORDER``; for every flag variant it is bf16 transposed, [BN / 16][d][32
bytes], the tokens in their natural order: the codes widened, or with
``pv_int8=False`` the centred values. DV is d with 40 padded to 48, BN 128
tokens for d <= 80, else 64 (``geometry``); padding holds zero codes, sq 0
and sk 1.

The online softmax quantizes P against the running maximum after each
block of kv tokens, so the block width is part of the function. The kernel
and the plain version take the JAX kernel's (``softmax_block``: 1024
tokens at SD1.5's lengths); the kernel visits a block twice, once for the
maxima and once for the rest.

The flag variants, as the JAX function takes them (only its op-level
callers set them; the dispatch and the pipelines do not):

- ``int8_mxu=False``: the same int8 codes multiplied at the bf16 rate into
  f32 accumulators. Every sum is an integer below 2^24, so the function is
  K4's exactly: the plain version's output is the default's bit for bit;
- ``pv_int8=False``, the quality variant: Q.K^T on the int8 codes as in
  K4, then P rounded to bf16 times the centred V rounded to bf16 (no V
  codes; the preparation writes bf16 V into the kv images,
  ``kv_image_bytes``, and svs = 1, which the kernel does not read), f32
  accumulators;
- both: Q.K^T at the bf16 rate and the bf16 P.V.

On the card each is an instantiation of K4's kernel with the same
pipeline and ``wgmma`` at the bf16 rate where the flags ask for it
(``_launch_variant``, csrc/sage_attention.cu), after the preparation with
the same flags, counted in the wrapper's ``VARIANT_COUNTERS[(int8_mxu,
pv_int8)]``.

No kernel has a backward: an input that requires grad goes through the
wrapper's ``grad_guard.no_backward``, whose backward raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch.ops import cuda_build, grad_guard
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.utils import profiling

NEG_INF = -1e30  # the masked score, as in the JAX kernel
HEAD_DIMS = (32, 40, 64, 80, 128, 160)  # head dims the kernel is built for
Q_ROWS = 64  # rows of a q image: one consumer warpgroup of K4
STAT_SPLITS = 16  # the most token slices of the preparation's column statistics

# K4's token order of V within each group of 32 (csrc/sage_attention.cu,
# kPermNote): stored position 4t + i holds token (2t, 2t+1, 8+2t, 9+2t)[i],
# and 16 + the same in the group's second half. The flag variants' bf16 V
# keeps the natural order.
_V_ORDER = [16 * h + (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)[i]
            for h in range(2) for t in range(4) for i in range(4)]

# The kernel against its plain version on the same inputs (bf16 out). Both
# take the same softmax blocks; the kernel's scores are in the base-2
# domain with ex2.approx, its sums over a block (of p) run in another
# order, and a p near a rounding edge of round(p * 127) can take the
# neighbouring code. Limits: three bf16 ulps at max |plain| and a relative
# RMS error of 1e-2, as for K1 and K2 (``flash_attention.agreement``);
# chip_smoke.py logs the measured values. The planted faults (the last kv
# tile skipped, sk not applied) must fail them.
MAX_ULPS = fa.BF16_MAX_ULPS
REL_RMSE_LIMIT = 1e-2

# The preparation kernel against ``prepare_plain``: Q's codes and sq are the
# same f32 operations on the same values; K's and V's follow the means over
# tokens, which the kernel sums in another order than torch's ``mean``, so a
# code may move by one where x / s lies at a rounding edge, and a scale by
# a few f32 ulps. Limits: at most PREP_CODE_SHARE of the codes differ, none
# by more than one; every scale (sq, sk, svs) within PREP_SCALE_ULPS ulps
# (relative); V's mean within PREP_MEAN_REL of its channel's max |v - vmu|
# (a mean near 0 has no relative error to speak of).
PREP_CODE_SHARE = 1e-3
PREP_CODE_MAX_DIFF = 1
PREP_SCALE_ULPS = 4
PREP_MEAN_REL = 1e-5


class Operands(NamedTuple):
    """What the preparation hands K4 or a flag variant: the q and kv images
    (uint8, (B*H, images, bytes)), V's scale over 127 and its mean ((B*H,
    d) f32), the kv length, and the flags the images were laid out for."""
    qimg: torch.Tensor
    kvimg: torch.Tensor
    svs: torch.Tensor
    vmu: torch.Tensor
    lk: int
    int8_mxu: bool = True
    pv_int8: bool = True


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


def prepare(q, k, v, pv_int8=True):
    """The JAX wrapper's preparation, in f32: (qq, sq, kq, sk, vq, svs, vmu)
    with Q and the centred K quantized per token (sq holding 1/sqrt(d)),
    the centred V per channel (svs = sv * (1/127), the kernel's P.V scale)
    and V's mean over tokens. Shapes (B, H, L, D) for the codes, (B, H, L,
    1) for sq and sk, (B, H, 1, D) for svs and vmu. ``pv_int8=False``: vq is
    the centred V rounded to bf16 and svs is ones (the JAX wrapper's
    quality variant)."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    kf = kf - kf.mean(dim=2, keepdim=True)
    vmu = vf.mean(dim=2, keepdim=True)
    vf = vf - vmu
    qq, sq = _quant_rows(qf)
    kq, sk = _quant_rows(kf)
    if pv_int8:
        sv = torch.clamp(vf.abs().amax(dim=2, keepdim=True), min=1e-12) * (1.0 / 127.0)
        vq = torch.clamp(torch.round(vf / sv), -127, 127).to(torch.int8)
        svs = sv * (1.0 / 127.0)
    else:
        vq = vf.to(torch.bfloat16)
        svs = torch.ones_like(vmu)
    return qq, sq * (1.0 / math.sqrt(d)), kq, sk, vq, svs, vmu


def _core_plain(qq, sq, kq, sk, vq, svs, block_k: int, out_dtype, pv_int8=True):
    """The kernel's arithmetic on prepared operands, one kv block of
    ``block_k`` tokens at a time. The int8 products are taken in f32, which
    is exact here: every partial sum is an integer below 2^24 (127 * 127 *
    160 for Q.K^T, 127 * 127 * 1024 for P.V), so ``int8_mxu`` (the rate the
    card multiplies the codes at) does not enter. ``pv_int8=False``: P
    rounded to bf16 times the bf16 V ``vq``, summed in f32, unscaled."""
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
        vb = vq[:, :, k0:k0 + block_k].float()
        if pv_int8:
            pv = torch.matmul(torch.round(p * 127.0), vb) * svs
        else:
            pv = torch.matmul(p.to(torch.bfloat16).float(), vb)
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).to(out_dtype)


def sage_attention_plain(q, k, v, block_k=None, pv_int8=True):
    """Plain PyTorch version of K4 and its flag variants: q (B, H, Lq, D),
    k/v (B, H, Lk, D) -> (B, H, Lq, D) in q's dtype, the JAX kernel's f32
    arithmetic written as tensor ops over kv blocks of ``block_k`` tokens
    (``softmax_block`` by default, the kernel's and the JAX kernel's). It
    takes no ``int8_mxu``: that flag changes nothing here (see
    ``_core_plain``)."""
    qq, sq, kq, sk, vq, svs, vmu = prepare(q, k, v, pv_int8)
    block_k = block_k or softmax_block(k.shape[2])
    out = _core_plain(qq, sq, kq, sk, vq, svs, block_k, q.dtype, pv_int8)
    return (out + vmu.to(out.dtype)).to(q.dtype)


def geometry(d: int):
    """(DP, DV, BN) of head dim ``d``: q and k rows in bytes, P.V's width,
    kv tokens per tile (csrc/sage_attention.cu ``Cfg``)."""
    return -(-d // 32) * 32, 48 if d == 40 else d, 128 if d <= 80 else 64


def row_elems(d: int, int8_mxu: bool = True) -> int:
    """Codes per q or k row of the images: DP (int8, k32 slices) or, with
    ``int8_mxu=False``, KP (bf16, k16 slices)."""
    return -(-d // 32) * 32 if int8_mxu else -(-d // 16) * 16


def row_bytes(d: int, int8_mxu: bool = True) -> int:
    """Bytes per q or k row of the images."""
    return row_elems(d, int8_mxu) * (1 if int8_mxu else 2)


def q_image_bytes(d: int, int8_mxu: bool = True) -> int:
    """Bytes of one q image: 64 rows of codes, then their sq."""
    return Q_ROWS * (row_bytes(d, int8_mxu) + 4)


def q_images(lq: int) -> int:
    """q images per (batch, head): ceil(lq / 128) pairs of 64 rows."""
    return -(-lq // (2 * Q_ROWS)) * 2


def _swizzle32(x):
    """(..., rows, cols) bytes -> (..., rows * cols) in the kernel's order:
    [cols / 32][rows][32], the two 16-byte halves of a row swapped in rows
    4-7 of each 8."""
    *lead, rows, cols = x.shape
    t = x.reshape(*lead, rows, cols // 32, 2, 16)
    swap = ((torch.arange(rows, device=x.device) >> 2) & 1).bool().view(rows, 1, 1, 1)
    t = torch.where(swap, t.flip(-2), t)
    return t.transpose(-4, -3).reshape(*lead, rows * cols)


def _unswizzle32(b, rows: int, cols: int):
    """The inverse of ``_swizzle32``."""
    *lead, _ = b.shape
    t = b.reshape(*lead, cols // 32, rows, 2, 16).transpose(-4, -3)
    swap = ((torch.arange(rows, device=b.device) >> 2) & 1).bool().view(rows, 1, 1, 1)
    return torch.where(swap, t.flip(-2), t).reshape(*lead, rows, cols)


def _bytes(x):
    return x.contiguous().view(torch.uint8)


def kv_image_bytes(d: int, pv_int8: bool = True, int8_mxu: bool = True) -> int:
    """Bytes of one kv image: K's codes, sk, then V: K4's codes ([BN / 32]
    [DV][32], swizzled, ``_V_ORDER``) or, for every flag variant, bf16
    ([BN / 16][d][32], swizzled, natural order)."""
    _, dv, bn = geometry(d)
    v_bytes = dv * bn if int8_mxu and pv_int8 else 2 * d * bn
    return bn * (row_bytes(d, int8_mxu) + 4) + v_bytes


def _row_image(codes, int8_mxu: bool):
    """(..., rows, row_elems) int8 codes -> their slices' bytes: int8, or
    widened to bf16 (exact)."""
    return _swizzle32(_bytes(codes if int8_mxu else codes.to(torch.bfloat16)))


def _row_codes(image, rows: int, d: int, int8_mxu: bool):
    """The inverse of ``_row_image``: (..., rows, row_elems) int8; raises
    if a widened code is not an integer."""
    x = _unswizzle32(image, rows, row_bytes(d, int8_mxu))
    return x.view(torch.int8) if int8_mxu else _exact_codes(x.view(torch.bfloat16))


def _exact_codes(x):
    codes = x.to(torch.int8)
    if not torch.equal(codes.to(x.dtype), x):
        raise ValueError("sage_attention: an image holds a bf16 code that is not an integer")
    return codes


def pack_operands(qq, sq, kq, sk, vq, svs, vmu, int8_mxu=True) -> Operands:
    """The plain layout: ``prepare``'s outputs as the preparation kernel
    writes them (see the module's docstring); a bf16 ``vq`` (``pv_int8=
    False``) goes in as bf16; ``int8_mxu=False`` widens Q's and K's codes
    to bf16."""
    b, h, lq, d = qq.shape
    lk = kq.shape[2]
    _, dv, bn = geometry(d)
    w = row_elems(d, int8_mxu)
    pv_int8 = vq.dtype != torch.bfloat16
    bh, qt, kt = b * h, q_images(lq), -(-lk // bn)
    qrows, krows = qt * Q_ROWS, kt * bn
    qc = F.pad(qq.reshape(bh, lq, d), (0, w - d, 0, qrows - lq)).view(bh, qt, Q_ROWS, w)
    qs = F.pad(sq.reshape(bh, lq), (0, qrows - lq)).view(bh, qt, Q_ROWS)
    qimg = torch.cat([_row_image(qc, int8_mxu), _bytes(qs)], dim=-1)
    kc = F.pad(kq.reshape(bh, lk, d), (0, w - d, 0, krows - lk)).view(bh, kt, bn, w)
    ks = F.pad(sk.reshape(bh, lk), (0, krows - lk), value=1.0).view(bh, kt, bn)
    if int8_mxu and pv_int8:
        order = torch.as_tensor(_V_ORDER, device=vq.device)
        vc = F.pad(vq.reshape(bh, lk, d), (0, dv - d, 0, krows - lk))
        vc = vc.view(bh, kt, bn // 32, 32, dv)[:, :, :, order].transpose(-1, -2)
        vimg = _swizzle32(_bytes(vc)).reshape(bh, kt, bn * dv)
    else:
        vc = F.pad(vq.reshape(bh, lk, d), (0, 0, 0, krows - lk)).to(torch.bfloat16)
        vc = vc.view(bh, kt, bn, d).transpose(-1, -2)
        vimg = _swizzle32(_bytes(vc)).reshape(bh, kt, 2 * d * bn)
    kvimg = torch.cat([_row_image(kc, int8_mxu), _bytes(ks), vimg], dim=-1)
    return Operands(qimg, kvimg, svs.reshape(bh, d).contiguous(),
                    vmu.reshape(bh, d).contiguous(), lk, int8_mxu, pv_int8)


def unpack_operands(ops: Operands, d: int):
    """The images of head dim ``d`` read back, padding included: q codes
    (B*H, q rows, row_elems) int8 (widened codes narrowed back) and sq (B*H,
    q rows) f32; k codes (B*H, kv rows, row_elems), sk (B*H, kv rows); v
    codes in token order, (B*H, kv rows, DV) for K4 and (B*H, kv rows, d)
    for a variant, or with ``pv_int8=False`` the bf16 V (B*H, kv rows, d).
    Rows past the lengths and columns past d are the padding."""
    _, dv, bn = geometry(d)
    bh, qt, kt = ops.kvimg.shape[0], ops.qimg.shape[1], ops.kvimg.shape[1]
    w, rb = row_elems(d, ops.int8_mxu), row_bytes(d, ops.int8_mxu)
    qcode = Q_ROWS * rb
    qc = _row_codes(ops.qimg[..., :qcode], Q_ROWS, d, ops.int8_mxu)
    qs = ops.qimg[..., qcode:].contiguous().view(torch.float32)
    kcode = bn * rb
    kc = _row_codes(ops.kvimg[..., :kcode], bn, d, ops.int8_mxu)
    ks = ops.kvimg[..., kcode:kcode + 4 * bn].contiguous().view(torch.float32)
    vimg = ops.kvimg[..., kcode + 4 * bn:]
    if ops.int8_mxu and ops.pv_int8:
        inverse = torch.as_tensor(sorted(range(32), key=_V_ORDER.__getitem__),
                                  device=ops.kvimg.device)
        vimg = vimg.reshape(bh, kt, bn // 32, dv * 32)
        vc = _unswizzle32(vimg, dv, 32).view(torch.int8).transpose(-1, -2)
        vc = vc[:, :, :, inverse].reshape(bh, kt * bn, dv)
    else:
        vc = _unswizzle32(vimg, d, 2 * bn).view(torch.bfloat16).transpose(-1, -2)
        vc = vc.reshape(bh, kt * bn, d)
        if ops.pv_int8:
            vc = _exact_codes(vc)
    return (qc.reshape(bh, qt * Q_ROWS, w), qs.reshape(bh, qt * Q_ROWS),
            kc.reshape(bh, kt * bn, w), ks.reshape(bh, kt * bn), vc)


def prepare_plain(q, k, v, pv_int8=True, int8_mxu=True) -> Operands:
    """Plain version of the preparation kernel: ``prepare``, then the
    kernel's layout for the flags."""
    return pack_operands(*prepare(q, k, v, pv_int8), int8_mxu=int8_mxu)


def prep_agreement(ops: Operands, ref: Operands, d: int) -> dict:
    """The preparation kernel's images against ``prepare_plain``'s, read
    back: codes (padding included) and scales, to the limits above; a bf16
    V as codes are (a value counts one step off within one bf16 ulp of
    either value plus its channel's difference of the means, which moves
    v - vmu before its rounding; at most PREP_CODE_SHARE of them
    different), V's mean against the largest |v - vmu| of its channel."""
    got, want = unpack_operands(ops, d), unpack_operands(ref, d)
    bf16_v = not ops.pv_int8
    ints = list(zip(got[0::2], want[0::2]))[:2 if bf16_v else 3]
    codes = [(g.int() - w.int()).abs() for g, w in ints]
    if bf16_v:
        g, w = got[4].float(), want[4].float()
        tol = (torch.maximum(g.abs(), w.abs()) * 2.0 ** -7
               + (ops.vmu - ref.vmu).abs()[:, None, :])
        diff = (g - w).abs()
        codes.append((diff > 0).int() + (diff > tol).int())
    max_diff = max(c.max().item() for c in codes)
    share = sum((c > 0).sum().item() for c in codes) / sum(c.numel() for c in codes)
    scales = [(got[1], want[1]), (got[3], want[3]), (ops.svs, ref.svs)]
    ulps = max(((g - w).abs() / (w.abs() * 2.0 ** -23).clamp(min=1e-30)).max().item()
               for g, w in scales)
    if bf16_v:
        vmax = want[4].float().abs().amax(dim=1)[:, :d]
        mean_err = ((ops.vmu - ref.vmu).abs() / vmax.clamp(min=1e-30)).max().item()
    else:
        mean_err = ((ops.vmu - ref.vmu).abs() / (ref.svs * (127.0 * 127.0))).max().item()
    ok = (max_diff <= PREP_CODE_MAX_DIFF and share <= PREP_CODE_SHARE
          and ulps <= PREP_SCALE_ULPS and mean_err <= PREP_MEAN_REL)
    return {"max_abs_err": float(max_diff), "code_diff_share": share,
            "code_diff_share_limit": PREP_CODE_SHARE,
            "scale_ulps": ulps, "scale_ulps_limit": PREP_SCALE_ULPS,
            "mean_rel_err": mean_err, "mean_rel_limit": PREP_MEAN_REL, "ok": bool(ok)}


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("sage_attention: expected (B, H, L, D) tensors")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"sage_attention: shapes {q.shape} {k.shape} {v.shape}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"sage_attention: no kernel for device {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("sage_attention: the kernel takes bf16 q, k, v")
    if d not in HEAD_DIMS:
        raise ValueError(f"sage_attention: head dim {d} not among {HEAD_DIMS}")
    for t in (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % 4 or any(s % 2 for s in t.stride()[:3]):
            raise ValueError("sage_attention: rows must be contiguous and 4-byte aligned")


@profiling.kernel_span("kernels.prepare_kernel")
def prepare_kernel(q, k, v, pv_int8=True, int8_mxu=True) -> Operands:
    """The preparation kernel: q (B, H, Lq, D), k/v (B, H, Lk, D) bf16 on
    the card, through their strides, -> the operands K4 (or the flag
    variant ``(int8_mxu, pv_int8)``) takes."""
    _check_inputs(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bn = geometry(d)[2]
    bh, qt, kt = b * h, q_images(lq), -(-lk // bn)
    dev = q.device
    qimg = torch.empty((bh, qt, q_image_bytes(d, int8_mxu)), dtype=torch.uint8, device=dev)
    kvimg = torch.empty((bh, kt, kv_image_bytes(d, pv_int8, int8_mxu)), dtype=torch.uint8,
                        device=dev)
    svs = torch.empty((bh, d), dtype=torch.float32, device=dev)
    vmu = torch.empty((bh, d), dtype=torch.float32, device=dev)
    part = torch.empty((bh, STAT_SPLITS, 4, d), dtype=torch.float32, device=dev)
    rc = cuda_build.entry_point("sage_prepare")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qimg.data_ptr(), kvimg.data_ptr(),
        svs.data_ptr(), vmu.data_ptr(), part.data_ptr(), b, h, lq, lk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], qt, kt,
        1.0 / math.sqrt(d), int(int8_mxu), int(pv_int8),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("sage_prepare kernel failed: "
                           + cuda_build.error_string("sage_prepare", rc))
    prepare_kernel.launches += 1
    return Operands(qimg, kvimg, svs, vmu, lk, bool(int8_mxu), bool(pv_int8))


def _launch(q, ops: Operands, kv_tiles=None, use_sk=True):
    """Launch K4 on the prepared operands with the JAX kernel's softmax
    block; the output is a (B, H, Lq, D) view of a (B, Lq, H, D) buffer.
    ``kv_tiles`` fewer than the kv images, or ``use_sk`` False, plant a
    fault (for the checks)."""
    b, h, lq, d = q.shape
    if not all(t.is_cuda for t in ops[:4]):
        raise ValueError(f"sage_attention: no kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"sage_attention: head dim {d} not among {HEAD_DIMS}")
    if not (ops.int8_mxu and ops.pv_int8):
        raise ValueError("sage_attention: operands prepared for a flag variant")
    bn = geometry(d)[2]
    qt, kt = ops.qimg.shape[1], ops.kvimg.shape[1]
    out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=q.device)
    rc = cuda_build.entry_point("sage_attention")(
        ops.qimg.data_ptr(), ops.kvimg.data_ptr(), ops.svs.data_ptr(), ops.vmu.data_ptr(),
        out.data_ptr(), b, h, lq, ops.lk, d, out.stride(0), out.stride(2), out.stride(1),
        qt, kt, kt if kv_tiles is None else kv_tiles, softmax_block(ops.lk) // bn, int(use_sk),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("sage_attention kernel failed: "
                           + cuda_build.error_string("sage_attention", rc))
    return out.permute(0, 2, 1, 3)


def _launch_variant(q, ops: Operands, int8_mxu: bool, pv_int8: bool, kv_tiles=None,
                    use_sk=True):
    """Launch the flag variant ``(int8_mxu, pv_int8)`` (not both True: that
    is K4) on operands prepared with the same flags; the output and the
    planted faults as for ``_launch``."""
    b, h, lq, d = q.shape
    if int8_mxu and pv_int8:
        raise ValueError("sage_attention: int8_mxu and pv_int8 both on is K4 (_launch)")
    if not all(t.is_cuda for t in ops[:4]):
        raise ValueError(f"sage_attention: no kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"sage_attention: head dim {d} not among {HEAD_DIMS}")
    if (ops.int8_mxu, ops.pv_int8) != (bool(int8_mxu), bool(pv_int8)):
        raise ValueError("sage_attention: operands prepared with other flags")
    bn = geometry(d)[2]
    qt, kt = ops.qimg.shape[1], ops.kvimg.shape[1]
    out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=q.device)
    name = "sage_attention_variant"
    rc = cuda_build.entry_point(name)(
        ops.qimg.data_ptr(), ops.kvimg.data_ptr(), ops.svs.data_ptr(), ops.vmu.data_ptr(),
        out.data_ptr(), b, h, lq, ops.lk, d, out.stride(0), out.stride(2), out.stride(1),
        qt, kt, kt if kv_tiles is None else kv_tiles, softmax_block(ops.lk) // bn, int(use_sk),
        int(int8_mxu), int(pv_int8), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: " + cuda_build.error_string(name, rc))
    return out.permute(0, 2, 1, 3)


@grad_guard.no_backward("sage_attention (K4)")
def sage_attention(q, k, v, int8_mxu=True, pv_int8=True):
    """K4: q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D) in q's dtype.
    On the GPU, bf16 in and out: the preparation kernel, then K4, or with
    ``int8_mxu`` or ``pv_int8`` off the variant kernel."""
    if q.device.type == "cpu":
        return sage_attention_plain(q, k, v, pv_int8=pv_int8)
    ops = prepare_kernel(q, k, v, pv_int8, int8_mxu)
    if int8_mxu and pv_int8:
        out = _launch(q, ops)
        sage_attention.launches += 1
    else:
        out = _launch_variant(q, ops, int8_mxu, pv_int8)
        counter = VARIANT_COUNTERS[(int8_mxu, pv_int8)]
        setattr(sage_attention, counter, getattr(sage_attention, counter) + 1)
    return out


# The variant kernel's flag pairs, (int8_mxu, pv_int8), and the wrapper's
# counter of each
VARIANT_COUNTERS = {(False, True): "launches_bf16_mxu", (True, False): "launches_pv_bf16",
                    (False, False): "launches_bf16_mxu_pv_bf16"}

sage_attention.launches = 0
for _counter in VARIANT_COUNTERS.values():
    setattr(sage_attention, _counter, 0)
prepare_kernel.launches = 0
