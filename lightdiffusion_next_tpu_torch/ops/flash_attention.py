"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of lightdiffusion_next_tpu/ops/flash_attention.py. Three entry
points, as there:

- ``packed_flash_attention`` (K1): head dims up to 64, SD1.5 level 0 at
  d = 40. Kernel: ``csrc/packed_flash_attention.cu``.
- ``flash_attention`` (K2): any head dim up to 512, including the VAE's
  single f32 head at d = 512. Kernel: ``csrc/flash_attention.cu``.
- ``fused_qkv_attention`` (K3): Flux's joint attention straight off the
  fused qkv projection, with QKNorm and the half-split RoPE in the
  kernel's prologue; ``interleaved`` reads the head-interleaved rows of
  the tensor-parallel layout. Kernel: ``csrc/fused_qkv_attention.cu``.

All compute exact non-causal attention the way the TPU kernels do: q is
pre-scaled by ``LOG2E / sqrt(d)`` in f32 and rounded back to its dtype, the
softmax runs in base 2 with f32 state, and the products accumulate in f32.
For f32 inputs the kernels keep f32 products (split-bf16 on the tensor
cores, see ``csrc/flash_attention.cuh``), as the JAX kernels multiply f32
operands in f32.

K1 and K2 run in two launches: the first writes k and v into a scratch of
kv tile images laid out for the second's shared memory (``kv_geometry``;
``pack_kv`` is its plain mirror and ``unpack_kv`` reads it back).

A wrapper takes the plain PyTorch version for a tensor on the CPU (the
tests) and launches its kernel for a CUDA tensor, or raises. It counts its
launches in ``<wrapper>.launches``. No kernel has a backward: an input that
requires grad (grad mode on) sends the call through the wrapper's
``grad_guard.no_backward``, whose backward raises, on the CPU too. ``agreement`` is the check that holds a
kernel's output against the plain version's on the card.

Layout: (B, H, L, D) in and out, like the JAX functions. The kernels read
q/k/v through their (B, H, L) strides (the last dim must be contiguous), so
head-split views of a fused projection need no copy, and they write the
result into a (B, L, H, D) buffer, returned as a (B, H, L, D) view: folding
the heads back is then free.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch.ops import cuda_build, grad_guard

LOG2E = 1.4426950408889634  # 1/ln(2)

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The plain version works on row chunks so its f32 logits stay near this
# many bytes (the kernels never form them at all).
_PLAIN_LOGIT_BYTES = 1 << 28


def supported(q, k, v) -> bool:
    """Dispatch gate (same as the JAX package): the kernels serve long
    sequences; short kv (cross-attention over 77 tokens) goes to sdpa."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    if d > 512:
        return False
    return lq >= 512 and lk >= 512


def pack_group(d: int) -> int:
    """Heads per 128-lane tile in the TPU kernel (3 at d <= 42, 2 at d <= 64,
    else 1). The port routes head dims with a group of 2 or more to K1."""
    if d <= 0:
        return 1
    return max(1, 128 // d) if d <= 64 else 1


def _attention_prescaled(qs, k, v):
    """Attention of q already in the base-2 domain (pre-scaled and rounded
    to its dtype): f32 logits, exp2 softmax, p rounded to v's dtype, f32
    products; one pass per row chunk instead of the online softmax."""
    lq, lk = qs.shape[2], k.shape[2]
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    out = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    rows = max(1, _PLAIN_LOGIT_BYTES // (4 * qs.shape[0] * qs.shape[1] * lk))
    for i0 in range(0, lq, rows):
        s = torch.matmul(qs[:, :, i0 : i0 + rows].float(), kt)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        out[:, :, i0 : i0 + rows] = o.to(qs.dtype)
    return out


def attention_plain(q, k, v):
    """Plain PyTorch version of K1 and K2: (B, H, Lq, D) x (B, H, Lk, D)
    -> (B, H, Lq, D), same math as the Pallas kernels."""
    qs = (q.float() * (LOG2E / math.sqrt(q.shape[-1]))).to(q.dtype)
    return _attention_prescaled(qs, k, v)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (7 fraction bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


# How far a kernel may stray from its plain version on the same inputs.
# bf16 outputs: both versions round their f32 result to bf16, and their f32
# results differ a little (p is rounded to bf16 against different running
# maxima), so an element can round to a neighbouring bf16 value. On an H100
# at every main-path shape of K1 and K2 the largest error was one bf16 ulp
# at the largest |plain| and the relative RMS error at most 2.5e-3; the
# limits are three ulps and 1e-2. f32 outputs (the VAE): the kernel keeps
# about 16 mantissa bits in every product (split-bf16), against the plain
# version's f32, and folds its running sum into the output every 256 kv
# tiles (csrc/flash_attention.cuh, fold_o: the tensor cores' accumulation
# drifts towards zero over many tiles); the limits are 1e-3 of max |plain|
# and a relative RMS error of 1e-4 (bf16 operands, or TF32's 10 bits, would
# not meet them). The smallest planted fault (the last kv tile of 64 rows
# skipped) moves the relative RMS error to 0.06 at Lk = 16384 and 0.03 at
# 65536. K3 (bf16) is held to the
# same bf16 limits: at its four Flux shapes it read one ulp and at most
# 2.4e-3, and its smallest planted fault 0.12.
BF16_MAX_ULPS = 3
F32_MAX_REL = 1e-3  # of max |plain|
REL_RMSE_LIMIT = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def agreement(out, ref, max_ulps=None, rel_rmse_limit=None) -> dict:
    """``out`` (a kernel's) against ``ref`` (the plain version's on the same
    inputs): max abs error and its limit, relative RMS error and its limit,
    and whether both hold. ``max_ulps`` (bf16) and ``rel_rmse_limit``
    override the limits above for a kernel that states its own."""
    ref32 = ref.float()
    diff = out.float() - ref32
    max_abs_err = diff.abs().max().item()
    peak = ref32.abs().max().item()
    rel_rmse = (diff.pow(2).mean().sqrt() / ref32.pow(2).mean().sqrt()).item()
    if out.dtype == torch.bfloat16:
        tol = (BF16_MAX_ULPS if max_ulps is None else max_ulps) * bf16_ulp(peak)
    else:
        tol = F32_MAX_REL * peak
    rel_limit = REL_RMSE_LIMIT[out.dtype] if rel_rmse_limit is None else rel_rmse_limit
    ok = (math.isfinite(max_abs_err) and math.isfinite(rel_rmse)
          and max_abs_err <= tol and rel_rmse <= rel_limit)
    return {"max_abs_err": max_abs_err, "tol": tol, "max_abs_plain": peak,
            "rel_rmse": rel_rmse, "rel_rmse_limit": rel_limit, "ok": ok}


# ---------------------------------------------------------------------------
# K1 and K2's kv tile images (csrc/flash_attention.cuh, flash_kv_kernel)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KvGeometry:
    """The tile images the kernel of one (d, dtype) reads. Per (batch, head)
    a row of tiles of ``bn`` kv rows, each ``tile_bytes``: the K image, then
    the V image. K is K-major: ``parts`` images (f32: the bf16 hi, then the
    lo halves) of [``blocks`` 64-column blocks][bn rows][128 bytes]. V is the
    same (``split``: flash_split_kernel) or transposed, [bn / 64 blocks][``dv``
    rows][128 bytes] (flash_wgmma_kernel). Every 128-byte row carries the
    128-byte swizzle; rows past Lk and columns past d are zero."""

    split: bool
    bn: int
    blocks: int
    dv: int
    parts: int

    @property
    def k_bytes(self) -> int:
        return self.parts * self.blocks * self.bn * 128

    @property
    def tile_bytes(self) -> int:
        v_bytes = self.k_bytes if self.split else (self.bn // 64) * self.dv * 128
        return self.k_bytes + v_bytes

    def tiles(self, lk: int) -> int:
        return -(-lk // self.bn)


def kv_geometry(d: int, dtype, packed: bool = False) -> KvGeometry:
    """The layout of the kernel each entry point runs at (d, dtype): bf16 up
    to d = 160 on flash_wgmma_kernel, its d rounded up to 32, 40 or 64 (K1,
    ``packed``) or to 64, 80, 96, 128 or 160 (K2), the K image padded to
    the k16 step and V transposed to d padded to 8 rows, tiles of 128 kv rows
    (64 above d = 128); f32, and bf16 above d = 160, on flash_split_kernel,
    d padded to 128, 256 or 512 and tiles of 16 kv rows."""
    if dtype == torch.bfloat16 and d <= 160:
        buckets = (32, 40, 64) if packed else (64, 80, 96, 128, 160)
        bucket = next(b for b in buckets if d <= b)
        dp = -(-bucket // 16) * 16
        return KvGeometry(False, 64 if bucket > 128 else 128, -(-dp // 64),
                          -(-bucket // 8) * 8, 1)
    dh = 64 if d <= 128 else 128 if d <= 256 else 256
    return KvGeometry(True, 16, 2 * dh // 64, 0, 2 if dtype == torch.float32 else 1)


def _swizzle(x):
    """(..., rows, 128) bytes with the 128-byte swizzle applied: 16-byte
    chunk j of row r moves to chunk j ^ (r % 8). Its own inverse."""
    rows = x.shape[-2]
    r = torch.arange(rows, device=x.device) % 8
    idx = torch.arange(8, device=x.device)[None, :] ^ r[:, None]
    chunks = x.unflatten(-1, (8, 16))
    return torch.gather(chunks, -2, idx[:, :, None].expand(chunks.shape)).flatten(-2)


def _bytes(x):
    return x.to(torch.bfloat16).contiguous().view(torch.uint8)


def _parts(x, parts):
    """x as its bf16 images: itself, or the hi and lo halves of f32."""
    if parts == 1:
        return [x.to(torch.bfloat16)]
    hi = x.to(torch.bfloat16)
    return [hi, (x.float() - hi.float()).to(torch.bfloat16)]


def _row_image(x, geom: KvGeometry, tiles: int):
    """(BH, Lk, d) -> (BH, tiles, blocks * bn * 128) K-major tile images."""
    bh, lk, d = x.shape
    xp = F.pad(x, (0, geom.blocks * 64 - d, 0, tiles * geom.bn - lk))
    xp = xp.view(bh, tiles, geom.bn, geom.blocks, 64).transpose(2, 3)
    return _swizzle(_bytes(xp)).reshape(bh, tiles, -1)


def _unrow_image(img, geom: KvGeometry):
    """The inverse of ``_row_image``: (BH, tiles * bn, blocks * 64) bf16."""
    bh, tiles = img.shape[:2]
    x = _swizzle(img.reshape(bh, tiles, geom.blocks, geom.bn, 128)).view(torch.bfloat16)
    return x.transpose(2, 3).reshape(bh, tiles * geom.bn, geom.blocks * 64)


def pack_kv(k, v, geom: KvGeometry):
    """Plain version of flash_kv_kernel: (B, H, Lk, d) k and v -> the
    (B*H, tiles, tile_bytes) uint8 scratch it writes."""
    b, h, lk, d = k.shape
    tiles = geom.tiles(lk)
    kp, vp = (_parts(x.reshape(b * h, lk, d), geom.parts) for x in (k, v))
    images = [_row_image(x, geom, tiles) for x in kp]
    if geom.split:
        images += [_row_image(x, geom, tiles) for x in vp]
    else:
        vt = F.pad(vp[0], (0, geom.dv - d, 0, tiles * geom.bn - lk))
        vt = vt.view(b * h, tiles, geom.bn // 64, 64, geom.dv).transpose(-1, -2)
        images.append(_swizzle(_bytes(vt)).reshape(b * h, tiles, -1))
    return torch.cat(images, dim=-1)


def unpack_kv(img, geom: KvGeometry):
    """The images read back, padding included: a list of K parts (B*H, kv
    rows, blocks * 64) and one of V parts ((B*H, kv rows, dv) transposed
    back, or as K's), each bf16; f32 k is ``parts[0].float() +
    parts[1].float()`` to about 16 bits."""
    bh, tiles = img.shape[:2]
    part = geom.blocks * geom.bn * 128
    ks = [_unrow_image(img[..., i * part:(i + 1) * part], geom) for i in range(geom.parts)]
    if geom.split:
        vs = [_unrow_image(img[..., geom.k_bytes + i * part:geom.k_bytes + (i + 1) * part], geom)
              for i in range(geom.parts)]
        return ks, vs
    vimg = img[..., geom.k_bytes:].reshape(bh, tiles, geom.bn // 64, geom.dv, 128)
    vt = _swizzle(vimg).view(torch.bfloat16).transpose(-1, -2)
    return ks, [vt.reshape(bh, tiles * geom.bn, geom.dv)]


def _launch(name: str, q, k, v, q_scale=None, scratch=None):
    """Check what the kernel takes, allocate the output and the tile images'
    scratch (or take ``scratch``, a (B*H, tiles, tile_bytes) uint8 tensor of
    ``kv_geometry``'s size) and launch. ``q_scale`` defaults to
    ``LOG2E / sqrt(d)``."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            f"{name}: no kernel for devices {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share dtype bf16 or f32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, L, D) tensors")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if lq == 0 or lk == 0:
        raise ValueError(f"{name}: empty sequence")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    geom = kv_geometry(d, q.dtype, packed=name == "packed_flash_attention")
    if scratch is None:
        scratch = torch.empty((b * h, geom.tiles(lk), geom.tile_bytes), dtype=torch.uint8,
                              device=q.device)
    elt = q.element_size()
    vec = all(
        t.data_ptr() % 16 == 0 and all((s * elt) % 16 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    )
    rc = cuda_build.entry_point(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[q.dtype], b, h, lq, lk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        LOG2E / math.sqrt(d) if q_scale is None else q_scale, int(vec),
        scratch.data_ptr(), scratch.numel(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel failed: {cuda_build.error_string(name, rc)}"
        )
    return out.permute(0, 2, 1, 3)


@grad_guard.no_backward("flash_attention (K2)")
def flash_attention(q, k, v):
    """K2: q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D), D <= 512."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    out = _launch("flash_attention", q, k, v)
    flash_attention.launches += 1
    return out


@grad_guard.no_backward("packed_flash_attention (K1)")
def packed_flash_attention(q, k, v):
    """K1: as ``flash_attention`` for head dims with ``pack_group(D) >= 2``
    (D <= 64)."""
    if pack_group(q.shape[-1]) < 2:
        raise ValueError(f"head dim {q.shape[-1]}: use flash_attention")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    out = _launch("packed_flash_attention", q, k, v)
    packed_flash_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: fused-prologue attention (QKNorm + RoPE + head indexing in the kernel)
# ---------------------------------------------------------------------------

ROPE_DIM = 128  # the fused kernel's head dim: one 128-lane stripe
_KV_TILE = 128  # kv rows per tile of the fused kernel's scratch (its kBN)


def _norm_rope(x, scale_img, scale_txt, txt_len, cos, sin, eps):
    """(B, L, H, 128) -> f32 QKNorm (txt scales for rows < txt_len) and the
    half-split RoPE ``x * C + roll(x, 64) * S``."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    rows = torch.arange(x.shape[1], device=x.device)[:, None] < txt_len
    sel = torch.where(rows, scale_txt.float()[None], scale_img.float()[None])
    xf = xf * sel[None, :, None, :]
    c, s = cos.float()[None, :, None, :], sin.float()[None, :, None, :]
    return xf * c + torch.roll(xf, ROPE_DIM // 2, dims=-1) * s


def split_qkv(qkv, num_heads, interleaved=False):
    """The (B, L, H, 128) q, k and v views of a fused projection's first
    3 * H * 128 columns: proj-major [q heads | k heads | v heads], or
    head-major [q_h0 | k_h0 | v_h0 | q_h1 | ...] when ``interleaved`` (the
    JAX kernel's index maps: blocks h, H + h, 2H + h, or 3h, 3h + 1, 3h + 2)."""
    b, l, _ = qkv.shape
    h, d = num_heads, ROPE_DIM
    x = qkv[..., :3 * h * d]
    if interleaved:
        x = x.reshape(b, l, h, 3, d)
        return x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    x = x.reshape(b, l, 3, h, d)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def fused_qkv_attention_plain(qkv, q_scale, k_scale, cos, sin, *, num_heads,
                              txt_len=0, txt_q_scale=None, txt_k_scale=None,
                              eps=1e-6, interleaved=False):
    """Plain PyTorch version of K3, same arithmetic and roundings: q and k
    normed and roped in f32, q scaled by LOG2E/sqrt(128), both rounded to
    qkv's dtype; then attention with p rounded to that dtype."""
    b, l, w = qkv.shape
    h, d = num_heads, ROPE_DIM
    if w < 3 * h * d:
        raise ValueError(f"qkv width {w} < 3 * {h} * {d}")
    tq = q_scale if txt_q_scale is None else txt_q_scale
    tk = k_scale if txt_k_scale is None else txt_k_scale
    q, k, v = split_qkv(qkv, h, interleaved)
    qn = (_norm_rope(q, q_scale, tq, txt_len, cos, sin, eps)
          * (LOG2E / math.sqrt(d))).to(qkv.dtype)
    kn = _norm_rope(k, k_scale, tk, txt_len, cos, sin, eps).to(qkv.dtype)
    out = _attention_prescaled(qn.transpose(1, 2), kn.transpose(1, 2),
                               v.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, l, h * d)


def _vec128(x, name):
    if x.dtype != torch.float32 or x.shape != (ROPE_DIM,) or not x.is_contiguous():
        raise ValueError(f"fused_qkv_attention: {name} must be a contiguous "
                         f"({ROPE_DIM},) f32 tensor")
    return x


def _launch_fused(qkv, q_scale, k_scale, cos, sin, num_heads, txt_len,
                  txt_q_scale, txt_k_scale, eps, lk=None, interleaved=False):
    """Check what K3 takes, allocate the output and its scratch (k normed
    and roped and v, as tiles of 128 rows laid out for the kernel's shared
    memory), launch. ``lk`` (default L) is the number of kv rows attended;
    ``interleaved`` picks the head-major stripes."""
    if not qkv.is_cuda:
        raise ValueError(f"fused_qkv_attention: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError("fused_qkv_attention: the kernel takes bf16 qkv")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention: qkv must be a contiguous (B, L, W) tensor")
    b, l, w = qkv.shape
    h = num_heads
    if w < 3 * h * ROPE_DIM or w % 8:
        raise ValueError(f"fused_qkv_attention: width {w} for {h} heads")
    for t, name in ((cos, "cos"), (sin, "sin")):
        if t.dtype != torch.float32 or t.shape != (l, ROPE_DIM) or not t.is_contiguous():
            raise ValueError(f"fused_qkv_attention: {name} must be a contiguous "
                             f"({l}, {ROPE_DIM}) f32 tensor")
    tq = q_scale if txt_q_scale is None else txt_q_scale
    tk = k_scale if txt_k_scale is None else txt_k_scale
    scales = [_vec128(t, n) for t, n in ((q_scale, "q_scale"), (k_scale, "k_scale"),
                                        (tq, "txt_q_scale"), (tk, "txt_k_scale"))]
    if any(t.device != qkv.device for t in scales + [cos, sin]):
        raise ValueError("fused_qkv_attention: every input on the qkv's device")
    out = torch.empty((b, l, h * ROPE_DIM), dtype=qkv.dtype, device=qkv.device)
    padded = -(-l // _KV_TILE) * _KV_TILE
    kv_scratch = torch.empty((b, h, padded, 2 * ROPE_DIM), dtype=qkv.dtype,
                             device=qkv.device)
    rc = cuda_build.entry_point("fused_qkv_attention")(
        qkv.data_ptr(), out.data_ptr(), kv_scratch.data_ptr(),
        *(t.data_ptr() for t in scales), cos.data_ptr(), sin.data_ptr(),
        b, h, l, l if lk is None else lk, w, txt_len, int(interleaved), eps,
        LOG2E / math.sqrt(ROPE_DIM),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("fused_qkv_attention kernel failed: "
                           + cuda_build.error_string("fused_qkv_attention", rc))
    return out


@grad_guard.no_backward("fused_qkv_attention (K3)")
def fused_qkv_attention(qkv, q_scale, k_scale, cos, sin, *, num_heads: int,
                        txt_len: int = 0, txt_q_scale=None, txt_k_scale=None,
                        eps: float = 1e-6, interleaved: bool = False):
    """K3: joint attention straight off the fused qkv projection.

    qkv: (B, L, >= 3*H*128), layout [q heads | k heads | v heads | ...];
    extra trailing columns (the single blocks' MLP lanes) are never read.
    ``interleaved``: the rows are head-major [q_h0 | k_h0 | v_h0 | q_h1 |
    ...] (``parallel.layout.to_tp_layout``, where a rank's shard holds
    whole heads); the output is head-major either way. A launch counts in
    ``launches``, or in ``launches_interleaved`` with ``interleaved`` set.
    q and k are in the permuted (half-split) RoPE basis
    (``models.flux.permute_rope_basis``). q_scale / k_scale: (128,) f32
    QKNorm scales for image rows; txt_q_scale / txt_k_scale for rows
    < txt_len (text tokens come first). cos / sin: (L, 128) f32 half-split
    tables (``models.flux.rope_cos_sin``). Returns (B, L, H*128)."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(
            qkv, q_scale, k_scale, cos, sin, num_heads=num_heads, txt_len=txt_len,
            txt_q_scale=txt_q_scale, txt_k_scale=txt_k_scale, eps=eps,
            interleaved=interleaved)
    out = _launch_fused(qkv, q_scale, k_scale, cos, sin, num_heads, txt_len,
                        txt_q_scale, txt_k_scale, eps, interleaved=interleaved)
    if interleaved:
        fused_qkv_attention.launches_interleaved += 1
    else:
        fused_qkv_attention.launches += 1
    return out


flash_attention.launches = 0
packed_flash_attention.launches = 0
fused_qkv_attention.launches = 0
fused_qkv_attention.launches_interleaved = 0
