"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of lightdiffusion_next_tpu/ops/flash_attention.py. Two entry
points, as there:

- ``packed_flash_attention`` (K1): head dims up to 64, SD1.5 level 0 at
  d = 40. Kernel: ``csrc/packed_flash_attention.cu``.
- ``flash_attention`` (K2): any head dim up to 512, including the VAE's
  single f32 head at d = 512. Kernel: ``csrc/flash_attention.cu``.

Both compute exact non-causal attention the way the TPU kernels do: q is
pre-scaled by ``LOG2E / sqrt(d)`` in f32 and rounded back to its dtype, the
softmax runs in base 2 with f32 state, and the products accumulate in f32.

A wrapper takes the plain PyTorch version for a tensor on the CPU (the
tests) and launches its kernel for a CUDA tensor, or raises. It counts its
launches in ``<wrapper>.launches``. ``agreement`` is the check that holds a
kernel's output against the plain version's on the card.

Layout: (B, H, L, D) in and out, like the JAX functions. The kernels read
q/k/v through their (B, H, L) strides (the last dim must be contiguous), so
head-split views of a fused projection need no copy, and they write the
result into a (B, L, H, D) buffer, returned as a (B, H, L, D) view: folding
the heads back is then free.
"""

from __future__ import annotations

import math

import torch

from lightdiffusion_next_tpu_torch.ops import cuda_build

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


def attention_plain(q, k, v):
    """Plain PyTorch version of both kernels: (B, H, Lq, D) x (B, H, Lk, D)
    -> (B, H, Lq, D), same math as the Pallas kernels, one pass per row
    chunk instead of the online softmax."""
    d = q.shape[-1]
    lq, lk = q.shape[2], k.shape[2]
    qs = (q.float() * (LOG2E / math.sqrt(d))).to(q.dtype)
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = max(1, _PLAIN_LOGIT_BYTES // (4 * q.shape[0] * q.shape[1] * lk))
    for i0 in range(0, lq, rows):
        s = torch.matmul(qs[:, :, i0 : i0 + rows].float(), kt)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        out[:, :, i0 : i0 + rows] = o.to(q.dtype)
    return out


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (7 fraction bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


# How far a kernel may stray from its plain version on the same inputs.
# bf16 outputs: both versions round their f32 result to bf16, and their f32
# results differ a little (p is rounded to bf16 against different running
# maxima), so an element can round to a neighbouring bf16 value. On an H100
# at every main-path shape the largest error was one bf16 ulp at the
# largest |plain| and the relative RMS error at most 2.4e-3; the limits are
# three ulps and 1e-2. f32 outputs (the VAE): the kernel rounds q, k, v and
# p to bf16 for the tensor cores; measured 5.3e-3 of max |plain| and a
# relative RMS error of 3.3e-3, limits 1.5e-2 and 1e-2. The smallest
# planted fault (the last kv tile of 64 rows skipped, at Lk = 16384) moves
# the relative RMS error to 0.06 and the max error to 18 times its limit
# or more.
BF16_MAX_ULPS = 3
F32_MAX_REL = 1.5e-2  # of max |plain|
REL_RMSE_LIMIT = {torch.bfloat16: 1e-2, torch.float32: 1e-2}


def agreement(out, ref) -> dict:
    """``out`` (a kernel's) against ``ref`` (the plain version's on the same
    inputs): max abs error and its limit, relative RMS error and its limit,
    and whether both hold."""
    ref32 = ref.float()
    diff = out.float() - ref32
    max_abs_err = diff.abs().max().item()
    peak = ref32.abs().max().item()
    rel_rmse = (diff.pow(2).mean().sqrt() / ref32.pow(2).mean().sqrt()).item()
    if out.dtype == torch.bfloat16:
        tol = BF16_MAX_ULPS * bf16_ulp(peak)
    else:
        tol = F32_MAX_REL * peak
    rel_limit = REL_RMSE_LIMIT[out.dtype]
    ok = (math.isfinite(max_abs_err) and math.isfinite(rel_rmse)
          and max_abs_err <= tol and rel_rmse <= rel_limit)
    return {"max_abs_err": max_abs_err, "tol": tol, "max_abs_plain": peak,
            "rel_rmse": rel_rmse, "rel_rmse_limit": rel_limit, "ok": ok}


def _launch(name: str, q, k, v, q_scale=None):
    """Check what the kernel takes, allocate the output and launch.
    ``q_scale`` defaults to ``LOG2E / sqrt(d)``."""
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
    # f32: the kernel rounds k and v into this bf16 buffer once per call
    scratch = (torch.empty((2, b, h, lk, d), dtype=torch.bfloat16, device=q.device)
               if q.dtype == torch.float32 else None)
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
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel failed: {cuda_build.error_string(name, rc)}"
        )
    return out.permute(0, 2, 1, 3)


def flash_attention(q, k, v):
    """K2: q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D), D <= 512."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    out = _launch("flash_attention", q, k, v)
    flash_attention.launches += 1
    return out


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


flash_attention.launches = 0
packed_flash_attention.launches = 0
