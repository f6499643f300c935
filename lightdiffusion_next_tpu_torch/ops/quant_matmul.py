"""Q8_0 dequant-matmul: the hand-written CUDA kernel (K5) and its plain
version.

Counterpart of lightdiffusion_next_tpu/ops/quant_matmul.py, its Q8_0 part
(``supported``, ``quant_matmul``). The weight is stored transposed, as
there: codes ``qt`` int8 (K, N) and scales ``scales_t`` f32 (K/32, N), one
scale per 32 consecutive K rows of a column. ``x`` (..., K) -> (..., N).

The kernel (``csrc/quant_matmul.cu``) dequantizes each weight element as
f32(q) * scale rounded to x's dtype (bf16), multiplies on the tensor cores
and accumulates in f32, like the Pallas kernel. ``quant_matmul`` takes the
plain version for a tensor on the CPU (the tests) and launches the kernel
for a CUDA tensor, or raises; it counts its launches in
``quant_matmul.launches``.

Not ported here: the stacked (K6), W8A8 (K7, K8) and fused-elementwise
(K9-K11) kernels (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from lightdiffusion_next_tpu_torch.ops import cuda_build

QBLOCK = 32  # Q8_0 quantization block (elements per scale)

# The kernel against its plain version (bf16 out): both dequantize to the
# same bf16 weights and accumulate in f32 in another order, so an output
# can round to a neighbouring bf16 value. Measured on an H100 at the
# main-path shapes: at most one bf16 ulp at max |plain| and a relative RMS
# error of at most 3.0e-4; the limits are three ulps and 1e-3. The planted
# faults (the last K tile skipped, each block read with its neighbour's
# scale row) read 0.064 or more.
MAX_ULPS = 3
REL_RMSE_LIMIT = 1e-3


def supported(m: int, k: int, n: int) -> bool:
    """Shapes the kernel takes (the JAX package's gate: K in 256-multiples,
    N in 128-multiples); the rest dequantize and go to ``torch.matmul``."""
    return k % 256 == 0 and n % 128 == 0 and m >= 1


def dequantize_t(qt, scales_t, dtype):
    """(K, N) int8 codes and (K/32, N) f32 scales -> (K, N) in ``dtype``:
    f32(q) * scale, then one rounding to ``dtype``."""
    k, n = qt.shape
    w = qt.float().reshape(k // QBLOCK, QBLOCK, n) * scales_t.float()[:, None, :]
    return w.reshape(k, n).to(dtype)


def quant_matmul_plain(x, qt, scales_t, out_dtype=None):
    """Plain PyTorch version of K5: the weight dequantized to x's dtype,
    the product in f32, the result rounded to ``out_dtype`` (x's dtype)."""
    out_dtype = out_dtype or x.dtype
    k, n = qt.shape
    w = dequantize_t(qt, scales_t, x.dtype).float()
    y = torch.matmul(x.reshape(-1, k).float(), w)
    return y.to(out_dtype).reshape(x.shape[:-1] + (n,))


def _launch(x2, qt, scales_t, k=None):
    """Check what the kernel takes, allocate the output and launch on the
    2-D ``x2`` (M, K). ``k`` (default K) is the number of K rows summed."""
    if not (x2.is_cuda and qt.is_cuda and scales_t.is_cuda):
        raise ValueError(f"quant_matmul: no kernel for device {x2.device}")
    if x2.dtype != torch.bfloat16 or qt.dtype != torch.int8 or scales_t.dtype != torch.float32:
        raise TypeError("quant_matmul: the kernel takes bf16 x, int8 codes, f32 scales")
    m, kx = x2.shape
    kq, n = qt.shape
    if kx != kq or scales_t.shape != (kq // QBLOCK, n) or not supported(m, kq, n):
        raise ValueError(f"quant_matmul: shapes x {tuple(x2.shape)}, qt {tuple(qt.shape)}, "
                         f"scales {tuple(scales_t.shape)}")
    if not (x2.is_contiguous() and qt.is_contiguous() and scales_t.is_contiguous()):
        raise ValueError("quant_matmul: x, qt and scales_t must be contiguous")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    rc = cuda_build.entry_point("quant_matmul")(
        x2.data_ptr(), qt.data_ptr(), scales_t.data_ptr(), out.data_ptr(),
        m, n, kq if k is None else k, kx,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("quant_matmul kernel failed: "
                           + cuda_build.error_string("quant_matmul", rc))
    return out


def quant_matmul(x, qt, scales_t, out_dtype=None):
    """K5: x (..., K) times the Q8_0 weight -> (..., N) in ``out_dtype``
    (x's dtype). On the GPU, bf16 in and out."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qt, scales_t, out_dtype)
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError("quant_matmul: the kernel writes bf16")
    k = x.shape[-1]
    out = _launch(x.reshape(-1, k).contiguous(), qt, scales_t)
    quant_matmul.launches += 1
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


quant_matmul.launches = 0
