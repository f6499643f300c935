"""Quantized matmuls: the hand-written CUDA kernels and their plain
versions.

Counterpart of lightdiffusion_next_tpu/ops/quant_matmul.py:

- Q8_0 (``supported``, ``quant_matmul``, K5): the weight stored transposed,
  as there: codes ``qt`` int8 (K, N) and scales ``scales_t`` f32 (K/32, N),
  one scale per 32 consecutive K rows of a column. The kernel
  (``csrc/quant_matmul.cu``) dequantizes each weight element as f32(q) *
  scale rounded to x's dtype (bf16), multiplies on the tensor cores and
  accumulates in f32, like the Pallas kernel.
- W8A8 (``quantize_rows``, ``supported_w8a8``, ``w8a8_matmul``, K7): x is
  row-quantized to int8 with one f32 scale per row, the weight holds int8
  codes with one f32 scale per output column (``ggml.QTensor8W``), the
  product is int8 x int8 with an exact int32 accumulator, and
  ``o = (f32(acc) * sx) * cs``. The weight's codes are (N, K),
  K-contiguous: the JAX record's ``qt`` transposed (``csrc/w8a8_matmul.cu``
  says why).
- The fused-elementwise W8A8 path (``supported_rowquant``,
  ``row_quantize_fused`` K9, ``row_quantize_concat_gelu`` K10,
  ``w8a8_matmul_ep`` K11): the LayerNorm + modulation or the GELU runs
  inside the row quantization, and the bias, gate and residual inside the
  matmul's epilogue (``csrc/row_quantize.cu``, ``csrc/w8a8_matmul.cu``).

- The stacked operands of the scan layout (``quant_matmul_stacked`` K6,
  ``w8a8_matmul_stacked`` K8, ``w8a8_matmul_ep_stacked`` the stacked K11,
  also reached through ``w8a8_matmul_ep``'s ``(q3, idx)`` operand): the
  weight is block ``idx`` of a stack of D same-shaped weights, read in
  place by the same device code as K5, K7 and K11 (no copy of the block).
  Q8_0 stacks are (D, K, N) codes and (D, K/32, N) scales; W8A8 stacks
  (D, N, K) codes, each block the port's (N, K) layout, and (D, 1, N)
  column scales. A block of the largest stack (the single blocks'
  ``linear1``: 38 x 21504 x 3072 bytes) lies past 2^31 bytes, so the
  kernels compute block offsets in 64 bits (the W8A8 kernel: the block as a
  row offset into the whole stack's tensor map).

Each wrapper takes the plain version for a tensor on the CPU (the tests)
and launches its kernel for a CUDA tensor, or raises; it counts its
launches in ``<wrapper>.launches`` (the int8 W8A8 kernel's launches of all
four also by tile id in ``W8A8_TILE_LAUNCHES``); an input that requires grad
(grad mode on) sends the call through the wrapper's ``grad_guard.no_backward``, whose
backward raises: no kernel has a backward. K7's and K8's row quantization is K9's
"none" law, so on the card ``w8a8_matmul`` launches K9 and then K7, and
``w8a8_matmul_stacked`` K9 and then K8.

``int8_mxu=False`` on ``w8a8_matmul``, ``w8a8_matmul_stacked``,
``w8a8_matmul_ep`` and ``w8a8_matmul_ep_stacked`` (default True, as in the
JAX package, whose pipelines never set it): the same int8 operands
multiplied at the bf16 rate into an f32 accumulator
(``csrc/w8a8_matmul_bf16.cu``, ``wgmma`` on the bf16 tensor cores, the
codes converted to bf16 on the way, tiles by shape), with the same
epilogues; counted in each wrapper's ``launches_bf16``. Its plain
version multiplies the codes as f32 (``torch.matmul``), exact while a
partial sum stays below 2^24, so on the CPU it equals the integer one.

Not ported here: the TPU's tile tables and VMEM estimators, which are not
semantics.
"""

from __future__ import annotations

import functools

import torch

from lightdiffusion_next_tpu_torch.ops import cuda_build, grad_guard

QBLOCK = 32  # Q8_0 quantization block (elements per scale)

# The kernel against its plain version (bf16 out): both dequantize to the
# same bf16 weights and accumulate in f32 in another order, so an output
# can round to a neighbouring bf16 value. Measured on an H100 at the
# main-path shapes: at most one bf16 ulp at max |plain| and a relative RMS
# error of at most 3.0e-4; the limits are three ulps and 1e-3. The planted
# faults (the last K tile skipped, each block read with its neighbour's
# scale row) read 0.064 or more. The bf16-rate W8A8 kernel (int8_mxu=False)
# is held to the same limits: its products are exact, and so are its sums
# below 2^24; past it the card's and the plain version's f32 sums round in
# another order. Measured on an H100 at chip_smoke.py phase 25's shapes (K
# up to 12288, codes of random weights and activations): bit for bit; its
# planted faults (the last K step skipped, cs not applied) fail the limits.
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


def _launch(x2, qt, scales_t, k=None, idx=None):
    """Check what the kernel takes, allocate the output and launch on the
    2-D ``x2`` (M, K): K5 on the (K, N) codes and (K/32, N) scales, or with
    ``idx`` K6 on block ``idx`` of the (D, K, N) and (D, K/32, N) stacks,
    read in place. ``k`` (default K) is the number of K rows summed."""
    name = "quant_matmul" if idx is None else "quant_matmul_stacked"
    if not (x2.is_cuda and qt.is_cuda and scales_t.is_cuda):
        raise ValueError(f"{name}: no kernel for device {x2.device}")
    if x2.dtype != torch.bfloat16 or qt.dtype != torch.int8 or scales_t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes bf16 x, int8 codes, f32 scales")
    m, kx = x2.shape
    kq, n = qt.shape[-2:]
    lead = tuple(qt.shape[:-2])
    if qt.dim() != (2 if idx is None else 3) or kx != kq \
            or scales_t.shape != lead + (kq // QBLOCK, n) or not supported(m, kq, n):
        raise ValueError(f"{name}: shapes x {tuple(x2.shape)}, qt {tuple(qt.shape)}, "
                         f"scales {tuple(scales_t.shape)}")
    if not (x2.is_contiguous() and qt.is_contiguous() and scales_t.is_contiguous()):
        raise ValueError(f"{name}: x, qt and scales_t must be contiguous")
    block = () if idx is None else (lead[0], _stack_index(lead[0], idx))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    rc = cuda_build.entry_point(name)(
        x2.data_ptr(), qt.data_ptr(), scales_t.data_ptr(), out.data_ptr(),
        m, n, kq if k is None else k, kx, *block,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: " + cuda_build.error_string(name, rc))
    return out


@grad_guard.no_backward("quant_matmul (K5)")
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


def _stack_index(depth: int, idx) -> int:
    """``idx`` as an int, checked against the stack's depth."""
    idx = int(idx)
    if not 0 <= idx < depth:
        raise IndexError(f"block {idx} of a stack of depth {depth}")
    return idx


def quant_matmul_stacked_plain(x, qt3, scales3, idx, out_dtype=None):
    """Plain PyTorch version of K6: K5's on block ``idx`` of the stack."""
    idx = _stack_index(qt3.shape[0], idx)
    return quant_matmul_plain(x, qt3[idx], scales3[idx], out_dtype)


@grad_guard.no_backward("quant_matmul_stacked (K6)")
def quant_matmul_stacked(x, qt3, scales3, idx, out_dtype=None):
    """K6: x (..., K) times block ``idx`` of a Q8_0 stack (codes qt3 (D, K,
    N) int8, scales3 (D, K/32, N) f32) -> (..., N), as K5 computes it."""
    if x.device.type == "cpu":
        return quant_matmul_stacked_plain(x, qt3, scales3, idx, out_dtype)
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError("quant_matmul_stacked: the kernel writes bf16")
    k = x.shape[-1]
    out = _launch(x.reshape(-1, k).contiguous(), qt3, scales3, idx=idx)
    quant_matmul_stacked.launches += 1
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


quant_matmul_stacked.launches = 0


# --------------------------------------------------------------------------
# W8A8: row-quantized int8 activations times per-column int8 weights
# --------------------------------------------------------------------------

# The row-quantization law (quantize_rows): sx = max(absmax, 1e-12) * INV_QMAX
# in f32, codes = clip(round_half_even(x / sx), -127, 127).
INV_QMAX = 1.0 / 127.0
QMAX = 127
PROLOGUES = ("none", "gelu", "ln_mod")

# The kernels against their plain versions. K7 and K11 compute the int32
# accumulator exactly and the epilogue in the same order of rounded f32
# operations, so their bf16 outputs are equal bit for bit; so are K9's codes
# and scales with the "none" prologue. With "gelu" (tanhf against torch's
# formula) and "ln_mod" (sums in another order, rsqrtf) a code can land on
# the other side of a rounding boundary: every code within CODE_MAX_DIFF,
# at most CODE_DIFF_SHARE of them different, scales within SCALE_REL.
CODE_MAX_DIFF = 1
CODE_DIFF_SHARE = 1e-3
SCALE_REL = 1e-6


def matmul_agreement(out, ref) -> dict:
    """K7's or K11's output against its plain version's: equal bit for bit
    (``ok``); the largest difference and the count of differing elements."""
    diff = (out.float() - ref.float()).abs()
    return {"max_abs_err": diff.max().item(), "tol": 0.0,
            "max_abs_plain": ref.float().abs().max().item(),
            "mismatches": int((out != ref).sum().item()), "ok": torch.equal(out, ref)}


def codes_agreement(codes, sx, ref_codes, ref_sx, exact=False) -> dict:
    """K9's or K10's codes and scales against the plain version's: equal
    bit for bit with ``exact`` (the "none" prologue), otherwise within the
    limits above."""
    d = (codes.int() - ref_codes.int()).abs()
    share = (d > 0).float().mean().item()
    scale_rel = ((sx.float() - ref_sx.float()).abs() / ref_sx.float().abs()).max().item()
    if exact:
        ok = torch.equal(codes, ref_codes) and torch.equal(sx, ref_sx)
    else:
        ok = (d.max().item() <= CODE_MAX_DIFF and share <= CODE_DIFF_SHARE
              and scale_rel <= SCALE_REL)
    return {"max_abs_err": d.max().item(), "tol": 0 if exact else CODE_MAX_DIFF,
            "code_diff_share": share, "code_diff_share_limit": 0.0 if exact else CODE_DIFF_SHARE,
            "scale_rel_err": scale_rel, "scale_rel_limit": 0.0 if exact else SCALE_REL,
            "ok": bool(ok)}


def quantize_rows(x):
    """Per-row symmetric int8 quantization of x (..., K): (codes int8
    (..., K), scales f32 (..., 1)) with x ~= codes * scales."""
    return _quantize_f32(x.float())


def _quantize_f32(xf):
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(absmax, min=1e-12) * INV_QMAX
    codes = torch.clamp(torch.round(xf / sx), -QMAX, QMAX).to(torch.int8)
    return codes, sx


def supported_w8a8(m: int, k: int, n: int) -> bool:
    """Shapes the W8A8 kernels take (the JAX package's gate): K and N in
    128-multiples."""
    return k % 128 == 0 and n % 128 == 0 and m >= 1


# The W8A8 kernel's tiles by id, as csrc/w8a8_matmul.cu dispatches them:
# (rows, columns, consumer warpgroups, blocks a cluster: two on neighbouring
# column tiles share each A tile, each copying half of it for both, ring
# stages). A block (two to an SM where it has one consumer warpgroup)
# walks the output tiles and stages K steps of W8A8_BK codes of its A (rows
# x BK) and B (columns x BK) tiles in its ring, beside the output's staging
# and the epilogue's column scales and bias; the source's header holds the
# times the choice below came from, and its static_asserts the fit.
W8A8_TILES = ((256, 128, 2, 2, 4), (64, 64, 1, 1, 6))
# The bf16-rate variant's tiles by id (csrc/w8a8_matmul_bf16.cu dispatches
# them the same way): (rows, columns, consumer warpgroups of 64 rows). Each
# block stages K steps of W8A8_BF16_BK codes of its A and B tiles in a ring
# of W8A8_BF16_STAGES, converts both into W8A8_BF16_BUFS bf16 buffer sets,
# plus one 1024-byte atom of alignment. It takes K in multiples of
# W8A8_BF16_BK.
W8A8_BF16_TILES = ((128, 256, 2), (128, 128, 2), (64, 64, 1))
W8A8_BF16_BK = 64
W8A8_BF16_STAGES = 3
W8A8_BF16_BUFS = 3
W8A8_BK = 128
SMS = 132  # an H100's streaming multiprocessors
# Launches of the int8 W8A8 kernel by tile id, over all four wrappers (and
# ``_launch_w8a8`` called directly): which tile, so which design, each call
# took.
W8A8_TILE_LAUNCHES = {tile: 0 for tile in range(len(W8A8_TILES))}


def w8a8_tile(m: int, n: int, k: int) -> int:
    """The tile id the W8A8 kernel takes for (M, K, N): 256 x 128 in pairs
    wherever its tiles cover half the SMs or more (every Flux shape with
    M >= 1024, and M = 256 at N >= 9216); 64 x 64 where they would leave
    more than half of them idle (M = 256 at N = 3072)."""
    del k  # the choice does not depend on K at the path's shapes
    blocks = -(-m // 256) * (n // 128)
    if 2 * blocks < SMS:
        return 1
    return 0


def w8a8_bf16_smem_bytes(tile: int) -> int:
    """Shared memory of one block of the bf16-rate variant's ``tile``,
    bytes."""
    bm, bn, _ = W8A8_BF16_TILES[tile]
    return ((W8A8_BF16_BUFS * 2 + W8A8_BF16_STAGES) * (bm + bn) * W8A8_BF16_BK
            + 1024)


def w8a8_bf16_tile(m: int, n: int, k: int) -> int:
    """The tile id the bf16-rate W8A8 kernel takes for (M, K, N): 128 x 256
    (one block per SM), 128 x 128 where N is not a multiple of 256, and
    64 x 64 where the larger tile's grid would leave more than a third of
    the SMs idle (M = 256: 24 blocks at N = 3072)."""
    del k  # the choice does not depend on K
    wide = n % 256 == 0
    blocks = -(-m // 128) * (n // (256 if wide else 128))
    if 3 * blocks < 2 * SMS:
        return 2
    return 0 if wide else 1


def supported_rowquant(k: int) -> bool:
    return k % 128 == 0


# K9's and K10's launch geometry (csrc/row_quantize.cu checks it): a group of
# W warps takes one row at a time, each lane holding VPT 16-byte chunks of it
# in registers; a block holds G groups, at most ROWQ_WARPS warps, and
# ROWQ_STAGES stages of K bf16 per group in shared memory; a persistent grid
# of at most the blocks that fit on the SMs at once walks the rows. The Flux
# path's row widths have instantiations of their own (K: (VPT, W, the
# prologues that have one)), bounded to 128 registers, so 16 warps fit an
# SM; every other shape takes the generic one, 16 chunks per lane and up to
# 255 registers (8 warps per SM).
ROWQ_FIXED = {3072: (6, 2, ("none", "ln_mod")), 12288: (6, 8, ("none", "gelu")),
              15360: (10, 6, ("none", "concat_gelu"))}
ROWQ_GENERIC_VPT = 16
ROWQ_STAGES = 2         # a group's ring: its row and the next one in flight
ROWQ_WARPS = 8
ROWQ_MAX_K = 32768
ROWQ_SMEM = 231424      # dynamic shared bytes one block may use
ROWQ_SMEM_SM = 233472   # shared bytes of one SM; each block also takes 1024
                        # and its 192 bytes of static scratch


def rowquant_smem(k: int, rows_per_block: int) -> int:
    """Dynamic shared memory of one K9/K10 block, bytes: the groups' rings."""
    return ROWQ_STAGES * 2 * k * rows_per_block


@functools.lru_cache(maxsize=256)
def rowquant_geometry(m: int, k: int, prologue: str = "none") -> tuple:
    """(chunks per lane, warps per row, rows per block, blocks) of K9 (the
    ``prologue``) or K10 ("concat_gelu") at M rows of K elements: the fixed
    instantiation of K where it has the prologue, else the generic one at
    the fewest warps that hold the row; then the rows per block that keep
    the most warps resident on an SM, at most one per SMS-th of M so that
    short calls spread over the SMs; then one resident set of blocks, or
    fewer where M runs out."""
    if m < 1 or k % 8 or not 0 < k <= ROWQ_MAX_K:
        raise ValueError(f"row quantize: no geometry for M = {m}, K = {k}")
    vpt, w, prologues = ROWQ_FIXED.get(k, (0, 0, ()))
    resident_warps = 16
    if prologue not in prologues:
        vpt, resident_warps = ROWQ_GENERIC_VPT, 8
        w = -(-k // (8 * 32 * vpt))

    def per_sm(g):
        return min(resident_warps // (w * g),
                   ROWQ_SMEM_SM // (rowquant_smem(k, g) + 1024 + 192))

    candidates = range(max(1, min(ROWQ_WARPS // w, m // SMS)), 0, -1)
    g = max(candidates, key=lambda g: per_sm(g) * g)
    return vpt, w, g, min(-(-m // g), SMS * per_sm(g))


def _epilogue_plain(xq, sx, q, cs, bias=None, residual=None, out_dtype=torch.bfloat16,
                    int8_mxu=True):
    """The W8A8 matmul on codes, in plain PyTorch: the int32 accumulator
    exactly (a float64 product of the codes: every partial sum is an integer
    below 2^53), then in f32 ``(acc * sx) * cs``, ``+ bias``, or ``(residual
    + (acc * sx) * cs) + bias``, each operation rounded. ``int8_mxu=False``
    (the bf16-rate variant): the codes as f32 through ``torch.matmul``, an
    f32 accumulator, exact while every partial sum stays below 2^24."""
    k = xq.shape[-1]
    n = q.shape[0]
    if int8_mxu:
        acc = torch.matmul(xq.reshape(-1, k).double(), q.double().t()).float()
    else:
        acc = torch.matmul(xq.reshape(-1, k).float(), q.float().t())
    o = acc * sx.reshape(-1, 1).float() * cs.reshape(1, n).float()
    if residual is not None:
        o = residual.reshape(-1, n).float() + o
    if bias is not None:
        o = o + bias.reshape(1, n).float()
    return o.to(out_dtype).reshape(xq.shape[:-1] + (n,))


def w8a8_matmul_plain(x, q, col_scales, out_dtype=None, int8_mxu=True):
    """Plain PyTorch version of ``w8a8_matmul``."""
    codes, sx = quantize_rows(x)
    return _epilogue_plain(codes, sx, q, col_scales, out_dtype=out_dtype or x.dtype,
                           int8_mxu=int8_mxu)


def _check_matmul_operands(xq, sx, q, cs, stacked=False):
    """The operands K7, K8 and K11 take; ``stacked``: q is a (D, N, K) stack
    (and, for K8, cs its (D, 1, N) column scales)."""
    if not (xq.is_cuda and sx.is_cuda and q.is_cuda and cs.is_cuda):
        raise ValueError(f"w8a8 matmul: no kernel for device {xq.device}")
    if xq.dtype != torch.int8 or q.dtype != torch.int8 or sx.dtype != torch.float32 \
            or cs.dtype != torch.float32:
        raise TypeError("w8a8 matmul: the kernel takes int8 codes and f32 scales")
    m, k = xq.shape
    if q.dim() != (3 if stacked else 2):
        raise ValueError(f"w8a8 matmul: codes of shape {tuple(q.shape)}")
    n, kq = q.shape[-2:]
    if k != kq or sx.numel() != m or cs.shape[-1] != n or not supported_w8a8(m, k, n):
        raise ValueError(f"w8a8 matmul: shapes xq {tuple(xq.shape)}, q {tuple(q.shape)}, "
                         f"cs {tuple(cs.shape)}")
    if not (xq.is_contiguous() and q.is_contiguous() and sx.is_contiguous()
            and cs.is_contiguous()) or xq.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("w8a8 matmul: codes and scales must be contiguous, the codes "
                         "16-byte aligned")


def _ep_operands(bias, residual, m, n):
    """K11's bias and residual as the kernels take them: (bias pointer,
    residual pointer or None, the residual's row stride)."""
    if bias is None or bias.dtype != torch.float32 or bias.numel() != n \
            or not bias.is_contiguous():
        raise ValueError("w8a8_matmul_ep: the kernel takes a contiguous f32 (N,) bias")
    if residual is None:
        return bias.data_ptr(), None, 0
    if residual.dtype != torch.bfloat16 or residual.shape != (m, n) \
            or residual.stride(1) != 1 or residual.stride(0) % 8 \
            or residual.data_ptr() % 16:
        raise ValueError("w8a8_matmul_ep: the residual must be bf16 (M, N) rows, "
                         "16-byte aligned")
    return bias.data_ptr(), residual.data_ptr(), residual.stride(0)


def _launch_w8a8(xq, sx, q, cs, bias=None, residual=None, k=None, ep=False, idx=None,
                 tile=None, int8_mxu=True):
    """Launch K7 (``ep=False``) or K11 on 2-D codes xq (M, K) and q (N, K);
    with ``idx``, K8 or the stacked K11 on block ``idx`` of the (D, N, K)
    stack q (K8: cs the stack's (D, 1, N) column scales, read at ``idx``
    too; K11: cs the folded (N,) vector). ``k`` (default K) is the number
    of K bytes summed; ``tile`` (default ``w8a8_tile``) the tile's id.
    ``int8_mxu=False``: the bf16-rate kernel (``csrc/w8a8_matmul_bf16.cu``)
    in place of the int8 one, on the same operands, its tile an id of
    ``W8A8_BF16_TILES`` (default ``w8a8_bf16_tile``)."""
    stacked = idx is not None
    _check_matmul_operands(xq, sx, q, cs, stacked)
    m, kx = xq.shape
    n = q.shape[-2]
    tiles = W8A8_TILES if int8_mxu else W8A8_BF16_TILES
    if tile is None:
        tile = (w8a8_tile if int8_mxu else w8a8_bf16_tile)(m, n, kx)
    if not 0 <= tile < len(tiles) or n % tiles[tile][1]:
        raise ValueError(f"w8a8 matmul: tile {tile} does not take N = {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    k = kx if k is None else k
    depth = q.shape[0] if stacked else 1
    if stacked:
        idx = _stack_index(depth, idx)
    if cs.numel() != (depth * n if stacked and not ep else n):
        raise ValueError(f"w8a8 matmul: cs {tuple(cs.shape)} for codes {tuple(q.shape)}: K8 "
                         "takes the stack's (D, 1, N) column scales, K7 and K11 (N,)")
    if not int8_mxu:
        return _launch_w8a8_bf16(xq, sx, q, cs, bias, residual, out, k, ep, depth,
                                 idx if stacked else 0, tile, stream)
    if not ep:
        name = "w8a8_matmul_stacked" if stacked else "w8a8_matmul"
        args = (xq.data_ptr(), sx.data_ptr(), q.data_ptr(), cs.data_ptr(), out.data_ptr(),
                m, n, k, kx, kx, tile)
        rc = cuda_build.entry_point(name)(*args, *((depth, idx) if stacked else ()), stream)
    else:
        name = "w8a8_matmul_ep_stacked" if stacked else "w8a8_matmul_ep"
        bias_ptr, res_ptr, ldr = _ep_operands(bias, residual, m, n)
        rc = cuda_build.entry_point(name)(
            xq.data_ptr(), sx.data_ptr(), q.data_ptr(), cs.data_ptr(), bias_ptr,
            res_ptr, out.data_ptr(), m, n, k, kx, kx, ldr, tile,
            *((depth, idx) if stacked else ()), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: " + cuda_build.error_string(name, rc))
    W8A8_TILE_LAUNCHES[tile] += 1
    return out


def _launch_w8a8_bf16(xq, sx, q, cs, bias, residual, out, k, ep, depth, idx, tile, stream):
    """The bf16-rate K7, K8 or K11 (``int8_mxu=False``) on checked operands:
    block ``idx`` of ``depth`` (1: a plain weight); K8's column scales read
    at the block here."""
    m, kx = xq.shape
    n = q.shape[-2]
    if k % W8A8_BF16_BK or k < W8A8_BF16_BK:
        raise ValueError(f"w8a8 matmul (bf16 rate): K = {k} not taken")
    bias_ptr, res_ptr, ldr = _ep_operands(bias, residual, m, n) if ep else (None, None, 0)
    cs_ptr = cs.data_ptr() + (0 if ep else 4 * idx * n)
    name = "w8a8_matmul_bf16"
    rc = cuda_build.entry_point(name)(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), cs_ptr, bias_ptr, res_ptr,
        out.data_ptr(), m, n, k, kx, kx, ldr, tile, depth, idx, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: " + cuda_build.error_string(name, rc))
    return out


def _count(fn, int8_mxu: bool):
    """One launch of ``fn``'s kernel: ``launches``, or ``launches_bf16`` for
    its bf16-rate variant."""
    if int8_mxu:
        fn.launches += 1
    else:
        fn.launches_bf16 += 1


@grad_guard.no_backward("w8a8_matmul (K7)")
def w8a8_matmul(x, q, col_scales, out_dtype=None, int8_mxu=True):
    """K7: x (..., K) float times the W8A8 weight (codes q (N, K) int8,
    ``col_scales`` (1, N) f32) -> (..., N) in ``out_dtype`` (x's dtype). On
    the GPU, bf16 in and out; x is row-quantized by K9 ("none") first.
    ``int8_mxu=False``: the codes multiplied at the bf16 rate
    (``csrc/w8a8_matmul_bf16.cu``), counted in ``launches_bf16``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, q, col_scales, out_dtype, int8_mxu)
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul: the kernel writes bf16")
    k = x.shape[-1]
    codes, sx = row_quantize_fused(x)
    out = _launch_w8a8(codes.reshape(-1, k), sx.reshape(-1), q, col_scales.reshape(-1),
                       int8_mxu=int8_mxu)
    _count(w8a8_matmul, int8_mxu)
    return out.reshape(x.shape[:-1] + (q.shape[0],))


w8a8_matmul.launches = 0
w8a8_matmul.launches_bf16 = 0


def w8a8_matmul_stacked_plain(x, q3, col_scales3, idx, out_dtype=None, int8_mxu=True):
    """Plain PyTorch version of K8: K7's on block ``idx`` of the stack."""
    idx = _stack_index(q3.shape[0], idx)
    return w8a8_matmul_plain(x, q3[idx], col_scales3[idx], out_dtype, int8_mxu)


@grad_guard.no_backward("w8a8_matmul_stacked (K8)")
def w8a8_matmul_stacked(x, q3, col_scales3, idx, out_dtype=None, int8_mxu=True):
    """K8: x (..., K) float times block ``idx`` of a W8A8 stack (codes q3
    (D, N, K) int8, ``col_scales3`` (D, 1, N) f32) -> (..., N), as K7
    computes it; x is row-quantized by K9 ("none") first. ``int8_mxu``
    as for K7."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w8a8_matmul_stacked_plain(x, q3, col_scales3, idx, out_dtype, int8_mxu)
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul_stacked: the kernel writes bf16")
    k = x.shape[-1]
    codes, sx = row_quantize_fused(x)
    out = _launch_w8a8(codes.reshape(-1, k), sx.reshape(-1), q3, col_scales3, idx=idx,
                       int8_mxu=int8_mxu)
    _count(w8a8_matmul_stacked, int8_mxu)
    return out.reshape(x.shape[:-1] + (q3.shape[1],))


w8a8_matmul_stacked.launches = 0
w8a8_matmul_stacked.launches_bf16 = 0


def w8a8_matmul_ep_plain(xq, sx, q, cs_eff, b_eff, residual=None, out_dtype=torch.bfloat16,
                         int8_mxu=True):
    """Plain PyTorch version of K11 (``_epilogue_plain`` with the bias); a
    ``(q3, idx)`` operand is block ``idx`` of the stack."""
    if isinstance(q, tuple):
        q3, idx = q
        q = q3[_stack_index(q3.shape[0], idx)]
    return _epilogue_plain(xq, sx, q, cs_eff, b_eff, residual, out_dtype, int8_mxu)


def _residual_rows(residual, n):
    """The residual as 2-D (M, N) bf16 rows the kernel reads through their
    stride in 16-byte chunks (copied only when the rows are not 16-byte
    aligned)."""
    if residual is None:
        return None
    res2 = residual.reshape(-1, n)
    if res2.stride(1) != 1 or res2.stride(0) % 8 or res2.data_ptr() % 16:
        res2 = res2.contiguous()
    return res2


@grad_guard.no_backward("w8a8_matmul_ep (K11)")
def w8a8_matmul_ep(xq, sx, q, cs_eff, b_eff, residual=None, out_dtype=torch.bfloat16,
                   int8_mxu=True):
    """K11: prequantized xq (..., K) int8 with scales sx (..., 1) times the
    W8A8 codes q (N, K) -> (..., N), epilogue ``(f32(acc) * sx) * cs_eff +
    b_eff`` or ``(residual + (f32(acc) * sx) * cs_eff) + b_eff``. ``cs_eff``
    and ``b_eff`` are (1, N) f32 with the gate folded in by the caller. The
    scan layout's ``(q3, idx)`` operand goes to ``w8a8_matmul_ep_stacked``
    (which counts that launch). ``int8_mxu`` as for K7."""
    if isinstance(q, tuple):
        return w8a8_matmul_ep_stacked(xq, sx, q[0], q[1], cs_eff, b_eff, residual, out_dtype,
                                      int8_mxu)
    n, k = q.shape
    if xq.device.type == "cpu":
        return w8a8_matmul_ep_plain(xq, sx, q, cs_eff, b_eff, residual, out_dtype, int8_mxu)
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul_ep: the kernel writes bf16")
    out = _launch_w8a8(xq.reshape(-1, k), sx.reshape(-1), q, cs_eff.reshape(-1),
                       b_eff.reshape(-1), _residual_rows(residual, n), ep=True,
                       int8_mxu=int8_mxu)
    _count(w8a8_matmul_ep, int8_mxu)
    return out.reshape(xq.shape[:-1] + (n,))


w8a8_matmul_ep.launches = 0
w8a8_matmul_ep.launches_bf16 = 0


@grad_guard.no_backward("w8a8_matmul_ep_stacked (stacked K11)")
def w8a8_matmul_ep_stacked(xq, sx, q3, idx, cs_eff, b_eff, residual=None,
                           out_dtype=torch.bfloat16, int8_mxu=True):
    """The stacked K11: ``w8a8_matmul_ep`` on block ``idx`` of the W8A8
    codes q3 (D, N, K), read in place; ``cs_eff`` and ``b_eff`` are the
    caller's (1, N) folds of that block's column scales."""
    d, n, k = q3.shape
    if xq.device.type == "cpu":
        return w8a8_matmul_ep_plain(xq, sx, (q3, idx), cs_eff, b_eff, residual, out_dtype,
                                    int8_mxu)
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul_ep_stacked: the kernel writes bf16")
    out = _launch_w8a8(xq.reshape(-1, k), sx.reshape(-1), q3, cs_eff.reshape(-1),
                       b_eff.reshape(-1), _residual_rows(residual, n), ep=True, idx=idx,
                       int8_mxu=int8_mxu)
    _count(w8a8_matmul_ep_stacked, int8_mxu)
    return out.reshape(xq.shape[:-1] + (n,))


w8a8_matmul_ep_stacked.launches = 0
w8a8_matmul_ep_stacked.launches_bf16 = 0


# --------------------------------------------------------------------------
# Row quantization with a fused prologue (K9) and of [a ; gelu(b window)] (K10)
# --------------------------------------------------------------------------


def row_quantize_fused_plain(x, mod_scale=None, mod_shift=None, *, prologue="none",
                             eps=1e-6):
    """Plain PyTorch version of K9, in the JAX kernels' f32 operations."""
    xf = x.float()
    if prologue == "gelu":
        xf = torch.nn.functional.gelu(xf, approximate="tanh")
    elif prologue == "ln_mod":
        k = xf.shape[-1]
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        var = (xc * xc).mean(dim=-1, keepdim=True)
        xf = (xc * torch.rsqrt(var + eps) * mod_scale.float().reshape(k)
              + mod_shift.float().reshape(k))
    return _quantize_f32(xf)


def _rows(x):
    """x (..., K) as 2-D rows with unit column stride, 16-byte aligned rows."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    return x2


def _stream(t) -> int:
    """The raw current CUDA stream of ``t``'s device: the public
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    for it, 3.7-7.3 µs of host time per call on the H100's host
    (``ablate_rowquant.py``), which K9's short launches pay 4180 times an
    image."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _modulation(v, k):
    """ln_mod's scale or shift as the (K,) f32 vector K9 reads, 16-byte
    aligned: ``v`` itself where it already is one."""
    v = v.float().reshape(k).contiguous()
    return v.clone() if v.data_ptr() % 16 else v


def _launch_rowquant(x2, prologue, mod_scale, mod_shift, eps, center=1, inv_qmax=INV_QMAX,
                     geometry=None):
    """Launch K9 on 2-D rows; ``center`` and ``inv_qmax`` other than 1 and
    1/127 plant a fault (for the checks); ``geometry`` forces a launch
    geometry other than ``rowquant_geometry``'s (for the card tests)."""
    if not x2.is_cuda:
        raise ValueError(f"row_quantize_fused: no kernel for device {x2.device}")
    if x2.dtype != torch.bfloat16:
        raise TypeError("row_quantize_fused: the kernel takes bf16 x")
    m, k = x2.shape
    if not supported_rowquant(k):
        raise ValueError(f"row_quantize_fused: K = {k} is not a multiple of 128")
    s = t = None
    if prologue == "ln_mod":
        s, t = _modulation(mod_scale, k), _modulation(mod_shift, k)
    codes = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    rc = cuda_build.entry_point("row_quantize_fused")(
        x2.data_ptr(), None if s is None else s.data_ptr(),
        None if t is None else t.data_ptr(), codes.data_ptr(), sx.data_ptr(),
        m, k, x2.stride(0), PROLOGUES.index(prologue), center, eps, inv_qmax,
        *(geometry or rowquant_geometry(m, k, prologue)), _stream(x2))
    if rc != 0:
        raise RuntimeError("row_quantize_fused kernel failed: "
                           + cuda_build.error_string("row_quantize_fused", rc))
    return codes, sx


@grad_guard.no_backward("row_quantize_fused (K9)")
def row_quantize_fused(x, mod_scale=None, mod_shift=None, *, prologue="none", eps=1e-6):
    """K9: x (..., K) -> (codes int8 (..., K), scales f32 (..., 1)) with the
    prologue ("none", "gelu" (tanh form) or "ln_mod") fused into the
    quantization. For "ln_mod", ``mod_scale`` and ``mod_shift`` are (1, K)
    f32 and the row is ``layer_norm(x, eps) * mod_scale + mod_shift`` (the
    caller folds the +1 into the scale)."""
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}")
    if x.device.type == "cpu":
        return row_quantize_fused_plain(x, mod_scale, mod_shift, prologue=prologue, eps=eps)
    k = x.shape[-1]
    codes, sx = _launch_rowquant(_rows(x), prologue, mod_scale, mod_shift, eps)
    row_quantize_fused.launches += 1
    return codes.reshape(x.shape[:-1] + (k,)), sx.reshape(x.shape[:-1] + (1,))


row_quantize_fused.launches = 0


def row_quantize_concat_gelu_plain(a, b, b_lo, b_hi):
    """Plain PyTorch version of K10 (it builds the concat)."""
    bf = torch.nn.functional.gelu(b[..., b_lo:b_hi].float(), approximate="tanh")
    return _quantize_f32(torch.cat([a.float(), bf], dim=-1))


def _launch_concat(a2, b2, b_lo, b_hi, gelu=1, geometry=None):
    """Launch K10 on 2-D rows; the window [b_lo, b_hi) of b2 is read through
    b2's row stride. ``gelu=0`` plants a fault (for the checks); ``geometry``
    as for ``_launch_rowquant``."""
    if not (a2.is_cuda and b2.is_cuda):
        raise ValueError(f"row_quantize_concat_gelu: no kernel for device {a2.device}")
    if a2.dtype != torch.bfloat16 or b2.dtype != torch.bfloat16:
        raise TypeError("row_quantize_concat_gelu: the kernel takes bf16 a and b")
    m, ka = a2.shape
    kb = b_hi - b_lo
    if b2.shape[0] != m or not (0 <= b_lo < b_hi <= b2.shape[1]) \
            or not supported_rowquant(ka + kb) or ka % 8 or b_lo % 8 or kb % 8:
        raise ValueError(f"row_quantize_concat_gelu: shapes a {tuple(a2.shape)}, "
                         f"b {tuple(b2.shape)}, window [{b_lo}, {b_hi})")
    window = b2[:, b_lo:b_hi]
    codes = torch.empty((m, ka + kb), dtype=torch.int8, device=a2.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=a2.device)
    rc = cuda_build.entry_point("row_quantize_concat_gelu")(
        a2.data_ptr(), window.data_ptr(), codes.data_ptr(), sx.data_ptr(), m, ka, kb,
        a2.stride(0), b2.stride(0), gelu, INV_QMAX,
        *(geometry or rowquant_geometry(m, ka + kb, "concat_gelu" if gelu else "none")),
        _stream(a2))
    if rc != 0:
        raise RuntimeError("row_quantize_concat_gelu kernel failed: "
                           + cuda_build.error_string("row_quantize_concat_gelu", rc))
    return codes, sx


@grad_guard.no_backward("row_quantize_concat_gelu (K10)")
def row_quantize_concat_gelu(a, b, b_lo: int, b_hi: int):
    """K10: codes and scales of the rows ``[a ; gelu(b[..., b_lo:b_hi])]``
    (the Flux single block's linear2 input: ``a`` the attention output, ``b``
    the full linear1 projection whose MLP window is [b_lo, b_hi)); the
    kernel reads only the window and never builds the concat."""
    if a.device.type == "cpu":
        return row_quantize_concat_gelu_plain(a, b, b_lo, b_hi)
    lead = a.shape[:-1]
    codes, sx = _launch_concat(_rows(a), _rows(b), b_lo, b_hi)
    row_quantize_concat_gelu.launches += 1
    return codes.reshape(lead + (codes.shape[-1],)), sx.reshape(lead + (1,))


row_quantize_concat_gelu.launches = 0
