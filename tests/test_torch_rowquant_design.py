"""K9's and K10's arithmetic and launch geometry, emulated on the CPU.

The kernel (``csrc/row_quantize.cu``) cannot run here; what it computes per
element can. These tests hold numpy f32 emulations of its operations, in
its order, to the law (``quant_matmul.quantize_rows``) and to torch's GELU:

- (a) the bracketed reciprocal: ``y * inv (1 -+ 2^-21)``, ``inv =
  __frcp_rn(sx)``, each rounded by one fused add of 1.5 * 2^23 (the code is
  the sum's low byte), with the chunk of 8 taking ``__fdiv_rn`` where the
  two round to different integers, equals ``clip(rint(y / sx), +-127)`` bit
  for bit;
- (b) the GELU ``x / (1 + 2^(x (A + B x^2)))`` stays within GELU_ULPS ulps
  of |x| of ``torch.nn.functional.gelu(approximate="tanh")``;
- (c) ``quant_matmul.rowquant_geometry`` covers every row and every chunk of
  a row, within the limits the kernel checks.

``__frcp_rn`` is an f32 division of 1, ``__fmul_rn`` an f32 product,
``__fmaf_rn(y, c, 1.5 * 2^23)`` 1.5 * 2^23 plus ``rint`` of the f64 product
(exact: the product of two f32 values fits an f64, and the fused add rounds
it once, half to even), other ``__fmaf_rn`` an f64 product and sum rounded
to f32, ``ex2.approx`` an exact exp2 rounded to f32 (and
flushed below 2^-126, as ``.ftz`` does), ``rcp.approx`` an exact reciprocal
rounded to f32; (b) also runs with those two off by their documented
worst cases.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

F32 = np.float32
SOURCE = (Path(qm.__file__).resolve().parent.parent / "csrc" / "row_quantize.cu").read_text()
ROUND = F32(12582912.0)                   # 1.5 * 2^23
BRACKET = (F32(1 - 2.0 ** -21), F32(1 + 2.0 ** -21))
GELU_A = F32(-2.0 * math.sqrt(2.0 / math.pi) / math.log(2.0))
GELU_B = F32(0.044715 * float(GELU_A))
# |kernel's GELU - torch's| <= GELU_ULPS * ulp(|x|): torch's tanh form
# loses up to about half an ulp of |x| in 1 + tanh(u) for x < 0 (where
# tanh(u) is near -1), the rewritten form keeps 2-3 ulps of its own value
# (ex2.approx within 2 ulps, rcp.approx within 1); gelu(x) <= |x| for
# x > 0, so at the row's absmax (a positive x) 4 ulps of |x| stay under
# quant_matmul.SCALE_REL.
GELU_ULPS = 4
EX2_REL = 2.0 ** -22   # ex2.approx.ftz.f32: 2 ulps
RCP_REL = 2.0 ** -23   # rcp.approx.ftz.f32: 1 ulp


def _constant(name):
    return F32(re.search(rf"constexpr float {name} = ([^;]+)f;", SOURCE).group(1))


def test_kernel_constants_are_the_emulated_ones():
    assert _constant("kGeluA") == GELU_A and _constant("kGeluB") == GELU_B
    assert _constant("kRound") == ROUND
    assert (_constant("kBracketLo"), _constant("kBracketHi")) == BRACKET


# --------------------------------------------------------------------------
# (a) the quantization
# --------------------------------------------------------------------------


def law_scale(amax):
    """sx = max(absmax, 1e-12) * f32(1/127), in f32."""
    return np.maximum(amax.astype(F32), F32(1e-12)) * F32(qm.INV_QMAX)


def exact_codes(y, sx):
    """The law: clip(rint(y / sx), +-127) with the IEEE f32 quotient."""
    return np.clip(np.rint(y / sx), -127, 127).astype(np.int8)


def _low_byte(r):
    return (r.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _fma_round(y, c):
    """__fmaf_rn(y, c, 1.5 * 2^23): the sum rounds y * c to an integer."""
    return (ROUND + np.rint(y.astype(np.float64) * c.astype(np.float64))).astype(F32)


def kernel_codes(y, sx):
    """The kernel's codes of f32 rows y (R, K), K a multiple of 8, at scales
    sx (R, 1): the bracketed reciprocal, chunk by chunk; and the share of
    elements in chunks that took the division."""
    inv = F32(1) / sx
    r_lo, r_hi = (_fma_round(y, inv * b) for b in BRACKET)
    tie = r_lo != r_hi
    chunk_tie = np.repeat(tie.reshape(y.shape[0], -1, 8).any(axis=2), 8, axis=1)
    r = np.clip(r_lo, ROUND - F32(127), ROUND + F32(127))
    div = np.clip(y / sx, F32(-127), F32(127)) + ROUND
    return _low_byte(np.where(chunk_tie, div, r)), chunk_tie.mean()


def finite_bf16():
    """Every finite bf16 value, as f32, sorted by magnitude (v and -v
    side by side)."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    x = (bits << 16).view(F32)
    x = x[np.isfinite(x)]
    return x[np.argsort(np.abs(x), kind="stable")]


def _rows(name, rng):
    """(y, sx) of case ``name``: y (R, K) f32 rows, sx their law scale or
    seeded scales."""
    if name == "every_bf16":
        # each finite bf16 value against 16 scales of the law: absmax at
        # |v| (the row's largest element) and at |v| times seeded factors
        v = finite_bf16()
        factor = np.concatenate([[1.0], rng.uniform(1.0, 300.0, 15)]).astype(F32)
        amax = np.minimum(np.abs(v)[:, None].astype(np.float64) * factor[None, :],
                          np.finfo(F32).max)
        sx = law_scale(amax).reshape(-1, 1)
        y = np.repeat(v, 16)[:, None]
        pad = np.zeros((y.shape[0], 7), F32)  # chunks of 8: the value and zeros
        return np.concatenate([y, pad], axis=1), sx
    if name == "ties":
        # y / sx exactly n + 1/2 for every n, at scales of few mantissa bits
        n = np.arange(-128, 127, dtype=F32) + F32(0.5)
        sx = np.array([m * 2.0 ** e for m in (1.0, 1.5, 1.25, 1.75, 1.125)
                       for e in range(-40, 41, 8)], F32)
        y = (n[None, :] * sx[:, None]).astype(F32)
        keep = y.shape[1] // 8 * 8
        return y[:, :keep], sx[:, None]
    if name == "near_ties":
        # y within a few ulps of (n + 1/2) sx at seeded scales: where the
        # bare reciprocal's product and the quotient round apart
        sx = law_scale(rng.uniform(0.5, 2.0, (4096, 1)) * np.exp(rng.uniform(-20, 20, (4096, 1))))
        n = rng.integers(-127, 127, (4096, 64)).astype(F32) + F32(0.5)
        y = (n * sx).astype(F32)
        step = rng.integers(-3, 4, y.shape).astype(np.int32)
        return (y.view(np.int32) + step).view(F32), sx
    if name == "zero_rows":
        y = np.zeros((8, 3072), F32)
        y[1:] = rng.standard_normal((7, 3072)).astype(F32) * F32(1e-14)
        return y, law_scale(np.abs(y).max(axis=1, keepdims=True))
    scale = float(name)
    y = (rng.standard_normal((64, 3072)) + rng.standard_normal((64, 1))) * scale
    y = y.astype(F32)
    return y, law_scale(np.abs(y).max(axis=1, keepdims=True))


@pytest.mark.parametrize("name", ["every_bf16", "ties", "near_ties", "zero_rows", "1e-8",
                                  "1e-4", "1", "1e4", "1e8", repr(math.exp(-20)),
                                  repr(math.exp(20))])
def test_bracketed_reciprocal_is_the_law(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    y, sx = _rows(name, rng)
    codes, share = kernel_codes(y, sx)
    np.testing.assert_array_equal(codes, exact_codes(y, sx))
    if "ties" not in name:
        assert share < 2e-3  # the division stays the exception
    if name == "near_ties":  # the data needs the guard: the bare product errs
        bare = np.clip(np.rint(y * (F32(1) / sx)), -127, 127).astype(np.int8)
        assert (bare != exact_codes(y, sx)).any()


def test_bracketed_reciprocal_matches_the_plain_version():
    """A row through the emulation equals quantize_rows' codes and scales."""
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((32, 3072)) * 3 + rng.standard_normal((32, 1))).astype(F32)
    y = torch.from_numpy(y).bfloat16().float().numpy()
    ref_codes, ref_sx = qm.quantize_rows(torch.from_numpy(y))
    sx = law_scale(np.abs(y).max(axis=1, keepdims=True))
    np.testing.assert_array_equal(sx, ref_sx.numpy())
    np.testing.assert_array_equal(kernel_codes(y, sx)[0], ref_codes.numpy())


# --------------------------------------------------------------------------
# (b) the GELU
# --------------------------------------------------------------------------


def kernel_gelu(x, ex2_rel=0.0, rcp_rel=0.0):
    """x (f32) through the kernel's GELU, its two approximations off by
    the given relative errors."""
    with np.errstate(over="ignore", invalid="ignore"):
        xx = x * x
        p = (xx.astype(np.float64) * float(GELU_B) + float(GELU_A)).astype(F32)
        t = x * p
        t = np.where(np.abs(t) < F32(2.0 ** -126), F32(0), t)
        e = (np.exp2(t.astype(np.float64)) * (1 + ex2_rel)).astype(F32)
        e = np.where(e < F32(2.0 ** -126), F32(0), e)
        d = F32(1) + e
        r = ((1.0 / d.astype(np.float64)) * (1 + rcp_rel)).astype(F32)
        return x * r


@pytest.mark.parametrize("ex2_rel,rcp_rel", [(0.0, 0.0), (EX2_REL, RCP_REL),
                                             (-EX2_REL, -RCP_REL), (EX2_REL, -RCP_REL),
                                             (-EX2_REL, RCP_REL)])
def test_gelu_within_ulps_of_torch(ex2_rel, rcp_rel):
    x = finite_bf16()
    ref = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    g = kernel_gelu(x, ex2_rel, rcp_rel)
    assert np.isfinite(g).all()
    err = np.abs(g.astype(np.float64) - ref.astype(np.float64))
    ulps = err / np.spacing(np.abs(x)).astype(np.float64)
    assert ulps.max() <= GELU_ULPS, (x[ulps.argmax()], g[ulps.argmax()], ref[ulps.argmax()])
    pos = x > 0  # where the absmax lies: within GELU_ULPS ulps of the value too
    rel = err[pos] / np.abs(ref[pos].astype(np.float64))
    assert rel.max() <= GELU_ULPS * 2.0 ** -23


# --------------------------------------------------------------------------
# (c) the launch geometry
# --------------------------------------------------------------------------

# K9 and K10 at the Flux W8A8 plan (4096 image, 256 text tokens) and the
# unfused DiT call, M = 1, ragged M, rows off the plan (the generic
# instantiation) and the longest row
GEOMETRY_SHAPES = [(4096, 3072, "ln_mod"), (256, 3072, "ln_mod"), (4352, 3072, "ln_mod"),
                   (4096, 3072, "none"), (256, 3072, "none"), (4096, 12288, "gelu"),
                   (256, 12288, "gelu"), (4352, 15360, "concat_gelu"),
                   (4352, 15360, "none"), (4096, 12288, "none"), (1, 3072, "ln_mod"),
                   (1, 12288, "gelu"), (255, 3072, "none"), (257, 15360, "concat_gelu"),
                   (4353, 3072, "ln_mod"), (510, 128, "gelu"), (1000, 3072, "gelu"),
                   (3, 32768, "none"), (4353, 32768, "ln_mod"), (300, 24576, "gelu"),
                   (300, 24704, "none"), (129, 12288, "ln_mod")]


@pytest.mark.parametrize("m,k,prologue", GEOMETRY_SHAPES)
def test_rowquant_geometry_covers_every_row(m, k, prologue):
    vpt, w, g, blocks = qm.rowquant_geometry(m, k, prologue)
    fixed = qm.ROWQ_FIXED.get(k)
    # the kernel's checks (csrc/row_quantize.cu, launch): a fixed
    # instantiation holds the row exactly, the generic one at least
    if fixed and prologue in fixed[2]:
        assert (vpt, w) == fixed[:2] and 32 * w * vpt * 8 == k
    else:
        assert vpt == qm.ROWQ_GENERIC_VPT and 32 * w * vpt * 8 >= k > 32 * (w - 1) * vpt * 8
    assert 1 <= g and w * g <= qm.ROWQ_WARPS and blocks >= 1
    assert qm.rowquant_smem(k, g) <= qm.ROWQ_SMEM
    # every chunk of a row has one lane: chunk lane + j * 32w, j < vpt
    lanes = 32 * w
    chunks = sorted(lane + j * lanes for lane in range(lanes) for j in range(vpt)
                    if lane + j * lanes < k // 8)
    assert chunks == list(range(k // 8))
    # every row has one group: group c of block b takes rows b*G + c,
    # stepping by G * blocks
    rows = np.concatenate([np.arange(b * g + c, m, g * blocks)
                           for b in range(blocks) for c in range(g)])
    assert np.array_equal(np.sort(rows), np.arange(m))
    # no block without a row, and no more blocks than fit on the SMs at once
    resident = 16 if fixed and prologue in fixed[2] else 8
    assert (blocks - 1) * g < m and blocks <= qm.SMS * (resident // (w * g))
