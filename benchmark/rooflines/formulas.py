"""The least times the kernels' work could take on one H100, from the
operation's shapes, at the published peaks (``benchmark.peaks``): the
formulas under the kernel table of PERF.md, frozen here.

- attention (K1, K2, K3; K4 at the int8 rate): the larger of the two
  products' operations 4 B H Lq Lk D at the tensor-core rate, the B H Lq
  Lk exponentials at the MUFU rate, and the bytes of q, k, v read and the
  output written once;
- a quantized matmul: the larger of 2 M K N operations at its rate and its
  bytes (each operand read once, the output written once);
- a row quantization (K9, K10): bytes alone.
"""

from benchmark import peaks


def attention(b, h, lq, lk, d, elt_bytes=2, rate="bf16"):
    ops = 4.0 * b * h * lq * lk * d / peaks.FLOPS[rate]
    exps = float(b) * h * lq * lk / peaks.EXP_PER_S
    nbytes = elt_bytes * b * h * d * (2 * lq + 2 * lk)
    return max(ops, exps, nbytes / peaks.HBM_BYTES_PER_S)


def gemm(m, k, n, nbytes, rate):
    return max(2.0 * m * k * n / peaks.FLOPS[rate], nbytes / peaks.HBM_BYTES_PER_S)


def q8_0_matmul(m, k, n):
    """K5/K6: bf16 x, int8 codes with an f32 scale per 32, bf16 out."""
    return gemm(m, k, n, 2 * m * k + k * n + k * n / 8 + 2 * m * n, "bf16")


def w8a8_product(m, k, n, residual=False, int8_mxu=True):
    """K7/K8/K11: int8 codes of x and of the weight, f32 row and column
    scales and bias, bf16 out (and residual)."""
    nbytes = m * k + n * k + 4 * m + 8 * n + 2 * m * n * (2 if residual else 1)
    return gemm(m, k, n, nbytes, "int8" if int8_mxu else "bf16")


def row_quantize(m, k, ln_mod=False):
    """K9/K10: bf16 rows read, int8 codes and an f32 scale a row written."""
    return (3 * m * k + 4 * m + (8 * k if ln_mod else 0)) / peaks.HBM_BYTES_PER_S


def rows(t):
    n = 1
    for d in t.shape[:-1]:
        n *= d
    return n
