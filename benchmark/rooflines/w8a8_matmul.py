"""``ops.quant_matmul.w8a8_matmul(x, q, col_scales)``: K9's row
quantization of x, then K7 on the (N, K) codes; the two bounds add."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "w8a8_matmul")


def shapes(x, q, *args, int8_mxu=True, **kwargs):
    return {"m": formulas.rows(x), "n": q.shape[-2], "k": q.shape[-1], "int8_mxu": int8_mxu}


def bound_s(s):
    return (formulas.row_quantize(s["m"], s["k"])
            + formulas.w8a8_product(s["m"], s["k"], s["n"], int8_mxu=s["int8_mxu"]))
