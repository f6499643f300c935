"""K10: ``ops.quant_matmul.row_quantize_concat_gelu(a, b, b_lo, b_hi)``: the
rows [a ; gelu(b[:, b_lo:b_hi])] quantized; the window of b is read, the
rest of b is not."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "row_quantize_concat_gelu")


def shapes(a, b, b_lo, b_hi, *args, **kwargs):
    return {"m": formulas.rows(a), "k": a.shape[-1] + (b_hi - b_lo)}


def bound_s(s):
    return formulas.row_quantize(s["m"], s["k"])
