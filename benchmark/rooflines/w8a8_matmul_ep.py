"""K11: ``ops.quant_matmul.w8a8_matmul_ep(xq, sx, q, cs_eff, b_eff,
residual)`` on prequantized rows; a ``(q3, idx)`` operand is one block of
a stack (the stacked K11, reached through this wrapper)."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "w8a8_matmul_ep")


def shapes(xq, sx, q, cs_eff, b_eff, residual=None, *args, int8_mxu=True, **kwargs):
    q = q[0] if isinstance(q, tuple) else q
    return {"m": formulas.rows(xq), "n": q.shape[-2], "k": q.shape[-1],
            "residual": residual is not None, "int8_mxu": int8_mxu}


def bound_s(s):
    return formulas.w8a8_product(s["m"], s["k"], s["n"], s["residual"], s["int8_mxu"])
