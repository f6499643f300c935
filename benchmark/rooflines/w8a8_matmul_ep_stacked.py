"""The stacked K11 called directly: ``ops.quant_matmul.w8a8_matmul_ep_stacked
(xq, sx, q3, idx, cs_eff, b_eff, residual)``."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "w8a8_matmul_ep_stacked")


def shapes(xq, sx, q3, idx, cs_eff, b_eff, residual=None, *args, int8_mxu=True, **kwargs):
    return {"m": formulas.rows(xq), "n": q3.shape[-2], "k": q3.shape[-1],
            "residual": residual is not None, "int8_mxu": int8_mxu}


def bound_s(s):
    return formulas.w8a8_product(s["m"], s["k"], s["n"], s["residual"], s["int8_mxu"])
