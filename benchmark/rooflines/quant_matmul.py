"""K5: ``ops.quant_matmul.quant_matmul(x, qt, scales_t)``, codes (K, N)."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "quant_matmul")


def shapes(x, qt, *args, **kwargs):
    return {"m": formulas.rows(x), "k": qt.shape[-2], "n": qt.shape[-1]}


def bound_s(s):
    return formulas.q8_0_matmul(s["m"], s["k"], s["n"])
