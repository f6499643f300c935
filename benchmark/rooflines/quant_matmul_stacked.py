"""K6: ``ops.quant_matmul.quant_matmul_stacked(x, qt3, scales3, idx)``: K5's
work on one block of the stack."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "quant_matmul_stacked")


def shapes(x, qt3, *args, **kwargs):
    return {"m": formulas.rows(x), "k": qt3.shape[-2], "n": qt3.shape[-1]}


def bound_s(s):
    return formulas.q8_0_matmul(s["m"], s["k"], s["n"])
