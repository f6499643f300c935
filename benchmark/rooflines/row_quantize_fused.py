"""K9: ``ops.quant_matmul.row_quantize_fused(x, mod_scale, mod_shift,
prologue=...)``."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.quant_matmul", "row_quantize_fused")


def shapes(x, *args, prologue="none", **kwargs):
    return {"m": formulas.rows(x), "k": x.shape[-1], "ln_mod": prologue == "ln_mod"}


def bound_s(s):
    return formulas.row_quantize(s["m"], s["k"], s["ln_mod"])
