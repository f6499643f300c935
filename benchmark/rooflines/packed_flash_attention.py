"""K1: ``ops.flash_attention.packed_flash_attention(q, k, v)``, (B, H, L, D)."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.flash_attention", "packed_flash_attention")


def shapes(q, k, v, *args, **kwargs):
    return {"b": q.shape[0], "h": q.shape[1], "lq": q.shape[2], "lk": k.shape[2],
            "d": q.shape[3], "elt": q.element_size()}


def bound_s(s):
    return formulas.attention(s["b"], s["h"], s["lq"], s["lk"], s["d"], s["elt"])
