"""K3: ``ops.flash_attention.fused_qkv_attention(qkv, ..., num_heads)``,
qkv (B, L, >= 3 H 128); QKNorm and RoPE ride along, counted as nothing."""

from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.flash_attention", "fused_qkv_attention")


def shapes(qkv, *args, num_heads, **kwargs):
    return {"b": qkv.shape[0], "l": qkv.shape[1], "h": num_heads}


def bound_s(s):
    return formulas.attention(s["b"], s["h"], s["l"], s["l"], 128)
