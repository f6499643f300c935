"""Operations of one SD1.5 UNet call (``models.base.sd15_model``'s apply),
from its shapes: 2 M K N for every convolution and linear layer and 4 B H
Lq Lk D for each attention's two products, all at the bf16 rate (the
configuration computes the UNet in bf16). MSW-MSA's windowed
self-attention, when its gate is open, attends within four windows of a
quarter of the tokens each: a quarter of the products.

``info``: b, h, w (the latent's), ctx (text tokens), windowed."""

from benchmark.reference import unet as ref


def count(cfg: dict, info: dict) -> dict:
    b, h, w, L = info["b"], info["h"], info["w"], info["ctx"]
    mc, ctx_dim = cfg["model_channels"], cfg["context_dim"]
    total = 2.0 * b * (mc * 4 * mc + 16 * mc * mc)  # time embedding
    inputs, middle, outputs = ref.plan(cfg)
    blocks = ([(("input", i), m) for i, m in enumerate(inputs)] + [(("middle", 0), middle)]
              + [(("output", i), m) for i, m in enumerate(outputs)])
    for block, mods in blocks:
        for kind, _, cin, cout in mods:
            n = h * w
            if kind == "conv_in":
                total += 2.0 * b * n * 9 * cin * cout
            elif kind == "res":
                total += 2.0 * b * n * 9 * (cin * cout + cout * cout) + 2.0 * b * 4 * mc * cout
                if cin != cout:
                    total += 2.0 * b * n * cin * cout
            elif kind == "attn":
                c = cout
                self_attn = 4.0 * b * n * n * c
                if info["windowed"] and block in ref.MSW_BLOCKS:
                    self_attn /= 4
                total += (2.0 * b * n * c * c * 2  # proj_in, proj_out
                          + 2.0 * b * n * c * c * 4 + self_attn  # attn1
                          + 2.0 * b * n * c * c * 2 + 2.0 * b * L * ctx_dim * c * 2
                          + 4.0 * b * n * L * c  # attn2
                          + 2.0 * b * n * c * 8 * c + 2.0 * b * n * 4 * c * c)  # GEGLU
            elif kind == "down":
                h, w = h // 2, w // 2
                total += 2.0 * b * h * w * 9 * cin * cout
            else:
                h, w = h * 2, w * 2
                total += 2.0 * b * h * w * 9 * cin * cout
    total += 2.0 * b * h * w * 9 * mc * cfg["out_channels"]
    return {"bf16": total}
