"""Operations of one Flux DiT call (``models.base.flux_model``'s apply) at
(b, h, w) latent size and ``txt`` text tokens: the matmuls that the
configuration runs in W8A8 (qkv, proj, mlp, linear1, linear2) at the int8
rate; attention (4 B L^2 D over the joint sequence) and the dense bf16
layers (the embedders, the modulations, the final layer) at the bf16
rate. A call that FBCache served (``hit``) ran double block 0 alone."""


def count(cfg: dict, info: dict) -> dict:
    b, txt = info["b"], info["txt"]
    li = (info["h"] // 2) * (info["w"] // 2)
    L = li + txt
    D = cfg["hidden_size"]
    F = int(D * cfg["mlp_ratio"])
    patch_in = cfg["in_channels"] * 4
    dense = 2.0 * b * (li * patch_in * D + txt * cfg["context_in_dim"] * D
                       + 2 * (256 * D + D * D) + cfg["vec_in_dim"] * D + D * D
                       + 2 * D * D + li * D * patch_in)
    double_int8 = 2.0 * b * L * D * (3 * D + D + F + F)
    double_bf16 = 4.0 * b * L * L * D + 2.0 * b * 2 * 6 * D * D
    single_int8 = 2.0 * b * L * D * (3 * D + F) + 2.0 * b * L * (D + F) * D
    single_bf16 = 4.0 * b * L * L * D + 2.0 * b * 3 * D * D
    if info.get("hit"):
        return {"int8": double_int8, "bf16": dense + double_bf16}
    return {"int8": cfg["depth"] * double_int8 + cfg["depth_single_blocks"] * single_int8,
            "bf16": dense + cfg["depth"] * double_bf16 + cfg["depth_single_blocks"] * single_bf16}
