"""Operations of one T5 encoder call of (b, L) tokens: the seven matmuls of
every block (Q8_0 weights multiplied in bf16) and the attention's two
products, at the bf16 rate."""


def count(cfg: dict, info: dict) -> dict:
    b, L = info["b"], info["l"]
    d, ff = cfg["d_model"], cfg["d_ff"]
    per = 2.0 * b * L * (4 * d * d + 3 * d * ff) + 4.0 * b * L * L * d
    return {"bf16": cfg["num_layers"] * per}
