"""Operations of one CLIP-L text encoder call of (b, L) tokens: four
projections, the MLP and the attention's two products a layer, and the
text projection when there is one, at the bf16 rate."""


def count(cfg: dict, info: dict) -> dict:
    b, L, w = info["b"], info["l"], cfg["width"]
    per = 2.0 * b * L * (4 * w * w + 8 * w * w) + 4.0 * b * L * L * w
    proj = 2.0 * b * w * w if cfg.get("projection") else 0.0
    return {"bf16": cfg["layers"] * per + proj}
