"""The CLIP-L text transformer (openai/clip-vit-large-patch14's text
tower) in plain PyTorch, f32, with SD's clip-skip and prompt weights.

``layout(cfg)`` lists it under the HF keys ("text_model.*"). ``encode``
takes rows of 77 token ids with one weight per token, as the benchmark's
prompt file holds them: the causal transformer (pre-LayerNorm, quick-GELU
MLP), the hidden state after ``layer`` (clip-skip -2: the eleventh of
twelve) put through the final LayerNorm, the pooled vector at the first
end token of the last layer (times ``text_projection`` where the params
hold it). A row with weights other than 1 is lerped per token against the
empty prompt's hidden state, (z - z_empty) * w + z_empty.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import common as C
from benchmark.weights import Leaf

START, END = 49406, 49407


def layout(cfg: dict, dtype: str = "bf16") -> List[Leaf]:
    w, n = cfg["width"], cfg["layers"]
    out = [Leaf("text_model.embeddings.token_embedding.weight", (cfg["vocab"], w), std=0.02,
                dtype=dtype),
           Leaf("text_model.embeddings.position_embedding.weight", (77, w), std=0.01,
                dtype=dtype)]

    def lin(key, o, i):
        out.append(Leaf(key + ".weight", (o, i), std=i ** -0.5, dtype=dtype))
        out.append(Leaf(key + ".bias", (o,), std=0.02, dtype=dtype))

    def norm(key):
        out.append(Leaf(key + ".weight", (w,), "one_plus", 0.1, dtype))
        out.append(Leaf(key + ".bias", (w,), std=0.02, dtype=dtype))

    for i in range(n):
        pre = f"text_model.encoder.layers.{i}."
        norm(pre + "layer_norm1")
        norm(pre + "layer_norm2")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(pre + "self_attn." + p, w, w)
        lin(pre + "mlp.fc1", 4 * w, w)
        lin(pre + "mlp.fc2", w, 4 * w)
    norm("text_model.final_layer_norm")
    if cfg.get("projection"):
        out.append(Leaf("text_projection.weight", (w, w), std=w ** -0.5, dtype=dtype))
    return out


def empty_row(length: int = 77) -> List[int]:
    return [START, END] + [END] * (length - 2)


class TextEncoder:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, prec: C.Precision):
        self.p, self.cfg, self.prec = params, cfg, prec

    def _lin(self, x, key):
        return C.linear(x, self.p[key + ".weight"], self.p[key + ".bias"], self.prec)

    def _ln(self, x, key):
        return C.layer_norm(x, self.p[key + ".weight"], self.p[key + ".bias"])

    def hidden(self, ids: torch.Tensor, layer: Optional[int]):
        """ids (B, 77) -> (the hidden state after ``layer`` (None: the last)
        through the final LayerNorm, the pooled vector)."""
        p = self.p
        heads = self.cfg["width"] // 64
        x = p["text_model.embeddings.token_embedding.weight"].float()[ids]
        x = x + p["text_model.embeddings.position_embedding.weight"].float()[None, :ids.shape[1]]
        L = x.shape[1]
        mask = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        n = self.cfg["layers"]
        stop = None if layer is None else (layer % n)
        inter = None
        for i in range(n):
            pre = f"text_model.encoder.layers.{i}."
            h = self._ln(x, pre + "layer_norm1")
            q, k, v = (self._lin(h, pre + "self_attn." + s) for s in ("q_proj", "k_proj", "v_proj"))
            b, l, c = q.shape
            split = lambda t: t.reshape(b, l, heads, c // heads).transpose(1, 2)
            a = C.attention(split(q), split(k), split(v), mask=mask, prec=self.prec)
            x = x + self._lin(a.transpose(1, 2).reshape(b, l, c), pre + "self_attn.out_proj")
            h = self._lin(self._ln(x, pre + "layer_norm2"), pre + "mlp.fc1")
            x = x + self._lin(h * torch.sigmoid(1.702 * h), pre + "mlp.fc2")
            if i == stop:
                inter = x
        last = self._ln(x, "text_model.final_layer_norm")
        z = last if inter is None else self._ln(inter, "text_model.final_layer_norm")
        eos = torch.argmax((ids == END).int(), dim=-1)
        pooled = last[torch.arange(ids.shape[0], device=ids.device), eos]
        if "text_projection.weight" in p:
            pooled = C.linear(pooled, p["text_projection.weight"], None, self.prec)
        return z, pooled

    def encode(self, rows: List[List[int]], weights: List[List[float]],
               layer: Optional[int], device):
        """Weighted rows -> (cond (1, 77 * rows, width), pooled (1, width))."""
        weighted = any(w != 1.0 for row in weights for w in row)
        ids = [list(r) for r in rows] + ([empty_row(len(rows[0]))] if weighted else [])
        z, pooled = self.hidden(torch.tensor(ids, device=device), layer)
        out = []
        for k in range(len(rows)):
            zk = z[k]
            if weighted:
                w = torch.tensor(weights[k], device=device, dtype=torch.float32)[:, None]
                zk = (zk - z[-1]) * w + z[-1]
            out.append(zk)
        return torch.cat(out, dim=0)[None], pooled[0:1]
