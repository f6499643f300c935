"""The T5 v1.1 encoder (google/t5-v1_1-xxl's) in plain PyTorch, f32.

``layout(cfg)`` lists it under the HF keys, with the seven matmul weights
of every block and the token embedding stored as Q8_0, as the published
encoder GGUF stores them; one group per block, so ``Encoder`` draws each
block again as it reaches it. The forward: the embedding, the bucketed
relative-position bias of block 0 (32 buckets, distance 128,
bidirectional) shared by all blocks, each block RMSNorm (eps 1e-6),
unscaled self-attention, RMSNorm, the gated-GELU (tanh) feed-forward;
the final RMSNorm. The Q8_0 weights are dequantized in f32, and every
position attends to every other, padding included, as the Flux flow
encodes its 256 tokens.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common as C
from benchmark.weights import Leaf, as_f32

BIAS_KEY = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def layout(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    """T5's own initialisation (Hugging Face's ``T5PreTrainedModel``): q
    N(0, (d_model d_kv)^-1/2), which stands in for the attention scale T5
    leaves out, k and v N(0, d_model^-1/2), o N(0, (heads d_kv)^-1/2), the
    feed-forward N(0, fan_in^-1/2), the embedding N(0, 1), the bias table
    N(0, d_model^-1/2); norm scales 1 + N(0, 0.1)."""
    d, ff, heads = cfg["d_model"], cfg["d_ff"], cfg["num_heads"]
    dkv = d // heads
    rest = [Leaf("shared.weight", (cfg["vocab"], d), std=1.0, q8=True),
            Leaf(BIAS_KEY, (32, heads), std=d ** -0.5),
            Leaf("encoder.final_layer_norm.weight", (d,), "one_plus", 0.1)]
    groups = [("t5.rest", rest)]
    for i in range(cfg["num_layers"]):
        pre = f"encoder.block.{i}."
        stds = {"q": (d * dkv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5, "o": (heads * dkv) ** -0.5}
        leaves = [Leaf(pre + f"layer.0.SelfAttention.{n}.weight", (d, d), std=stds[n], q8=True)
                  for n in "qkvo"]
        leaves += [Leaf(pre + "layer.0.layer_norm.weight", (d,), "one_plus", 0.1),
                   Leaf(pre + "layer.1.layer_norm.weight", (d,), "one_plus", 0.1)]
        leaves += [Leaf(pre + f"layer.1.DenseReluDense.{n}.weight", (ff, d), std=d ** -0.5,
                        q8=True) for n in ("wi_0", "wi_1")]
        leaves.append(Leaf(pre + "layer.1.DenseReluDense.wo.weight", (d, ff), std=ff ** -0.5,
                           q8=True))
        groups.append((f"t5.block.{i}", leaves))
    return groups


def buckets(length: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """Mesh-TF's bidirectional relative-position buckets, (L, L)."""
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    half = num_buckets // 2
    out = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    exact = half // 2
    with np.errstate(divide="ignore"):
        large = exact + (np.log(np.maximum(rel, 1) / exact) / math.log(max_distance / exact)
                         * (half - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, half - 1))


class Encoder:
    """``draw(group)`` returns a group's drawn leaves (weights.draw_group)."""

    def __init__(self, draw: Callable[[str], Dict], cfg: dict, prec: C.Precision):
        self.draw, self.cfg, self.prec = draw, cfg, prec

    def _w(self, leaf):
        """A Q8_0 weight in f32; in the control its 32-blocks requantized
        to int4."""
        w = as_f32(leaf)
        if self.prec.control:
            codes, s = C.quantize_sym(w.reshape(w.shape[0], -1, 32), self.prec.qmax)
            w = (codes * s).reshape(w.shape)
        return w

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, L) -> (B, L, d_model) f32."""
        rest = self.draw("t5.rest")
        heads = self.cfg["num_heads"]
        x = self._w(rest["shared.weight"])[ids]
        L = ids.shape[1]
        idx = torch.as_tensor(buckets(L), device=ids.device)
        bias = rest[BIAS_KEY].float()[idx].permute(2, 0, 1)[None]
        for i in range(self.cfg["num_layers"]):
            p = self.draw(f"t5.block.{i}")
            pre = f"encoder.block.{i}."
            a = pre + "layer.0.SelfAttention."
            h = C.rms_norm(x, p[pre + "layer.0.layer_norm.weight"])
            q, k, v = (C.linear(h, self._w(p[a + n + ".weight"]), None, self.prec)
                       for n in "qkv")
            b, l, c = q.shape
            split = lambda t: t.reshape(b, l, heads, c // heads).transpose(1, 2)
            o = C.attention(split(q), split(k), split(v), scale=1.0, bias=bias, prec=self.prec)
            x = x + C.linear(o.transpose(1, 2).reshape(b, l, c), self._w(p[a + "o.weight"]),
                             None, self.prec)
            f = pre + "layer.1.DenseReluDense."
            h = C.rms_norm(x, p[pre + "layer.1.layer_norm.weight"])
            g = F.gelu(C.linear(h, self._w(p[f + "wi_0.weight"]), None, self.prec),
                       approximate="tanh")
            u = C.linear(h, self._w(p[f + "wi_1.weight"]), None, self.prec)
            x = x + C.linear(g * u, self._w(p[f + "wo.weight"]), None, self.prec)
            del p
        return C.rms_norm(x, rest["encoder.final_layer_norm.weight"])
