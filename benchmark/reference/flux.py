"""The Flux.1 DiT (black-forest-labs' flux/model.py and modules/layers.py)
in plain PyTorch, f32, with its matmul weights in W8A8.

``layout(cfg)`` lists the parameters under BFL's checkpoint keys, one
group for the embedders and the final layer and one per block, with the
matmul weights the published Q8_0 GGUF quantizes (qkv, proj, mlp.0,
mlp.2, linear1, linear2) stored as Q8_0, the other 2-D weights and the
biases dense, the QKNorm scales f32.

The configuration runs those matmuls in W8A8. So ``DiT`` works out the
W8A8 weights again from the Q8_0 ones (dequantized in f32, then one int8
code per element and one scale per output column, scale = max |w| / 127),
and each of those matmuls quantizes its input per row the same way and
multiplies the codes (exact products, f32 sums). Everything else is f32:
LayerNorm (eps 1e-6, no affine) with the adaLN modulation, QKNorm
(RMSNorm with learned scales), the interleaved-pair RoPE over the three
position axes (16, 56, 56), softmax attention over the text tokens and the
image tokens together, GELU (tanh), gates and residuals. ``DiT`` draws
every block again as it reaches it and runs a batch of inputs through
each block once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import common as C
from benchmark.weights import Leaf, as_f32

Q8_SUFFIXES = ("qkv.weight", "proj.weight", "mlp.0.weight", "mlp.2.weight",
               "linear1.weight", "linear2.weight")


def layout(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    H = cfg["hidden_size"]
    mlp = int(H * cfg["mlp_ratio"])
    hd = H // cfg["num_heads"]

    def lin(out, key, o, i, bias=True):
        out.append(Leaf(key + ".weight", (o, i), std=i ** -0.5,
                        q8=(key + ".weight").endswith(Q8_SUFFIXES)))
        if bias:
            out.append(Leaf(key + ".bias", (o,), std=0.02))

    rest: List[Leaf] = []
    lin(rest, "img_in", H, cfg["in_channels"] * 4)
    lin(rest, "txt_in", H, cfg["context_in_dim"])
    for e, i in (("time_in", 256), ("vector_in", cfg["vec_in_dim"]), ("guidance_in", 256)):
        lin(rest, e + ".in_layer", H, i)
        lin(rest, e + ".out_layer", H, H)
    lin(rest, "final_layer.linear", 4 * cfg["in_channels"], H)
    lin(rest, "final_layer.adaLN_modulation.1", 2 * H, H)
    groups = [("dit.rest", rest)]
    for i in range(cfg["depth"]):
        pre, leaves = f"double_blocks.{i}.", []
        for s in ("img", "txt"):
            lin(leaves, pre + f"{s}_mod.lin", 6 * H, H)
            lin(leaves, pre + f"{s}_attn.qkv", 3 * H, H)
            for n in ("query_norm", "key_norm"):
                leaves.append(Leaf(pre + f"{s}_attn.norm.{n}.scale", (hd,), "one_plus", 0.1,
                                   "f32"))
            lin(leaves, pre + f"{s}_attn.proj", H, H)
            lin(leaves, pre + f"{s}_mlp.0", mlp, H)
            lin(leaves, pre + f"{s}_mlp.2", H, mlp)
        groups.append((f"dit.double.{i}", leaves))
    for i in range(cfg["depth_single_blocks"]):
        pre, leaves = f"single_blocks.{i}.", []
        lin(leaves, pre + "linear1", 3 * H + mlp, H)
        lin(leaves, pre + "linear2", H, H + mlp)
        for n in ("query_norm", "key_norm"):
            leaves.append(Leaf(pre + f"norm.{n}.scale", (hd,), "one_plus", 0.1, "f32"))
        lin(leaves, pre + "modulation.lin", 3 * H, H)
        groups.append((f"dit.single.{i}", leaves))
    return groups


def timestep_embedding(t, dim: int = 256):
    """Flux's: t * 1000, [cos | sin], max period 10000."""
    t = 1000.0 * t.float()
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, device=t.device))
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_angles(h: int, w: int, txt: int, axes=(16, 56, 56), theta: float = 10000.0,
                device=None):
    """(L, sum(axes) / 2) angles of the txt tokens (position 0) then the
    image tokens (0, row, col), in float64."""
    ids = torch.zeros((txt + h * w, 3), dtype=torch.float64, device=device)
    ids[txt:, 1] = torch.arange(h, dtype=torch.float64, device=device).repeat_interleave(w)
    ids[txt:, 2] = torch.arange(w, dtype=torch.float64, device=device).repeat(h)
    parts = []
    for ax, dim in enumerate(axes):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim)
        parts.append(ids[:, ax:ax + 1] * omega[None])
    return torch.cat(parts, dim=-1)


def apply_rope(x, ang):
    """x (B, H, L, D): each pair (2i, 2i + 1) rotated by ang[:, i]."""
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).flatten(-2)


class DiT:
    """``draw(group)`` returns a group's drawn leaves (weights.draw_group)."""

    def __init__(self, draw: Callable[[str], Dict], cfg: dict, prec: C.Precision):
        self.draw, self.cfg, self.prec = draw, cfg, prec

    def _lin(self, p, key, x, bias=True):
        w = p[key + ".weight"]
        b = p.get(key + ".bias") if bias else None
        if (key + ".weight").endswith(Q8_SUFFIXES):
            codes, cs = C.quantize_sym(as_f32(w), 127, dim=1)
            return C.w8a8_linear(x, codes, cs, b, self.prec)
        return C.linear(x, w, b, self.prec)

    def _mlp_embed(self, p, key, x):
        return self._lin(p, key + ".out_layer", F.silu(self._lin(p, key + ".in_layer", x)))

    def _heads(self, qkv, p, key):
        b, l, _ = qkv.shape
        nh = self.cfg["num_heads"]
        q, k, v = qkv.reshape(b, l, 3, nh, -1).permute(2, 0, 3, 1, 4)
        q = C.rms_norm(q, p[key + "query_norm.scale"])
        k = C.rms_norm(k, p[key + "key_norm.scale"])
        return q, k, v

    def _attend(self, q, k, v, ang):
        q, k = apply_rope(q, ang), apply_rope(k, ang)
        o = C.attention(q, k, v, prec=self.prec)
        b, h, l, d = o.shape
        return o.transpose(1, 2).reshape(b, l, h * d)

    @staticmethod
    def _modulate(x, shift, scale):
        return C.layer_norm(x, eps=1e-6) * (1 + scale) + shift

    def _double(self, p, pre, img, txt, vec, ang):
        mods = {}
        for s in ("img", "txt"):
            mods[s] = self._lin(p, pre + f"{s}_mod.lin", F.silu(vec))[:, None].chunk(6, dim=-1)
        qkv = {}
        for s, x in (("img", img), ("txt", txt)):
            sh, sc = mods[s][0], mods[s][1]
            qkv[s] = self._heads(self._lin(p, pre + f"{s}_attn.qkv", self._modulate(x, sh, sc)),
                                 p, pre + f"{s}_attn.norm.")
        q, k, v = (torch.cat([qkv["txt"][j], qkv["img"][j]], dim=2) for j in range(3))
        attn = self._attend(q, k, v, ang)
        lt = txt.shape[1]
        out = {}
        for s, x, a in (("img", img, attn[:, lt:]), ("txt", txt, attn[:, :lt])):
            sh1, sc1, g1, sh2, sc2, g2 = mods[s]
            x = x + g1 * self._lin(p, pre + f"{s}_attn.proj", a)
            h = self._lin(p, pre + f"{s}_mlp.0", self._modulate(x, sh2, sc2))
            out[s] = x + g2 * self._lin(p, pre + f"{s}_mlp.2", F.gelu(h, approximate="tanh"))
        return out["img"], out["txt"]

    def _single(self, p, pre, x, vec, ang):
        H = self.cfg["hidden_size"]
        sh, sc, g = self._lin(p, pre + "modulation.lin", F.silu(vec))[:, None].chunk(3, dim=-1)
        proj = self._lin(p, pre + "linear1", self._modulate(x, sh, sc))
        q, k, v = self._heads(proj[..., :3 * H], p, pre + "norm.")
        attn = self._attend(q, k, v, ang)
        mlp = F.gelu(proj[..., 3 * H:], approximate="tanh")
        return x + g * self._lin(p, pre + "linear2", torch.cat([attn, mlp], dim=-1))

    def __call__(self, x, t, context, y, guidance: float):
        """x (B, H, W, 16) latents, t (B,) sigmas, context (1, L, 4096), y
        (1, 768) -> the velocity (B, H, W, 16), f32."""
        b, hh, ww, c = x.shape
        h2, w2 = hh // 2, ww // 2
        tokens = x.float().reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4)
        tokens = tokens.reshape(b, h2 * w2, c * 4)
        rest = self.draw("dit.rest")
        img = self._lin(rest, "img_in", tokens)
        txt = self._lin(rest, "txt_in", context.float()).expand(b, -1, -1)
        vec = self._mlp_embed(rest, "time_in", timestep_embedding(t))
        g = torch.full((b,), guidance, dtype=torch.float32, device=x.device)
        vec = vec + self._mlp_embed(rest, "guidance_in", timestep_embedding(g))
        vec = vec + self._mlp_embed(rest, "vector_in", y.float().expand(b, -1))
        ang = rope_angles(h2, w2, txt.shape[1], device=x.device)
        for i in range(self.cfg["depth"]):
            p = self.draw(f"dit.double.{i}")
            img, txt = self._double(p, f"double_blocks.{i}.", img, txt, vec, ang)
            del p
        xx = torch.cat([txt, img], dim=1)
        for i in range(self.cfg["depth_single_blocks"]):
            p = self.draw(f"dit.single.{i}")
            xx = self._single(p, f"single_blocks.{i}.", xx, vec, ang)
            del p
        img = xx[:, txt.shape[1]:]
        shift, scale = self._lin(rest, "final_layer.adaLN_modulation.1", F.silu(vec)).chunk(2, -1)
        img = self._modulate(img, shift[:, None], scale[:, None])
        out = self._lin(rest, "final_layer.linear", img)
        out = out.reshape(b, h2, w2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(b, hh, ww, c)
