"""The LDM UNet of SD1.5 (runwayml's v1-inference.yaml) in plain PyTorch.

``layout(cfg)`` lists every parameter under the checkpoint's keys
("input_blocks.1.0.in_layers.2.weight", ...), which is also how the
benchmark draws them. ``forward`` is the UNet as the LDM code defines it:
res blocks (GroupNorm 32, SiLU, 3x3 convs, the timestep embedding added),
spatial transformers (GroupNorm eps 1e-6, 1x1 proj_in, self-attention,
cross-attention over the text context, GEGLU feed-forward, 1x1 proj_out),
stride-2 downsampling and nearest x2 upsampling, in f32.

HiDiffusion's MSW-MSA is part of the served model: the self-attention of
input blocks 1, 2 and output blocks 9, 10, 11 runs in 2 x 2 windows,
rolled by a shift of index floor(t) mod 4 (a quarter window per index),
while t lies in the gate's timestep window. ``forward`` takes the shift
index and the gate as arguments; ``sampling.msw_state`` computes them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import common as C
from benchmark.weights import Leaf

MSW_BLOCKS = (("input", 1), ("input", 2), ("output", 9), ("output", 10), ("output", 11))


def plan(cfg: dict):
    """(input_blocks, middle, output_blocks): each block a list of modules
    (kind, key prefix, in channels, out channels)."""
    mc, mult = cfg["model_channels"], cfg["channel_mult"]
    nrb, depth = cfg["num_res_blocks"], cfg["transformer_depth"]
    inputs: List[list] = [[("conv_in", "input_blocks.0.0.", cfg["in_channels"], mc)]]
    chans, ch, nb = [mc], mc, 1
    for lvl, m in enumerate(mult):
        for _ in range(nrb):
            mods = [("res", f"input_blocks.{nb}.0.", ch, mc * m)]
            ch = mc * m
            if depth[lvl]:
                mods.append(("attn", f"input_blocks.{nb}.1.", ch, ch))
            inputs.append(mods)
            chans.append(ch)
            nb += 1
        if lvl != len(mult) - 1:
            inputs.append([("down", f"input_blocks.{nb}.0.", ch, ch)])
            chans.append(ch)
            nb += 1
    middle = [("res", "middle_block.0.", ch, ch), ("attn", "middle_block.1.", ch, ch),
              ("res", "middle_block.2.", ch, ch)]
    outputs, nb = [], 0
    for lvl in reversed(range(len(mult))):
        m = mult[lvl]
        for i in range(nrb + 1):
            ich = chans.pop()
            mods = [("res", f"output_blocks.{nb}.0.", ch + ich, mc * m)]
            ch = mc * m
            if depth[lvl]:
                mods.append(("attn", f"output_blocks.{nb}.1.", ch, ch))
            if lvl and i == nrb:
                mods.append(("up", f"output_blocks.{nb}.{len(mods)}.", ch, ch))
            outputs.append(mods)
            nb += 1
    return inputs, middle, outputs


def layout(cfg: dict, dtype: str = "bf16") -> List[Leaf]:
    """Every UNet parameter: weights N(0, fan_in^-1/2), biases N(0, 0.02),
    norm scales 1 + N(0, 0.1)."""
    out: List[Leaf] = []

    def lin(key, o, i, bias=True):
        out.append(Leaf(key + ".weight", (o, i), std=i ** -0.5, dtype=dtype))
        if bias:
            out.append(Leaf(key + ".bias", (o,), std=0.02, dtype=dtype))

    def conv(key, o, i, k=3):
        out.append(Leaf(key + ".weight", (o, i, k, k), std=(i * k * k) ** -0.5, dtype=dtype))
        out.append(Leaf(key + ".bias", (o,), std=0.02, dtype=dtype))

    def norm(key, c):
        out.append(Leaf(key + ".weight", (c,), "one_plus", 0.1, dtype))
        out.append(Leaf(key + ".bias", (c,), std=0.02, dtype=dtype))

    mc, ctx = cfg["model_channels"], cfg["context_dim"]
    lin("time_embed.0", 4 * mc, mc)
    lin("time_embed.2", 4 * mc, 4 * mc)
    inputs, middle, outputs = plan(cfg)
    for mods in inputs + [middle] + outputs:
        for kind, key, i, o in mods:
            if kind == "conv_in":
                conv(key.rstrip("."), o, i)
            elif kind == "down":
                conv(key + "op", o, i)
            elif kind == "up":
                conv(key + "conv", o, i)
            elif kind == "res":
                norm(key + "in_layers.0", i)
                conv(key + "in_layers.2", o, i)
                lin(key + "emb_layers.1", o, 4 * mc)
                norm(key + "out_layers.0", o)
                conv(key + "out_layers.3", o, o)
                if i != o:
                    conv(key + "skip_connection", o, i, k=1)
            else:
                norm(key + "norm", o)
                conv(key + "proj_in", o, o, k=1)
                tb = key + "transformer_blocks.0."
                for n in ("norm1", "norm2", "norm3"):
                    norm(tb + n, o)
                for a, kv in (("attn1", o), ("attn2", ctx)):
                    lin(tb + f"{a}.to_q", o, o, bias=False)
                    lin(tb + f"{a}.to_k", o, kv, bias=False)
                    lin(tb + f"{a}.to_v", o, kv, bias=False)
                    lin(tb + f"{a}.to_out.0", o, o)
                lin(tb + "ff.net.0.proj", 8 * o, o)
                lin(tb + "ff.net.2", o, 4 * o)
                conv(key + "proj_out", o, o, k=1)
    norm("out.0", mc)
    conv("out.2", cfg["out_channels"], mc)
    return out


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding, [cos | sin], max period 10000."""
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, device=t.device))
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _windows(x, hw, shift, reverse=False):
    """(B, H*W, C) <-> (4B, H/2*W/2, C): 2 x 2 windows after a roll by -shift."""
    h, w = hw
    if not reverse:
        b, _, c = x.shape
        x = torch.roll(x.reshape(b, h, w, c), (-shift[0], -shift[1]), dims=(1, 2))
        x = x.reshape(b, 2, h // 2, 2, w // 2, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(4 * b, (h // 2) * (w // 2), c)
    b4, _, c = x.shape
    x = x.reshape(b4 // 4, 2, 2, h // 2, w // 2, c).permute(0, 1, 3, 2, 4, 5)
    x = torch.roll(x.reshape(b4 // 4, h, w, c), (shift[0], shift[1]), dims=(1, 2))
    return x.reshape(b4 // 4, h * w, c)


class UNet:
    """The UNet over f32 params; ``prec`` as in ``common.Precision``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, prec: C.Precision):
        self.p, self.cfg, self.prec = params, cfg, prec
        self.plan = plan(cfg)

    def _lin(self, x, key, bias=True):
        return C.linear(x, self.p[key + ".weight"], self.p.get(key + ".bias") if bias
                        else None, self.prec)

    def _conv(self, x, key, stride=1, padding=1):
        return C.conv2d(x, self.p[key + ".weight"], self.p[key + ".bias"], stride, padding,
                        self.prec)

    def _gn(self, x, key, eps=1e-5):
        return C.group_norm(x, self.p[key + ".weight"], self.p[key + ".bias"], eps=eps)

    def _res(self, key, x, emb):
        h = self._conv(F.silu(self._gn(x, key + "in_layers.0")), key + "in_layers.2")
        h = h + self._lin(F.silu(emb), key + "emb_layers.1")[:, None, None, :]
        h = self._conv(F.silu(self._gn(h, key + "out_layers.0")), key + "out_layers.3")
        if key + "skip_connection.weight" in self.p:
            x = self._conv(x, key + "skip_connection", padding=0)
        return x + h

    def _attend(self, key, x, ctx, heads, window):
        q = self._lin(x, key + "to_q", bias=False)
        src = x if ctx is None else ctx
        k = self._lin(src, key + "to_k", bias=False)
        v = self._lin(src, key + "to_v", bias=False)
        if window is not None:
            hw, shift = window
            q, k, v = (_windows(t, hw, shift) for t in (q, k, v))
        b, lq, c = q.shape
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, c // heads).transpose(1, 2)
        o = C.attention(split(q), split(k), split(v), prec=self.prec)
        o = o.transpose(1, 2).reshape(b, lq, c)
        if window is not None:
            o = _windows(o, hw, shift, reverse=True)
        return self._lin(o, key + "to_out.0")

    def _transformer(self, key, x, ctx, block, msw):
        b, h, w, c = x.shape
        heads = self.cfg["num_heads"]
        x_in = x
        x = self._conv(self._gn(x, key + "norm", eps=1e-6), key + "proj_in", padding=0)
        x = x.reshape(b, h * w, c)
        tb = key + "transformer_blocks.0."
        window = None
        shift_idx, active = msw
        if active and block in MSW_BLOCKS:
            window = ((h, w), ((h // 2 // 4) * shift_idx, (w // 2 // 4) * shift_idx))
        ln = lambda t, n: C.layer_norm(t, self.p[tb + n + ".weight"], self.p[tb + n + ".bias"])
        x = x + self._attend(tb + "attn1.", ln(x, "norm1"), None, heads, window)
        x = x + self._attend(tb + "attn2.", ln(x, "norm2"), ctx, heads, None)
        val, gate = self._lin(ln(x, "norm3"), tb + "ff.net.0.proj").chunk(2, dim=-1)
        x = x + self._lin(val * F.gelu(gate), tb + "ff.net.2")
        x = self._conv(x.reshape(b, h, w, c), key + "proj_out", padding=0)
        return x + x_in

    def _block(self, mods, h, emb, ctx, block, msw):
        for kind, key, _, _ in mods:
            if kind == "conv_in":
                h = self._conv(h, key.rstrip("."))
            elif kind == "res":
                h = self._res(key, h, emb)
            elif kind == "attn":
                h = self._transformer(key, h, ctx, block, msw)
            elif kind == "down":
                h = self._conv(h, key + "op", stride=2)
            else:
                h = self._conv(h.repeat_interleave(2, 1).repeat_interleave(2, 2), key + "conv")
        return h

    def __call__(self, x, t, ctx, msw: Tuple[int, bool]):
        """x (B, H, W, 4) scaled input, t (B,) timesteps, ctx (B, L, 768)
        -> eps prediction (B, H, W, 4), f32."""
        mc = self.cfg["model_channels"]
        emb = self._lin(timestep_embedding(t, mc), "time_embed.0")
        emb = self._lin(F.silu(emb), "time_embed.2")
        inputs, middle, outputs = self.plan
        hs, h = [], x.float()
        for i, mods in enumerate(inputs):
            h = self._block(mods, h, emb, ctx, ("input", i), msw)
            hs.append(h)
        h = self._block(middle, h, emb, ctx, ("middle", 0), msw)
        for i, mods in enumerate(outputs):
            h = self._block(mods, torch.cat([h, hs.pop()], dim=-1), emb, ctx, ("output", i), msw)
        h = F.silu(self._gn(h, "out.0"))
        return self._conv(h, "out.2")
