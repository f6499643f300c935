"""The AutoencoderKL decoder (the SD VAE, and the Flux AE: 16 latent
channels, no quant convs) in plain PyTorch, f32.

``layout(cfg)`` lists encoder and decoder under the checkpoint's keys (a
served VAE holds both); ``decode`` runs post_quant_conv, conv_in, the mid
block (res, single-head attention over every pixel, res), four up levels
of three res blocks with nearest x2 upsampling, GroupNorm, SiLU, conv_out,
and maps [-1, 1] to [0, 1].
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import common as C
from benchmark.weights import Leaf


def layout(cfg: dict, dtype: str = "f32") -> List[Leaf]:
    out: List[Leaf] = []

    def conv(key, o, i, k=3):
        out.append(Leaf(key + ".weight", (o, i, k, k), std=(i * k * k) ** -0.5, dtype=dtype))
        out.append(Leaf(key + ".bias", (o,), std=0.02, dtype=dtype))

    def norm(key, c):
        out.append(Leaf(key + ".weight", (c,), "one_plus", 0.1, dtype))
        out.append(Leaf(key + ".bias", (c,), std=0.02, dtype=dtype))

    def res(pre, i, o):
        norm(pre + "norm1", i)
        conv(pre + "conv1", o, i)
        norm(pre + "norm2", o)
        conv(pre + "conv2", o, o)
        if i != o:
            conv(pre + "nin_shortcut", o, i, k=1)

    def attn(pre, c):
        norm(pre + "norm", c)
        for n in ("q", "k", "v", "proj_out"):
            conv(pre + n, c, c, k=1)

    ch, mult, nrb, z = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"], cfg["z_channels"]
    conv("encoder.conv_in", ch, 3)
    c = ch
    for i, m in enumerate(mult):
        for j in range(nrb):
            res(f"encoder.down.{i}.block.{j}.", c, ch * m)
            c = ch * m
        if i != len(mult) - 1:
            conv(f"encoder.down.{i}.downsample.conv", c, c)
    res("encoder.mid.block_1.", c, c)
    attn("encoder.mid.attn_1.", c)
    res("encoder.mid.block_2.", c, c)
    norm("encoder.norm_out", c)
    conv("encoder.conv_out", 2 * z, c)
    if cfg["has_quant_conv"]:
        conv("quant_conv", 2 * z, 2 * z, k=1)
        conv("post_quant_conv", z, z, k=1)
    conv("decoder.conv_in", c, z)
    res("decoder.mid.block_1.", c, c)
    attn("decoder.mid.attn_1.", c)
    res("decoder.mid.block_2.", c, c)
    for i in reversed(range(len(mult))):
        o = ch * mult[i]
        for j in range(nrb + 1):
            res(f"decoder.up.{i}.block.{j}.", c, o)
            c = o
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", c, c)
    norm("decoder.norm_out", c)
    conv("decoder.conv_out", 3, c)
    return out


class Decoder:
    """latent NHWC -> pixels NHWC in [0, 1], f32; ``prec.f32`` rounds the
    convolution and attention operands in the control."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, prec: C.Precision):
        self.p, self.cfg, self.prec = params, cfg, prec

    def _conv(self, x, key, padding=1):
        return C.conv2d(x, self.p[key + ".weight"], self.p[key + ".bias"], padding=padding,
                        prec=self.prec, stated="f32")

    def _gn(self, x, key):
        return C.group_norm(x, self.p[key + ".weight"], self.p[key + ".bias"], eps=1e-6)

    def _res(self, pre, x):
        h = self._conv(F.silu(self._gn(x, pre + "norm1")), pre + "conv1")
        h = self._conv(F.silu(self._gn(h, pre + "norm2")), pre + "conv2")
        if pre + "nin_shortcut.weight" in self.p:
            x = self._conv(x, pre + "nin_shortcut", padding=0)
        return x + h

    def _attn(self, pre, x):
        b, h, w, c = x.shape
        n = self._gn(x, pre + "norm")
        q, k, v = (self._conv(n, pre + s, padding=0).reshape(b, 1, h * w, c)
                   for s in ("q", "k", "v"))
        o = C.attention(q, k, v, prec=self.prec, stated="f32", block=2048)
        return x + self._conv(o.reshape(b, h, w, c), pre + "proj_out", padding=0)

    def __call__(self, z):
        z = z.float()
        if self.cfg["has_quant_conv"]:
            z = self._conv(z, "post_quant_conv", padding=0)
        h = self._conv(z, "decoder.conv_in")
        h = self._res("decoder.mid.block_1.", h)
        h = self._attn("decoder.mid.attn_1.", h)
        h = self._res("decoder.mid.block_2.", h)
        for i in reversed(range(len(self.cfg["ch_mult"]))):
            for j in range(self.cfg["num_res_blocks"] + 1):
                h = self._res(f"decoder.up.{i}.block.{j}.", h)
            if i != 0:
                h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = self._conv(h, f"decoder.up.{i}.upsample.conv")
        h = self._conv(F.silu(self._gn(h, "decoder.norm_out")), "decoder.conv_out")
        return torch.clamp((h + 1.0) / 2.0, 0.0, 1.0)
