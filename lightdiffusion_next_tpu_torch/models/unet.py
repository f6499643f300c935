"""LDM UNet (SD1.5 and its SD2-class branches) as plain functions over a
flat param dict.

Counterpart of lightdiffusion_next_tpu/models/unet.py: the same static block
plan, the same checkpoint keys ("input_blocks.1.0.in_layers.2.weight", ...),
NHWC activations at the boundary, f32 norms, and the MSW-MSA override as an
explicit functional argument. Conv weights are OIHW; the attention
projections are joined once at build time (``fuse_projections``) unless
``RuntimeConfig.qkv_fuse`` is off, and ``cross_attention`` runs whichever
layout the params hold. ``apply_unet``'s ``first_block_hook`` is FBCache's
place, after input blocks 0 and 1, as in the JAX UNet. The config's
``num_head_channels`` (heads set by channels), ``use_linear_in_transformer``
(linear ``proj_in``/``proj_out`` on the tokens) and the label embedding
(``label_emb.0.*``, added to the timestep embedding when the params hold
it and ``y`` is given) follow the JAX UNet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.sampling.schedules import timestep_embedding
from lightdiffusion_next_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture description."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 0)  # per level
    transformer_depth_middle: int = 1
    context_dim: Optional[int] = 768
    num_heads: int = 8
    num_head_channels: int = -1
    use_linear_in_transformer: bool = False
    adm_in_channels: Optional[int] = None
    dtype: torch.dtype = torch.float32

    def heads_for(self, ch: int) -> Tuple[int, int]:
        """(heads, head dim): a fixed head count, or with
        ``num_head_channels`` a fixed head width."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels


SD15_CONFIG = UNetConfig()


@dataclasses.dataclass(frozen=True)
class _Block:
    kind: str  # "conv_in" | "res" | "attn" | "down" | "up"
    key: str  # param prefix, e.g. "input_blocks.1.0."
    in_ch: int = 0
    out_ch: int = 0
    skip_ch: int = 0
    depth: int = 0  # transformer depth for "attn"


def build_plan(cfg: UNetConfig):
    """(input_blocks, middle_blocks, output_blocks); each inner list holds the
    modules of one numbered block."""
    input_blocks: List[List[_Block]] = [
        [_Block("conv_in", "input_blocks.0.0.", cfg.in_channels, cfg.model_channels)]
    ]
    input_block_chans = [cfg.model_channels]
    ch = cfg.model_channels
    nb = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks[level]):
            out_ch = cfg.model_channels * mult
            mods = [_Block("res", f"input_blocks.{nb}.0.", ch, out_ch)]
            ch = out_ch
            if cfg.transformer_depth[level] > 0:
                mods.append(_Block("attn", f"input_blocks.{nb}.1.", ch, ch,
                                   depth=cfg.transformer_depth[level]))
            input_blocks.append(mods)
            input_block_chans.append(ch)
            nb += 1
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([_Block("down", f"input_blocks.{nb}.0.", ch, ch)])
            input_block_chans.append(ch)
            nb += 1

    middle = [
        _Block("res", "middle_block.0.", ch, ch),
        _Block("attn", "middle_block.1.", ch, ch, depth=cfg.transformer_depth_middle),
        _Block("res", "middle_block.2.", ch, ch),
    ]

    output_blocks: List[List[_Block]] = []
    nb = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks[level] + 1):
            ich = input_block_chans.pop()
            out_ch = cfg.model_channels * mult
            mods = [_Block("res", f"output_blocks.{nb}.0.", ch + ich, out_ch, skip_ch=ich)]
            ch = out_ch
            midx = 1
            if cfg.transformer_depth[level] > 0:
                mods.append(_Block("attn", f"output_blocks.{nb}.{midx}.", ch, ch,
                                   depth=cfg.transformer_depth[level]))
                midx += 1
            if level and i == cfg.num_res_blocks[level]:
                mods.append(_Block("up", f"output_blocks.{nb}.{midx}.", ch, ch))
            output_blocks.append(mods)
            nb += 1
    return input_blocks, middle, output_blocks


def resblock(p: nn.ParamView, x, emb):
    """GN-SiLU-conv, + timestep embedding, GN-SiLU-conv, skip."""
    h = nn.group_norm(x, p("in_layers.0.weight"), p("in_layers.0.bias"))
    h = nn.silu(h)
    h = nn.conv2d(h, p("in_layers.2.weight"), p("in_layers.2.bias"), padding=1)
    emb_out = nn.linear(nn.silu(emb), p("emb_layers.1.weight"), p("emb_layers.1.bias"))
    h = h + emb_out[:, None, None, :].to(h.dtype)
    h = nn.group_norm(h, p("out_layers.0.weight"), p("out_layers.0.bias"))
    h = nn.silu(h)
    h = nn.conv2d(h, p("out_layers.3.weight"), p("out_layers.3.bias"), padding=1)
    if p.has("skip_connection.weight"):
        x = nn.conv2d(x, p("skip_connection.weight"), p("skip_connection.bias"))
    return x + h


def fuse_projections(params: dict) -> dict:
    """The params ``apply_unet`` reads: the checkpoint's keys, except that
    each self-attention's to_q, to_k and to_v weights become one
    ``attn1.to_qkv.weight`` and each cross-attention's to_k and to_v one
    ``attn2.to_kv.weight`` (rows stacked in that order), so each runs as one
    wide matmul with the same contraction per output element. Done once,
    when the model is built (``base.sd15_model``)."""
    out = dict(params)
    for key in params:
        if key.endswith("attn1.to_q.weight"):
            pre, names = key[: -len("to_q.weight")], ("to_q", "to_k", "to_v")
            out[pre + "to_qkv.weight"] = torch.cat(
                [out.pop(f"{pre}{n}.weight") for n in names], dim=0)
        elif key.endswith("attn2.to_k.weight"):
            pre, names = key[: -len("to_k.weight")], ("to_k", "to_v")
            out[pre + "to_kv.weight"] = torch.cat(
                [out.pop(f"{pre}{n}.weight") for n in names], dim=0)
    return out


def cross_attention(p: nn.ParamView, x, context, heads: int,
                    attn_override: Optional[Callable] = None, block=None, hw=None):
    """Projections without bias (with joined params, one q|k|v matmul for
    self-attention and q, then one k|v matmul of the context for
    cross-attention, see ``fuse_projections``; else the checkpoint's three),
    attention, to_out."""
    if context is None and p.has("to_qkv.weight"):
        q, k, v = nn.linear(x, p("to_qkv.weight")).chunk(3, dim=-1)
    elif context is not None and p.has("to_kv.weight"):
        q = nn.linear(x, p("to_q.weight"))
        k, v = nn.linear(context, p("to_kv.weight")).chunk(2, dim=-1)
    else:
        ctx = x if context is None else context
        q = nn.linear(x, p("to_q.weight"))
        k = nn.linear(ctx, p("to_k.weight"))
        v = nn.linear(ctx, p("to_v.weight"))
    if attn_override is not None:
        out = attn_override(q, k, v, heads, block=block, hw=hw)
    else:
        out = attn_ops.attention(q, k, v, heads)
    return nn.linear(out, p("to_out.0.weight"), p("to_out.0.bias"))


def basic_transformer_block(p: nn.ParamView, x, context, heads: int,
                            attn1_override: Optional[Callable] = None,
                            block=None, hw=None):
    """Self-attention, cross-attention, GEGLU feed-forward; each with a
    pre-LayerNorm and a residual."""
    h = nn.layer_norm(x, p("norm1.weight"), p("norm1.bias"))
    x = x + cross_attention(p.scope("attn1."), h, None, heads, attn1_override,
                            block=block, hw=hw)
    h = nn.layer_norm(x, p("norm2.weight"), p("norm2.bias"))
    x = x + cross_attention(p.scope("attn2."), h, context, heads)
    h = nn.layer_norm(x, p("norm3.weight"), p("norm3.bias"))
    x = x + nn.linear(
        nn.geglu(h, p("ff.net.0.proj.weight"), p("ff.net.0.proj.bias")),
        p("ff.net.2.weight"), p("ff.net.2.bias"),
    )
    return x


def spatial_transformer(p: nn.ParamView, x, context, cfg: UNetConfig, depth: int,
                        attn1_override: Optional[Callable] = None, block=None):
    """GN (eps 1e-6), proj_in (1x1 conv, or linear on the tokens with
    ``use_linear_in_transformer``), blocks, proj_out, residual."""
    b, hh, ww, c = x.shape
    heads, _ = cfg.heads_for(c)
    x_in = x
    x = nn.group_norm(x, p("norm.weight"), p("norm.bias"), eps=1e-6)
    if cfg.use_linear_in_transformer:
        x = nn.linear(x.reshape(b, hh * ww, c), p("proj_in.weight"), p("proj_in.bias"))
    else:
        x = nn.conv2d(x, p("proj_in.weight"), p("proj_in.bias")).reshape(b, hh * ww, c)
    for d in range(depth):
        x = basic_transformer_block(p.scope(f"transformer_blocks.{d}."), x, context,
                                    heads, attn1_override, block=block, hw=(hh, ww))
    if cfg.use_linear_in_transformer:
        x = nn.linear(x, p("proj_out.weight"), p("proj_out.bias")).reshape(b, hh, ww, c)
    else:
        x = nn.conv2d(x.reshape(b, hh, ww, c), p("proj_out.weight"), p("proj_out.bias"))
    return x + x_in


def downsample(p: nn.ParamView, x):
    """Stride-2 3x3 conv."""
    return nn.conv2d(x, p("op.weight"), p("op.bias"), stride=2, padding=1)


def upsample(p: nn.ParamView, x):
    """Nearest x2, then a 3x3 conv."""
    return nn.conv2d(nn.interpolate_nearest(x, 2), p("conv.weight"), p("conv.bias"),
                     padding=1)


def _run_block(mods, params, h, emb, context, cfg, attn1_override, block=None):
    """``block``: ("input"|"middle"|"output", index), the identity the
    MSW-MSA override gates on."""
    for m in mods:
        p = nn.ParamView(params, m.key)
        if m.kind == "conv_in":
            h = nn.conv2d(h, p("weight"), p("bias"), padding=1)
        elif m.kind == "res":
            h = resblock(p, h, emb)
        elif m.kind == "attn":
            h = spatial_transformer(p, h, context, cfg, m.depth, attn1_override,
                                    block=block)
        elif m.kind == "down":
            h = downsample(p, h)
        elif m.kind == "up":
            h = upsample(p, h)
    return h


def apply_unet(params: dict, x, timesteps, context, y=None,
               cfg: UNetConfig = SD15_CONFIG, plan=None,
               attn1_override: Optional[Callable] = None,
               first_block_hook: Optional[Callable] = None):
    """params: checkpoint-keyed, joined by ``fuse_projections`` or not; x:
    (B, H, W, C) latent; timesteps: (B,) discrete t; context: (B, L,
    context_dim); y: (B, adm_in_channels), the label embedding's input, used
    when the params hold ``label_emb.0.0.weight`` (ignored otherwise, as in
    the JAX UNet). Returns (B, H, W, out_channels) in ``cfg.dtype``.

    ``first_block_hook(h_prev, h_first, run_rest)``: FBCache's place.
    ``h_prev`` is input block 0's output (``conv_in``), ``h_first`` input
    block 1's (the first res block and transformer), and ``run_rest(h)``
    runs everything after them up to, not including, the ``out`` head; the
    hook returns the hidden state the head takes."""
    with profiling.span("models.unet"):
        if plan is None:
            plan = build_plan(cfg)
        input_blocks, middle, output_blocks = plan

        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(cfg.dtype)
        pt = nn.ParamView(params, "time_embed.")
        emb = nn.linear(t_emb, pt("0.weight"), pt("0.bias"))
        emb = nn.linear(nn.silu(emb), pt("2.weight"), pt("2.bias"))
        if y is not None and "label_emb.0.0.weight" in params:
            pl = nn.ParamView(params, "label_emb.0.")
            le = nn.linear(y.to(cfg.dtype), pl("0.weight"), pl("0.bias"))
            emb = emb + nn.linear(nn.silu(le), pl("2.weight"), pl("2.bias"))

        h = x.to(cfg.dtype)
        if context is not None:
            context = context.to(cfg.dtype)

        hs = []

        def run_rest(h):
            rest_hs = list(hs)
            for i, mods in enumerate(input_blocks[2:], start=2):
                h = _run_block(mods, params, h, emb, context, cfg, attn1_override,
                               block=("input", i))
                rest_hs.append(h)
            h = _run_block(middle, params, h, emb, context, cfg, attn1_override,
                           block=("middle", 0))
            for i, mods in enumerate(output_blocks):
                h = torch.cat([h, rest_hs.pop()], dim=-1)
                h = _run_block(mods, params, h, emb, context, cfg, attn1_override,
                               block=("output", i))
            return h

        for i in (0, 1):
            h_prev = h
            h = _run_block(input_blocks[i], params, h, emb, context, cfg, attn1_override,
                           block=("input", i))
            hs.append(h)
        h = run_rest(h) if first_block_hook is None else first_block_hook(h_prev, h, run_rest)

        po = nn.ParamView(params, "out.")
        h = nn.silu(nn.group_norm(h, po("0.weight"), po("0.bias")))
        return nn.conv2d(h, po("2.weight"), po("2.bias"), padding=1)


def attention_blocks(cfg: UNetConfig = SD15_CONFIG):
    """Every self-attention site of the plan as (block id, level, channels,
    transformer depth): what the kernels' launch counts derive from."""
    input_blocks, middle, output_blocks = build_plan(cfg)
    sites = []
    level = 0
    for i, mods in enumerate(input_blocks):
        for m in mods:
            if m.kind == "attn":
                sites.append((("input", i), level, m.out_ch, m.depth))
            elif m.kind == "down":
                level += 1
    sites.append((("middle", 0), level, middle[1].out_ch, middle[1].depth))
    for i, mods in enumerate(output_blocks):
        for m in mods:
            if m.kind == "attn":
                sites.append((("output", i), level, m.out_ch, m.depth))
            elif m.kind == "up":
                level -= 1
    return sites


def init_params(cfg: UNetConfig = SD15_CONFIG, seed: int = 0):
    """Random flat param dict with checkpoint keys, drawn exactly as the JAX
    package's ``init_params`` draws it (the same numpy generator calls in
    the same order, HWIO conv shapes), then laid out OIHW; the transformer
    projections linear under ``use_linear_in_transformer``, and, as there,
    no label embedding. Host numpy f32."""
    rng = np.random.default_rng(seed)
    P = {}

    def add_linear(key, out_d, in_d, bias=True):
        P[key + ".weight"] = rng.normal(0, in_d**-0.5, (out_d, in_d))
        if bias:
            P[key + ".bias"] = np.zeros((out_d,))

    def add_conv(key, out_c, in_c, k=3):
        hwio = rng.normal(0, (in_c * k * k) ** -0.5, (k, k, in_c, out_c))
        P[key + ".weight"] = hwio.transpose(3, 2, 0, 1)
        P[key + ".bias"] = np.zeros((out_c,))

    def add_norm(key, c):
        P[key + ".weight"] = np.ones((c,))
        P[key + ".bias"] = np.zeros((c,))

    def add_attn(prefix, ch, ctx):
        add_linear(prefix + "to_q", ch, ch, bias=False)
        add_linear(prefix + "to_k", ch, ctx, bias=False)
        add_linear(prefix + "to_v", ch, ctx, bias=False)
        add_linear(prefix + "to_out.0", ch, ch)

    def add_st(prefix, ch, depth):
        add_norm(prefix + "norm", ch)
        if cfg.use_linear_in_transformer:
            add_linear(prefix + "proj_in", ch, ch)
            add_linear(prefix + "proj_out", ch, ch)
        else:
            add_conv(prefix + "proj_in", ch, ch, k=1)
            add_conv(prefix + "proj_out", ch, ch, k=1)
        for d in range(depth):
            tb = f"{prefix}transformer_blocks.{d}."
            add_norm(tb + "norm1", ch)
            add_norm(tb + "norm2", ch)
            add_norm(tb + "norm3", ch)
            add_attn(tb + "attn1.", ch, ch)
            add_attn(tb + "attn2.", ch, cfg.context_dim)
            add_linear(tb + "ff.net.0.proj", ch * 8, ch)
            add_linear(tb + "ff.net.2", ch, ch * 4)

    def add_res(prefix, in_ch, out_ch):
        add_norm(prefix + "in_layers.0", in_ch)
        add_conv(prefix + "in_layers.2", out_ch, in_ch)
        add_linear(prefix + "emb_layers.1", out_ch, cfg.model_channels * 4)
        add_norm(prefix + "out_layers.0", out_ch)
        add_conv(prefix + "out_layers.3", out_ch, out_ch)
        if in_ch != out_ch:
            add_conv(prefix + "skip_connection", out_ch, in_ch, k=1)

    add_linear("time_embed.0", cfg.model_channels * 4, cfg.model_channels)
    add_linear("time_embed.2", cfg.model_channels * 4, cfg.model_channels * 4)

    input_blocks, middle, output_blocks = build_plan(cfg)
    for mods in input_blocks + [middle] + output_blocks:
        for m in mods:
            key = m.key.rstrip(".")
            if m.kind == "conv_in":
                add_conv(key, m.out_ch, m.in_ch)
            elif m.kind == "res":
                add_res(m.key, m.in_ch, m.out_ch)
            elif m.kind == "attn":
                add_st(m.key, m.out_ch, m.depth)
            elif m.kind == "down":
                add_conv(key + ".op", m.out_ch, m.in_ch)
            elif m.kind == "up":
                add_conv(key + ".conv", m.out_ch, m.in_ch)

    add_norm("out.0", cfg.model_channels)
    add_conv("out.2", cfg.out_channels, cfg.model_channels)
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in P.items()}
