"""SD VAE (AutoencoderKL) encoder and decoder, NHWC at the boundary.

Counterpart of lightdiffusion_next_tpu/models/vae.py: the same config,
checkpoint keys ("decoder.up.3.upsample.conv.weight", ...) and math, for
the SD VAE and the Flux AE (``FLUX_AE``: 16 latent channels, no quant
convs). Conv weights are OIHW. The VAE computes in f32 (the dtype policy);
the mid-block attention of the encoder and the decoder runs through K2
from 512 tokens (a 1024^2 decode: 16 384, 2048^2: 65 536; a 576^2 USDU
tile: 5184).

``VAE.decode`` decodes in sub-batches sized to the device's free memory
(``torch.cuda.mem_get_info``) at the JAX package's estimate of 160 KiB per
latent pixel; if even that runs out of memory (``torch.OutOfMemoryError``,
nothing else), it logs it and decodes in overlapping 64-pixel latent tiles
(``decode_tiled``). ``VAE.encode`` returns the latent distribution's mode,
or a sample with the noise given.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.base import params_to_device
from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.utils import tiling
from lightdiffusion_next_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    double_z: bool = True
    has_quant_conv: bool = True

    @property
    def downscale_ratio(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


SD_VAE = VAEConfig()
FLUX_AE = VAEConfig(z_channels=16, has_quant_conv=False)


def detect_vae_config(sd: dict) -> VAEConfig:
    """VAEConfig from state-dict shapes (OIHW or HWIO convs)."""

    def ch_of(key, axis_out=True):
        w = sd[key]
        hwio = w.shape[0] == w.shape[1] and w.shape[0] <= 7
        if hwio:
            return w.shape[-1] if axis_out else w.shape[-2]
        return w.shape[0] if axis_out else w.shape[1]

    ch = ch_of("encoder.conv_in.weight")
    z_channels = ch_of("decoder.conv_in.weight", axis_out=False)
    mults = []
    i = 0
    while f"encoder.down.{i}.block.0.conv1.weight" in sd:
        mults.append(ch_of(f"encoder.down.{i}.block.0.conv1.weight") // ch)
        i += 1
    nrb = 0
    while f"encoder.down.0.block.{nrb}.conv1.weight" in sd:
        nrb += 1
    return VAEConfig(ch=ch, ch_mult=tuple(mults) or (1, 2, 4, 4),
                     num_res_blocks=nrb or 2, z_channels=z_channels,
                     has_quant_conv="quant_conv.weight" in sd)


def _gn(x, scale, bias):
    """GroupNorm(32), eps 1e-6; the group count clamps to the channel count
    so tiny test configs work."""
    return nn.group_norm(x, scale, bias, groups=min(32, x.shape[-1]), eps=1e-6)


def _resnet(p: nn.ParamView, x):
    h = nn.silu(_gn(x, p("norm1.weight"), p("norm1.bias")))
    h = nn.conv2d(h, p("conv1.weight"), p("conv1.bias"), padding=1)
    h = nn.silu(_gn(h, p("norm2.weight"), p("norm2.bias")))
    h = nn.conv2d(h, p("conv2.weight"), p("conv2.bias"), padding=1)
    if p.has("nin_shortcut.weight"):
        x = nn.conv2d(x, p("nin_shortcut.weight"), p("nin_shortcut.bias"))
    return x + h


def _attn_block(p: nn.ParamView, x):
    """Mid-block single-head spatial attention; q/k/v/proj_out are 1x1
    convs."""
    h = _gn(x, p("norm.weight"), p("norm.bias"))
    q = nn.conv2d(h, p("q.weight"), p("q.bias"))
    k = nn.conv2d(h, p("k.weight"), p("k.bias"))
    v = nn.conv2d(h, p("v.weight"), p("v.bias"))
    out = attn_ops.vae_attention_core(q, k, v)
    return x + nn.conv2d(out, p("proj_out.weight"), p("proj_out.bias"))


def apply_encoder(params: dict, x, cfg: VAEConfig = SD_VAE):
    """pixels (B, H, W, 3) in [-1, 1] -> moments (B, h, w, 2 * z)."""
    p = nn.ParamView(params, "encoder.")
    h = nn.conv2d(x, p("conv_in.weight"), p("conv_in.bias"), padding=1)
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            h = _resnet(p.scope(f"down.{i}.block.{j}."), h)
        if i != len(cfg.ch_mult) - 1:
            # the asymmetric (0, 1) pad of H and W, then a stride-2 conv
            h = nn.conv2d(F.pad(h, (0, 0, 0, 1, 0, 1)), p(f"down.{i}.downsample.conv.weight"),
                          p(f"down.{i}.downsample.conv.bias"), stride=2)
    h = _resnet(p.scope("mid.block_1."), h)
    h = _attn_block(p.scope("mid.attn_1."), h)
    h = _resnet(p.scope("mid.block_2."), h)
    h = nn.silu(_gn(h, p("norm_out.weight"), p("norm_out.bias")))
    h = nn.conv2d(h, p("conv_out.weight"), p("conv_out.bias"), padding=1)
    if cfg.has_quant_conv:
        h = nn.conv2d(h, params["quant_conv.weight"], params["quant_conv.bias"])
    return h


def apply_decoder(params: dict, z, cfg: VAEConfig = SD_VAE):
    """latent (B, h, w, z) -> pixels (B, H, W, 3) in [-1, 1]."""
    if cfg.has_quant_conv:
        z = nn.conv2d(z, params["post_quant_conv.weight"], params["post_quant_conv.bias"])
    p = nn.ParamView(params, "decoder.")
    h = nn.conv2d(z, p("conv_in.weight"), p("conv_in.bias"), padding=1)
    h = _resnet(p.scope("mid.block_1."), h)
    h = _attn_block(p.scope("mid.attn_1."), h)
    h = _resnet(p.scope("mid.block_2."), h)
    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet(p.scope(f"up.{i}.block.{j}."), h)
        if i != 0:
            h = nn.conv2d(nn.interpolate_nearest(h, 2),
                          p(f"up.{i}.upsample.conv.weight"),
                          p(f"up.{i}.upsample.conv.bias"), padding=1)
    h = nn.silu(_gn(h, p("norm_out.weight"), p("norm_out.bias")))
    return nn.conv2d(h, p("conv_out.weight"), p("conv_out.bias"), padding=1)


def gaussian_sample(moments, noise=None):
    """NHWC moments (mean | logvar on the channel axis) -> the mean, or with
    ``noise`` a sample."""
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    if noise is None:
        return mean
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return mean + torch.exp(0.5 * logvar) * noise


class VAE:
    """Encode and decode facade: pixel-range scaling around the encoder and
    the decoder, the decode sub-batched and its tiled fallback."""

    # the decoder's activation peak per latent pixel (the JAX package's
    # measured constant): 64 output pixels x 128 channels x 4 bytes x the
    # live buffers
    _DECODE_BYTES_PER_LATENT_PIXEL = 160 * 1024

    def __init__(self, params: dict, cfg: VAEConfig = SD_VAE,
                 dtype: Optional[torch.dtype] = None,
                 device: _config.DeviceLike = None):
        self.device = _config.resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype or _config.DtypePolicy.for_device(self.device).vae_dtype
        self.params = params_to_device(params, self.dtype, self.device)

    def _max_decode_batch(self, shape) -> int:
        """The most images of ``shape``'s size one decode call fits in 80% of
        the device's free memory (8 GiB assumed on the CPU)."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 8 << 30
        per_image = shape[1] * shape[2] * self._DECODE_BYTES_PER_LATENT_PIXEL
        return max(1, int(free * 0.8) // max(per_image, 1))

    def _decode_scaled(self, z):
        out = apply_decoder(self.params, z.to(self.dtype), self.cfg)
        return torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0)

    def decode(self, samples):
        """latent NHWC -> images NHWC float32 in [0, 1], on the VAE's device."""
        with profiling.span("models.vae"):
            z = torch.as_tensor(samples).to(device=self.device, dtype=self.dtype)
            b = z.shape[0]
            step = min(self._max_decode_batch(z.shape), b)
            try:
                outs = [self._decode_scaled(z[i:i + step]) for i in range(0, b, step)]
                return outs[0] if len(outs) == 1 else torch.cat(outs)
            except torch.OutOfMemoryError:
                # handled below, once this frame's partial results are freed
                pass
            logger.warning("VAE decode of %s ran out of device memory; decoding in tiles",
                           tuple(z.shape))
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            return self.decode_tiled(z)

    def decode_tiled(self, samples, tile: int = 64, overlap: int = 16):
        """The decode in overlapping ``tile`` x ``tile`` latent tiles, blended
        by feathered weights (``utils.tiling``)."""
        z = torch.as_tensor(samples).to(device=self.device, dtype=self.dtype)
        return tiling.tiled_apply_2d(self._decode_scaled, z, tile=tile, overlap=overlap,
                                     upscale=self.cfg.downscale_ratio,
                                     out_channels=self.cfg.out_ch)

    def encode(self, pixels, noise=None):
        """images NHWC in [0, 1] -> latent NHWC f32 on the VAE's device: the
        mode, or a sample with ``noise``."""
        x = torch.as_tensor(pixels).to(device=self.device, dtype=self.dtype) * 2.0 - 1.0
        moments = apply_encoder(self.params, x, self.cfg).float()
        if noise is not None:
            noise = torch.as_tensor(noise).to(device=self.device, dtype=torch.float32)
        return gaussian_sample(moments, noise)


def init_params(cfg: VAEConfig = SD_VAE, seed: int = 0):
    """Random flat param dict drawn exactly as the JAX package's
    ``init_params`` draws it, convs laid out OIHW. Host numpy f32."""
    rng = np.random.default_rng(seed)
    P = {}

    def conv(key, out_c, in_c, k=3):
        hwio = rng.normal(0, (in_c * k * k) ** -0.5, (k, k, in_c, out_c))
        P[key + ".weight"] = hwio.transpose(3, 2, 0, 1)
        P[key + ".bias"] = np.zeros((out_c,))

    def norm(key, c):
        P[key + ".weight"] = np.ones((c,))
        P[key + ".bias"] = np.zeros((c,))

    def res(prefix, cin, cout):
        norm(prefix + "norm1", cin)
        conv(prefix + "conv1", cout, cin)
        norm(prefix + "norm2", cout)
        conv(prefix + "conv2", cout, cout)
        if cin != cout:
            conv(prefix + "nin_shortcut", cout, cin, k=1)

    def attn(prefix, c):
        norm(prefix + "norm", c)
        for nme in ("q", "k", "v", "proj_out"):
            conv(prefix + nme, c, c, k=1)

    conv("encoder.conv_in", cfg.ch, cfg.in_channels)
    ch = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}.", ch, out)
            ch = out
        if i != len(cfg.ch_mult) - 1:
            conv(f"encoder.down.{i}.downsample.conv", ch, ch)
    res("encoder.mid.block_1.", ch, ch)
    attn("encoder.mid.attn_1.", ch)
    res("encoder.mid.block_2.", ch, ch)
    norm("encoder.norm_out", ch)
    zc = cfg.z_channels * (2 if cfg.double_z else 1)
    conv("encoder.conv_out", zc, ch)
    if cfg.has_quant_conv:
        conv("quant_conv", zc, zc, k=1)
        conv("post_quant_conv", cfg.z_channels, cfg.z_channels, k=1)

    conv("decoder.conv_in", ch, cfg.z_channels)
    res("decoder.mid.block_1.", ch, ch)
    attn("decoder.mid.attn_1.", ch)
    res("decoder.mid.block_2.", ch, ch)
    for i in reversed(range(len(cfg.ch_mult))):
        out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}.", ch, out)
            ch = out
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", ch, ch)
    norm("decoder.norm_out", ch)
    conv("decoder.conv_out", cfg.out_ch, ch)
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in P.items()}
