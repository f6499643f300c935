"""TAESD, the tiny autoencoder: the latent preview's decoder and a fast
encoder.

Counterpart of lightdiffusion_next_tpu/models/taesd.py: the same
sequential layouts (index -> kind) and flat param keys
("decoder.1.weight", "decoder.3.conv.0.weight", ...), ``decode``,
``encode``, ``normalize_decoder_params`` (the three checkpoint layouts in
circulation), ``decode_preview`` and the seeded ``init_params``. Conv
weights are OIHW, activations NHWC at the functions' edges (``ops.nn``
hands cuDNN channels-last views), f32 as in the JAX package. A torch file
read from disk is already OIHW.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import nn

LATENT_MAGNITUDE = 3.0
LATENT_SHIFT = 0.5

_ENCODER_LAYOUT = [
    ("conv", 3, 64), ("block", 64, 64), ("sconv", 64, 64), ("block", 64, 64),
    ("block", 64, 64), ("block", 64, 64), ("sconv", 64, 64), ("block", 64, 64),
    ("block", 64, 64), ("block", 64, 64), ("sconv", 64, 64), ("block", 64, 64),
    ("block", 64, 64), ("block", 64, 64), ("conv", 64, 4),
]
_DECODER_LAYOUT = [
    ("clamp",), ("conv", 4, 64), ("relu",), ("block", 64, 64), ("block", 64, 64),
    ("block", 64, 64), ("up",), ("conv_nb", 64, 64), ("block", 64, 64),
    ("block", 64, 64), ("block", 64, 64), ("up",), ("conv_nb", 64, 64),
    ("block", 64, 64), ("block", 64, 64), ("block", 64, 64), ("up",),
    ("conv_nb", 64, 64), ("block", 64, 64), ("conv", 64, 3),
]


def _block(p: nn.ParamView, x):
    h = torch.relu(nn.conv2d(x, p("conv.0.weight"), p("conv.0.bias"), padding=1))
    h = torch.relu(nn.conv2d(h, p("conv.2.weight"), p("conv.2.bias"), padding=1))
    h = nn.conv2d(h, p("conv.4.weight"), p("conv.4.bias"), padding=1)
    if p.has("skip.weight"):
        x = nn.conv2d(x, p("skip.weight"))
    return torch.relu(h + x)


def _run_sequential(params: Dict, prefix: str, layout, x):
    for i, spec in enumerate(layout):
        kind = spec[0]
        p = nn.ParamView(params, f"{prefix}{i}.")
        if kind == "clamp":
            x = torch.tanh(x / 3.0) * 3.0
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "up":
            x = nn.interpolate_nearest(x, 2)
        elif kind == "conv":
            x = nn.conv2d(x, p("weight"), p("bias"), padding=1)
        elif kind == "conv_nb":
            x = nn.conv2d(x, p("weight"), padding=1)
        elif kind == "sconv":
            x = nn.conv2d(x, p("weight"), stride=2, padding=1)
        elif kind == "block":
            x = _block(p, x)
    return x


def _on(params: Dict, like: torch.Tensor) -> Dict:
    """The params as f32 tensors on ``like``'s device (no copy when they
    are already)."""
    return {k: torch.as_tensor(v).to(device=like.device, dtype=torch.float32)
            for k, v in params.items()}


@torch.no_grad()
def decode(params: Dict, latent, vae_scale: float = 1.0, vae_shift: float = 0.0):
    """latent NHWC -> image NHWC in [-1, 1]; keys under "decoder."."""
    latent = torch.as_tensor(latent).float()
    x = (latent - vae_shift) * vae_scale
    return _run_sequential(_on(params, x), "decoder.", _DECODER_LAYOUT, x)


@torch.no_grad()
def encode(params: Dict, image, vae_scale: float = 1.0, vae_shift: float = 0.0):
    """image NHWC in [-1, 1] -> latent NHWC; keys under "encoder."."""
    x = torch.as_tensor(image).float() * 0.5 + 0.5
    lat = _run_sequential(_on(params, x), "encoder.", _ENCODER_LAYOUT, x)
    return lat / vae_scale + vae_shift


def scale_latents(x):
    return torch.clamp(x / (2 * LATENT_MAGNITUDE) + LATENT_SHIFT, 0, 1)


def unscale_latents(x):
    return (x - LATENT_SHIFT) * (2 * LATENT_MAGNITUDE)


def normalize_decoder_params(sd: Dict) -> Optional[Dict]:
    """A TAESD decoder checkpoint in any of the layouts in circulation, as a
    dict under this module's "decoder.N.*" keys, or None when the layout is
    not one of them (callers then preview through the linear RGB map):

    - "decoder.N.*": this module's, the taesd repo's with its prefix;
    - bare "N.*": taesd_decoder.safetensors, a decoder-only dump;
    - "decoder.layers.N.*": diffusers' AutoencoderTiny (taef1), whose
      decoder has no clamp layer (its forward applies the tanh), so its
      indices are one less than this layout's.

    A dict without every conv of ``_DECODER_LAYOUT`` is refused here."""
    keys = list(sd)
    if any(k.startswith("decoder.layers.") for k in keys):
        out = {}
        for k, v in sd.items():
            if not k.startswith("decoder.layers."):
                continue
            idx, _, tail = k[len("decoder.layers."):].partition(".")
            if not idx.isdigit():
                return None
            out[f"decoder.{int(idx) + 1}.{tail}"] = v
        sd = out
    elif not any(k.startswith("decoder.") for k in keys):
        if keys and all(k.split(".")[0].isdigit() for k in keys):
            sd = {f"decoder.{k}": v for k, v in sd.items()}
        else:
            return None
    else:
        sd = {k: v for k, v in sd.items() if k.startswith("decoder.")}
    required = [f"decoder.{i}.weight" for i, spec in enumerate(_DECODER_LAYOUT)
                if spec[0] in ("conv", "conv_nb")]
    if not all(k in sd for k in required):
        return None
    return sd


def decode_preview(params: Dict, latent) -> np.ndarray:
    """latent -> RGB in [0, 1], host f32 numpy NHWC."""
    img = decode(params, latent)
    return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()


def init_params(seed: int = 0, latent_channels: int = 4) -> Dict:
    """Random encoder and decoder params drawn exactly as the JAX package's
    ``init_params`` draws them, convs OIHW: host numpy f32."""
    rng = np.random.default_rng(seed)
    P = {}

    def conv(key, cin, cout, bias=True, k=3):
        w = rng.normal(0, (cin * k * k) ** -0.5, (k, k, cin, cout)).astype(np.float32)
        P[key + ".weight"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        if bias:
            P[key + ".bias"] = np.zeros((cout,), np.float32)

    def emit(prefix, layout):
        for i, spec in enumerate(layout):
            kind, key = spec[0], f"{prefix}{i}"
            if kind in ("conv", "sconv", "conv_nb"):
                conv(key, spec[1], spec[2], bias=(kind == "conv"))
            elif kind == "block":
                cin, cout = spec[1], spec[2]
                conv(key + ".conv.0", cin, cout)
                conv(key + ".conv.2", cout, cout)
                conv(key + ".conv.4", cout, cout)
                if cin != cout:
                    conv(key + ".skip", cin, cout, bias=False, k=1)

    layout_enc = list(_ENCODER_LAYOUT)
    layout_enc[-1] = ("conv", 64, latent_channels)
    layout_dec = list(_DECODER_LAYOUT)
    layout_dec[1] = ("conv", latent_channels, 64)
    emit("encoder.", layout_enc)
    emit("decoder.", layout_dec)
    return P
