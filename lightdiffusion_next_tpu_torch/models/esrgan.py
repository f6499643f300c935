"""RRDBNet (ESRGAN / RealESRGAN x4), the image upscaler of img2img.

Counterpart of lightdiffusion_next_tpu/models/esrgan.py: the RealESRGAN
keys (conv_first, body.N.rdb{1,2,3}.conv{1-5}, conv_body, conv_up1/2,
conv_hr, conv_last), the old ESRGAN keys ("model.0",
"model.1.sub.N.RDBk.convj.0", ...) mapped onto them at load, and the tiled
``UpscaleModel`` (128-pixel tiles, 8 of overlap, ``utils.tiling``). NHWC
activations, OIHW conv weights. The network computes in f32, as in the JAX
package; on the GPU TF32 is off for its convolutions
(``config.configure_cuda_math``). The convolutions are PyTorch's, as XLA's
are the JAX package's: no Pallas kernel is on this path.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.base import params_to_device
from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.utils import tiling


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _rdb(p: nn.ParamView, x):
    """Residual dense block: five convs over the running concatenation, the
    residual scaled by 0.2."""
    feats = [x]
    for i in range(1, 5):
        feats.append(_lrelu(nn.conv2d(torch.cat(feats, -1), p(f"conv{i}.weight"),
                                      p(f"conv{i}.bias"), padding=1)))
    x5 = nn.conv2d(torch.cat(feats, -1), p("conv5.weight"), p("conv5.bias"), padding=1)
    return x5 * 0.2 + x


def _rrdb(p: nn.ParamView, x):
    out = _rdb(p.scope("rdb1."), x)
    out = _rdb(p.scope("rdb2."), out)
    out = _rdb(p.scope("rdb3."), out)
    return out * 0.2 + x


def num_blocks(params: Dict) -> int:
    n = 0
    while f"body.{n}.rdb1.conv1.weight" in params:
        n += 1
    return n


def apply_rrdbnet(params: Dict, x, scale: int = 4):
    """x: (B, H, W, 3) in [0, 1] -> (B, scale*H, scale*W, 3)."""
    fea = nn.conv2d(x, params["conv_first.weight"], params["conv_first.bias"], padding=1)
    trunk = fea
    for i in range(num_blocks(params)):
        trunk = _rrdb(nn.ParamView(params, f"body.{i}."), trunk)
    trunk = nn.conv2d(trunk, params["conv_body.weight"], params["conv_body.bias"], padding=1)
    fea = fea + trunk
    for level, name in ((2, "conv_up1"), (4, "conv_up2")):
        if scale >= level:
            fea = _lrelu(nn.conv2d(nn.interpolate_nearest(fea, 2), params[f"{name}.weight"],
                                   params[f"{name}.bias"], padding=1))
    fea = _lrelu(nn.conv2d(fea, params["conv_hr.weight"], params["conv_hr.bias"], padding=1))
    return nn.conv2d(fea, params["conv_last.weight"], params["conv_last.bias"], padding=1)


_OLD_ARCH_MAP = [
    (re.compile(r"^model\.0\.(weight|bias)$"), r"conv_first.\1"),
    (re.compile(r"^model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d)\.0\.(weight|bias)$"),
     r"body.\1.rdb\2.conv\3.\4"),
    (re.compile(r"^model\.3\.(weight|bias)$"), r"conv_up1.\1"),
    (re.compile(r"^model\.6\.(weight|bias)$"), r"conv_up2.\1"),
    (re.compile(r"^model\.8\.(weight|bias)$"), r"conv_hr.\1"),
    (re.compile(r"^model\.10\.(weight|bias)$"), r"conv_last.\1"),
]

_OLD_TRUNK = re.compile(r"^model\.1\.sub\.(\d+)\.(weight|bias)$")


def normalize_esrgan_keys(sd: Dict) -> Dict:
    """Old ESRGAN keys -> RealESRGAN's. The trunk conv is the highest
    ``model.1.sub.N`` without an RDB segment (N is the block count: 23 for
    x4plus, other models have 16 or 6)."""
    if "conv_first.weight" in sd:
        return dict(sd)
    trunk_idx = max((int(m.group(1)) for m in map(_OLD_TRUNK.match, sd) if m), default=None)
    out = {}
    for k, v in sd.items():
        m = _OLD_TRUNK.match(k)
        if m and int(m.group(1)) == trunk_idx:
            out[f"conv_body.{m.group(2)}"] = v
            continue
        for pat, repl in _OLD_ARCH_MAP:
            if pat.match(k):
                out[pat.sub(repl, k)] = v
                break
        else:
            out[k] = v
    return out


class UpscaleModel:
    """ESRGAN on its device in f32, applied in 128-pixel tiles with
    feathered blending."""

    def __init__(self, params: Dict, scale: int = 4, device: _config.DeviceLike = None):
        self.device = _config.resolve_device(device)
        self.scale = scale
        self.params = params_to_device(normalize_esrgan_keys(params), torch.float32,
                                       self.device)

    def upscale(self, image, tile: int = 128, overlap: int = 8) -> torch.Tensor:
        """image: (B, H, W, 3) in [0, 1] (tensor or numpy) -> (B, sH, sW, 3)
        f32 on the model's device, clipped to [0, 1]."""
        x = torch.as_tensor(image).to(device=self.device, dtype=torch.float32)
        with torch.no_grad():
            out = tiling.tiled_apply_2d(lambda t: apply_rrdbnet(self.params, t, self.scale),
                                        x, tile=tile, overlap=overlap, upscale=self.scale,
                                        out_channels=3)
        return torch.clamp(out, 0.0, 1.0)


def init_params(num_body: int = 2, nf: int = 64, gc: int = 32, seed: int = 0):
    """Random params drawn exactly as the JAX package's ``init_params``
    draws them, convs laid out OIHW. Host numpy f32."""
    rng = np.random.default_rng(seed)
    P = {}

    def conv(key, cin, cout):
        hwio = rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
        P[key + ".weight"] = np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))
        P[key + ".bias"] = np.zeros((cout,), np.float32)

    conv("conv_first", 3, nf)
    for i in range(num_body):
        for r in (1, 2, 3):
            for c in range(1, 6):
                conv(f"body.{i}.rdb{r}.conv{c}", nf + gc * (c - 1), gc if c < 5 else nf)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf)
    conv("conv_last", nf, 3)
    return P
