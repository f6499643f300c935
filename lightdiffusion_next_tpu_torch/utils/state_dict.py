"""Checkpoint IO: safetensors and torch files, prefix surgery, the split of
a one-file SD checkpoint, and architecture detection from shapes.

Counterpart of lightdiffusion_next_tpu/utils/state_dict.py. Tensors stay in
the checkpoint's own dtype and layout (OIHW convs, which the port keeps, so
there is no ``convs_to_hwio``); the model constructors cast and place them.
``.safetensors`` files are read with the standard library (the layout: an
8-byte little-endian header length, a JSON header giving each tensor's
``dtype``, ``shape`` and ``data_offsets`` into the data that follows, and an
optional ``__metadata__`` entry), so the ``safetensors`` package is not
needed.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import torch

from lightdiffusion_next_tpu_torch.models.unet import UNetConfig

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file as a CPU tensor in its own
    dtype. The file is read once; the tensors are views of that buffer."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} has unsupported dtype {meta['dtype']}")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if end == start:
            out[key] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start, offset=start)
        if dtype.itemsize > 1 and start % dtype.itemsize:
            raw = raw.clone()  # a view needs the element size's alignment
        out[key] = raw.view(dtype).reshape(shape)
    return out


# the keys a torch file may nest its tensors under: Lightning's
# "state_dict" and RealESRGAN's "params_ema" (the published x4plus file)
NESTED_KEYS = ("state_dict", "params_ema")


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """``.safetensors`` / ``.sft`` through ``read_safetensors``; ``.ckpt`` /
    ``.pt`` / ``.pth`` through ``torch.load`` (weights only; the first of
    ``NESTED_KEYS`` that holds a dict unwrapped). CPU tensors in the file's
    dtype."""
    if path.lower().endswith((".safetensors", ".sft")):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    nested = next((k for k in NESTED_KEYS if isinstance(sd.get(k), dict)), None)
    if nested is not None:
        sd = sd[nested]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def state_dict_prefix_replace(sd: Dict, replace_prefix: Dict[str, str],
                              filter_keys: bool = False) -> Dict:
    """Rename keys by prefix; ``filter_keys`` keeps only the renamed ones."""
    out = {} if filter_keys else dict(sd)
    for rp, new in replace_prefix.items():
        for k in [k for k in sd if k.startswith(rp)]:
            if not filter_keys:
                out.pop(k, None)
            out[new + k[len(rp):]] = sd[k]
    return out


def split_checkpoint(sd: Dict) -> Tuple[Dict, Dict, Dict]:
    """One-file SD checkpoint -> (unet_sd, clip_sd, vae_sd), prefixes
    stripped; CLIP keys normalized to "text_model.*"."""
    unet, clip, vae = {}, {}, {}
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            unet[k[len("model.diffusion_model."):]] = v
        elif k.startswith("first_stage_model."):
            vae[k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model."):
            kk = k[len("cond_stage_model."):]
            if kk.startswith("transformer.") and not kk.startswith("transformer.text_model."):
                kk = "transformer.text_model." + kk[len("transformer."):]
            if kk.startswith("transformer."):
                kk = kk[len("transformer."):]
            clip[kk] = v
        elif k.startswith(("te.", "conditioner.")):
            clip[k] = v
    return unet, clip, vae


def detect_model_type(unet_sd: Dict) -> str:
    if "double_blocks.0.img_attn.norm.key_norm.scale" in unet_sd:
        return "flux"
    if "input_blocks.0.0.weight" in unet_sd:
        return "unet"
    raise ValueError("unrecognized diffusion model state dict")


def detect_unet_config(unet_sd: Dict) -> UNetConfig:
    """UNetConfig from state-dict shapes (OIHW or HWIO convs), the JAX
    package's decision data: linear transformer projections from a 2-D
    ``proj_in``, ``adm_in_channels`` from ``label_emb.0.0.weight``, and,
    as there, eight heads whatever the checkpoint (an SD2.x file would want
    ``num_head_channels = 64``, which nothing detects)."""

    def is_hwio(w) -> bool:
        return w.shape[0] == w.shape[1] and w.shape[0] <= 7

    def out_ch_of(key):
        w = unet_sd[key]
        if w.ndim != 4:
            return w.shape[0]
        return w.shape[-1] if is_hwio(w) else w.shape[0]

    def in_ch_of(key):
        w = unet_sd[key]
        if w.ndim != 4:
            return w.shape[1]
        return w.shape[-2] if is_hwio(w) else w.shape[1]

    model_channels = out_ch_of("input_blocks.0.0.weight")
    context_dim = next((unet_sd[k].shape[1] for k in unet_sd
                        if k.endswith("attn2.to_k.weight")), None)
    pk = "input_blocks.1.1.proj_in.weight"
    use_linear = pk in unet_sd and unet_sd[pk].ndim == 2

    channel_mult, num_res_blocks, transformer_depth = [], [], []
    level_blocks = level_depth = 0
    level_ch = model_channels
    i = 1
    while (f"input_blocks.{i}.0.in_layers.0.weight" in unet_sd
           or f"input_blocks.{i}.0.op.weight" in unet_sd):
        if f"input_blocks.{i}.0.op.weight" in unet_sd:
            channel_mult.append(level_ch // model_channels)
            num_res_blocks.append(level_blocks)
            transformer_depth.append(level_depth)
            level_blocks = level_depth = 0
            i += 1
            continue
        level_ch = out_ch_of(f"input_blocks.{i}.0.out_layers.3.weight")
        level_blocks += 1
        d = 0
        while f"input_blocks.{i}.1.transformer_blocks.{d}.attn1.to_q.weight" in unet_sd:
            d += 1
        level_depth = max(level_depth, d)
        i += 1
    channel_mult.append(level_ch // model_channels)
    num_res_blocks.append(level_blocks)
    transformer_depth.append(level_depth)

    dm = 0
    while f"middle_block.1.transformer_blocks.{dm}.attn1.to_q.weight" in unet_sd:
        dm += 1
    return UNetConfig(
        in_channels=in_ch_of("input_blocks.0.0.weight"),
        out_channels=out_ch_of("out.2.weight"),
        model_channels=model_channels,
        channel_mult=tuple(channel_mult),
        num_res_blocks=tuple(num_res_blocks),
        transformer_depth=tuple(transformer_depth),
        transformer_depth_middle=dm,
        context_dim=context_dim,
        num_heads=8,
        use_linear_in_transformer=use_linear,
        adm_in_channels=(in_ch_of("label_emb.0.0.weight")
                         if "label_emb.0.0.weight" in unet_sd else None),
    )
