"""LoRA: key maps and the weight merge over flat param dicts, SD1.5.

Counterpart of lightdiffusion_next_tpu/models/lora.py (``unet_key_map``,
``clip_key_map``, ``load_lora``, ``_lora_delta``, ``apply_lora``,
``load_and_apply_lora``): W' = dtype(f32(W) + strength * (alpha / rank) *
up @ down), computed on the weight's device, into new tensors (the params
given are not changed, so a cached model stays as it was loaded).

The port's UNet params hold each self-attention's q|k|v weights joined
as ``attn1.to_qkv.weight`` and each cross-attention's k|v as
``attn2.to_kv.weight`` (``unet.fuse_projections``). ``unet_key_map`` maps
the LoRA names of the parts (``..._attn1_to_q``) to their rows of the
joined weight, so a patch lands on the same values either way: merging
into the joined weight equals merging into the parts and joining them.

Not ported yet (ROADMAP Queue 1, item 8): LoRA on Flux's quantized
weights (the JAX package's ``QTensorLoRA``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple, Union

import torch

logger = logging.getLogger(__name__)

LORA_CLIP_MAP = {
    "mlp.fc1": "mlp_fc1",
    "mlp.fc2": "mlp_fc2",
    "self_attn.k_proj": "self_attn_k_proj",
    "self_attn.q_proj": "self_attn_q_proj",
    "self_attn.v_proj": "self_attn_v_proj",
    "self_attn.out_proj": "self_attn_out_proj",
}

# joined weight -> its parts, in row order (unet.fuse_projections)
FUSED_PARTS = {"attn1.to_qkv.weight": ("to_q", "to_k", "to_v"),
               "attn2.to_kv.weight": ("to_k", "to_v")}

# a param key, or (joined key, first row, end row) for a part of a joined
# weight
Target = Union[str, Tuple[str, int, int]]


def unet_key_map(unet_params: Dict) -> Dict[str, Target]:
    """lora_unet_<checkpoint key with underscores> (and lora_prior_unet_)
    -> its target in ``unet_params``, joined or not."""
    key_map: Dict[str, Target] = {}

    def add(ckpt_key, target):
        name = ckpt_key[: -len(".weight")].replace(".", "_")
        key_map[f"lora_unet_{name}"] = target
        key_map[f"lora_prior_unet_{name}"] = target

    for k, w in unet_params.items():
        if not k.endswith(".weight"):
            continue
        fused = next((f for f in FUSED_PARTS if k.endswith(f)), None)
        if fused is None:
            add(k, k)
            continue
        parts = FUSED_PARTS[fused]
        pre = k[: -len(fused.split(".", 1)[1])]
        rows = w.shape[0] // len(parts)
        for i, part in enumerate(parts):
            add(f"{pre}{part}.weight", (k, i * rows, (i + 1) * rows))
    return key_map


def clip_key_map(clip_params: Dict) -> Dict[str, str]:
    """lora_te_* / lora_te1_* / diffusers text_encoder.* -> the CLIP key."""
    key_map = {}
    for b in range(32):
        for c, lname in LORA_CLIP_MAP.items():
            k = f"text_model.encoder.layers.{b}.{c}.weight"
            if k in clip_params:
                key_map[f"lora_te_text_model_encoder_layers_{b}_{lname}"] = k
                key_map[f"lora_te1_text_model_encoder_layers_{b}_{lname}"] = k
                key_map[f"text_encoder.text_model.encoder.layers.{b}.{c}"] = k
    return key_map


def load_lora(lora_sd: Dict, key_map: Dict[str, Target]) -> Tuple[Dict[Target, Tuple], List]:
    """LoRA state dict -> ({target: (up f32, down f32, alpha)}, the LoRA
    keys left unmatched)."""
    patches = {}
    loaded = set()
    for lora_key, target in key_map.items():
        a_name = f"{lora_key}.lora_up.weight"
        if a_name not in lora_sd:
            continue
        b_name = f"{lora_key}.lora_down.weight"
        alpha_name = f"{lora_key}.alpha"
        alpha = None
        if alpha_name in lora_sd:
            alpha = float(torch.as_tensor(lora_sd[alpha_name]).float())
            loaded.add(alpha_name)
        patches[target] = (torch.as_tensor(lora_sd[a_name]).float(),
                           torch.as_tensor(lora_sd[b_name]).float(), alpha)
        loaded.update((a_name, b_name))
    return patches, [k for k in lora_sd if k not in loaded]


def _lora_delta(up: torch.Tensor, down: torch.Tensor, alpha: Optional[float]):
    """The strength-free delta, (out, in) or OIHW, f32."""
    rank = down.shape[0]
    scale = 1.0 if alpha is None else alpha / rank
    mat = up.reshape(up.shape[0], -1) @ down.reshape(rank, -1)
    return scale * mat.reshape((up.shape[0],) + tuple(down.shape[1:]))


def apply_lora(params: Dict, patches: Dict[Target, Tuple], strength: float = 1.0) -> Dict:
    """A new param dict with the patches merged at ``strength``; patched
    weights are new tensors, the others are shared. Targets missing from
    ``params`` are skipped."""
    out = dict(params)
    copied = set()
    for target, (up, down, alpha) in patches.items():
        key, rows = (target, None) if isinstance(target, str) else (target[0], target[1:])
        if key not in out:
            continue
        w = out[key]
        delta = _lora_delta(up.to(w.device), down.to(w.device), alpha) * strength
        if rows is None:
            out[key] = (w.float() + delta).to(w.dtype)
            continue
        if key not in copied:
            out[key] = w = w.clone()
            copied.add(key)
        w[rows[0]:rows[1]] = (w[rows[0]:rows[1]].float() + delta).to(w.dtype)
    return out


def lora_modules(lora_sd: Dict) -> List[str]:
    """The module names of a LoRA file (one per lora_up weight)."""
    return [k[: -len(".lora_up.weight")] for k in lora_sd if k.endswith(".lora_up.weight")]


def load_and_apply_lora(lora_sd: Dict, unet_params: Dict, clip_params: Optional[Dict],
                        strength_model: float, strength_clip: float):
    """New (unet_params, clip_params) with the LoRA merged; logs how many of
    the file's modules each model took."""
    new_unet, new_clip = unet_params, clip_params
    n_unet = n_clip = 0
    if strength_model != 0:
        patches, _ = load_lora(lora_sd, unet_key_map(unet_params))
        new_unet = apply_lora(unet_params, patches, strength_model)
        n_unet = len(patches)
    if clip_params is not None and strength_clip != 0:
        patches, _ = load_lora(lora_sd, clip_key_map(clip_params))
        new_clip = apply_lora(clip_params, patches, strength_clip)
        n_clip = len(patches)
    logger.info("LoRA: %d UNet and %d CLIP modules patched of the file's %d",
                n_unet, n_clip, len(lora_modules(lora_sd)))
    return new_unet, new_clip
