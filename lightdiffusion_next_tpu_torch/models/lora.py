"""LoRA: key maps and the weight merge over flat param dicts, SD1.5 and
Flux.

Counterpart of lightdiffusion_next_tpu/models/lora.py (``unet_key_map``,
``clip_key_map``, ``load_lora``, ``_lora_delta``, ``apply_lora``,
``load_and_apply_lora``): W' = dtype(f32(W) + strength * (alpha / rank) *
up @ down), computed on the weight's device, into new tensors (the params
given are not changed, so a cached model stays as it was loaded).

Flux's quantized matmul weights (``QTensor8T``, ``QTensor8W``) are not
merged: each patched one becomes a ``ggml.QTensorLoRA`` that applies the
low-rank product at compute time, so the weight stays int8 and keeps its
kernel; a second LoRA on the same weight concatenates its rank onto the
first's. Stacked (scan layout) params raise, as in the JAX package. So do
params built for the fused attention (``model_cfg.fused_attn``) when a
patch targets a ``qkv`` or ``linear1`` weight: their q/k rows are in the
permuted RoPE basis and the patch's are not. The JAX package applies such
a patch in the wrong basis without an error; the port refuses it, and
refuses Flux DiT params given without their ``model_cfg``, which alone
tells the two bases apart. With ``model_cfg.tp_layout`` the patches move to
the TP layout's keys first (``parallel.layout.to_tp_layout_patches``), and
with ``model_cfg.tp_axis`` (the params are this rank's shards) each patch
is cut as its base is: ``up``'s rows with a column-parallel weight,
``down``'s columns with a row-parallel one (``parallel.sharding``).

The port's UNet params hold each self-attention's q|k|v weights joined
as ``attn1.to_qkv.weight`` and each cross-attention's k|v as
``attn2.to_kv.weight`` (``unet.fuse_projections``). ``unet_key_map`` maps
the LoRA names of the parts (``..._attn1_to_q``) to their rows of the
joined weight, so a patch lands on the same values either way: merging
into the joined weight equals merging into the parts and joining them.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple, Union

import torch

from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.ops import ggml

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


# the Flux projections whose q/k rows the fused attention permutes
PERMUTED_SUFFIXES = ("qkv.weight", "linear1.weight")
_LORA_BASES = (ggml.QTensor8T, ggml.QTensor8W, ggml.QTensorLoRA)


def _device(w):
    """The device of a tensor, a Q8_0 or W8A8 record or a ``QTensorLoRA``."""
    w = w.base if isinstance(w, ggml.QTensorLoRA) else w
    if isinstance(w, ggml.QTensor8T):
        return w.qt.device
    return w.q.device if ggml.is_quantized(w) else w.device


def apply_lora(params: Dict, patches: Dict[Target, Tuple], strength: float = 1.0,
               model_cfg=None) -> Dict:
    """A new param dict with the patches applied at ``strength``; patched
    weights are new tensors or records, the others are shared. Targets
    missing from ``params`` are skipped. A 2-D quantized target becomes a
    ``ggml.QTensorLoRA`` (up scaled by strength * alpha / rank, f32);
    other targets merge. ``model_cfg`` is the model's config: a Flux
    ``FluxConfig`` with ``fused_attn`` refuses patches on ``qkv`` and
    ``linear1`` weights. Raises ValueError on stacked Flux params, and on
    Flux DiT params given without ``model_cfg``."""
    if flux_mod.is_stacked(params):
        raise ValueError("cannot apply LoRA to a scan-mode (stacked) Flux model: load "
                         "with flux_scan disabled, or apply the LoRA before stacking")
    if model_cfg is None and any(k.startswith(("double_blocks.", "single_blocks."))
                                 and k.endswith(PERMUTED_SUFFIXES) for k in params):
        raise ValueError("LoRA on a Flux DiT needs its model_cfg: whether fused_attn "
                         "permuted the q/k rows decides whether the patch may apply")
    if getattr(model_cfg, "tp_layout", False):
        patches = _tp_patches(patches, model_cfg)
    if getattr(model_cfg, "fused_attn", False):
        permuted = sorted(t for t in patches if isinstance(t, str) and t in params
                          and t.endswith(PERMUTED_SUFFIXES))
        if permuted:
            raise ValueError(
                f"LoRA patches {permuted[:2]}... target q/k rows that fused_attn permuted "
                "into its RoPE basis; load the model with fused_attn off "
                "(RuntimeConfig(fused_attn=False), --no-fused-attn)")
    out = dict(params)
    copied = set()
    for target, (up, down, alpha) in patches.items():
        key, rows = (target, None) if isinstance(target, str) else (target[0], target[1:])
        if key not in out:
            continue
        w = out[key]
        dev = _device(w)
        if isinstance(w, _LORA_BASES) and len(w.shape) == 2 and up.dim() == 2 \
                and down.dim() == 2:
            scale = strength * (1.0 if alpha is None else alpha / down.shape[0])
            new_up, new_down = up.to(dev).float() * scale, down.to(dev).float()
            if isinstance(w, ggml.QTensorLoRA):
                out[key] = ggml.QTensorLoRA(w.base, torch.cat([w.up, new_up], dim=1),
                                            torch.cat([w.down, new_down], dim=0))
            else:
                out[key] = ggml.QTensorLoRA(w, new_up, new_down)
            continue
        delta = _lora_delta(up.to(dev), down.to(dev), alpha) * strength
        if ggml.is_quantized(w):  # no 2-D matmul layout: densify, as in JAX
            out[key] = (w.dequantize(torch.float32) + delta).to(torch.bfloat16)
            continue
        if rows is None:
            out[key] = (w.float() + delta).to(w.dtype)
            continue
        if key not in copied:
            out[key] = w = w.clone()
            copied.add(key)
        w[rows[0]:rows[1]] = (w[rows[0]:rows[1]].float() + delta).to(w.dtype)
    return out


def _tp_patches(patches: Dict, cfg) -> Dict:
    """Flux patches in the TP layout's keys and, under ``cfg.tp_axis``,
    cut to this rank's slice of their base."""
    from lightdiffusion_next_tpu_torch.parallel import layout, sharding

    patches = layout.to_tp_layout_patches(patches, cfg)
    if cfg.tp_axis is None:
        return patches
    import torch.distributed as dist

    return sharding.shard_patches(patches, dist.get_rank(cfg.tp_axis),
                                  dist.get_world_size(cfg.tp_axis))


def lora_modules(lora_sd: Dict) -> List[str]:
    """The module names of a LoRA file (one per lora_up weight)."""
    return [k[: -len(".lora_up.weight")] for k in lora_sd if k.endswith(".lora_up.weight")]


def load_and_apply_lora(lora_sd: Dict, unet_params: Dict, clip_params: Optional[Dict],
                        strength_model: float, strength_clip: float, model_cfg=None):
    """New (unet_params, clip_params) with the LoRA applied; logs how many
    of the file's modules each model took. ``model_cfg``: the diffusion
    model's config (see ``apply_lora``)."""
    new_unet, new_clip = unet_params, clip_params
    n_unet = n_clip = 0
    if strength_model != 0:
        patches, _ = load_lora(lora_sd, unet_key_map(unet_params))
        new_unet = apply_lora(unet_params, patches, strength_model, model_cfg)
        n_unet = len(patches)
    if clip_params is not None and strength_clip != 0:
        patches, _ = load_lora(lora_sd, clip_key_map(clip_params))
        new_clip = apply_lora(clip_params, patches, strength_clip)
        n_clip = len(patches)
    logger.info("LoRA: %d UNet and %d CLIP modules patched of the file's %d",
                n_unet, n_clip, len(lora_modules(lora_sd)))
    return new_unet, new_clip
