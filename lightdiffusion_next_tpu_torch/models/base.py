"""Diffusion model packaging: net + parameterization + latent format.

Counterpart of lightdiffusion_next_tpu/models/base.py. A ``DiffusionModel``
bundles an apply function, its flat param dict (tensors on the model's
device, in the model's dtype), the model-sampling object and the latent
format. ``with_options`` returns a new bundle sharing the params.
``sd15_model`` and ``flux_model`` assemble the two model families.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.models import unet as unet_mod
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
from lightdiffusion_next_tpu_torch.sampling import model_sampling as ms_mod
from lightdiffusion_next_tpu_torch.utils import latent as latent_mod


def params_to_device(params: Dict[str, Any], dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf to ``device`` in ``dtype`` (numpy arrays or tensors), in
    the narrower of its own dtype and ``dtype`` across the bus: a leaf no
    wider than ``dtype`` (a checkpoint's f16) is moved and then cast, a
    wider one (f32 seeds) is cast and then moved."""

    def to(v):
        t = torch.as_tensor(v)
        if t.dtype.itemsize <= dtype.itemsize:
            return t.to(device=device).to(dtype=dtype)
        return t.to(device=device, dtype=dtype)

    return {k: to(v) for k, v in params.items()}


@dataclasses.dataclass
class DiffusionModel:
    apply_fn: Callable  # (params, x, t, context, attn1_override=None) -> out
    params: Dict[str, torch.Tensor]
    model_sampling: Any
    latent_format: latent_mod.LatentFormat
    config: Any = None
    model_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    model_type: str = "sd1"

    def with_options(self, **opts) -> "DiffusionModel":
        new = dict(self.model_options)
        new.update(opts)
        return dataclasses.replace(self, model_options=new)


def sd15_model(params: Dict[str, Any], cfg: Optional[unet_mod.UNetConfig] = None,
               dtype: Optional[torch.dtype] = None,
               device: _config.DeviceLike = None) -> DiffusionModel:
    """Assemble an SD1.5-class EPS UNet bundle from checkpoint-keyed params
    (numpy arrays or tensors); the attention projections are joined here,
    once (``unet.fuse_projections``). ``dtype`` defaults to the device's
    policy (bf16 on the GPU, f32 on the CPU); the UNet computes in
    ``cfg.dtype``, which follows it unless ``cfg`` is given."""
    dev = _config.resolve_device(device)
    dtype = dtype or _config.DtypePolicy.for_device(dev).param_dtype
    cfg = cfg or dataclasses.replace(unet_mod.SD15_CONFIG, dtype=dtype)
    plan = unet_mod.build_plan(cfg)

    def apply_fn(p, x, t, context, y=None, attn1_override=None):
        return unet_mod.apply_unet(p, x, t, context, cfg=cfg, plan=plan,
                                   attn1_override=attn1_override)

    return DiffusionModel(
        apply_fn=apply_fn,
        params=unet_mod.fuse_projections(params_to_device(params, dtype, dev)),
        model_sampling=ms_mod.ModelSamplingDiscrete(),
        latent_format=latent_mod.SD15,
        config=cfg,
        device=dev,
    )


def flux_model(params: Dict[str, Any], cfg: Optional[flux_mod.FluxConfig] = None,
               dtype: Optional[torch.dtype] = None,
               device: _config.DeviceLike = None) -> DiffusionModel:
    """Assemble a Flux DiT bundle from checkpoint-keyed params (numpy
    arrays, tensors or Q8_0 records, e.g. from ``ggml.gguf_sd_loader`` or
    ``flux.random_params``): Q8_0 matmul weights as ``QTensor8T``, dense
    leaves in ``dtype`` (the device's compute dtype by default), requantized
    per output column to W8A8 (``ggml.to_w8a8``) when
    ``RuntimeConfig.w8a8`` resolves on for the device (on the GPU by
    default), the RoPE basis permuted once for the fused attention (K3,
    after the requant, as the JAX loader does), the QKNorm scales in f32
    (the kernel's), the blocks stacked into the scan layout
    (``flux.stack_block_params``, consuming the flat dict) when
    ``RuntimeConfig.flux_scan`` resolves on for the device (on the GPU by
    default), ``ModelSamplingFlux``, the FLUX1 latent format and FBCache at
    threshold 0.120 in the options. That is the order of the JAX loader's
    device path: requant, permute, stack."""
    dev = _config.resolve_device(device)
    dtype = dtype or _config.DtypePolicy.for_device(dev).compute_dtype
    p = ggml.to_device_quantized(params, dtype=dtype, device=dev)
    del params  # so that to_w8a8 frees each Q8_0 leaf nothing else holds
    cfg = dataclasses.replace(cfg or flux_mod.detect_config(p), dtype=dtype,
                              fused_attn=True)
    if _config.get_config().resolve_w8a8(dev):
        p = ggml.to_w8a8(p)
    p = flux_mod.permute_rope_basis(p, cfg)
    for key in p:
        if key.endswith(("query_norm.scale", "key_norm.scale")):
            p[key] = p[key].float().contiguous()
    if _config.get_config().resolve_flux_scan(dev):
        p = flux_mod.stack_block_params(p, cfg)
    return DiffusionModel(
        apply_fn=flux_mod.make_apply_fn(cfg),
        params=p,
        model_sampling=ms_mod.ModelSamplingFlux(),
        latent_format=latent_mod.FLUX1,
        config=cfg,
        model_options={"fbcache": fb_mod.FBCacheConfig(0.120)},
        device=dev,
        model_type="flux",
    )
