"""Diffusion model packaging: net + parameterization + latent format.

Counterpart of lightdiffusion_next_tpu/models/base.py. A ``DiffusionModel``
bundles an apply function, its flat param dict (tensors on the model's
device, in the model's dtype), the model-sampling object and the latent
format. ``with_options`` returns a new bundle sharing the params.
``sd15_model`` and ``flux_model`` assemble the two model families.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.models import unet as unet_mod
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
from lightdiffusion_next_tpu_torch.sampling import model_sampling as ms_mod
from lightdiffusion_next_tpu_torch.utils import latent as latent_mod

logger = logging.getLogger(__name__)


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
    """Assemble an SD1.5-class EPS UNet bundle (any ``UNetConfig``: the
    label embedding reads the pooled vector the CFG denoiser passes as
    ``y``) from checkpoint-keyed params
    (numpy arrays or tensors); the attention projections are joined here,
    once (``unet.fuse_projections``), unless ``RuntimeConfig.qkv_fuse`` is
    off. ``dtype`` defaults to the device's policy (bf16 on the GPU, f32 on
    the CPU); the UNet computes in ``cfg.dtype``, which follows it unless
    ``cfg`` is given."""
    dev = _config.resolve_device(device)
    dtype = dtype or _config.DtypePolicy.for_device(dev).param_dtype
    cfg = cfg or dataclasses.replace(unet_mod.SD15_CONFIG, dtype=dtype)
    plan = unet_mod.build_plan(cfg)

    def apply_fn(p, x, t, context, y=None, attn1_override=None, first_block_hook=None):
        return unet_mod.apply_unet(p, x, t, context, y=y, cfg=cfg, plan=plan,
                                   attn1_override=attn1_override,
                                   first_block_hook=first_block_hook)

    params = params_to_device(params, dtype, dev)
    if _config.get_config().resolve_qkv_fuse():
        params = unet_mod.fuse_projections(params)
    return DiffusionModel(
        apply_fn=apply_fn,
        params=params,
        model_sampling=ms_mod.ModelSamplingDiscrete(),
        latent_format=latent_mod.SD15,
        config=cfg,
        device=dev,
    )


def fused_attn_for(cfg: flux_mod.FluxConfig, device: _config.DeviceLike) -> bool:
    """Whether a Flux DiT of ``cfg`` built on ``device`` takes the fused
    attention: ``RuntimeConfig.fused_attn`` resolved for the device, and a
    head dim of 128 (K3's), as in the JAX loader, which warns and keeps the
    unfused path otherwise."""
    if not _config.get_config().resolve_fused_attn(device):
        return False
    if cfg.head_dim != 128:
        logger.warning("fused_attn kernel is 128-lane head_dim only (got %d); "
                       "keeping the unfused attention path", cfg.head_dim)
        return False
    return True


def flux_model(params: Dict[str, Any], cfg: Optional[flux_mod.FluxConfig] = None,
               dtype: Optional[torch.dtype] = None,
               device: _config.DeviceLike = None, w8a8: Optional[bool] = None,
               scan: Optional[bool] = None) -> DiffusionModel:
    """Assemble a Flux DiT bundle from checkpoint-keyed params (numpy
    arrays, tensors or Q8_0 records, e.g. from ``ggml.gguf_sd_loader`` or
    ``flux.random_params``), in the order of the JAX loader's device path:
    Q8_0 matmul weights as ``QTensor8T``, dense leaves in ``dtype`` (the
    device's compute dtype by default); requantized per output column to
    W8A8 (``ggml.to_w8a8``) when ``w8a8`` (default: ``RuntimeConfig.w8a8``
    resolved for the device, on for the GPU); the RoPE basis permuted for
    the fused attention (K3) when ``fused_attn_for`` says so, which sets
    ``cfg.fused_attn``; the QKNorm scales in f32; the blocks stacked into
    the scan layout (``flux.stack_block_params``, consuming the flat dict)
    when ``scan`` (default: ``RuntimeConfig.flux_scan`` resolved for the
    device). Params that cannot be permuted or stacked (LoRA-patched
    leaves) keep the unfused attention or the unrolled layout, with a
    warning, as in the JAX loader. The bundle holds ``ModelSamplingFlux``,
    the FLUX1 latent format and FBCache at threshold 0.120 in the
    options."""
    dev = _config.resolve_device(device)
    rc = _config.get_config()
    w8a8 = rc.resolve_w8a8(dev) if w8a8 is None else w8a8
    scan = rc.resolve_flux_scan(dev) if scan is None else scan
    dtype = dtype or _config.DtypePolicy.for_device(dev).compute_dtype
    p = ggml.to_device_quantized(params, dtype=dtype, device=dev)
    del params  # so that to_w8a8 frees each Q8_0 leaf nothing else holds
    cfg = dataclasses.replace(cfg or flux_mod.detect_config(p), dtype=dtype,
                              fused_attn=False)
    if w8a8:
        p = ggml.to_w8a8(p)
    if fused_attn_for(cfg, dev):
        try:
            p = flux_mod.permute_rope_basis(p, cfg)
            cfg = dataclasses.replace(cfg, fused_attn=True)
        except ValueError as e:
            logger.warning("fused_attn unavailable for these params (%s); keeping the "
                           "unfused attention path", e)
    p = f32_qk_norms(p)
    if scan:
        try:
            p = flux_mod.stack_block_params(p, cfg)
        except ValueError as e:
            logger.warning("flux_scan unavailable for these params (%s); keeping the "
                           "unrolled forward", e)
    return flux_bundle(p, cfg, dev)


def f32_qk_norms(p: Dict[str, Any]) -> Dict[str, Any]:
    """The QKNorm scales in contiguous f32 (what K3 and the norms take)."""
    for key in p:
        if key.endswith(("query_norm.scale", "key_norm.scale")):
            p[key] = p[key].float().contiguous()
    return p


def flux_bundle(p: Dict[str, Any], cfg: flux_mod.FluxConfig, device) -> DiffusionModel:
    """A Flux DiT's ``DiffusionModel`` on built params: ``ModelSamplingFlux``,
    the FLUX1 latent format, FBCache at 0.120 in the options."""
    return DiffusionModel(
        apply_fn=flux_mod.make_apply_fn(cfg),
        params=p,
        model_sampling=ms_mod.ModelSamplingFlux(),
        latent_format=latent_mod.FLUX1,
        config=cfg,
        model_options={"fbcache": fb_mod.FBCacheConfig(0.120)},
        device=device,
        model_type="flux",
    )
