"""Checkpoint loading: a one-file SD1.5 checkpoint -> (model, clip, vae), a
Flux GGUF -> the Flux DiT, an ESRGAN file -> its upscaler, with
architecture detection and a model cache kept between calls.

Counterpart of lightdiffusion_next_tpu/pipelines/loader.py, its
single-device part: ``load_checkpoint_guess_config``,
``load_diffusion_model_gguf``, ``ModelCache`` (with
``evict_other_variants`` and the WebUI's keep-loaded switch),
``get_model_cache``, ``CheckpointLoaderSimple``, and the cache's
``"esrgan"`` entry that the JAX ``pipeline.py`` keeps
(``load_upscale_model``). Each model is built on the
given device (the GPU by default) in the device's dtype policy: the UNet
through ``base.sd15_model`` (which joins its attention projections), the
VAE with its encoder and decoder, ESRGAN in f32, CLIP-L with the
textual-inversion directory, the Flux DiT through ``base.flux_model``
(requant, permutation and stacking on the device). A one-file Flux
checkpoint raises, as in the JAX package.

With ``mesh=`` (``parallel.make_mesh``) the Flux load is tensor-parallel:
each rank reads the GGUF, lays it out (``parallel.layout``) and uploads
only its slices (``parallel.sharding``), with the JAX mesh load's checks
and warnings on fused attention. The port has one tensor-parallel
forward, the explicit one of ``parallel.spmd`` (the JAX ``shard_map``
design; JAX's GSPMD load has no counterpart), and the ``RuntimeConfig``
toggles choose its configuration as on one device: with fused attention
the RoPE basis is permuted on the host before the interleave for K3, and
the stacking (``flux_scan``) and the W8A8 requant come after, per shard
(the JAX pipeline's order).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Optional, Tuple

import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models import base as base_mod
from lightdiffusion_next_tpu_torch.models import esrgan
from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.models import vae as vae_mod
from lightdiffusion_next_tpu_torch.models.clip import facade as clip_facade
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.parallel import layout as tp_layout
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
from lightdiffusion_next_tpu_torch.parallel import sharding as shard_rules
from lightdiffusion_next_tpu_torch.parallel import spmd as spmd_mod
from lightdiffusion_next_tpu_torch.utils import state_dict as sd_utils

logger = logging.getLogger(__name__)


def load_checkpoint_guess_config(
    ckpt_path: str,
    embedding_directory: Optional[str] = None,
    device: _config.DeviceLike = None,
) -> Tuple[base_mod.DiffusionModel, clip_facade.CLIP, vae_mod.VAE]:
    """Read a one-file SD checkpoint and build its three models."""
    dev = _config.resolve_device(device)
    policy = _config.DtypePolicy.for_device(dev)
    t0 = time.perf_counter()
    sd = sd_utils.load_torch_file(ckpt_path)
    unet_sd, clip_sd, vae_sd = sd_utils.split_checkpoint(sd)
    del sd
    if not unet_sd:
        raise RuntimeError(f"no diffusion model weights in {ckpt_path}")
    if sd_utils.detect_model_type(unet_sd) != "unet":
        raise RuntimeError("one-file flux checkpoints not supported; use GGUF")
    unet_cfg = dataclasses.replace(sd_utils.detect_unet_config(unet_sd),
                                   dtype=policy.compute_dtype)
    model = base_mod.sd15_model(unet_sd, cfg=unet_cfg, dtype=policy.param_dtype,
                                device=dev)
    vae = vae_mod.VAE(vae_sd, cfg=vae_mod.detect_vae_config(vae_sd),
                      dtype=policy.vae_dtype, device=dev)
    clip = clip_facade.sd1_clip_from_params(
        clip_sd, embedding_directory=embedding_directory,
        dtype=policy.text_encoder_dtype, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("loaded %s (%d bytes) in %.3f s", ckpt_path,
                os.path.getsize(ckpt_path), time.perf_counter() - t0)
    return model, clip, vae


def load_diffusion_model_gguf(path: str, w8a8: Optional[bool] = None,
                              scan_blocks: Optional[bool] = None,
                              device: _config.DeviceLike = None,
                              mesh=None) -> base_mod.DiffusionModel:
    """A Flux GGUF -> its quantized DiT on ``device`` (the GPU by default),
    through ``base.flux_model``: upload, then ``w8a8`` (default:
    ``RuntimeConfig.w8a8`` for the device) requantizes the matmul weights
    per output column, the RoPE basis is permuted when
    ``base.fused_attn_for`` says so, and ``scan_blocks`` (default:
    ``RuntimeConfig.flux_scan``) stacks the blocks on the device. Raises on
    a GGUF that holds no Flux DiT. ``mesh``: this rank's tensor-parallel
    shards instead (``_load_tp``)."""
    dev = _config.resolve_device(device)
    dtype = _config.DtypePolicy.for_device(dev).compute_dtype
    t0 = time.perf_counter()
    sd = ggml.gguf_sd_loader(path)
    if "double_blocks.0.img_attn.qkv.weight" not in sd:
        raise RuntimeError(f"{path} is not a Flux GGUF")
    fcfg = flux_mod.detect_config(sd, dtype=dtype)
    if mesh is None:
        model = base_mod.flux_model(sd, cfg=fcfg, dtype=dtype, device=dev, w8a8=w8a8,
                                    scan=scan_blocks)
    else:
        model = _load_tp(sd, fcfg, mesh, w8a8, scan_blocks, dev)
    del sd
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("loaded %s (%d bytes) in %.3f s", path, os.path.getsize(path),
                time.perf_counter() - t0)
    return model


def _load_tp(sd, fcfg, mesh, w8a8, scan_blocks, dev) -> base_mod.DiffusionModel:
    """The mesh load of the JAX ``load_diffusion_model_gguf`` with
    ``spmd=True``, and the JAX pipeline's steps after it: with fused
    attention resolved on, the RoPE basis is permuted in the checkpoint's
    layout (head dim 128 and heads divisible by the "model" ranks, else a
    warning and the unfused path); the TP layout; this rank's slices
    uploaded; the tensor-parallel forward, its shards stacked when
    ``scan_blocks`` (``spmd.to_spmd_model``), then requantized to W8A8
    when ``w8a8`` (``spmd.to_w8a8``). ``sd`` is consumed."""
    rc = _config.get_config()
    tp = mesh_mod.model_size(mesh)
    fused = False
    if rc.resolve_fused_attn(dev):
        if fcfg.head_dim != 128:
            logger.warning("fused_attn kernel is 128-lane head_dim only (got %d); keeping the "
                           "unfused attention path", fcfg.head_dim)
        elif fcfg.num_heads % tp:
            logger.warning("fused_attn needs num_heads %% tp == 0 (%d %% %d); keeping the "
                           "unfused attention path", fcfg.num_heads, tp)
        else:
            try:
                permuted = tp_layout.permute_rope_basis_rows(sd, fcfg)
                sd.clear()  # the unpermuted rows go now, not with the caller's dict
                sd, fused = permuted, True
            except ValueError as e:
                logger.warning("fused_attn unavailable for this checkpoint (%s); keeping the "
                               "unfused attention path", e)
    laid, fcfg = tp_layout.to_tp_layout(sd, fcfg)
    sd.clear()
    cfg = spmd_mod.tp_config(dataclasses.replace(fcfg, fused_attn=fused), mesh)
    p = shard_rules.shard_state_dict(laid, mesh, dtype=fcfg.dtype, device=dev)
    model = base_mod.flux_bundle(base_mod.f32_qk_norms(p), cfg, dev)
    model = spmd_mod.to_spmd_model(
        model, mesh, scan_blocks=rc.resolve_flux_scan(dev) if scan_blocks is None else scan_blocks)
    if rc.resolve_w8a8(dev) if w8a8 is None else w8a8:
        model = dataclasses.replace(model, params=spmd_mod.to_w8a8(model.params, model.config))
    return model


def load_upscale_model(path: str, device: _config.DeviceLike = None) -> esrgan.UpscaleModel:
    """The ESRGAN file at ``path`` as an ``esrgan.UpscaleModel`` on ``device``,
    through the model cache (variant ``"esrgan"``): one load a session."""
    dev = _config.resolve_device(device)
    cache = get_model_cache()
    variant = f"esrgan;dev={dev}"
    model = cache.get(path, variant)
    if model is None:
        t0 = time.perf_counter()
        model = esrgan.UpscaleModel(sd_utils.load_torch_file(path), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        logger.info("loaded %s (%d bytes) in %.3f s", path, os.path.getsize(path),
                    time.perf_counter() - t0)
        cache.put(path, model, variant)
    return model


class ModelCache:
    """Keeps built models resident between generations, keyed by the
    checkpoint's path and mtime (a rewritten file misses). With
    ``keep_models_loaded`` off (the WebUI's switch) it keeps nothing: every
    ``get`` misses, ``put`` stores nothing, and turning it off empties it."""

    def __init__(self):
        self._cache: Dict[str, Tuple] = {}
        self.keep_models_loaded = True

    def _key(self, path: str, variant: str = "") -> str:
        try:
            base = f"{os.path.abspath(path)}:{os.path.getmtime(path)}"
        except OSError:
            base = os.path.abspath(path)
        return f"{base}::{variant}" if variant else base

    def get(self, path: str, variant: str = ""):
        """``variant`` tells apart residents of one file built differently
        (another embedding directory, another device)."""
        if not self.keep_models_loaded:
            return None
        return self._cache.get(self._key(path, variant))

    def put(self, path: str, value, variant: str = "") -> None:
        if self.keep_models_loaded:
            self._cache[self._key(path, variant)] = value

    def discard(self, path: str, variant: str = "") -> None:
        self._cache.pop(self._key(path, variant), None)

    def evict_other_variants(self, path: str, keep_variant: str = "") -> None:
        """Drop every other variant of ``path`` before a new one loads: one
        resident Flux DiT at a time across the variant keys (``:w8a8``,
        ``:scan``, ``:fusedattn``), as in the JAX package."""
        base = f"{os.path.abspath(path)}:"
        keep = self._key(path, keep_variant)
        for k in [k for k in self._cache if k.startswith(base) and k != keep]:
            del self._cache[k]

    def clear(self) -> None:
        self._cache.clear()

    def set_keep_models_loaded(self, keep: bool) -> None:
        self.keep_models_loaded = keep
        if not keep:
            self.clear()

    def get_memory_info(self) -> Dict:
        """Cached models and the GPU's memory, where there is one."""
        info = {"cached_models": len(self._cache)}
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            info.update(bytes_in_use=torch.cuda.memory_allocated(),
                        bytes_free=free, bytes_limit=total)
        return info


_model_cache: Optional[ModelCache] = None


def get_model_cache() -> ModelCache:
    global _model_cache
    if _model_cache is None:
        _model_cache = ModelCache()
    return _model_cache


class CheckpointLoaderSimple:
    """Load through the process-wide model cache."""

    def load_checkpoint(self, ckpt_path: str, embedding_directory: Optional[str] = None,
                        device: _config.DeviceLike = None):
        dev = _config.resolve_device(device)
        cache = get_model_cache()
        # the tokenizer resolves embeddings against its directory, so a
        # resident built for one directory must not serve another; nor may
        # a UNet whose projections were joined (or not) under the other
        # qkv_fuse, and only one of those two stays resident
        joined = f"dev={dev}" + (f";emb={embedding_directory}" if embedding_directory else "")
        unjoined = joined + ":unfused"
        variant, other = ((joined, unjoined) if _config.get_config().resolve_qkv_fuse()
                          else (unjoined, joined))
        hit = cache.get(ckpt_path, variant)
        if hit is not None:
            return hit
        cache.discard(ckpt_path, other)
        out = load_checkpoint_guess_config(ckpt_path, embedding_directory, dev)
        cache.put(ckpt_path, out, variant)
        return out
