"""Runtime configuration: device, dtype policy, attention dispatch.

Counterpart of lightdiffusion_next_tpu/config.py, for PyTorch on an NVIDIA
GPU. What the port consults:

- ``resolve_device``: every entry point runs on ``cuda`` unless the caller
  asks for ``"cpu"`` (as the tests do); with no GPU it raises rather than
  carry on quietly on the CPU.
- ``DtypePolicy``: bf16 UNet params and compute, f32 VAE, bf16 text
  encoder on the GPU; everything f32 on the CPU. Norms and schedules always
  compute in f32.
- ``RuntimeConfig``: ``attention_backend``, ``packed_attn`` and
  ``sage_attention`` (the UNet's attention), ``qkv_fuse`` (the UNet's
  joined projections), ``rng_mode`` (the host noise), ``w8a8`` and
  ``fused_ew`` (the Flux DiT's int8 path), ``flux_scan`` (the stacked block
  layout of the Flux DiT and T5), ``fused_attn`` (Flux's attention through
  K3 on params in the permuted RoPE basis, or the unfused attention). A
  ``RuntimeConfig`` made without them reads the JAX package's seven
  overrides: ``LDT_W8A8``, ``LDT_PACKED_ATTN``, ``LDT_FLUX_SCAN``,
  ``LDT_FUSED_ATTN``, ``LDT_QKV_FUSE`` and ``LDT_FUSED_EW`` ("1" on, "0"
  off, anything else "auto") and ``LDT_SAGE_ATTN`` ("1" on).

What of the JAX ``config.py`` has no counterpart, and why:

- ``LDT_SCOPED_VMEM_KIB`` and ``donate_latents``: options of XLA's
  compiler, which the port does not run;
- ``profile_dir``: read nowhere in the JAX package (``utils/profiling
  .trace`` takes its directory from the caller);
- ``data_parallel`` and ``model_parallel``: read nowhere in the JAX
  package either; the port's mesh is the process group's (``torchrun``'s
  world, a (1, world) mesh for Flux under ``LDT_FLUX_TP``, see
  ``pipelines/pipeline.py``) or ``parallel.make_mesh``'s arguments.

The JAX package's kernel flags ``int8_mxu`` and ``pv_int8`` are arguments
of the ops (``ops.quant_matmul``'s W8A8 matmuls, ``ops.sage_attention``),
not fields here, as there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def configure_cuda_math() -> None:
    """Full-f32 math on the GPU. cuDNN runs f32 convolutions in TF32 by
    default (a 10-bit mantissa); the VAE keeps the JAX package's f32 policy
    because its decoder is the numerically fragile part of the pipeline, so
    TF32 is turned off for both convolutions and matmuls. The bf16 UNet and
    text encoder are unaffected. The plain attention versions also rely on
    f32 matmuls being f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. Raises when the GPU is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        configure_cuda_math()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Static mixed-precision policy (JAX ``DtypePolicy`` parity)."""

    compute_dtype: torch.dtype
    param_dtype: torch.dtype
    vae_dtype: torch.dtype
    text_encoder_dtype: torch.dtype

    @staticmethod
    def for_device(device: DeviceLike = None) -> "DtypePolicy":
        if torch.device("cuda" if device is None else device).type == "cpu":
            f32 = torch.float32
            return DtypePolicy(f32, f32, f32, f32)
        return DtypePolicy(
            torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16
        )


_VALID_ATTENTION = ("flash", "sdpa")
_VALID_RNG = ("torch", "jax")

_TRI_STATE = (True, False, "auto")


def _on_gpu(device: DeviceLike) -> bool:
    """``None`` is the GPU, as everywhere in the port."""
    return device is None or torch.device(device).type == "cuda"


def _tri_state_env(name: str):
    """A tri-state field's default from the environment, read when the
    config is made: "1" on, "0" off, anything else (or unset) "auto"."""
    return dataclasses.field(
        default_factory=lambda: {"1": True, "0": False}.get(os.environ.get(name, "auto"),
                                                             "auto"))


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The knobs of the port's runtime.

    attention_backend: "flash" sends long sequences (``flash_attention
      .supported``) to the hand-written kernels and the rest to ``sdpa``;
      "sdpa" sends everything to ``sdpa`` (the plain reference path).
    packed_attn: head dims up to 64 go to K1 (``packed_flash_attention``),
      otherwise to K2.
    qkv_fuse: ``models.base.sd15_model`` joins each attention's q|k|v (and
      k|v) projection weights once (``unet.fuse_projections``), so each runs
      as one matmul; off, the UNet keeps the checkpoint's separate weights
      and runs three (two) matmuls. The same contraction per output element
      either way.
    rng_mode: "torch" draws the host noise with torch's CPU generator, bit
      for bit the reference's; "jax" with numpy's Philox generator, bit for
      bit the JAX package's mode of that name (``sampling/noise.py``).
    sage_attention: opt-in, as in the JAX package. Every long-sequence
      UNet attention goes to the int8 attention K4
      (``ops.sage_attention``) ahead of K1 and K2; the VAE's attention
      stays on K2 and Flux's on K3.
    w8a8: the Flux DiT's Q8_0 matmul weights are requantized once, per
      output column, to int8 when the model is built (``ggml.to_w8a8``),
      and each of those matmuls row-quantizes its input and multiplies
      int8 by int8 (K7, ``quant_matmul.w8a8_matmul``). T5 stays Q8_0.
    fused_ew: on W8A8 weights, the LayerNorm + modulation or GELU before a
      matmul runs inside its row quantization (K9, K10) and the bias, gate
      and residual inside the matmul's epilogue (K11); models/flux.py.
    flux_scan: the Flux DiT built by ``models.base.flux_model`` stacks its
      19 double and 38 single blocks' params along a depth axis
      (``models.flux.stack_block_params``), and a T5 encoder built by
      ``T5XXLModel`` stacks its blocks (``t5.stack_t5_block_params``);
      every quantized matmul then reads block ``idx`` of a stack in place
      (K6 on Q8_0 stacks, K8 and the stacked K11 on W8A8 stacks).
    fused_attn: a Flux DiT built by ``models.base.flux_model`` or
      ``pipelines.loader.load_diffusion_model_gguf`` has its q/k projection
      columns permuted into the half-split RoPE basis, and its attention
      runs QKNorm, RoPE and the product in one kernel (K3). Off: the
      unfused attention (QKNorm, ``ops/rope.py``, then K2 for long
      sequences), which LoRA on the q/k projections needs.
    ``packed_attn``, ``qkv_fuse``, ``w8a8``, ``fused_ew``, ``flux_scan``
    and ``fused_attn`` take True, False or "auto"; "auto" is on for a model
    (``w8a8``, ``flux_scan``, ``fused_attn``) or a tensor (``packed_attn``,
    ``fused_ew``) on the GPU and off on the CPU, as the JAX package's is on
    for the TPU and off on the CPU; ``qkv_fuse``'s "auto" is on everywhere,
    as in the JAX package. Each other ``resolve_*`` takes the device
    (``None``: the GPU).
    """

    attention_backend: str = "flash"
    rng_mode: str = "torch"
    packed_attn: object = _tri_state_env("LDT_PACKED_ATTN")
    sage_attention: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("LDT_SAGE_ATTN", "") == "1")
    qkv_fuse: object = _tri_state_env("LDT_QKV_FUSE")
    w8a8: object = _tri_state_env("LDT_W8A8")
    fused_ew: object = _tri_state_env("LDT_FUSED_EW")
    flux_scan: object = _tri_state_env("LDT_FLUX_SCAN")
    fused_attn: object = _tri_state_env("LDT_FUSED_ATTN")

    def __post_init__(self):
        if self.attention_backend not in _VALID_ATTENTION:
            raise ValueError(f"attention_backend must be one of {_VALID_ATTENTION}")
        if self.rng_mode not in _VALID_RNG:
            raise ValueError(f"rng_mode must be one of {_VALID_RNG}")
        for name in ("packed_attn", "qkv_fuse", "w8a8", "fused_ew", "flux_scan",
                     "fused_attn"):
            if getattr(self, name) not in _TRI_STATE:
                raise ValueError(f'{name} must be True, False or "auto"')

    def resolve_packed_attn(self, device: DeviceLike = None) -> bool:
        """Whether attention on ``device`` with a head dim up to 64 takes K1."""
        return _on_gpu(device) if self.packed_attn == "auto" else bool(self.packed_attn)

    def resolve_qkv_fuse(self) -> bool:
        """Whether a UNet joins its projections: "auto" is on everywhere
        (the math is the same)."""
        return True if self.qkv_fuse == "auto" else bool(self.qkv_fuse)

    def resolve_w8a8(self, device: DeviceLike = None) -> bool:
        """Whether a Flux model built on ``device`` converts to W8A8."""
        return _on_gpu(device) if self.w8a8 == "auto" else bool(self.w8a8)

    def resolve_fused_ew(self, device: DeviceLike = None) -> bool:
        """Whether an activation on ``device`` takes the fused path."""
        return _on_gpu(device) if self.fused_ew == "auto" else bool(self.fused_ew)

    def resolve_flux_scan(self, device: DeviceLike = None) -> bool:
        """Whether a Flux model or a T5 encoder built on ``device`` takes
        the stacked scan layout."""
        return _on_gpu(device) if self.flux_scan == "auto" else bool(self.flux_scan)

    def resolve_fused_attn(self, device: DeviceLike = None) -> bool:
        """Whether a Flux DiT built on ``device`` takes the fused attention."""
        return _on_gpu(device) if self.fused_attn == "auto" else bool(self.fused_attn)


_current: Optional[RuntimeConfig] = None


def get_config() -> RuntimeConfig:
    global _current
    if _current is None:
        _current = RuntimeConfig()
    return _current


def set_config(cfg: RuntimeConfig) -> RuntimeConfig:
    global _current
    _current = cfg
    return cfg


def repo_asset(*parts: str) -> str:
    """Path to a data file vendored in this repository (tokenizer vocab)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "assets", *parts)


def asset_root() -> str:
    """Directory of model assets (the seed file of ``reuse_seed``)."""
    return os.environ.get(
        "LDT_ASSET_ROOT", os.path.join(os.path.expanduser("~"), ".ldt", "include")
    )
