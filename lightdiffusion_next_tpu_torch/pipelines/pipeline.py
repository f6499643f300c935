"""pipeline(): SD1.5 txt2img with its hires-fix and ADetailer, SD1.5
img2img with UltimateSDUpscale, and Flux.1 txt2img, on the GPU, with
progress and previews through ``app.instance.PreviewHook``.

Counterpart of lightdiffusion_next_tpu/pipelines/pipeline.py ``pipeline``
with its flows, dispatched in its order (Flux first, then img2img, then
SD1.5; so Flux ignores ``hires_fix``, ``img2img`` and ``adetailer``):

- ``_sd15_generate``: without models given, the checkpoint (Meina V10, or
  DreamShaper 8 with ``realistic_model``) is loaded from the asset root
  through the model cache with the textual-inversion directory
  ``<asset_root>/embeddings``, and ``loras/add_detail.safetensors`` is
  merged at 0.7/0.7 when it exists; CLIP-L with clip-skip -2 encodes the
  prompt and the negative prompt, the UNet runs ``dpmpp_sde_cfgpp`` (or
  ``dpmpp_2m_cfgpp`` with ``prio_speed``) for 20 karras steps under the
  batched CFG denoiser with the multi-scale plan and MSW-MSA windowing,
  the VAE decodes, AutoHDR runs (``autohdr``), and the image is saved
  under "Classic/LD". With ``hires_fix`` the final latent is resized by
  bislerp to twice the size, then ``euler_ancestral_cfgpp`` takes 10 steps
  over the "normal" schedule at cfg 8.0 and denoise 0.45 from a new
  ``random.randint`` seed (MSW-MSA still on, multi-scale off), and the
  decode is saved under "HiresFix/LD". With ``adetailer`` the decoded
  images go through ``_run_adetailer`` before AutoHDR and are saved under
  "Adetailer/LD-head": a person pass, then a face pass (the files
  ``yolos/person_yolov8m-seg.pt`` and ``yolos/face_yolov9c.pt``, each
  skipped when missing or when ``ultralytics`` is not installed), each
  segment re-diffused by ``detailer.Detailer`` (20 steps of
  ``dpmpp_2m_cfgpp`` over karras at cfg 7.5, denoise 0.5, the image's
  seed, differential diffusion) on the MSW-MSA model, its masks refined by
  SAM (``yolos/sam_vit_b_01ec64.pth``, ``segment_anything``) when both are
  there; without detector files the images pass through unchanged;
- ``_img2img_usdu`` (``img2img=True``; the prompt is the image's path):
  the checkpoint as above without the LoRA, CLIP-L with clip-skip -2 on
  fixed prompts, the image upscaled by ``ESRGAN/RealESRGAN_x4plus.pth``
  (through the model cache) when it exists, then UltimateSDUpscale to
  twice the size (``upscaler.USDUConfig(upscale_by=2.0)``: 512 tiles, 8
  steps of ``dpmpp_2m_cfgpp`` over karras at cfg 6.0, denoise 0.3 and 0.2
  on the seams, from a new ``random.randint`` seed), AutoHDR, saved under
  "Img2Img/LD";
- ``_flux_txt2img`` (``flux_enabled=True``): without models given, the
  four Flux assets are loaded from the asset root through the model cache
  (``_get_flux_models``: the DiT from ``unet/flux1-dev-Q8_0.gguf`` with
  FBCache at 0.120, in the W8A8, scan and fused-attention variant that
  ``RuntimeConfig`` resolves for the device; T5-XXL from its GGUF, stacked
  when ``flux_scan`` resolves on; CLIP-L and the AE from safetensors);
  CLIP-L's projected pooled vector and T5-XXL's sequence (at least 256
  tokens) with guidance 3.0 (``encode_flux_conditioning``), a zero
  16-channel latent, 20 steps of ``euler_cfgpp`` at cfg 1.0 over the "beta"
  schedule with FBCache (the model's option), the Flux AE decodes,
  AutoHDR, and the image is saved under "Flux/LD".

Beyond the JAX function's arguments it takes the models (``model``,
``clip``, ``vae`` and, for Flux, ``t5``; they are loaded when none is
given, and only a loaded SD1.5 checkpoint gets the LoRA, in txt2img), an
optional ``seed`` (txt2img's first pass and ADetailer's; the hires-fix
and USDU seeds come from ``random`` as in the JAX package) and the
``device`` (the GPU by default).

``progress_callback``: a raw callable passes through to every sampling
stage; one with a ``for_stage`` method (``app.instance.PreviewHook``) gives
each stage its callback (``_resolve_callback``) from the stage's step count
(txt2img 20, hires-fix 10, USDU 8, ADetailer 20, Flux 20), the latent
format and its TAESD decoder (``vae_approx/`` + the format's
``taesd_decoder_file``: SD1.5 ``taesd_decoder.safetensors``, Flux
``diffusion_pytorch_model.safetensors`` in diffusers' layout) when the file
is there, else None and the linear RGB preview. The loop over images, the
hires pass and the ADetailer pass stop when its ``should_stop`` says so
(a ``PreviewHook``: its instance was interrupted). The JAX package polls
a separate ``_stop_requested`` that knows ``PreviewHook`` by type.

``enhance_prompt``: the prompt goes through ``enhancer.enhance_prompt``
(a local Ollama; the prompt itself when that fails) after the parameter
file is written and before any model is loaded, as in the JAX package.

Several GPUs (one process each, a ``torch.distributed`` process group of
more than one rank, e.g. under ``torchrun``): unless ``LDT_FLUX_TP`` is
"off", the Flux DiT loads tensor-parallel over a (1, world) mesh
(``_flux_mesh``; the JAX pipeline's multi-chip Flux) and runs the explicit
forward of ``parallel.spmd``, with the ``RuntimeConfig`` toggles' choices
per shard (on the card W8A8, scan and K3 interleaved). "auto", the
default, and "spmd" are that one mode; the JAX package's "auto" is its
GSPMD path, which the port does not build. T5, CLIP-L and the AE are
whole on every rank. Every rank runs the same flow; the seed and the stop
flag are rank 0's (``parallel.inference.agree``), and only rank 0 writes
the PNGs, the seed file and the parameter file. With one rank, or
``LDT_FLUX_TP=off``, the single-device path runs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
from typing import List, Optional

import torch
import torch.distributed as dist

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models import lora as lora_mod
from lightdiffusion_next_tpu_torch.models import taesd as taesd_mod
from lightdiffusion_next_tpu_torch.models import vae as vae_mod
from lightdiffusion_next_tpu_torch.models.clip import facade as clip_facade
from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
from lightdiffusion_next_tpu_torch.models.clip import t5_tokenizer
from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te
from lightdiffusion_next_tpu_torch.models.clip import tokenizer as clip_tokenizer
from lightdiffusion_next_tpu_torch.ops import ggml, window
from lightdiffusion_next_tpu_torch.parallel import inference as par_inf
from lightdiffusion_next_tpu_torch.pipelines import detailer, downloader, enhancer, loader
from lightdiffusion_next_tpu_torch.pipelines import upscaler
from lightdiffusion_next_tpu_torch.pipelines import sam as sam_mod
from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod
from lightdiffusion_next_tpu_torch.sampling import ksampler as ks
from lightdiffusion_next_tpu_torch.sampling import samplers as samplers_mod
from lightdiffusion_next_tpu_torch.utils import hdr as hdr_mod
from lightdiffusion_next_tpu_torch.utils import image as image_utils
from lightdiffusion_next_tpu_torch.utils import latent as latent_mod
from lightdiffusion_next_tpu_torch.utils import params_io
from lightdiffusion_next_tpu_torch.utils import profiling
from lightdiffusion_next_tpu_torch.utils import state_dict as sd_utils
from lightdiffusion_next_tpu_torch.utils import upscale as upscale_mod

logger = logging.getLogger(__name__)

DEFAULT_NEGATIVE = (
    "(worst quality, low quality:1.4), (zombie, sketch, interlocked fingers, "
    "comic), (embedding:EasyNegative), (embedding:badhandv4), (embedding:lr), "
    "(embedding:ng_deepnegative_v1_75t)"
)

def _seed_file() -> str:
    return os.path.join(_config.asset_root(), "last_seed.txt")


def load_last_seed() -> int:
    try:
        with open(_seed_file()) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def save_last_seed(seed: int) -> None:
    os.makedirs(os.path.dirname(_seed_file()), exist_ok=True)
    with open(_seed_file(), "w") as f:
        f.write(str(seed))


def pipeline(
    prompt: str,
    w: int,
    h: int,
    number: int = 1,
    batch: int = 1,
    hires_fix: bool = False,
    adetailer: bool = False,
    enhance_prompt: bool = False,
    img2img: bool = False,
    stable_fast: bool = False,  # accepted for API parity
    reuse_seed: bool = False,
    flux_enabled: bool = False,
    prio_speed: bool = False,
    autohdr: bool = True,
    realistic_model: bool = False,
    negative_prompt: Optional[str] = None,
    multiscale_preset: Optional[str] = None,
    enable_multiscale: bool = True,
    multiscale_factor: float = 0.5,
    multiscale_fullres_start: int = 3,
    multiscale_fullres_end: int = 8,
    multiscale_intermittent_fullres: bool = False,
    output_dir: str = "./output",
    progress_callback=None,
    hidiffusion: bool = True,
    *,
    model=None,
    clip=None,
    vae=None,
    t5=None,
    seed: Optional[int] = None,
    device: _config.DeviceLike = None,
) -> List[str]:
    """Run txt2img; returns the saved image paths. ``model`` is a
    ``models.base.DiffusionModel`` (``sd15_model``, or ``flux_model`` with
    ``flux_enabled=True``), ``vae`` a ``models.vae.VAE``. SD1.5: ``clip`` is
    a ``models.clip.facade.CLIP``. Flux: ``clip`` is a CLIP-L
    ``models.clip.text_encoder.SDClipModel`` (its projected pooled vector is
    used) and ``t5`` a ``models.clip.t5.T5XXLModel``. With none of them
    given, they are loaded on ``device`` from the asset root. With ``seed`` given,
    no seed file is read or written; otherwise the JAX package's seed
    handling applies. ``progress_callback``: a ``PreviewHook``, or a
    callable called after every sampler step with the step's dict (``x``,
    ``i``, ``sigma``, ``denoised``; see ``samplers.sample`` for one that
    carries ``chunk``); a ``should_stop`` method on it, when it returns
    true, stops the run between images, passes, USDU tiles and ADetailer
    segments."""
    given = [m is not None for m in (model, clip, vae)] + ([t5 is not None] if flux_enabled
                                                          else [])
    if any(given) and not all(given):
        raise ValueError("pass all of model=, clip=, vae= (and t5= with flux_enabled), or "
                         "none to load them")

    if multiscale_preset is not None:
        ms = samplers_mod.MultiScale.preset(multiscale_preset)
    else:
        ms = samplers_mod.MultiScale(
            enabled=enable_multiscale,
            factor=multiscale_factor,
            fullres_start=multiscale_fullres_start,
            fullres_end=multiscale_fullres_end,
            intermittent=multiscale_intermittent_fullres,
        )
    if negative_prompt is None or not negative_prompt.strip():
        negative_prompt = DEFAULT_NEGATIVE

    with profiling.request("pipeline"):
        writer = par_inf.is_writer()
        drawn = seed is None
        if drawn:
            seed = load_last_seed() if reuse_seed else random.randint(1, 2**63 - 1)
        seed = par_inf.agree(seed)
        if drawn and writer:
            save_last_seed(seed)
        if writer:
            try:
                params_io.write_parameters_to_file(prompt, negative_prompt, w, h, 7)
            except OSError:
                pass
        if enhance_prompt:
            prompt = enhancer.enhance_prompt(prompt)

        saver = image_utils.SaveImage(output_dir=output_dir) if writer else _NoSaver()
        saved: List[str] = []
        for _ in range(number):
            if par_inf.agree(samplers_mod.callback_requests_stop(progress_callback)):
                break
            if flux_enabled:
                saved += _flux_txt2img(prompt, w, h, batch, seed, autohdr, saver,
                                       progress_callback, model, clip, vae, t5, device)
            elif img2img:
                saved += _img2img_usdu(prompt, autohdr, saver, realistic_model, progress_callback,
                                       model, clip, vae, device)
                continue
            else:
                saved += _sd15_generate(prompt, negative_prompt, w, h, batch, seed, ms,
                                        prio_speed, autohdr, realistic_model, saver,
                                        progress_callback, hidiffusion, model, clip, vae,
                                        device, hires_fix, adetailer)
            seed = par_inf.agree(random.randint(1, 2**63 - 1))
        return saved


class _NoSaver:
    """The saver of a rank other than 0: rank 0 writes the images."""

    def save_images(self, images, folder, prompt=None):
        return []


_TAESD_CACHE: dict = {}


def _load_taesd_params(taesd_file, device):
    """The TAESD decoder ``vae_approx/<taesd_file>`` normalized and on
    ``device`` in f32, cached per (path, mtime, device); None when the file
    is missing or not a TAESD decoder (cached too; the previews then use
    the linear RGB map)."""
    if not taesd_file:
        return None
    path = downloader.asset_path("vae_approx", taesd_file)
    try:
        key = (path, os.path.getmtime(path), str(device))
    except OSError:
        return None
    if key not in _TAESD_CACHE:
        params = None
        try:
            params = taesd_mod.normalize_decoder_params(sd_utils.load_torch_file(path))
        except Exception:
            logger.exception("TAESD decoder %s not read; previews use the linear RGB map",
                             path)
        if params is not None:
            params = {k: v.to(device=device, dtype=torch.float32)
                      for k, v in params.items()}
        _TAESD_CACHE[key] = params
    return _TAESD_CACHE[key]


def _resolve_callback(progress_callback, latent_format, total_steps, device=None):
    """This stage's callback: ``progress_callback.for_stage`` given the
    stage's latent format, step count and the format's TAESD decoder on
    ``device`` (None without its file); a callback without ``for_stage``
    passes through."""
    for_stage = getattr(progress_callback, "for_stage", None)
    if for_stage is None:
        return progress_callback
    taesd_params = _load_taesd_params(latent_format.taesd_decoder_file,
                                      _config.resolve_device(device))
    return for_stage(latent_format, total_steps, taesd_params)


def _load_sd15(realistic_model: bool, device):
    missing = downloader.check_and_download()
    ckpt = downloader.asset_path(
        "checkpoints",
        "DreamShaper_8_pruned.safetensors" if realistic_model
        else "Meina V10 - baked VAE.safetensors",
    )
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"checkpoint missing: {ckpt}"
                                + (f" (downloads failed: {missing})" if missing else ""))
    return loader.CheckpointLoaderSimple().load_checkpoint(
        ckpt, embedding_directory=os.path.join(_config.asset_root(), "embeddings"),
        device=device)


def _apply_lora_add_detail(model, clip):
    """The add_detail LoRA merged at 0.7 (UNet) and 0.7 (CLIP), into new
    models, when its file exists. A failure leaves the models as they were,
    as in the JAX package, and is logged with its traceback."""
    path = downloader.asset_path("loras", "add_detail.safetensors")
    if not os.path.exists(path):
        return model, clip
    try:
        lora_sd = sd_utils.load_torch_file(path)
        inner = clip.model.model  # SD1ClipModel -> SDClipModel
        new_unet, new_clip_params = lora_mod.load_and_apply_lora(
            lora_sd, model.params, inner.params, 0.7, 0.7)
        new_inner = inner.clone()
        new_inner.params = new_clip_params
        clip = clip.clone()
        clip.model = te.SD1ClipModel(new_inner)
        return dataclasses.replace(model, params=new_unet), clip
    except Exception:
        logger.exception("LoRA %s not applied", path)
        return model, clip


def _sd15_generate(prompt, negative_prompt, w, h, batch, seed, ms, prio_speed, autohdr,
                   realistic_model, saver, progress_callback, hidiffusion, model, clip, vae,
                   device, hires_fix, adetailer):
    if model is None:
        model, clip, vae = _load_sd15(realistic_model, device)
        model, clip = _apply_lora_add_detail(model, clip)
    clip = clip_facade.CLIPSetLastLayer().set_last_layer(clip, -2)
    with profiling.span("pipeline.encode"):
        encode = clip_facade.CLIPTextEncode()
        positive = encode.encode(clip, prompt)
        negative = encode.encode(clip, negative_prompt)

    if hidiffusion:
        model = model.with_options(
            attn1_override_factory=window.make_msw_msa_factory(
                model_sampling=model.model_sampling
            )
        )

    result = ks.ksample(
        model,
        seed=seed,
        steps=20,
        cfg_scale=7.0,
        sampler_name="dpmpp_2m_cfgpp" if prio_speed else "dpmpp_sde_cfgpp",
        scheduler="karras",
        positive=positive,
        negative=negative,
        latent_image=latent_mod.empty_latent(w, h, batch, device=model.device),
        denoise=1.0,
        ms=ms,
        callback=_resolve_callback(progress_callback, model.latent_format, 20, model.device),
    )
    if hires_fix and not samplers_mod.callback_requests_stop(progress_callback):
        with profiling.span("pipeline.upscale"):
            up = upscale_mod.bislerp(result.latent, (w * 2) // 8, (h * 2) // 8)
            with profiling.span("sync.upscale_upload"):
                up = torch.from_numpy(up).to(model.device)
        result = ks.ksample(
            model,
            seed=random.randint(1, 2**63 - 1),
            steps=10,
            cfg_scale=8.0,
            sampler_name="euler_ancestral_cfgpp",
            scheduler="normal",
            positive=positive,
            negative=negative,
            latent_image=up,
            denoise=0.45,
            callback=_resolve_callback(progress_callback, model.latent_format, 10,
                                       model.device),
        )
        del up  # not held on the device through the decode
    with profiling.span("pipeline.decode"):
        images = vae.decode(result.latent)
    if adetailer and not samplers_mod.callback_requests_stop(progress_callback):
        images = torch.from_numpy(_run_adetailer(
            images.cpu().numpy(), model, vae, positive, negative, seed,
            progress_callback)).to(images.device)
        prefix = "Adetailer/LD-head"
    else:
        prefix = "HiresFix/LD" if hires_fix else "Classic/LD"
    if autohdr:
        with profiling.span("pipeline.hdr"):
            images = hdr_mod.apply_hdr_batch(images)
    return _save(saver, images, prefix, prompt)


def _save(saver, images, prefix, prompt):
    """The images read back to the host, encoded as PNGs and written."""
    with profiling.span("pipeline.save"):
        with profiling.span("sync.readback"):
            images = images.cpu().numpy()
        return saver.save_images(images, prefix, prompt=prompt)


def _run_adetailer(images, model, vae, positive, negative, seed, progress_callback=None):
    """The person pass, then the face pass, over host images (B, H, W, 3)
    f32 with the generation's conds and seed. SAM and the detectors come
    from the model cache (variants "sam", "yolo"); each missing file is
    skipped, and so is a detector or SAM whose package is not installed
    (logged)."""
    d = detailer.Detailer(model, vae, detailer.DetailerConfig(denoise=0.5, seed=seed))
    cb = _resolve_callback(progress_callback, model.latent_format, d.cfg.steps, model.device)
    cache = loader.get_model_cache()

    sam = None
    sam_path = downloader.asset_path("yolos", "sam_vit_b_01ec64.pth")
    if os.path.exists(sam_path):
        sam = cache.get(sam_path, "sam")
        if sam is None:
            try:
                sam = sam_mod.SAMWrapper(sam_path)
                cache.put(sam_path, sam, "sam")
            except RuntimeError as err:
                logger.warning("ADetailer: SAM %s not used: %s", sam_path, err)
                sam = None

    for name in ("person_yolov8m-seg.pt", "face_yolov9c.pt"):
        path = downloader.asset_path("yolos", name)
        if not os.path.exists(path):
            continue
        detector = cache.get(path, "yolo")
        if detector is None:
            try:
                detector = detailer.UltralyticsDetector(path)
                cache.put(path, detector, "yolo")
            except RuntimeError as err:
                logger.warning("ADetailer: %s skipped: %s", path, err)
                continue
        images, _ = d.detail(images, detector, positive, negative, sam=sam, callback=cb)
    return images


def _img2img_usdu(image_path, autohdr, saver, realistic_model, progress_callback, model, clip,
                  vae, device):
    if model is None:
        model, clip, vae = _load_sd15(realistic_model, device)
    clip = clip_facade.CLIPSetLastLayer().set_last_layer(clip, -2)
    encode = clip_facade.CLIPTextEncode()
    positive = encode.encode(clip, "masterpiece, best quality, highly detailed")
    negative = encode.encode(clip, DEFAULT_NEGATIVE)
    image = image_utils.load_image(image_path)

    up_model = None
    esrgan_path = downloader.asset_path("ESRGAN", "RealESRGAN_x4plus.pth")
    if os.path.exists(esrgan_path):
        up_model = loader.load_upscale_model(esrgan_path, model.device)
    usdu = upscaler.UltimateSDUpscale(model, vae, up_model, upscaler.USDUConfig(upscale_by=2.0))
    out = usdu.upscale(image, positive, negative, seed=random.randint(1, 2**63 - 1), steps=8,
                       cfg_scale=6.0, sampler_name="dpmpp_2m_cfgpp", scheduler="karras",
                       denoise=0.3,
                       callback=_resolve_callback(progress_callback, model.latent_format, 8,
                                                  model.device))
    if autohdr:
        out = hdr_mod.apply_hdr_batch(torch.from_numpy(out).to(model.device)).cpu().numpy()
    return saver.save_images(out, "Img2Img/LD", prompt=image_path)


def _flux_mesh():
    """The (1, world) mesh the Flux DiT is served tensor-parallel over when
    ``LDT_FLUX_TP`` is not "off" and the process group has more than one
    rank, else None. "auto" (the default) and "spmd" are one mode: the
    port has one tensor-parallel forward (``parallel.spmd``), configured by
    the ``RuntimeConfig`` toggles."""
    tp_mode = os.environ.get("LDT_FLUX_TP", "auto")
    if tp_mode not in ("auto", "spmd", "off"):
        raise ValueError(f"LDT_FLUX_TP={tp_mode!r}: must be auto or spmd (tensor-parallel) "
                         "or off (single device)")
    if tp_mode != "off" and dist.is_initialized() and dist.get_world_size() > 1:
        return par_inf.inference_mesh(n_model=dist.get_world_size())
    return None


def _get_flux_models(unet_path, t5_path, clip_l_path, ae_path, device, mesh=None):
    """The Flux DiT, AE, T5-XXL and CLIP-L from their files, each through
    the model cache keyed by path, mtime and variant: a second call reads
    nothing from disk. One resident DiT across its variants
    (``:mesh(1, N)``, ``:w8a8``, ``:scan``, ``:fusedattn``) and one T5
    across its layouts. ``mesh``: this rank's shards of the DiT with the
    tensor-parallel forward (``loader.load_diffusion_model_gguf(mesh=)``)."""
    dev = _config.resolve_device(device)
    rc = _config.get_config()
    cache = loader.get_model_cache()
    variant = f"dev={dev}" if mesh is None else f"dev={dev}:mesh{tuple(mesh.shape)}"
    w8a8 = rc.resolve_w8a8(dev)
    scan = rc.resolve_flux_scan(dev)
    if w8a8:
        variant += ":w8a8"
    if scan:
        variant += ":scan"
    if rc.resolve_fused_attn(dev):
        variant += ":fusedattn"
    model = cache.get(unet_path, variant=variant)
    if model is None:
        cache.evict_other_variants(unet_path, keep_variant=variant)
        model = loader.load_diffusion_model_gguf(unet_path, w8a8=w8a8, scan_blocks=scan,
                                                 device=dev, mesh=mesh)
        cache.put(unet_path, model, variant=variant)

    vae = cache.get(ae_path, variant=f"dev={dev}")
    if vae is None:
        ae_sd = sd_utils.load_torch_file(ae_path)
        vae = vae_mod.VAE(ae_sd, cfg=vae_mod.detect_vae_config(ae_sd), device=dev)
        cache.put(ae_path, vae, variant=f"dev={dev}")

    t5_variant = f"dev={dev}" + (":scan" if scan else "")
    t5_model = cache.get(t5_path, variant=t5_variant)
    if t5_model is None:
        cache.evict_other_variants(t5_path, keep_variant=t5_variant)
        t5_params = ggml.gguf_clip_loader(t5_path)
        t5_model = t5_mod.T5XXLModel(t5_params, cfg=t5_mod.detect_config(t5_params),
                                     compute_dtype=torch.bfloat16, device=dev,
                                     scan_blocks=scan)
        cache.put(t5_path, t5_model, variant=t5_variant)

    clip_model = cache.get(clip_l_path, variant=f"dev={dev}")
    if clip_model is None:
        clip_model = te.SDClipModel(sd_utils.load_torch_file(clip_l_path), device=dev)
        cache.put(clip_l_path, clip_model, variant=f"dev={dev}")
    return model, vae, t5_model, clip_model


def _load_flux(device):
    downloader.check_and_download_flux()
    paths = (downloader.asset_path("unet", "flux1-dev-Q8_0.gguf"),
             downloader.asset_path("clip", "t5-v1_1-xxl-encoder-Q8_0.gguf"),
             downloader.asset_path("clip", "clip_l.safetensors"),
             downloader.asset_path("vae", "ae.safetensors"))
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"flux asset missing: {p}")
    return _get_flux_models(*paths, device, mesh=_flux_mesh())


def _flux_txt2img(prompt, w, h, batch, seed, autohdr, saver, progress_callback, model, clip,
                  vae, t5, device):
    if model is None:
        model, vae, t5, clip = _load_flux(device)
    with profiling.span("pipeline.encode"):
        positive = encode_flux_conditioning(prompt, prompt, guidance=3.0,
                                            t5_model=t5, clip_model=clip)
        negative = dataclasses.replace(  # ConditioningZeroOut
            positive, cross_attn=torch.zeros_like(positive.cross_attn),
            pooled=torch.zeros_like(positive.pooled),
        )
    result = ks.ksample(
        model,
        seed=seed,
        steps=20,
        cfg_scale=1.0,
        sampler_name="euler_cfgpp",
        scheduler="beta",
        positive=positive,
        negative=negative,
        latent_image=latent_mod.empty_latent(w, h, batch, channels=16,
                                             device=model.device),
        denoise=1.0,
        callback=_resolve_callback(progress_callback, latent_mod.FLUX1, 20, model.device),
    )
    with profiling.span("pipeline.decode"):
        images = vae.decode(result.latent)
    if autohdr:
        with profiling.span("pipeline.hdr"):
            images = hdr_mod.apply_hdr_batch(images)
    return _save(saver, images, "Flux/LD", prompt)


def encode_flux_conditioning(clip_l_text: str, t5xxl_text: str, guidance: float = 3.0,
                             t5_model=None, clip_model=None) -> cfg_mod.CondInput:
    """T5 sequence as the cross-attention context and CLIP-L's projected
    pooled vector, with the distilled guidance strength. ``clip_model`` is
    an ``SDClipModel`` with its own defaults (last layer, projected pooled),
    not the SD1.5 facade's clip-skip."""
    clip_rows = clip_tokenizer.SDTokenizer().tokenize_with_weights(clip_l_text)
    _, pooled = clip_model.encode_token_weights(clip_rows)
    t5_out, _ = t5_model.encode_token_weights([t5_tokenizer.flux_t5_tokenize(t5xxl_text)])
    return cfg_mod.CondInput(cross_attn=t5_out, pooled=pooled, guidance=guidance)
