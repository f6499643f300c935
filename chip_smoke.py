#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every hand-written kernel from ``lightdiffusion_next_tpu_torch/csrc``,
   with each source's register and spill report; the ``wgmma`` kernels (K5's
   and K6's, K3's attention kernel, K4 and its flag variants, K1's and K2's
   two templates, the one W8A8 matmul template of K7, K8, K11 and the
   stacked K11, and its bf16-rate variant) must spill nothing and, in the
   built library's SASS (``cuobjdump``), run on ``wgmma`` (HGMMA for bf16,
   IGMMA for int8: K4 and the W8A8 matmul IGMMA alone, the sage variant
   with int8 Q.K^T both, the other variants and the bf16-rate W8A8 HGMMA
   alone) with no ``mma.sync`` (HMMA, IMMA) left, or the run fails; K9's
   and K10's row-quantize kernel must spill nothing too;
   K4's conversions and exps (I2F, F2I, FRND, MUFU.EX2) are counted;
3. SD1.5 kernels: K1 and K2 at each shape the SD1.5 1024^2 path gives them
   (derived from the UNet plan, the multi-scale plan and the MSW-MSA gate),
   checked against their plain PyTorch version (``flash_attention
   .agreement``), shown to reject two planted faults, and timed beside the
   plain version and beside ``torch.nn.functional.scaled_dot_product_attention``
   (a yardstick only: the port never calls it);
4. SD1.5 reference: one full-width UNet forward at a small latent through the
   kernels in bf16 against the same forward in f32 through plain attention;
5. SD1.5 pipeline: full-width SD1.5 UNet, VAE and CLIP-L from seeded random
   weights, ``pipeline(prompt, 1024, 1024, prio_speed=True, autohdr=False)``
   to a PNG, with every launch counter set to 0 before and checked against
   the plan's prediction after; then a second, timed run;
6. Flux kernels: K5 (Q8_0 dequant-matmul) at every matmul shape of the Flux
   1024^2 path (DiT full-res and dy calls, T5-XXL) and K3 (fused QKNorm +
   RoPE attention) at its four shapes, each against its plain version, with
   two planted faults each, timed beside the plain version and a library
   yardstick (``torch.matmul`` on the weight dequantized beforehand;
   ``scaled_dot_product_attention`` on q and k normed and roped beforehand,
   so it skips the prologue);
7. Flux reference: one double block and one single block at full width and
   1024^2 token counts, from the same Q8_0 weights, through the kernels in
   bf16 against the plain versions in f32;
8. Flux pipeline: Flux.1-dev DiT (Q8_0), T5-XXL (Q8_0), CLIP-L and the Flux
   AE at full width from seeded random weights,
   ``pipeline(prompt, 1024, 1024, flux_enabled=True, autohdr=False, t5=...)``
   to a PNG; every launch counter set to 0 before and checked after against
   the plan derived from the counted FBCache hits, the two dy calls and the
   T5 encode; then a second, timed run and the time of one missed DiT call.
   The DiT is held to Q8_0 (``RuntimeConfig(w8a8=False)``), so K5 runs it;
9. W8A8 kernels: K9 (all three prologues) and K10 at every row-quantize
   shape, K11 (with and without residual) and K7 at every matmul shape of
   the W8A8 Flux 1024^2 path, each against its plain version, with two
   planted faults each, timed beside the plain version and (K7, K11)
   ``torch._int_mm`` on the same codes;
10. W8A8 Flux reference: one double and one single block at full width and
   1024^2 token counts on W8A8 weights, through the kernels in bf16 against
   the plain versions in f32 (and, logged only, against phase 7's Q8_0
   plain block on the same seeded weights);
11. W8A8 Flux pipeline: the phase 8 DiT requantized by ``ggml.to_w8a8``
   (the Q8_0 codes freed leaf by leaf), the same pipeline call with the
   launch counters checked against the W8A8 plan (K9, K10, K11 with the
   fused elementwise path, K5 for T5, K3, K2), a timed run, and one missed
   DiT call with ``fused_ew`` on and one with it off (K9 "none" and K7 on
   every matmul, counted);
12. SD1.5 int8 attention kernel: K4 at every shape the SD1.5 path gives K1
   and K2 in the UNet, and one ragged shape, through its wrapper (the
   preparation kernel, then K4) against its plain version, with two planted
   faults, timed beside the plain version and
   ``scaled_dot_product_attention``; the preparation kernel against its
   plain version (codes and scales, ``sage_attention.prep_agreement``) and
   timed alone;
13. SD1.5 sage pipeline: phase 5's models with ``RuntimeConfig(
   sage_attention=True)``, the same pipeline call with the launches checked
   (every UNet K1 and K2 call on K4; the VAE's K2), the image checked, its
   final latent against phase 5's logged, then a timed run;
14. stacked kernels: K6 at the Q8_0 DiT's and T5's shapes, K8 and the
   stacked K11 at the W8A8 DiT's, on stacks of the real depths (19, 38,
   24), each at its first and last block (the 2.5 GB linear1 stack's last
   block lies past 2^31 bytes), against its plain version and bit for bit
   against the unstacked kernel on a copy of the block, with two planted
   faults (the neighbouring block, the last K tile skipped), timed beside
   the plain version and the library yardstick; and the stacked requant
   against the unstacked one;
15. W8A8 Flux scan pipeline: the phase 11 DiT and T5 stacked in place into
   the scan layout (the port's default on the card), the same pipeline call
   with the launches checked against the scan plan (the stacked K11, K9,
   K10, K6 for T5, K3, K2; no K5, K7, K8 or unstacked K11), its final latent
   and one missed DiT call with ``fused_ew`` on and off (K8 and K9 on every
   matmul) held bit for bit to phase 11's, a timed run;
16. Flux FBCache hits: phase 15's models with FBCache forced to hit
   (``FORCED_HITS``), the same pipeline call with the launches checked
   against the plan of its counted hits and misses (a hit runs double block
   0: its matmuls and one K3 launch), its output checked; fails unless the
   cache hit;
17. SD1.5 defaults (run after phase 13, before the Flux phases): under its
   own asset root (``build/chip_smoke/defaults``, ``LDT_OFFLINE=1``) it
   writes phase 5's seeded UNet, VAE and CLIP-L as an f16 one-file
   checkpoint (about 2.1 GB, by its own writer), a seeded Kohya add_detail
   LoRA over every attention and feed-forward linear, and the four
   embeddings ``DEFAULT_NEGATIVE`` names (A1111 ``.pt``); then
   ``pipeline(prompt, 1024, 1024, output_dir=...)`` with every default and
   no models (loader, LoRA merge, textual inversion, ``dpmpp_sde_cfgpp``
   with the Brownian-tree noise, multi-scale, MSW-MSA, AutoHDR, PNG),
   checked: the K1/K2 launches against the SDE plan (midpoint calls
   included), every loaded parameter bit for bit the f16-rounded seed in
   the device policy's dtype, every LoRA module patched, the negative
   prompt's rows carrying the embeddings, a finite latent, the PNG equal to
   the AutoHDR of the decode; a timed second call; the load, the LoRA
   merge, the Brownian noise and AutoHDR timed alone; last the CLI with its
   defaults (SDE, AutoHDR off), which must print its PNG's path and take
   the model from the cache;
18. Flux from files (after phase 16): K2 at the unfused Flux attention's
   two shapes, (1, 24, 4352, 128) and (1, 24, 1280, 128) in bf16, as phase
   3 holds K1 and K2; then, under its own asset root
   (``build/chip_smoke/flux``, ``LDT_OFFLINE=1``), phase 8's models written
   at full width and depth by the port's writers, each leaf streamed from
   the card (the DiT's Q8_0 GGUF with f16 scales, T5-XXL's GGUF in
   llama.cpp names, CLIP-L and the AE as safetensors: 28.2 GB, the free
   space checked first); ``pipeline(prompt, 1024, 1024, flux_enabled=True)``
   with every default and no models (W8A8, scan, fused attention, FBCache,
   AutoHDR), its launches against phase 15's scan plan, the loaded DiT bit
   for bit ``base.flux_model``'s from the file's records, the PNG equal to
   the AutoHDR of the decode, the final latent against phase 15's logged; a
   timed second call that reads no file; the GGUF load alone (s, GB/s, the
   host's peak RSS, the device's peak); the CLI's ``--flux`` from the
   cache; then the LoRA on the unfused path: the unrolled, unfused W8A8
   variant loaded through the cache (which evicts the scan one), a seeded
   rank-16 Kohya LoRA on every block linear, the same pipeline call with
   its launches against the plan (K9 "none" and K7 on every quantized
   matmul, K2 at (1, 24, L, 128) for every attention, no K3), a finite
   image, a timed second call, and one double and one single block under
   the LoRA, bf16 kernels against the f32 plain versions. It also keeps
   phase 23's one-device references (one missed DiT call on seeded inputs,
   the final latent). The files stay for phase 23 and are removed after
   it, also on failure;
19. SD1.5 hires-fix (after phase 17, from its files): K1 and K2 at the
   hires pass's new shapes (``hires_calls``: its level-0 windows at 16 384
   tokens, levels 1-3 at 16 384, 4096 and 1024 tokens, the f32 decode at
   65 536 tokens) and K1 unwindowed at 65 536 tokens, as phase 3 holds
   them; ``pipeline(prompt, 1024, 1024, hires_fix=True)`` with every
   default, Python's ``random`` seeded, its launches against the plan
   derived from the hires pass's own sigmas ("normal", denoise 0.45, the
   MSW gate), 20 steps at 128^2 then 10 at 256^2, a finite latent, the
   2048^2 PNG equal to the AutoHDR of the decode; a timed second call; the
   CLI's ``--hires-fix`` as a process;
20. SD1.5 img2img: K1 and K2 at the USDU tiles' shapes (576^2 crops: 5184
   and 1296 tokens, the f32 encoder and decoder at 5184) as above; a seeded
   ESRGAN at RealESRGAN_x4plus's width (23 RRDB blocks, nf 64, gc 32; 67 MB
   f32) written as ``ESRGAN/RealESRGAN_x4plus.pth`` under phase 17's asset
   root; ``pipeline(<phase 17's PNG>, 1024, 1024, img2img=True)``, its
   launches against the plan (``usdu_calls``: 16 redraw and 24 seam tiles,
   each an encode, 8 steps, a decode), a 2048^2 PNG that is not constant,
   a finite last latent; a timed second call, which must take ESRGAN from
   the cache; ESRGAN, the tile's VAE encode and decode timed alone; the
   CLI's ``--img2img`` as a process;
21. SD1.5 ADetailer and previews: K1 and K2 at the detailer's bucket
   shapes (``adetailer_calls``: a person mask whose 2x crop takes the 768
   cap, 512 x 768, and a face's, 512 x 640; level 0 windowed and
   unwindowed, level 1, the f32 encode and decode at the bucket's latent)
   as above; ``pipeline(prompt, 1024, 1024, adetailer=True)`` with no
   ``yolos/`` files equal to the plain run's PNG bit for bit; with empty
   ``yolos/`` placeholders and ``StandInDetector`` in
   ``UltralyticsDetector``'s place (restored after, also on failure) both
   passes, their launches against the plan (the first pass, then per
   segment an encode, the detailer's 20 of 40 karras sigmas with the MSW
   gate, a decode), a finite last latent, a PNG that is not constant; a
   timed second call with each segment's seconds; ``Detailer.detail``
   alone on a decoded image: the pixels outside every crop bit for bit;
   a seeded TAESD decoder at the published widths under
   ``vae_approx/``, ``PreviewHook`` previews (every 5): the steps at the
   plan's chunk marks, 1024^2 PNGs that are not constant, progress 1.0,
   the final PNG equal to the run without previews, timed in turns with
   it (plain, preview, preview, plain), TAESD's decode alone; the CLI's
   ``--adetailer --preview`` as a process; the linear RGB previews once
   the decoder file is gone;
22. the WebUI on the card (after 21, from phase 17's files): K2 at the
   shapes ``packed_attn=False`` gives it (d = 40 at level 0) and K4 at the
   SDE plan's, as above; then Generate through
   ``webui.generate_images_with_preview`` with every default and previews,
   its worker thread's launches against phase 17's plan, then in turns
   with the direct ``pipeline()`` call it makes (the same PNG, bit for
   bit; the handler's overhead and the poll's share of it); a second
   Generate refused while one runs, an interrupt that stops the run at the
   next chunk mark, a disconnect that keeps the lock until the worker
   ends; the ``sage_attention`` and ``packed_attn`` toggles against their
   plans; ``enhance_prompt`` against a stand-in Ollama served on
   127.0.0.1:11434 from a thread (CLIP gets ``QUALITY_PREFIX`` + its
   reply; a failing stand-in leaves the prompt); the UNet's FBCache forced
   to hit through ``pipeline(model=...)``, its launches against the plan
   of its counted hits, threshold 0 bit for bit the run without the cache;
   ``qkv_fuse`` off (its own unjoined UNet, the same launches, the final
   latent held to 2e-2 of the joined run's); ``keep_models_loaded`` off
   (a load per Generate, the cache empty after). The config and the
   switches are restored after;
23. Flux tensor-parallel on the one card (after 18, from its files): K3
   with ``interleaved=True`` at (1, L, H, 128) bf16 for the TP path's
   shapes (4352 and 1280 tokens, 12 heads, text rows 256 and 0) and at 24
   and 6 heads, against its plain version, with two planted faults (the
   proj-major offsets; each head's k and v stripes swapped), timed beside
   the plain version, ``scaled_dot_product_attention`` and the bound; K9,
   the stacked K11, K5 and K2 at a rank's new shapes, as their phases hold
   them; the Q8_0 unfused unrolled DiT on one device for the reference;
   then two ranks spawned on the card (gloo, a FileStore; NCCL refuses
   two ranks on one device, and gloo stages every all-reduce through the
   host, so the times are not NVLink TP's), each loading through the
   pipeline's loader with ``LDT_FLUX_TP=spmd`` (W8A8, scan, K3
   interleaved per shard): one missed DiT call against phase 18's one
   device (both ranks bit for bit equal), its launches against the TP plan
   and 114 all-reduces of width 3072; ``pipeline(prompt, 1024, 1024,
   flux_enabled=True)`` with each rank drawing its own seed, rank 0's on
   both, rank 0's PNG only, the final latent against phase 18's at that
   seed, the launches and all-reduces against the plan of the counted
   FBCache hits, the wall time and the device's peak per rank; then
   ``LDT_FLUX_TP=auto``, the same tensor-parallel load, with the
   ``w8a8``, ``flux_scan`` and ``fused_attn`` toggles off (Q8_0, unrolled,
   unfused: K5 and K2 at 12 heads), one missed DiT call against the one
   device's under the same toggles. A rank that fails or runs past
   ``TP_TIMEOUT_S`` fails the phase;
24. the flow-matching trainer (after 23): ``parallel.trainer`` at
   Flux.1-dev's full width in f32 with the depth cut to 2 double and 2
   single blocks (of 19 and 38), a 1024^2 latent and 512 text tokens,
   batch 1 per "data" rank, weights drawn on the card from a seed, AdamW
   at a learning rate of 1e-5 (``TRAIN_LR``). On one
   device: the first step's loss and three gradients, s/step and the peak;
   the loss's backward under ``attention_backend="flash"`` (K2 in the
   forward) must raise the backward guard's error. Then two ranks on the one card over gloo: TP
   1x2 (its first loss within 1e-5 of the one device's, each rank's slice
   of the gradients within 1e-3 relative RMS, the all-reduces a step
   against the plan, five steps fed by ``prefetch_to_mesh`` with the last
   loss below the first, ``save_checkpoint`` after step 2 and
   ``restore_checkpoint`` into a fresh trainer bit for bit, step 3's loss
   within 1e-6 of the uninterrupted run's; scan + remat's first loss
   within 1e-5 and a lower peak), DP 2x1 (both ranks' params equal after a
   step). No training step launches a kernel. A rank that fails or runs
   past ``TP_TIMEOUT_S`` fails the phase;
25. kernel variants (after 24): the op-level flags no pipeline sets, at
   the JAX smoke scripts' shapes (``scripts/smoke_sage.py``,
   ``scripts/smoke_w8a8.py``): ``sage_attention`` with (int8_mxu,
   pv_int8) = (False, True), (True, False) and (False, False) at (8, 8,
   4096, 40), (2, 8, 4096, 80), (2, 8, 1024, 160), (1, 24, 4352, 128) and
   the ragged (2, 8, 1000, 80); ``w8a8_matmul`` with ``int8_mxu=False`` at
   (4352, 3072, 3072), (4352, 3072, 12288), (4352, 12288, 3072) and
   (4352, 3072, 9216), ``w8a8_matmul_stacked`` (the last block of a stack
   of two), ``w8a8_matmul_ep`` and ``w8a8_matmul_ep_stacked`` with the
   residual at (256, 12288, 3072). Every counter set to 0, one call of each
   variant at each shape, the counts read (each variant must launch; every
   earlier path reads each variant's counter too, and it must stay 0); then
   each output against its plain version (the sage variants as K4, the W8A8
   ones at K5's limits, ``quant_matmul.MAX_ULPS`` and ``REL_RMSE_LIMIT``),
   two planted faults each (the last kv tile or K step skipped; sk or cs
   not applied), each variant's preparation's images against
   ``prepare_plain`` with the same flags, int8_mxu=False against K4's
   output and (False, False) against (True, False), which must be equal
   bit for bit, and the W8A8 variants against the integer plain version
   (logged); times beside K4 or K7/K8/K11, the library call
   (``scaled_dot_product_attention``; ``torch._int_mm``, and ``torch.matmul``
   on the codes cast to bf16, the same-rate yardstick) and the bound. The
   variants' SASS is held in the build phase;
26. the UNet's SD2-class branches (after 25): (a) phase 17's checkpoint
   rewritten with every transformer ``proj_in``/``proj_out`` as its
   squeezed 2-D weight and a seeded label embedding (``label_emb.0.0``
   768 -> 1280, ``label_emb.0.2`` 1280 -> 1280; 768 is the pooled CLIP-L
   vector the CFG denoiser passes as ``y``), once with ``label_emb.0.2``
   zeroed and once seeded, each under its own asset root beside phase 17's
   LoRA and embeddings (removed after); ``pipeline(prompt, 1024, 1024)``
   with every default, Python's ``random`` seeded as before phase 17's
   first call: the detected config (linear projections, adm 768), the
   zeroed file's final latent and PNG against phase 17's
   (``TOL_LINEAR_*``), K1 and K2 against phase 17's plan, a timed second
   call, and the seeded file's final latent, which must move; (b) SD2.1's
   UNet (``SD21_UNET``: Stability AI's v2-inference-v.yaml, 64 channels a
   head, linear projections, context 1024) from ``init_params(seed=0)`` in
   bf16 through ``ksample``: 20 karras steps of ``dpmpp_2m_cfgpp`` at
   1024^2, the pipeline's default multi-scale plan, MSW-MSA, CFG 7.5 on a
   seeded (1, 77, 1024) context; K1 at d = 64 at each shape of its plan
   (``sd21_calls``) against its plain version with two planted faults,
   timed beside ``scaled_dot_product_attention`` and the bound; the
   launches against the plan, a timed run, and the final latent against
   the same run on the plain attention route (logged).

Phases 19 to 22 run after phase 17, before the Flux phases; phase 26
after phase 25, from phase 17's files. Phases 5 to
11 pin ``RuntimeConfig(flux_scan=False)``, so their launch plans
are the unrolled layout's. K1's and K2's shapes in phase 3 are those of both
SD1.5 plans (``dpmpp_2m_cfgpp``, ``dpmpp_sde_cfgpp``).

Prints one ``{"kernels": [...]}`` JSON line (``ms``: the kernel's time per
image, summed over its main-path shapes and over the paths it runs on; K7's
and K8's paths are one missed DiT call with ``fused_ew`` off; the flag
variants', which no pipeline reaches, one call at each of phase 25's
shapes), the card's
name and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX. Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # git-ignored

# H100 SXM peaks (NVIDIA data sheet, dense, at the 1.83 GHz the data-sheet
# rates assume): bf16 tensor cores, HBM3, and the special-function units'
# exp2 rate (132 SMs x 16 per clock x 1.83 GHz).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.83e9

# The kernels are held against their plain versions by
# ``flash_attention.agreement`` (its limits are stated there). Two planted
# faults, launched through the same C entry point at every shape, show that
# those limits catch a wrong kernel: each must fail them.
PLANTED_FAULTS = ("q scale without LOG2E", "last kv tile of 64 rows skipped")
Q8_FAULTS = ("last K tile of 64 rows skipped", "neighbouring 32-block's scale row")
FUSED_FAULTS = ("last kv tile of 64 rows skipped", "RoPE sine's sign flipped")
W8A8_FAULTS = ("last K tile of 128 skipped", "neighbouring column's scale")
STACK_FAULTS = ("neighbouring block of the stack", "last K tile skipped")
SAGE_FAULTS = ("last kv tile skipped", "sk not applied")
ROWQ_FAULTS = {"ln_mod": "LayerNorm without the mean subtracted",
               "none": "GELU applied", "gelu": "GELU dropped"}
ROWQ_SCALE_FAULT = "scale of absmax/128"
CONCAT_FAULTS = ("window shifted by 128 lanes", "GELU dropped")
# rel RMSE of the bf16 kernel UNet against the f32 plain-attention UNet
TOL_UNET_REL_RMSE = 5e-2
# rel RMSE of a bf16 Flux block through the kernels against the same block
# in f32 through the plain versions
TOL_FLUX_BLOCK_REL_RMSE = 5e-2
# rel RMSE of the scan layout's outputs against the unrolled layout's at the
# same seed (bit for bit expected and logged; this limit catches a wrong
# block, which moves them by O(1))
TOL_SCAN_REL_RMSE = 1e-2
# device memory the in-place stacking may take above the unrolled models:
# one family's stack at a time (the largest, linear1's, is 2.3 GiB), not a
# second copy of the 12 GB of codes
TOL_STACK_PEAK_GIB = 3.0

KERNELS = {
    "packed_flash_attention": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/packed_flash_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/flash_attention.py:323",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/flash_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/flash_attention.py:113",
    },
    "fused_qkv_attention": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/flash_attention.py:552",
    },
    # K3 with interleaved=True (the TP layout): the same wrapper, counted in
    # its launches_interleaved
    "fused_qkv_attention_interleaved": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/flash_attention.py:552 (interleaved=True, "
                    "index maps :610-617)",
    },
    "quant_matmul": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:258",
    },
    "w8a8_matmul": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:623",
    },
    "row_quantize_fused": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/row_quantize.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:926",
    },
    "row_quantize_concat_gelu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/row_quantize.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:1014",
    },
    "w8a8_matmul_ep": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:1155",
    },
    "sage_attention": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/sage_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/sage_attention.py:152",
    },
    # K4's preparation: the JAX wrapper's one XLA pass before its pallas_call
    "sage_prepare": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/sage_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/sage_attention.py:169",
    },
    "quant_matmul_stacked": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:447",
    },
    "w8a8_matmul_stacked": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:742",
    },
    "w8a8_matmul_ep_stacked": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:1284",
    },
}

# The flag variants of K4 and of K7, K8 and K11 (phase 25): name -> the
# kernels line's fields. A sage row is counted in the wrapper's
# ``VARIANT_COUNTERS[SAGE_VARIANT_FLAGS[name]]``; a W8A8 row "<wrapper>_bf16_mxu"
# in that wrapper's ``launches_bf16`` (``kernel_counters``)
VARIANT_KERNELS = {
    "sage_attention_bf16_mxu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/sage_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/sage_attention.py:152 (int8_mxu=False: "
                    ":69-80, :98-104)",
    },
    "sage_attention_pv_bf16": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/sage_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/sage_attention.py:152 (pv_int8=False: "
                    ":181-191, :111-119)",
    },
    "sage_attention_bf16_mxu_pv_bf16": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/sage_attention.cu",
        "replaces": "lightdiffusion_next_tpu/ops/sage_attention.py:152 (int8_mxu=False, "
                    "pv_int8=False)",
    },
    "w8a8_matmul_bf16_mxu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul_bf16.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:623 (int8_mxu=False: "
                    ":112-124)",
    },
    "w8a8_matmul_stacked_bf16_mxu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul_bf16.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:742 (int8_mxu=False: "
                    ":171-185)",
    },
    "w8a8_matmul_ep_bf16_mxu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul_bf16.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:1155 (int8_mxu=False: "
                    ":1090-1102)",
    },
    "w8a8_matmul_ep_stacked_bf16_mxu": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/w8a8_matmul_bf16.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:1155 (stacked :1284; "
                    "int8_mxu=False: :1090-1102)",
    },
}
# (int8_mxu, pv_int8) of each sage variant
SAGE_VARIANT_FLAGS = {"sage_attention_bf16_mxu": (False, True),
                      "sage_attention_pv_bf16": (True, False),
                      "sage_attention_bf16_mxu_pv_bf16": (False, False)}
# phase 25's shapes: scripts/smoke_sage.py's SD1.5 and Flux attention (:24-29)
# and one ragged length; scripts/smoke_w8a8.py's Flux linears (:24-29) for
# K7, and the text stream's mlp.2 for K8 and K11
VARIANT_SAGE_SHAPES = ((8, 8, 4096, 40), (2, 8, 4096, 80), (2, 8, 1024, 160),
                       (1, 24, 4352, 128), (2, 8, 1000, 80))
VARIANT_W8A8_SHAPES = {"w8a8_matmul_bf16_mxu": ((4352, 3072, 3072), (4352, 3072, 12288),
                                                (4352, 12288, 3072), (4352, 3072, 9216)),
                       "w8a8_matmul_stacked_bf16_mxu": ((256, 12288, 3072),),
                       "w8a8_matmul_ep_bf16_mxu": ((256, 12288, 3072),),
                       "w8a8_matmul_ep_stacked_bf16_mxu": ((256, 12288, 3072),)}
VARIANT_W8A8_FAULTS = ("last K step of 64 skipped", "cs not applied")

# FBCache forced to hit (the hit-path phase): every call the cache may serve
# is served, at most two in a row, so misses between them refresh the cached
# residual
FORCED_HITS = dict(residual_diff_threshold=1e30, max_consecutive_cache_hits=2)

# The MMA opcodes of the SASS: wgmma's (HGMMA bf16, IGMMA int8) and
# mma.sync's (HMMA, IMMA)
MMA_OPCODES = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def sage_opcodes(config):
    """The wgmma opcodes an instantiation of ``sage_attention_kernel<D,
    QK8, PV8>`` (``config``: its mangled template arguments) must hold: K4
    (both true) IGMMA alone; with int8 Q.K^T and bf16 P.V (QK8 alone) IGMMA
    and HGMMA; with bf16 Q.K^T HGMMA alone."""
    qk8, pv8 = (b == "1" for b in re.findall(r"Lb([01])E", config + "E"))
    if qk8 and pv8:
        return ("IGMMA",)
    return ("IGMMA", "HGMMA") if qk8 else ("HGMMA",)


# The wgmma kernels (source, template name, the MMA opcodes every
# instantiation must hold, or a function of its mangled template arguments
# that names them): the build phase fails unless no instantiation spills
# and each one's SASS holds its opcodes and no other of MMA_OPCODES (no
# mma.sync left, no product at another rate)
WGMMA_KERNELS = (("quant_matmul.cu", "quant_matmul_kernel", ("HGMMA",)),
                 ("fused_qkv_attention.cu", "fused_attention_kernel", ("HGMMA",)),
                 ("sage_attention.cu", "sage_attention_kernel", sage_opcodes),
                 ("packed_flash_attention.cu", "flash_wgmma_kernel", ("HGMMA",)),
                 ("packed_flash_attention.cu", "flash_split_kernel", ("HGMMA",)),
                 ("flash_attention.cu", "flash_wgmma_kernel", ("HGMMA",)),
                 ("flash_attention.cu", "flash_split_kernel", ("HGMMA",)),
                 ("w8a8_matmul.cu", "w8a8_matmul_kernel", ("IGMMA",)),
                 ("w8a8_matmul_bf16.cu", "w8a8_bf16_matmul_kernel", ("HGMMA",)))
# Kernels without wgmma whose instantiations must spill nothing either (K9
# and K10 keep a row's f32 values in registers)
NO_SPILL_KERNELS = (("row_quantize.cu", "row_quantize_kernel"),)
# conversions and exps counted in the wgmma kernels' SASS: K4's work per score
# should hold none but MUFU.EX2 (its I2F convert the P.V sums once per
# softmax block)
SASS_COUNTED = ("I2F", "F2I", "FRND", "MUFU.EX2")
# an instruction's opcode in ``cuobjdump --dump-sass``: after its address and
# its predicate, if any
SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Za-z0-9_.]*)")

# The kernel names of the scan layout's stacked operands
STACKED_NAMES = {"quant_matmul": "quant_matmul_stacked", "w8a8_matmul": "w8a8_matmul_stacked",
                 "w8a8_matmul_ep": "w8a8_matmul_ep_stacked"}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# What the 1024^2 path launches, derived from the plans
# --------------------------------------------------------------------------


def unet_calls(add, sigmas, lh, lw, batch=1, sampler="dpmpp_2m_cfgpp", ms=None, msw=True,
               sage=False, hits=None, cfg=None):
    """Add to ``add`` the UNet's K1/K2 (or K4) calls, keyed (kernel, B, H, L,
    D, dtype), of one sampler pass over ``sigmas`` at an lh x lw latent:
    CFG batch 2, each step at full or reduced resolution as the multi-scale
    plan ``ms`` says (None: every step at full resolution),
    ``dpmpp_sde_cfgpp``'s midpoint call (every step but the last) at
    ``sde_sigma_mid`` on its step's route, and with ``msw`` the MSW-MSA
    windowing of level 0 where its sigma gate is open. ``sage``: the calls
    go to K4 and its preparation. ``hits``: FBCache's decision for each
    model call in order (``fbcache.history``); a hit runs input blocks 0
    and 1 only, so its one attention is input block 1's. ``cfg``: the
    UNet's ``UNetConfig`` (SD1.5's by default), which sets the heads."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import unet
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import window
    from lightdiffusion_next_tpu_torch.sampling import samplers
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    msd = ModelSamplingDiscrete()
    steps = len(sigmas) - 1
    mids = samplers._step_consts(sigmas)["sde_sigma_mid"]
    flags = (samplers.fullres_flags(steps, ms, lh, lw) if ms is not None
             else [True] * steps)
    bounds = window.msw_gate_bounds(msd)
    packed = config.get_config().resolve_packed_attn("cuda")
    hits = iter(hits) if hits is not None else None
    cfg = cfg or unet.SD15_CONFIG

    def model_call(sigma, h, w):
        t = msd.timestep(torch.tensor([sigma] * 2 * batch, dtype=torch.float32))
        active = msw and window.msw_step_state(t, bounds)[1]
        hit = hits is not None and next(hits)
        for block, level, ch, depth in unet.attention_blocks(cfg):
            if hit and block != ("input", 1):
                continue
            hh, ww = h, w
            for _ in range(level):
                hh, ww = (hh + 1) // 2, (ww + 1) // 2
            heads, d = cfg.heads_for(ch)
            b, tokens = 2 * batch, hh * ww
            if active and block in window.SD15_BLOCKS:
                b, tokens = 4 * b, (((hh + 1) // 2) * ((ww + 1) // 2))
            if tokens >= 512 and d <= 512:
                name = "packed_flash_attention" if packed and fa.pack_group(d) >= 2 \
                    else "flash_attention"
                if sage:  # K4's wrapper launches the preparation, then K4
                    add(("sage_prepare", b, heads, tokens, d, "bf16"), depth)
                    name = "sage_attention"
                add((name, b, heads, tokens, d, "bf16"), depth)

    for i in range(steps):
        h, w = (lh, lw) if flags[i] else samplers.scaled_dims(lh, lw, ms.factor)
        model_call(sigmas[i], h, w)
        if sampler == "dpmpp_sde_cfgpp" and sigmas[i + 1] > 0:
            model_call(mids[i], h, w)


def vae_call(add, lh, lw, batch=1):
    """The VAE's mid-block attention on an lh x lw latent (encoder or
    decoder): K2 in f32 at d = 512 from 512 tokens."""
    if lh * lw >= 512:
        add(("flash_attention", batch, 1, lh * lw, 512, "f32"), 1)


def attention_calls(width=1024, height=1024, batch=1, steps=20, sage=False,
                    sampler="dpmpp_2m_cfgpp", hits=None):
    """{(kernel, B, H, L, D, dtype): calls per image} for the pipeline's
    SD1.5 txt2img at width x height: 20 karras steps of ``sampler``, the
    default multi-scale plan, MSW-MSA with its sigma gate, CFG batch 2, the
    VAE's mid-block attention (``unet_calls``, ``vae_call``); ``hits``:
    FBCache's decisions."""
    from lightdiffusion_next_tpu_torch.sampling import ksampler, samplers
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    calls = {}
    add = _adder(calls)
    sigmas = ksampler.sigmas_for(ModelSamplingDiscrete(), "karras", steps)
    unet_calls(add, sigmas, height // 8, width // 8, batch, sampler,
               samplers.MultiScale(enabled=True), sage=sage, hits=hits)
    vae_call(add, height // 8, width // 8, batch)
    return calls


def hires_calls(width=1024, height=1024):
    """The calls of ``pipeline(prompt, width, height, hires_fix=True)`` with
    every default: the first pass as ``attention_calls`` gives it for
    ``dpmpp_sde_cfgpp`` without its decode, then the hires pass at twice
    the size: 10 steps of ``euler_ancestral_cfgpp`` over the "normal"
    schedule at denoise 0.45 (full resolution, MSW-MSA with its gate), and
    the decode at twice the size."""
    from lightdiffusion_next_tpu_torch.sampling import ksampler, samplers
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    calls = {}
    add = _adder(calls)
    msd = ModelSamplingDiscrete()
    unet_calls(add, ksampler.sigmas_for(msd, "karras", 20), height // 8, width // 8,
               sampler="dpmpp_sde_cfgpp", ms=samplers.MultiScale(enabled=True))
    lh, lw = (height * 2) // 8, (width * 2) // 8
    unet_calls(add, ksampler.sigmas_for(msd, "normal", 10, denoise=0.45), lh, lw,
               sampler="euler_ancestral_cfgpp")
    vae_call(add, lh, lw)
    return calls


def usdu_tiles(height, width, cfg):
    """(tiles, their model shape (h, w)) of USDU on an upscaled height x
    width image with ``cfg`` (an ``upscaler.USDUConfig``): the redraw grid of
    config tiles, then the seam bands between its rows and between its
    columns; every crop at ceil((tile + 2 * padding) / 8) * 8, clamped to the
    image (the two paddings are equal by default)."""
    rows, cols = -(-height // cfg.tile_height), -(-width // cfg.tile_width)
    seams = (rows - 1) * cols + rows * (cols - 1) if cfg.seam_fix_mode != "none" else 0
    mh = min(-(-(cfg.tile_height + 2 * cfg.padding) // 8) * 8, height // 8 * 8)
    mw = min(-(-(cfg.tile_width + 2 * cfg.padding) // 8) * 8, width // 8 * 8)
    return rows * cols + seams, (mh, mw)


def usdu_calls(width=1024, height=1024):
    """The calls of ``pipeline(png, width, height, img2img=True)`` on a
    width x height PNG: USDU at twice its size with its defaults, each tile
    an encode, 8 steps of ``dpmpp_2m_cfgpp`` (karras; redraw at denoise 0.3,
    seams at 0.2; no multi-scale, no MSW-MSA) and a decode at the model
    tile's latent."""
    from lightdiffusion_next_tpu_torch.pipelines import upscaler
    from lightdiffusion_next_tpu_torch.sampling import ksampler
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    cfg = upscaler.USDUConfig(upscale_by=2.0)
    n_tiles, (mh, mw) = usdu_tiles(2 * height, 2 * width, cfg)
    n_redraw = -(-2 * height // cfg.tile_height) * -(-2 * width // cfg.tile_width)
    calls = {}
    add = _adder(calls)
    msd = ModelSamplingDiscrete()
    for denoise, n in ((0.3, n_redraw), (cfg.seam_fix_denoise, n_tiles - n_redraw)):
        for _ in range(n):
            vae_call(add, mh // 8, mw // 8)
            unet_calls(add, ksampler.sigmas_for(msd, "karras", 8, denoise), mh // 8, mw // 8,
                       msw=False)
            vae_call(add, mh // 8, mw // 8)
    return calls


def predicted_launches(calls):
    out = {name: 0 for name in KERNELS}
    for (name, *_), n in calls.items():
        out[name] += n
    return out


# Flux.1-dev at 1024^2: 4096 image tokens (2048 in a dy call's half-res
# latent: 1024), 256 T5 tokens; hidden 3072, MLP 12288, 24 heads of 128.
FLUX_TXT = 256
FLUX_H, FLUX_MLP, FLUX_HEADS = 3072, 12288, 24


# A double block's matmuls, per stream: (K, N, the prologue fused into its
# row quantization, whether its epilogue adds the residual); then the single
# block's linear1 and linear2
DOUBLE_MATMULS = ((FLUX_H, 3 * FLUX_H, "ln_mod", False),   # qkv
                  (FLUX_H, FLUX_H, "none", True),          # proj
                  (FLUX_H, FLUX_MLP, "ln_mod", False),     # mlp.0
                  (FLUX_MLP, FLUX_H, "gelu", True))        # mlp.2
LINEAR1 = (FLUX_H, 3 * FLUX_H + FLUX_MLP)
LINEAR2 = (FLUX_H + FLUX_MLP, FLUX_H)


def w8a8_matmul_calls(add, rows, k, n, prologue, residual, n_calls, fused_ew):
    """One W8A8 matmul's launches: with ``fused_ew``, K9 with its prologue
    and K11; without it, K9 "none" (K7's row quantization) and K7."""
    if fused_ew:
        add(("row_quantize_fused", prologue, rows, k), n_calls)
        add(("w8a8_matmul_ep", rows, k, n, residual), n_calls)
    else:
        add(("row_quantize_fused", "none", rows, k), n_calls)
        add(("w8a8_matmul", rows, k, n), n_calls)


def flux_dit_calls(img, add, n=1, w8a8=False, fused_ew=True, fused_attn=True):
    """Kernel calls of one DiT call at ``img`` image tokens that misses the
    cache (all 57 blocks), added ``n`` times to the dict ``add``: K5 on
    Q8_0 weights, the W8A8 kernels on W8A8 weights; K3, or with
    ``fused_attn`` off K2 on the (1, 24, joint, 128) heads."""
    joint = img + FLUX_TXT
    for rows in (img, FLUX_TXT):  # 19 double blocks, image and text streams
        for k, nn_, prologue, res in DOUBLE_MATMULS:
            if w8a8:
                w8a8_matmul_calls(add, rows, k, nn_, prologue, res, 19 * n, fused_ew)
            else:
                add(("quant_matmul", rows, k, nn_), 19 * n)
    if not w8a8:
        add(("quant_matmul", joint, *LINEAR1), 38 * n)
        add(("quant_matmul", joint, *LINEAR2), 38 * n)
    else:
        w8a8_matmul_calls(add, joint, *LINEAR1, "ln_mod", False, 38 * n, fused_ew)
        if fused_ew:  # K10 reads linear1's MLP window
            add(("row_quantize_concat_gelu", joint, FLUX_H, LINEAR1[1], 3 * FLUX_H), 38 * n)
            add(("w8a8_matmul_ep", joint, *LINEAR2, True), 38 * n)
        else:
            w8a8_matmul_calls(add, joint, *LINEAR2, "none", True, 38 * n, False)
    if fused_attn:
        add(("fused_qkv_attention", joint, 3 * FLUX_H, FLUX_TXT), 19 * n)
        add(("fused_qkv_attention", joint, 3 * FLUX_H + FLUX_MLP, 0), 38 * n)
    else:
        add(flux_k2_key(joint), 57 * n)


def flux_k2_key(joint):
    """K2's key on the unfused Flux attention at ``joint`` tokens."""
    return ("flash_attention", 1, FLUX_HEADS, joint, 128, "bf16")


def _adder(calls):
    def add(key, n):
        if n:
            calls[key] = calls.get(key, 0) + n
    return add


def stacked(calls):
    """``calls`` in the scan layout: every quantized matmul on its stacked
    kernel (K6, K8, the stacked K11)."""
    return {(STACKED_NAMES.get(key[0], key[0]),) + key[1:]: n for key, n in calls.items()}


def stack_depth(k, n):
    """The depth of the stack a (K, N) weight lies in: T5's 24 blocks, the 38
    single blocks' linear1 and linear2, the 19 double blocks'."""
    if k in (4096, 10240):
        return 24
    if (k, n) in {(kk, nn_) for kk, nn_, _ in TP_DOUBLE}:  # a rank's: double or single
        return 38
    return 38 if (k, n) in (LINEAR1, LINEAR2) else 19


def flux_calls(hits=0, misses=20, dy_calls=2, w8a8=False, scan=False):
    """{(kernel, *shape): calls per image} for the Flux path at 1024^2:
    ``misses`` full-res DiT calls that run every block, ``hits`` that FBCache
    serves after double block 0 (8 matmuls and 1 K3 launch), ``dy_calls``
    half-res calls (always misses), the T5-XXL encode (24 layers x 7 K5) and
    the AE decode (one K2 call). ``w8a8``: the DiT on W8A8 weights with the
    fused elementwise path; ``scan``: the DiT and T5 in the scan layout."""
    if scan:
        return stacked(flux_calls(hits, misses, dy_calls, w8a8))
    calls = {}
    add = _adder(calls)
    flux_dit_calls(4096, add, misses, w8a8)
    flux_dit_calls(1024, add, dy_calls, w8a8)
    for rows in (4096, FLUX_TXT):  # a hit: double block 0 only
        for k, nn_, prologue, res in DOUBLE_MATMULS:
            if w8a8:
                w8a8_matmul_calls(add, rows, k, nn_, prologue, res, hits, True)
            else:
                add(("quant_matmul", rows, k, nn_), hits)
    add(("fused_qkv_attention", 4096 + FLUX_TXT, 3 * FLUX_H, FLUX_TXT), hits)
    for k, nn_, n in ((4096, 4096, 4), (4096, 10240, 2), (10240, 4096, 1)):
        add(("quant_matmul", FLUX_TXT, k, nn_), 24 * n)
    add(("flash_attention", 1, 1, 16384, 512, "f32"), 1)
    return calls


def lora_flux_calls(hits=0, misses=20, dy_calls=2):
    """{(kernel, *shape): calls per image} of the Flux path with a LoRA on
    every block linear of a W8A8 DiT, unrolled, with the unfused attention:
    no quantized matmul has ``modulated_matmul`` (``QTensorLoRA``), so each
    runs K9 "none" and K7; the attention runs K2 at (1, 24, L, 128); a hit
    runs double block 0 (8 matmuls, one K2 launch); T5 unrolled (K5), the
    AE's K2 call."""
    calls = {}
    add = _adder(calls)
    flux_dit_calls(4096, add, misses, w8a8=True, fused_ew=False, fused_attn=False)
    flux_dit_calls(1024, add, dy_calls, w8a8=True, fused_ew=False, fused_attn=False)
    for rows in (4096, FLUX_TXT):
        for k, nn_, prologue, res in DOUBLE_MATMULS:
            w8a8_matmul_calls(add, rows, k, nn_, prologue, res, hits, False)
    add(flux_k2_key(4096 + FLUX_TXT), hits)
    for k, nn_, n in ((4096, 4096, 4), (4096, 10240, 2), (10240, 4096, 1)):
        add(("quant_matmul", FLUX_TXT, k, nn_), 24 * n)
    add(("flash_attention", 1, 1, 16384, 512, "f32"), 1)
    return calls


def unfused_dit_calls(scan=False):
    """Kernel calls of one missed W8A8 DiT call at 1024^2 with ``fused_ew``
    off: K9 "none" and K7 (``scan``: K8) on each of the 228 matmuls, K3."""
    calls = {}
    flux_dit_calls(4096, _adder(calls), 1, w8a8=True, fused_ew=False)
    return stacked(calls) if scan else calls


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_environment():
    import torch

    line = gpu_line()
    log("gpu:", line)
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    return line


def phase_build():
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    report = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(report)} kernels")
    for name, rep in report.items():
        regs = [ln.split("info    :")[-1].strip() for ln in rep["log"].splitlines()
                if "registers" in ln]
        spills = [ln.strip() for ln in rep["log"].splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack")]
        log(f"  {name}: {rep['seconds']:.1f} s; {len(regs)} instantiations; "
            f"{sorted(set(regs))}; spills: {spills or 'none'}")
    for source, kernel, opcodes in WGMMA_KERNELS:
        check_wgmma_build(source, report[source], cuda_build.nvcc_path(), kernel, opcodes)
    for source, kernel in NO_SPILL_KERNELS:
        spilled = spilled_functions(source, report[source], kernel)[1]
        if spilled:
            raise RuntimeError(f"{source}: spills in {spilled}")


def ptxas_functions(build_log):
    """{mangled function: [its ptxas -v lines]} from a build's report."""
    funcs, current = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            current = ln.split("'")[1]
            funcs[current] = []
        elif "Function properties for" in ln:
            current = ln.split("Function properties for")[-1].strip()
            funcs.setdefault(current, [])
        elif current is not None and ("spill" in ln or "registers" in ln):
            funcs[current].append(ln.split("info    :")[-1].strip())
    return funcs


def spilled_functions(source, rep, kernel):
    """The instantiations of ``kernel`` in the build report ``rep`` of
    ``source`` ({mangled name: its ptxas lines}), each logged with its
    registers and spills, and those that spill any bytes."""
    funcs = {f: lines for f, lines in ptxas_functions(rep["log"]).items() if kernel in f}
    if not funcs:
        raise RuntimeError(f"{source}: no {kernel} in the ptxas report")
    spilled = []
    for f, lines in sorted(funcs.items()):
        config = f.split(kernel)[-1].split("EEEv")[0]
        log(f"  {kernel} {config}: {'; '.join(lines)}")
        if any(" 0 bytes spill stores, 0 bytes spill loads" not in ln
               for ln in lines if "spill" in ln):
            spilled.append(f)
    return funcs, spilled


def check_wgmma_build(source, rep, nvcc, kernel, opcodes):
    """A ``wgmma`` kernel's instantiations in the library of ``source``
    (``kernel``: its template's name, e.g. ``quant_matmul_kernel`` for K5
    and K6; ``rep``: the source's build report): log each
    one's registers and spills as ptxas reports them, then read the
    library's SASS (``cuobjdump --dump-sass``) and log each one's MMA
    opcodes and its ``SASS_COUNTED`` instructions. Raises unless every
    instantiation spills 0 bytes and its SASS holds each of ``opcodes``
    (HGMMA, IGMMA; or ``opcodes(config)`` of its template arguments) and
    no other of ``MMA_OPCODES``: no mma.sync (HMMA, IMMA) left."""
    funcs, spilled = spilled_functions(source, rep, kernel)
    for ln in rep["log"].splitlines():
        if "wgmma" in ln:
            log(f"  ptxas: {ln.strip()}")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", rep["path"]], capture_output=True,
                          text=True, check=True).stdout
    counts, bad = {}, []
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name:
            config = name.split(kernel)[-1].split("EEEv")[0]
            want = opcodes(config) if callable(opcodes) else opcodes
            ops = SASS_OPCODE.findall(part)
            mma = {kind: sum(op.startswith(kind + ".") for op in ops) for kind in MMA_OPCODES}
            counts[name] = (mma, {c: sum(op == c or op.startswith(c + ".") or op.startswith(c + "P")
                                         for op in ops) for c in SASS_COUNTED})
            good = all(mma[kind] > 0 for kind in want) and not any(
                mma[kind] for kind in MMA_OPCODES if kind not in want)
            log(f"  SASS {kernel} {config}: {mma} (want {'+'.join(want)} alone: "
                f"{'ok' if good else 'FAIL'}); {counts[name][1]}")
            if not good:
                bad.append(name)
    if spilled or bad or len(counts) != len(funcs):
        raise RuntimeError(f"{source}: spills in {spilled}; SASS off its MMA opcodes in {bad}; "
                           f"{len(counts)} functions in the SASS, {len(funcs)} in the ptxas "
                           "report")


def cuda_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def repeats_for(fn, budget_ms=300.0):
    one = cuda_ms(fn, 1)
    return max(1, min(50, int(budget_ms / max(one, 1e-3))))


def make_inputs(b, h, l, d, dtype, gen):
    """q, k, v as the path hands them over: head-split views of the fused
    q|k|v projection (unwindowed UNet), separate contiguous tensors
    (windowed UNet, the VAE's 1x1 convs)."""
    import torch

    if dtype == "bf16" and b <= 2:
        x = torch.randn((b, l, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        return tuple(t.reshape(b, l, h, d).transpose(1, 2) for t in x.chunk(3, dim=-1))
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    return tuple(
        torch.randn((b, l, h * d), generator=gen, device="cuda").to(tdtype)
        .reshape(b, l, h, d).transpose(1, 2)
        for _ in range(3)
    )


def bound(b, h, l, d, elt):
    flops = 4.0 * b * h * l * l * d
    exps = float(b * h * l * l)
    nbytes = 4.0 * b * h * l * d * elt
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / PEAK_EXP2)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def planted_fault(fault, name, q, k, v):
    """The kernel's output with a fault planted through its C interface."""
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    if fault == PLANTED_FAULTS[0]:
        return fa._launch(name, q, k, v, q_scale=1.0 / math.sqrt(q.shape[-1]))
    return fa._launch(name, q, k[:, :, :-64], v[:, :, :-64])


def phase_kernels(calls, per_kernel=None):
    """K1 and K2 at the (kernel, B, H, L, D, dtype) keys of ``calls``:
    agreement with the plain version, both planted faults, times; folded
    into ``per_kernel`` (a new dict by default)."""
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {} if per_kernel is None else per_kernel
    for (name, b, h, l, d, dtype), n_calls in sorted(calls.items()):
        q, k, v = make_inputs(b, h, l, d, dtype, gen)
        wrapper = getattr(fa, name)
        out = wrapper(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v)
        check = fa.agreement(out, ref)
        faults = {fault: fault_entry(fa.agreement(planted_fault(fault, name, q, k, v), ref))
                  for fault in PLANTED_FAULTS}
        ms = cuda_ms(lambda: wrapper(q, k, v), repeats_for(lambda: wrapper(q, k, v)))
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v), 2)
        lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        library_ms = cuda_ms(lib, repeats_for(lib))
        bound_ms, bound_by = bound(b, h, l, d, q.element_size())
        record_shape(per_kernel, (name, b, h, l, d, dtype), check, faults, {
            "shape": [b, h, l, d], "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return per_kernel


def record_shape(per_kernel, key, check, faults, shape):
    """Log one kernel shape's check, planted faults and times; fold them
    into ``per_kernel[name]``."""
    name = key[0]
    shape = {"key": list(key), **shape, **{k: v for k, v in check.items() if k != "ok"},
             "planted_faults": faults}
    log(f"kernel {name} {shape}")
    entry = per_kernel.setdefault(name, {"shapes": [], "max_abs_err": 0.0, "ok": True})
    entry["shapes"].append(shape)
    entry["max_abs_err"] = max(entry["max_abs_err"], check["max_abs_err"])
    entry["ok"] = entry["ok"] and check["ok"] and all(f["caught"] for f in faults.values())
    if not check["ok"]:
        log(f"FAIL: {name} at {key[1:]} disagrees with its plain version")
    for fault, f in faults.items():
        if not f["caught"]:
            log(f"FAIL: {name} at {key[1:]}: planted fault '{fault}' passes the check")


def fault_entry(bad):
    return {**{k: bad[k] for k in ("max_abs_err", "rel_rmse", "mismatches",
                                   "code_diff_share", "scale_rel_err") if k in bad},
            "caught": not bad["ok"]}


def phase_reference():
    """A full-width SD1.5 UNet forward at a 64x64 latent (512^2), MSW
    windowing on, through the kernels in bf16, against the same params in
    f32 through plain attention."""
    import dataclasses

    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import unet
    from lightdiffusion_next_tpu_torch.models.base import params_to_device
    from lightdiffusion_next_tpu_torch.ops import window

    params = unet.init_params(unet.SD15_CONFIG, seed=3)
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((2, 64, 64, 4), generator=gen).cuda()
    ctx = torch.randn((2, 77, 768), generator=gen).cuda()
    t = torch.tensor([500.0, 500.0], device="cuda")
    override = window.make_msw_msa_override(shift_idx=1)
    outs = {}
    saved = config.get_config()
    try:
        for label, dtype, backend in (("kernels", torch.bfloat16, "flash"),
                                      ("plain", torch.float32, "sdpa")):
            config.set_config(dataclasses.replace(saved, attention_backend=backend))
            cfg = dataclasses.replace(unet.SD15_CONFIG, dtype=dtype)
            p = unet.fuse_projections(params_to_device(params, dtype, torch.device("cuda")))
            with torch.no_grad():
                outs[label] = unet.apply_unet(p, x, t, ctx, cfg=cfg,
                                              attn1_override=override).float()
            del p
            torch.cuda.empty_cache()
    finally:
        config.set_config(saved)
    diff = outs["kernels"] - outs["plain"]
    rel = (diff.pow(2).mean().sqrt() / outs["plain"].pow(2).mean().sqrt()).item()
    ok = math.isfinite(rel) and rel <= TOL_UNET_REL_RMSE
    log(f"reference: UNet 64x64 bf16 kernels vs f32 plain: rel RMSE {rel:.4g} "
        f"(tol {TOL_UNET_REL_RMSE}) {'ok' if ok else 'FAIL'}")
    return ok, rel


def read_png(path):
    """(H, W, C) uint8 from an 8-bit non-interlaced PNG with filter 0 rows
    (what the port's writer produces)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h, color = 8, b"", 0, 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = int.from_bytes(body[0:4], "big"), int.from_bytes(body[4:8], "big")
            color = body[9]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, c)


@functools.lru_cache(maxsize=1)
def seeded_sd15_params():
    """Full-width SD1.5 UNet, VAE and CLIP-L params from seeds 0, 1, 2 (host
    numpy f32, checkpoint keys): phase 5 builds its models from them, phase
    17 writes them into its checkpoint."""
    from lightdiffusion_next_tpu_torch.models import unet
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    return (unet.init_params(unet.SD15_CONFIG, seed=0),
            vae_mod.init_params(vae_mod.SD_VAE, seed=1),
            te.init_params(num_layers=12, width=768, heads=12, seed=2))


def build_models():
    """Full-width SD1.5 UNet, VAE and CLIP-L on the card from seeded random
    weights (seeds 0, 1, 2): (model, vae, clip)."""
    import torch

    from lightdiffusion_next_tpu_torch.models import base
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import facade

    t0 = time.perf_counter()
    unet_p, vae_p, clip_p = seeded_sd15_params()
    model = base.sd15_model(unet_p)
    vae = vae_mod.VAE(vae_p)
    clip = facade.sd1_clip_from_params(
        clip_p, embedding_directory=os.path.join(OUT_DIR, "embeddings"),
    )
    torch.cuda.synchronize()
    log(f"pipeline: built SD1.5 UNet, VAE, CLIP-L from seeds in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, vae, clip


def run_pipeline(models, seed):
    """One ``pipeline(prompt, 1024, 1024, prio_speed=True, autohdr=False)``
    call to a PNG: its paths, wall seconds, the time after each sampler step
    (device synced) and the last step's callback info."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    model, vae, clip = models
    step_times, last = [], {}

    def on_step(info):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        last.update(info)

    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        paths = pl.pipeline(
            "a photograph of an astronaut riding a horse, (detailed:1.2)",
            1024, 1024, prio_speed=True, autohdr=False, model=model,
            clip=clip, vae=vae, seed=seed, output_dir=OUT_DIR,
            progress_callback=on_step,
        )
    torch.cuda.synchronize()
    return {"paths": paths, "wall": time.perf_counter() - start,
            "step_times": step_times, "last": last}


def kernel_counters():
    """{KERNELS or VARIANT_KERNELS name: (its wrapper, the wrapper's counter
    of that kernel)}: K3 counts its proj-major launches in ``launches`` and
    its interleaved ones in ``launches_interleaved``; the flag variants are
    counted apart from their defaults (see VARIANT_KERNELS)."""
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    wrappers = {"packed_flash_attention": fa.packed_flash_attention,
                "flash_attention": fa.flash_attention,
                "fused_qkv_attention": fa.fused_qkv_attention,
                "quant_matmul": qm.quant_matmul,
                "w8a8_matmul": qm.w8a8_matmul,
                "row_quantize_fused": qm.row_quantize_fused,
                "row_quantize_concat_gelu": qm.row_quantize_concat_gelu,
                "w8a8_matmul_ep": qm.w8a8_matmul_ep,
                "sage_attention": sa.sage_attention,
                "sage_prepare": sa.prepare_kernel,
                "quant_matmul_stacked": qm.quant_matmul_stacked,
                "w8a8_matmul_stacked": qm.w8a8_matmul_stacked,
                "w8a8_matmul_ep_stacked": qm.w8a8_matmul_ep_stacked}
    counters = {name: (fn, "launches") for name, fn in wrappers.items()}
    counters["fused_qkv_attention_interleaved"] = (fa.fused_qkv_attention,
                                                   "launches_interleaved")
    for name in VARIANT_KERNELS:
        if name in SAGE_VARIANT_FLAGS:
            counters[name] = (sa.sage_attention, sa.VARIANT_COUNTERS[SAGE_VARIANT_FLAGS[name]])
        else:
            counters[name] = (wrappers[name.removesuffix("_bf16_mxu")], "launches_bf16")
    return counters


def reset_launches():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def check_sd15_output(run, model, vae, label):
    """What came out of an SD1.5 pipeline call: a finite latent of the right
    shape, finite pixels that are not all one value, and the PNG holding
    exactly those pixels at 1024 x 1024 x 3."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    x = run["last"]["x"]
    latent_ok = tuple(x.shape) == (1, 128, 128, 4) and bool(torch.isfinite(x).all())
    with torch.no_grad():
        pixels = vae.decode(model.latent_format.process_out(x))
    pixels_ok = bool(torch.isfinite(pixels).all()) and float(pixels.std()) > 0
    png = read_png(run["paths"][0])
    png_ok = png.shape == (1024, 1024, 3) and np.array_equal(
        png, image_utils.to_uint8(pixels.cpu().numpy())[0])
    log(f"{label} output: latent {tuple(x.shape)} finite={latent_ok}, pixels finite and "
        f"not constant={pixels_ok}, png {png.shape} matches decode={png_ok}, "
        f"pixel mean {png.mean():.2f} std {png.std():.2f}")
    return latent_ok and pixels_ok and png_ok


def check_sd15_launches(launches, calls, label, used):
    """The launches against the plan; the kernels in ``used`` must launch."""
    predicted = predicted_launches(calls)
    ok = True
    for name in KERNELS:
        good = launches[name] == predicted[name] and (launches[name] > 0 or name not in used)
        ok = ok and good
        log(f"launches {label} {name}: {launches[name]} (plan predicts {predicted[name]}) "
            f"{'ok' if good else 'FAIL'}")
    return ok


def timed_sd15_run(models, label):
    import torch

    torch.cuda.reset_peak_memory_stats()
    timed = run_pipeline(models, 5678)
    steps = timed["step_times"]
    n = len(steps)
    it_s = (n - 1) / (steps[-1] - steps[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label} timed run: {timed['wall']:.3f} s/image end to end; sampler "
        f"steps 2..{n}: {it_s:.3f} it/s; peak memory {peak:.1f} GiB")
    return {"s_per_image": timed["wall"], "it_per_s": it_s, "peak_gib": peak}


def phase_pipeline(calls):
    """The SD1.5 pipeline. Returns (ok, launches, e2e, the models, the first
    run's final latent)."""
    models = build_models()
    model, vae, _ = models
    reset_launches()
    first = run_pipeline(models, 1234)
    launches = read_launches()
    ok = check_sd15_launches(launches, calls, "SD1.5",
                             ("packed_flash_attention", "flash_attention"))
    ok = check_sd15_output(first, model, vae, "SD1.5") and ok
    e2e = timed_sd15_run(models, "pipeline")
    log(f"pipeline: first run {first['wall']:.3f} s/image")
    e2e["first_run_s_per_image"] = first["wall"]
    return ok, launches, e2e, models, first["last"]["x"]


def sage_bound(b, h, lq, lk, d):
    """K4's least time: int8 operations at the int8 tensor-core rate and one
    exp per score at the SFU rate, or the bytes of bf16 q, k, v and out."""
    ops = 4.0 * b * h * lq * lk * d
    exps = float(b * h * lq * lk)
    nbytes = 2.0 * b * h * d * (2 * lq + 2 * lk)
    t_ops = max(ops / PEAK_INT8_OPS, exps / PEAK_EXP2)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def prepare_bound(b, h, lq, lk, d):
    """The preparation's least time at the HBM rate: bf16 q, k and v read
    once; d-wide q, k and v codes, f32 sq and sk, svs and vmu written once
    (the images' padding is the layout's, not the function's)."""
    nbytes = (2.0 * b * h * d * (lq + 2 * lk) + b * h * (lq * (d + 4) + lk * (2 * d + 4))
              + 2.0 * b * h * d * 4)
    return nbytes / PEAK_HBM_BYTES * 1e3, "bytes"


# one ragged shape beside the path's: a masked kv tail and a partial q tile
SAGE_RAGGED = ("sage_attention", 2, 8, 1000, 80, "bf16")


def phase_sage_kernels(calls, per_kernel):
    """K4 at every UNet shape of the sage path and one ragged shape: the
    wrapper (the preparation kernel, then K4) against its plain version, two
    faults planted through the C interface, times (the wrapper, K4 alone, the
    plain version, ``scaled_dot_product_attention``); the preparation kernel
    against ``prepare_plain`` (``sage_attention.prep_agreement``: codes and
    scales) and timed alone and beside its plain version."""
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(5)

    def check(out, ref):
        return fa.agreement(out, ref, max_ulps=sa.MAX_ULPS, rel_rmse_limit=sa.REL_RMSE_LIMIT)

    def timed(fn):
        return cuda_ms(fn, repeats_for(fn))

    for key in sorted(k for k in calls if k[0] == "sage_attention") + [SAGE_RAGGED]:
        _, b, h, l, d, dtype = key
        q, k, v = make_inputs(b, h, l, d, dtype, gen)
        out = sa.sage_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.sage_attention_plain(q, k, v)
        ops = sa.prepare_kernel(q, k, v)
        ops_ref = sa.prepare_plain(q, k, v)
        kt = ops.kvimg.shape[1]
        faults = {
            SAGE_FAULTS[0]: fault_entry(check(sa._launch(q, ops, kv_tiles=kt - 1), ref)),
            SAGE_FAULTS[1]: fault_entry(check(sa._launch(q, ops, use_sk=False), ref)),
        }
        ms = timed(lambda: sa.sage_attention(q, k, v))
        kernel_ms = timed(lambda: sa._launch(q, ops))
        prep_ms = timed(lambda: sa.prepare_kernel(q, k, v))
        plain_ms = cuda_ms(lambda: sa.sage_attention_plain(q, k, v), 1)
        prep_plain_ms = cuda_ms(lambda: sa.prepare_plain(q, k, v), 2)
        library_ms = timed(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = sage_bound(b, h, l, l, d)
        record_shape(per_kernel, key, check(out, ref), faults, {
            "shape": [b, h, l, d], "dtype": "bf16 in and out, int8 codes", "ms": ms,
            "kernel_ms": kernel_ms, "prepare_ms": prep_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        prep_bound_ms, prep_bound_by = prepare_bound(b, h, l, l, d)
        record_shape(per_kernel, ("sage_prepare",) + key[1:],
                     sa.prep_agreement(ops, ops_ref, d), {}, {
                         "shape": [b, h, l, d], "dtype": "bf16 in, int8 codes and f32 scales",
                         "ms": prep_ms, "plain_ms": prep_plain_ms, "library_ms": None,
                         "bound_ms": prep_bound_ms, "bound_by": prep_bound_by})
        del q, k, v, out, ref, ops, ops_ref
        torch.cuda.empty_cache()
    return per_kernel


def phase_sage_pipeline(models, flash_latent):
    """Phase 5's models with ``sage_attention`` on: the same pipeline call
    (every UNet K1 and K2 call on K4, the VAE's on K2), the output checked,
    the final latent against the flash run of the same seed (logged, not
    held to a limit), a timed run. Returns (ok, launches, e2e, calls)."""
    calls = attention_calls(sage=True)
    model, vae, _ = models
    with runtime_config(sage_attention=True):
        reset_launches()
        first = run_pipeline(models, 1234)
        launches = read_launches()
        ok = check_sd15_launches(launches, calls, "SD1.5 sage",
                                 ("sage_attention", "sage_prepare", "flash_attention"))
        ok = check_sd15_output(first, model, vae, "SD1.5 sage") and ok
        x = first["last"]["x"]
        drift = ((x - flash_latent).pow(2).mean().sqrt()
                 / flash_latent.pow(2).mean().sqrt()).item()
        log(f"SD1.5 sage: final latent against the flash run of the same seed: rel RMSE "
            f"{drift:.4g} (logged only)")
        e2e = timed_sd15_run(models, "SD1.5 sage pipeline")
    log(f"SD1.5 sage: first run {first['wall']:.3f} s/image")
    e2e.update(first_run_s_per_image=first["wall"], latent_drift_vs_flash=drift)
    return ok, launches, e2e, calls


# --------------------------------------------------------------------------
# SD1.5 with every default, from a checkpoint file
# --------------------------------------------------------------------------

DEFAULTS_DIR = os.path.join(OUT_DIR, "defaults")  # its own asset root
DEFAULTS_CKPT = os.path.join(DEFAULTS_DIR, "checkpoints", "Meina V10 - baked VAE.safetensors")
DEFAULTS_PROMPT = "a photograph of an astronaut riding a horse, (detailed:1.2)"
# Python's random, seeded before phase 17's first call and phase 26's calls
# that are compared with it: the pipeline draws its seed from it
DEFAULTS_RANDOM_SEED = 17
# the four textual-inversion embeddings DEFAULT_NEGATIVE names, with the
# vector counts of their published files
EMBEDDING_VECTORS = {"EasyNegative": 8, "badhandv4": 6, "lr": 2,
                     "ng_deepnegative_v1_75t": 75}
LORA_RANK = 8
LORA_TARGETS = re.compile(
    r"(transformer_blocks\.\d+\.(attn[12]\.(to_[qkv]|to_out\.0)|ff\.net\.(0\.proj|2))"
    r"|layers\.\d+\.(self_attn\.(q|k|v|out)_proj|mlp\.fc[12]))\.weight$")
ST_DTYPES = {"float16": "F16", "float32": "F32", "bfloat16": "BF16"}


def write_safetensors(path, tensors):
    """A ``.safetensors`` file from CPU tensors, without the safetensors
    package: the header's length (8 bytes, little-endian), the JSON header
    padded to 8 bytes, the tensors' bytes in order."""
    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": ST_DTYPES[str(t.dtype).split(".")[-1]],
                       "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy()))


def write_default_assets():
    """The checkpoint (phase 5's seeded UNet, VAE and CLIP-L in f16 under
    the checkpoint's keys), a seeded Kohya add_detail LoRA over every
    attention and feed-forward linear of the UNet and CLIP, and the four
    embeddings as A1111 .pt files. Returns (the checkpoint's f16 tensors by
    part, the LoRA's module count by model, the embeddings' vectors)."""
    import numpy as np
    import torch

    unet_p, vae_p, clip_p = seeded_sd15_params()
    parts = {"unet": {k: torch.from_numpy(np.asarray(v, np.float16)) for k, v in unet_p.items()},
             "vae": {k: torch.from_numpy(np.asarray(v, np.float16)) for k, v in vae_p.items()},
             "clip": {k: torch.from_numpy(np.asarray(v, np.float16)) for k, v in clip_p.items()}}
    prefixes = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                "clip": "cond_stage_model.transformer."}
    write_safetensors(DEFAULTS_CKPT, {prefixes[part] + k: v for part, sd in parts.items()
                                      for k, v in sd.items()})

    gen = torch.Generator().manual_seed(7)
    lora, modules = {}, {"unet": 0, "clip": 0}
    for part, tag in (("unet", "lora_unet_"), ("clip", "lora_te_")):
        for key, w in parts[part].items():
            if not LORA_TARGETS.search(key):
                continue
            name = tag + key[: -len(".weight")].replace(".", "_")
            out_f, in_f = w.shape
            lora[f"{name}.lora_down.weight"] = (
                torch.randn(LORA_RANK, in_f, generator=gen) * in_f**-0.5).half()
            lora[f"{name}.lora_up.weight"] = (
                torch.randn(out_f, LORA_RANK, generator=gen) * 0.01).half()
            lora[f"{name}.alpha"] = torch.tensor(LORA_RANK / 2, dtype=torch.float16)
            modules[part] += 1
    write_safetensors(os.path.join(DEFAULTS_DIR, "loras", "add_detail.safetensors"), lora)

    vectors = {}
    os.makedirs(os.path.join(DEFAULTS_DIR, "embeddings"), exist_ok=True)
    for name, n in EMBEDDING_VECTORS.items():
        vectors[name] = torch.randn(n, 768, generator=gen) * 0.02
        torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": vectors[name]},
                    "name": name, "step": 1000},
                   os.path.join(DEFAULTS_DIR, "embeddings", f"{name}.pt"))
    return parts, modules, vectors


class LogRecords(logging.Handler):
    """The port's log messages while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def count(self, prefix):
        return sum(m.startswith(prefix) for m in self.messages)


def run_default_pipeline(prompt=DEFAULTS_PROMPT, out="out", **kw):
    """``pipeline(prompt, 1024, 1024, output_dir=..., **kw)`` with every
    other argument at its default and no models: paths, wall seconds, the
    time and latent shape after each step (device synced) and the last
    step's callback info."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    step_times, shapes, last = [], [], {}

    def on_step(info):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        shapes.append(tuple(info["x"].shape))
        last.update(info)

    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        paths = pl.pipeline(prompt, 1024, 1024, output_dir=os.path.join(DEFAULTS_DIR, out),
                            progress_callback=on_step, **kw)
    torch.cuda.synchronize()
    return {"paths": paths, "wall": time.perf_counter() - start,
            "step_times": step_times, "shapes": shapes, "last": last}


def check_loaded_params(model, vae, clip, parts):
    """Every UNet, VAE and CLIP parameter the loader built equals the
    f16-rounded seed cast to the device policy's dtype, bit for bit (the
    UNet's q|k|v and k|v joined as ``sd15_model`` joins them)."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import unet

    policy = config.DtypePolicy.for_device("cuda")
    dev = torch.device("cuda")
    bad, n = [], 0
    for got, want, dtype in ((model.params, unet.fuse_projections(parts["unet"]),
                              policy.param_dtype),
                             (vae.params, parts["vae"], policy.vae_dtype),
                             (clip.model.model.params, parts["clip"],
                              policy.text_encoder_dtype)):
        if set(got) != set(want):
            bad.append(f"keys differ: {sorted(set(got) ^ set(want))[:4]}")
        for key, w in want.items():
            n += 1
            g = got.get(key)
            if g is None or g.dtype != dtype or not torch.equal(g, w.to(dev).to(dtype)):
                bad.append(key)
    log(f"SD1.5 defaults: {n} loaded params against the f16-rounded seeds: "
        f"{'bit for bit' if not bad else f'FAIL: {len(bad)} differ, e.g. {bad[:3]}'}")
    return not bad


def check_embeddings(clip, vectors):
    """DEFAULT_NEGATIVE's token rows carry the four embeddings' vectors, in
    order, and the encoder's rows put them in their slots."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    rows = clip.tokenize(pl.DEFAULT_NEGATIVE)["l"]
    tokens = [[t for t, _ in row] for row in rows]
    found = [torch.from_numpy(t) for row in tokens for t in row if not isinstance(t, int)]
    want = torch.cat([vectors[n] for n in EMBEDDING_VECTORS])
    ok = len(found) == len(want) and torch.equal(torch.stack(found), want)
    embeds, ids = clip.model.model._embed_rows(tokens)
    ok = ok and torch.equal(embeds[ids < 0].float().cpu(), want.to(embeds.dtype).float())
    log(f"SD1.5 defaults: negative prompt {len(rows)} rows, {len(found)} embedding vectors "
        f"(the four files hold {len(want)}) {'ok' if ok else 'FAIL'}")
    return ok


def check_hdr_output(run, vae, size=1024, label="SD1.5 defaults"):
    """A finite final latent of a size x size image, and the PNG equal to
    to_uint8(apply_hdr_batch(decode(latent)))."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import hdr
    from lightdiffusion_next_tpu_torch.utils import image as image_utils
    from lightdiffusion_next_tpu_torch.utils import latent as latent_mod

    x = run["last"]["x"]
    latent_ok = (tuple(x.shape) == (1, size // 8, size // 8, 4)
                 and bool(torch.isfinite(x).all()))
    with torch.no_grad():
        pixels = vae.decode(latent_mod.SD15.process_out(x))
        shaped = hdr.apply_hdr_batch(pixels)
    want = image_utils.to_uint8(shaped.cpu().numpy())[0]
    png = read_png(run["paths"][0])
    png_ok = png.shape == (size, size, 3) and np.array_equal(png, want)
    changed = not np.array_equal(want, image_utils.to_uint8(pixels.cpu().numpy())[0])
    log(f"{label} output: latent {tuple(x.shape)} finite={latent_ok}, png {png.shape} "
        f"matches the AutoHDR of the decode={png_ok} (AutoHDR changed it: {changed}), "
        f"pixel mean {png.mean():.2f} std {png.std():.2f}")
    return latent_ok and png_ok and changed, pixels


def phase_sd15_defaults(gpu):
    """Phase 17: SD1.5 from a checkpoint file with every default, its first
    call after Python's ``random`` is seeded (``DEFAULTS_RANDOM_SEED``), so
    phase 26 can draw the same seed. Returns (ok, launches, e2e, calls, the
    first call's final latent and PNG)."""
    import random

    import torch

    from lightdiffusion_next_tpu_torch.app import cli
    from lightdiffusion_next_tpu_torch.pipelines import loader
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl
    from lightdiffusion_next_tpu_torch.sampling import ksampler, noise
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete
    from lightdiffusion_next_tpu_torch.utils import hdr

    calls = attention_calls(sampler="dpmpp_sde_cfgpp")
    t0 = time.perf_counter()
    parts, modules, vectors = write_default_assets()
    gb = os.path.getsize(DEFAULTS_CKPT) / 1e9
    log(f"SD1.5 defaults: wrote the {gb:.3f} GB checkpoint, the LoRA ({modules['unet']} UNet "
        f"and {modules['clip']} CLIP modules) and {len(vectors)} embeddings in "
        f"{time.perf_counter() - t0:.1f} s")
    saved_env = {k: os.environ.get(k) for k in ("LDT_ASSET_ROOT", "LDT_OFFLINE")}
    os.environ.update(LDT_ASSET_ROOT=DEFAULTS_DIR, LDT_OFFLINE="1")
    records = LogRecords()
    port_log = logging.getLogger("lightdiffusion_next_tpu_torch")
    port_log.addHandler(records)
    port_log.setLevel(logging.INFO)
    try:
        reset_launches()
        random.seed(DEFAULTS_RANDOM_SEED)
        first = run_default_pipeline()
        launches = read_launches()
        ok = check_sd15_launches(launches, calls, "SD1.5 defaults",
                                 ("packed_flash_attention", "flash_attention"))
        n_lora = sum(modules.values())
        lora_msg = (f"LoRA: {modules['unet']} UNet and {modules['clip']} CLIP modules patched "
                    f"of the file's {n_lora}")
        lora_ok = lora_msg in records.messages and records.count("LoRA ") == 0
        log(f"SD1.5 defaults: LoRA merged with every module matched: "
            f"{'ok' if lora_ok else 'FAIL'} ({[m for m in records.messages if 'LoRA' in m]})")
        model, clip, vae = loader.CheckpointLoaderSimple().load_checkpoint(
            DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
        ok = ok and lora_ok and records.count("loaded ") == 1
        ok = check_loaded_params(model, vae, clip, parts) and ok
        del parts
        ok = check_embeddings(clip, vectors) and ok
        out_ok, pixels = check_hdr_output(first, vae)
        ok = out_ok and ok

        torch.cuda.reset_peak_memory_stats()
        timed = run_default_pipeline()
        steps = timed["step_times"]
        it_s = (len(steps) - 1) / (steps[-1] - steps[0])
        peak = torch.cuda.max_memory_allocated() / 2**30

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = loader.load_checkpoint_guess_config(DEFAULTS_CKPT, os.path.join(
            DEFAULTS_DIR, "embeddings"))
        load_s = time.perf_counter() - t0
        del fresh
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = pl._apply_lora_add_detail(model, clip)
        torch.cuda.synchronize()
        lora_s = time.perf_counter() - t0
        del merged
        sigmas = ksampler.sigmas_for(ModelSamplingDiscrete(), "karras", 20)
        t0 = time.perf_counter()
        noise.sde_noise_for_steps((1, 128, 128, 4), sigmas, 0.5, 1.0, 1234)
        noise_ms = (time.perf_counter() - t0) * 1e3
        hdr_ms = cuda_ms(lambda: hdr.apply_hdr_batch(pixels), 5)

        n_loaded = records.count("loaded ")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([DEFAULTS_PROMPT, "1024", "1024", "1", "1", "--output-dir",
                           os.path.join(DEFAULTS_DIR, "cli")])
        cli_s = time.perf_counter() - t0
        printed = out.getvalue().split()
        cli_ok = (rc == 0 and len(printed) == 1 and printed[0].endswith(".png")
                  and os.path.exists(printed[0]) and records.count("loaded ") == n_loaded
                  and read_png(printed[0]).shape == (1024, 1024, 3))
        log(f"SD1.5 defaults CLI: printed {printed}, from the cached model (loads "
            f"{records.count('loaded ')}): {'ok' if cli_ok else 'FAIL'}; {cli_s:.3f} s")
        ok = ok and cli_ok
    finally:
        port_log.removeHandler(records)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    loader.get_model_cache().clear()
    e2e = {"s_per_image": timed["wall"], "it_per_s": it_s, "peak_gib": peak,
           "first_run_s_per_image_with_load": first["wall"], "load_s": load_s,
           "load_gb_per_s": gb / load_s, "checkpoint_gb": gb, "lora_merge_s": lora_s,
           "brownian_noise_ms": noise_ms, "autohdr_ms_per_image": hdr_ms,
           "cli_s_per_image": cli_s, "gpu": gpu, "png": first["paths"][0]}
    log(f"SD1.5 defaults ({gpu}): {timed['wall']:.3f} s/image end to end; sampler steps "
        f"2..{len(steps)}: {it_s:.3f} it/s (two model calls each); first run with the load "
        f"{first['wall']:.3f} s/image; checkpoint load {load_s:.3f} s ({gb / load_s:.3f} "
        f"GB/s); LoRA merge {lora_s:.3f} s; Brownian noise {noise_ms:.1f} ms; AutoHDR "
        f"{hdr_ms:.3f} ms per image; peak memory {peak:.1f} GiB")
    return ok, launches, e2e, calls, (first["last"]["x"].float().cpu(), first["paths"][0])


# --------------------------------------------------------------------------
# SD1.5 hires-fix and img2img (phases 19 and 20), from phase 17's files
# --------------------------------------------------------------------------

# K1 at the hires pass's level 0 with MSW-MSA off (``hidiffusion=False``):
# not on the default path, whose gate is open at every hires sigma, but
# checked beside it
HIRES_UNWINDOWED = ("packed_flash_attention", 2, 8, 65536, 40, "bf16")
ESRGAN_PATH = os.path.join(DEFAULTS_DIR, "ESRGAN", "RealESRGAN_x4plus.pth")


def new_shapes(calls, per_kernel):
    """The keys of ``calls`` that no earlier phase checked."""
    seen = {tuple(s_["key"]) for entry in per_kernel.values() for s_ in entry["shapes"]}
    return {k: n for k, n in calls.items() if k not in seen}


@contextlib.contextmanager
def defaults_assets(root=DEFAULTS_DIR):
    """Phase 17's asset root (or ``root``) as ``LDT_ASSET_ROOT``, offline,
    and the port's log records while inside."""
    saved_env = {k: os.environ.get(k) for k in ("LDT_ASSET_ROOT", "LDT_OFFLINE")}
    os.environ.update(LDT_ASSET_ROOT=root, LDT_OFFLINE="1")
    records = LogRecords()
    port_log = logging.getLogger("lightdiffusion_next_tpu_torch")
    port_log.addHandler(records)
    port_log.setLevel(logging.INFO)
    try:
        yield records
    finally:
        port_log.removeHandler(records)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli_process(args, out_dir, size):
    """``python3 -m lightdiffusion_next_tpu_torch.app.cli *args`` as a process
    from phase 17's asset root: ok when it exits 0 and prints one PNG path
    whose image is size x size x 3 and not constant. Returns (ok, seconds)."""
    env = dict(os.environ, LDT_ASSET_ROOT=DEFAULTS_DIR, LDT_OFFLINE="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lightdiffusion_next_tpu_torch.app.cli",
                           *args, "--output-dir", out_dir], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    printed = proc.stdout.split()
    ok = proc.returncode == 0 and len(printed) == 1 and os.path.exists(printed[0])
    shape, std = None, 0.0
    if ok:
        png = read_png(printed[0])
        shape, std = png.shape, float(png.std())
        ok = shape == (size, size, 3) and std > 0
    log(f"CLI process {args[1:]}: exit {proc.returncode}, printed {printed}, png {shape} "
        f"std {std:.2f} {'ok' if ok else 'FAIL'}; {seconds:.3f} s")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
    return ok, seconds


def phase_hires(gpu, per_kernel):
    """Phase 19: ``pipeline(prompt, 1024, 1024, hires_fix=True)`` with every
    default from phase 17's files. Returns (ok, launches, e2e, calls)."""
    import random

    import torch

    from lightdiffusion_next_tpu_torch.pipelines import loader

    calls = hires_calls()
    log("plan SD1.5 hires-fix:", {f"{k[0]} {k[1:]}": v for k, v in sorted(calls.items())})
    phase_kernels({**new_shapes(calls, per_kernel), HIRES_UNWINDOWED: 0}, per_kernel)
    with defaults_assets():
        reset_launches()
        random.seed(19)
        first = run_default_pipeline(out="hires", hires_fix=True)
        launches = read_launches()
        ok = check_sd15_launches(launches, calls, "SD1.5 hires-fix",
                                 ("packed_flash_attention", "flash_attention"))
        shapes_ok = first["shapes"] == [(1, 128, 128, 4)] * 20 + [(1, 256, 256, 4)] * 10
        log(f"SD1.5 hires-fix: 20 steps at 128^2 then 10 at 256^2: "
            f"{'ok' if shapes_ok else 'FAIL: ' + str(sorted(set(first['shapes'])))}")
        _, _, vae = loader.CheckpointLoaderSimple().load_checkpoint(
            DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
        out_ok, _ = check_hdr_output(first, vae, 2048, "SD1.5 hires-fix")
        ok = ok and shapes_ok and out_ok and "HiresFix" in first["paths"][0]
        torch.cuda.reset_peak_memory_stats()
        random.seed(20)
        timed = run_default_pipeline(out="hires", hires_fix=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
    hires_t = timed["step_times"][20:]
    hires_it_s = (len(hires_t) - 1) / (hires_t[-1] - hires_t[0])
    cli_ok, cli_s = run_cli_process([DEFAULTS_PROMPT, "1024", "1024", "--hires-fix"],
                                    os.path.join(DEFAULTS_DIR, "cli_hires"), 2048)
    e2e = {"s_per_image": timed["wall"], "hires_pass_it_per_s": hires_it_s, "peak_gib": peak,
           "first_run_s_per_image_with_load": first["wall"], "cli_process_s": cli_s, "gpu": gpu}
    log(f"SD1.5 hires-fix ({gpu}): {timed['wall']:.3f} s/image end to end (1024^2 then "
        f"2048^2); hires pass steps 2..10: {hires_it_s:.3f} it/s; first run with the load "
        f"{first['wall']:.3f} s; peak memory {peak:.1f} GiB; CLI process {cli_s:.3f} s")
    return ok and cli_ok, launches, e2e, calls


def write_esrgan():
    """A seeded ESRGAN at RealESRGAN_x4plus's width (23 RRDB blocks, nf 64,
    gc 32) as a flat f32 state dict under the RealESRGAN keys, which both
    packages' loaders read. Returns its bytes."""
    import torch

    from lightdiffusion_next_tpu_torch.models import esrgan

    os.makedirs(os.path.dirname(ESRGAN_PATH), exist_ok=True)
    params = esrgan.init_params(num_body=23, nf=64, gc=32, seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in params.items()}, ESRGAN_PATH)
    return os.path.getsize(ESRGAN_PATH)


def phase_img2img(gpu, per_kernel, png):
    """Phase 20: ``pipeline(png, 1024, 1024, img2img=True)`` from phase 17's
    files and a seeded ESRGAN file, on phase 17's 1024^2 PNG. Returns (ok,
    launches, e2e, calls)."""
    import random

    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import loader, upscaler
    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    calls = usdu_calls()
    n_tiles, (mh, mw) = usdu_tiles(2048, 2048, upscaler.USDUConfig(upscale_by=2.0))
    log(f"plan SD1.5 img2img: {n_tiles} USDU tiles of {mh}x{mw}:",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(calls.items())})
    phase_kernels(new_shapes(calls, per_kernel), per_kernel)
    mb = write_esrgan() / 1e6
    with defaults_assets() as records:
        reset_launches()
        random.seed(21)
        first = run_default_pipeline(png, out="img2img", img2img=True)
        launches = read_launches()
        ok = check_sd15_launches(launches, calls, "SD1.5 img2img",
                                 ("packed_flash_attention", "flash_attention"))
        steps_ok = first["shapes"] == [(1, mh // 8, mw // 8, 4)] * (8 * n_tiles)
        out = read_png(first["paths"][0])
        out_ok = (out.shape == (2048, 2048, 3) and float(out.std()) > 0
                  and bool(torch.isfinite(first["last"]["x"]).all())
                  and "Img2Img" in first["paths"][0])
        log(f"SD1.5 img2img: {len(first['shapes'])} sampler steps of {n_tiles} tiles at "
            f"{sorted(set(first['shapes']))}: {'ok' if steps_ok else 'FAIL'}; png {out.shape} "
            f"mean {out.mean():.2f} std {out.std():.2f}: {'ok' if out_ok else 'FAIL'}")
        torch.cuda.reset_peak_memory_stats()
        random.seed(22)
        timed = run_default_pipeline(png, out="img2img", img2img=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        esrgan_loads = records.count(f"loaded {ESRGAN_PATH}")
        cache_ok = esrgan_loads == 1
        log(f"SD1.5 img2img: ESRGAN loaded {esrgan_loads} time(s) in two runs "
            f"{'ok' if cache_ok else 'FAIL'}")
        ok = ok and steps_ok and out_ok and cache_ok

        up_model = loader.load_upscale_model(ESRGAN_PATH)
        _, _, vae = loader.CheckpointLoaderSimple().load_checkpoint(
            DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
        image = torch.from_numpy(image_utils.load_image(png)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = up_model.upscale(image)
        torch.cuda.synchronize()
        esrgan_ms = (time.perf_counter() - t0) * 1e3
        crop = up[:, :2 * mh:2, :2 * mw:2].contiguous()
        with torch.no_grad():
            latent = vae.encode(crop)
            encode_ms = cuda_ms(lambda: vae.encode(crop), 3)
            decode_ms = cuda_ms(lambda: vae.decode(latent), 3)
        del up, crop, latent
    cli_ok, cli_s = run_cli_process([png, "1024", "1024", "--img2img"],
                                    os.path.join(DEFAULTS_DIR, "cli_img2img"), 2048)
    e2e = {"s_per_image": timed["wall"], "first_run_s_per_image_with_load": first["wall"],
           "tiles": n_tiles, "tile_px": [mh, mw], "esrgan_ms": esrgan_ms,
           "esrgan_file_mb": mb, "vae_encode_ms_per_tile": encode_ms,
           "vae_decode_ms_per_tile": decode_ms, "peak_gib": peak, "cli_process_s": cli_s,
           "gpu": gpu}
    log(f"SD1.5 img2img ({gpu}): {timed['wall']:.3f} s/image end to end (1024^2 PNG to "
        f"2048^2); first run with the ESRGAN load {first['wall']:.3f} s; {n_tiles} tiles of "
        f"{mh}x{mw}; ESRGAN x4 of the 1024^2 image {esrgan_ms:.1f} ms ({mb:.1f} MB file); VAE "
        f"encode {encode_ms:.2f} ms and decode {decode_ms:.2f} ms per tile; peak memory "
        f"{peak:.1f} GiB; CLI process {cli_s:.3f} s")
    return ok and cli_ok, launches, e2e, calls


# --------------------------------------------------------------------------
# SD1.5 ADetailer and previews (phase 21), from phase 17's files
# --------------------------------------------------------------------------

YOLO_FILES = ("person_yolov8m-seg.pt", "face_yolov9c.pt")
TAESD_PATH = os.path.join(DEFAULTS_DIR, "vae_approx", "taesd_decoder.safetensors")
PREVIEW_EVERY = 5


@functools.lru_cache(maxsize=1)
def detailer_masks():
    """{YOLO file: its stand-in's (1024, 1024) mask}: seeded ellipses, a
    standing person (300 x 900 pixels: its 2x crop, clipped at the border,
    takes the 768 cap) and a face (120 x 150), values in (0.8, 1]."""
    import numpy as np

    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:1024, 0:1024]
    masks = {}
    for name, (cx, cy, ax, ay) in zip(YOLO_FILES, ((512, 550, 150, 450), (500, 275, 60, 75))):
        inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
        masks[name] = (inside * (0.8 + 0.2 * rng.random((1024, 1024)))).astype(np.float32)
    return masks


class StandInDetector:
    """Takes ``UltralyticsDetector``'s place in phase 21: the person file
    finds ``detailer_masks()``'s person, the face file its face."""

    def __init__(self, path):
        self.mask = detailer_masks()[os.path.basename(path)]

    def detect(self, image, threshold=0.5):
        from lightdiffusion_next_tpu_torch.pipelines import detailer

        return detailer.StaticMaskDetector([self.mask]).detect(image, threshold)


def detailer_buckets(masks, size=1024):
    """Each mask's (bbox, crop region, bucket (w, h)) as ``Detailer``
    derives them with its defaults."""
    import numpy as np

    from lightdiffusion_next_tpu_torch.pipelines import detailer

    cfg = detailer.DetailerConfig()
    out = []
    for m in masks:
        for seg in detailer.StaticMaskDetector([m]).detect(np.zeros((1, size, size, 3))):
            x0, y0, x1, y1 = detailer.crop_region_with_factor(seg.bbox, cfg.crop_factor,
                                                              (size, size))
            out.append((seg.bbox, (x0, y0, x1, y1),
                        detailer._bucket_size(x1 - x0, y1 - y0, cfg.guide_size,
                                              cfg.max_size)))
    return out


def adetailer_calls(buckets):
    """The calls of ``pipeline(prompt, 1024, 1024, adetailer=True)`` with
    every default: the first pass as ``attention_calls`` gives it for
    ``dpmpp_sde_cfgpp`` with its decode, then per segment the encode at
    the bucket's latent, the detailer's 20 of 40 karras sigmas (denoise
    0.5) of ``dpmpp_2m_cfgpp`` at full resolution with MSW-MSA and its
    gate, and the decode."""
    from lightdiffusion_next_tpu_torch.sampling import ksampler
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    calls = attention_calls(sampler="dpmpp_sde_cfgpp")
    add = _adder(calls)
    sigmas = ksampler.sigmas_for(ModelSamplingDiscrete(), "karras", 20, 0.5)
    for _, _, (pw, ph) in buckets:
        vae_call(add, ph // 8, pw // 8)
        unet_calls(add, sigmas, ph // 8, pw // 8)
        vae_call(add, ph // 8, pw // 8)
    return calls


def unwindowed_keys(calls, buckets):
    """K1 at each bucket's level 0 with MSW-MSA's gate closed: checked
    beside the windowed shapes the gate gives."""
    names = {k[0] for k in calls if k[4] == 40}
    return {(name, 2, 8, (ph // 8) * (pw // 8), 40, "bf16"): 0
            for name in names for _, _, (pw, ph) in buckets}


def write_taesd():
    """A seeded TAESD decoder at the published widths (64 channels, 4
    latent channels) under taesd_decoder.safetensors' bare ``N.*`` keys.
    Returns its params as written."""
    import torch

    from lightdiffusion_next_tpu_torch.models import taesd

    params = {k[len("decoder."):]: torch.from_numpy(v)
              for k, v in taesd.init_params(seed=21).items() if k.startswith("decoder.")}
    write_safetensors(TAESD_PATH, params)
    return params


def recording_instance(preview_dir):
    """An ``AppInstance`` that also keeps the progress at each preview it
    writes."""
    from lightdiffusion_next_tpu_torch.app import instance

    class Recording(instance.AppInstance):
        def __init__(self):
            super().__init__(preview_dir)
            self.progress_at = []

        def update_image(self, image):
            self.progress_at.append(self.progress.get())
            return super().update_image(image)

    return Recording()


def run_preview_pipeline(seed, out, preview_dir=None):
    """``pipeline(prompt, 1024, 1024, seed=seed)`` with every default and,
    with ``preview_dir``, a ``PreviewHook`` (every 5) on a recording
    instance: (paths, wall seconds, the instance)."""
    import torch

    from lightdiffusion_next_tpu_torch.app import instance
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    inst = recording_instance(preview_dir) if preview_dir else None
    hook = instance.PreviewHook(inst, every=PREVIEW_EVERY) if inst else None
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        paths = pl.pipeline(DEFAULTS_PROMPT, WEBUI_SIZE, WEBUI_SIZE, seed=seed, progress_callback=hook,
                            output_dir=os.path.join(DEFAULTS_DIR, out))
    torch.cuda.synchronize()
    return paths, time.perf_counter() - start, inst


def check_previews(inst, side, label):
    """The preview steps are the chunk marks of the default plan, progress
    ends at 1.0, and the kept previews are side x side PNGs that are not
    constant."""
    from lightdiffusion_next_tpu_torch.sampling import samplers

    flags = samplers.fullres_flags(20, samplers.MultiScale(enabled=True), 128, 128)
    marks = samplers.chunk_marks(20, flags, set(), PREVIEW_EVERY)
    want = [m - 1 for m in sorted(marks) if m > 0]
    got = [round(p * 20) - 1 for p in inst.progress_at]
    files = inst.get_latest_previews(8)
    pngs = [read_png(p) for p in files if os.path.exists(p)]
    ok = (got == want and inst.progress.get() == 1.0 and len(pngs) == len(files) == 4
          and all(p.shape == (side, side, 3) and p.std() > 0 for p in pngs))
    log(f"{label}: previews after steps {got} (the plan's marks {want}), progress "
        f"{inst.progress.get()}, {len(pngs)} kept of {len(got)}, "
        f"{[p.shape for p in pngs]}, std {[round(float(p.std()), 2) for p in pngs]}: "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def timed_segments():
    """A context that times (synced) each ``Detailer.enhance_detail``, each
    ``detailer.dilate_masks`` and each ``StandInDetector.detect`` into the
    lists of the dict it yields ("segment", "dilate", "detect")."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import detailer

    seconds = {"segment": [], "dilate": [], "detect": []}
    patched = ((detailer.Detailer, "enhance_detail", "segment"),
               (detailer, "dilate_masks", "dilate"), (StandInDetector, "detect", "detect"))
    reals = [getattr(owner, name) for owner, name, _ in patched]

    def timer(real, key):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key].append(time.perf_counter() - t0)
            return out

        return timed

    @contextlib.contextmanager
    def ctx():
        for (owner, name, key), real in zip(patched, reals):
            setattr(owner, name, timer(real, key))
        try:
            yield seconds
        finally:
            for (owner, name, _), real in zip(patched, reals):
                setattr(owner, name, real)

    return ctx()


def check_detail_direct(model, vae, clip, x, masks, seed):
    """``Detailer.detail`` on the decode of ``x`` with ``StaticMaskDetector``
    over ``masks``: the pixels outside every crop region bit for bit the
    input, those inside each mask changed."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.models.clip import facade
    from lightdiffusion_next_tpu_torch.ops import window
    from lightdiffusion_next_tpu_torch.pipelines import detailer
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    clip = facade.CLIPSetLastLayer().set_last_layer(clip, -2)
    encode = facade.CLIPTextEncode()
    pos, neg = encode.encode(clip, DEFAULTS_PROMPT), encode.encode(clip, pl.DEFAULT_NEGATIVE)
    msw = model.with_options(attn1_override_factory=window.make_msw_msa_factory(
        model_sampling=model.model_sampling))
    with torch.no_grad():
        image = vae.decode(model.latent_format.process_out(x)).cpu().numpy()
        d = detailer.Detailer(msw, vae, detailer.DetailerConfig(denoise=0.5, seed=seed))
        out, segs = d.detail(image, detailer.StaticMaskDetector(list(masks)), pos, neg)
    outside = np.ones(image.shape[1:3], bool)
    changed = []
    for seg in segs:
        x0, y0, x1, y1 = detailer.crop_region_with_factor(seg.bbox, d.cfg.crop_factor,
                                                          image.shape[1:3])
        outside[y0:y1, x0:x1] = False
        inside = seg.mask > 0.5
        changed.append(float(np.abs(out[0][inside] - image[0][inside]).mean()))
    ok = (len(segs) == len(masks) and np.array_equal(out[0][outside], image[0][outside])
          and all(c > 1e-3 for c in changed) and bool(np.isfinite(out).all()))
    log(f"ADetailer Detailer.detail direct: {len(segs)} segments; outside every crop "
        f"({int(outside.sum())} pixels) bit for bit; mean |change| inside the masks "
        f"{[round(c, 4) for c in changed]}: {'ok' if ok else 'FAIL'}")
    return ok


def phase_adetailer(gpu, per_kernel):
    """Phase 21: ``pipeline(prompt, 1024, 1024, adetailer=True)`` and the
    TAESD previews with every default from phase 17's files. Returns (ok,
    launches, e2e, calls)."""
    import shutil

    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.models import taesd
    from lightdiffusion_next_tpu_torch.pipelines import detailer, loader
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    masks = detailer_masks()
    buckets = detailer_buckets(masks.values())
    calls = adetailer_calls(buckets)
    log("plan SD1.5 ADetailer: segments (bbox, crop, bucket)", buckets,
        {f"{k[0]} {k[1:]}": v for k, v in sorted(calls.items())})
    phase_kernels({**new_shapes(calls, per_kernel), **unwindowed_keys(calls, buckets)},
                  per_kernel)
    yolo_dir = os.path.join(DEFAULTS_DIR, "yolos")
    real_detector = detailer.UltralyticsDetector
    seed = 2121
    with defaults_assets():
        try:
            # (b) no yolos/ files: the images pass through
            plain = run_default_pipeline(out="plain21", seed=seed)
            through = run_default_pipeline(out="adetailer_through", adetailer=True, seed=seed)
            same = np.array_equal(read_png(plain["paths"][0]), read_png(through["paths"][0]))
            through_ok = same and "Adetailer" in through["paths"][0]
            log(f"ADetailer without detector files: {through['paths'][0]} equal to the plain "
                f"run's PNG bit for bit: {'ok' if through_ok else 'FAIL'}")

            # (c) both passes with the stand-in detector
            os.makedirs(yolo_dir, exist_ok=True)
            for name in YOLO_FILES:
                open(os.path.join(yolo_dir, name), "wb").close()
            detailer.UltralyticsDetector = StandInDetector
            reset_launches()
            first = run_default_pipeline(out="adetailer", adetailer=True, seed=seed)
            launches = read_launches()
            ok = check_sd15_launches(launches, calls, "SD1.5 ADetailer",
                                     ("packed_flash_attention", "flash_attention"))
            x = first["last"]["x"]
            pw, ph = buckets[-1][2]
            png = read_png(first["paths"][0])
            out_ok = (tuple(x.shape) == (1, ph // 8, pw // 8, 4)
                      and bool(torch.isfinite(x).all()) and png.shape == (1024, 1024, 3)
                      and float(png.std()) > 0
                      and not np.array_equal(png, read_png(plain["paths"][0])))
            n_steps = len(first["shapes"])
            log(f"SD1.5 ADetailer: {n_steps} sampler steps at {sorted(set(first['shapes']))}, "
                f"last latent {tuple(x.shape)} finite, png {png.shape} mean {png.mean():.2f} "
                f"std {png.std():.2f}, differs from the plain run: "
                f"{'ok' if out_ok else 'FAIL'}")
            torch.cuda.reset_peak_memory_stats()
            with timed_segments() as seg_s:
                timed = run_default_pipeline(out="adetailer", adetailer=True, seed=seed + 1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            ok = ok and through_ok and out_ok and n_steps == 20 + 20 * len(buckets)
            model, clip, vae = loader.CheckpointLoaderSimple().load_checkpoint(
                DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
            ok = check_detail_direct(model, vae, clip, plain["last"]["x"], masks.values(),
                                     seed) and ok
        finally:
            detailer.UltralyticsDetector = real_detector
            shutil.rmtree(yolo_dir, ignore_errors=True)

        # (d) previews through TAESD, then through the linear RGB map
        try:
            params = write_taesd()
            runs = {}
            for label in ("plain", "preview", "preview", "plain"):
                pdir = os.path.join(DEFAULTS_DIR, "previews") if label == "preview" else None
                runs.setdefault(label, []).append(run_preview_pipeline(seed, "p21_" + label,
                                                                       pdir))
            prev_ok = all(check_previews(r[2], 1024, "TAESD previews") for r in runs["preview"])
            final_same = all(np.array_equal(read_png(r[0][0]), read_png(plain["paths"][0]))
                             for label in runs for r in runs[label])
            log(f"previews: the final PNGs equal the run without previews bit for bit: "
                f"{'ok' if final_same else 'FAIL'}")
            n_prev = len(runs["preview"][0][2].progress_at)
            wall = {k: sum(r[1] for r in v) / len(v) for k, v in runs.items()}
            per_preview_ms = (wall["preview"] - wall["plain"]) / n_prev * 1e3
            lat = torch.randn((1, 128, 128, 4), generator=torch.Generator().manual_seed(3)).cuda()
            dev_params = {k: v.cuda().float() for k, v in taesd.normalize_decoder_params(
                dict(params)).items()}
            with torch.no_grad():
                taesd_ms = cuda_ms(lambda: taesd.decode(dev_params, lat), 5)
            cli_ok, cli_s = run_cli_process([DEFAULTS_PROMPT, "1024", "1024", "--adetailer",
                                             "--preview"],
                                            os.path.join(DEFAULTS_DIR, "cli_adetailer"), 1024)
            cli_prev = os.path.join(DEFAULTS_DIR, "cli_adetailer", "preview")
            cli_previews = sorted(os.listdir(cli_prev)) if os.path.isdir(cli_prev) else []
            cli_ok = cli_ok and len(cli_previews) == 4 and all(
                read_png(os.path.join(cli_prev, p)).shape == (1024, 1024, 3)
                for p in cli_previews)
            log(f"CLI --adetailer --preview: {len(cli_previews)} previews kept of 1024^2: "
                f"{'ok' if cli_ok else 'FAIL'}")
        finally:
            if os.path.exists(TAESD_PATH):
                os.remove(TAESD_PATH)
        _, _, inst = run_preview_pipeline(seed, "p21_linear",
                                          os.path.join(DEFAULTS_DIR, "previews_linear"))
        linear_ok = check_previews(inst, 128, "linear RGB previews (no TAESD file)")
    loader.get_model_cache().clear()
    ok = ok and prev_ok and final_same and linear_ok and cli_ok
    # the ADetailer image's seconds outside the first pass (as the plain
    # runs take it), the segments, the dilations and the detections
    rest_s = timed["wall"] - wall["plain"] - sum(sum(v) for v in seg_s.values())
    e2e = {"s_per_image": timed["wall"], "first_run_s_per_image": first["wall"],
           "segment_s": seg_s["segment"], "dilate_s": seg_s["dilate"],
           "detect_s": seg_s["detect"], "rest_s": rest_s,
           "segments": [list(b[2]) for b in buckets], "peak_gib": peak,
           "plain_s_per_image": wall["plain"], "preview_s_per_image": wall["preview"],
           "previews_per_image": n_prev, "ms_per_preview": per_preview_ms,
           "taesd_decode_ms_1024": taesd_ms, "cli_process_s": cli_s, "gpu": gpu}
    log(f"SD1.5 ADetailer ({gpu}): {timed['wall']:.3f} s/image end to end with both passes "
        f"(without ADetailer {wall['plain']:.3f}); segments {seg_s['segment']} s "
        f"at buckets {[b[2] for b in buckets]}; dilate_masks {seg_s['dilate']} s; detect "
        f"{seg_s['detect']} s; the rest {rest_s:.3f} s; peak memory {peak:.1f} GiB; previews: "
        f"{wall['preview']:.3f} s/image against {wall['plain']:.3f} without, {n_prev} "
        f"previews, {per_preview_ms:.1f} ms each; TAESD decode at 1024^2 {taesd_ms:.3f} ms; "
        f"CLI process {cli_s:.3f} s")
    return ok, launches, e2e, calls


# --------------------------------------------------------------------------
# The WebUI on the card (phase 22), from phase 17's files
# --------------------------------------------------------------------------

OLLAMA_REPLY = "an astronaut riding a white horse across the dunes, golden hour, film grain"
WEBUI_SEED = 2200
WEBUI_SIZE = 1024  # the image side of every Generate in the phase


@contextlib.contextmanager
def ollama_stub(reply):
    """A stand-in for Ollama at the enhancer's default host (127.0.0.1:11434),
    served from a thread: ``/api/chat`` answers ``reply`` after a
    ``<think>`` block, or HTTP 500 when ``reply`` is None. Yields the
    requests' bodies."""
    import http.server
    import inspect
    import threading
    from urllib.parse import urlsplit

    from lightdiffusion_next_tpu_torch.pipelines import enhancer

    host = urlsplit(inspect.signature(enhancer.enhance_prompt).parameters["host"].default)
    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            status, body = ((200, {"message": {"content": f"<think>a plan</think> {reply}"}})
                            if reply is not None else (500, {"error": "stand-in failure"}))
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer((host.hostname, host.port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield bodies
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def run_webui(seed=WEBUI_SEED, out="webui", **kw):
    """One Generate through ``webui.generate_images_with_preview`` (the
    prompt at 1024^2, ``seed``, ``**kw``) iterated to its end: the last
    paths, every status, wall seconds (which the 0.5 s poll rounds up),
    the seconds until the pipeline returned on the worker thread (device
    synced), and from then to the handler's last yield, the poll's
    share."""
    import torch

    from lightdiffusion_next_tpu_torch.app import webui
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    real, returned = pl.pipeline, []

    def pipeline(*args, **kwargs):
        out_paths = real(*args, **kwargs)
        torch.cuda.synchronize()
        returned.append(time.perf_counter())
        return out_paths

    statuses, paths = [], []
    pl.pipeline = pipeline
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for paths, status in webui.generate_images_with_preview(
                output_dir=os.path.join(DEFAULTS_DIR, out), prompt=DEFAULTS_PROMPT,
                w=WEBUI_SIZE, h=WEBUI_SIZE, seed=seed, **kw):
            statuses.append(status)
        end = time.perf_counter()
    finally:
        pl.pipeline = real
    return {"paths": paths, "statuses": statuses, "wall": end - start,
            "pipeline_s": returned[0] - start if returned else None,
            "poll_s": end - returned[0] if returned else None}


def run_direct(seed=WEBUI_SEED, out="webui_direct", preview=True, **kw):
    """``pipeline(prompt, 1024, 1024, seed=seed, **kw)`` on this thread as the
    handler calls it (a ``PreviewHook`` on the app's instance with
    ``preview``, no ``torch.no_grad``): paths, wall seconds."""
    import torch

    from lightdiffusion_next_tpu_torch.app import instance
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    instance.app.clear_interrupt()
    hook = instance.PreviewHook(instance.app) if preview else None
    torch.cuda.synchronize()
    start = time.perf_counter()
    paths = pl.pipeline(DEFAULTS_PROMPT, WEBUI_SIZE, WEBUI_SIZE, seed=seed, progress_callback=hook,
                        output_dir=os.path.join(DEFAULTS_DIR, out), **kw)
    torch.cuda.synchronize()
    return {"paths": paths, "wall": time.perf_counter() - start}


def webui_done(run, label):
    """A Generate that ended in "done" with one PNG of the phase's size that
    is not constant, having polled at least once, and no error status."""
    statuses = run["statuses"]
    png = read_png(run["paths"][0]) if len(run["paths"]) == 1 else None
    ok = (statuses[-1] == "done" and not any(s.startswith(("error", "busy")) for s in statuses)
          and all(s.startswith("generating... ") for s in statuses[:-1]) and len(statuses) > 1
          and png is not None and png.shape == (WEBUI_SIZE, WEBUI_SIZE, 3)
          and float(png.std()) > 0)
    log(f"WebUI {label}: {len(statuses)} statuses ({statuses[0]!r} .. {statuses[-1]!r}), "
        f"{run['paths']}, {run['wall']:.3f} s: {'ok' if ok else 'FAIL'}")
    return ok


def same_png(a, b):
    import numpy as np

    return np.array_equal(read_png(a["paths"][0]), read_png(b["paths"][0]))


def phase_webui(gpu, per_kernel, def_calls):
    """Phase 22: the WebUI's Generate handler on the card from phase 17's
    files, its worker thread launching the kernels. Returns (ok, launches by
    path, e2e, calls by path)."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.app import instance, webui
    from lightdiffusion_next_tpu_torch.models.clip import facade
    from lightdiffusion_next_tpu_torch.pipelines import enhancer, loader
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    flash = ("packed_flash_attention", "flash_attention")
    with runtime_config(sage_attention=True):
        sage_calls = attention_calls(sage=True, sampler="dpmpp_sde_cfgpp")
    with runtime_config(packed_attn=False):
        unpacked_calls = attention_calls(sampler="dpmpp_sde_cfgpp")
    log("plan WebUI packed_attn off:",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(unpacked_calls.items())})
    new = new_shapes({**sage_calls, **unpacked_calls}, per_kernel)
    phase_kernels({k: n for k, n in new.items() if k[0] in flash}, per_kernel)
    if any(k[0] == "sage_attention" for k in new):
        phase_sage_kernels(new, per_kernel)

    cache = loader.get_model_cache()
    saved = (config.get_config(), instance.app.preview_dir, webui.SETTINGS_FILE)
    instance.app.preview_dir = os.path.join(DEFAULTS_DIR, "webui_preview")
    webui.SETTINGS_FILE = os.path.join(DEFAULTS_DIR, "webui_settings.json")
    launches, calls, e2e, oks = {}, {}, {"gpu": gpu}, {}
    with defaults_assets() as records:
        try:
            # (a) Generate with every default, previews on: the first (which
            # loads the checkpoint) against the launch plan, then in turns
            # with the direct pipeline() call the handler makes (same seed)
            reset_launches()
            first = run_webui()
            launches["webui_sd15_defaults"] = read_launches()
            calls["webui_sd15_defaults"] = def_calls
            runs = {"direct": [], "webui": []}
            for label in ("direct", "webui", "webui", "direct"):
                runs[label].append(run_direct() if label == "direct" else run_webui())
            previews = instance.app.get_latest_previews(8)
            oks["defaults"] = (
                check_sd15_launches(launches["webui_sd15_defaults"], def_calls,
                                    "WebUI defaults (worker thread)", flash)
                and all(webui_done(r, "defaults") for r in [first] + runs["webui"])
                and all(same_png(r, first) for r in runs["webui"] + runs["direct"])
                and instance.app.progress.get() == 1.0 and len(previews) == 4)
            log(f"WebUI defaults: the handler's PNGs equal the direct calls' bit for bit, "
                f"{len(previews)} previews kept: {'ok' if oks['defaults'] else 'FAIL'}")
            wall = {k: sum(r["wall"] for r in v) / len(v) for k, v in runs.items()}
            poll = [r["poll_s"] for r in runs["webui"]]
            e2e.update(s_per_image=wall["webui"], direct_s_per_image=wall["direct"],
                       handler_overhead_s=wall["webui"] - wall["direct"], poll_s=poll,
                       pipeline_s_in_handler=[r["pipeline_s"] for r in runs["webui"]],
                       first_run_s_with_load=first["wall"],
                       runs_s={k: [r["wall"] for r in v] for k, v in runs.items()})

            # (b) a second Generate while one runs, an interrupt, a disconnect
            statuses, busy, at, paths = [], None, None, []
            for paths, status in webui.generate_images_with_preview(
                    output_dir=os.path.join(DEFAULTS_DIR, "webui_interrupt"),
                    prompt=DEFAULTS_PROMPT, w=WEBUI_SIZE, h=WEBUI_SIZE, seed=WEBUI_SEED + 1):
                statuses.append(status)
                if busy is None and instance.app.progress.get() > 0:
                    busy = list(webui.generate_images_with_preview(prompt="x", w=64, h=64))
                    at = instance.app.progress.get()
                    instance.app.request_interrupt()
            end_at = instance.app.progress.get()
            free = webui._GENERATION_LOCK.acquire(blocking=False)
            if free:
                webui._GENERATION_LOCK.release()
            gen = webui.generate_images_with_preview(
                output_dir=os.path.join(DEFAULTS_DIR, "webui_interrupt"),
                prompt=DEFAULTS_PROMPT, w=WEBUI_SIZE, h=WEBUI_SIZE, seed=WEBUI_SEED + 2)
            next(gen)
            gen.close()  # the client went away mid-run
            busy_after_close = list(webui.generate_images_with_preview(prompt="x", w=64, h=64))
            instance.app.request_interrupt()
            t0 = time.perf_counter()
            while not webui._GENERATION_LOCK.acquire(blocking=False):
                if time.perf_counter() - t0 > 120:
                    break
                time.sleep(0.05)
            else:
                webui._GENERATION_LOCK.release()
            released_s = time.perf_counter() - t0
            refused = [([], "busy: a generation is already in progress")]
            oks["interrupt"] = (busy == refused and busy_after_close == refused
                                and statuses[-1] == "done" and len(paths) == 1
                                and at is not None and at < end_at < 1.0 and free
                                and released_s < 120)
            log(f"WebUI interrupt: second Generate {busy}, interrupted at progress {at}, "
                f"stopped at {end_at} ({statuses[-1]!r}, {paths}), lock free after: {free}; "
                f"after a disconnect a Generate was {busy_after_close}, the lock came back "
                f"{released_s:.2f} s after the interrupt: "
                f"{'ok' if oks['interrupt'] else 'FAIL'}")
            e2e["interrupt"] = {"progress_at_request": at, "progress_at_stop": end_at,
                                "disconnect_release_s": released_s}

            # (d) sage_attention from the WebUI: K4 and its preparation
            reset_launches()
            sage = run_webui(out="webui_sage", sage_attention=True)
            launches["webui_sd15_sage"], calls["webui_sd15_sage"] = read_launches(), sage_calls
            oks["sage"] = (check_sd15_launches(launches["webui_sd15_sage"], sage_calls,
                                               "WebUI sage_attention",
                                               ("sage_attention", "sage_prepare",
                                                "flash_attention"))
                           and webui_done(sage, "sage_attention")
                           and webui.load_settings()["sage_attention"] is True)
            # (e) packed_attn off: no K1, K2 takes level 0
            reset_launches()
            unpacked = run_webui(out="webui_unpacked", sage_attention=False, packed_attn=False)
            launches["webui_sd15_unpacked"] = read_launches()
            calls["webui_sd15_unpacked"] = unpacked_calls
            oks["unpacked"] = (check_sd15_launches(launches["webui_sd15_unpacked"],
                                                   unpacked_calls, "WebUI packed_attn off",
                                                   ("flash_attention",))
                               and launches["webui_sd15_unpacked"]["packed_flash_attention"] == 0
                               and webui_done(unpacked, "packed_attn off"))
            e2e.update(sage_s_per_image=sage["pipeline_s"],
                       unpacked_s_per_image=unpacked["pipeline_s"])

            # (h) enhance_prompt against a stand-in Ollama, then a failing one
            encoded, real_encode = [], facade.CLIPTextEncode.encode

            def spy(self, clip, text):
                encoded.append(text)
                return real_encode(self, clip, text)

            facade.CLIPTextEncode.encode = spy
            try:
                with ollama_stub(OLLAMA_REPLY) as bodies:
                    enh = run_webui(out="webui_enhance", packed_attn=True, enhance_prompt=True)
                got, encoded[:] = list(encoded), []
                with ollama_stub(None) as failed_bodies:
                    enh_failed = run_webui(out="webui_enhance", enhance_prompt=True)
            finally:
                facade.CLIPTextEncode.encode = real_encode
            want = enhancer.QUALITY_PREFIX + OLLAMA_REPLY
            oks["enhance"] = (got[:1] == [want] and encoded[:1] == [DEFAULTS_PROMPT]
                              and len(bodies) == len(failed_bodies) == 1
                              and bodies[0]["messages"][1]["content"] == DEFAULTS_PROMPT
                              and webui_done(enh, "enhance_prompt")
                              and webui_done(enh_failed, "enhance_prompt, Ollama failing"))
            log(f"WebUI enhance_prompt: CLIP got {got[:1]} (want {want!r}); with Ollama "
                f"failing {encoded[:1]}: {'ok' if oks['enhance'] else 'FAIL'}")
            e2e["enhance_s_per_image"] = enh["pipeline_s"]

            # (g) FBCache on the UNet, forced to hit, through pipeline(model=...)
            model, clip, vae = loader.CheckpointLoaderSimple().load_checkpoint(
                DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
            forced = model.with_options(fbcache=fbcache.FBCacheConfig(**FORCED_HITS))
            fbcache.history.clear()
            reset_launches()
            fb = run_direct(WEBUI_SEED + 3, "webui_fbcache", False, model=forced, clip=clip,
                            vae=vae)
            hist = list(fbcache.history)
            launches["sd15_unet_fbcache_hits"] = read_launches()
            fb_calls = attention_calls(sampler="dpmpp_sde_cfgpp", hits=hist)
            calls["sd15_unet_fbcache_hits"] = fb_calls
            fbcache.history.clear()
            zero = run_direct(WEBUI_SEED + 3, "webui_fbcache_zero", False, vae=vae, clip=clip,
                              model=model.with_options(fbcache=fbcache.FBCacheConfig(0.0)))
            zero_hist = list(fbcache.history)
            plain = run_direct(WEBUI_SEED + 3, "webui_fbcache_plain", False, model=model,
                               clip=clip, vae=vae)
            fb_png = read_png(fb["paths"][0])
            oks["fbcache"] = (check_sd15_launches(launches["sd15_unet_fbcache_hits"], fb_calls,
                                                  "SD1.5 UNet FBCache forced hits", flash)
                              and len(hist) == 39 and 0 < sum(hist) < 39
                              and zero_hist == [False] * 39 and same_png(zero, plain)
                              and fb_png.shape == (WEBUI_SIZE, WEBUI_SIZE, 3)
                              and float(fb_png.std()) > 0)
            log(f"SD1.5 UNet FBCache forced hits: {sum(hist)} hits of {len(hist)} model calls "
                f"{hist}, {fb['wall']:.3f} s/image against {plain['wall']:.3f} without the "
                f"cache; threshold 0: {len(zero_hist)} misses, the PNG bit for bit the run "
                f"without the cache: {'ok' if oks['fbcache'] else 'FAIL'}")
            e2e["fbcache"] = {"hits": sum(hist), "model_calls": len(hist), "history": hist,
                              "s_per_image": fb["wall"], "plain_s_per_image": plain["wall"],
                              "threshold_0_s_per_image": zero["wall"]}
            del model, clip, vae, forced

            # (f) qkv_fuse off: its own UNet load, the same launches, the
            # final latent against the joined run's
            latents = {}

            def recorder(key):
                return lambda info: latents.__setitem__(key, info["x"])

            reset_launches()
            joined = run_webui(out="webui_qkv", progress_callback=recorder("joined"))
            joined_launches = read_launches()
            n_loads = records.count("loaded ")
            reset_launches()
            unjoined = run_webui(out="webui_qkv", qkv_fuse=False,
                                 progress_callback=recorder("unjoined"))
            launches["webui_sd15_qkv_unfused"] = read_launches()
            calls["webui_sd15_qkv_unfused"] = def_calls
            x, ref = latents["unjoined"], latents["joined"]
            rel = ((x - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
            unfused_model, _, _ = loader.CheckpointLoaderSimple().load_checkpoint(
                DEFAULTS_CKPT, os.path.join(DEFAULTS_DIR, "embeddings"))
            layout_ok = ("input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
                         in unfused_model.params
                         and not any(k.endswith("to_qkv.weight") for k in unfused_model.params))
            del unfused_model
            oks["qkv"] = (launches["webui_sd15_qkv_unfused"] == joined_launches
                          and check_sd15_launches(joined_launches, def_calls, "WebUI qkv_fuse on",
                                                  flash)
                          and records.count("loaded ") == n_loads + 1 and layout_ok
                          and bool(torch.isfinite(x).all()) and rel <= 2e-2
                          and webui_done(joined, "qkv_fuse on")
                          and webui_done(unjoined, "qkv_fuse off"))
            log(f"WebUI qkv_fuse off: final latent against the joined run's: rel RMSE "
                f"{rel:.4g} (limit 2e-2); launches equal; its own unjoined UNet loaded: "
                f"{'ok' if oks['qkv'] else 'FAIL'}")
            e2e.update(qkv_unfused_rel_rmse=rel, qkv_joined_s_per_image=joined["pipeline_s"],
                       qkv_unfused_s_per_image_with_load=unjoined["pipeline_s"])

            # (c) keep_models_loaded off: every Generate loads the checkpoint
            n_loads = records.count("loaded ")
            off = [run_webui(out="webui_reload", qkv_fuse=True, keep_models_loaded=False),
                   run_webui(out="webui_reload", keep_models_loaded=False)]
            loads = [m for m in records.messages if m.startswith(f"loaded {DEFAULTS_CKPT}")]
            reload_s = float(re.search(r" in ([0-9.]+) s$", loads[-1]).group(1))
            left = cache.get_memory_info()["cached_models"]
            oks["reload"] = (records.count("loaded ") == n_loads + 2 and left == 0
                             and cache.keep_models_loaded is False
                             and all(webui_done(r, "keep_models_loaded off") for r in off))
            log(f"WebUI keep_models_loaded off: two Generates loaded the checkpoint "
                f"{records.count('loaded ') - n_loads} times, the second load {reload_s:.3f} s, "
                f"{off[1]['wall']:.3f} s/image; cached models after: {left}: "
                f"{'ok' if oks['reload'] else 'FAIL'}")
            e2e["reload"] = {"s_per_image": off[1]["pipeline_s"], "load_s": reload_s,
                             "cached_models_after": left}
        finally:
            config.set_config(saved[0])
            instance.app.preview_dir, webui.SETTINGS_FILE = saved[1], saved[2]
            instance.app.clear_interrupt()
            cache.set_keep_models_loaded(True)
    ok = all(oks.values())
    log(f"WebUI ({gpu}): Generate {e2e['s_per_image']:.3f} s/image against "
        f"{e2e['direct_s_per_image']:.3f} for the direct call (overhead "
        f"{e2e['handler_overhead_s']:.3f} s; the pipeline returned after "
        f"{e2e['pipeline_s_in_handler']} s, the last yield {poll} s later); "
        f"sage {e2e['sage_s_per_image']:.3f}, packed_attn off "
        f"{e2e['unpacked_s_per_image']:.3f}, enhance_prompt {e2e['enhance_s_per_image']:.3f}, "
        f"FBCache forced hits {e2e['fbcache']['s_per_image']:.3f} s/image; reload "
        f"{e2e['reload']['load_s']:.3f} s; checks {oks}")
    return ok, launches, e2e, calls


# --------------------------------------------------------------------------
# Flux
# --------------------------------------------------------------------------


def q8_bound(m, k, n):
    flops = 2.0 * m * k * n
    nbytes = 2.0 * m * k + k * n + 4.0 * k * n / 32 + 2.0 * m * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fused_bound(l, heads=FLUX_HEADS, d=128):
    flops = 4.0 * l * l * d * heads
    exps = float(l * l * heads)
    nbytes = 2.0 * 4 * l * heads * d + 2 * 4.0 * l * d  # q, k, v, o; cos, sin
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / PEAK_EXP2)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flux_ids(l):
    """Position ids of a joint sequence of 256 text and l - 256 image tokens."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    side = int(round(math.sqrt(l - FLUX_TXT)))
    return torch.cat([torch.zeros((1, FLUX_TXT, 3), device="cuda"),
                      flux.img_ids(1, 2 * side, 2 * side, device="cuda")], dim=1)


def flux_rope(l):
    """(cos, sin) of ``flux_ids(l)``: the fused attention's tables."""
    from lightdiffusion_next_tpu_torch.models import flux

    return flux.rope_cos_sin(flux_ids(l), flux.FLUX_DEV.axes_dim)


def phase_flux_kernels(calls, per_kernel):
    """K5 and K3 at every Flux main-path shape: agreement with the plain
    version, both planted faults, times."""
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import ggml
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(1)

    def q8_check(out, ref):
        return fa.agreement(out, ref, max_ulps=qm.MAX_ULPS, rel_rmse_limit=qm.REL_RMSE_LIMIT)

    for key in sorted(k for k in calls if k[0] == "quant_matmul"):
        _, m, k, n = key
        w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
        t = ggml.transpose_for_matmul(ggml.quantize(w))
        del w
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        out = qm.quant_matmul(x, t.qt, t.scales_t)
        torch.cuda.synchronize()
        ref = qm.quant_matmul_plain(x, t.qt, t.scales_t)
        check = q8_check(out, ref)
        rolled = torch.roll(t.scales_t, -1, 0).contiguous()
        faults = {
            Q8_FAULTS[0]: fault_entry(q8_check(qm._launch(x, t.qt, t.scales_t, k=k - 64), ref)),
            Q8_FAULTS[1]: fault_entry(q8_check(qm._launch(x, t.qt, rolled), ref)),
        }
        run = lambda: qm.quant_matmul(x, t.qt, t.scales_t)  # noqa: E731
        ms = cuda_ms(run, repeats_for(run))
        plain_ms = cuda_ms(lambda: qm.quant_matmul_plain(x, t.qt, t.scales_t), 2)
        w_bf16 = t.dequantize(torch.bfloat16).t().contiguous()  # (K, N), untimed
        lib = lambda: torch.matmul(x, w_bf16)  # noqa: E731
        library_ms = cuda_ms(lib, repeats_for(lib))
        bound_ms, bound_by = q8_bound(m, k, n)
        record_shape(per_kernel, key, check, faults, {
            "shape": [m, k, n], "dtype": "bf16 x, Q8_0 weight", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by})
        del t, x, out, ref, rolled, w_bf16
        torch.cuda.empty_cache()

    for key in sorted(k for k in calls if k[0] == "fused_qkv_attention"):
        _, l, width, txt_len = key
        qkv = torch.randn((1, l, width), generator=gen, device="cuda").bfloat16()
        sc = [(1.0 + 0.2 * torch.randn((128,), generator=gen, device="cuda")).float()
              for _ in range(4)]
        cos, sin = flux_rope(l)
        kw = dict(num_heads=FLUX_HEADS, txt_len=txt_len, txt_q_scale=sc[2], txt_k_scale=sc[3])
        out = fa.fused_qkv_attention(qkv, sc[0], sc[1], cos, sin, **kw)
        torch.cuda.synchronize()
        ref = fa.fused_qkv_attention_plain(qkv, sc[0], sc[1], cos, sin, **kw)
        check = fa.agreement(out, ref)
        args = (FLUX_HEADS, txt_len, sc[2], sc[3], 1e-6)
        faults = {
            FUSED_FAULTS[0]: fault_entry(fa.agreement(
                fa._launch_fused(qkv, sc[0], sc[1], cos, sin, *args, lk=l - 64), ref)),
            FUSED_FAULTS[1]: fault_entry(fa.agreement(
                fa._launch_fused(qkv, sc[0], sc[1], cos, -sin, *args), ref)),
        }
        run = lambda: fa.fused_qkv_attention(qkv, sc[0], sc[1], cos, sin, **kw)  # noqa: E731
        ms = cuda_ms(run, repeats_for(run))
        plain_ms = cuda_ms(
            lambda: fa.fused_qkv_attention_plain(qkv, sc[0], sc[1], cos, sin, **kw), 2)
        # the yardstick attends q and k already normed and roped (untimed):
        # it skips the prologue the kernel does
        hd = FLUX_HEADS * 128
        q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(1, l, FLUX_HEADS, 128)
                   for i in range(3))
        qn = fa._norm_rope(q, sc[0], sc[2], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        kn = fa._norm_rope(k, sc[1], sc[3], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        vh = v.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qn, kn, vh)  # noqa: E731
        library_ms = cuda_ms(lib, repeats_for(lib))
        bound_ms, bound_by = fused_bound(l)
        record_shape(per_kernel, key, check, faults, {
            "shape": [1, l, width, txt_len], "dtype": "bf16", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by})
        del qkv, out, ref, q, k, v, qn, kn, vh
        torch.cuda.empty_cache()
    return per_kernel


def phase_flux_reference():
    """One double block and one single block of Flux.1-dev at full width and
    1024^2 token counts (4096 image + 256 text), from the same seeded Q8_0
    weights: bf16 through K5 and K3, against f32 through the plain versions
    (the Q8_0 weights dequantized to f32, attention in
    ``fused_qkv_attention_plain``)."""
    import dataclasses

    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.ops import ggml, nn

    cfg = dataclasses.replace(flux.FLUX_DEV, depth=1, depth_single_blocks=1,
                              fused_attn=True)
    params = flux.permute_rope_basis(flux.random_params(cfg, seed=30), cfg)
    img, txt, vec, pe = flux_block_inputs()
    outs = {}
    saved = config.get_config()
    try:
        for label, dtype, backend in (("kernels", torch.bfloat16, "flash"),
                                      ("plain", torch.float32, "sdpa")):
            config.set_config(dataclasses.replace(saved, attention_backend=backend))
            c = dataclasses.replace(cfg, dtype=dtype)
            p = {k: (v.dequantize(torch.float32).contiguous() if dtype == torch.float32
                     else v) if isinstance(v, ggml.QTensor8T) else
                 (v if k.endswith("norm.scale") else v.to(dtype))
                 for k, v in params.items()}
            with torch.no_grad():
                im, tx = flux._double_block(nn.ParamView(p, "double_blocks.0."),
                                            img.to(dtype), txt.to(dtype), vec.to(dtype), pe, c)
                xx = flux._single_block(nn.ParamView(p, "single_blocks.0."),
                                        torch.cat([tx, im], dim=1), vec.to(dtype), pe, c)
            outs[label] = (im.float(), tx.float(), xx.float())
            del p
            torch.cuda.empty_cache()
    finally:
        config.set_config(saved)
    rels = block_rel_rmse(outs["kernels"], outs["plain"])
    ok = all(math.isfinite(r) and r <= TOL_FLUX_BLOCK_REL_RMSE for r in rels)
    log(f"flux reference: double block img/txt and single block, bf16 kernels vs f32 "
        f"plain: rel RMSE {[f'{r:.4g}' for r in rels]} (tol {TOL_FLUX_BLOCK_REL_RMSE}) "
        f"{'ok' if ok else 'FAIL'}")
    plain = outs["plain"]
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rels, plain


def block_rel_rmse(outs, refs):
    return [((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()
            for a, b in zip(outs, refs)]


def flux_block_inputs():
    """The reference blocks' inputs (seed 31): image and text tokens, the
    vector, the RoPE tables of 4096 + 256 tokens."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(31)
    img = torch.randn((1, 4096, FLUX_H), generator=gen, device="cuda")
    txt = torch.randn((1, FLUX_TXT, FLUX_H), generator=gen, device="cuda")
    vec = torch.randn((1, FLUX_H), generator=gen, device="cuda")
    return img, txt, vec, flux_rope(4096 + FLUX_TXT)


def build_flux_models(w8a8=False):
    """Flux.1-dev DiT and T5-XXL (Q8_0, drawn and quantized on the card),
    CLIP-L and the Flux AE at full width from seeded random weights (seeds
    20-23): (model, clip, vae, t5). The DiT is built with
    ``RuntimeConfig.w8a8`` off, so it stays Q8_0 (K5); with ``w8a8`` it is
    then requantized (``to_w8a8_models``). Both are built with ``flux_scan``
    off, unrolled (``to_scan_models`` stacks them)."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import base, flux
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    t0 = time.perf_counter()
    with runtime_config(w8a8=False, flux_scan=False):
        model = base.flux_model(flux.random_params(flux.FLUX_DEV, seed=20), cfg=flux.FLUX_DEV)
        t5 = t5_mod.T5XXLModel(t5_mod.random_params(t5_mod.T5_XXL, seed=21), cfg=t5_mod.T5_XXL)
    clip = te.SDClipModel(te.init_params(num_layers=12, width=768, heads=12, seed=22,
                                         with_projection=True), num_layers=12, heads=12)
    vae = vae_mod.VAE(vae_mod.init_params(vae_mod.FLUX_AE, seed=23), vae_mod.FLUX_AE)
    torch.cuda.synchronize()
    log(f"flux pipeline: built the DiT, T5-XXL, CLIP-L and the AE from seeds in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        "on the card")
    models = (model, clip, vae, t5)
    return to_w8a8_models(models) if w8a8 else models


def to_w8a8_models(models):
    """The Flux models with the DiT requantized per output column to W8A8
    (``ggml.to_w8a8``, which commutes with the RoPE permutation already
    applied). The Q8_0 DiT's params are consumed: each Q8_0 leaf is freed as
    it converts, so one DiT is resident at a time. T5 stays Q8_0."""
    import torch

    from lightdiffusion_next_tpu_torch.ops import ggml

    model, clip, vae, t5 = models
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    w8 = dataclasses.replace(model, params=ggml.to_w8a8(model.params))
    torch.cuda.synchronize()
    log(f"flux W8A8: DiT requantized in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB during the requant")
    return w8, clip, vae, t5


def to_scan_models(models):
    """The Flux models with the DiT and T5 stacked in place into the scan
    layout (``flux.stack_block_params``, ``t5.stack_t5_block_params``), as
    ``flux_model`` and ``T5XXLModel`` build them with ``flux_scan`` on (the
    card's default). The unrolled params are consumed family by family:
    returns the models and the device memory the stacking took at its peak
    above the unrolled models, in GiB."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod

    model, clip, vae, t5 = models
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    scan = dataclasses.replace(model, params=flux.stack_block_params(model.params, model.config))
    t5.params = t5_mod.stack_t5_block_params(t5.params, t5.cfg)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"flux scan: DiT and T5 stacked in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, peak {peak:.2f} GiB "
        "above the unrolled models during the stacking")
    return (scan, clip, vae, t5), peak


@contextlib.contextmanager
def runtime_config(**fields):
    """The port's ``RuntimeConfig`` with ``fields`` replaced; restored after."""
    from lightdiffusion_next_tpu_torch import config

    saved = config.get_config()
    config.set_config(dataclasses.replace(saved, **fields))
    try:
        yield
    finally:
        config.set_config(saved)


def run_flux_pipeline(models, seed):
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    model, clip, vae, t5 = models
    step_times, last = [], {}

    def on_step(info):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        last.update(info)

    fbcache.history.clear()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        paths = pl.pipeline(
            "a photograph of an astronaut riding a horse on the moon, detailed",
            1024, 1024, flux_enabled=True, autohdr=False, model=model, clip=clip,
            vae=vae, t5=t5, seed=seed, output_dir=OUT_DIR, progress_callback=on_step,
        )
    torch.cuda.synchronize()
    return {"paths": paths, "wall": time.perf_counter() - start,
            "step_times": step_times, "last": last, "hits": list(fbcache.history)}


def check_flux_output(run, model, vae, label):
    """What came out of a Flux pipeline call: a finite latent of the right
    shape, finite pixels, and the PNG holding exactly those pixels."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    x = run["last"]["x"]
    latent_ok = tuple(x.shape) == (1, 128, 128, 16) and bool(torch.isfinite(x).all())
    with torch.no_grad():
        pixels = vae.decode(model.latent_format.process_out(x))
    pixels_ok = bool(torch.isfinite(pixels).all())
    png = read_png(run["paths"][0])
    png_ok = png.shape == (1024, 1024, 3) and np.array_equal(
        png, image_utils.to_uint8(pixels.cpu().numpy())[0])
    log(f"{label} output: latent {tuple(x.shape)} finite={latent_ok}, pixels finite="
        f"{pixels_ok}, png {png.shape} matches decode={png_ok}, "
        f"pixel mean {png.mean():.2f} std {png.std():.2f}, {run['paths'][0]}")
    return latent_ok and pixels_ok and png_ok


def check_flux_launches(run, launches, w8a8, label, scan=False, plan=None):
    """The pipeline call's launches against the plan derived from its
    counted FBCache hits (``plan(hits, misses, dy_calls)``, by default
    ``flux_calls`` with ``w8a8`` and ``scan``). Returns (ok, the plan's
    calls per image)."""
    hist = run["hits"]
    # calls in order: steps 0-2, the dy call of step 2, step 3, its dy call, steps 4-19
    main = [h for i, h in enumerate(hist) if i not in (3, 5)]
    dy = [hist[i] for i in (3, 5) if i < len(hist)]
    hits = sum(main)
    plan = plan or functools.partial(flux_calls, w8a8=w8a8, scan=scan)
    calls = plan(hits=hits, misses=len(main) - hits, dy_calls=len(dy))
    predicted = predicted_launches(calls)
    ok = len(hist) == 22 and not any(dy)
    log(f"{label} FBCache: {''.join('H' if h else '.' for h in hist)} ({hits} hits of "
        f"{len(main)} main-loop calls; the dy calls are the 4th and 6th)")
    for name in KERNELS:
        good = launches[name] == predicted[name]
        ok = ok and good
        log(f"launches {label} {name}: {launches[name]} (plan predicts {predicted[name]}) "
            f"{'ok' if good else 'FAIL'}")
    return ok, calls


def missed_dit_calls(model, n=2):
    """Wall seconds of ``n`` Flux forwards at 1024^2 that run every block
    (no cache), each synced; the launch counters are set to 0 before the
    last one and read after it. Returns (seconds, launches of the last, its
    output)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(40)
    args = (torch.randn((1, 128, 128, 16), generator=gen, device="cuda"),
            torch.tensor([0.5], device="cuda"),
            torch.randn((1, FLUX_TXT, 4096), generator=gen, device="cuda"))
    kw = dict(y=torch.randn((1, 768), generator=gen, device="cuda"),
              guidance=torch.tensor([3.0], device="cuda"))
    seconds = []
    for i in range(n):
        if i == n - 1:
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model.apply_fn(model.params, *args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds, read_launches(), out


def timed_flux_run(models, label):
    """A second pipeline call (seed 8765), timed: its e2e numbers."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    timed = run_flux_pipeline(models, 8765)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = timed["step_times"]
    it_s = (len(steps) - 1) / (steps[-1] - steps[0])
    log(f"{label} timed run: {timed['wall']:.3f} s/image end to end; sampler "
        f"steps 2..{len(steps)}: {it_s:.3f} it/s; FBCache "
        f"{''.join('H' if h else '.' for h in timed['hits'])} "
        f"({sum(timed['hits'])} hits); peak memory {peak:.1f} GiB")
    return {"s_per_image": timed["wall"], "it_per_s": it_s,
            "fbcache_hits": sum(timed["hits"]), "fbcache_history": timed["hits"],
            "peak_gib": peak}


def phase_flux_pipeline():
    """The Q8_0 Flux pipeline. Returns (ok, launches, e2e, flux calls per
    image from the counted FBCache hits, the models, the first run's final
    latent)."""
    models = build_flux_models()
    model, clip, vae, t5 = models
    reset_launches()
    first = run_flux_pipeline(models, 4321)
    launches = read_launches()
    ok, calls = check_flux_launches(first, launches, False, "Flux")
    ok = check_flux_output(first, model, vae, "flux") and ok
    e2e = timed_flux_run(models, "flux pipeline")
    miss, _, _ = missed_dit_calls(model)
    log(f"flux: first run {first['wall']:.3f} s/image; one missed DiT call "
        f"{miss[-1] * 1e3:.1f} ms wall (first {miss[0] * 1e3:.1f})")
    e2e.update(first_run_s_per_image=first["wall"], missed_dit_call_s=miss[-1])
    return ok, launches, e2e, calls, models, first["last"]["x"]


# --------------------------------------------------------------------------
# Flux on W8A8 weights
# --------------------------------------------------------------------------


def int8_bound(m, k, n, bias, residual):
    flops = 2.0 * m * k * n
    nbytes = (m * k + k * n + 4.0 * n * (2 if bias else 1) + 4.0 * m
              + 2.0 * m * n * (2 if residual else 1))
    t_ops, t_bytes = flops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rowquant_bound(m, k, prologue="none"):
    """Bytes: each bf16 element read once, its code written once, one f32
    scale per row (and ln_mod's (K,) f32 scale and shift)."""
    nbytes = 3.0 * m * k + 4.0 * m + (8.0 * k if prologue == "ln_mod" else 0.0)
    return nbytes / PEAK_HBM_BYTES * 1e3, "bytes"


def activations(m, k, gen):
    """bf16 rows with a mean of their own, as the DiT's activations have."""
    import torch

    x = 2 * torch.randn((m, k), generator=gen, device="cuda")
    return (x + torch.randn((m, 1), generator=gen, device="cuda")).bfloat16()


def w8_weight(k, n, gen):
    """A (N, K) weight drawn as ``flux.random_params`` draws it, quantized
    to Q8_0 and requantized to W8A8 on the card."""
    import torch

    from lightdiffusion_next_tpu_torch.ops import ggml

    w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
    return ggml.to_w8a8({"w": ggml.transpose_for_matmul(ggml.quantize(w))})["w"]


def phase_w8a8_kernels(calls, per_kernel):
    """K9, K10, K11 and K7 at every shape of ``calls`` (the W8A8 Flux path
    and the unfused DiT call): agreement with the plain version, two planted
    faults each, times."""
    import torch

    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(2)

    for key in sorted(k for k in calls if k[0] == "row_quantize_fused"):
        _, prologue, m, k = key
        x = activations(m, k, gen)
        s = 1 + 0.2 * torch.randn((1, k), generator=gen, device="cuda")
        t = 0.1 * torch.randn((1, k), generator=gen, device="cuda")
        codes, sx = qm.row_quantize_fused(x, s, t, prologue=prologue)
        torch.cuda.synchronize()
        ref = qm.row_quantize_fused_plain(x, s, t, prologue=prologue)
        check = qm.codes_agreement(codes, sx, *ref, exact=prologue == "none")
        if prologue == "ln_mod":
            bad = qm._launch_rowquant(x, prologue, s, t, 1e-6, center=0)
        else:
            bad = qm._launch_rowquant(x, "gelu" if prologue == "none" else "none", s, t, 1e-6)
        faults = {
            ROWQ_FAULTS[prologue]: fault_entry(qm.codes_agreement(*bad, *ref)),
            ROWQ_SCALE_FAULT: fault_entry(qm.codes_agreement(
                *qm._launch_rowquant(x, prologue, s, t, 1e-6, inv_qmax=1.0 / 128), *ref)),
        }
        run = lambda: qm.row_quantize_fused(x, s, t, prologue=prologue)  # noqa: E731
        ms = cuda_ms(run, repeats_for(run))
        plain_ms = cuda_ms(lambda: qm.row_quantize_fused_plain(x, s, t, prologue=prologue), 2)
        bound_ms, bound_by = rowquant_bound(m, k, prologue)
        record_shape(per_kernel, key, check, faults, {
            "shape": [m, k], "dtype": f"bf16 in, {prologue} prologue", "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by})
        del x, codes, sx, ref, bad
        torch.cuda.empty_cache()

    for key in sorted(k for k in calls if k[0] == "row_quantize_concat_gelu"):
        _, m, ka, width, lo = key
        a, b = activations(m, ka, gen), activations(m, width, gen)
        codes, sx = qm.row_quantize_concat_gelu(a, b, lo, width)
        torch.cuda.synchronize()
        ref = qm.row_quantize_concat_gelu_plain(a, b, lo, width)
        check = qm.codes_agreement(codes, sx, *ref)
        faults = {
            CONCAT_FAULTS[0]: fault_entry(qm.codes_agreement(
                *qm._launch_concat(a, b, lo - 128, width - 128), *ref)),
            CONCAT_FAULTS[1]: fault_entry(qm.codes_agreement(
                *qm._launch_concat(a, b, lo, width, gelu=0), *ref)),
        }
        run = lambda: qm.row_quantize_concat_gelu(a, b, lo, width)  # noqa: E731
        ms = cuda_ms(run, repeats_for(run))
        plain_ms = cuda_ms(lambda: qm.row_quantize_concat_gelu_plain(a, b, lo, width), 2)
        bound_ms, bound_by = rowquant_bound(m, ka + width - lo)
        record_shape(per_kernel, key, check, faults, {
            "shape": [m, ka, width, lo], "dtype": "bf16 in, window read through its stride",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by})
        del a, b, codes, sx, ref
        torch.cuda.empty_cache()

    matmuls = {}
    for key in calls:
        if key[0] in ("w8a8_matmul", "w8a8_matmul_ep"):
            matmuls.setdefault(tuple(key[1:4]), []).append(key)
    for (m, k, n), keys in sorted(matmuls.items()):
        w = w8_weight(k, n, gen)
        x = activations(m, k, gen)
        xq, sx = qm.row_quantize_fused(x)
        sx1 = sx.reshape(-1)
        lib = lambda: torch._int_mm(xq, w.q.t())  # noqa: E731
        try:
            library_ms = cuda_ms(lib, repeats_for(lib))
        except RuntimeError as e:  # the yardstick only; the port never calls it
            log(f"torch._int_mm at {(m, k, n)}: {e}")
            library_ms = None
        for key in sorted(keys, key=str):
            if key[0] == "w8a8_matmul":
                cs, bias, r = w.col_scales.reshape(-1).contiguous(), None, None
                out = qm.w8a8_matmul(x, w.q, w.col_scales)
                torch.cuda.synchronize()
                ref = qm.w8a8_matmul_plain(x, w.q, w.col_scales)
                run = lambda: qm._launch_w8a8(xq, sx1, w.q, cs)  # noqa: E731  K7 alone
            else:
                gate = torch.randn((1, n), generator=gen, device="cuda")
                cs = (w.col_scales * gate).reshape(-1).contiguous()
                bias = (0.1 * torch.randn((1, n), generator=gen, device="cuda") * gate).reshape(-1)
                r = activations(m, n, gen) if key[4] else None
                out = qm.w8a8_matmul_ep(xq, sx, w.q, cs, bias, residual=r)
                torch.cuda.synchronize()
                ref = qm.w8a8_matmul_ep_plain(xq, sx, w.q, cs, bias, residual=r)
                run = lambda: qm.w8a8_matmul_ep(xq, sx, w.q, cs, bias, residual=r)  # noqa: E731
            ep = bias is not None
            check = qm.matmul_agreement(out, ref)
            faults = {
                W8A8_FAULTS[0]: fault_entry(qm.matmul_agreement(qm._launch_w8a8(
                    xq, sx1, w.q, cs, bias, r, k=k - 128, ep=ep), ref)),
                W8A8_FAULTS[1]: fault_entry(qm.matmul_agreement(qm._launch_w8a8(
                    xq, sx1, w.q, torch.roll(cs, -1).contiguous(), bias, r, ep=ep), ref)),
            }
            ms = cuda_ms(run, repeats_for(run))
            plain_ms = cuda_ms(lambda: qm._epilogue_plain(xq, sx, w.q, cs, bias, r), 2)
            bound_ms, bound_by = int8_bound(m, k, n, ep, r is not None)
            record_shape(per_kernel, key, check, faults, {
                "shape": [m, k, n], "dtype": "int8 codes, bf16 out"
                + (", bf16 residual" if r is not None else ""),
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            del out, ref, r
        del w, x, xq, sx, sx1
        torch.cuda.empty_cache()
    return per_kernel


@contextlib.contextmanager
def plain_w8a8():
    """The W8A8 wrappers of ``ops.quant_matmul`` replaced by their plain
    versions (the modules that call them look them up at call time), so a
    forward on the card runs the plain versions in f32; restored after."""
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    names = ("w8a8_matmul", "w8a8_matmul_ep", "row_quantize_fused",
             "row_quantize_concat_gelu")
    saved = {name: getattr(qm, name) for name in names}
    for name in names:
        setattr(qm, name, getattr(qm, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(qm, name, fn)


def phase_flux_w8a8_reference(q8_plain):
    """One double block and one single block of Flux.1-dev at full width and
    1024^2 token counts on W8A8 weights (the Q8_0 weights of phase 7,
    requantized): bf16 through K9, K10 and K11 (and K3), against f32 through
    the plain versions. The drift against phase 7's f32 Q8_0 blocks is
    logged, not held to a limit."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.ops import ggml, nn

    cfg = dataclasses.replace(flux.FLUX_DEV, depth=1, depth_single_blocks=1,
                              fused_attn=True)
    params = flux.permute_rope_basis(ggml.to_w8a8(flux.random_params(cfg, seed=30)), cfg)
    img, txt, vec, pe = flux_block_inputs()
    outs = {}
    for label, dtype, backend in (("kernels", torch.bfloat16, "flash"),
                                  ("plain", torch.float32, "sdpa")):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = {k: v if isinstance(v, ggml.QTensor8W) or k.endswith("norm.scale")
             else v.to(dtype) for k, v in params.items()}
        plain = plain_w8a8() if dtype == torch.float32 else contextlib.nullcontext()
        with runtime_config(attention_backend=backend, fused_ew=True), plain, torch.no_grad():
            im, tx = flux._double_block(nn.ParamView(p, "double_blocks.0."),
                                        img.to(dtype), txt.to(dtype), vec.to(dtype), pe, c)
            xx = flux._single_block(nn.ParamView(p, "single_blocks.0."),
                                    torch.cat([tx, im], dim=1), vec.to(dtype), pe, c)
        outs[label] = (im.float(), tx.float(), xx.float())
        del p
        torch.cuda.empty_cache()
    rels = block_rel_rmse(outs["kernels"], outs["plain"])
    drift = block_rel_rmse(outs["kernels"], q8_plain)
    ok = all(math.isfinite(r) and r <= TOL_FLUX_BLOCK_REL_RMSE for r in rels)
    log(f"flux W8A8 reference: double block img/txt and single block, bf16 kernels vs f32 "
        f"plain: rel RMSE {[f'{r:.4g}' for r in rels]} (tol {TOL_FLUX_BLOCK_REL_RMSE}) "
        f"{'ok' if ok else 'FAIL'}; against the f32 Q8_0 blocks (logged only): "
        f"{[f'{r:.4g}' for r in drift]}")
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rels, drift


def phase_flux_w8a8_pipeline(models, q8_latent):
    """The phase 8 models with the DiT requantized to W8A8 (``fused_ew`` on,
    the default on the card), the same pipeline call, then a timed one and
    one missed DiT call with ``fused_ew`` on and one with it off. Returns
    (ok, launches, e2e, calls per image, launches of the unfused DiT call,
    the models, the outputs the scan layout is held to: the first run's
    final latent and the two missed DiT calls')."""
    models = to_w8a8_models(models)
    model, clip, vae, t5 = models
    with runtime_config(fused_ew="auto"):
        reset_launches()
        first = run_flux_pipeline(models, 4321)
        launches = read_launches()
        ok, calls = check_flux_launches(first, launches, True, "Flux W8A8")
        ok = check_flux_output(first, model, vae, "flux W8A8") and ok
        x = first["last"]["x"]
        drift = ((x - q8_latent).pow(2).mean().sqrt() / q8_latent.pow(2).mean().sqrt()).item()
        log(f"flux W8A8: final latent against the Q8_0 run of the same seed: rel RMSE "
            f"{drift:.4g} (logged only)")
        e2e = timed_flux_run(models, "flux W8A8 pipeline")
        miss_on, _, out_on = missed_dit_calls(model)
    with runtime_config(fused_ew=False):
        miss_off, off_launches, out_off = missed_dit_calls(model)
    predicted = predicted_launches(unfused_dit_calls())
    for name in KERNELS:
        good = off_launches[name] == predicted[name]
        ok = ok and good
        log(f"launches W8A8 DiT call, fused_ew off, {name}: {off_launches[name]} "
            f"(plan predicts {predicted[name]}) {'ok' if good else 'FAIL'}")
    log(f"flux W8A8: first run {first['wall']:.3f} s/image; one missed DiT call "
        f"{miss_on[-1] * 1e3:.1f} ms wall with fused_ew on (first {miss_on[0] * 1e3:.1f}), "
        f"{miss_off[-1] * 1e3:.1f} ms with it off (first {miss_off[0] * 1e3:.1f})")
    e2e.update(first_run_s_per_image=first["wall"], missed_dit_call_s=miss_on[-1],
               missed_dit_call_fused_ew_off_s=miss_off[-1], latent_drift_vs_q8_0=drift)
    refs = {"latent": x, "dit_call": out_on, "dit_call_fused_ew_off": out_off}
    return ok, launches, e2e, calls, off_launches, models, refs


# --------------------------------------------------------------------------
# The scan layout: K6, K8 and the stacked K11
# --------------------------------------------------------------------------


def q8_stack(d, k, n, gen):
    """A Q8_0 stack of ``d`` blocks: random codes, scales of the size
    ``flux.random_params``' weights get."""
    import torch

    qt3 = torch.randint(-127, 128, (d, k, n), generator=gen, device="cuda", dtype=torch.int8)
    scales3 = (0.5 + torch.rand((d, k // 32, n), generator=gen, device="cuda")) * (
        3.0 / (127 * k**0.5))
    return qt3, scales3


def w8_stack(d, k, n, gen):
    """A W8A8 stack of ``d`` blocks: random (N, K) codes, column scales."""
    import torch

    q3 = torch.randint(-127, 128, (d, n, k), generator=gen, device="cuda", dtype=torch.int8)
    cs3 = (0.5 + torch.rand((d, 1, n), generator=gen, device="cuda")) * (3.0 / (127 * k**0.5))
    return q3, cs3


def combine(checks, equal):
    """The checks at a stack's first and last block as one, with whether the
    stacked kernel equalled the unstacked one on a copy of each block."""
    out = dict(max(checks, key=lambda c: c["max_abs_err"]))
    out["ok"] = all(c["ok"] for c in checks) and all(equal)
    out["equals_unstacked_on_the_block"] = all(equal)
    return out


def stacked_requant_check(gen):
    """``to_w8a8`` of a Q8_0 stack (the double blocks' 19 img qkv weights,
    quantized on the card) against ``requant_col`` of each block alone."""
    import torch

    from lightdiffusion_next_tpu_torch.ops import ggml

    d, k, n = 19, FLUX_H, 3 * FLUX_H
    leaves = [ggml.transpose_for_matmul(ggml.quantize(
        torch.randn((n, k), generator=gen, device="cuda") * k**-0.5)) for _ in range(d)]
    alone = [ggml.requant_col(leaf) for leaf in leaves]
    w8 = ggml.to_w8a8({"s": ggml.stack_leaves(leaves)})["s"]
    del leaves
    ok = all(torch.equal(w8.q3[i], a.q) and torch.equal(w8.col_scales3[i], a.col_scales)
             for i, a in enumerate(alone))
    log(f"stacked requant of {d} x ({k}, {n}) against the unstacked: "
        f"{'equal bit for bit' if ok else 'FAIL: differs'}")
    return ok


def phase_stacked_kernels(calls, per_kernel):
    """K6, K8 and the stacked K11 at every shape of ``calls`` on stacks of
    the real depths, each at its first and last block: against its plain
    version (K6 to K5's limits, K8 and K11 bit for bit) and bit for bit
    against the unstacked kernel on a copy of the block; two planted faults
    at the last block (the neighbouring block, the last K tile skipped);
    times at the last block beside the plain version and the library
    yardstick. Then the stacked requant against the unstacked. Returns
    whether that last check held."""
    import torch

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(3)

    def q8_check(out, ref):
        return fa.agreement(out, ref, max_ulps=qm.MAX_ULPS, rel_rmse_limit=qm.REL_RMSE_LIMIT)

    def by_weight(name):
        groups = {}
        for key in calls:
            if key[0] == name:
                groups.setdefault(tuple(key[2:4]), []).append(key)
        return sorted(groups.items())

    for (k, n), keys in by_weight("quant_matmul_stacked"):
        depth = stack_depth(k, n)
        qt3, scales3 = q8_stack(depth, k, n, gen)
        for key in sorted(keys):
            m = key[1]
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            checks, equal, refs = [], [], {}
            for idx in (0, depth - 1):
                out = qm.quant_matmul_stacked(x, qt3, scales3, idx)
                torch.cuda.synchronize()
                refs[idx] = qm.quant_matmul_stacked_plain(x, qt3, scales3, idx)
                checks.append(q8_check(out, refs[idx]))
                equal.append(torch.equal(out, qm._launch(x, qt3[idx].contiguous(),
                                                         scales3[idx].contiguous())))
            last, ref = depth - 1, refs[depth - 1]
            faults = {
                STACK_FAULTS[0]: fault_entry(q8_check(qm._launch(x, qt3, scales3, idx=last - 1),
                                                      ref)),
                STACK_FAULTS[1]: fault_entry(q8_check(
                    qm._launch(x, qt3, scales3, k=k - 64, idx=last), ref)),
            }
            run = lambda: qm.quant_matmul_stacked(x, qt3, scales3, last)  # noqa: E731
            ms = cuda_ms(run, repeats_for(run, 100.0))
            plain_ms = cuda_ms(lambda: qm.quant_matmul_stacked_plain(x, qt3, scales3, last), 1)
            w_bf16 = qm.dequantize_t(qt3[last], scales3[last], torch.bfloat16)  # untimed
            lib = lambda: torch.matmul(x, w_bf16)  # noqa: E731
            library_ms = cuda_ms(lib, repeats_for(lib, 100.0))
            bound_ms, bound_by = q8_bound(m, k, n)
            record_shape(per_kernel, key, combine(checks, equal), faults, {
                "shape": [m, k, n], "depth": depth, "blocks": [0, last],
                "dtype": "bf16 x, Q8_0 stack", "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
            del x, refs, w_bf16
        del qt3, scales3
        torch.cuda.empty_cache()

    w8_groups = {}
    for name in ("w8a8_matmul_stacked", "w8a8_matmul_ep_stacked"):
        for kn, keys in by_weight(name):
            w8_groups.setdefault(kn, []).extend(keys)
    for (k, n), keys in sorted(w8_groups.items()):
        depth = stack_depth(k, n)
        last = depth - 1
        q3, cs3 = w8_stack(depth, k, n, gen)
        for key in sorted(keys, key=str):
            m = key[1]
            x = activations(m, k, gen)
            xq, sx = qm.row_quantize_fused(x)
            sx1 = sx.reshape(-1)
            lib = lambda: torch._int_mm(xq, q3[last].t())  # noqa: E731
            try:
                library_ms = cuda_ms(lib, repeats_for(lib, 100.0))
            except RuntimeError as e:  # the yardstick only; the port never calls it
                log(f"torch._int_mm at {(m, k, n)}: {e}")
                library_ms = None
            ep = key[0] == "w8a8_matmul_ep_stacked"
            gate = torch.randn((1, n), generator=gen, device="cuda")
            bias = (0.1 * torch.randn((1, n), generator=gen, device="cuda") * gate).reshape(-1)
            r = activations(m, n, gen) if ep and key[4] else None
            checks, equal, refs = [], [], {}
            for idx in (0, last):
                if ep:
                    cs = (cs3[idx] * gate).reshape(-1).contiguous()
                    out = qm.w8a8_matmul_ep(xq, sx, (q3, idx), cs, bias, residual=r)
                    torch.cuda.synchronize()
                    refs[idx] = qm.w8a8_matmul_ep_plain(xq, sx, (q3, idx), cs, bias, residual=r)
                    alone = qm._launch_w8a8(xq, sx1, q3[idx].contiguous(), cs, bias, r, ep=True)
                else:
                    out = qm.w8a8_matmul_stacked(x, q3, cs3, idx)
                    torch.cuda.synchronize()
                    refs[idx] = qm.w8a8_matmul_stacked_plain(x, q3, cs3, idx)
                    alone = qm._launch_w8a8(xq, sx1, q3[idx].contiguous(),
                                            cs3[idx].reshape(-1).contiguous())
                checks.append(qm.matmul_agreement(out, refs[idx]))
                equal.append(torch.equal(out, alone))
                del out, alone
            ref = refs[last]
            cs_last = (cs3[last] * gate).reshape(-1).contiguous() if ep else cs3
            kw = dict(bias=bias, residual=r, ep=True) if ep else {}
            faults = {
                STACK_FAULTS[0]: fault_entry(qm.matmul_agreement(
                    qm._launch_w8a8(xq, sx1, q3, cs_last, idx=last - 1, **kw), ref)),
                STACK_FAULTS[1]: fault_entry(qm.matmul_agreement(
                    qm._launch_w8a8(xq, sx1, q3, cs_last, k=k - 128, idx=last, **kw), ref)),
            }
            if ep:
                run = lambda: qm.w8a8_matmul_ep_stacked(  # noqa: E731
                    xq, sx, q3, last, cs_last, bias, residual=r)
            else:
                run = lambda: qm._launch_w8a8(xq, sx1, q3, cs3, idx=last)  # noqa: E731  K8 alone
            ms = cuda_ms(run, repeats_for(run, 100.0))
            plain_ms = cuda_ms(lambda: qm._epilogue_plain(
                xq, sx, q3[last], cs_last if ep else cs3[last],
                bias if ep else None, r), 1)
            bound_ms, bound_by = int8_bound(m, k, n, ep, r is not None)
            record_shape(per_kernel, key, combine(checks, equal), faults, {
                "shape": [m, k, n], "depth": depth, "blocks": [0, last],
                "dtype": "int8 codes, bf16 out" + (", bf16 residual" if r is not None else ""),
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            del x, xq, sx, sx1, r, refs
        del q3, cs3
        torch.cuda.empty_cache()
    return stacked_requant_check(gen)


def phase_flux_scan_pipeline(models, refs):
    """Phase 11's models stacked in place into the scan layout (the port's
    default on the card): the same pipeline call, its launches against the
    scan plan, its output, its final latent and one missed DiT call with
    ``fused_ew`` on and one with it off against phase 11's (bit for bit
    expected: the same kernels on the same weights; held to
    TOL_SCAN_REL_RMSE, the equality logged), a timed run. Returns (ok,
    launches, e2e, calls per image, launches of the unfused DiT call, the
    stacked models)."""
    import torch

    models, stack_peak = to_scan_models(models)
    model, clip, vae, t5 = models
    # one family's stack at a time: the largest, linear1's, is 2.3 GiB
    stack_ok = stack_peak <= TOL_STACK_PEAK_GIB
    log(f"flux scan: stacking peak {stack_peak:.2f} GiB (limit {TOL_STACK_PEAK_GIB}) "
        f"{'ok' if stack_ok else 'FAIL'}")

    def against(out, ref, label):
        equal = torch.equal(out, ref)
        rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
        log(f"flux scan: {label} against the unrolled layout's: "
            + ("equal bit for bit" if equal else
               f"NOT bit for bit: max |diff| {(out - ref).abs().max().item():.4g}, "
               f"{int((out != ref).sum().item())} of {out.numel()} differ, rel RMSE {rel:.4g}"))
        return equal, math.isfinite(rel) and rel <= TOL_SCAN_REL_RMSE

    with runtime_config(fused_ew="auto"):
        reset_launches()
        first = run_flux_pipeline(models, 4321)
        launches = read_launches()
        ok, calls = check_flux_launches(first, launches, True, "Flux W8A8 scan", scan=True)
        ok = check_flux_output(first, model, vae, "flux W8A8 scan") and ok
        eq_latent, close = against(first["last"]["x"], refs["latent"], "final latent")
        ok = ok and close
        e2e = timed_flux_run(models, "flux W8A8 scan pipeline")
        miss_on, _, out_on = missed_dit_calls(model)
    with runtime_config(fused_ew=False):
        miss_off, off_launches, out_off = missed_dit_calls(model)
    eq_on, close_on = against(out_on, refs["dit_call"], "missed DiT call")
    eq_off, close_off = against(out_off, refs["dit_call_fused_ew_off"],
                                "missed DiT call with fused_ew off")
    ok = ok and close_on and close_off and stack_ok
    predicted = predicted_launches(unfused_dit_calls(scan=True))
    for name in KERNELS:
        good = off_launches[name] == predicted[name]
        ok = ok and good
        log(f"launches W8A8 scan DiT call, fused_ew off, {name}: {off_launches[name]} "
            f"(plan predicts {predicted[name]}) {'ok' if good else 'FAIL'}")
    log(f"flux W8A8 scan: first run {first['wall']:.3f} s/image; one missed DiT call "
        f"{miss_on[-1] * 1e3:.1f} ms wall with fused_ew on (first {miss_on[0] * 1e3:.1f}), "
        f"{miss_off[-1] * 1e3:.1f} ms with it off (first {miss_off[0] * 1e3:.1f})")
    e2e.update(first_run_s_per_image=first["wall"], missed_dit_call_s=miss_on[-1],
               missed_dit_call_fused_ew_off_s=miss_off[-1], stacking_peak_gib=stack_peak,
               bit_for_bit_with_unrolled={"final_latent": eq_latent, "dit_call": eq_on,
                                          "dit_call_fused_ew_off": eq_off})
    return ok, launches, e2e, calls, off_launches, models, first["last"]["x"]


def phase_flux_fbcache_hits(models):
    """Phase 15's models with FBCache forced to hit (``FORCED_HITS``): the
    same pipeline call, its launches against the plan of its counted hits
    and misses, its output. Random full-width weights never hit at the
    default threshold, so this is the hit path's run on the card: a hit runs
    double block 0 (its matmuls and one K3 launch) and adds the cached
    residual. Fails unless the cache hit. Returns (ok, launches, calls per
    image, e2e)."""
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    model, clip, vae, t5 = models
    forced = model.with_options(fbcache=fbcache.FBCacheConfig(**FORCED_HITS))
    with runtime_config(fused_ew="auto"):
        reset_launches()
        run = run_flux_pipeline((forced, clip, vae, t5), 4321)
        launches = read_launches()
    label = "Flux W8A8 scan, FBCache forced to hit"
    ok, calls = check_flux_launches(run, launches, True, label, scan=True)
    ok = check_flux_output(run, forced, vae, "flux FBCache hits") and ok
    hits = sum(run["hits"])
    log(f"{label}: {hits} hits {'ok' if hits else 'FAIL: none'}; {run['wall']:.3f} s/image")
    return ok and hits > 0, launches, calls, {"s_per_image": run["wall"], "fbcache_hits": hits,
                                             "fbcache_history": run["hits"]}


# --------------------------------------------------------------------------
# Flux from files (phase 18)
# --------------------------------------------------------------------------

FLUX_DIR = os.path.join(OUT_DIR, "flux")  # its own asset root, removed after
FLUX_PROMPT = "a photograph of an astronaut riding a horse on the moon, detailed"
FLUX_LORA_RANK = 16
# what the four files take on disk, with room to spare: the DiT's 9.1 GB of
# Q8_0 (``flux.Q8_0_SUFFIXES``) and 13.2 GB of F32 (the modulation weights
# are dense), T5-XXL's 5.1 GB, CLIP-L's 0.5 GB, the AE's 0.3 GB
FLUX_FILES_BYTES = 30e9
# every block linear of the DiT (the LoRA's targets)
FLUX_BLOCK_LINEARS = re.compile(
    r"^(double|single)_blocks\.\d+\..*(qkv|proj|mlp\.[02]|linear[12]|mod\.lin|modulation\.lin)"
    r"\.weight$")


def flux_asset_paths():
    """The four files of the Flux flow under ``FLUX_DIR``, in
    ``pipeline._get_flux_models``' order (DiT, T5, CLIP-L, AE)."""
    return (os.path.join(FLUX_DIR, "unet", "flux1-dev-Q8_0.gguf"),
            os.path.join(FLUX_DIR, "clip", "t5-v1_1-xxl-encoder-Q8_0.gguf"),
            os.path.join(FLUX_DIR, "clip", "clip_l.safetensors"),
            os.path.join(FLUX_DIR, "vae", "ae.safetensors"))


def write_flux_assets():
    """Phase 8's models as the files of the Flux flow, written by the port's
    writers with every leaf streamed from the card: the DiT (seed 20, its
    Q8_0 records as ``flux.random_params`` draws them, the scales to f16 as
    GGUF stores them), T5-XXL (seed 21, llama.cpp names), CLIP-L (seed 22)
    and the AE (seed 23) as safetensors. Fails if the disk lacks the room.
    Returns the bytes of each file."""
    import shutil

    import torch

    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te
    from lightdiffusion_next_tpu_torch.ops import ggml

    unet, t5, clip, ae = flux_asset_paths()
    for path in (unet, t5, ae):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    free = shutil.disk_usage(FLUX_DIR).free
    log(f"flux files: {free / 1e9:.1f} GB free under {FLUX_DIR}, {FLUX_FILES_BYTES / 1e9:.1f} "
        "GB needed")
    if free < FLUX_FILES_BYTES:
        raise RuntimeError(f"flux files: {free} bytes free, {FLUX_FILES_BYTES:.0f} needed")
    layout = [(k, shape, kind == "lin" and k.endswith(flux.Q8_0_SUFFIXES))
              for k, shape, kind in flux._layout(flux.FLUX_DEV)]
    ggml.write_gguf(unet, flux.random_leaves(flux.FLUX_DEV, seed=20), arch="flux",
                    layout=layout)
    layout = [(ggml.t5_gguf_name(k), shape, std is not None and k.endswith(t5_mod.Q8_0_SUFFIXES))
              for k, shape, std in t5_mod._layout(t5_mod.T5_XXL)]
    ggml.write_gguf(t5, ((ggml.t5_gguf_name(k), v) for k, v in
                         t5_mod.random_leaves(t5_mod.T5_XXL, seed=21)),
                    arch="t5encoder", layout=layout)
    write_safetensors(clip, {k: torch.from_numpy(v) for k, v in te.init_params(
        num_layers=12, width=768, heads=12, seed=22, with_projection=True).items()})
    write_safetensors(ae, {k: torch.from_numpy(v) for k, v in vae_mod.init_params(
        vae_mod.FLUX_AE, seed=23).items()})
    return {os.path.basename(p): os.path.getsize(p) for p in (unet, t5, clip, ae)}


@contextlib.contextmanager
def counted_reads(reads):
    """Every read of a model file by the port (GGUF, safetensors) appended
    to ``reads`` while inside."""
    from lightdiffusion_next_tpu_torch.ops import ggml
    from lightdiffusion_next_tpu_torch.utils import state_dict

    saved = {(mod, name): getattr(mod, name)
             for mod, name in ((ggml, "gguf_sd_loader"), (state_dict, "load_torch_file"))}
    for (mod, name), fn in saved.items():
        setattr(mod, name, lambda path, *a, _fn=fn, **k: reads.append(path) or _fn(path, *a, **k))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


class PeakRss:
    """The process's peak resident set size while inside, sampled from
    /proc/self/statm every 10 ms by a thread."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def sample():
            while not self._stop.is_set():
                with open("/proc/self/statm") as f:
                    self.peak = max(self.peak, int(f.read().split()[1]) * page)
                self._stop.wait(0.01)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def run_flux_defaults(seed, out="out", **kw):
    """``pipeline(FLUX_PROMPT, 1024, 1024, flux_enabled=True, seed=...)``
    with every other argument at its default (``kw`` adds the models): the
    paths, wall seconds, the time after each step (device synced), the last
    step's callback info and FBCache's decisions."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    step_times, last = [], {}

    def on_step(info):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        last.update(info)

    fbcache.history.clear()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        paths = pl.pipeline(FLUX_PROMPT, 1024, 1024, flux_enabled=True, seed=seed,
                            output_dir=os.path.join(FLUX_DIR, out),
                            progress_callback=on_step, **kw)
    torch.cuda.synchronize()
    return {"paths": paths, "wall": time.perf_counter() - start, "step_times": step_times,
            "last": last, "hits": list(fbcache.history)}


def check_flux_hdr_output(run, vae, label):
    """A finite final latent, and the PNG equal to to_uint8(apply_hdr_batch(
    decode(latent)))."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import hdr
    from lightdiffusion_next_tpu_torch.utils import image as image_utils
    from lightdiffusion_next_tpu_torch.utils import latent as latent_mod

    x = run["last"]["x"]
    latent_ok = tuple(x.shape) == (1, 128, 128, 16) and bool(torch.isfinite(x).all())
    with torch.no_grad():
        shaped = hdr.apply_hdr_batch(vae.decode(latent_mod.FLUX1.process_out(x)))
    png = read_png(run["paths"][0])
    png_ok = png.shape == (1024, 1024, 3) and np.array_equal(
        png, image_utils.to_uint8(shaped.cpu().numpy())[0])
    log(f"{label} output: latent {tuple(x.shape)} finite={latent_ok}, png {png.shape} matches "
        f"the AutoHDR of the decode={png_ok}, pixel mean {png.mean():.2f} std "
        f"{png.std():.2f}, {run['paths'][0]}")
    return latent_ok and png_ok


def _leaf_tensors(leaf, idx=None):
    """A leaf's tensors (a record's fields), block ``idx`` of a stack's."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return [leaf if idx is None else leaf[idx]]
    return [getattr(leaf, f.name) if idx is None else getattr(leaf, f.name)[idx]
            for f in dataclasses.fields(leaf) if f.name != "shape"]


def same_dit(got, want):
    """The loaded DiT's params against ``flux_model``'s from the same
    records: every flat leaf, and each stacked family's first and last
    block, bit for bit (types, dtypes, values). Returns the keys that
    differ and the count compared."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    bad, n = [], 0
    if set(got) != set(want):
        return [f"keys differ: {sorted(set(got) ^ set(want))[:4]}"], 0
    for key, w in want.items():
        g = got[key]
        if key in (flux.DOUBLE_STACK_KEY, flux.SINGLE_STACK_KEY):
            if set(g) != set(w):
                bad.append(key)
                continue
            for rel, ws in w.items():
                depth = _leaf_tensors(ws)[0].shape[0]
                for idx in (0, depth - 1):
                    n += 1
                    pairs = zip(_leaf_tensors(g[rel], idx), _leaf_tensors(ws, idx))
                    if type(g[rel]) is not type(ws) or not all(
                            a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
                        bad.append(f"{key}/{rel}[{idx}]")
            continue
        n += 1
        pairs = zip(_leaf_tensors(g), _leaf_tensors(w))
        if type(g) is not type(w) or not all(a.dtype == b.dtype and torch.equal(a, b)
                                             for a, b in pairs):
            bad.append(key)
    return bad, n


def flux_lora_sd(seed=24, rank=FLUX_LORA_RANK):
    """A seeded Kohya-named LoRA over every block linear of Flux.1-dev (CPU
    f32): its state dict and module count."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    gen = torch.Generator().manual_seed(seed)
    sd, n = {}, 0
    for key, (out_f, in_f), _ in ((k, s, kind) for k, s, kind in flux._layout(flux.FLUX_DEV)
                                  if kind == "lin"):
        if not FLUX_BLOCK_LINEARS.match(key):
            continue
        name = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        sd[f"{name}.lora_down.weight"] = torch.randn(rank, in_f, generator=gen) * in_f**-0.5
        sd[f"{name}.lora_up.weight"] = torch.randn(out_f, rank, generator=gen) * 0.01
        sd[f"{name}.alpha"] = torch.tensor(rank / 2)
        n += 1
    return sd, n


def flux_pe(l):
    """``embed_nd`` tables of ``flux_ids(l)``: the unfused attention's."""
    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.ops import rope

    return rope.embed_nd(flux_ids(l), flux.FLUX_DEV.axes_dim)


def flux_lora_reference():
    """One double block and one single block at full width and 1024^2
    token counts on W8A8 weights under the rank-16 LoRA, the attention
    unfused: bf16 through K9, K7 and K2, against f32 through the plain
    versions (the weights dequantized by their plain matmuls, attention in
    ``sdpa``). Returns (ok, the rel RMSE of img, txt, single)."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux, lora
    from lightdiffusion_next_tpu_torch.ops import ggml, nn

    cfg = dataclasses.replace(flux.FLUX_DEV, depth=1, depth_single_blocks=1)
    params = ggml.to_w8a8(flux.random_params(cfg, seed=30))
    lora_sd, _ = flux_lora_sd()
    params, _ = lora.load_and_apply_lora(lora_sd, params, None, 1.0, 0.0, model_cfg=cfg)
    img, txt, vec, _ = flux_block_inputs()
    pe = flux_pe(4096 + FLUX_TXT)
    outs = {}
    for label, dtype, backend in (("kernels", torch.bfloat16, "flash"),
                                  ("plain", torch.float32, "sdpa")):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = {k: v if isinstance(v, ggml.QTensorLoRA) or k.endswith("norm.scale")
             else v.to(dtype) for k, v in params.items()}
        plain = plain_w8a8() if dtype == torch.float32 else contextlib.nullcontext()
        with runtime_config(attention_backend=backend, fused_ew=True), plain, torch.no_grad():
            im, tx = flux._double_block(nn.ParamView(p, "double_blocks.0."),
                                        img.to(dtype), txt.to(dtype), vec.to(dtype), pe, c)
            xx = flux._single_block(nn.ParamView(p, "single_blocks.0."),
                                    torch.cat([tx, im], dim=1), vec.to(dtype), pe, c)
        outs[label] = (im.float(), tx.float(), xx.float())
        del p
        torch.cuda.empty_cache()
    rels = block_rel_rmse(outs["kernels"], outs["plain"])
    ok = all(math.isfinite(r) and r <= TOL_FLUX_BLOCK_REL_RMSE for r in rels)
    log(f"flux LoRA reference: double block img/txt and single block, W8A8 + rank-"
        f"{FLUX_LORA_RANK} LoRA, unfused attention, bf16 kernels vs f32 plain: rel RMSE "
        f"{[f'{r:.4g}' for r in rels]} (tol {TOL_FLUX_BLOCK_REL_RMSE}) "
        f"{'ok' if ok else 'FAIL'}")
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rels


def flux_files_flow(gpu, scan_latent):
    """Phase 18's checks, with the files written (see ``phase_flux_files``).
    Returns (ok, launches and calls per image of the default and LoRA
    paths, e2e)."""
    import torch

    from lightdiffusion_next_tpu_torch.app import cli
    from lightdiffusion_next_tpu_torch.models import base, flux, lora
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.ops import ggml
    from lightdiffusion_next_tpu_torch.pipelines import loader
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    unet_path = flux_asset_paths()[0]
    cache = loader.get_model_cache()
    cache.clear()
    reads = []
    # the defaults: W8A8, scan, fused attention, FBCache, AutoHDR, from the files
    with counted_reads(reads):
        reset_launches()
        first = run_flux_defaults(FLUX_FILES_SEED)
        launches = read_launches()
    label = "Flux from files, defaults"
    ok, calls = check_flux_launches(first, launches, True, label, scan=True)
    model, vae, t5, clip = pl._get_flux_models(*flux_asset_paths(), "cuda")
    cfg_ok = (model.config.fused_attn and flux.is_stacked(model.params)
              and isinstance(model.params[flux.SINGLE_STACK_KEY]["linear1.weight"],
                             ggml.StackedQTensor8W) and t5_mod.is_stacked(t5.params)
              and len(reads) == 4)
    log(f"{label}: W8A8, scan, fused attention, 4 files read ({len(reads)}): "
        f"{'ok' if cfg_ok else 'FAIL'}")
    ok = ok and cfg_ok and check_flux_hdr_output(first, vae, label)
    x = first["last"]["x"]
    # phase 23's one-device references: this final latent, one missed call
    tp_reference(model, "spmd")
    torch.save(x.float().cpu(), os.path.join(TP_DIR, "files_latent.pt"))
    drift = ((x - scan_latent).pow(2).mean().sqrt() / scan_latent.pow(2).mean().sqrt()).item()
    log(f"{label}: final latent against phase 15's (the same seeds in memory; the file "
        f"rounds the Q8_0 scales to f16): rel RMSE {drift:.4g} (logged only)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = base.flux_model(ggml.gguf_sd_loader(unet_path))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    bad, n = same_dit(model.params, ref.params)
    same_ok = not bad and ref.config == model.config
    log(f"{label}: the loaded DiT against flux_model on the file's records ({n} leaves and "
        f"stack ends; built in {ref_s:.1f} s): "
        f"{'bit for bit' if same_ok else f'FAIL: {len(bad)} differ, e.g. {bad[:3]}'}")
    ok = ok and same_ok
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    n_reads = len(reads)
    with counted_reads(reads):
        torch.cuda.reset_peak_memory_stats()
        timed = run_flux_defaults(8765)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = timed["step_times"]
    it_s = (len(steps) - 1) / (steps[-1] - steps[0])
    warm_ok = len(reads) == n_reads
    log(f"{label} ({gpu}) timed run: {timed['wall']:.3f} s/image, {it_s:.3f} it/s, FBCache "
        f"{''.join('H' if h else '.' for h in timed['hits'])}, peak {peak:.1f} GiB; files read: "
        f"{len(reads) - n_reads} {'ok' if warm_ok else 'FAIL'}")
    ok = ok and warm_ok

    # the GGUF load alone, beside the cached DiT
    gb = os.path.getsize(unet_path) / 1e9
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with PeakRss() as rss:
        t0 = time.perf_counter()
        fresh = loader.load_diffusion_model_gguf(unet_path)
        load_s = time.perf_counter() - t0
    dev_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    dev_kept = (torch.cuda.memory_allocated() - before) / 2**30
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label}: GGUF load {load_s:.3f} s for {gb:.3f} GB ({gb / load_s:.3f} GB/s); host peak "
        f"RSS {rss.peak / 2**30:.1f} GiB; device peak {dev_peak:.2f} GiB above the resident "
        f"models, {dev_kept:.2f} GiB kept")

    # the CLI with its defaults, from the cache
    out = io.StringIO()
    n_reads = len(reads)
    t0 = time.perf_counter()
    with counted_reads(reads), contextlib.redirect_stdout(out):
        rc = cli.main([FLUX_PROMPT, "1024", "1024", "--flux", "--output-dir",
                       os.path.join(FLUX_DIR, "cli")])
    cli_s = time.perf_counter() - t0
    printed = out.getvalue().split()
    cli_ok = (rc == 0 and len(printed) == 1 and printed[0].endswith(".png")
              and os.path.exists(printed[0]) and len(reads) == n_reads
              and read_png(printed[0]).shape == (1024, 1024, 3))
    log(f"{label} CLI: printed {printed}, files read {len(reads) - n_reads}: "
        f"{'ok' if cli_ok else 'FAIL'}; {cli_s:.3f} s")
    ok = ok and cli_ok

    # LoRA on the unfused path: the unrolled, unfused variant evicts the scan one
    lora_label = "Flux LoRA, unfused attention"
    with runtime_config(flux_scan=False, fused_attn=False):
        n_reads = len(reads)
        with counted_reads(reads):
            t0 = time.perf_counter()
            lmodel, vae, t5, clip = pl._get_flux_models(*flux_asset_paths(), "cuda")
            lload_s = time.perf_counter() - t0
        dits = [k for k in cache._cache if k.startswith(os.path.abspath(unet_path) + ":")]
        evict_ok = (len(dits) == 1 and not lmodel.config.fused_attn
                    and "__double_stack__" not in lmodel.params
                    and reads[n_reads:] == [unet_path, flux_asset_paths()[1]])
        log(f"{lora_label}: the unrolled unfused DiT and T5 loaded in {lload_s:.1f} s, "
            f"{len(dits)} DiT resident: {'ok' if evict_ok else 'FAIL'}")
        lora_sd, n_modules = flux_lora_sd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = lora.load_and_apply_lora(lora_sd, lmodel.params, None, 1.0, 0.0,
                                             model_cfg=lmodel.config)
        torch.cuda.synchronize()
        lora_s = time.perf_counter() - t0
        n_lora = sum(isinstance(v, ggml.QTensorLoRA) for v in params.values())
        patched_ok = n_lora == 19 * 8 + 38 * 2 and n_modules == 19 * 10 + 38 * 3
        log(f"{lora_label}: rank {FLUX_LORA_RANK} on {n_modules} block linears, "
            f"{n_lora} of them quantized (QTensorLoRA), in {lora_s:.3f} s: "
            f"{'ok' if patched_ok else 'FAIL'}")
        lmodel = dataclasses.replace(lmodel, params=params)
        kw = dict(model=lmodel, clip=clip, vae=vae, t5=t5)
        reset_launches()
        lfirst = run_flux_defaults(FLUX_FILES_SEED, **kw)
        llaunches = read_launches()
        lok, lcalls = check_flux_launches(lfirst, llaunches, True, lora_label,
                                          plan=lora_flux_calls)
        lok = check_flux_hdr_output(lfirst, vae, lora_label) and lok
        ltimed = run_flux_defaults(8765, **kw)
        lsteps = ltimed["step_times"]
        lit_s = (len(lsteps) - 1) / (lsteps[-1] - lsteps[0])
        log(f"{lora_label} ({gpu}) timed run: {ltimed['wall']:.3f} s/image, {lit_s:.3f} it/s; "
            f"first run {lfirst['wall']:.3f} s")
        del lmodel, params, kw
    ok = ok and evict_ok and patched_ok and lok
    cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    ref_ok, rels = flux_lora_reference()
    ok = ok and ref_ok
    e2e = {"defaults": {"s_per_image": timed["wall"], "it_per_s": it_s, "peak_gib": peak,
                        "first_run_s_per_image_with_load": first["wall"],
                        "gguf_load_s": load_s, "gguf_load_gb_per_s": gb / load_s,
                        "gguf_gb": gb, "load_host_peak_rss_gib": rss.peak / 2**30,
                        "load_device_peak_gib": dev_peak, "reference_build_s": ref_s,
                        "cli_s_per_image": cli_s, "latent_drift_vs_phase_15": drift,
                        "fbcache_hits": sum(timed["hits"]), "gpu": gpu},
           "lora_unfused": {"s_per_image": ltimed["wall"], "it_per_s": lit_s,
                            "first_run_s_per_image": lfirst["wall"], "load_s": lload_s,
                            "lora_apply_s": lora_s, "fbcache_hits": sum(ltimed["hits"]),
                            "block_rel_rmse": rels, "gpu": gpu}}
    return ok, (launches, calls), (llaunches, lcalls), e2e


def phase_flux_files(gpu, scan_latent, per_kernel):
    """Phase 18: Flux.1-dev from files, under its own asset root
    (``FLUX_DIR``, ``LDT_OFFLINE=1``). K2 at the unfused attention's two
    new shapes first; then the four files written at full width and depth
    (``write_flux_assets``, 28.2 GB), ``pipeline(..., flux_enabled=True)``
    with every default and no models, the CLI's ``--flux``, and the LoRA on
    the unfused path (``flux_files_flow``). The files are removed when the
    run of phase 23 ends (``main``), also on failure. Returns (ok, the two
    paths' launches and calls, e2e)."""
    import torch

    phase_kernels({flux_k2_key(4096 + FLUX_TXT): 1, flux_k2_key(1024 + FLUX_TXT): 1},
                  per_kernel)
    saved_env = {k: os.environ.get(k) for k in ("LDT_ASSET_ROOT", "LDT_OFFLINE")}
    try:
        t0 = time.perf_counter()
        sizes = write_flux_assets()
        write_s = time.perf_counter() - t0
        total = sum(sizes.values())
        log(f"flux files: wrote {total / 1e9:.3f} GB ({sizes}) in {write_s:.1f} s "
            f"({total / 1e9 / write_s:.3f} GB/s)")
        os.environ.update(LDT_ASSET_ROOT=FLUX_DIR, LDT_OFFLINE="1")
        ok, defaults, lora_path, e2e = flux_files_flow(gpu, scan_latent)
        e2e["defaults"].update(files_bytes=sizes, write_s=write_s)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.empty_cache()
    return ok, defaults, lora_path, e2e


# --------------------------------------------------------------------------
# Flux tensor-parallel on one card (phase 23), from phase 18's files
# --------------------------------------------------------------------------

TP = 2  # ranks, both on the one card, gloo between them
TP_HEADS, TP_H, TP_MLP = FLUX_HEADS // TP, FLUX_H // TP, FLUX_MLP // TP
TP_DIR = os.path.join(OUT_DIR, "tp")
TP_TIMEOUT_S = 900  # both ranks, end to end; a rank's collective gives up after
TP_GLOO_TIMEOUT_S = 300
FLUX_FILES_SEED = 4321  # phase 18's first pipeline call
TP_OTHER_DRAW = 777  # rank 1's own seed draw, which rank 0's must replace
# rel RMSE of the TP forward (bf16, each rank's half) against the one-device
# forward on the same files: the row-parallel partials are summed in bf16
# and, on W8A8, each rank row-quantizes its half of an activation row with
# a scale of its own (2.8e-2 with the card's toggles, 1.4e-2 with Q8_0
# unfused, on an H100 at 700 W)
TOL_TP_FORWARD_REL_RMSE = 5e-2
# rel RMSE of the TP pipeline's final latent against phase 18's, from the
# same files at the same seed: 6.86e-3 in two runs (H100 80GB HBM3, 700 W),
# the per-call differences above carried through 20 steps; the limit is
# about three times that, where a wrong seed or a wrong block moves it by
# O(1)
TOL_TP_LATENT_REL_RMSE = 2e-2
INTERLEAVED_FAULTS = ("proj-major offsets", "k and v stripes swapped")
# K3 interleaved beyond the TP = 2 path's shapes: 24 and 6 heads (TP = 1, 4)
TP_EXTRA_K3 = (("fused_qkv_attention_interleaved", 4096 + FLUX_TXT, FLUX_HEADS, FLUX_TXT),
               ("fused_qkv_attention_interleaved", 4096 + FLUX_TXT, FLUX_HEADS // 4, FLUX_TXT))
# a rank's matmuls (K, N, K9's prologue): a double block's per stream (qkv,
# proj, mlp.0, mlp.2), the single block's (linear1_qkv, linear1_mlp,
# linear2_attn, linear2_mlp); column-parallel N and row-parallel K halved,
# every K11 without the residual (a bias, or a raw partial to all-reduce)
TP_DOUBLE = ((FLUX_H, 3 * TP_H, "ln_mod"), (TP_H, FLUX_H, "none"),
             (FLUX_H, TP_MLP, "ln_mod"), (TP_MLP, FLUX_H, "gelu"))
TP_SINGLE = ((FLUX_H, 3 * TP_H, "ln_mod"), (FLUX_H, TP_MLP, "ln_mod"),
             (TP_H, FLUX_H, "none"), (TP_MLP, FLUX_H, "gelu"))
TP_ALL_REDUCES = 4 * 19 + 38  # per missed DiT call: each double block's 4, each single's 1


def tp_matmul_calls(add, rows, mats, n, q8):
    for k, nn_, prologue in mats:
        if q8:
            add(("quant_matmul", rows, k, nn_), n)
        else:
            add(("row_quantize_fused", prologue, rows, k), n)
            add(("w8a8_matmul_ep", rows, k, nn_, False), n)


def tp_dit_calls(img, add, n=1, q8=False):
    """A rank's kernel calls of ``n`` missed DiT calls at ``img`` image
    tokens under TP = 2: with the card's toggles (W8A8, fused-EW, fused
    attention) K9 and K11 on its shards and K3 interleaved on its 12
    heads; with ``q8`` (W8A8 and fused attention off) K5 on its shards
    and K2 at (1, 12, L, 128)."""
    joint = img + FLUX_TXT
    for rows in (img, FLUX_TXT):
        tp_matmul_calls(add, rows, TP_DOUBLE, 19 * n, q8)
    tp_matmul_calls(add, joint, TP_SINGLE, 38 * n, q8)
    if q8:
        add(("flash_attention", 1, TP_HEADS, joint, 128, "bf16"), 57 * n)
    else:
        add(("fused_qkv_attention_interleaved", joint, TP_HEADS, FLUX_TXT), 19 * n)
        add(("fused_qkv_attention_interleaved", joint, TP_HEADS, 0), 38 * n)


def tp_forward_calls(q8=False):
    """One missed DiT call at 1024^2 on a rank: the card's toggles' in the
    scan layout, or ``q8``'s unrolled."""
    calls = {}
    tp_dit_calls(4096, _adder(calls), 1, q8)
    return calls if q8 else stacked(calls)


def tp_flux_calls(hits=0, misses=20, dy_calls=2):
    """A rank's calls per image of the TP pipeline under the card's toggles
    (``flux_calls``' walk):
    the DiT calls on its shards in the scan layout, a hit running double
    block 0, T5-XXL (whole on every rank) and the AE decode."""
    calls = {}
    add = _adder(calls)
    tp_dit_calls(4096, add, misses)
    tp_dit_calls(1024, add, dy_calls)
    for rows in (4096, FLUX_TXT):
        tp_matmul_calls(add, rows, TP_DOUBLE, hits, False)
    add(("fused_qkv_attention_interleaved", 4096 + FLUX_TXT, TP_HEADS, FLUX_TXT), hits)
    for k, nn_, n in ((4096, 4096, 4), (4096, 10240, 2), (10240, 4096, 1)):
        add(("quant_matmul", FLUX_TXT, k, nn_), 24 * n)
    add(("flash_attention", 1, 1, 16384, 512, "f32"), 1)
    return stacked(calls)


def phase_interleaved_kernels(keys, per_kernel):
    """K3 interleaved at each (L, heads, txt_len) of ``keys``: against its
    plain version, the two planted faults (the same qkv read at the
    proj-major offsets; each head's k and v stripes swapped in the input),
    times beside the plain version and ``scaled_dot_product_attention`` on
    q and k normed and roped beforehand, the bound."""
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    for key in sorted(keys):
        _, l, h, txt_len = key
        width = 3 * h * 128
        qkv = torch.randn((1, l, width), generator=gen, device="cuda").bfloat16()
        sc = [(1.0 + 0.2 * torch.randn((128,), generator=gen, device="cuda")).float()
              for _ in range(4)]
        cos, sin = flux_rope(l)
        kw = dict(num_heads=h, txt_len=txt_len, txt_q_scale=sc[2], txt_k_scale=sc[3],
                  interleaved=True)
        out = fa.fused_qkv_attention(qkv, sc[0], sc[1], cos, sin, **kw)
        torch.cuda.synchronize()
        ref = fa.fused_qkv_attention_plain(qkv, sc[0], sc[1], cos, sin, **kw)
        check = fa.agreement(out, ref)
        args = (h, txt_len, sc[2], sc[3], 1e-6)
        swapped = qkv.reshape(1, l, h, 3, 128)[:, :, :, [0, 2, 1]].reshape(qkv.shape)
        faults = {
            INTERLEAVED_FAULTS[0]: fault_entry(fa.agreement(
                fa._launch_fused(qkv, sc[0], sc[1], cos, sin, *args), ref)),
            INTERLEAVED_FAULTS[1]: fault_entry(fa.agreement(
                fa._launch_fused(swapped.contiguous(), sc[0], sc[1], cos, sin, *args,
                                 interleaved=True), ref)),
        }
        run = lambda: fa.fused_qkv_attention(qkv, sc[0], sc[1], cos, sin, **kw)  # noqa: E731
        ms = cuda_ms(run, repeats_for(run))
        plain_ms = cuda_ms(
            lambda: fa.fused_qkv_attention_plain(qkv, sc[0], sc[1], cos, sin, **kw), 2)
        q, k, v = fa.split_qkv(qkv, h, interleaved=True)
        qn = fa._norm_rope(q, sc[0], sc[2], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        kn = fa._norm_rope(k, sc[1], sc[3], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        vh = v.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(qn, kn, vh)  # noqa: E731
        library_ms = cuda_ms(lib, repeats_for(lib))
        bound_ms, bound_by = fused_bound(l, heads=h)
        record_shape(per_kernel, key, check, faults, {
            "shape": [1, l, h, 128], "txt_len": txt_len, "dtype": "bf16, interleaved",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by})
        del qkv, out, ref, swapped, q, k, v, qn, kn, vh
        torch.cuda.empty_cache()


def tp_inputs():
    """One DiT call's inputs at 1024^2, the same in every process (seeded
    on the card): latent, sigma, T5 sequence, CLIP pooled, guidance."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(23)
    return (torch.randn((1, 128, 128, 16), generator=gen, device="cuda"),
            torch.tensor([0.75], device="cuda"),
            torch.randn((1, FLUX_TXT, 4096), generator=gen, device="cuda") * 0.3,
            torch.randn((1, 768), generator=gen, device="cuda") * 0.3,
            torch.tensor([3.0], device="cuda"))


def tp_forward(model):
    """One missed DiT call on ``tp_inputs``: (the output on the host, the
    launches, the all-reduces and their widths, seconds)."""
    import torch

    from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod

    x, t, ctx, y, g = tp_inputs()
    torch.cuda.synchronize()
    reset_launches()
    mesh_mod.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model.apply_fn(model.params, x, t, ctx, y=y, guidance=g)
    torch.cuda.synchronize()
    return {"out": out.float().cpu(), "launches": read_launches(),
            "all_reduces": mesh_mod.all_reduce.calls,
            "widths": dict(mesh_mod.all_reduce.widths), "s": time.perf_counter() - t0}


def tp_reference(model, name):
    """One device's ``tp_forward`` output, kept under ``TP_DIR`` for phase 23."""
    import torch

    os.makedirs(TP_DIR, exist_ok=True)
    torch.save(tp_forward(model)["out"], os.path.join(TP_DIR, f"ref_{name}.pt"))


def tp_rank(rank, store):
    """A rank of phase 23: the process group (gloo), then ``tp_rank_flow``;
    its results to ``TP_DIR/rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, TP), rank=rank, world_size=TP,
                            timeout=datetime.timedelta(seconds=TP_GLOO_TIMEOUT_S))
    try:
        torch.save(tp_rank_flow(rank), os.path.join(TP_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_rank_flow(rank):
    """On this rank, from phase 18's files through the pipeline's loader:
    ``LDT_FLUX_TP=spmd`` (the card's defaults per shard), one missed DiT
    call; ``pipeline(FLUX_PROMPT, 1024, 1024, flux_enabled=True)`` with no
    seed, each rank drawing its own; then ``LDT_FLUX_TP=auto`` with the
    ``w8a8``, ``flux_scan`` and ``fused_attn`` toggles off, one missed DiT
    call. Launches, all-reduces, seconds and the device's peak."""
    import random

    import torch

    from lightdiffusion_next_tpu_torch.models import flux
    from lightdiffusion_next_tpu_torch.ops import ggml
    from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl
    from lightdiffusion_next_tpu_torch.sampling import ksampler

    os.environ.update(LDT_ASSET_ROOT=FLUX_DIR, LDT_OFFLINE="1", LDT_FLUX_TP="spmd")
    res = {}

    def load():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = pl._get_flux_models(*flux_asset_paths(), "cuda", mesh=pl._flux_mesh())[0]
        torch.cuda.synchronize()
        stack = model.params.get(flux.SINGLE_STACK_KEY, {})
        return model, {"load_s": time.perf_counter() - t0, "tp": model.config.tp_axis is not None,
                       "fused_attn": model.config.fused_attn, "stacked": flux.is_stacked(model.params),
                       "w8a8": isinstance(stack.get("linear1_qkv.weight"), ggml.StackedQTensor8W),
                       "q8_0": isinstance(model.params.get("single_blocks.0.linear1_qkv.weight"),
                                          ggml.QTensor8T)}

    model, res["spmd_config"] = load()
    res["spmd_forward"] = tp_forward(model)
    del model

    seen = {}
    real = ksampler.ksample

    def recording(model, **kw):
        seen["seed"] = kw["seed"]
        return real(model, **kw)

    pl.ks.ksample = recording
    random.randint = lambda a, b: FLUX_FILES_SEED if rank == 0 else TP_OTHER_DRAW
    reset_launches()
    mesh_mod.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    run = run_flux_defaults(None, out="out_tp")
    run.update(seed=seen["seed"], launches=read_launches(), all_reduces=mesh_mod.all_reduce.calls,
               widths=dict(mesh_mod.all_reduce.widths),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               x=run["last"]["x"].float().cpu())
    del run["last"]
    res["pipeline"] = run
    pl.ks.ksample = real

    os.environ["LDT_FLUX_TP"] = "auto"
    with runtime_config(w8a8=False, flux_scan=False, fused_attn=False):
        model, res["q8_config"] = load()
        res["q8_forward"] = tp_forward(model)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def rel_rmse(out, ref):
    return ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()


def tp_launch_check(label, launches, calls):
    """A rank's launches against ``calls``' prediction."""
    predicted = predicted_launches(calls)
    ok = True
    for name in KERNELS:
        good = launches[name] == predicted[name]
        ok = ok and good
        if launches[name] or predicted[name]:
            log(f"launches {label} {name}: {launches[name]} (plan predicts {predicted[name]}) "
                f"{'ok' if good else 'FAIL'}")
    return ok


def run_tp_ranks():
    """Spawn the two ranks (gloo on a FileStore) and wait for both, at most
    ``TP_TIMEOUT_S``: a rank that fails or is late fails the phase."""
    import torch.multiprocessing as mp

    store = os.path.join(TP_DIR, "store")
    for f in ("store", "rank0.pt", "rank1.pt"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(TP_DIR, f))
    ctx = mp.start_processes(tp_rank, args=(store,), nprocs=TP, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + TP_TIMEOUT_S
    while not ctx.join(timeout=5.0):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"phase 23: the ranks ran past {TP_TIMEOUT_S} s")


def phase_flux_tp(gpu, per_kernel):
    """Phase 23, from phase 18's files (removed by ``main`` after it): K3
    interleaved at the TP path's shapes (and at 24 and 6 heads), K9, the
    stacked K11, K5 and K2 at a rank's new shapes; the Q8_0 unfused
    unrolled reference on one device (phase 18 kept the W8A8 one); then two
    ranks on the one card over gloo (``tp_rank_flow``), whose results are
    held here against the one-device forwards, phase 18's final latent,
    their plans and each other. Returns (ok, launches and calls per path,
    e2e)."""
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import loader

    spmd_plan, q8_plan = tp_forward_calls(), tp_forward_calls(q8=True)
    pipe_plan = tp_flux_calls()
    new = new_shapes({**spmd_plan, **q8_plan, **pipe_plan}, per_kernel)
    phase_interleaved_kernels([k for k in new if k[0] == "fused_qkv_attention_interleaved"]
                              + list(TP_EXTRA_K3), per_kernel)
    phase_w8a8_kernels({k: n for k, n in new.items() if k[0] == "row_quantize_fused"},
                       per_kernel)
    requant_ok = phase_stacked_kernels(
        {k: n for k, n in new.items() if k[0] == "w8a8_matmul_ep_stacked"}, per_kernel)
    phase_flux_kernels({k: n for k, n in new.items() if k[0] == "quant_matmul"}, per_kernel)
    phase_kernels({k: n for k, n in new.items() if k[0] == "flash_attention"}, per_kernel)

    unet_path = flux_asset_paths()[0]
    loader.get_model_cache().clear()
    gc.collect()
    torch.cuda.empty_cache()
    with runtime_config(w8a8=False, flux_scan=False, fused_attn=False):
        ref = loader.load_diffusion_model_gguf(unet_path)
    tp_reference(ref, "q8")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_tp_ranks()
    ranks_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(TP_DIR, f"rank{r}.pt"), weights_only=False)
           for r in range(TP)]
    label = "Flux TP"
    ok = requant_ok
    paths = {}
    for mode in ("spmd", "q8"):
        cfg_ok = all(r[f"{mode}_config"]["tp"] for r in res)
        want = ((True, True, True, False) if mode == "spmd" else (False, False, False, True))
        cfg_ok = cfg_ok and all(tuple(r[f"{mode}_config"][f] for f in (
            "fused_attn", "stacked", "w8a8", "q8_0")) == want for r in res)
        outs = [r[f"{mode}_forward"]["out"] for r in res]
        ref = torch.load(os.path.join(TP_DIR, f"ref_{mode}.pt"))
        rel = rel_rmse(outs[0], ref)
        same = torch.equal(outs[0], outs[1])
        fwd_ok = (cfg_ok and same and bool(torch.isfinite(outs[0]).all())
                  and rel <= TOL_TP_FORWARD_REL_RMSE)
        log(f"{label} {mode}: config {res[0][f'{mode}_config']}; one missed DiT call against "
            f"one device's: rel RMSE {rel:.4g} (tol {TOL_TP_FORWARD_REL_RMSE}), the ranks' "
            f"outputs {'equal' if same else 'DIFFER'}: {'ok' if fwd_ok else 'FAIL'}")
        ok = ok and fwd_ok
        for r, rr in enumerate(res):
            f = rr[f"{mode}_forward"]
            lok = tp_launch_check(f"{label} {mode} DiT call rank {r}", f["launches"],
                                  q8_plan if mode == "q8" else spmd_plan)
            ar_ok = f["all_reduces"] == TP_ALL_REDUCES and f["widths"] == {FLUX_H: TP_ALL_REDUCES}
            log(f"{label} {mode} rank {r}: {f['all_reduces']} all-reduces {f['widths']} (plan "
                f"{TP_ALL_REDUCES} of width {FLUX_H}) {'ok' if ar_ok else 'FAIL'}; the call "
                f"{f['s']:.3f} s ({gpu}; gloo through the host, not NVLink); load "
                f"{rr[f'{mode}_config']['load_s']:.1f} s")
            ok = ok and lok and ar_ok
            paths[f"flux_tp_{mode}_dit_call_rank{r}"] = f["launches"]

    runs = [r["pipeline"] for r in res]
    hist = runs[0]["hits"]
    main_hist = [h for i, h in enumerate(hist) if i not in (3, 5)]
    hits = sum(main_hist)
    calls = tp_flux_calls(hits=hits, misses=len(main_hist) - hits,
                          dy_calls=len(hist) - len(main_hist))
    n_ar = sum(4 if h else TP_ALL_REDUCES for h in hist)
    drift = rel_rmse(runs[0]["x"], torch.load(os.path.join(TP_DIR, "files_latent.pt")))
    pipe_ok = (all(r["seed"] == FLUX_FILES_SEED for r in runs) and runs[1]["hits"] == hist
               and len(hist) == 22 and torch.equal(runs[0]["x"], runs[1]["x"])
               and len(runs[0]["paths"]) == 1 and runs[1]["paths"] == []
               and read_png(runs[0]["paths"][0]).shape == (1024, 1024, 3)
               and drift <= TOL_TP_LATENT_REL_RMSE)
    log(f"{label} pipeline: seeds {[r['seed'] for r in runs]} (rank 1 drew {TP_OTHER_DRAW}), "
        f"FBCache {''.join('H' if h else '.' for h in hist)} on both: "
        f"{runs[1]['hits'] == hist}, PNGs {[r['paths'] for r in runs]}, final latent against "
        f"phase 18's rel RMSE {drift:.4g} (tol {TOL_TP_LATENT_REL_RMSE}), the ranks' equal: "
        f"{torch.equal(runs[0]['x'], runs[1]['x'])}: {'ok' if pipe_ok else 'FAIL'}")
    ok = ok and pipe_ok
    for r, run in enumerate(runs):
        lok = tp_launch_check(f"{label} pipeline rank {r}", run["launches"], calls)
        ar_ok = run["all_reduces"] == n_ar and run["widths"] == {FLUX_H: n_ar}
        steps = run["step_times"]
        log(f"{label} pipeline rank {r}: {run['all_reduces']} all-reduces (plan {n_ar}) "
            f"{'ok' if ar_ok else 'FAIL'}; {run['wall']:.3f} s/image, "
            f"{(len(steps) - 1) / (steps[-1] - steps[0]):.3f} it/s, device peak "
            f"{run['peak_gib']:.2f} GiB ({gpu}; two ranks on one card, gloo through the host)")
        ok = ok and lok and ar_ok
        paths[f"flux_tp_spmd_pipeline_rank{r}"] = run["launches"]
    e2e = {"ranks_s": ranks_s, "s_per_image": runs[0]["wall"],
           "forward_s": {m: res[0][f"{m}_forward"]["s"] for m in ("spmd", "q8")},
           "load_s": {m: res[0][f"{m}_config"]["load_s"] for m in ("spmd", "q8")},
           "peak_gib_by_rank": [r["peak_gib"] for r in res], "latent_drift": drift,
           "fbcache_hits": hits, "gpu": gpu,
           "note": "two ranks on one card, all-reduces through gloo over the host"}
    plans = {f"flux_tp_spmd_dit_call_rank{r}": spmd_plan for r in range(TP)}
    plans.update({f"flux_tp_q8_dit_call_rank{r}": q8_plan for r in range(TP)})
    plans.update({f"flux_tp_spmd_pipeline_rank{r}": calls for r in range(TP)})
    return ok, paths, plans, e2e


# --------------------------------------------------------------------------
# The flow-matching trainer on one card (phase 24)
# --------------------------------------------------------------------------

TRAIN_DIR = os.path.join(OUT_DIR, "train")  # the checkpoint; removed after the phase
TRAIN_DEPTH = (2, 2)  # double and single blocks: Flux.1-dev's 19 and 38 cut to fit
TRAIN_TXT = 512
TRAIN_SIDE = 128  # the latent's side: 1024^2 pixels, 4096 image tokens
TRAIN_SEED = 24  # the weights' draw on the card
TRAIN_BATCH_SEED = 3
TRAIN_STEPS = 5
TRAIN_SAVE_AT = 2  # the checkpoint is written after this step
# the learning rate of phase 24's AdamW (optax adamw's arithmetic otherwise):
# at this width adamw(1e-4)'s first step, which moves every weight by ~1e-4
# in its gradient's sign, took the loss from 3.34 to 33.1 (H100, 700 W),
# and five steps ended above the first
TRAIN_LR = 1e-5
# leaves whose gradients the ranks hold against the one device's
TRAIN_WATCHED = ("img_in.weight", "double_blocks.1.img_attn.qkv.weight",
                 "double_blocks.1.img_mod.lin.weight")
# a step's all-reduces over "model" at TP = 2 and depth (2, 2): forward, the
# 4 row-parallel sums of each double block and 1 of each single block;
# backward, as many column-parallel inputs (width 3072) and the QKNorm
# scales (4 a double block, 2 a single block; width 128); remat recomputes
# the forward of the blocks after double block 0 (4 + 2 more)
TRAIN_FORWARD = 4 * TRAIN_DEPTH[0] + TRAIN_DEPTH[1]
TRAIN_SCALES = 4 * TRAIN_DEPTH[0] + 2 * TRAIN_DEPTH[1]
TRAIN_REMAT = 4 * (TRAIN_DEPTH[0] - 1) + TRAIN_DEPTH[1]
# the first loss on 2 ranks against one device's (f32, the row-parallel
# partials summed in another order), and scan + remat against unrolled
TOL_TRAIN_LOSS_REL = 1e-5
# a watched gradient, a rank's slice, against one device's: relative RMS
# error. f32 sums in another order read ~1e-6 to 1e-4 on the CPU tests'
# small model; a rank's partial gradient (a missing all-reduce) reads ~0.5
TOL_TRAIN_GRAD_REL_RMSE = 1e-3
# step 3's loss after the restore against the uninterrupted run's
TOL_TRAIN_RESUME_REL = 1e-6


def train_config():
    """Flux.1-dev at full width (hidden 3072, 24 heads, MLP 4.0, T5 width
    4096, CLIP 768, axes (16, 56, 56)) in f32, depth cut to TRAIN_DEPTH."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    return dataclasses.replace(flux.FLUX_DEV, depth=TRAIN_DEPTH[0],
                               depth_single_blocks=TRAIN_DEPTH[1], dtype=torch.float32)


def train_params(cfg):
    """``init_params``' distributions (normal(0, in^-0.5) weights, zero
    biases, unit norm scales) drawn on the card from TRAIN_SEED: the same
    numbers in every process, 1.02e9 f32 at this depth (a numpy draw would
    take tens of seconds per process)."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    out = {}
    for key, shape, kind in flux._layout(cfg):
        if kind == "lin":
            out[key] = torch.randn(shape, generator=gen, device="cuda") * shape[1] ** -0.5
        else:
            out[key] = (torch.ones if kind == "scale" else torch.zeros)(shape, device="cuda")
    return out


def train_trainer(n_data, n_model, cfg, scan_blocks=False, remat=False):
    """``build_sharded_trainer``'s (mesh, params, opt_state, step,
    make_batch), built from its parts on ``train_params`` with AdamW at
    TRAIN_LR, the full draw freed once the rank's leaves are cut from it."""
    import torch

    from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
    from lightdiffusion_next_tpu_torch.parallel import trainer

    mesh = None if n_data * n_model == 1 else mesh_mod.make_mesh(n_data, n_model)
    params, cfg = trainer._local(train_params(cfg), cfg, mesh, "cuda", scan_blocks)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, remat_blocks=remat)
    optimizer, step = trainer.make_train_step(cfg, trainer.AdamW(learning_rate=TRAIN_LR),
                                              mesh=mesh)
    params = trainer._trainable(params)
    return mesh, params, optimizer.init(params), step, trainer.batch_maker(cfg, mesh, "cuda")


def timed_step(step, p, o, batch):
    """One train step, synced: (params, opt_state, loss, seconds, peak GiB,
    the "model" all-reduces forward and backward and their widths, the
    kernels launched)."""
    import torch

    from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mesh_mod.reset_counts()
    t0 = time.perf_counter()
    p, o, loss = step(p, o, batch)
    loss = float(loss)
    torch.cuda.synchronize()
    ar = mesh_mod.all_reduce
    return p, o, loss, {"s": time.perf_counter() - t0,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "forward": ar.calls, "forward_widths": dict(ar.widths),
                        "backward": ar.backward_calls,
                        "backward_widths": dict(ar.backward_widths),
                        "launched": sum(read_launches().values())}


def host_state(params, opt_state):
    """{name: (param, mu, nu)} on the host, and the count."""
    from lightdiffusion_next_tpu_torch.parallel import trainer

    out = {n: tuple(x.detach().to("cpu", copy=True)
                    for x in (t, opt_state.state[t]["exp_avg"], opt_state.state[t]["exp_avg_sq"]))
           for n, t in trainer.leaves(params)}
    return out, {float(opt_state.state[t]["step"]) for _, t in trainer.leaves(params)}


def train_rank(rank, store):
    """A rank of phase 24: the process group (gloo), ``train_rank_flow``,
    its results to ``TRAIN_DIR/rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, TP), rank=rank, world_size=TP,
                            timeout=datetime.timedelta(seconds=TP_GLOO_TIMEOUT_S))
    try:
        torch.save(train_rank_flow(rank), os.path.join(TRAIN_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_rank_flow(rank):
    """On this rank: TP 1x2, unrolled, TRAIN_STEPS steps on one batch fed
    by ``prefetch_to_mesh`` (the watched gradients after the first, the
    checkpoint after TRAIN_SAVE_AT, written and timed); a fresh trainer
    restored from it, held bit for bit to the state saved and stepped once;
    scan + remat's first step; DP 2x1's first step, rank 0's params
    broadcast and held bit for bit to rank 1's."""
    import torch
    import torch.distributed as dist

    from lightdiffusion_next_tpu_torch.parallel import data as data_mod
    from lightdiffusion_next_tpu_torch.parallel import trainer

    cfg = train_config()
    res = {"steps": []}
    mesh, p, o, step, make_batch = train_trainer(1, TP, cfg)
    host_batch = {k: v.cpu() for k, v in make_batch(1, TRAIN_SIDE, TRAIN_SIDE, TRAIN_TXT,
                                                     seed=TRAIN_BATCH_SEED).items()}
    loader = data_mod.prefetch_to_mesh((host_batch for _ in range(TRAIN_STEPS)), mesh)
    ckpt = os.path.join(TRAIN_DIR, "ckpt")
    for i, batch in enumerate(loader, 1):
        p, o, loss, info = timed_step(step, p, o, batch)
        res["steps"].append(dict(info, loss=loss))
        if i == 1:
            res["grads"] = {n: p[n].grad.cpu() for n in TRAIN_WATCHED}
        if i == TRAIN_SAVE_AT:
            saved, count = host_state(p, o)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.save_checkpoint(ckpt, p, o, step=i, mesh=mesh)
            res["save_s"] = time.perf_counter() - t0
    res["transferred"] = loader.transferred
    del p, o, step, loader
    gc.collect()
    torch.cuda.empty_cache()

    mesh, p, o, step, make_batch = train_trainer(1, TP, cfg)
    t0 = time.perf_counter()
    p, o, n = trainer.restore_checkpoint(ckpt, p, o, mesh=mesh)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    restored, rcount = host_state(p, o)
    res["restored_equal"] = (n == TRAIN_SAVE_AT and rcount == count
                             and sorted(restored) == sorted(saved)
                             and all(torch.equal(a, b) for name in saved
                                     for a, b in zip(saved[name], restored[name])))
    res["restored_leaves"] = len(restored)
    del saved, restored
    p, o, loss, info = timed_step(step, p, o, make_batch(1, TRAIN_SIDE, TRAIN_SIDE, TRAIN_TXT,
                                                         seed=TRAIN_BATCH_SEED))
    res["resumed"] = dict(info, loss=loss)
    del p, o, step
    gc.collect()
    torch.cuda.empty_cache()

    _, p, o, step, make_batch = train_trainer(1, TP, cfg, scan_blocks=True, remat=True)
    p, o, loss, info = timed_step(step, p, o, make_batch(1, TRAIN_SIDE, TRAIN_SIDE, TRAIN_TXT,
                                                         seed=TRAIN_BATCH_SEED))
    res["remat"] = dict(info, loss=loss)
    del p, o, step
    gc.collect()
    torch.cuda.empty_cache()

    _, p, o, step, make_batch = train_trainer(TP, 1, cfg)
    p, o, loss, info = timed_step(step, p, o, make_batch(TP, TRAIN_SIDE, TRAIN_SIDE, TRAIN_TXT,
                                                         seed=TRAIN_BATCH_SEED))
    res["dp"] = dict(info, loss=loss)
    equal = True
    for _, t in trainer.leaves(p):
        buf = t.detach().clone() if rank == 0 else torch.empty_like(t)
        dist.broadcast(buf, src=0)
        equal = equal and torch.equal(buf, t.detach())
    res["dp"]["equal_to_rank0"] = equal
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def run_train_ranks():
    """Spawn phase 24's two ranks and wait for both, at most
    ``TP_TIMEOUT_S``: a rank that fails or is late fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(train_rank, args=(os.path.join(TRAIN_DIR, "store"),), nprocs=TP,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + TP_TIMEOUT_S
    while not ctx.join(timeout=5.0):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"phase 24: the ranks ran past {TP_TIMEOUT_S} s")


def grad_slice(name, g, rank, cfg):
    """Rank ``rank``'s slice, at TP = 2, of a one-device gradient: qkv rows
    head-interleaved (``layout.to_tp_layout``) and cut; replicated leaves
    whole."""
    import torch

    from lightdiffusion_next_tpu_torch.parallel import layout, sharding

    spec = sharding.flux_param_spec(name)
    if name.endswith("attn.qkv.weight"):
        g = g[torch.as_tensor(layout.qkv_interleave_perm(cfg.num_heads, cfg.head_dim))]
    return sharding.shard_leaf(g, spec, rank, TP)


def phase_train(gpu):
    """Phase 24: the flow-matching trainer (``parallel.trainer``) at
    Flux.1-dev's full width in f32, depth cut to TRAIN_DEPTH (2 double, 2
    single blocks of 19 and 38: 1.02e9 params, 16 B each with the gradient
    and two moments), a 1024^2 latent (4096 image tokens) and TRAIN_TXT
    text tokens, batch 1 per "data" rank, weights drawn on the card.
    (a) one device, 1x1, here: the first step's loss, the watched
    gradients, s/step and the peak; (c) the loss under
    ``attention_backend="flash"`` reaches K2 at 4608 tokens and its
    backward must raise the guard's error. Then, freed, two ranks on the one card over gloo
    (``train_rank_flow``): (b) TP 1x2 against (a) and the all-reduce plan,
    five steps from ``prefetch_to_mesh`` (the last loss below the first),
    the checkpoint round trip, scan + remat (the first loss within 1e-5 of
    unrolled, a lower peak); (d) DP 2x1, the ranks' params equal after a
    step. AdamW at TRAIN_LR throughout. No step launches a kernel. Returns
    (ok, e2e)."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.ops import grad_guard
    from lightdiffusion_next_tpu_torch.parallel import trainer

    cfg = train_config()
    os.makedirs(TRAIN_DIR, exist_ok=True)
    label = "train"
    ok = True
    try:
        _, p, o, step, make_batch = train_trainer(1, 1, cfg)
        batch = make_batch(1, TRAIN_SIDE, TRAIN_SIDE, TRAIN_TXT, seed=TRAIN_BATCH_SEED)
        p, o, loss, one = timed_step(step, p, o, batch)
        grads = {n: p[n].grad.cpu() for n in TRAIN_WATCHED}
        one_ok = math.isfinite(loss) and one["launched"] == 0 and one["forward"] == 0
        log(f"{label} (a) one device: loss {loss:.8g}, {one['s']:.3f} s/step, peak "
            f"{one['peak_gib']:.2f} GiB, {one['launched']} kernel launches ({gpu}) "
            f"{'ok' if one_ok else 'FAIL'}")
        ok = ok and one_ok
        launches = None
        saved = config.get_config()
        config.set_config(dataclasses.replace(saved, attention_backend="flash"))
        try:
            reset_launches()
            o.zero_grad(set_to_none=True)
            trainer.flow_matching_loss(p, batch, cfg).backward()
            guard_ok = False
            err = "no error"
        except grad_guard.NoBackwardError as e:
            launches = read_launches()["flash_attention"]
            guard_ok = "flash_attention (K2)" in str(e) and launches > 0
            err = str(e)
        finally:
            config.set_config(saved)
        log(f"{label} (c) attention_backend='flash': {err!r}, K2 launched {launches} times in "
            f"the forward {'ok' if guard_ok else 'FAIL'}")
        ok = ok and guard_ok
        del p, o, step, batch
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        run_train_ranks()
        ranks_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(TRAIN_DIR, f"rank{r}.pt"), weights_only=False)
               for r in range(TP)]
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    plan = {"forward": TRAIN_FORWARD, "forward_widths": {FLUX_H: TRAIN_FORWARD},
            "backward": TRAIN_FORWARD + TRAIN_SCALES,
            "backward_widths": {FLUX_H: TRAIN_FORWARD, 128: TRAIN_SCALES}, "launched": 0}
    remat_plan = dict(plan, forward=TRAIN_FORWARD + TRAIN_REMAT,
                      forward_widths={FLUX_H: TRAIN_FORWARD + TRAIN_REMAT})
    for r, rr in enumerate(res):
        steps = rr["steps"]
        first = steps[0]["loss"]
        rel = abs(first - loss) / abs(loss)
        errs = {n: rel_rmse(rr["grads"][n], grad_slice(n, grads[n], r, cfg))
                for n in TRAIN_WATCHED}
        counts_ok = all({k: s[k] for k in plan} == plan for s in steps)
        b_ok = (rel <= TOL_TRAIN_LOSS_REL and max(errs.values()) <= TOL_TRAIN_GRAD_REL_RMSE
                and counts_ok and len(steps) == TRAIN_STEPS and rr["transferred"] == TRAIN_STEPS
                and steps[-1]["loss"] < first)
        log(f"{label} (b) TP 1x2 rank {r}: first loss {first:.8g} against one device's "
            f"(rel {rel:.3g}, tol {TOL_TRAIN_LOSS_REL}); gradients' rel RMSE "
            f"{ {n: f'{e:.3g}' for n, e in errs.items()} } (tol {TOL_TRAIN_GRAD_REL_RMSE}); "
            f"losses {[s['loss'] for s in steps]} from prefetch_to_mesh "
            f"({rr['transferred']} batches); all-reduces a step {steps[0]['forward']} forward "
            f"{steps[0]['forward_widths']}, {steps[0]['backward']} backward "
            f"{steps[0]['backward_widths']} (plan {plan['forward']} and {plan['backward']}), "
            f"launches {[s['launched'] for s in steps]}; {[round(s['s'], 3) for s in steps]} "
            f"s/step, peak {steps[0]['peak_gib']:.2f} GiB ({gpu}; gloo through the host) "
            f"{'ok' if b_ok else 'FAIL'}")
        resumed = rr["resumed"]["loss"]
        uninterrupted = steps[TRAIN_SAVE_AT]["loss"]
        res_rel = abs(resumed - uninterrupted) / abs(uninterrupted)
        ck_ok = rr["restored_equal"] and res_rel <= TOL_TRAIN_RESUME_REL
        log(f"{label} (b) checkpoint rank {r}: written after step {TRAIN_SAVE_AT} in "
            f"{rr['save_s']:.2f} s, read into a fresh trainer in {rr['restore_s']:.2f} s; "
            f"{rr['restored_leaves']} leaves with their moments and count bit for bit: "
            f"{rr['restored_equal']}; step {TRAIN_SAVE_AT + 1} resumed {resumed:.8g} against "
            f"{uninterrupted:.8g} (rel {res_rel:.3g}, tol {TOL_TRAIN_RESUME_REL}) ({gpu}) "
            f"{'ok' if ck_ok else 'FAIL'}")
        rm = rr["remat"]
        rm_rel = abs(rm["loss"] - first) / abs(first)
        rm_ok = ({k: rm[k] for k in remat_plan} == remat_plan and rm_rel <= TOL_TRAIN_LOSS_REL
                 and rm["peak_gib"] < steps[0]["peak_gib"])
        log(f"{label} (b) scan + remat rank {r}: first loss {rm['loss']:.8g} (rel {rm_rel:.3g} "
            f"to unrolled), {rm['forward']} forward all-reduces (plan {remat_plan['forward']}), "
            f"{rm['backward']} backward, peak {rm['peak_gib']:.2f} GiB against unrolled's "
            f"{steps[0]['peak_gib']:.2f}, {rm['s']:.3f} s/step ({gpu}) {'ok' if rm_ok else 'FAIL'}")
        dp = rr["dp"]
        dp_ok = (math.isfinite(dp["loss"]) and dp["equal_to_rank0"] and dp["forward"] == 0
                 and dp["backward"] == 0 and dp["launched"] == 0)
        log(f"{label} (d) DP 2x1 rank {r}: loss {dp['loss']:.8g}, params equal to rank 0's "
            f"bit for bit: {dp['equal_to_rank0']}, {dp['s']:.3f} s/step (gloo's mean "
            f"all-reduce of 1.02e9 gradients included), peak {dp['peak_gib']:.2f} GiB ({gpu}) "
            f"{'ok' if dp_ok else 'FAIL'}")
        ok = ok and b_ok and ck_ok and rm_ok and dp_ok
    r0 = res[0]
    e2e = {"one_device_s_per_step": one["s"], "one_device_peak_gib": one["peak_gib"],
           "one_device_loss": loss,
           "tp_s_per_step": [[s["s"] for s in rr["steps"]] for rr in res],
           "tp_peak_gib": [rr["steps"][0]["peak_gib"] for rr in res],
           "tp_losses": [s["loss"] for s in r0["steps"]],
           "remat_peak_gib": [rr["remat"]["peak_gib"] for rr in res],
           "remat_s_per_step": [rr["remat"]["s"] for rr in res],
           "dp_s_per_step": [rr["dp"]["s"] for rr in res],
           "dp_peak_gib": [rr["dp"]["peak_gib"] for rr in res],
           "checkpoint_save_s": [rr["save_s"] for rr in res],
           "checkpoint_restore_s": [rr["restore_s"] for rr in res],
           "ranks_s": ranks_s, "gpu": gpu,
           "note": "two ranks on one card, all-reduces through gloo over the host; "
                   "not a benchmark metric"}
    return ok, e2e


def variant_bound(b, h, lq, lk, d, qk_int8):
    """A sage variant's least time: Q.K^T at the int8 rate (``qk_int8``) or
    the bf16 rate plus P.V at the bf16 rate, against one exp per score at
    the SFU rate and the bytes of bf16 q, k, v and out."""
    ops = 2.0 * b * h * lq * lk * d
    t_mma = ops / (PEAK_INT8_OPS if qk_int8 else PEAK_BF16_FLOPS) + ops / PEAK_BF16_FLOPS
    t_ops = max(t_mma, b * h * lq * lk / PEAK_EXP2)
    t_bytes = 2.0 * b * h * d * (2 * lq + 2 * lk) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bf16_rate_bound(m, k, n, bias, residual):
    """The bf16-rate W8A8 matmul's least time: ``int8_bound``'s bytes,
    2 M K N operations at the bf16 rate."""
    nbytes = (m * k + k * n + 4.0 * n * (2 if bias else 1) + 4.0 * m
              + 2.0 * m * n * (2 if residual else 1))
    t_ops, t_bytes = 2.0 * m * k * n / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_variants(gpu):
    """Phase 25: the flag variants at their shapes (see the module's
    docstring). Returns (ok, {name: per_kernel entry}, the counts of the
    drive, the calls of the drive)."""
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    log("gpu:", gpu)
    ok = True
    gen = torch.Generator(device="cuda").manual_seed(25)

    def timed(fn):
        return cuda_ms(fn, repeats_for(fn, budget_ms=150.0))

    sage_inputs = {shape: make_inputs(*shape, "bf16", gen) for shape in VARIANT_SAGE_SHAPES}
    w8_inputs = {}
    for name, shapes in VARIANT_W8A8_SHAPES.items():
        for m, k, n in shapes:
            x = activations(m, k, gen)
            if "stacked" in name:
                q3, cs3 = w8_stack(2, k, n, gen)
                w = (q3, cs3, 1)
            else:
                w8 = w8_weight(k, n, gen)
                w = (w8.q, w8.col_scales, None)
            gate = torch.randn((1, n), generator=gen, device="cuda")
            extra = {"gate": gate, "bias": (0.1 * torch.randn((1, n), generator=gen,
                                                               device="cuda") * gate),
                     "r": activations(m, n, gen)}
            w8_inputs[(name, m, k, n)] = (x, w, extra)

    def ep_operands(x, w, extra):
        xq, sx = qm.row_quantize_fused(x)
        q, cs, idx = w
        cs_blk = cs[idx] if idx is not None else cs
        cs_eff = (cs_blk * extra["gate"]).reshape(-1).contiguous()
        return xq, sx, q, idx, cs_eff, extra["bias"].reshape(-1).contiguous()

    def w8_call(name, x, w, extra):
        q, cs, idx = w
        if name == "w8a8_matmul_bf16_mxu":
            return qm.w8a8_matmul(x, q, cs, int8_mxu=False)
        if name == "w8a8_matmul_stacked_bf16_mxu":
            return qm.w8a8_matmul_stacked(x, q, cs, idx, int8_mxu=False)
        xq, sx, q, idx, cs_eff, bias = ep_operands(x, w, extra)
        operand = q if idx is None else (q, idx)
        return qm.w8a8_matmul_ep(xq, sx, operand, cs_eff, bias, residual=extra["r"],
                                 int8_mxu=False)

    # the drive: every count at 0, one call of each variant at each shape
    reset_launches()
    outs, calls = {}, {}
    for shape, (q, k, v) in sage_inputs.items():
        for name, (int8_mxu, pv_int8) in SAGE_VARIANT_FLAGS.items():
            outs[(name,) + shape] = sa.sage_attention(q, k, v, int8_mxu=int8_mxu,
                                                      pv_int8=pv_int8)
            calls[(name,) + shape + ("bf16",)] = 1
    for key, (x, w, extra) in w8_inputs.items():
        outs[key] = w8_call(key[0], x, w, extra)
        calls[key] = 1
    torch.cuda.synchronize()
    launches = read_launches()
    for name in VARIANT_KERNELS:
        want = sum(1 for key in calls if key[0] == name)
        good = launches[name] == want > 0
        ok = ok and good
        log(f"launches kernel variants {name}: {launches[name]} (one per shape: {want}) "
            f"{'ok' if good else 'FAIL'}")
    log("launches kernel variants, the other counters:",
        {n: c for n, c in launches.items() if c and n not in VARIANT_KERNELS})

    per_kernel = {}

    def sage_check(out, ref):
        return fa.agreement(out, ref, max_ulps=sa.MAX_ULPS, rel_rmse_limit=sa.REL_RMSE_LIMIT)

    def w8_check(out, ref):
        return {**fa.agreement(out, ref, max_ulps=qm.MAX_ULPS, rel_rmse_limit=qm.REL_RMSE_LIMIT),
                "mismatches": int((out != ref).sum().item())}

    for shape, (q, k, v) in sage_inputs.items():
        b, h, l, d = shape
        ops8 = sa.prepare_kernel(q, k, v)
        k4 = sa._launch(q, ops8)
        k4_ms = timed(lambda: sa._launch(q, ops8))
        k4_wrapper_ms = timed(lambda: sa.sage_attention(q, k, v))
        library_ms = timed(lambda: F.scaled_dot_product_attention(q, k, v))
        torch.cuda.synchronize()
        for name, (int8_mxu, pv_int8) in SAGE_VARIANT_FLAGS.items():
            out = outs[(name,) + shape]
            ref = sa.sage_attention_plain(q, k, v, pv_int8=pv_int8)
            check = sage_check(out, ref)
            ops = sa.prepare_kernel(q, k, v, pv_int8=pv_int8, int8_mxu=int8_mxu)
            prep = sa.prep_agreement(
                ops, sa.prepare_plain(q, k, v, pv_int8=pv_int8, int8_mxu=int8_mxu), d)
            extra = {"prepare": prep}
            check = {**check, "ok": check["ok"] and prep["ok"]}
            if not int8_mxu:  # the same integers as with int8_mxu on: bit for bit
                twin = k4 if pv_int8 else outs[("sage_attention_pv_bf16",) + shape]
                diff = (out.float() - twin.float()).abs()
                same = bool(torch.equal(out, twin))
                extra["against_int8_mxu"] = {
                    "kernel": "K4" if pv_int8 else "sage_attention_pv_bf16",
                    "bit_for_bit": same,
                    "max_abs_diff": diff.max().item(), "differing": int((diff > 0).sum().item())}
                if not same:
                    log(f"FAIL: {name} at {shape} differs from {extra['against_int8_mxu']}")
                check = {**check, "ok": check["ok"] and same}
            kt = ops.kvimg.shape[1]
            faults = {
                SAGE_FAULTS[0]: fault_entry(sage_check(
                    sa._launch_variant(q, ops, int8_mxu, pv_int8, kv_tiles=kt - 1), ref)),
                SAGE_FAULTS[1]: fault_entry(sage_check(
                    sa._launch_variant(q, ops, int8_mxu, pv_int8, use_sk=False), ref)),
            }
            ms = timed(lambda: sa.sage_attention(q, k, v, int8_mxu=int8_mxu, pv_int8=pv_int8))
            kernel_ms = timed(lambda: sa._launch_variant(q, ops, int8_mxu, pv_int8))
            plain_ms = cuda_ms(lambda: sa.sage_attention_plain(q, k, v, pv_int8=pv_int8), 1)
            bound_ms, bound_by = variant_bound(b, h, l, l, d, qk_int8=int8_mxu)
            record_shape(per_kernel, (name,) + shape + ("bf16",), check, faults, {
                "shape": list(shape), "dtype": "bf16 in and out", "ms": ms,
                "kernel_ms": kernel_ms, "k4_ms": k4_ms, "k4_wrapper_ms": k4_wrapper_ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, **extra})
            del out, ref
        for name in SAGE_VARIANT_FLAGS:
            del outs[(name,) + shape]
        del q, k, v, ops8, k4
        torch.cuda.empty_cache()
    sage_inputs.clear()

    for key, (x, w, extra_in) in w8_inputs.items():
        name, m, k, n = key
        q, cs, idx = w
        out = outs.pop(key)
        lib_codes = qm.row_quantize_fused(x)[0]
        lib = lambda: torch._int_mm(lib_codes, (q if idx is None else q[idx]).t())  # noqa: E731
        try:
            library_ms = timed(lib)
        except RuntimeError as e:  # the yardstick only; the port never calls it
            log(f"torch._int_mm at {(m, k, n)}: {e}")
            library_ms = None
        # the same-rate yardstick: torch.matmul on the codes cast to bf16 (no
        # epilogue, the casts outside the timing)
        a16 = lib_codes.to(torch.bfloat16)
        b16 = (q if idx is None else q[idx]).t().to(torch.bfloat16)
        matmul_bf16_ms = timed(lambda: torch.matmul(a16, b16))
        del a16, b16
        if name in ("w8a8_matmul_bf16_mxu", "w8a8_matmul_stacked_bf16_mxu"):
            xq, sx = qm.row_quantize_fused(x)
            cs_k = (cs if idx is None else cs[idx]).reshape(-1).contiguous()
            bias = r = None
            if idx is None:
                ref = qm.w8a8_matmul_plain(x, q, cs, int8_mxu=False)
                exact = qm.w8a8_matmul_plain(x, q, cs)
            else:
                ref = qm.w8a8_matmul_stacked_plain(x, q, cs, idx, int8_mxu=False)
                exact = qm.w8a8_matmul_stacked_plain(x, q, cs, idx)
            launch_cs = cs_k if idx is None else cs
            run = lambda: w8_call(name, x, w, extra_in)  # noqa: E731
        else:
            xq, sx, q, idx, cs_k, bias = ep_operands(x, w, extra_in)
            r = extra_in["r"]
            operand = q if idx is None else (q, idx)
            ref = qm.w8a8_matmul_ep_plain(xq, sx, operand, cs_k, bias, residual=r,
                                          int8_mxu=False)
            exact = qm.w8a8_matmul_ep_plain(xq, sx, operand, cs_k, bias, residual=r)
            launch_cs = cs_k
            run = lambda: qm.w8a8_matmul_ep(xq, sx, operand, cs_k, bias,  # noqa: E731
                                            residual=r, int8_mxu=False)
        ep = bias is not None
        sx1 = sx.reshape(-1)
        check = w8_check(out, ref)
        ones = torch.ones_like(launch_cs)
        faults = {
            VARIANT_W8A8_FAULTS[0]: fault_entry(w8_check(qm._launch_w8a8(
                xq, sx1, q, launch_cs, bias, r, k=k - qm.W8A8_BF16_BK, ep=ep, idx=idx,
                int8_mxu=False), ref)),
            VARIANT_W8A8_FAULTS[1]: fault_entry(w8_check(qm._launch_w8a8(
                xq, sx1, q, ones, bias, r, ep=ep, idx=idx, int8_mxu=False), ref)),
        }
        against = qm.matmul_agreement(out, exact)
        ms = timed(run)
        kernel_ms = timed(lambda: qm._launch_w8a8(xq, sx1, q, launch_cs, bias, r, ep=ep,
                                                  idx=idx, int8_mxu=False))
        int8_ms = timed(lambda: qm._launch_w8a8(xq, sx1, q, launch_cs, bias, r, ep=ep,
                                                idx=idx))
        blk = q if idx is None else q[idx]
        plain_ms = cuda_ms(lambda: qm._epilogue_plain(xq, sx, blk, cs_k, bias, r,
                                                      int8_mxu=False), 2)
        bound_ms, bound_by = bf16_rate_bound(m, k, n, ep, r is not None)
        record_shape(per_kernel, key, check, faults, {
            "shape": [m, k, n], "dtype": "int8 codes at the bf16 rate, bf16 out"
            + (", bf16 residual" if r is not None else ""),
            "ms": ms, "kernel_ms": kernel_ms, "int8_kernel_ms": int8_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "matmul_bf16_ms": matmul_bf16_ms,
            "tile": qm.W8A8_BF16_TILES[qm.w8a8_bf16_tile(m, n, k)],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "against_integer_plain": {k_: against[k_] for k_ in ("max_abs_err", "mismatches",
                                                                "ok")}})
        del out, ref, exact
    w8_inputs.clear()
    torch.cuda.empty_cache()
    ok = ok and all(per_kernel[name]["ok"] for name in VARIANT_KERNELS)
    return ok, per_kernel, launches, calls


# --------------------------------------------------------------------------
# The UNet's SD2-class branches (phase 26)
# --------------------------------------------------------------------------

LINEAR_DIR = os.path.join(OUT_DIR, "linear")  # phase 26 (a)'s asset roots, removed after
LINEAR_ROOTS = {"zero": os.path.join(LINEAR_DIR, "zero"), "adm": os.path.join(LINEAR_DIR, "adm")}
ADM_WIDTH = 768  # the pooled CLIP-L vector the CFG denoiser passes as y
ADM_SEED = 26
# Stability AI's v2-inference-v.yaml UNet: heads of 64 channels, linear
# transformer projections, a 1024-wide context (OpenCLIP-H's, which neither
# package has: the context is drawn from a seed)
SD21_UNET = dict(model_channels=320, channel_mult=(1, 2, 4, 4), num_res_blocks=(2, 2, 2, 2),
                 transformer_depth=(1, 1, 1, 0), transformer_depth_middle=1,
                 context_dim=1024, num_head_channels=64, use_linear_in_transformer=True)
SD21_SEED = 0  # init_params' draw
SD21_NOISE_SEED = 2601
SD21_CFG = 7.5
# rel RMSE of phase 26 (a)'s final latent, linear projections with a zeroed
# label embedding, against phase 17's at the same seed: the same function
# through a matmul instead of a 1x1 convolution, which may round otherwise
# (equal bit for bit on an H100 80GB HBM3 at 700 W, torch 2.11.0+cu128; a
# wrong projection or a y that leaks in moves it by O(0.1))
TOL_LINEAR_LATENT_REL_RMSE = 2e-2
# the mean absolute difference of the two PNGs, in 8-bit levels (0 there)
TOL_LINEAR_PNG_MEAN_LEVELS = 2.0


def linear_checkpoint(parts):
    """Phase 17's checkpoint tensors (``parts``: the file's dict) with every
    transformer ``proj_in``/``proj_out`` as its squeezed 2-D weight (the same
    function on the tokens) and a seeded label embedding: ``label_emb.0.0``
    (768 -> 1280) and ``label_emb.0.2`` (1280 -> 1280), f16 as the rest.
    Returns (the tensors with ``label_emb.0.2`` zeroed, with it seeded)."""
    import torch

    pre = "model.diffusion_model."
    out = {}
    for key, t in parts.items():
        if key.startswith(pre) and key.endswith(("proj_in.weight", "proj_out.weight")):
            t = t[:, :, 0, 0].contiguous()
        out[key] = t
    td = out[pre + "time_embed.0.weight"].shape[0]
    gen = torch.Generator().manual_seed(ADM_SEED)
    first = {f"{pre}label_emb.0.0.weight": torch.randn(td, ADM_WIDTH, generator=gen)
             * ADM_WIDTH**-0.5,
             f"{pre}label_emb.0.0.bias": torch.randn(td, generator=gen) * 0.1}
    second = {f"{pre}label_emb.0.2.weight": torch.randn(td, td, generator=gen) * td**-0.5,
              f"{pre}label_emb.0.2.bias": torch.randn(td, generator=gen) * 0.1}
    first = {k: v.half() for k, v in first.items()}
    zero = {**out, **first, **{k: torch.zeros_like(v).half() for k, v in second.items()}}
    return zero, {**out, **first, **{k: v.half() for k, v in second.items()}}


def write_linear_assets():
    """The two checkpoints of phase 26 (a), each under its own asset root
    beside links to phase 17's LoRA and embeddings. Returns the linear
    UNet's detected config."""
    from lightdiffusion_next_tpu_torch.utils import state_dict as sd_utils

    shutil.rmtree(LINEAR_DIR, ignore_errors=True)
    parts = sd_utils.load_torch_file(DEFAULTS_CKPT)
    files = dict(zip(("zero", "adm"), linear_checkpoint(parts)))
    del parts
    for name, tensors in files.items():
        root = LINEAR_ROOTS[name]
        write_safetensors(os.path.join(root, "checkpoints", os.path.basename(DEFAULTS_CKPT)),
                          tensors)
        for sub in ("loras", "embeddings"):
            os.symlink(os.path.join(DEFAULTS_DIR, sub), os.path.join(root, sub))
    unet_sd, _, _ = sd_utils.split_checkpoint(files["zero"])
    return sd_utils.detect_unet_config(unet_sd)


def rel_rmse_of(x, ref):
    x, ref = x.double(), ref.double()
    return ((x - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()


def linear_run(name, label):
    """One ``pipeline(prompt, 1024, 1024)`` call with every default from the
    asset root ``name`` after Python's random is seeded as before phase
    17's first call: the run, its launches, its VAE and its UNet's config."""
    import random

    from lightdiffusion_next_tpu_torch.pipelines import loader

    root = LINEAR_ROOTS[name]
    with defaults_assets(root):
        reset_launches()
        random.seed(DEFAULTS_RANDOM_SEED)
        run = run_default_pipeline(out=label)
        launches = read_launches()
        model, _, vae = loader.CheckpointLoaderSimple().load_checkpoint(
            os.path.join(root, "checkpoints", os.path.basename(DEFAULTS_CKPT)),
            os.path.join(root, "embeddings"))
    return run, launches, vae, model.config


def phase_linear_label_emb(gpu, def_calls, def_first):
    """Phase 26 (a): SD1.5 at full width from a checkpoint with linear
    transformer projections and a label embedding (``linear_checkpoint``),
    ``pipeline(prompt, 1024, 1024)`` with every default: with
    ``label_emb.0.2`` zeroed the final latent and PNG are phase 17's within
    ``TOL_LINEAR_*``; with it seeded the final latent moves (``y``
    arrives); K1 and K2 launch as phase 17's plan says. Returns (ok,
    launches, e2e)."""
    import random

    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.pipelines import loader

    t0 = time.perf_counter()
    detected = write_linear_assets()
    write_s = time.perf_counter() - t0
    log(f"SD1.5 linear + label_emb: wrote two {os.path.getsize(DEFAULTS_CKPT) / 1e9:.3f} GB "
        f"checkpoints in {write_s:.1f} s; detected {detected}")
    ok = detected.use_linear_in_transformer and detected.adm_in_channels == ADM_WIDTH
    first, launches, vae, cfg = linear_run("zero", "linear")
    ok = check_sd15_launches(launches, def_calls, "SD1.5 linear + label_emb",
                             ("packed_flash_attention", "flash_attention")) and ok
    out_ok, _ = check_hdr_output(first, vae, label="SD1.5 linear + label_emb")
    cfg_ok = cfg.use_linear_in_transformer and cfg.adm_in_channels == ADM_WIDTH
    ok = ok and out_ok and cfg_ok
    x = first["last"]["x"].float().cpu()
    ref_x, ref_png = def_first
    drift = rel_rmse_of(x, ref_x)
    levels = np.abs(read_png(first["paths"][0]).astype(np.float64)
                    - read_png(ref_png).astype(np.float64))
    same = drift <= TOL_LINEAR_LATENT_REL_RMSE and levels.mean() <= TOL_LINEAR_PNG_MEAN_LEVELS
    log(f"SD1.5 linear + label_emb (label_emb.0.2 zeroed) against phase 17 at the same seed: "
        f"final latent rel RMSE {drift:.4g} (tol {TOL_LINEAR_LATENT_REL_RMSE}), PNG mean "
        f"|diff| {levels.mean():.4g} levels (tol {TOL_LINEAR_PNG_MEAN_LEVELS}), max "
        f"{levels.max():.0f}; the loaded UNet's config {cfg}: {'ok' if same and cfg_ok else 'FAIL'}")
    ok = ok and same

    torch.cuda.reset_peak_memory_stats()
    with defaults_assets(LINEAR_ROOTS["zero"]):
        random.seed(DEFAULTS_RANDOM_SEED)
        timed = run_default_pipeline(out="linear")
    steps = timed["step_times"]
    it_s = (len(steps) - 1) / (steps[-1] - steps[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    repeat = torch.equal(timed["last"]["x"].float().cpu(), x)

    adm, adm_launches, _, _ = linear_run("adm", "linear_adm")
    adm_ok = check_sd15_launches(adm_launches, def_calls, "SD1.5 linear + seeded label_emb",
                                 ("packed_flash_attention", "flash_attention"))
    moved = rel_rmse_of(adm["last"]["x"].float().cpu(), x)
    adm_x_ok = bool(torch.isfinite(adm["last"]["x"]).all())
    y_ok = adm_x_ok and moved > TOL_LINEAR_LATENT_REL_RMSE
    log(f"SD1.5 linear + seeded label_emb: final latent rel RMSE {moved:.4g} against the "
        f"zeroed run (must exceed {TOL_LINEAR_LATENT_REL_RMSE}: y arrives): "
        f"{'ok' if y_ok else 'FAIL'}")
    ok = ok and adm_ok and y_ok
    loader.get_model_cache().clear()
    shutil.rmtree(LINEAR_DIR, ignore_errors=True)
    e2e = {"s_per_image": timed["wall"], "it_per_s": it_s, "peak_gib": peak,
           "first_run_s_per_image_with_load": first["wall"], "checkpoints_write_s": write_s,
           "latent_rel_rmse_vs_phase17": drift, "png_mean_abs_levels_vs_phase17": levels.mean(),
           "png_max_abs_levels_vs_phase17": float(levels.max()),
           "repeat_bit_for_bit": repeat, "label_emb_latent_rel_rmse": moved,
           "unet_config": str(detected), "gpu": gpu}
    log(f"SD1.5 linear + label_emb ({gpu}): {timed['wall']:.3f} s/image end to end; sampler "
        f"steps 2..{len(steps)}: {it_s:.3f} it/s; first run with the load {first['wall']:.3f} "
        f"s; peak memory {peak:.1f} GiB; the timed run bit for bit the first: {repeat}")
    return ok, launches, e2e


def sd21_calls(steps=20):
    """K1's calls of phase 26 (b)'s ``ksample``: SD2.1's UNet at a 128^2
    latent, ``dpmpp_2m_cfgpp`` over 20 karras steps, the pipeline's default
    multi-scale plan, MSW-MSA with its gate, CFG batch 2; no VAE."""
    from lightdiffusion_next_tpu_torch.models import unet
    from lightdiffusion_next_tpu_torch.sampling import ksampler, samplers
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    calls = {}
    unet_calls(_adder(calls), ksampler.sigmas_for(ModelSamplingDiscrete(), "karras", steps),
               128, 128, ms=samplers.MultiScale(enabled=True),
               cfg=unet.UNetConfig(**SD21_UNET))
    return calls


def sd21_run(model, conds, label):
    """One ``ksample`` of phase 26 (b): (the final latent, wall s, the time
    after each step, device synced)."""
    import torch

    from lightdiffusion_next_tpu_torch.sampling import ksampler, samplers

    step_times = []

    def on_step(info):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = ksampler.ksample(
            model, seed=SD21_NOISE_SEED, steps=20, cfg_scale=SD21_CFG,
            sampler_name="dpmpp_2m_cfgpp", scheduler="karras", positive=conds[0],
            negative=conds[1], latent_image=torch.zeros(1, 128, 128, 4, device="cuda"),
            ms=samplers.MultiScale(enabled=True), callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x = res.raw.float()
    log(f"SD2.1 UNet ksample ({label}): {wall:.3f} s, final latent {tuple(x.shape)} finite "
        f"{bool(torch.isfinite(x).all())}")
    return x, wall, step_times


def draw_sd21_params():
    """``init_params(SD21_UNET, seed=0)`` on a host thread (numpy releases
    the GIL while it draws): 866 M normal draws take 15-31 s of host time,
    so ``main`` starts them before phase 24, whose pace the gloo ranks set,
    and phase 26 (b) takes the result. Returns the future."""
    import concurrent.futures

    from lightdiffusion_next_tpu_torch.models import unet

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(unet.init_params, unet.UNetConfig(**SD21_UNET), SD21_SEED)
    pool.shutdown(wait=False)
    return future


def phase_sd21_heads(gpu, per_kernel, sd21_params):
    """Phase 26 (b): SD2.1's UNet head layout (``SD21_UNET``, bf16,
    ``init_params(seed=0)``, drawn by ``draw_sd21_params``: its future is
    ``sd21_params``) through ``ksample`` at 1024^2: K1 at d = 64 at
    each shape of its plan held to its plain version (two planted faults,
    times beside ``scaled_dot_product_attention`` and the bound), the
    launches against the plan, it/s and s/run, and the final latent against
    the same run on the plain attention route (logged). Returns (ok,
    launches, e2e, calls)."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import base, unet
    from lightdiffusion_next_tpu_torch.ops import window
    from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod

    calls = sd21_calls()
    log("plan SD2.1 UNet ksample:", {f"{k[0]} {k[1:]}": v for k, v in sorted(calls.items())})
    phase_kernels(new_shapes(calls, per_kernel), per_kernel)
    t0 = time.perf_counter()
    params = sd21_params.result()
    waited = time.perf_counter() - t0
    cfg = unet.UNetConfig(**SD21_UNET, dtype=torch.bfloat16)
    model = base.sd15_model(params, cfg=cfg)
    del params
    model = model.with_options(attn1_override_factory=window.make_msw_msa_factory(
        model_sampling=model.model_sampling))
    torch.cuda.synchronize()
    log(f"SD2.1 UNet: init_params(seed={SD21_SEED}) waited for {waited:.1f} s, on the card "
        f"in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.params.values())} params")
    gen = torch.Generator(device="cuda").manual_seed(SD21_NOISE_SEED)
    conds = [cfg_mod.CondInput(cross_attn=torch.randn(1, 77, 1024, generator=gen,
                                                      device="cuda"))
             for _ in range(2)]
    reset_launches()
    x, first_s, _ = sd21_run(model, conds, "first")
    launches = read_launches()
    ok = check_sd15_launches(launches, calls, "SD2.1 UNet ksample", ("packed_flash_attention",))
    shape_ok = tuple(x.shape) == (1, 128, 128, 4) and bool(torch.isfinite(x).all())
    x2, wall, steps = sd21_run(model, conds, "timed")
    it_s = (len(steps) - 1) / (steps[-1] - steps[0])
    saved = config.get_config()
    try:
        config.set_config(dataclasses.replace(saved, attention_backend="sdpa"))
        plain_x, plain_s, _ = sd21_run(model, conds, "plain attention")
    finally:
        config.set_config(saved)
    drift = rel_rmse_of(x, plain_x)
    log(f"SD2.1 UNet ({gpu}): {wall:.3f} s/run of 20 steps; steps 2..{len(steps)}: "
        f"{it_s:.3f} it/s; first run {first_s:.3f} s; the run again bit for bit "
        f"{torch.equal(x, x2)}; final latent rel RMSE against the plain attention route "
        f"{drift:.4g} (logged; plain run {plain_s:.3f} s); output "
        f"{'ok' if shape_ok else 'FAIL'}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    e2e = {"s_per_run": wall, "it_per_s": it_s, "first_run_s": first_s,
           "latent_rel_rmse_vs_plain_attention": drift, "plain_attention_run_s": plain_s,
           "gpu": gpu}
    return ok and shape_ok, launches, e2e, calls


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lightdiffusion_next_tpu_torch import config
        from lightdiffusion_next_tpu_torch.pipelines import loader
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    os.environ.setdefault("LDT_ASSET_ROOT", OUT_DIR)
    config.resolve_device("cuda")

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    line = timed("environment", phase_environment)
    timed("build", phase_build)
    sd_calls = attention_calls()
    sde_calls = attention_calls(sampler="dpmpp_sde_cfgpp")
    log("plan SD1.5:", {f"{k[0]} {k[1:]}": v for k, v in sorted(sd_calls.items())})
    log("plan SD1.5 defaults (dpmpp_sde_cfgpp):",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(sde_calls.items())})
    per_kernel = timed("sd15 kernels", phase_kernels, {**sd_calls, **sde_calls})
    ref_ok, _ = timed("sd15 reference", phase_reference)
    pipe_ok, sd_launches, sd_e2e, sd_models, sd_latent = timed(
        "sd15 pipeline", phase_pipeline, sd_calls)
    sage_plan = attention_calls(sage=True)
    timed("sage kernels", phase_sage_kernels, sage_plan, per_kernel)
    sage_ok, sage_launches, sage_e2e, sage_calls = timed(
        "sd15 sage pipeline", phase_sage_pipeline, sd_models, sd_latent)
    def_ok, def_launches, def_e2e, def_calls, def_first = timed(
        "sd15 defaults", phase_sd15_defaults, line)
    hires_ok, hires_launches, hires_e2e, hires_plan = timed(
        "sd15 hires-fix", phase_hires, line, per_kernel)
    i2i_ok, i2i_launches, i2i_e2e, i2i_plan = timed(
        "sd15 img2img", phase_img2img, line, per_kernel, def_e2e["png"])
    ad_ok, ad_launches, ad_e2e, ad_plan = timed(
        "sd15 adetailer", phase_adetailer, line, per_kernel)
    webui_ok, webui_launches, webui_e2e, webui_calls = timed(
        "sd15 webui", phase_webui, line, per_kernel, def_calls)
    loader.get_model_cache().clear()
    seeded_sd15_params.cache_clear()
    del sd_models
    gc.collect()
    torch.cuda.empty_cache()
    log("plan Flux (no FBCache hit):",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(flux_calls().items())})
    timed("flux kernels", phase_flux_kernels, flux_calls(), per_kernel)
    flux_ref_ok, _, q8_blocks = timed("flux reference", phase_flux_reference)
    flux_ok, flux_launches, flux_e2e, fcalls, flux_models, q8_latent = timed(
        "flux pipeline", phase_flux_pipeline)
    w8_plan, off_plan = flux_calls(w8a8=True), unfused_dit_calls()
    log("plan Flux W8A8 (no FBCache hit):",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(w8_plan.items())})
    log("plan W8A8 DiT call, fused_ew off:",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(off_plan.items())})
    timed("w8a8 kernels", phase_w8a8_kernels, {**w8_plan, **off_plan}, per_kernel)
    w8_ref_ok, _, _ = timed("flux w8a8 reference", phase_flux_w8a8_reference, q8_blocks)
    w8_ok, w8_launches, w8_e2e, w8_calls, off_launches, flux_models, w8_refs = timed(
        "flux w8a8 pipeline", phase_flux_w8a8_pipeline, flux_models, q8_latent)
    scan_plan, scan_off_plan = flux_calls(w8a8=True, scan=True), unfused_dit_calls(scan=True)
    log("plan Flux W8A8 scan (no FBCache hit):",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(scan_plan.items())})
    # K6 at the Q8_0 DiT's full-res shapes and T5's, K8 and the stacked K11
    # at the W8A8 scan path's
    k6_plan = {k: n for k, n in stacked(flux_calls()).items()
               if k[0] == "quant_matmul_stacked" and k[1] in (4096, 4096 + FLUX_TXT, FLUX_TXT)}
    requant_ok = timed("stacked kernels", phase_stacked_kernels,
                       {**k6_plan, **scan_plan, **scan_off_plan}, per_kernel)
    (scan_ok, scan_launches, scan_e2e, scan_calls, scan_off_launches, flux_models,
     scan_latent) = timed("flux w8a8 scan pipeline", phase_flux_scan_pipeline, flux_models,
                          w8_refs)
    hit_ok, hit_launches, hit_calls, hit_e2e = timed(
        "flux fbcache hits", phase_flux_fbcache_hits, flux_models)
    del flux_models, w8_refs
    gc.collect()
    torch.cuda.empty_cache()
    try:
        files_ok, (files_launches, files_calls), (lora_launches, lora_calls), files_e2e = timed(
            "flux files", phase_flux_files, line, scan_latent, per_kernel)
        tp_ok, tp_launches, tp_calls, tp_e2e = timed("flux tp", phase_flux_tp, line, per_kernel)
    finally:
        shutil.rmtree(FLUX_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    sd21_params = draw_sd21_params()  # phase 26 (b)'s weights, drawn meanwhile
    train_ok, train_e2e = timed("train", phase_train, line)
    var_ok, var_kernels, var_launches, var_calls = timed(
        "kernel variants", phase_kernel_variants, line)
    per_kernel.update(var_kernels)
    lin_ok, lin_launches, lin_e2e = timed(
        "sd15 linear label_emb", phase_linear_label_emb, line, def_calls, def_first)
    sd21_ok, sd21_launches, sd21_e2e, sd21_plan = timed(
        "sd21 heads", phase_sd21_heads, line, per_kernel, sd21_params)

    # calls per image of each path, summed over the paths a kernel runs on
    # (the unfused DiT calls count once)
    path_calls = {"sd15": sd_calls, "sd15_sage": sage_calls, "sd15_defaults": def_calls,
                  "sd15_hires_fix": hires_plan, "sd15_img2img_usdu": i2i_plan,
                  "sd15_adetailer": ad_plan, **webui_calls, "flux": fcalls,
                  "flux_w8a8": w8_calls, "w8a8_dit_call_fused_ew_off": off_plan,
                  "flux_w8a8_scan": scan_calls, "w8a8_scan_dit_call_fused_ew_off": scan_off_plan,
                  "flux_w8a8_scan_fbcache_hits": hit_calls, "flux_files_defaults": files_calls,
                  "flux_lora_unfused_attention": lora_calls, **tp_calls,
                  "kernel_variants": var_calls, "sd15_linear_label_emb": def_calls,
                  "sd21_unet_ksample": sd21_plan}
    all_calls = {}
    for calls in path_calls.values():
        for key, n in calls.items():
            all_calls[key] = all_calls.get(key, 0) + n
    paths = {"sd15": sd_launches, "sd15_sage": sage_launches, "sd15_defaults": def_launches,
             "sd15_hires_fix": hires_launches, "sd15_img2img_usdu": i2i_launches,
             "sd15_adetailer": ad_launches, **webui_launches, "flux": flux_launches,
             "flux_w8a8": w8_launches, "w8a8_dit_call_fused_ew_off": off_launches,
             "flux_w8a8_scan": scan_launches,
             "w8a8_scan_dit_call_fused_ew_off": scan_off_launches,
             "flux_w8a8_scan_fbcache_hits": hit_launches, "flux_files_defaults": files_launches,
             "flux_lora_unfused_attention": lora_launches, **tp_launches,
             "kernel_variants": var_launches, "sd15_linear_label_emb": lin_launches,
             "sd21_unet_ksample": sd21_launches}
    # the defaults launch no flag variant: every earlier path read each
    # variant's counter, and it stayed at 0
    defaults_ok = True
    for path, launches in paths.items():
        if path == "kernel_variants":
            continue
        stray = {name: launches.get(name) for name in VARIANT_KERNELS
                 if launches.get(name) != 0}
        if stray:
            log(f"FAIL: {path} read these flag variants' counters as {stray} (want 0 each)")
            defaults_ok = False
    log(f"launches of the flag variants on the {len(paths) - 1} default paths: "
        f"{'0 each, ok' if defaults_ok else 'FAIL'}")
    kernels_line = []
    metas = {**KERNELS, **VARIANT_KERNELS}
    for name, meta in metas.items():
        entry = per_kernel[name]
        shapes = entry["shapes"]
        for s_ in shapes:
            s_["calls_per_image"] = all_calls.get(tuple(s_["key"]), 0)

        def per_image(key):
            vals = [s_[key] for s_ in shapes]
            if any(v is None for v in vals):
                return None
            return sum(s_["calls_per_image"] * s_[key] for s_ in shapes)

        bound_shapes = [s_["bound_by"] for s_ in shapes]
        kernels_line.append({
            "name": name, **meta,
            "launches": sum(launches.get(name, 0) for launches in paths.values()),
            "launches_by_path": {path: launches.get(name, 0) for path, launches in paths.items()},
            "max_abs_err": entry["max_abs_err"],
            "ms": per_image("ms"),
            "plain_ms": per_image("plain_ms"), "bound_ms": per_image("bound_ms"),
            "bound_by": max(set(bound_shapes), key=bound_shapes.count),
            "library_ms": per_image("library_ms"), "ok": entry["ok"],
            # the kernel's time per image of each path it runs on
            "ms_by_path": {path: sum(calls.get(tuple(s_["key"]), 0) * s_["ms"] for s_ in shapes)
                           for path, calls in path_calls.items()
                           if any(tuple(s_["key"]) in calls for s_ in shapes)},
            "per": "image: the sum over its main-path shapes of calls x time, over one "
                   "image of each path it runs on (SD1.5 with flash or sage attention, "
                   "SD1.5 with every default, its hires-fix, img2img and ADetailer, the "
                   "WebUI's Generate with every default, with sage_attention, with "
                   "packed_attn off and with qkv_fuse off, SD1.5 with the UNet's FBCache "
                   "forced to hit, Flux Q8_0, "
                   "Flux W8A8 unrolled and scan, "
                   "Flux W8A8 scan with FBCache forced to hit, Flux from files with every "
                   "default, Flux with a LoRA on the unfused attention, each rank of Flux "
                   "tensor-parallel at TP = 2: the spmd pipeline and one missed DiT call "
                   "with the card's toggles and with w8a8, flux_scan and fused_attn off, "
                   "SD1.5 with every default from a checkpoint with linear transformer "
                   "projections and a label embedding, SD2.1's UNet through ksample) "
                   "and one missed "
                   "W8A8 DiT call with fused_ew off in each layout",
            "shapes": shapes,
        })
        if name in VARIANT_KERNELS:
            kernels_line[-1]["per"] = ("call: no pipeline reaches the flag variant; one call "
                                       "at each of phase 25's shapes, summed")
    e2e = {"sd15": sd_e2e, "sd15_sage": sage_e2e, "sd15_defaults": def_e2e,
           "sd15_hires_fix": hires_e2e, "sd15_img2img_usdu": i2i_e2e,
           "sd15_adetailer_previews": ad_e2e, "sd15_webui": webui_e2e, "flux": flux_e2e,
           "flux_w8a8": w8_e2e,
           "flux_w8a8_scan": scan_e2e, "flux_w8a8_scan_fbcache_hits": hit_e2e,
           "flux_files_defaults": files_e2e["defaults"],
           "flux_lora_unfused_attention": files_e2e["lora_unfused"], "flux_tp": tp_e2e,
           "train": train_e2e, "sd15_linear_label_emb": lin_e2e, "sd21_unet_ksample": sd21_e2e}
    ok = (ref_ok and pipe_ok and sage_ok and def_ok and hires_ok and i2i_ok and ad_ok
          and webui_ok and flux_ref_ok
          and flux_ok and w8_ref_ok and w8_ok and requant_ok and scan_ok and hit_ok and files_ok
          and tp_ok and train_ok and var_ok and lin_ok and sd21_ok and defaults_ok
          and all(k["ok"] for k in kernels_line))
    record = {"gpu": line, "kernels": kernels_line, "e2e": e2e, "phase_seconds": seconds,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in entry.items() if k != "shapes"}
                                  for entry in kernels_line]}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
