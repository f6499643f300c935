#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every hand-written kernel from ``lightdiffusion_next_tpu_torch/csrc``;
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

Prints one ``{"kernels": [...]}`` JSON line (``ms``: the kernel's time per
image, summed over its main-path shapes and over the paths it runs on), the
card's name and power limit, and as its last line ``{"ok": true, "device":
{...}}``. Imports nothing of JAX. Needs one CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import gc
import json
import math
import os
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
PEAK_HBM_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.83e9

# The kernels are held against their plain versions by
# ``flash_attention.agreement`` (its limits are stated there). Two planted
# faults, launched through the same C entry point at every shape, show that
# those limits catch a wrong kernel: each must fail them.
PLANTED_FAULTS = ("q scale without LOG2E", "last kv tile of 64 rows skipped")
Q8_FAULTS = ("last K tile of 64 rows skipped", "neighbouring 32-block's scale row")
FUSED_FAULTS = ("last kv tile of 64 rows skipped", "RoPE sine's sign flipped")
# rel RMSE of the bf16 kernel UNet against the f32 plain-attention UNet
TOL_UNET_REL_RMSE = 5e-2
# rel RMSE of a bf16 Flux block through the kernels against the same block
# in f32 through the plain versions
TOL_FLUX_BLOCK_REL_RMSE = 5e-2

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
    "quant_matmul": {
        "route": "cuda",
        "source": "lightdiffusion_next_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "lightdiffusion_next_tpu/ops/quant_matmul.py:258",
    },
}


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


def attention_calls(width=1024, height=1024, batch=1, steps=20):
    """{(kernel, B, H, L, D, dtype): calls per image} for the pipeline's
    SD1.5 txt2img at width x height: 20 karras steps, the default
    multi-scale plan, MSW-MSA with its sigma gate, CFG batch 2, the VAE's
    mid-block attention."""
    import torch

    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import unet
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import window
    from lightdiffusion_next_tpu_torch.sampling import ksampler, samplers
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete

    msd = ModelSamplingDiscrete()
    sigmas = ksampler.sigmas_for(msd, "karras", steps)
    lh, lw = height // 8, width // 8
    ms = samplers.MultiScale(enabled=True)
    flags = samplers.fullres_flags(steps, ms, lh, lw)
    bounds = window.msw_gate_bounds(msd)
    packed = config.get_config().packed_attn
    calls = {}

    def add(key, n=1):
        calls[key] = calls.get(key, 0) + n

    for i in range(steps):
        h, w = (lh, lw) if flags[i] else samplers.scaled_dims(lh, lw, ms.factor)
        t = msd.timestep(torch.tensor([sigmas[i]] * 2 * batch, dtype=torch.float32))
        _, active = window.msw_step_state(t, bounds)
        for block, level, ch, depth in unet.attention_blocks(unet.SD15_CONFIG):
            hh, ww = h, w
            for _ in range(level):
                hh, ww = (hh + 1) // 2, (ww + 1) // 2
            heads, d = unet.SD15_CONFIG.heads_for(ch)
            b, tokens = 2 * batch, hh * ww
            if active and block in window.SD15_BLOCKS:
                b, tokens = 4 * b, (((hh + 1) // 2) * ((ww + 1) // 2))
            if tokens >= 512 and d <= 512:
                name = "packed_flash_attention" if packed and fa.pack_group(d) >= 2 \
                    else "flash_attention"
                add((name, b, heads, tokens, d, "bf16"), depth)
    add(("flash_attention", batch, 1, lh * lw, 512, "f32"))
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


def flux_dit_calls(img, add, n=1):
    """K5 and K3 calls of one DiT call at ``img`` image tokens that misses
    the cache (all 57 blocks), added ``n`` times to the dict ``add``."""
    joint = img + FLUX_TXT
    for rows in (img, FLUX_TXT):  # 19 double blocks, image and text streams
        for k, nn_ in ((FLUX_H, 3 * FLUX_H), (FLUX_H, FLUX_H), (FLUX_H, FLUX_MLP),
                       (FLUX_MLP, FLUX_H)):
            add(("quant_matmul", rows, k, nn_), 19 * n)
    add(("quant_matmul", joint, FLUX_H, 3 * FLUX_H + FLUX_MLP), 38 * n)  # linear1
    add(("quant_matmul", joint, FLUX_H + FLUX_MLP, FLUX_H), 38 * n)      # linear2
    add(("fused_qkv_attention", joint, 3 * FLUX_H, FLUX_TXT), 19 * n)
    add(("fused_qkv_attention", joint, 3 * FLUX_H + FLUX_MLP, 0), 38 * n)


def flux_calls(hits=0, misses=20, dy_calls=2):
    """{(kernel, *shape): calls per image} for the Flux path at 1024^2:
    ``misses`` full-res DiT calls that run every block, ``hits`` that FBCache
    serves after double block 0 (8 K5 and 1 K3 launches), ``dy_calls``
    half-res calls (always misses), the T5-XXL encode (24 layers x 7 K5) and
    the AE decode (one K2 call)."""
    calls = {}

    def add(key, n):
        if n:
            calls[key] = calls.get(key, 0) + n

    flux_dit_calls(4096, add, misses)
    flux_dit_calls(1024, add, dy_calls)
    for rows in (4096, FLUX_TXT):  # a hit: double block 0 only
        for k, nn_ in ((FLUX_H, 3 * FLUX_H), (FLUX_H, FLUX_H), (FLUX_H, FLUX_MLP),
                       (FLUX_MLP, FLUX_H)):
            add(("quant_matmul", rows, k, nn_), hits)
    add(("fused_qkv_attention", 4096 + FLUX_TXT, 3 * FLUX_H, FLUX_TXT), hits)
    for k, nn_, n in ((4096, 4096, 4), (4096, 10240, 2), (10240, 4096, 1)):
        add(("quant_matmul", FLUX_TXT, k, nn_), 24 * n)
    add(("flash_attention", 1, 1, 16384, 512, "f32"), 1)
    return calls


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


def phase_kernels(calls):
    import torch
    import torch.nn.functional as F

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {}
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
    shape = {"key": list(key), **shape,
             **{k: check[k] for k in ("max_abs_err", "tol", "max_abs_plain",
                                      "rel_rmse", "rel_rmse_limit")},
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
    return {"max_abs_err": bad["max_abs_err"], "rel_rmse": bad["rel_rmse"],
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


def build_models():
    """Full-width SD1.5 UNet, VAE and CLIP-L on the card from seeded random
    weights (seeds 0, 1, 2): (model, vae, clip)."""
    import torch

    from lightdiffusion_next_tpu_torch.models import base, unet
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import facade
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    t0 = time.perf_counter()
    model = base.sd15_model(unet.init_params(unet.SD15_CONFIG, seed=0))
    vae = vae_mod.VAE(vae_mod.init_params(vae_mod.SD_VAE, seed=1))
    clip = facade.sd1_clip_from_params(
        te.init_params(num_layers=12, width=768, heads=12, seed=2),
        embedding_directory=os.path.join(OUT_DIR, "embeddings"),
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


def kernel_wrappers():
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    return {"packed_flash_attention": fa.packed_flash_attention,
            "flash_attention": fa.flash_attention,
            "fused_qkv_attention": fa.fused_qkv_attention,
            "quant_matmul": qm.quant_matmul}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_pipeline(calls):
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    models = build_models()
    model, vae, _ = models
    reset_launches()
    first = run_pipeline(models, 1234)
    launches = read_launches()
    predicted = predicted_launches(calls)
    ok = True
    for name in KERNELS:
        good = launches[name] == predicted[name] and (launches[name] > 0 or name in (
            "fused_qkv_attention", "quant_matmul"))
        ok = ok and good
        log(f"launches SD1.5 {name}: {launches[name]} (plan predicts {predicted[name]}) "
            f"{'ok' if good else 'FAIL'}")

    # what came out: finite latent of the right shape, finite pixels, and the
    # PNG holding exactly those pixels at 1024 x 1024 x 3
    x = first["last"]["x"]
    latent_ok = tuple(x.shape) == (1, 128, 128, 4) and bool(torch.isfinite(x).all())
    with torch.no_grad():
        pixels = vae.decode(model.latent_format.process_out(x))
    pixels_ok = bool(torch.isfinite(pixels).all())
    png = read_png(first["paths"][0])
    png_ok = png.shape == (1024, 1024, 3) and np.array_equal(
        png, image_utils.to_uint8(pixels.cpu().numpy())[0])
    log(f"output: latent {tuple(x.shape)} finite={latent_ok}, pixels finite="
        f"{pixels_ok}, png {png.shape} matches decode={png_ok}, "
        f"pixel mean {png.mean():.2f} std {png.std():.2f}")
    ok = ok and latent_ok and pixels_ok and png_ok

    torch.cuda.reset_peak_memory_stats()
    timed = run_pipeline(models, 5678)
    steps = timed["step_times"]
    n = len(steps)
    loop_s = steps[-1] - steps[0]
    it_s = (n - 1) / loop_s
    log(f"pipeline timed run: {timed['wall']:.3f} s/image end to end; sampler "
        f"steps 2..{n}: {it_s:.3f} it/s; first run {first['wall']:.3f} s/image; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    e2e = {"s_per_image": timed["wall"], "it_per_s": it_s,
           "first_run_s_per_image": first["wall"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del models, model, vae, first, timed
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches, e2e


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


def flux_rope(l):
    """(cos, sin) of a joint sequence of 256 text and l - 256 image tokens."""
    import torch

    from lightdiffusion_next_tpu_torch.models import flux

    side = int(round(math.sqrt(l - FLUX_TXT)))
    ids = torch.cat([torch.zeros((1, FLUX_TXT, 3), device="cuda"),
                     flux.img_ids(1, 2 * side, 2 * side, device="cuda")], dim=1)
    return flux.rope_cos_sin(ids, flux.FLUX_DEV.axes_dim)


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
    gen = torch.Generator(device="cuda").manual_seed(31)
    img = torch.randn((1, 4096, FLUX_H), generator=gen, device="cuda")
    txt = torch.randn((1, FLUX_TXT, FLUX_H), generator=gen, device="cuda")
    vec = torch.randn((1, FLUX_H), generator=gen, device="cuda")
    pe = flux_rope(4096 + FLUX_TXT)
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
    rels = []
    for a, b in zip(outs["kernels"], outs["plain"]):
        rels.append(((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item())
    ok = all(math.isfinite(r) and r <= TOL_FLUX_BLOCK_REL_RMSE for r in rels)
    log(f"flux reference: double block img/txt and single block, bf16 kernels vs f32 "
        f"plain: rel RMSE {[f'{r:.4g}' for r in rels]} (tol {TOL_FLUX_BLOCK_REL_RMSE}) "
        f"{'ok' if ok else 'FAIL'}")
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rels


def build_flux_models():
    """Flux.1-dev DiT and T5-XXL (Q8_0, drawn and quantized on the card),
    CLIP-L and the Flux AE at full width from seeded random weights (seeds
    20-23): (model, clip, vae, t5)."""
    import torch

    from lightdiffusion_next_tpu_torch.models import base, flux
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    t0 = time.perf_counter()
    model = base.flux_model(flux.random_params(flux.FLUX_DEV, seed=20), cfg=flux.FLUX_DEV)
    t5 = t5_mod.T5XXLModel(t5_mod.random_params(t5_mod.T5_XXL, seed=21), cfg=t5_mod.T5_XXL)
    clip = te.SDClipModel(te.init_params(num_layers=12, width=768, heads=12, seed=22,
                                         with_projection=True), num_layers=12, heads=12)
    vae = vae_mod.VAE(vae_mod.init_params(vae_mod.FLUX_AE, seed=23), vae_mod.FLUX_AE)
    torch.cuda.synchronize()
    log(f"flux pipeline: built the DiT, T5-XXL, CLIP-L and the AE from seeds in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        "on the card")
    return model, clip, vae, t5


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


def phase_flux_pipeline():
    """Returns (ok, launches, e2e, flux calls per image from the counted
    FBCache hits)."""
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    models = build_flux_models()
    model, clip, vae, t5 = models
    reset_launches()
    first = run_flux_pipeline(models, 4321)
    launches = read_launches()
    hist = first["hits"]
    # calls in order: steps 0-2, the dy call of step 2, step 3, its dy call, steps 4-19
    main = [h for i, h in enumerate(hist) if i not in (3, 5)]
    dy = [hist[i] for i in (3, 5) if i < len(hist)]
    hits = sum(main)
    calls = flux_calls(hits=hits, misses=len(main) - hits, dy_calls=len(dy))
    predicted = predicted_launches(calls)
    ok = len(hist) == 22 and not any(dy)
    log(f"flux FBCache: {''.join('H' if h else '.' for h in hist)} ({hits} hits of "
        f"{len(main)} main-loop calls; the dy calls are the 4th and 6th)")
    for name in KERNELS:
        good = launches[name] == predicted[name]
        ok = ok and good
        log(f"launches Flux {name}: {launches[name]} (plan predicts {predicted[name]}) "
            f"{'ok' if good else 'FAIL'}")

    x = first["last"]["x"]
    latent_ok = tuple(x.shape) == (1, 128, 128, 16) and bool(torch.isfinite(x).all())
    with torch.no_grad():
        pixels = vae.decode(model.latent_format.process_out(x))
    pixels_ok = bool(torch.isfinite(pixels).all())
    png = read_png(first["paths"][0])
    png_ok = png.shape == (1024, 1024, 3) and np.array_equal(
        png, image_utils.to_uint8(pixels.cpu().numpy())[0])
    log(f"flux output: latent {tuple(x.shape)} finite={latent_ok}, pixels finite="
        f"{pixels_ok}, png {png.shape} matches decode={png_ok}, "
        f"pixel mean {png.mean():.2f} std {png.std():.2f}, {first['paths'][0]}")
    ok = ok and latent_ok and pixels_ok and png_ok

    torch.cuda.reset_peak_memory_stats()
    timed = run_flux_pipeline(models, 8765)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = timed["step_times"]
    it_s = (len(steps) - 1) / (steps[-1] - steps[0])

    # one DiT call that runs every block (no cache), at 1024^2
    gen = torch.Generator(device="cuda").manual_seed(40)
    args = (torch.randn((1, 128, 128, 16), generator=gen, device="cuda"),
            torch.tensor([0.5], device="cuda"),
            torch.randn((1, FLUX_TXT, 4096), generator=gen, device="cuda"))
    kw = dict(y=torch.randn((1, 768), generator=gen, device="cuda"),
              guidance=torch.tensor([3.0], device="cuda"))
    miss = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.apply_fn(model.params, *args, **kw)
        torch.cuda.synchronize()
        miss.append(time.perf_counter() - t0)
    log(f"flux pipeline timed run: {timed['wall']:.3f} s/image end to end; sampler "
        f"steps 2..{len(steps)}: {it_s:.3f} it/s; FBCache "
        f"{''.join('H' if h else '.' for h in timed['hits'])} "
        f"({sum(timed['hits'])} hits); first run {first['wall']:.3f} s/image; one "
        f"missed DiT call {miss[-1] * 1e3:.1f} ms wall (first {miss[0] * 1e3:.1f}); "
        f"peak memory {peak:.1f} GiB")
    e2e = {"s_per_image": timed["wall"], "it_per_s": it_s,
           "first_run_s_per_image": first["wall"], "fbcache_hits": sum(timed["hits"]),
           "fbcache_history": timed["hits"], "missed_dit_call_s": miss[-1],
           "peak_gib": peak}
    return ok, launches, e2e, calls


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
    log("plan SD1.5:", {f"{k[0]} {k[1:]}": v for k, v in sorted(sd_calls.items())})
    per_kernel = timed("sd15 kernels", phase_kernels, sd_calls)
    ref_ok, _ = timed("sd15 reference", phase_reference)
    pipe_ok, sd_launches, sd_e2e = timed("sd15 pipeline", phase_pipeline, sd_calls)
    log("plan Flux (no FBCache hit):",
        {f"{k[0]} {k[1:]}": v for k, v in sorted(flux_calls().items())})
    timed("flux kernels", phase_flux_kernels, flux_calls(), per_kernel)
    flux_ref_ok, _ = timed("flux reference", phase_flux_reference)
    flux_ok, flux_launches, flux_e2e, fcalls = timed("flux pipeline", phase_flux_pipeline)

    # calls per image of each path, summed over the paths a kernel runs on
    all_calls = dict(sd_calls)
    for key, n in fcalls.items():
        all_calls[key] = all_calls.get(key, 0) + n
    kernels_line = []
    for name, meta in KERNELS.items():
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
            "launches": sd_launches[name] + flux_launches[name],
            "launches_by_path": {"sd15": sd_launches[name], "flux": flux_launches[name]},
            "max_abs_err": entry["max_abs_err"],
            "ms": per_image("ms"),
            "plain_ms": per_image("plain_ms"), "bound_ms": per_image("bound_ms"),
            "bound_by": max(set(bound_shapes), key=bound_shapes.count),
            "library_ms": per_image("library_ms"), "ok": entry["ok"],
            "per": "image: the sum over its main-path shapes of calls x time, over one "
                   "image of each path it runs on (SD1.5 and Flux)",
            "shapes": shapes,
        })
    e2e = {"sd15": sd_e2e, "flux": flux_e2e}
    ok = (ref_ok and pipe_ok and flux_ref_ok and flux_ok
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
