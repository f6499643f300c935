#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every hand-written kernel from ``lightdiffusion_next_tpu_torch/csrc``;
3. kernels: each kernel at each shape the SD1.5 1024^2 path gives it (derived
   from the UNet plan, the multi-scale plan and the MSW-MSA gate), checked
   against its plain PyTorch version (``flash_attention.agreement``), shown
   to reject two planted faults, and timed beside the plain version and
   beside ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick
   only: the port never calls it);
4. reference: one full-width UNet forward at a small latent through the
   kernels in bf16 against the same forward in f32 through plain attention;
5. pipeline: full-width SD1.5 UNet, VAE and CLIP-L from seeded random
   weights, ``pipeline(prompt, 1024, 1024, prio_speed=True, autohdr=False)``
   to a PNG, with every launch counter set to 0 before and checked against
   the plan's prediction after; then a second, timed run.

Prints one ``{"kernels": [...]}`` JSON line (``ms``: the kernel's time per
image, summed over its main-path shapes), the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Imports nothing of
JAX. Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

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
# rel RMSE of the bf16 kernel UNet against the f32 plain-attention UNet
TOL_UNET_REL_RMSE = 5e-2

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
    per_kernel = {name: {"shapes": [], "max_abs_err": 0.0, "ok": True} for name in KERNELS}
    for (name, b, h, l, d, dtype), n_calls in sorted(calls.items()):
        q, k, v = make_inputs(b, h, l, d, dtype, gen)
        wrapper = getattr(fa, name)
        out = wrapper(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v)
        check = fa.agreement(out, ref)
        faults = {}
        for fault in PLANTED_FAULTS:
            bad = fa.agreement(planted_fault(fault, name, q, k, v), ref)
            faults[fault] = {"max_abs_err": bad["max_abs_err"], "rel_rmse": bad["rel_rmse"],
                             "caught": not bad["ok"]}
        ok = check["ok"] and all(f["caught"] for f in faults.values())
        ms = cuda_ms(lambda: wrapper(q, k, v), repeats_for(lambda: wrapper(q, k, v)))
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v), 2)
        lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        library_ms = cuda_ms(lib, repeats_for(lib))
        bound_ms, bound_by = bound(b, h, l, d, q.element_size())
        shape = {"shape": [b, h, l, d], "dtype": dtype, "calls_per_image": n_calls,
                 **{key: check[key] for key in ("max_abs_err", "tol", "max_abs_plain",
                                                "rel_rmse", "rel_rmse_limit")},
                 "planted_faults": faults, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"kernel {name} {shape}")
        entry = per_kernel[name]
        entry["shapes"].append(shape)
        entry["max_abs_err"] = max(entry["max_abs_err"], check["max_abs_err"])
        entry["ok"] = entry["ok"] and ok
        if not check["ok"]:
            log(f"FAIL: {name} at {(b, h, l, d, dtype)} disagrees with its plain version")
        for fault, f in faults.items():
            if not f["caught"]:
                log(f"FAIL: {name} at {(b, h, l, d, dtype)}: planted fault '{fault}' "
                    "passes the check")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return per_kernel


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


def phase_pipeline(calls):
    import numpy as np
    import torch

    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.utils import image as image_utils

    models = build_models()
    model, vae, _ = models
    fa.flash_attention.launches = 0
    fa.packed_flash_attention.launches = 0
    first = run_pipeline(models, 1234)
    launches = {"flash_attention": fa.flash_attention.launches,
                "packed_flash_attention": fa.packed_flash_attention.launches}
    predicted = predicted_launches(calls)
    ok = True
    for name in KERNELS:
        good = launches[name] == predicted[name] and launches[name] > 0
        ok = ok and good
        log(f"launches {name}: {launches[name]} (plan predicts {predicted[name]}) "
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
    return ok, launches, {"s_per_image": timed["wall"], "it_per_s": it_s,
                          "first_run_s_per_image": first["wall"],
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


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
    line = phase_environment()
    phase_build()
    calls = attention_calls()
    log("plan:", {f"{k[0]} {k[1:]}": v for k, v in sorted(calls.items())})
    per_kernel = phase_kernels(calls)
    ref_ok, _ = phase_reference()
    pipe_ok, launches, e2e = phase_pipeline(calls)

    kernels_line = []
    for name, meta in KERNELS.items():
        entry = per_kernel[name]
        shapes = entry["shapes"]

        def per_image(key):
            vals = [s[key] for s in shapes]
            if any(v is None for v in vals):
                return None
            return sum(s["calls_per_image"] * s[key] for s in shapes)

        bound_shapes = [s["bound_by"] for s in shapes]
        kernels_line.append({
            "name": name, **meta, "launches": launches[name],
            "max_abs_err": entry["max_abs_err"],
            "ms": per_image("ms"),
            "plain_ms": per_image("plain_ms"), "bound_ms": per_image("bound_ms"),
            "bound_by": max(set(bound_shapes), key=bound_shapes.count),
            "library_ms": per_image("library_ms"), "ok": entry["ok"],
            "per": "image: the sum over its main-path shapes of calls x time",
            "shapes": shapes,
        })
    ok = ref_ok and pipe_ok and all(k["ok"] for k in kernels_line)
    record = {"gpu": line, "kernels": kernels_line, "e2e": e2e,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels_line}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
