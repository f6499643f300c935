#!/usr/bin/env python3
"""Where the device time of one SD1.5 (or Flux) 1024^2 image goes, on one
NVIDIA GPU.

    python3 profile_sd15.py            # SD1.5
    python3 profile_sd15.py --sage     # SD1.5 with the int8 attention (K4)
    python3 profile_sd15.py --flux     # Flux.1-dev, W8A8 DiT in the scan layout
                                       # (the card's default)
    python3 profile_sd15.py --flux --q8  # Flux.1-dev, Q8_0 DiT unrolled (K5)

Builds the same full-width models from seeded random weights as
``chip_smoke.py`` (SD1.5: UNet, VAE, CLIP-L; Flux: the DiT requantized to
W8A8 from its seeded Q8_0 weights, with the fused elementwise path, the Q8_0
T5-XXL, CLIP-L, the AE, the DiT and T5 then stacked into the scan layout;
with ``--q8`` the DiT and T5 stay Q8_0 and unrolled, as in
``chip_smoke.py``'s Flux pipeline phase),
runs the pipeline at 1024^2 once to warm up, then once more
under ``torch.profiler``. Prints, for that profiled call: its wall time, the
device's busy time (the sum of its kernels' device time) and idle share
(1 - busy / wall: profiling slows the host, so this share is the profiled
call's, not an unprofiled call's), the device time by class of kernel
(matched on kernel names), and the top kernels. Writes every kernel's time
to ``build/chip_smoke/profile.txt``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import chip_smoke


def kernel_category(name: str) -> str:
    """Coarse class of a device kernel by its name. K6 is K5's template
    instantiated with STACKED = true; K8 and the stacked K11 launch K7's
    and K11's own instantiations."""
    stacked = "true>" in name
    if "sage_attention_kernel" in name:
        return "K4 sage_attention (UNet, int8)"
    if "sage_stats_kernel" in name or "sage_quantize_kernel" in name:
        return "K4's preparation sage_prepare (UNet, int8)"
    if "flash_wgmma_kernel<40" in name:
        return "K1 packed_flash_attention (UNet d=40)"
    if "flash_split_kernel<true" in name:
        return "K2 flash_attention (VAE f32 d=512)"
    if "flash_kv_kernel<float" in name:
        return "K2's tile-image prologue flash_kv_kernel (VAE f32)"
    if "flash_kv_kernel" in name:
        return "K1's and K2's tile-image prologue flash_kv_kernel (UNet bf16)"
    if "norm_rope_kv_kernel" in name or "fused_attention_kernel" in name:
        return "K3 fused_qkv_attention (Flux)"
    if "quant_matmul_kernel" in name:
        return ("K6 quant_matmul_stacked (T5, Q8_0 scan)" if stacked
                else "K5 quant_matmul (Flux Q8_0, T5)")
    if "w8a8_matmul_kernel" in name:
        # template <WGS, MT, BN, MODE>: MODE 0 is K7's and K8's plain
        # epilogue, 1 and 2 K11's; the stacked entry points launch the same
        # instantiations (on the scan layout, every launch is a stacked one)
        if ", 0>" in name:
            return "K7 w8a8_matmul / K8 stacked (fused_ew off)"
        return "K11 w8a8_matmul_ep / stacked K11 (Flux W8A8)"
    # template <prologue of a, prologue of the window, chunks per lane>: K10
    # is the one with the GELU on its second segment
    if "row_quantize_kernel<0,1," in name.replace(" ", ""):
        return "K10 row_quantize_concat_gelu (Flux W8A8)"
    if "row_quantize_kernel" in name:
        return "K9 row_quantize_fused (Flux W8A8)"
    if "flash_wgmma_kernel" in name:
        return "K2 flash_attention (UNet d=80, 160)"
    if "fprop" in name:
        return "convolutions, f32 (VAE)" if "f32f32_f32f32" in name \
            else "convolutions, bf16 (UNet)"
    if "gemm" in name or "nvjet" in name or "cutlass" in name:
        return "matmuls"
    if "reduce_kernel" in name:
        return "norm statistics"
    if "softmax" in name:
        return "softmax (sdpa)"
    if "copy" in name or "Cat" in name or "roll" in name or "hwcTo" in name:
        return "copies, cat, roll, layout"
    if "elementwise" in name:
        return "other elementwise"
    return "other"


def main(top: int = 12, flux: bool = False, sage: bool = False, q8: bool = False) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_sd15: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightdiffusion_next_tpu_torch import config

    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    os.environ.setdefault("LDT_ASSET_ROOT", chip_smoke.OUT_DIR)
    config.resolve_device("cuda")
    print("gpu:", chip_smoke.gpu_line(), flush=True)
    if flux and q8:
        models, run = chip_smoke.build_flux_models(), chip_smoke.run_flux_pipeline
    elif flux:
        models, _ = chip_smoke.to_scan_models(chip_smoke.build_flux_models(w8a8=True))
        run = chip_smoke.run_flux_pipeline
    else:
        models, run = chip_smoke.build_models(), chip_smoke.run_pipeline
    with chip_smoke.runtime_config(sage_attention=sage):
        warm = run(models, 1234)
        print(f"warm-up call: {warm['wall']:.3f} s/image (unprofiled)", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(models, 9012)
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print("profile_sd15: the trace holds no device time", file=sys.stderr)
        return 1
    classes = {}
    for ms, count, key in rows:
        cls = classes.setdefault(kernel_category(key), [0.0, 0])
        cls[0] += ms
        cls[1] += count
    print(f"profiled call: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the profiled call "
          f"({sum(r[1] for r in rows)} device events)")
    for name, (ms, count) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f}% x{count:<6d} {name}")
    for ms, count, key in rows[:top]:
        print(f"  kernel {ms:9.2f} ms x{count:<6d} {key[:90]}")
    name = ("profile_flux_q8.txt" if q8 else "profile_flux.txt") if flux else (
        "profile_sage.txt" if sage else "profile.txt")
    with open(os.path.join(chip_smoke.OUT_DIR, name), "w") as f:
        for ms, count, key in rows:
            f.write(f"{ms:.3f}\t{count}\t{key}\n")
    print(json.dumps({"wall_ms": wall_ms, "busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms,
                      "classes": {k: {"ms": v[0], "count": v[1]}
                                  for k, v in classes.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(flux="--flux" in sys.argv[1:], sage="--sage" in sys.argv[1:],
                  q8="--q8" in sys.argv[1:]))
