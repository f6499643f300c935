#!/usr/bin/env python3
"""Where the time of loading Flux.1-dev's GGUF goes, on one NVIDIA GPU.

    python3 profile_flux_load.py

Writes the DiT's GGUF as ``chip_smoke.py``'s phase 18 writes it (seed 20,
22.3 GB under ``build/chip_smoke/flux/``, removed at the end), then times
the two halves of ``pipelines.loader.load_diffusion_model_gguf`` in its
default form (W8A8, scan, fused attention) alone: the reader, then
``base.flux_model`` (upload, requant, RoPE permutation, stacking on the
device) with the device's peak memory; then the whole load twice with the
host's peak RSS and the device's peak. Every step ends in a device sync.
Needs one CUDA device.
"""

import gc
import os
import shutil
import sys
import time

import torch

import chip_smoke as cs
from lightdiffusion_next_tpu_torch import config
from lightdiffusion_next_tpu_torch.models import base, flux
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.pipelines import loader


def step(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` synced and timed, with the device's peak
    memory above what was allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    print(f"{name}: {time.perf_counter() - t0:.2f} s, device peak {peak:.2f} GiB",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flux_load: no CUDA device", file=sys.stderr)
        return 2
    config.resolve_device("cuda")
    print("gpu:", cs.gpu_line(), flush=True)
    path = cs.flux_asset_paths()[0]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        layout = [(k, shape, kind == "lin" and k.endswith(flux.Q8_0_SUFFIXES))
                  for k, shape, kind in flux._layout(flux.FLUX_DEV)]
        n = step("write", ggml.write_gguf, path, flux.random_leaves(flux.FLUX_DEV, seed=20),
                 "flux", (), layout)
        print(f"file: {n} bytes", flush=True)
        sd = step("gguf_sd_loader", ggml.gguf_sd_loader, path)
        cfg = flux.detect_config(sd, dtype=torch.bfloat16)
        model = step("flux_model", base.flux_model, sd, cfg=cfg, dtype=torch.bfloat16,
                     device="cuda")
        del model, sd
        for _ in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            with cs.PeakRss() as rss:
                model = step("load_diffusion_model_gguf", loader.load_diffusion_model_gguf,
                             path)
            print(f"host peak RSS {rss.peak / 2**30:.1f} GiB", flush=True)
            del model
    finally:
        shutil.rmtree(cs.FLUX_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
