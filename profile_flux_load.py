#!/usr/bin/env python3
"""Where the time of loading Flux.1-dev's GGUF goes, on one NVIDIA GPU.

    python3 profile_flux_load.py

Writes the DiT's GGUF as ``chip_smoke.py``'s phase 18 writes it (seed 20,
22.3 GB under ``build/chip_smoke/flux/``, removed at the end; every read
below finds it in the page cache, warm), then splits the reader
(``ops.ggml.gguf_sd_loader``): the file read alone (every tensor read into
a buffer of its own, as the reader reads it, and dropped), then the reader
with the Q8_0 block split of torch's copies (``native.split_q8_0_plain``)
and with the C++ split (``native.split_q8_0``, the default), in turns
(plain, C++, C++, plain), each with the seconds spent in its split calls.
Then it times the two halves of ``pipelines.loader.load_diffusion_model_gguf``
in its default form (W8A8, scan, fused attention) alone: the reader, then
``base.flux_model`` (upload, requant, RoPE permutation, stacking on the
device) with the device's peak memory; then the whole load twice with the
host's peak RSS and the device's peak. Every step ends in a device sync.
Needs one CUDA device.
"""

import gc
import math
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
from lightdiffusion_next_tpu_torch.utils import native


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


def read_only(path):
    """The reader's file reads alone: each tensor ``readinto`` a buffer of
    its own, in file order, then dropped. Returns the bytes read."""
    _, infos, data_start, buf = ggml.parse_gguf(path)
    buf.close()
    total = 0
    with open(path, "rb", buffering=0) as f:
        for info in infos:
            n = math.prod(info.shape)
            nbytes = n // 32 * 34 if info.ggml_type == ggml.GGML_Q8_0 else 4 * n
            raw = torch.empty(nbytes, dtype=torch.uint8)
            f.seek(data_start + info.offset)
            total += f.readinto(memoryview(raw.numpy()))
            del raw
    return total


def timed_reader(path, split, label):
    """``gguf_sd_loader`` with ``split`` in place of ``native.split_q8_0``
    (the reader's split, put back after), timed whole and in its split
    calls; the state dict is dropped."""
    spent = [0.0]

    def timed_split(blocks):
        t0 = time.perf_counter()
        out = split(blocks)
        spent[0] += time.perf_counter() - t0
        return out

    default = native.split_q8_0
    native.split_q8_0 = timed_split
    try:
        t0 = time.perf_counter()
        sd = ggml.gguf_sd_loader(path)
        total = time.perf_counter() - t0
    finally:
        native.split_q8_0 = default
    print(f"gguf_sd_loader {label}: {total:.2f} s, of which the Q8_0 split {spent[0]:.2f} s, "
          f"the rest (reads, records) {total - spent[0]:.2f} s", flush=True)
    del sd
    gc.collect()


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
        native.load_library()  # built before the clocks start
        t0 = time.perf_counter()
        nbytes = read_only(path)
        print(f"file read alone: {time.perf_counter() - t0:.2f} s for {nbytes} bytes",
              flush=True)
        for label in ("torch split (plain)", "C++ split (native)", "C++ split (native)",
                      "torch split (plain)"):
            split = native.split_q8_0_plain if "plain" in label else native.split_q8_0
            timed_reader(path, split, label)
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
