"""A copy of the benchmark's folder at small widths, for the CPU tests: the
same files, plus configurations, traffic and cells that a CPU runs in
seconds, under a ``BENCHMARK.json`` of their own."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "tiny-sd15": {
        "family": "sd15", "source": "test", "reduced": [], "assumed": [],
        "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32,
                 "channel_mult": [1, 2], "num_res_blocks": 1, "transformer_depth": [1, 1],
                 "context_dim": 64, "num_heads": 2},
        "vae": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4,
                "has_quant_conv": True},
        "clip": {"width": 64, "layers": 2, "vocab": 49408, "projection": False, "layer": -2},
    },
    "tiny-flux": {
        "family": "flux", "source": "test", "reduced": [], "assumed": [],
        "runtime": {"w8a8": True, "flux_scan": True, "fused_attn": True, "fused_ew": True},
        "dit": {"in_channels": 16, "hidden_size": 256, "mlp_ratio": 4.0, "num_heads": 2,
                "depth": 1, "depth_single_blocks": 1, "axes_dim": [16, 56, 56], "theta": 10000,
                "qkv_bias": True, "guidance_embed": True, "vec_in_dim": 64,
                "context_in_dim": 256, "patch_size": 2},
        "t5": {"d_model": 256, "d_ff": 512, "num_heads": 4, "num_layers": 2, "vocab": 32128},
        "clip": {"width": 64, "layers": 2, "vocab": 49408, "projection": True, "layer": None},
        "ae": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 16,
               "has_quant_conv": False},
    },
}
TRAFFIC = {
    "tiny-txt2img": {"why": "test", "width": 128, "height": 128, "hires_fix": False,
                     "prompts": "prompts.json", "checked_image_among_first": 1},
    "tiny-hires": {"why": "test", "width": 128, "height": 128, "hires_fix": True,
                   "prompts": "prompts.json", "checked_image_among_first": 1},
}
CELLS = {
    "tiny-sd15-txt2img": ("tiny-sd15", "tiny-txt2img"),
    "tiny-sd15-hires": ("tiny-sd15", "tiny-hires"),
    "tiny-flux-txt2img": ("tiny-flux", "tiny-txt2img"),
}
# generous: the CPU runs the port's plain versions in f32, which agree with
# the reference far inside these
LIMITS = {"clip": 1e-3, "t5": 1e-3, "model": 1e-2, "denoise": 1e-3, "update": 1e-4, "upscale": 1e-5,
          "png_levels": 0.5}


def make_root(tmp: str) -> str:
    """``tmp`` laid out as a checkout: ``benchmark/`` copied, the tiny files
    added, and a ``BENCHMARK.json`` of the tiny cells with the real metrics."""
    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, spec in TRAFFIC.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(spec, f)
    for name in CELLS:
        with open(os.path.join(bench, "cells", name + ".json"), "w") as f:
            json.dump({"limits": LIMITS}, f)
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"] = [{"name": n, "source": "test", "file": f"benchmark/configs/{n}.json",
                       "reduced": [], "why": "test"} for n in CONFIGS]
    man["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                        for n, (c, t) in CELLS.items()]
    for m in man["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return bench


def cell(tmp: str, name: str):
    from benchmark import manifest

    return manifest.Cell(name, root=tmp, bench_dir=os.path.join(tmp, "benchmark"))
