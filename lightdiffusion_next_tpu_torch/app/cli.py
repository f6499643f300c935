"""Command-line interface.

Counterpart of lightdiffusion_next_tpu/app/cli.py: the same parser and
mutual-exclusion checks, on the port's ``pipeline()`` and ``RuntimeConfig``
(``--w8a8``, ``--sage-attention``, ``--flux-scan``, ``--fused-ew``,
``--packed-attn``, ``--fused-attn``, ``--qkv-fuse`` and their ``--no-``
forms). ``--stable-fast`` is accepted and changes nothing, as in the JAX
package. ``--enhance-prompt`` sends the prompt through a local Ollama
first (``pipelines/enhancer.py``). ``--flux`` runs Flux.1-dev from the four files under
the asset root, ``--hires-fix`` adds SD1.5's second pass at twice the
size, ``--img2img`` takes the prompt as an image's path and upscales it
twice with UltimateSDUpscale, ``--adetailer`` re-diffuses the people and
faces the detectors under ``<asset_root>/yolos`` find, and ``--preview``
writes progress previews (TAESD, or the linear RGB map) under
``<output-dir>/preview`` through the ``app.instance.app`` singleton. Runs
on the GPU. Usage:

    python -m lightdiffusion_next_tpu_torch.app.cli "a cat" 1024 1024
    python -m lightdiffusion_next_tpu_torch.app.cli "a cat" 1024 1024 --hires-fix
    python -m lightdiffusion_next_tpu_torch.app.cli image.png 1024 1024 --img2img
    python -m lightdiffusion_next_tpu_torch.app.cli "a cat" 1024 1024 --flux
    python -m lightdiffusion_next_tpu_torch.app.cli "a cat" 1024 1024 --adetailer --preview

Flux across N GPUs of one host, tensor-parallel (``LDT_FLUX_TP`` "auto",
the default, or its alias "spmd"; see ``pipelines/pipeline.py``): under
``torchrun`` (``WORLD_SIZE`` > 1) ``main`` initialises the process group
itself, nccl on ``LOCAL_RANK``'s GPU, unless one is initialised already;
only rank 0 prints the paths and writes the PNGs and ``last_seed.txt``:

    torchrun --nproc-per-node 2 \
        -m lightdiffusion_next_tpu_torch.app.cli "a cat" 1024 1024 --flux
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from lightdiffusion_next_tpu_torch import config as _config

# the RuntimeConfig fields with a flag each, and a --no- form
_TOGGLES = ("w8a8", "flux_scan", "fused_ew", "packed_attn", "fused_attn", "qkv_fuse")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lightdiffusion-torch",
                                description="LightDiffusion on an NVIDIA GPU")
    p.add_argument("prompt", help="prompt text (or image path with --img2img)")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("number", type=int, nargs="?", default=1)
    p.add_argument("batch", type=int, nargs="?", default=1)
    p.add_argument("--hires-fix", action="store_true")
    p.add_argument("--adetailer", action="store_true")
    p.add_argument("--enhance-prompt", action="store_true")
    p.add_argument("--img2img", action="store_true")
    p.add_argument("--stable-fast", action="store_true", help="accepted; changes nothing")
    p.add_argument("--reuse-seed", action="store_true")
    p.add_argument("--flux", action="store_true")
    p.add_argument("--prio-speed", action="store_true",
                   help="dpmpp_2m_cfgpp (one model call a step) instead of dpmpp_sde_cfgpp")
    p.add_argument("--autohdr", action="store_true")
    p.add_argument("--realistic-model", action="store_true")
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--multiscale-preset", default=None,
                   choices=["quality", "performance", "balanced", "disabled"])
    p.add_argument("--no-multiscale", action="store_true")
    p.add_argument("--multiscale-factor", type=float, default=0.5)
    p.add_argument("--multiscale-fullres-start", type=int, default=3)
    p.add_argument("--multiscale-fullres-end", type=int, default=8)
    p.add_argument("--multiscale-intermittent-fullres", action="store_true")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--preview", action="store_true")
    p.add_argument("--sage-attention", action="store_true",
                   help="SD1.5: the UNet's long-sequence attention in int8")
    for field in _TOGGLES:
        name = field.replace("_", "-")
        p.add_argument(f"--{name}", action="store_true",
                       help=f"force RuntimeConfig.{field} on (off with --no-{name})")
        p.add_argument(f"--no-{name}", action="store_true")
    return p


def runtime_config(args, base: _config.RuntimeConfig) -> _config.RuntimeConfig:
    """``base`` with the fields the flags force."""
    changes = {field: getattr(args, field) for field in _TOGGLES
               if getattr(args, field) or getattr(args, f"no_{field}")}
    if args.sage_attention:
        changes["sage_attention"] = True
    return dataclasses.replace(base, **changes)


def init_distributed() -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1) with no process group yet:
    nccl on ``LOCAL_RANK``'s GPU, made the current device. Returns whether
    it initialised the group."""
    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local)
    return True


def main(argv=None, device: _config.DeviceLike = None) -> int:
    """Parse ``argv``, run ``pipeline()`` on ``device`` (the GPU by
    default), print the saved paths (rank 0 of a process group only)."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    for field in _TOGGLES:
        if getattr(args, field) and getattr(args, f"no_{field}"):
            name = field.replace("_", "-")
            raise SystemExit(f"--{name} and --no-{name} are mutually exclusive")

    _config.set_config(runtime_config(args, _config.get_config()))

    from lightdiffusion_next_tpu_torch.app import instance
    from lightdiffusion_next_tpu_torch.parallel import inference as par_inf
    from lightdiffusion_next_tpu_torch.pipelines.pipeline import pipeline

    owns_group = init_distributed()
    writer = par_inf.is_writer()
    progress_callback = None
    if args.preview:
        instance.app.preview_dir = os.path.join(args.output_dir, "preview")
        progress_callback = instance.PreviewHook(instance.app)

    try:
        paths = pipeline(
            args.prompt,
            args.width,
            args.height,
            number=args.number,
            batch=args.batch,
            hires_fix=args.hires_fix,
            adetailer=args.adetailer,
            enhance_prompt=args.enhance_prompt,
            img2img=args.img2img,
            stable_fast=args.stable_fast,
            reuse_seed=args.reuse_seed,
            flux_enabled=args.flux,
            prio_speed=args.prio_speed,
            autohdr=args.autohdr,
            realistic_model=args.realistic_model,
            negative_prompt=args.negative_prompt,
            multiscale_preset=args.multiscale_preset,
            enable_multiscale=not args.no_multiscale,
            multiscale_factor=args.multiscale_factor,
            multiscale_fullres_start=args.multiscale_fullres_start,
            multiscale_fullres_end=args.multiscale_fullres_end,
            multiscale_intermittent_fullres=args.multiscale_intermittent_fullres,
            output_dir=args.output_dir,
            progress_callback=progress_callback,
            device=device,
        )
    finally:
        if owns_group:
            dist.destroy_process_group()
    if writer:
        for path in paths:
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
