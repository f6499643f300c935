"""Model assets under the asset root, fetched from the HuggingFace Hub when
missing.

Counterpart of lightdiffusion_next_tpu/pipelines/downloader.py: the same
asset lists and layout (``<asset_root>/<subdir>/<filename>``). A fetch
never blocks a run: ``LDT_OFFLINE=1`` skips the hub, and an absent
``huggingface_hub`` package or a failed download counts as missing. The
``check_and_download*`` functions return what is missing.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from lightdiffusion_next_tpu_torch import config as _config

# (repo_id, filename, subdir)
SD_ASSETS: List[Tuple[str, str, str]] = [
    ("Meina/MeinaMix", "Meina V10 - baked VAE.safetensors", "checkpoints"),
    ("Lykon/DreamShaper", "DreamShaper_8_pruned.safetensors", "checkpoints"),
    ("Bingsu/adetailer", "person_yolov8m-seg.pt", "yolos"),
    ("Bingsu/adetailer", "face_yolov9c.pt", "yolos"),
    ("segments-arnaud/sam_vit_b", "sam_vit_b_01ec64.pth", "yolos"),
    ("lllyasviel/Annotators", "RealESRGAN_x4plus.pth", "ESRGAN"),
    ("EvilEngine/add_detail", "add_detail.safetensors", "loras"),
    ("EvilEngine/badhandv4", "badhandv4.pt", "embeddings"),
    ("madebyollin/taesd", "taesd_decoder.safetensors", "vae_approx"),
]

FLUX_ASSETS: List[Tuple[str, str, str]] = [
    ("city96/FLUX.1-dev-gguf", "flux1-dev-Q8_0.gguf", "unet"),
    ("city96/t5-v1_1-xxl-encoder-gguf", "t5-v1_1-xxl-encoder-Q8_0.gguf", "clip"),
    ("comfyanonymous/flux_text_encoders", "clip_l.safetensors", "clip"),
    ("google/t5-v1_1-xxl", "spiece.model", "clip"),
    ("black-forest-labs/FLUX.1-dev", "ae.safetensors", "vae"),
    ("madebyollin/taef1", "diffusion_pytorch_model.safetensors", "vae_approx"),
]


def _download(assets) -> List[str]:
    root = _config.asset_root()
    offline = os.environ.get("LDT_OFFLINE", "0") == "1"
    missing = []
    for repo_id, filename, subdir in assets:
        target_dir = os.path.join(root, subdir)
        target = os.path.join(target_dir, filename)
        if os.path.exists(target):
            continue
        if offline:
            missing.append(f"{target} (offline mode)")
            continue
        try:
            from huggingface_hub import hf_hub_download

            os.makedirs(target_dir, exist_ok=True)
            hf_hub_download(repo_id=repo_id, filename=filename, local_dir=target_dir)
        except Exception as e:  # no hub package, no network
            missing.append(f"{target} (from {repo_id}: {e})")
    return missing


def check_and_download() -> List[str]:
    """The SD1.5 asset set; returns the paths still missing."""
    return _download(SD_ASSETS)


def check_and_download_flux() -> List[str]:
    """The Flux asset set; returns the paths still missing."""
    return _download(FLUX_ASSETS)


def asset_path(subdir: str, filename: str) -> str:
    return os.path.join(_config.asset_root(), subdir, filename)
