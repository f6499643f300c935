"""The SD1.5 default flow as a whole: the JAX package's real ``pipeline()``
and the port's, with every default, on the same files.

One asset root holds the tiny checkpoint of scripts/make_tiny_assets.py
(UNet, VAE and CLIP-L at width 768, f32), a seeded Kohya
``loras/add_detail.safetensors`` over every attention and feed-forward
linear of the UNet and CLIP, and the four textual-inversion embeddings
``DEFAULT_NEGATIVE`` names (A1111 ``.pt`` and ``.safetensors``, one in a
subdirectory). Both packages load the checkpoint, merge the LoRA at
0.7/0.7, splice the embeddings into the negative prompt, run
``dpmpp_sde_cfgpp`` with the Brownian-tree noise over 20 karras steps with
multi-scale and MSW-MSA, decode, run AutoHDR and write a 128x128 PNG, from
one seed read back from the seed file (``reuse_seed``, a seed above 2^32).
Each package runs once per file; the cases share the result.

Tolerance: the PNGs within one uint8 level (f32 on both sides, summation
order differs over 39 model calls, and a value near a rounding edge can
land on either side); the final latents to 1e-4 relative RMS.
"""

import logging
import os
import re
import sys

import numpy as np
import pytest
import safetensors.numpy
import torch
from PIL import Image

from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.models import lora as tlora
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.utils import hdr as thdr
from lightdiffusion_next_tpu_torch.utils import image as timage
from lightdiffusion_next_tpu_torch.utils import params_io as tparams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a (cute:1.2) cat on a mat"
SEED = 2**40 + 77
LINEARS = re.compile(r"(transformer_blocks\.\d+\.(attn[12]\.(to_[qkv]|to_out\.0)|"
                     r"ff\.net\.(0\.proj|2))|layers\.\d+\.(self_attn\.(q|k|v|out)_proj|"
                     r"mlp\.fc[12]))\.weight$")
EMBEDDINGS = {"EasyNegative": 8, "badhandv4": 6, "lr": 2, "ng_deepnegative_v1_75t": 75}


def write_assets(root):
    """The checkpoint, the LoRA and the embeddings under ``root``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_tiny_assets
    finally:
        sys.path.pop(0)
    ckpt = make_tiny_assets.main(str(root))
    rng = np.random.default_rng(11)
    lora = {}
    for key, w in safetensors.numpy.load_file(ckpt).items():
        if not LINEARS.search(key):
            continue
        if key.startswith("model.diffusion_model."):
            name = "lora_unet_" + key[len("model.diffusion_model."):-len(".weight")]
        else:
            name = "lora_te_" + key[len("cond_stage_model.transformer."):-len(".weight")]
        name = name.replace(".", "_")
        lora[f"{name}.lora_down.weight"] = (rng.standard_normal((8, w.shape[1])) * 0.05
                                            ).astype(np.float16)
        lora[f"{name}.lora_up.weight"] = (rng.standard_normal((w.shape[0], 8)) * 0.05
                                          ).astype(np.float16)
        lora[f"{name}.alpha"] = np.array(4.0, np.float16)
    os.makedirs(root / "loras")
    safetensors.numpy.save_file(lora, str(root / "loras" / "add_detail.safetensors"))
    vecs = {n: (rng.standard_normal((k, 768)) * 0.02).astype(np.float32)
            for n, k in EMBEDDINGS.items()}
    emb = root / "embeddings"
    (emb / "negative").mkdir(parents=True)
    safetensors.numpy.save_file({"emb_params": vecs["EasyNegative"]},
                                str(emb / "EasyNegative.safetensors"))
    for name in ("badhandv4", "lr", "ng_deepnegative_v1_75t"):
        path = emb / ("negative" if name == "lr" else "") / f"{name}.pt"
        torch.save({"string_to_token": {"*": 265},
                    "string_to_param": {"*": torch.from_numpy(vecs[name])},
                    "name": name, "step": 1000}, str(path))
    return ckpt, lora, vecs


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    ckpt, lora, vecs = write_assets(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("LDT_ASSET_ROOT", str(root))
    mp.setenv("LDT_OFFLINE", "1")
    (root / "last_seed.txt").write_text(str(SEED))
    records = _Records()
    logger = logging.getLogger("lightdiffusion_next_tpu_torch")
    old_level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(records)
    try:
        port_x, jax_x = [], []
        port = tpipe.pipeline(PROMPT, 128, 128, reuse_seed=True, device="cpu",
                              output_dir=str(root / "port"),
                              progress_callback=lambda info: port_x.append(info["x"]))
        params = tparams.load_parameters_from_file()
        ref = jpipe.pipeline(PROMPT, 128, 128, reuse_seed=True,
                             output_dir=str(root / "jax"),
                             progress_callback=lambda info: jax_x.append(np.asarray(info["x"])))
        yield dict(root=root, ckpt=ckpt, lora=lora, vecs=vecs, port=port, ref=ref,
                   port_x=port_x, jax_x=jax_x, records=records, params=params)
    finally:
        logger.removeHandler(records)
        logger.setLevel(old_level)
        mp.undo()


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


def test_default_slice_png_matches_jax(runs):
    assert [os.path.basename(p) for p in runs["port"]] == ["LD_00001_.png"]
    assert os.path.dirname(runs["port"][0]).endswith("Classic")
    ours, theirs = _png(runs["port"][0]), _png(runs["ref"][0])
    assert ours.shape == theirs.shape == (128, 128, 3)
    assert np.abs(ours - theirs).max() <= 1


def test_default_slice_latent_matches_jax(runs):
    assert len(runs["port_x"]) == len(runs["jax_x"]) == 20
    out, ref = runs["port_x"][-1].numpy(), runs["jax_x"][-1]
    assert np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)) < 1e-4


def test_default_slice_loads_merges_and_splices(runs):
    """The checkpoint loaded once into the cache and left as loaded, the
    LoRA merged with every module matched, the negative prompt's rows
    carrying the four embeddings, the parameter file written."""
    msgs = runs["records"].messages
    assert sum(m.startswith("loaded ") for m in msgs) == 1
    modules = tlora.lora_modules(runs["lora"])
    n_unet = sum(m.startswith("lora_unet_") for m in modules)
    assert any(m == f"LoRA: {n_unet} UNet and {len(modules) - n_unet} CLIP modules patched "
               f"of the file's {len(modules)}" for m in msgs), msgs
    model, clip, _ = tloader.CheckpointLoaderSimple().load_checkpoint(
        runs["ckpt"], os.path.join(str(runs["root"]), "embeddings"), device="cpu")
    w = safetensors.numpy.load_file(runs["ckpt"])[
        "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.ff.net.2.weight"]
    np.testing.assert_array_equal(
        model.params["input_blocks.1.1.transformer_blocks.0.ff.net.2.weight"].numpy(), w)

    rows = clip.tokenize(tpipe.DEFAULT_NEGATIVE)["l"]
    vectors = [t for row in rows for t, _ in row if not isinstance(t, (int, np.integer))]
    want = np.concatenate([runs["vecs"][n] for n in EMBEDDINGS])
    assert len(rows) == 2 and len(vectors) == len(want)
    np.testing.assert_array_equal(np.stack(vectors), want)
    assert runs["params"] == (PROMPT, tpipe.DEFAULT_NEGATIVE, 128, 128, 7)


def test_default_slice_png_is_the_hdr_of_the_decode(runs):
    _, _, vae = tloader.CheckpointLoaderSimple().load_checkpoint(
        runs["ckpt"], os.path.join(str(runs["root"]), "embeddings"), device="cpu")
    from lightdiffusion_next_tpu_torch.utils import latent as tlatent

    pixels = vae.decode(tlatent.SD15.process_out(runs["port_x"][-1]))
    want = timage.to_uint8(thdr.apply_hdr_batch(pixels).numpy())[0]
    np.testing.assert_array_equal(_png(runs["port"][0]), want)
    assert not np.array_equal(want, timage.to_uint8(pixels.numpy())[0])


def test_cli_defaults_end_to_end(runs, capsys):
    """The CLI with its defaults (dpmpp_sde_cfgpp, AutoHDR off) on the
    cached model: no second load, the PNG path printed."""
    out_dir = str(runs["root"] / "cli")
    n_loaded = sum(m.startswith("loaded ") for m in runs["records"].messages)
    assert tcli.main([PROMPT, "128", "128", "1", "1", "--output-dir", out_dir],
                     device="cpu") == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [os.path.join(out_dir, "Classic", "LD_00001_.png")]
    assert os.path.exists(printed[0]) and _png(printed[0]).shape == (128, 128, 3)
    assert sum(m.startswith("loaded ") for m in runs["records"].messages) == n_loaded


@pytest.mark.parametrize("flag", ["--flux", "--preview", "--hires-fix", "--img2img",
                                  "--adetailer", "--enhance-prompt"])
def test_cli_unported_flags_raise(flag, tmp_path, monkeypatch):
    """Each unported flag raises before anything loads; ``--flux``,
    ``--preview``, ``--hires-fix``, ``--img2img`` and ``--adetailer`` are
    ported and raise FileNotFoundError for their missing files (the Flux
    assets, the SD1.5 checkpoint, which img2img loads before it reads the
    image)."""
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    monkeypatch.setenv("LDT_OFFLINE", "1")
    missing = {"--flux": "flux asset missing", "--hires-fix": "checkpoint missing",
               "--img2img": "checkpoint missing", "--preview": "checkpoint missing",
               "--adetailer": "checkpoint missing"}
    if flag in missing:
        with pytest.raises(FileNotFoundError, match=missing[flag]):
            tcli.main(["a cat", "64", "64", flag, "--output-dir", str(tmp_path)],
                      device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["a cat", "64", "64", flag], device="cpu")


def test_cli_mutually_exclusive_flags_and_config():
    from lightdiffusion_next_tpu_torch import config as tconfig

    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main(["a cat", "64", "64", "--w8a8", "--no-w8a8"], device="cpu")
    saved = tconfig.get_config()
    with pytest.raises(NotImplementedError):
        tcli.main(["a cat", "64", "64", "--no-packed-attn", "--enhance-prompt"], device="cpu")
    assert tconfig.get_config() == saved  # the unported flag raised first
    parse = tcli.build_parser().parse_args
    base = tconfig.RuntimeConfig()
    assert tcli.runtime_config(parse(["a", "64", "64"]), base) == base
    got = tcli.runtime_config(parse(["a", "64", "64", "--no-packed-attn", "--sage-attention",
                                     "--no-flux-scan", "--w8a8", "--no-fused-ew",
                                     "--fused-attn", "--no-qkv-fuse", "--stable-fast"]), base)
    assert got == tconfig.RuntimeConfig(packed_attn=False, sage_attention=True,
                                        flux_scan=False, w8a8=True, fused_ew=False,
                                        fused_attn=True)
