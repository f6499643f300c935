"""The port's checkpoint IO, loader, model cache, downloader and parameter
file against the JAX package's.

The safetensors reader uses the standard library only; it must give every
listed dtype bit for bit as the ``safetensors`` package does (present
here, absent on the card's machine), with a ``__metadata__`` entry in the
header. The loader's params must equal the JAX loader's exactly on the
tiny checkpoint of scripts/make_tiny_assets.py (f32 on the CPU in both;
the JAX package's HWIO convs transposed to OIHW, the port's q|k|v and k|v
joined).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from lightdiffusion_next_tpu.pipelines import downloader as jdl
from lightdiffusion_next_tpu.pipelines import loader as jloader
from lightdiffusion_next_tpu.utils import params_io as jparams
from lightdiffusion_next_tpu.utils import state_dict as jsd
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.pipelines import downloader as tdl
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.utils import params_io as tparams
from lightdiffusion_next_tpu_torch.utils import state_dict as tsd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NP_DTYPES = [np.float16, np.float32, np.float64, np.int64, np.int32, np.int16, np.int8,
             np.uint8, np.bool_]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_tiny_assets
    finally:
        sys.path.pop(0)
    return make_tiny_assets.main(str(tmp_path_factory.mktemp("assets")))


def test_safetensors_reader_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {}
    for i, dt in enumerate(NP_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 1, 1), (0, 4), (1,)][i % 5]
        arrays[f"t{i}.{np.dtype(dt).name}"] = (rng.standard_normal(shape) * 50).astype(dt)
    path = str(tmp_path / "a.safetensors")
    safetensors.numpy.save_file(arrays, path, metadata={"format": "pt", "note": "x"})
    ours = tsd.read_safetensors(path)
    ref = safetensors.numpy.load_file(path)
    assert set(ours) == set(ref)  # __metadata__ skipped
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(v).dtype, k
        assert tuple(ours[k].shape) == v.shape
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # BF16 (numpy has none): against the torch loader, and at an odd offset
    t = {"a": torch.ones(1, dtype=torch.int8),
         "b": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).bfloat16()}
    safetensors.torch.save_file(t, path)
    ours = tsd.load_torch_file(path)
    for k, v in safetensors.torch.load_file(path).items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v)
    np.testing.assert_array_equal(ours["b"].float().numpy(), jsd.load_torch_file(path)["b"])


def test_load_torch_file_pt(tmp_path):
    w = torch.randn(3, 2, generator=torch.Generator().manual_seed(2)).half()
    path = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": {"a.weight": w, "step": 3}}, path)
    out = tsd.load_torch_file(path)
    assert list(out) == ["a.weight"] and out["a.weight"].dtype == torch.float16
    np.testing.assert_array_equal(out["a.weight"].float().numpy(),
                                  jsd.load_torch_file(path)["a.weight"])


def test_split_detect_and_prefix_match_jax(tiny_ckpt):
    t_parts = tsd.split_checkpoint(tsd.load_torch_file(tiny_ckpt))
    j_parts = jsd.split_checkpoint(jsd.load_torch_file(tiny_ckpt))
    for t, j in zip(t_parts, j_parts):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    assert tsd.detect_model_type(t_parts[0]) == jsd.detect_model_type(j_parts[0]) == "unet"
    tcfg, jcfg = tsd.detect_unet_config(t_parts[0]), jsd.detect_unet_config(j_parts[0])
    for field in ("in_channels", "out_channels", "model_channels", "channel_mult",
                  "num_res_blocks", "transformer_depth", "transformer_depth_middle",
                  "context_dim", "num_heads"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert jcfg.adm_in_channels is None and not jcfg.use_linear_in_transformer
    hwio = jsd.convs_to_hwio(j_parts[0])
    assert tsd.detect_unet_config(hwio) == tcfg  # either conv layout
    sd = {"a.x": 1, "a.y": 2, "b.z": 3}
    for filt in (False, True):
        assert (tsd.state_dict_prefix_replace(sd, {"a.": "c.", "b.": "a."}, filt)
                == jsd.state_dict_prefix_replace(sd, {"a.": "c.", "b.": "a."}, filt))


def _tiny_unet_sd(linear, label_emb, seed=0):
    """A tiny UNet state dict in the JAX layout (HWIO convs) from the JAX
    ``init_params``: transformer projections linear or 1x1 convs, with or
    without a seeded label embedding (adm 24 -> the time dim)."""
    from lightdiffusion_next_tpu.models import unet as junet

    cfg = junet.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
                           transformer_depth=(1, 1), context_dim=64, num_heads=2,
                           use_linear_in_transformer=linear)
    sd = {k: np.asarray(v, np.float32) for k, v in junet.init_params(cfg, seed=seed).items()}
    if label_emb:
        rng = np.random.default_rng(seed + 1)
        sd["label_emb.0.0.weight"] = rng.standard_normal((128, 24)).astype(np.float32)
        sd["label_emb.0.0.bias"] = rng.standard_normal(128).astype(np.float32)
        sd["label_emb.0.2.weight"] = rng.standard_normal((128, 128)).astype(np.float32)
        sd["label_emb.0.2.bias"] = rng.standard_normal(128).astype(np.float32)
    return sd


@pytest.mark.parametrize("case", ["conv", "linear", "conv+label_emb", "linear+label_emb",
                                  "unrecognized"])
def test_detect_refuses_what_the_unet_does_not_run(case):
    """Detection equals the JAX package's on conv and linear transformer
    projections, with and without a label embedding (the port's UNet runs
    all four); what both packages refuse, a state dict of no known model,
    raises the same ValueError in both."""
    if case == "unrecognized":
        sd = {"encoder.layers.0.weight": np.zeros((4, 4), np.float32)}
        with pytest.raises(ValueError, match="unrecognized"):
            jsd.detect_model_type(sd)
        with pytest.raises(ValueError, match="unrecognized"):
            tsd.detect_model_type({k: torch.from_numpy(v) for k, v in sd.items()})
        assert tsd.detect_model_type(
            {"double_blocks.0.img_attn.norm.key_norm.scale": 0}) == "flux"
        return
    sd = _tiny_unet_sd("linear" in case, "label_emb" in case)
    jcfg = jsd.detect_unet_config(sd)
    tcfg = tsd.detect_unet_config(from_jax(sd))  # OIHW, as the port keeps it
    fields = [f.name for f in dataclasses.fields(tcfg) if f.name != "dtype"]
    assert {f.name for f in dataclasses.fields(jcfg)} - {"dtype"} == set(fields)
    for field in fields:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.use_linear_in_transformer == ("linear" in case)
    assert tcfg.adm_in_channels == (24 if "label_emb" in case else None)
    assert tcfg.num_heads == 8 and tcfg.num_head_channels == -1
    assert tsd.detect_unet_config({k: torch.from_numpy(v) for k, v in sd.items()}) == tcfg
    assert tsd.detect_model_type(from_jax(sd)) == jsd.detect_model_type(sd) == "unet"


def test_loader_params_equal_jax_linear_label_emb(tiny_ckpt, tmp_path):
    """A one-file checkpoint whose UNet has linear transformer projections
    (the tiny checkpoint's 1x1 convs squeezed, the same function) and a
    label embedding: both loaders detect it alike and build the same
    params, the 2-D projections and ``label_emb`` carried as they are."""
    sd = safetensors.numpy.load_file(tiny_ckpt)
    pre = "model.diffusion_model."
    for k in list(sd):
        if k.startswith(pre) and k.endswith(("proj_in.weight", "proj_out.weight")):
            sd[k] = np.ascontiguousarray(sd[k][:, :, 0, 0])
    td, _ = sd[pre + "time_embed.0.weight"].shape
    rng = np.random.default_rng(9)
    for name, shape in (("0.0", (td, 768)), ("0.2", (td, td))):
        sd[f"{pre}label_emb.{name}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{pre}label_emb.{name}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    path = str(tmp_path / "linear_adm.safetensors")
    safetensors.numpy.save_file(sd, path)
    model, _, _ = tloader.load_checkpoint_guess_config(path, embedding_directory=str(tmp_path),
                                                       device="cpu")
    jmodel, _, _ = jloader.load_checkpoint_guess_config(path)
    assert model.config.use_linear_in_transformer and jmodel.config.use_linear_in_transformer
    assert model.config.adm_in_channels == jmodel.config.adm_in_channels == 768
    want = tunet.fuse_projections(from_jax({k: np.asarray(v) for k, v in jmodel.params.items()}))
    assert set(model.params) == set(want)
    for k, v in want.items():
        assert model.params[k].dtype == torch.float32
        np.testing.assert_array_equal(model.params[k].numpy(), v.numpy(), err_msg=k)
    assert model.params["input_blocks.1.1.proj_in.weight"].ndim == 2
    np.testing.assert_array_equal(model.params["label_emb.0.2.weight"].numpy(),
                                  sd[pre + "label_emb.0.2.weight"])


def test_loader_params_equal_jax(tiny_ckpt, tmp_path):
    model, clip, vae = tloader.load_checkpoint_guess_config(
        tiny_ckpt, embedding_directory=str(tmp_path), device="cpu")
    jmodel, jclip, jvae = jloader.load_checkpoint_guess_config(tiny_ckpt)
    want = tunet.fuse_projections(from_jax({k: np.asarray(v) for k, v in jmodel.params.items()}))
    assert set(model.params) == set(want)
    for k, v in want.items():
        assert model.params[k].dtype == torch.float32
        np.testing.assert_array_equal(model.params[k].numpy(), v.numpy(), err_msg=k)
    for ours, theirs in ((vae.params, jvae.params), (clip.model.model.params,
                                                      jclip.model.model.params)):
        theirs = from_jax({k: np.asarray(v) for k, v in theirs.items()})
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)
    assert model.config.channel_mult == jmodel.config.channel_mult
    assert vae.cfg.ch_mult == jvae.cfg.ch_mult and vae.cfg.ch == jvae.cfg.ch
    assert clip.tokenizer.clip_l.embedding_size == 768
    assert clip.tokenizer.clip_l.embedding_directory == str(tmp_path)


def test_one_file_flux_checkpoint_raises(tmp_path):
    path = str(tmp_path / "flux.safetensors")
    safetensors.numpy.save_file(
        {"model.diffusion_model.double_blocks.0.img_attn.norm.key_norm.scale":
         np.ones(4, np.float32)}, path)
    with pytest.raises(RuntimeError, match="flux"):
        tloader.load_checkpoint_guess_config(path, device="cpu")


def test_model_cache_hits_and_misses_on_mtime(tiny_ckpt, tmp_path):
    cache = tloader.ModelCache()
    cache.put(tiny_ckpt, "a")
    assert cache.get(tiny_ckpt) == "a" and cache.get(tiny_ckpt, "other") is None
    cache.put(tiny_ckpt, "b", "other")
    assert cache.get(tiny_ckpt, "other") == "b" and cache.get(tiny_ckpt) == "a"
    st = os.stat(tiny_ckpt)
    os.utime(tiny_ckpt, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert cache.get(tiny_ckpt, "other") is None  # rewritten: a miss
    assert cache.get_memory_info()["cached_models"] == 2
    cache.clear()
    assert cache.get_memory_info()["cached_models"] == 0

    loader = tloader.CheckpointLoaderSimple()
    first = loader.load_checkpoint(tiny_ckpt, str(tmp_path), device="cpu")
    assert loader.load_checkpoint(tiny_ckpt, str(tmp_path), device="cpu") is first
    assert loader.load_checkpoint(tiny_ckpt, None, device="cpu") is not first
    os.utime(tiny_ckpt, ns=(st.st_atime_ns, st.st_mtime_ns + 2 * 10**9))
    assert loader.load_checkpoint(tiny_ckpt, str(tmp_path), device="cpu") is not first


def test_downloader_offline_and_without_hub(tmp_path, monkeypatch):
    assert tdl.SD_ASSETS == jdl.SD_ASSETS and tdl.FLUX_ASSETS == jdl.FLUX_ASSETS
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    monkeypatch.setenv("LDT_OFFLINE", "1")
    (tmp_path / "loras").mkdir()
    (tmp_path / "loras" / "add_detail.safetensors").write_bytes(b"")
    missing = tdl.check_and_download()
    assert missing == jdl.check_and_download()
    assert len(missing) == len(tdl.SD_ASSETS) - 1
    assert all(m.endswith("(offline mode)") for m in missing)
    assert len(tdl.check_and_download_flux()) == len(tdl.FLUX_ASSETS)
    assert tdl.asset_path("loras", "x") == str(tmp_path / "loras" / "x")
    # no hub package (as on the card): every absent asset counts as missing
    monkeypatch.setenv("LDT_OFFLINE", "0")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    missing = tdl.check_and_download_flux()
    assert len(missing) == len(tdl.FLUX_ASSETS)
    assert all("from" in m for m in missing)


def test_parameter_file(tmp_path, monkeypatch):
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    tparams.write_parameters_to_file("a cat\non a mat", "ugly", 512, 768, 7)
    expect = ("a cat on a mat", "ugly", 512, 768, 7)
    assert tparams.load_parameters_from_file() == expect == jparams.load_parameters_from_file()
    with open(tmp_path / "prompt.txt") as f:
        ours = f.read()
    jparams.write_parameters_to_file("a cat\non a mat", "ugly", 512, 768, 7)
    with open(tmp_path / "prompt.txt") as f:
        assert f.read() == ours
    (tmp_path / "prompt.txt").write_text("prompt: a dog neg: bad w: 64h: 96cfg: 8")
    assert tparams.load_parameters_from_file() == ("a dog neg: bad w: 64h: 96cfg: 8".split(
        " neg")[0], "bad", 64, 96, 8) == jparams.load_parameters_from_file()
