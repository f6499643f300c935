"""Flux from files in the port, against the JAX package: the GGUF writer,
the RoPE of the unfused attention, the unfused double and single blocks and
the unfused DiT forward in both layouts, the GGUF loader in every
{Q8_0, W8A8} x {unrolled, scan} x {fused attention off, on} combination,
the model cache's variants, ``pipeline(flux_enabled=True)`` loading its four
files from the asset root, and the CLI's ``--flux``.

Every file is written by the test, from a numpy seed, at small widths that
keep head dim 128 (the fused path's) and K, N multiples of 256 and 128.
JAX's Pallas kernels run in interpret mode on the CPU. Tolerances:

- the writer: the same bytes as the JAX package's ``write_gguf``; the
  loaded leaves bit for bit what ``flux_model`` builds from the same
  records, and bit for bit the JAX loader's (``from_jax``);
- ``rope``, ``embed_nd``, ``apply_rope``: atol 1e-6 (the port computes the
  angles in float64; the JAX tests run with x64 off, so JAX's are f32;
  ``apply_rope`` is compared on the same tables);
- forwards: relative RMS error 1e-4 on Q8_0 weights, ``DIT_REL_RMSE``
  (1e-2, ``test_torch_w8a8.py``) on W8A8; the port's unfused forward
  against its fused one on the same weights: 1e-4;
- T5 through the loaders: both compute in bf16 (as the JAX
  ``_get_flux_models`` asks), held to 2e-2.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.ops import nn as jnn
from lightdiffusion_next_tpu.ops import rope as jrope
from lightdiffusion_next_tpu.pipelines import loader as jloader
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
from lightdiffusion_next_tpu_torch.models.clip import text_encoder as tte
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.ops import nn as tnn
from lightdiffusion_next_tpu_torch.ops import rope as trope
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.utils import state_dict as tsd
from test_torch_flux import TINY, _flux_params, _rel_rmse, _t, _write_flux_gguf
from test_torch_t5 import TINY as T5_TINY
from test_torch_w8a8 import DIT_REL_RMSE

AXES = (16, 56, 56)
T5_Q8 = ("attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_o.weight",
         "ffn_up.weight", "ffn_down.weight", "ffn_gate.weight", "token_embd.weight")


@pytest.fixture
def configs():
    """Set both packages' ``RuntimeConfig`` fields (the same names);
    restored after the test."""
    saved_j, saved_t = jconfig.get_config(), tconfig.get_config()

    def set_(**kw):
        jconfig.set_config(dataclasses.replace(saved_j, **kw))
        tconfig.set_config(dataclasses.replace(saved_t, **kw))

    yield set_
    jconfig.set_config(saved_j)
    tconfig.set_config(saved_t)


def _inputs(seed, side=16, txt=64, vec=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, side, side, 16)).astype(np.float32),
            np.asarray([0.7], np.float32),
            rng.standard_normal((1, txt, 256)).astype(np.float32),
            rng.standard_normal((1, vec)).astype(np.float32),
            np.asarray([3.0], np.float32))


def _jax_forward(params, cfg, inputs):
    return np.asarray(jflux.apply_flux(params, *(jnp.asarray(a) for a in inputs[:4]),
                                       jnp.asarray(inputs[4]), cfg=cfg))


def _port_forward(model, inputs):
    x, t, ctx, y, g = (_t(a) for a in inputs)
    return model.apply_fn(model.params, x, t, ctx, y=y, guidance=g).numpy()


def assert_same_leaves(a, b, path=""):
    """Two port param dicts equal bit for bit: the same keys, nested dicts,
    record types, tensor dtypes and values."""
    assert sorted(a) == sorted(b), path
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            assert_same_leaves(x, y, path + k + "/")
            continue
        assert type(x) is type(y), path + k
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path + k
            continue
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, torch.Tensor):
                assert u.dtype == v.dtype and torch.equal(u, v), f"{path}{k}.{f.name}"
            else:
                assert u == v, f"{path}{k}.{f.name}"


# --- the writer -------------------------------------------------------------


@pytest.mark.parametrize("arch,quantize", [("flux", tflux.Q8_0_SUFFIXES), ("t5encoder", T5_Q8)])
def test_write_gguf_bytes_equal_jax(tmp_path, arch, quantize):
    """The same bytes for the same f32 tensors (Q8_0 where a suffix matches
    and the last dim is a multiple of 32, F32 otherwise); records and a
    streamed layout write the same file; both readers read the values
    back."""
    rng = np.random.default_rng(1)
    tensors = {"a.qkv.weight": rng.standard_normal((64, 96)).astype(np.float32),
               "a.qkv.bias": rng.standard_normal((64,)).astype(np.float32),
               "b.linear1.weight": rng.standard_normal((3, 5, 64)).astype(np.float32) * 9,
               "c.proj.weight": rng.standard_normal((7, 33)).astype(np.float32),
               "enc.blk.0.attn_q.weight": rng.standard_normal((32, 64)).astype(np.float32),
               "token_embd.weight": np.zeros((4, 32), np.float32)}
    jpath, tpath, spath = (str(tmp_path / f"{n}.gguf") for n in "jts")
    jggml.write_gguf(jpath, tensors, arch=arch, quantize=quantize)
    n = tggml.write_gguf(tpath, tensors, arch=arch, quantize=quantize)
    ref = open(jpath, "rb").read()
    assert open(tpath, "rb").read() == ref and n == len(ref)

    def leaf(k, v):
        q8 = any(k.endswith(s) for s in quantize) and v.shape[-1] % 32 == 0
        return tggml.quantize(_t(v)) if q8 else _t(v)

    layout = [(k, v.shape, isinstance(leaf(k, v), tggml.QTensor8)) for k, v in tensors.items()]
    tggml.write_gguf(spath, ((k, leaf(k, v)) for k, v in tensors.items()), arch=arch,
                     layout=layout)
    assert open(spath, "rb").read() == ref
    with pytest.raises(ValueError, match="layout"):
        tggml.write_gguf(spath, reversed(list(tensors.items())), arch=arch, layout=layout)

    jsd, tsd_ = jggml.gguf_sd_loader(jpath), tggml.gguf_sd_loader(tpath)
    assert sorted(jsd) == sorted(tsd_)
    for k, v in jsd.items():
        if isinstance(v, jggml.QTensor8):
            np.testing.assert_array_equal(tsd_[k].q.numpy(), np.asarray(v.q))
            np.testing.assert_array_equal(tsd_[k].scales.numpy(), np.asarray(v.scales))
        else:
            np.testing.assert_array_equal(tsd_[k].numpy(), np.asarray(v))


# --- RoPE and the unfused blocks ------------------------------------------


def test_rope_embed_nd_apply_rope_match_jax():
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.zeros((1, 8, 3), np.float32),
                          np.asarray(jflux.img_ids(1, 16, 24))], axis=1)
    pos = rng.uniform(0, 32, (2, 40)).astype(np.float32)
    np.testing.assert_allclose(trope.rope(_t(pos), 16).numpy(),
                               np.asarray(jrope.rope(jnp.asarray(pos), 16)), atol=1e-6, rtol=0)
    jpe = jrope.embed_nd(jnp.asarray(ids), AXES)
    tpe = trope.embed_nd(_t(ids), AXES)
    assert tpe.shape == jpe.shape == (1, 1, ids.shape[1], 64, 2, 2) and tpe.dtype == torch.float32
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), atol=1e-6, rtol=0)
    # apply_rope on the same tables (the angles' f32/f64 difference is held
    # above), so only the rotation itself is compared
    q, k = (rng.standard_normal((1, 2, ids.shape[1], 128)).astype(np.float32) for _ in "qk")
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jpe)
    tq, tk = trope.apply_rope(_t(q), _t(k), _t(jpe))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    tqb, _ = trope.apply_rope(_t(q).bfloat16(), _t(k).bfloat16(), tpe)
    assert tqb.dtype == torch.bfloat16


def _unfused_pair(tmp_path, seed):
    """The JAX package's and the port's Q8_0 params of one small DiT from one
    GGUF, unpermuted (f32 compute)."""
    cfg, params = _flux_params(seed)
    path = _write_flux_gguf(tmp_path, params)
    jp = jggml.to_device_quantized(jggml.gguf_sd_loader(path), dtype=jnp.float32)
    tp = tggml.to_device_quantized(tggml.gguf_sd_loader(path), dtype=torch.float32,
                                   device="cpu")
    return cfg, jp, tp, path


def test_unfused_blocks_match_jax(tmp_path):
    """One double block and one single block on the unfused path (the heads
    split, QKNorm, ``apply_rope``, attention) against the JAX blocks."""
    cfg, jp, tp, _ = _unfused_pair(tmp_path, 30)
    tcfg = tflux.FluxConfig(**TINY)
    rng = np.random.default_rng(31)
    img, txt = (rng.standard_normal((1, n, 256)).astype(np.float32) for n in (64, 24))
    vec = rng.standard_normal((1, 256)).astype(np.float32)
    ids = np.concatenate([np.zeros((1, 24, 3), np.float32),
                          np.asarray(jflux.img_ids(1, 16, 16))], axis=1)
    jpe, tpe = jrope.embed_nd(jnp.asarray(ids), AXES), trope.embed_nd(_t(ids), AXES)
    jim, jtx = jflux._double_block(jnn.ParamView(jp, "double_blocks.0."), jnp.asarray(img),
                                   jnp.asarray(txt), jnp.asarray(vec), jpe, cfg)
    tim, ttx = tflux._double_block(tnn.ParamView(tp, "double_blocks.0."), _t(img), _t(txt),
                                   _t(vec), tpe, tcfg)
    assert _rel_rmse(tim.numpy(), jim) <= 1e-5 and _rel_rmse(ttx.numpy(), jtx) <= 1e-5
    xx = np.concatenate([txt, img], axis=1)
    jx = jflux._single_block(jnn.ParamView(jp, "single_blocks.0."), jnp.asarray(xx),
                             jnp.asarray(vec), jpe, cfg)
    tx = tflux._single_block(tnn.ParamView(tp, "single_blocks.0."), _t(xx), _t(vec), tpe, tcfg)
    assert _rel_rmse(tx.numpy(), jx) <= 1e-5


@pytest.mark.parametrize("w8a8,scan", [(False, False), (False, True), (True, False),
                                       (True, True)])
def test_unfused_forward_matches_jax(tmp_path, configs, w8a8, scan):
    """The whole unfused DiT forward, unrolled and stacked, Q8_0 and W8A8
    (``fused_ew`` on), against the JAX forward on the same weights."""
    cfg, jp, _, path = _unfused_pair(tmp_path, 32)
    configs(w8a8=w8a8, fused_ew=True, flux_scan=scan, fused_attn=False)
    if w8a8:
        jp = jggml.to_w8a8(jp)
    if scan:
        jp = jflux.stack_block_params(jp, cfg)
    inputs = _inputs(33)
    ref = _jax_forward(jp, cfg, inputs)
    model = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.FluxConfig(**TINY),
                             device="cpu")
    assert not model.config.fused_attn and tflux.is_stacked(model.params) == scan
    assert _rel_rmse(_port_forward(model, inputs), ref) <= (DIT_REL_RMSE if w8a8 else 1e-4)


def test_fused_forward_equals_unfused(tmp_path, configs):
    """The port's two attention paths on the same weights (the fused one's
    permuted) give the same forward."""
    _, _, _, path = _unfused_pair(tmp_path, 34)
    inputs = _inputs(35)
    outs = {}
    for fused in (False, True):
        configs(fused_attn=fused)
        model = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.FluxConfig(**TINY),
                                 device="cpu")
        assert model.config.fused_attn == fused
        outs[fused] = _port_forward(model, inputs)
    assert _rel_rmse(outs[True], outs[False]) <= 1e-4


# --- the loader -------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("w8a8", [False, True])
def test_loader_matches_flux_model_and_jax(tmp_path, configs, w8a8, scan, fused):
    """``load_diffusion_model_gguf`` in each combination: its leaves bit for
    bit ``flux_model``'s from the same records (the scan layout stacked on
    the host, the others on the device path) and the JAX loader's, its
    forward within the limits. JAX runs every combination on the CPU (its
    kernels in interpret mode)."""
    cfg, params = _flux_params(40)
    path = _write_flux_gguf(tmp_path, params)
    configs(w8a8=w8a8, flux_scan=scan, fused_attn=fused, fused_ew=True)
    model = tloader.load_diffusion_model_gguf(path, device="cpu")
    assert model.model_type == "flux" and model.config.fused_attn == fused
    assert tflux.is_stacked(model.params) == scan
    built = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.detect_config(
        tggml.gguf_sd_loader(path), dtype=torch.float32), device="cpu")
    assert built.config == model.config
    assert_same_leaves(model.params, built.params)
    jmodel = jloader.load_diffusion_model_gguf(path)
    assert jmodel.config.fused_attn == fused
    assert_same_leaves(model.params, tggml.to_device_quantized(
        from_jax(jmodel.params), dtype=torch.float32, device="cpu"))
    inputs = _inputs(41)
    ref = _jax_forward(jmodel.params, jmodel.config, inputs)
    assert _rel_rmse(_port_forward(model, inputs), ref) <= (DIT_REL_RMSE if w8a8 else 1e-4)


def test_loader_refuses_a_non_flux_gguf(tmp_path):
    path = str(tmp_path / "t5.gguf")
    tggml.write_gguf(path, {"enc.blk.0.attn_q.weight": np.zeros((32, 32), np.float32)},
                     arch="t5encoder")
    with pytest.raises(RuntimeError, match="not a Flux GGUF"):
        tloader.load_diffusion_model_gguf(path, device="cpu")
    with pytest.raises(RuntimeError, match="not a Flux GGUF"):
        jloader.load_diffusion_model_gguf(path)


def test_cache_evicts_other_variants(tmp_path):
    path = str(tmp_path / "flux.gguf")
    open(path, "wb").close()
    cache = tloader.ModelCache()
    cache.put(path, "q8", variant="dev=cpu")
    cache.put(path, "w8", variant="dev=cpu:w8a8")
    cache.put(str(tmp_path / "other.gguf"), "other")
    cache.evict_other_variants(path, keep_variant="dev=cpu:w8a8")
    assert cache.get(path, "dev=cpu") is None and cache.get(path, "dev=cpu:w8a8") == "w8"
    assert cache.get(str(tmp_path / "other.gguf")) == "other"


# --- pipeline() and the CLI from files --------------------------------------


def _write_flux_assets(root):
    """Tiny DiT, T5, CLIP-L and AE files under the asset names of the Flux
    flow: the DiT and T5 written by the port's GGUF writer, CLIP-L (12
    heads of 8, the JAX loader's head count) and the AE as safetensors."""
    from safetensors.numpy import save_file

    cfg = jflux.FluxConfig(**{**TINY, "vec_in_dim": 96})  # CLIP-L's pooled width here
    params = jflux.init_params(cfg, seed=50)
    for sub in ("unet", "clip", "vae"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    tggml.write_gguf(os.path.join(root, "unet", "flux1-dev-Q8_0.gguf"), params, arch="flux",
                     quantize=tflux.Q8_0_SUFFIXES)
    t5p = tt5.init_params(tt5.T5Config(**T5_TINY), seed=51)
    tggml.write_gguf(os.path.join(root, "clip", "t5-v1_1-xxl-encoder-Q8_0.gguf"),
                     {tggml.t5_gguf_name(k): v for k, v in t5p.items()}, arch="t5encoder",
                     quantize=T5_Q8)
    save_file(tte.init_params(num_layers=2, width=96, heads=12, seed=52, with_projection=True),
              os.path.join(root, "clip", "clip_l.safetensors"))
    vcfg = tvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16,
                          has_quant_conv=False)
    save_file(tvae.init_params(vcfg, seed=53), os.path.join(root, "vae", "ae.safetensors"))
    return cfg


@pytest.fixture
def flux_assets(tmp_path, monkeypatch):
    root = str(tmp_path / "assets")
    cfg = _write_flux_assets(root)
    monkeypatch.setenv("LDT_ASSET_ROOT", root)
    monkeypatch.setenv("LDT_OFFLINE", "1")
    tloader.get_model_cache().clear()
    yield root, cfg
    tloader.get_model_cache().clear()


def _asset_paths(root):
    return (os.path.join(root, "unet", "flux1-dev-Q8_0.gguf"),
            os.path.join(root, "clip", "t5-v1_1-xxl-encoder-Q8_0.gguf"),
            os.path.join(root, "clip", "clip_l.safetensors"),
            os.path.join(root, "vae", "ae.safetensors"))


def test_pipeline_loads_flux_from_files(flux_assets, tmp_path, monkeypatch):
    """``pipeline(flux_enabled=True)`` with no models: the four files load
    through the cache and the PNG is written; a second call reads no file;
    each loaded model's forward matches the JAX ``_get_flux_models``'s on
    the same files."""
    root, cfg = flux_assets
    reads = []
    for mod, name in ((tggml, "gguf_sd_loader"), (tsd, "load_torch_file")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda p, *a, _r=real, **k: reads.append(p) or _r(p, *a,
                                                                                      **k))
    out = str(tmp_path / "out")
    paths = tpipe.pipeline("a castle", 64, 64, flux_enabled=True, seed=5, device="cpu",
                           output_dir=out)
    assert len(paths) == 1 and paths[0].endswith(".png") and "Flux" in paths[0]
    assert len(reads) == 4
    paths2 = tpipe.pipeline("a castle", 64, 64, flux_enabled=True, seed=5, device="cpu",
                            output_dir=out)
    assert len(reads) == 4 and open(paths[0], "rb").read() == open(paths2[0], "rb").read()

    model, vae, t5, clip = tpipe._get_flux_models(*_asset_paths(root), "cpu")
    assert len(reads) == 4  # every model from the cache
    assert not model.config.fused_attn and not tflux.is_stacked(model.params)
    jmodel, jvae, jt5m, jclip = jpipe._get_flux_models(*_asset_paths(root))
    inputs = _inputs(54, side=8, vec=96)
    assert _rel_rmse(_port_forward(model, inputs),
                     _jax_forward(jmodel.params, jmodel.config, inputs)) <= 1e-4
    z = np.random.default_rng(55).standard_normal((1, 8, 8, 16)).astype(np.float32)
    assert _rel_rmse(vae.decode(_t(z)).numpy(), jvae.decode(jnp.asarray(z))) <= 1e-4
    rows = [[(t, 1.0) for t in [49406] + list(range(300, 310)) + [49407] * 66]]
    (tc, tpool), (jc, jpool) = (m.encode_token_weights(rows) for m in (clip, jclip))
    assert _rel_rmse(tc.numpy(), jc) <= 1e-4 and _rel_rmse(tpool.numpy(), jpool) <= 1e-4
    t5rows = [[(t, 1.0) for t in list(range(40, 60)) + [1]]]
    assert _rel_rmse(t5.encode_token_weights(t5rows)[0].numpy(),
                     jt5m.encode_token_weights(t5rows)[0]) <= 2e-2


def test_pipeline_flux_missing_file_raises(flux_assets):
    root, _ = flux_assets
    os.remove(_asset_paths(root)[3])
    with pytest.raises(FileNotFoundError, match="ae.safetensors"):
        tpipe.pipeline("a cat", 64, 64, flux_enabled=True, seed=1, device="cpu")


def test_pipeline_flux_variants_keep_one_dit(flux_assets, configs):
    """A ``RuntimeConfig`` flip loads the other variant and evicts the first:
    one resident DiT and one T5."""
    root, _ = flux_assets
    cache = tloader.get_model_cache()
    configs(flux_scan=False)
    first = tpipe._get_flux_models(*_asset_paths(root), "cpu")[0]
    configs(flux_scan=True, w8a8=True, fused_attn=True)
    second = tpipe._get_flux_models(*_asset_paths(root), "cpu")[0]
    assert tflux.is_stacked(second.params) and second.config.fused_attn
    assert second is not first
    unet = _asset_paths(root)[0]
    assert cache.get(unet, "dev=cpu") is None
    assert cache.get(unet, "dev=cpu:w8a8:scan:fusedattn") is second
    t5 = cache.get(_asset_paths(root)[1], "dev=cpu:scan")
    assert t5 is not None and tt5.is_stacked(t5.params)
    assert cache.get(_asset_paths(root)[1], "dev=cpu") is None


def test_cli_flux_prints_a_path(flux_assets, tmp_path, capsys):
    out = str(tmp_path / "cli")
    assert tcli.main(["a cat", "64", "64", "--flux", "--output-dir", out], device="cpu") == 0
    printed = capsys.readouterr().out.split()
    assert len(printed) == 1 and printed[0].startswith(os.path.join(out, "Flux"))
    assert os.path.exists(printed[0])


def test_cli_fused_attn_flags(flux_assets):
    saved = tconfig.get_config()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main(["a cat", "64", "64", "--flux", "--fused-attn", "--no-fused-attn"],
                  device="cpu")
    parse = tcli.build_parser().parse_args
    assert tcli.runtime_config(parse(["a", "64", "64", "--no-fused-attn"]), saved) == \
        dataclasses.replace(saved, fused_attn=False)
    assert tcli.runtime_config(parse(["a", "64", "64", "--fused-attn"]), saved) == \
        dataclasses.replace(saved, fused_attn=True)
    assert tconfig.get_config() == saved
