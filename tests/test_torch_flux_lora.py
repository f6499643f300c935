"""Flux LoRA in the port, against the JAX package: ``QTensorLoRA`` (an
unmerged low-rank patch over a Q8_0 or W8A8 weight), ``apply_lora`` on
Flux params (every block linear patched, two LoRAs chained by rank), and
the refusals: stacked (scan) params, as in the JAX package, and params
built for the fused attention when a patch targets a ``qkv`` or ``linear1``
weight (the port's own: the JAX package applies such a patch in the wrong
basis).

Inputs come from a numpy seed; the DiT is written to a GGUF by the test and
loaded by both packages (unfused attention, f32 compute on the CPU).
Tolerances: ``QTensorLoRA``'s matmul 1e-5 of max |ref| (f32, another
summation order); the patched forward a relative RMS error of 1e-4 on Q8_0
bases and ``DIT_REL_RMSE`` (1e-2) on W8A8 bases, as the unpatched
forwards; the patches' up and down bit for bit.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models import lora as jlora
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.pipelines import loader as jloader
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models import lora as tlora
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from test_torch_flux import _flux_params, _rel_rmse, _t, _write_flux_gguf
from test_torch_flux_gguf import _inputs, _jax_forward, _port_forward
from test_torch_w8a8 import DIT_REL_RMSE

# every block linear of the DiT (Kohya names are the keys with "_" for ".")
BLOCK_LINEARS = re.compile(r"^(double|single)_blocks\.\d+\..*(qkv|proj|mlp\.[02]|linear[12]|"
                           r"mod\.lin|modulation\.lin)\.weight$")


@pytest.fixture
def configs():
    saved_j, saved_t = jconfig.get_config(), tconfig.get_config()

    def set_(**kw):
        jconfig.set_config(dataclasses.replace(saved_j, **kw))
        tconfig.set_config(dataclasses.replace(saved_t, **kw))

    yield set_
    jconfig.set_config(saved_j)
    tconfig.set_config(saved_t)


def _lora_file(params, seed, rank=4):
    """A seeded Kohya-named LoRA over every block linear of ``params``
    (numpy f32, checkpoint keys)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, w in params.items():
        if not BLOCK_LINEARS.match(key):
            continue
        name = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        out_f, in_f = w.shape
        sd[f"{name}.lora_down.weight"] = (rng.standard_normal((rank, in_f))
                                          * in_f**-0.5).astype(np.float32)
        sd[f"{name}.lora_up.weight"] = (rng.standard_normal((out_f, rank)) * 0.05
                                        ).astype(np.float32)
        sd[f"{name}.alpha"] = np.float32(rank / 2)
    return sd


def _bases(rng, k=256, n=128):
    w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
    q, s = jggml.quantize_q8_0(w)
    jq8 = jggml.transpose_for_matmul(jggml.QTensor8(q=q, scales=s, shape=w.shape),
                                     device=False)
    jq8 = jggml.QTensor8T(qt=jnp.asarray(jq8.qt), scales_t=jnp.asarray(jq8.scales_t),
                          shape=jq8.shape)
    return jq8, jggml.to_w8a8({"w": jq8})["w"]


@pytest.mark.parametrize("kind", ["q8_0", "w8a8"])
def test_qtensor_lora_matmul_matches_jax(kind):
    rng = np.random.default_rng(1)
    jq8, jw8 = _bases(rng)
    jbase = jq8 if kind == "q8_0" else jw8
    tbase_ = from_jax({"w": jbase})["w"]
    up = rng.standard_normal((128, 8)).astype(np.float32) * 0.1
    down = rng.standard_normal((8, 256)).astype(np.float32) * 0.1
    jl = jggml.QTensorLoRA(base=jbase, up=jnp.asarray(up), down=jnp.asarray(down))
    tl = tggml.QTensorLoRA(tbase_, _t(up), _t(down))
    assert tl.shape == (128, 256)
    x = rng.standard_normal((2, 40, 256)).astype(np.float32)
    ref = np.asarray(jl.fused_matmul(jnp.asarray(x)))
    out = tl.fused_matmul(_t(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(tl.dequantize(torch.float32).numpy(),
                               np.asarray(jl.dequantize(jnp.float32)), rtol=0, atol=1e-6)
    assert not hasattr(tl, "modulated_matmul")  # the blocks take the plain chain
    w8 = tggml.to_w8a8({"w": tggml.QTensorLoRA(from_jax({"w": jq8})["w"], _t(up), _t(down))})
    assert isinstance(w8["w"].base, tggml.QTensor8W)
    np.testing.assert_array_equal(w8["w"].base.q.numpy(), np.asarray(jw8.qt).T)


def _assert_same_patch(tl, jl):
    assert isinstance(tl, tggml.QTensorLoRA) and isinstance(jl, jggml.QTensorLoRA)
    np.testing.assert_array_equal(tl.up.numpy(), np.asarray(jl.up))
    np.testing.assert_array_equal(tl.down.numpy(), np.asarray(jl.down))


@pytest.mark.parametrize("w8a8", [False, True])
def test_apply_lora_on_flux_matches_jax(tmp_path, configs, w8a8):
    """A LoRA over every block linear of the unfused DiT, then a second one
    chained onto the first (ranks concatenated), through both packages'
    ``load_and_apply_lora``; the patched forwards agree."""
    cfg, params = _flux_params(2)
    path = _write_flux_gguf(tmp_path, params)
    configs(w8a8=w8a8, fused_ew=True, flux_scan=False, fused_attn=False)
    model = tloader.load_diffusion_model_gguf(path, device="cpu")
    jmodel = jloader.load_diffusion_model_gguf(path)
    inputs = _inputs(3)
    jp, tp = jmodel.params, model.params
    for seed, rank in ((4, 4), (5, 2)):
        lora = _lora_file(params, seed, rank)
        jp, _ = jlora.load_and_apply_lora(lora, jp, None, 0.8, 0.0)
        tp, _ = tlora.load_and_apply_lora({k: _t(v) for k, v in lora.items()}, tp, None, 0.8,
                                          0.0, model_cfg=model.config)
    patched = [k for k in params if BLOCK_LINEARS.match(k)]
    quantized = [k for k in patched if k.endswith(tflux.Q8_0_SUFFIXES)]
    assert len(patched) == 13 and len(quantized) == 10
    for key in quantized:
        _assert_same_patch(tp[key], jp[key])
        assert tp[key].up.shape[1] == 6 and tp[key].down.shape[0] == 6
        base = tggml.QTensor8W if w8a8 else tggml.QTensor8T
        assert isinstance(tp[key].base, base) and tp[key].base is model.params[key]
    for key in set(patched) - set(quantized):  # the dense modulation weights merge
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), rtol=0, atol=1e-6)
    assert not any(isinstance(v, tggml.QTensorLoRA) for k, v in model.params.items())
    ref = _jax_forward(jp, jmodel.config, inputs)
    out = _port_forward(dataclasses.replace(model, params=tp), inputs)
    assert _rel_rmse(out, ref) <= (DIT_REL_RMSE if w8a8 else 1e-4)
    assert _rel_rmse(out, _port_forward(model, inputs)) > 1e-3  # the patch counts


def test_lora_refuses_stacked_params(tmp_path, configs):
    cfg, params = _flux_params(6)
    path = _write_flux_gguf(tmp_path, params)
    configs(flux_scan=True, fused_attn=False)
    model = tloader.load_diffusion_model_gguf(path, device="cpu")
    assert tflux.is_stacked(model.params)
    lora = {k: _t(v) for k, v in _lora_file(params, 7).items()}
    with pytest.raises(ValueError, match="stacked"):
        tlora.load_and_apply_lora(lora, model.params, None, 1.0, 0.0, model_cfg=model.config)
    jp = jflux.stack_block_params(jggml.to_device_quantized(
        jggml.gguf_sd_loader(path), dtype=jnp.float32), cfg)
    with pytest.raises(ValueError, match="stacked"):
        jlora.apply_lora(jp, {}, 1.0)


def test_lora_refuses_qk_targets_under_fused_attention(tmp_path, configs):
    """Params built for the fused attention hold their q/k rows in the
    permuted RoPE basis: a patch on a ``qkv`` or ``linear1`` weight would
    land in the wrong basis, so it raises and names the way out. Patches on
    other weights still apply, and a LoRA'd model keeps the unfused path
    when it is rebuilt."""
    cfg, params = _flux_params(8)
    path = _write_flux_gguf(tmp_path, params)
    configs(flux_scan=False, fused_attn=True)
    model = tloader.load_diffusion_model_gguf(path, device="cpu")
    assert model.config.fused_attn
    lora = {k: _t(v) for k, v in _lora_file(params, 9).items()}
    with pytest.raises(ValueError, match="fused_attn off"):
        tlora.load_and_apply_lora(lora, model.params, None, 1.0, 0.0, model_cfg=model.config)
    proj_only = {k: v for k, v in lora.items() if "_proj." in k}
    new, _ = tlora.load_and_apply_lora(proj_only, model.params, None, 1.0, 0.0,
                                       model_cfg=model.config)
    assert isinstance(new["double_blocks.0.img_attn.proj.weight"], tggml.QTensorLoRA)
    with pytest.raises(ValueError, match="LoRA"):
        tflux.permute_rope_basis(
            {**new, "double_blocks.0.img_attn.qkv.weight": tggml.QTensorLoRA(
                new["double_blocks.0.img_attn.qkv.weight"], torch.zeros(768, 1),
                torch.zeros(1, 256))}, model.config)
    # flux_model on LoRA'd unpermuted params: the unfused path, with a warning
    configs(flux_scan=False, fused_attn=False)
    unfused = tloader.load_diffusion_model_gguf(path, device="cpu")
    patched, _ = tlora.load_and_apply_lora(lora, unfused.params, None, 1.0, 0.0,
                                           model_cfg=unfused.config)
    configs(flux_scan=True, fused_attn=True)
    rebuilt = tbase.flux_model(patched, cfg=unfused.config, device="cpu")
    assert not rebuilt.config.fused_attn and not tflux.is_stacked(rebuilt.params)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_lora_on_flux_needs_model_cfg(tmp_path, configs, fused):
    """Only the model's config tells a permuted q/k basis from the
    checkpoint's, so Flux DiT params patched without ``model_cfg`` raise,
    on a fused build and an unfused one alike, and nothing is applied."""
    cfg, params = _flux_params(10)
    path = _write_flux_gguf(tmp_path, params)
    configs(flux_scan=False, fused_attn=fused)
    model = tloader.load_diffusion_model_gguf(path, device="cpu")
    assert model.config.fused_attn == fused
    lora = {k: _t(v) for k, v in _lora_file(params, 11).items()}
    with pytest.raises(ValueError, match="model_cfg"):
        tlora.load_and_apply_lora(lora, model.params, None, 1.0, 0.0)
    patches, _ = tlora.load_lora(lora, tlora.unet_key_map(model.params))
    with pytest.raises(ValueError, match="model_cfg"):
        tlora.apply_lora(model.params, patches, 1.0)
    assert not any(isinstance(v, tggml.QTensorLoRA) for v in model.params.values())
