"""The port's models (UNet, VAE, CLIP and its tokenizer) against the JAX
package's, at tiny widths on the CPU in f32.

Params come from the JAX package's ``init_params`` and reach the port
through ``weights.from_jax``; the port's own ``init_params`` must draw the
same numbers. Tolerance for whole forwards: atol/rtol 1e-4 (f32, summation
order differs between XLA and PyTorch over a few dozen layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.clip import facade as jfacade
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.models.clip import tokenizer as jtok
from lightdiffusion_next_tpu.ops import window as jwin
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import facade as tfacade
from lightdiffusion_next_tpu_torch.models.clip import text_encoder as tte
from lightdiffusion_next_tpu_torch.models.clip import tokenizer as ttok
from lightdiffusion_next_tpu_torch.ops import window as twin
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1,
            context_dim=64, num_heads=2)
TINY_BLOCKS = (("input", 1), ("output", 2), ("output", 3))
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)


def _unet_pair(seed=0):
    jcfg = junet.UNetConfig(**TINY)
    tcfg = tunet.UNetConfig(**TINY)
    return jcfg, tcfg, junet.init_params(jcfg, seed=seed)


def test_unet_plan_and_attention_sites_match():
    jcfg, tcfg, _ = _unet_pair()
    for cfg_j, cfg_t in ((jcfg, tcfg), (junet.SD15_CONFIG, tunet.SD15_CONFIG)):
        jp = junet.build_plan(cfg_j)
        tp = tunet.build_plan(cfg_t)
        assert [[dataclasses.astuple(m) for m in b] for b in jp[0]] == \
            [[dataclasses.astuple(m) for m in b] for b in tp[0]]
        assert [dataclasses.astuple(m) for m in jp[1]] == [dataclasses.astuple(m) for m in tp[1]]
        assert [[dataclasses.astuple(m) for m in b] for b in jp[2]] == \
            [[dataclasses.astuple(m) for m in b] for b in tp[2]]
    sites = tunet.attention_blocks(tunet.SD15_CONFIG)
    level0 = [s[0] for s in sites if s[1] == 0]
    assert level0 == list(twin.SD15_BLOCKS)
    assert [s[1] for s in sites].count(1) == 5 and [s[1] for s in sites].count(2) == 5


@pytest.mark.parametrize("msw", [False, True])
def test_unet_forward_matches_jax(msw):
    """A 24x24 latent: level 0 has 576 tokens (the kernel route on the port;
    XLA attention on the JAX CPU backend), windowed into 144-token windows
    with the MSW override (sdpa on both)."""
    jcfg, tcfg, params = _unet_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 24, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([981.0, 981.0], np.float32)
    jover = jwin.make_msw_msa_override(blocks=TINY_BLOCKS, shift_idx=1) if msw else None
    tover = twin.make_msw_msa_override(blocks=TINY_BLOCKS, shift_idx=1) if msw else None
    japply = jax.jit(lambda p, x, t, c: junet.apply_unet(p, x, t, c, cfg=jcfg,
                                                          attn1_override=jover))
    ref = np.asarray(japply({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    tparams = tunet.fuse_projections(from_jax(params))
    out = tunet.apply_unet(tparams, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), cfg=tcfg, attn1_override=tover).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_unet_init_params_draw_for_draw():
    _, tcfg, params = _unet_pair(seed=5)
    ours = tunet.init_params(tcfg, seed=5)
    conv = from_jax(params)
    assert ours.keys() == conv.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v, conv[k].numpy(), err_msg=k)


def test_vae_decode_and_init_match_jax():
    jcfg, tcfg = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    params = jvae.init_params(jcfg, seed=3)
    ours = tvae.init_params(tcfg, seed=3)
    conv = from_jax(params)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, conv[k].numpy(), err_msg=k)
    z = np.random.default_rng(4).standard_normal((1, 24, 24, 4)).astype(np.float32)
    ref = np.asarray(jvae.VAE(params, jcfg).decode(jnp.asarray(z)))
    out = tvae.VAE(ours, tcfg, device="cpu").decode(torch.from_numpy(z)).numpy()
    assert out.shape == (1, 48, 48, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


PROMPTS = [
    "a (cute:1.2) cat, ((masterpiece)), best_quality",
    "\\(literal\\) parens and (unclosed group, 42 cats",
    "(worst quality, low quality:1.4), (zombie, sketch:0.8), " + "longword" * 12,
    " ".join(["word"] * 90),
    "héllo wörld ²³ Ⅻ ½ 你好 🐱 it's x!'s <|endoftext|> mix3d_w0rds",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_matches_jax(prompt):
    j = jtok.SD1Tokenizer().tokenize_with_weights(prompt, return_word_ids=True)
    t = ttok.SD1Tokenizer().tokenize_with_weights(prompt, return_word_ids=True)
    assert t == j


def test_tokenizer_skips_missing_embeddings(tmp_path):
    """A missing embedding is skipped, as in the JAX package; once its file
    exists its vectors take the word's place (tests/test_torch_lora_ti.py
    holds textual inversion to the JAX package in full)."""
    prompt = "a cat, (embedding:EasyNegative), dog"
    j = jtok.SD1Tokenizer(embedding_directory=str(tmp_path)).tokenize_with_weights(prompt)
    t = ttok.SD1Tokenizer(embedding_directory=str(tmp_path)).tokenize_with_weights(prompt)
    assert t == j
    vecs = np.random.default_rng(0).standard_normal((2, 768)).astype(np.float32)
    torch.save({"string_to_param": {"*": torch.from_numpy(vecs)}},
               str(tmp_path / "EasyNegative.pt"))
    rows = ttok.SD1Tokenizer(embedding_directory=str(tmp_path)).tokenize_with_weights(prompt)
    jrows = jtok.SD1Tokenizer(embedding_directory=str(tmp_path)).tokenize_with_weights(prompt)
    got = [(t, w) for t, w in rows["l"][0] if not isinstance(t, int)]
    want = [(t, w) for t, w in jrows["l"][0] if not isinstance(t, int)]
    assert len(got) == len(want) == 2 and [w for _, w in got] == [w for _, w in want]
    np.testing.assert_array_equal(np.stack([t for t, _ in got]), vecs)
    assert [t for t, _ in rows["l"][0] if isinstance(t, int)] == [
        t for t, _ in jrows["l"][0] if isinstance(t, int)]


@pytest.mark.parametrize("layer", [None, -2])
def test_clip_encode_matches_jax(layer):
    """Weighted prompt (lerp against the empty prompt), two rows, clip-skip."""
    params = jte.init_params(num_layers=3, width=64, heads=4, seed=6)
    prompt = "a (cute:1.3) cat " + "on a mat " * 30
    jclip = jfacade.sd1_clip_from_state_dict(params)
    tclip = tfacade.sd1_clip_from_params(from_jax(params), device="cpu")
    if layer is not None:
        jclip = jfacade.CLIPSetLastLayer().set_last_layer(jclip, layer)
        tclip = tfacade.CLIPSetLastLayer().set_last_layer(tclip, layer)
    jc = jfacade.CLIPTextEncode().encode(jclip, prompt)
    tc = tfacade.CLIPTextEncode().encode(tclip, prompt)
    assert tc.cross_attn.shape == (1, 154, 64)
    np.testing.assert_allclose(tc.cross_attn.numpy(), np.asarray(jc.cross_attn),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc.pooled.numpy(), np.asarray(jc.pooled),
                               atol=1e-4, rtol=1e-4)


def test_clip_init_params_draw_for_draw():
    j = jte.init_params(num_layers=2, width=32, heads=2, seed=7, with_projection=True)
    t = tte.init_params(num_layers=2, width=32, heads=2, seed=7, with_projection=True)
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_from_jax_layouts():
    params = {"a.weight": np.zeros((3, 3, 4, 8), np.float32),
              "b.weight": np.ones((8, 4), np.float32), "c.bias": np.ones(8, np.float32)}
    out = from_jax(params)
    assert out["a.weight"].shape == (8, 4, 3, 3)
    assert out["b.weight"].shape == (8, 4) and out["c.bias"].shape == (8,)
    hwio = np.random.default_rng(8).standard_normal((3, 3, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(from_jax({"w": hwio})["w"].numpy()[4, 1, 2, 0],
                                  hwio[2, 0, 1, 4])


def test_sd15_model_bundle_on_cpu():
    jcfg, tcfg, params = _unet_pair()
    m = tbase.sd15_model(tunet.init_params(tcfg), cfg=tcfg, device="cpu")
    jm = jbase.sd15_model(params, cfg=jcfg)
    assert m.latent_format.scale_factor == jm.latent_format.scale_factor == 0.18215
    assert m.params["out.2.weight"].dtype == torch.float32
    key = "input_blocks.1.1.transformer_blocks.0."
    assert m.params[key + "attn1.to_qkv.weight"].shape == (96, 32)
    assert m.params[key + "attn2.to_kv.weight"].shape == (64, 64)
    assert not any(k.endswith(("attn1.to_q.weight", "to_k.weight", "to_v.weight"))
                   for k in m.params)
    assert m.with_options(a=1).model_options == {"a": 1} and m.model_options == {}
