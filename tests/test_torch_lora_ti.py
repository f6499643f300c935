"""The port's LoRA merge and textual inversion against the JAX package's.

LoRA: a Kohya file (``lora_unet_*`` / ``lora_te_*`` with ``lora_up``,
``lora_down`` and ``alpha``) over every attention and feed-forward linear
of a tiny UNet and CLIP, and a 1x1 conv, merged at 0.7 / 0.5. The port
merges into its joined q|k|v and k|v weights (``unet_key_map`` maps the
parts to their rows); that must equal merging into the checkpoint-keyed
weights and joining afterwards, bit for bit, drop no module, and equal the
JAX package's ``load_and_apply_lora``: the delta's matmul is f32 on both
sides, summed by numpy's BLAS there and by torch here, so the merged f32
weights agree to 2 ulps of the delta's scale (atol 1e-7 at these
magnitudes) and the bf16 ones to one bf16 ulp.

Textual inversion: ``load_embed`` (subdirectories, the name with and
without its extension, a path that escapes its directory, A1111 ``.pt``
with ``string_to_param``, ``.safetensors``), the tokenizer's rows with the
trailing-comma retry, and the CLIP encoder's output with embedding rows
(to 1e-5, f32), all against the JAX package's.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from lightdiffusion_next_tpu.models import lora as jlora
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models.clip import facade as jfacade
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.models.clip import tokenizer as jtok
from lightdiffusion_next_tpu_torch.models import lora as tlora
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models.clip import facade as tfacade
from lightdiffusion_next_tpu_torch.models.clip import tokenizer as ttok
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
            num_heads=2)
UNET_LINEAR = re.compile(r"transformer_blocks\.\d+\.(attn[12]\.(to_[qkv]|to_out\.0)|"
                         r"ff\.net\.(0\.proj|2))\.weight$")
CLIP_LINEAR = re.compile(r"layers\.\d+\.(self_attn\.(q|k|v|out)_proj|mlp\.fc[12])\.weight$")


def kohya_lora(unet_params, clip_params, rank=4, seed=0, conv_key=None):
    """A seeded Kohya LoRA (f16, as published files are) over every
    attention and feed-forward linear, plus ``conv_key`` (a 1x1 conv)."""
    rng = np.random.default_rng(seed)
    out = {}

    def module(name, shape):
        o, rest = shape[0], tuple(shape[1:])
        down = rng.standard_normal((rank,) + rest) * 0.1
        up = rng.standard_normal((o, rank) + (1,) * (len(rest) - 1)) * 0.1
        out[f"{name}.lora_down.weight"] = down.astype(np.float16)
        out[f"{name}.lora_up.weight"] = up.astype(np.float16)
        out[f"{name}.alpha"] = np.array(rank / 2, np.float16)

    for k, v in unet_params.items():
        if UNET_LINEAR.search(k) or k == conv_key:
            module("lora_unet_" + k[: -len(".weight")].replace(".", "_"), np.shape(v))
    for k, v in clip_params.items():
        if CLIP_LINEAR.search(k):
            module("lora_te_" + k[: -len(".weight")].replace(".", "_"), np.shape(v))
    return out


@pytest.fixture(scope="module")
def tiny():
    ucfg = junet.UNetConfig(**TINY)
    unet_p = junet.init_params(ucfg, seed=0)  # HWIO convs
    clip_p = jte.init_params(num_layers=2, width=64, heads=4, seed=2)
    ours_unet = from_jax(unet_p)  # checkpoint keys, OIHW
    conv_key = "input_blocks.1.1.proj_in.weight"
    lora = kohya_lora(ours_unet, clip_p, conv_key=conv_key)
    return unet_p, clip_p, ours_unet, lora


def test_lora_merge_fused_equals_unfused_and_jax(tiny, caplog):
    unet_p, clip_p, ours_unet, lora = tiny
    lora_t = {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()}
    clip_t = from_jax(clip_p)
    with caplog.at_level(logging.INFO, logger="lightdiffusion_next_tpu_torch"):
        fused, clip_new = tlora.load_and_apply_lora(
            lora_t, tunet.fuse_projections(ours_unet), clip_t, 0.7, 0.5)
    unfused, _ = tlora.load_and_apply_lora(lora_t, ours_unet, None, 0.7, 0.5)
    unfused = tunet.fuse_projections(unfused)
    assert set(fused) == set(unfused)
    for k in fused:
        assert torch.equal(fused[k], unfused[k]), k

    j_unet, j_clip = jlora.load_and_apply_lora(lora, unet_p, clip_p, 0.7, 0.5)
    want = tunet.fuse_projections(from_jax(j_unet))
    n_changed = 0
    for k, v in want.items():
        np.testing.assert_allclose(fused[k].numpy(), v.numpy(), atol=1e-7, rtol=0, err_msg=k)
        n_changed += not torch.equal(fused[k], tunet.fuse_projections(ours_unet)[k])
    for k, v in from_jax(j_clip).items():
        np.testing.assert_allclose(clip_new[k].numpy(), v.numpy(), atol=1e-7, rtol=0,
                                   err_msg=k)

    # no module dropped: every LoRA module matched, and every target changed
    modules = tlora.lora_modules(lora_t)
    n_unet = sum(m.startswith("lora_unet_") for m in modules)
    n_clip = len(modules) - n_unet
    n_blocks = sum(k.endswith("attn1.to_q.weight") for k in ours_unet)
    assert n_blocks == 7 and n_unet == n_blocks * 10 + 1 and n_clip == 2 * 6
    _, left = tlora.load_lora(lora_t, {**tlora.unet_key_map(fused), **tlora.clip_key_map(clip_t)})
    assert left == []
    # per transformer block q|k|v, to_q, k|v, two to_out, two ff; + proj_in
    assert n_changed == n_blocks * 7 + 1
    assert any(f"{n_unet} UNet and {n_clip} CLIP modules patched of the file's "
               f"{len(modules)}" in r.getMessage() for r in caplog.records)
    # the params given are not changed
    assert torch.equal(clip_t["text_model.encoder.layers.0.mlp.fc1.weight"],
                       from_jax(clip_p)["text_model.encoder.layers.0.mlp.fc1.weight"])


def test_lora_merge_bf16_rounds_as_jax(tiny):
    """bf16 weights: W' = bf16(f32(W) + delta), as the JAX package rounds."""
    unet_p, _, ours_unet, lora = tiny
    keys = [k for k in unet_p if UNET_LINEAR.search(k)][:6]
    sub_j = {k: jnp.asarray(unet_p[k], dtype=jnp.bfloat16) for k in keys}
    sub_t = {k: ours_unet[k].bfloat16() for k in keys}
    lora_t = {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()}
    j_out, _ = jlora.load_and_apply_lora(lora, sub_j, None, 0.7, 0.0)
    t_out, _ = tlora.load_and_apply_lora(lora_t, sub_t, None, 0.7, 0.0)
    for k in keys:
        assert t_out[k].dtype == torch.bfloat16
        ours = t_out[k].float().numpy()
        theirs = np.asarray(j_out[k].astype(jnp.float32))
        ulp = np.spacing(np.abs(theirs).astype(np.float32)) * 2**16
        assert np.all(np.abs(ours - theirs) <= ulp), k
        assert np.mean(ours == theirs) > 0.99, k


def _write_embeddings(d, rng):
    """Four embeddings as published: A1111 .pt (string_to_param), one in a
    subdirectory, and one .safetensors."""
    vecs = {n: rng.standard_normal((k, 64)).astype(np.float32) * 0.02
            for n, k in (("EasyNegative", 3), ("badhandv4", 2), ("lr", 1), ("ng75", 5))}
    (d / "sub").mkdir(parents=True, exist_ok=True)
    safetensors.numpy.save_file({"emb_params": vecs["EasyNegative"]},
                                str(d / "EasyNegative.safetensors"))
    for name, path in (("badhandv4", d / "badhandv4.pt"), ("lr", d / "sub" / "lr.pt"),
                       ("ng75", d / "ng75.pt")):
        torch.save({"string_to_token": {"*": 265},
                    "string_to_param": {"*": torch.from_numpy(vecs[name])},
                    "name": name, "step": 100}, str(path))
    return vecs


def test_load_embed_matches_jax(tmp_path):
    vecs = _write_embeddings(tmp_path / "emb", np.random.default_rng(0))
    d = str(tmp_path / "emb")
    (tmp_path / "outside.pt").write_bytes(b"")
    for name in ("EasyNegative", "badhandv4", "lr", "ng75", "badhandv4.pt",
                 "EasyNegative.safetensors", "missing", "../outside"):
        ours, theirs = ttok.load_embed(name, d, 64), jtok.load_embed(name, d, 64)
        if theirs is None:
            assert ours is None, name
            continue
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
        np.testing.assert_array_equal(ours, vecs[name.split(".")[0]])
    assert ttok.load_embed("lr", d, 768) is None  # another width


PROMPTS = ["a cat, embedding:badhandv4, (embedding:lr:1.2) dog",
           "(embedding:EasyNegative), embedding:ng75,, embedding:nothing, " + "x " * 60,
           "embedding:badhandv4,, cat embedding:badhandv4,cat"]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_rows_with_embeddings_match_jax(tmp_path, prompt):
    _write_embeddings(tmp_path / "emb", np.random.default_rng(0))
    d = str(tmp_path / "emb")
    j = jtok.SD1Tokenizer(embedding_directory=d, embedding_size=64).tokenize_with_weights(
        prompt, return_word_ids=True)["l"]
    t = ttok.SD1Tokenizer(embedding_directory=d, embedding_size=64).tokenize_with_weights(
        prompt, return_word_ids=True)["l"]
    assert len(t) == len(j)
    n_vec = 0
    for rt, rj in zip(t, j):
        assert len(rt) == len(rj) == 77
        for (a, wa, ia), (b, wb, ib) in zip(rt, rj):
            assert (wa, ia) == (wb, ib)
            if isinstance(b, (int, np.integer)):
                assert a == b
            else:
                n_vec += 1
                np.testing.assert_array_equal(a, b)
    assert n_vec > 0


@pytest.mark.parametrize("layer", [None, -2])
def test_clip_encode_with_embeddings_matches_jax(tmp_path, layer):
    _write_embeddings(tmp_path / "emb", np.random.default_rng(0))
    d = str(tmp_path / "emb")
    params = jte.init_params(num_layers=3, width=64, heads=4, seed=6)
    jclip = jfacade.sd1_clip_from_state_dict(params, embedding_directory=d)
    tclip = tfacade.sd1_clip_from_params(from_jax(params), embedding_directory=d,
                                         device="cpu")
    for clip in (jclip, tclip):
        clip.clip_layer(layer)
    prompt = PROMPTS[0] + ", " + PROMPTS[1]
    jz, jp = jclip.encode_from_tokens(jclip.tokenize(prompt), return_pooled=True)
    tz, tp = tclip.encode_from_tokens(tclip.tokenize(prompt), return_pooled=True)
    assert tz.shape == (1, 154, 64)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-5)


def test_embed_rows_match_jax():
    """Token rows gathered on the device, vectors in their slots (id -1),
    a vector of another width leaves its slot zero."""
    params = jte.init_params(num_layers=1, width=64, heads=4, seed=7)
    jm = jte.SDClipModel(params, num_layers=1, heads=4)
    tm = tfacade.sd1_clip_from_params(from_jax(params), device="cpu").model.model
    rng = np.random.default_rng(1)
    row = [49406] + [rng.standard_normal(64).astype(np.float32), 320,
                     np.ones(32, np.float32)] + [49407] * 73
    row2 = [49406, 1000] + [49407] * 75
    je, jt = jm._embed_rows([row, row2])
    te_, tt = tm._embed_rows([row, row2])
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(te_.numpy(), je)
    assert not te_[0, 3].any()
