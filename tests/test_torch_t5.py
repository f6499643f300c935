"""The port's T5 side of the Flux path against the JAX package and the
``tokenizers`` package: the encoder on Q8_0 weights read from a GGUF file
written by the JAX package, the relative position buckets, and the T5
tokenizer (the port's own implementation of the vendored tokenizer.json)
on prompts with ASCII, accents (composed and combining), full-width forms,
emoji, special tokens and runs of spaces.

Tolerances: the encoder agrees with the JAX package to a relative RMS error
of 1e-4 (f32 on both sides, another summation order); buckets and token
ids are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tokenizers import Tokenizer

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models.clip import t5 as jt5
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
from lightdiffusion_next_tpu_torch.models.clip import t5_tokenizer as ttok
from lightdiffusion_next_tpu_torch.ops import ggml as tggml

TINY = dict(d_model=256, d_ff=512, num_heads=4, num_layers=2, vocab_size=32128)

PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "A castle on a hill, (detailed:1.2), 8k, sharp focus",
    "Café crème brûlée à la française, naïve façade",
    "Café crème with combining accents, ñ",
    "Ｆｕｌｌ－ｗｉｄｔｈ ｌｅｔｔｅｒｓ １２３ ！？",
    "emoji 😀🎉👍🏽 and 👨‍👩‍👧‍👦 family 🇯🇵 flag",
    "multiple    spaces   here  and\ttabs\nnewlines",
    "  leading and trailing spaces   ",
    "",
    "  ",
    "<extra_id_0> special </s> tokens <pad> inside<unk>",
    "hello</s>world",
    "ALL CAPS TEXT WITH NUMBERS 1234567890",
    "日本語のテキストと中文文本",
    "Ελληνικά και русский текст",
    "ﬁ ligature ™ ½ ① ㎏ ｶﾞｷﾞ halfwidth kana",
    "a\r\nb c d​e",
    "unknown chars: ☃☃ \U0001F9FF\U0001F9FF ⨁⨁",
    "1️⃣ keycap, ♥️ heart, ✈ plane",
    "x" * 300,
    "The quick brown fox jumps over the lazy dog. " * 3,
]


@pytest.fixture(scope="module")
def tokenizers_ref():
    return Tokenizer.from_file(jconfig.repo_asset("tokenizer", "t5", "tokenizer.json"))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_matches_tokenizers_package(tokenizers_ref, prompt):
    assert ttok.default_tokenizer().encode(prompt) == tokenizers_ref.encode(prompt).ids


@pytest.mark.parametrize("prompt", ["a castle", "x " * 300, ""])
def test_flux_t5_tokenize_matches_jax(prompt):
    rows = ttok.flux_t5_tokenize(prompt)
    assert rows == jpipe.flux_t5_tokenize(prompt)
    assert len(rows) >= 256 and rows[-1][0] in (0, 1)


def test_graphemes_join_marks_and_sequences():
    assert ttok.graphemes("éa") == ["é", "a"]
    assert ttok.graphemes("\r\nb") == ["\r\n", "b"]
    assert ttok.graphemes("🇯🇵🇫") == ["🇯🇵", "🇫"]
    assert ttok.graphemes("👨‍👩") == ["👨‍👩"]


def test_relative_position_buckets_match_jax():
    rel = np.arange(-300, 301).reshape(1, -1)
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel, True, 32, 128),
                                  jt5.relative_position_bucket(rel, True, 32, 128))
    cfg_t, cfg_j = tt5.T5Config(), jt5.T5Config()
    np.testing.assert_array_equal(tt5.compute_bias_table(256, 256, cfg_t),
                                  jt5.compute_bias_table(256, 256, cfg_j))


def _t5_gguf(tmp_path):
    """A tiny T5 written by the JAX package in llama.cpp naming, Q8_0 on the
    matmuls and the token embedding (as the published encoder GGUF)."""
    params = jt5.init_params(jt5.T5Config(**TINY), seed=3)
    names = {"shared": "token_embd", "encoder.": "enc.", ".block.": ".blk.",
             "layer.0.SelfAttention.relative_attention_bias": "attn_rel_b",
             "layer.0.SelfAttention.q": "attn_q", "layer.0.SelfAttention.k": "attn_k",
             "layer.0.SelfAttention.v": "attn_v", "layer.0.SelfAttention.o": "attn_o",
             "layer.0.layer_norm": "attn_norm",
             "layer.1.DenseReluDense.wi_0": "ffn_gate",
             "layer.1.DenseReluDense.wi_1": "ffn_up",
             "layer.1.DenseReluDense.wo": "ffn_down",
             "layer.1.layer_norm": "ffn_norm", "final_layer_norm": "output_norm"}
    named = {}
    for k, v in params.items():
        for a, b in names.items():
            k = k.replace(a, b)
        named[k] = np.asarray(v)
    path = str(tmp_path / "t5.gguf")
    jggml.write_gguf(path, named, arch="t5", quantize=(
        "attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_o.weight",
        "ffn_up.weight", "ffn_down.weight", "ffn_gate.weight", "token_embd.weight"))
    return path


def test_t5_encode_matches_jax(tmp_path):
    path = _t5_gguf(tmp_path)
    jsd = jggml.to_device_quantized(jggml.gguf_clip_loader(path), dtype=jnp.float32)
    jmodel = jt5.T5XXLModel(jsd, cfg=jt5.detect_config(jsd), compute_dtype=jnp.float32)
    tmodel = tt5.T5XXLModel(tggml.gguf_clip_loader(path), device="cpu")
    assert tmodel.cfg == tt5.T5Config(**{**TINY, "relative_num_buckets": 32})
    assert isinstance(tmodel.params["shared.weight"], tggml.QTensor8)
    assert isinstance(tmodel.params["encoder.block.1.layer.1.DenseReluDense.wo.weight"],
                      tggml.QTensor8T)
    rows = [ttok.flux_t5_tokenize("a castle on a hill, fine details")]
    ref, _ = jmodel.encode_token_weights(rows)
    out, pooled = tmodel.encode_token_weights(rows)
    assert pooled is None and out.shape == (1, 256, 256)
    rel = np.sqrt(np.mean((out.numpy() - ref) ** 2) / np.mean(ref**2))
    assert rel <= 1e-4


def test_t5_random_params_layout():
    """The seeded builder draws what init_params lays out, with the Q8_0
    set quantized (matmuls in the matmul layout, the embedding by rows)."""
    cfg = tt5.T5Config(**{**TINY, "vocab_size": 300})
    p = tt5.random_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ref = tt5.init_params(cfg, seed=0)
    assert sorted(p) == sorted(ref)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape, k
    assert isinstance(p["shared.weight"], tggml.QTensor8)
    assert isinstance(p["encoder.block.0.layer.0.SelfAttention.q.weight"], tggml.QTensor8T)
    assert p["encoder.block.0.layer.0.layer_norm.weight"].dtype == torch.float32
    w = p["encoder.block.0.layer.1.DenseReluDense.wo.weight"].dequantize(torch.float32)
    assert abs(float(w.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
