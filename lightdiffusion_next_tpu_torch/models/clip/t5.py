"""T5 encoder (T5-XXL for Flux) as plain functions over a flat param dict.

Counterpart of lightdiffusion_next_tpu/models/clip/t5.py, unrolled or in
the scan layout (``stack_t5_block_params``: every block family stacked
along a depth axis, K6 reading each Q8_0 block in place): the
same HF keys ("encoder.block.{i}.layer.0.SelfAttention.q.weight", ...),
unscaled attention logits plus the relative position bias of block 0,
pre-RMSNorm residual blocks and the gated tanh-GELU feed-forward. The
attention over 256 tokens is plain PyTorch (f32 logits and softmax), as
the JAX package computes it outside any kernel; the Q8_0 matmul weights go
through K5 (``ops.nn.linear``) and the Q8_0 embedding table through
``ops.nn.embedding_lookup``. An attention mask adds -1e9 to the padded
tokens' logits, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.ops import ggml, nn
from lightdiffusion_next_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class T5Config:
    d_model: int = 4096
    d_ff: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    vocab_size: int = 32128
    relative_num_buckets: int = 32
    relative_max_distance: int = 128


T5_XXL = T5Config()

# the Q8_0 weights of the published T5-XXL encoder GGUF: the seven matmuls
# of every block and the token embedding (kept in row layout)
Q8_0_SUFFIXES = ("SelfAttention.q.weight", "SelfAttention.k.weight",
                 "SelfAttention.v.weight", "SelfAttention.o.weight",
                 "wi_0.weight", "wi_1.weight", "wo.weight", "shared.weight")

_BIAS_KEY = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def relative_position_bucket(relative_position: np.ndarray, bidirectional: bool = True,
                             num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """Mesh-TF bucket mapping, host numpy."""
    relative_buckets = np.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        relative_buckets += (relative_position > 0).astype(np.int64) * num_buckets
        relative_position = np.abs(relative_position)
    else:
        relative_position = -np.minimum(relative_position, 0)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    with np.errstate(divide="ignore"):
        rp_large = max_exact + (
            np.log(np.maximum(relative_position, 1) / max_exact)
            / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)
        ).astype(np.int64)
    rp_large = np.minimum(rp_large, num_buckets - 1)
    relative_buckets += np.where(is_small, relative_position, rp_large)
    return relative_buckets


def compute_bias_table(q_len: int, k_len: int, cfg: T5Config) -> np.ndarray:
    ctx = np.arange(q_len, dtype=np.int64)[:, None]
    mem = np.arange(k_len, dtype=np.int64)[None, :]
    return relative_position_bucket(
        mem - ctx, bidirectional=True, num_buckets=cfg.relative_num_buckets,
        max_distance=cfg.relative_max_distance,
    )


def _t5_attention(p: nn.ParamView, x, bias, heads: int):
    q = nn.linear(x, p("q.weight"))
    k = nn.linear(x, p("k.weight"))
    v = nn.linear(x, p("v.weight"))
    b, l, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, l, heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    # unscaled logits plus the additive bias (T5 semantics)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, inner)
    return nn.linear(out, p("o.weight"))


def _t5_block(p: nn.ParamView, x, bias, cfg: T5Config):
    h = nn.rms_norm(x, p("layer.0.layer_norm.weight"))
    x = x + _t5_attention(p.scope("layer.0.SelfAttention."), h, bias, cfg.num_heads)
    h = nn.rms_norm(x, p("layer.1.layer_norm.weight"))
    hg = nn.gelu(nn.linear(h, p("layer.1.DenseReluDense.wi_0.weight")), approximate=True)
    hl = nn.linear(h, p("layer.1.DenseReluDense.wi_1.weight"))
    return x + nn.linear(hg * hl, p("layer.1.DenseReluDense.wo.weight"))


T5_STACK_KEY = "__t5_block_stack__"
_BIAS_REL = "layer.0.SelfAttention.relative_attention_bias.weight"


def is_stacked(params: Dict) -> bool:
    return T5_STACK_KEY in params


def stack_t5_block_params(params: Dict, cfg: T5Config) -> Dict:
    """The scan layout of the encoder: every ``encoder.block.{i}.{rel}``
    family stacked along a leading depth axis under ``T5_STACK_KEY``
    (``ggml.stack_leaves``); block 0's relative-attention bias table stays
    at its flat key (it is read once, before the blocks). Validates every
    family first (ValueError, ``params`` untouched, for a ragged or
    non-uniform family), then CONSUMES ``params`` one family at a time, as
    ``models.flux.stack_block_params`` does."""
    out: Dict = {}
    fams: Dict[str, Dict[int, object]] = {}
    pre = "encoder.block."
    for k, v in params.items():
        if k.startswith(pre):
            idx_s, _, rel = k[len(pre):].partition(".")
            if idx_s.isdigit() and rel and rel != _BIAS_REL:
                fams.setdefault(rel, {})[int(idx_s)] = v
                continue
        out[k] = v
    blocks = list(range(cfg.num_layers))
    for rel in fams:
        if sorted(fams[rel]) != blocks:
            raise ValueError(f"encoder.block.*.{rel}: blocks {sorted(fams[rel])} != "
                             f"0..{cfg.num_layers - 1}")
    # moved out of ``fams``, so each family's leaves go with its stack
    families = {rel: [fams[rel].pop(i) for i in blocks] for rel in fams}
    out[T5_STACK_KEY] = ggml.stack_families(params, families)
    return out


def apply_t5(params: Dict, tokens, attention_mask=None,
             intermediate_output: Optional[int] = None,
             final_layer_norm_intermediate: bool = True, cfg: T5Config = T5_XXL,
             compute_dtype=torch.float32):
    """tokens (B, L) int -> (x, intermediate, None), activations in
    ``compute_dtype`` (norms and the softmax in f32). ``attention_mask``:
    (B, L), 1 = attend; the other keys get a -1e9 bias."""
    x = nn.embedding_lookup(tokens, params["shared.weight"], dtype=compute_dtype)
    L = x.shape[1]
    with profiling.span("sync.t5_buckets"):
        buckets = torch.as_tensor(compute_bias_table(L, L, cfg), device=x.device)
    bias_emb = params[_BIAS_KEY]
    bias = nn.embedding_lookup(buckets.reshape(-1), bias_emb, dtype=torch.float32)
    bias = bias.reshape(L, L, -1).permute(2, 0, 1)[None]  # (1, H, L, L) f32
    if attention_mask is not None:
        am = torch.as_tensor(attention_mask, dtype=torch.float32, device=x.device)
        bias = bias + (1.0 - am)[:, None, None, :] * -1e9
    if intermediate_output is not None and intermediate_output < 0:
        intermediate_output = cfg.num_layers + intermediate_output
    intermediate = None
    stack = params.get(T5_STACK_KEY)
    for i in range(cfg.num_layers):
        p = (nn.StackView(stack, i) if stack is not None
             else nn.ParamView(params, f"encoder.block.{i}."))
        x = _t5_block(p, x, bias, cfg)
        if intermediate_output is not None and i == intermediate_output:
            intermediate = x
    x = nn.rms_norm(x, params["encoder.final_layer_norm.weight"])
    if intermediate is not None and final_layer_norm_intermediate:
        intermediate = nn.rms_norm(intermediate, params["encoder.final_layer_norm.weight"])
    return x, intermediate, None


def detect_config(params: Dict) -> T5Config:
    """T5Config from state-dict shapes (leaves may be quantized records)."""
    def shape(k):
        return tuple(params[k].shape)

    vocab, d_model = shape("shared.weight")
    buckets, heads = shape(_BIAS_KEY)
    if is_stacked(params):  # a stacked record's shape is one block's
        stack = params[T5_STACK_KEY]
        n_layers = stack["layer.0.layer_norm.weight"].shape[0]
        wi = stack["layer.1.DenseReluDense.wi_0.weight"]
        d_ff = wi.shape[1] if isinstance(wi, torch.Tensor) else wi.shape[0]
    else:
        n_layers = 0
        while f"encoder.block.{n_layers}.layer.0.layer_norm.weight" in params:
            n_layers += 1
        d_ff = shape("encoder.block.0.layer.1.DenseReluDense.wi_0.weight")[0]
    return T5Config(d_model=d_model, d_ff=d_ff, num_heads=heads,
                    num_layers=n_layers or T5_XXL.num_layers, vocab_size=vocab,
                    relative_num_buckets=buckets)


class T5XXLModel:
    """Encoder facade: params placed on the device (Q8_0 matmul weights as
    ``QTensor8T``, the embedding as a row-layout ``QTensor8``, dense leaves in
    ``dtype``), activations in ``compute_dtype``. ``scan_blocks`` (default:
    ``RuntimeConfig.resolve_flux_scan`` for the device, so on for the GPU)
    stacks the blocks after placement (``stack_t5_block_params``)."""

    def __init__(self, params: Dict, cfg: Optional[T5Config] = None,
                 dtype: Optional[torch.dtype] = None, compute_dtype=None,
                 device: _config.DeviceLike = None, scan_blocks: Optional[bool] = None):
        self.device = _config.resolve_device(device)
        policy = _config.DtypePolicy.for_device(self.device)
        self.dtype = dtype or policy.text_encoder_dtype
        self.params = ggml.to_device_quantized(params, dtype=self.dtype, device=self.device)
        self.cfg = cfg or detect_config(self.params)
        if scan_blocks is None:
            scan_blocks = _config.get_config().resolve_flux_scan(self.device)
        if scan_blocks and not is_stacked(self.params):
            self.params = stack_t5_block_params(self.params, self.cfg)
        self.compute_dtype = compute_dtype or self.dtype
        self.special_tokens = {"end": 1, "pad": 0}

    def encode_token_weights(self, token_weight_pairs):
        """Rows of (token, weight) -> ((B, L, d_model) f32, None); the
        weights are not applied (the Flux flow encodes T5 plainly)."""
        with profiling.span("models.t5"):
            rows = [[int(a[0]) for a in row] for row in token_weight_pairs]
            with profiling.span("sync.t5_tokens"):
                tokens = torch.tensor(rows, dtype=torch.long, device=self.device)
            out, _, _ = apply_t5(self.params, tokens, cfg=self.cfg,
                                 compute_dtype=self.compute_dtype)
            return out.float(), None


def _layout(cfg: T5Config):
    """(key, shape, std) of every param in ``init_params``' draw order;
    std None means ones."""
    out = [("shared.weight", (cfg.vocab_size, cfg.d_model), 1.0),
           (_BIAS_KEY, (cfg.relative_num_buckets, cfg.num_heads), 0.1)]
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}."
        for nme in "qkvo":
            out.append((pre + f"layer.0.SelfAttention.{nme}.weight",
                        (cfg.d_model, cfg.d_model), cfg.d_model ** -0.5))
        out.append((pre + "layer.0.layer_norm.weight", (cfg.d_model,), None))
        for nme in ("wi_0", "wi_1"):
            out.append((pre + f"layer.1.DenseReluDense.{nme}.weight",
                        (cfg.d_ff, cfg.d_model), cfg.d_model ** -0.5))
        out.append((pre + "layer.1.DenseReluDense.wo.weight",
                    (cfg.d_model, cfg.d_ff), cfg.d_ff ** -0.5))
        out.append((pre + "layer.1.layer_norm.weight", (cfg.d_model,), None))
    out.append(("encoder.final_layer_norm.weight", (cfg.d_model,), None))
    return out


def init_params(cfg: T5Config = T5_XXL, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random params drawn exactly as the JAX package's ``init_params``
    draws them (numpy, f32). For the tests' small widths."""
    rng = np.random.default_rng(seed)
    P = {}
    for key, shape, std in _layout(cfg):
        if std is None:
            P[key] = np.ones(shape, np.float32)
        else:
            P[key] = rng.normal(0, std, shape).astype(np.float32)
    return P


def random_leaves(cfg: T5Config = T5_XXL, seed: int = 0, device="cuda",
                  dtype=torch.bfloat16):
    """``random_params``' leaves one at a time, as (key, leaf) in
    ``_layout``'s order, the Q8_0 weights as row-layout ``QTensor8`` records
    (what a GGUF file holds)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for key, shape, std in _layout(cfg):
        if std is None:
            yield key, torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=gen, device=device) * std
        yield key, ggml.quantize(w) if key.endswith(Q8_0_SUFFIXES) else w.to(dtype)
        del w


def random_params(cfg: T5Config = T5_XXL, seed: int = 0, device="cuda",
                  dtype=torch.bfloat16) -> Dict:
    """Seeded params at any width, drawn on ``device`` by a
    ``torch.Generator`` with ``init_params``' distributions: the weights
    named by ``Q8_0_SUFFIXES`` become Q8_0 there (the matmuls ``QTensor8T``,
    the embedding a row-layout ``QTensor8``), the rest ``dtype``. At
    T5-XXL's width about 5.1 GB of Q8_0."""
    return {key: ggml.transpose_for_matmul(leaf)
            if isinstance(leaf, ggml.QTensor8) and key not in ggml.EMBED_KEYS else leaf
            for key, leaf in random_leaves(cfg, seed, device, dtype)}
