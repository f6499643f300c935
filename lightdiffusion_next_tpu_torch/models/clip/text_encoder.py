"""CLIP-L text transformer and weighted-token encoding.

Counterpart of lightdiffusion_next_tpu/models/clip/text_encoder.py: causal
transformer with a clip-skip tap and eos pooling, prompt weights as a lerp
against the empty prompt. Param keys are the HF ones ("text_model.*").
Attention runs through ``sdpa`` (77 causal tokens: no kernel). Textual
inversion: a row entry may be an embedding vector instead of a token id
(``tokenizer.load_embed``); ``_embed_rows`` gathers the token rows from the
table on the device and puts the vectors in their slots.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.base import params_to_device
from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import nn
from lightdiffusion_next_tpu_torch.utils import profiling

CLIP_L_LAYERS = 12
CLIP_L_HEADS = 12
CLIP_L_WIDTH = 768
CLIP_L_VOCAB = 49408
SPECIAL_TOKENS = {"start": 49406, "end": 49407, "pad": 49407}


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _clip_layer(p: nn.ParamView, x, mask, heads: int):
    h = nn.layer_norm(x, p("layer_norm1.weight"), p("layer_norm1.bias"))
    q = nn.linear(h, p("self_attn.q_proj.weight"), p("self_attn.q_proj.bias"))
    k = nn.linear(h, p("self_attn.k_proj.weight"), p("self_attn.k_proj.bias"))
    v = nn.linear(h, p("self_attn.v_proj.weight"), p("self_attn.v_proj.bias"))
    a = attn_ops.attention_xla(q, k, v, heads=heads, mask=mask)
    x = x + nn.linear(a, p("self_attn.out_proj.weight"), p("self_attn.out_proj.bias"))
    h = nn.layer_norm(x, p("layer_norm2.weight"), p("layer_norm2.bias"))
    h = quick_gelu(nn.linear(h, p("mlp.fc1.weight"), p("mlp.fc1.bias")))
    return x + nn.linear(h, p("mlp.fc2.weight"), p("mlp.fc2.bias"))


def apply_clip_text(params: dict, tokens, embeds,
                    intermediate_output: Optional[int] = None,
                    final_layer_norm_intermediate: bool = True,
                    num_layers: int = CLIP_L_LAYERS, heads: int = CLIP_L_HEADS,
                    eos_token_id: int = SPECIAL_TOKENS["end"]):
    """(tokens (B, 77) int, their embeddings (B, 77, width), from
    ``SDClipModel._embed_rows``) -> (last_hidden, intermediate, pooled)."""
    p = nn.ParamView(params, "text_model.")
    x = embeds + p("embeddings.position_embedding.weight")[: embeds.shape[1]][None]

    L = x.shape[1]
    mask = torch.triu(
        torch.full((L, L), float("-inf"), dtype=torch.float32, device=x.device), diagonal=1
    )
    if intermediate_output is not None and intermediate_output < 0:
        intermediate_output = num_layers + intermediate_output

    intermediate = None
    for i in range(num_layers):
        x = _clip_layer(p.scope(f"encoder.layers.{i}."), x, mask, heads)
        if intermediate_output is not None and i == intermediate_output:
            intermediate = x
    x = nn.layer_norm(x, p("final_layer_norm.weight"), p("final_layer_norm.bias"))
    if intermediate is not None and final_layer_norm_intermediate:
        intermediate = nn.layer_norm(intermediate, p("final_layer_norm.weight"),
                                     p("final_layer_norm.bias"))
    eos_pos = torch.argmax((tokens == eos_token_id).int(), dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
    return x, intermediate, pooled


class SDClipModel:
    """CLIP-L encoder facade with clip-skip and weighted-token encoding."""

    def __init__(self, params: dict, layer: str = "last",
                 layer_idx: Optional[int] = None, num_layers: int = CLIP_L_LAYERS,
                 heads: int = CLIP_L_HEADS, special_tokens: dict = SPECIAL_TOKENS,
                 layer_norm_hidden_state: bool = True,
                 return_projected_pooled: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 device: _config.DeviceLike = None):
        self.device = _config.resolve_device(device)
        self.dtype = dtype or _config.DtypePolicy.for_device(self.device).text_encoder_dtype
        if num_layers == CLIP_L_LAYERS:  # as in the JAX package: the file's count
            n = 0
            while f"text_model.encoder.layers.{n}.self_attn.q_proj.weight" in params:
                n += 1
            num_layers = n or num_layers
        self.params = params_to_device(params, self.dtype, self.device)
        self.layer = layer
        self.layer_idx = layer_idx
        self.num_layers = num_layers
        self.heads = heads
        self.special_tokens = special_tokens
        self.layer_norm_hidden_state = layer_norm_hidden_state
        self.return_projected_pooled = return_projected_pooled
        self.options_default = (layer, layer_idx, return_projected_pooled)

    def clone(self) -> "SDClipModel":
        """A shallow copy (the same params dict) whose options and params
        can be replaced without touching this one."""
        c = SDClipModel.__new__(SDClipModel)
        c.__dict__.update(self.__dict__)
        return c

    def set_clip_options(self, options: dict):
        layer_idx = options.get("layer", self.layer_idx)
        self.return_projected_pooled = options.get(
            "projected_pooled", self.return_projected_pooled)
        if layer_idx is None or abs(layer_idx) > self.num_layers:
            self.layer = "last"
            self.layer_idx = None
        else:
            self.layer = "hidden"
            self.layer_idx = layer_idx

    def reset_clip_options(self):
        self.layer, self.layer_idx, self.return_projected_pooled = self.options_default

    def _embed_rows(self, token_rows: List[List]):
        """Rows of token ids and textual-inversion vectors -> (embeds (B, L,
        width) in the encoder's dtype, token ids (B, L)), both on the
        device. A vector's slot holds id -1, not the pad id: SD1.5 pads with
        the end token, and the end token's position is where pooling reads.
        A vector of another width leaves its slot zero, as in the JAX
        package."""
        table = self.params["text_model.embeddings.token_embedding.weight"]
        width = table.shape[1]
        ids = np.zeros((len(token_rows), len(token_rows[0])), dtype=np.int64)
        slots, vectors = [], []
        for i, row in enumerate(token_rows):
            for j, t in enumerate(row):
                if isinstance(t, (int, np.integer)):
                    ids[i, j] = int(t)
                    continue
                ids[i, j] = -1
                vec = np.asarray(t, dtype=np.float32)
                if vec.shape[0] == width:
                    slots.append((i, j))
                    vectors.append(vec)
        with profiling.span("sync.clip_tokens"):
            tokens = torch.from_numpy(ids).to(self.device)
        embeds = table[tokens.clamp(min=0)]
        embeds[tokens < 0] = 0
        if slots:
            rows, cols = zip(*slots)
            with profiling.span("sync.clip_embeddings"):
                embeds[list(rows), list(cols)] = torch.from_numpy(np.stack(vectors)).to(
                    device=self.device, dtype=embeds.dtype)
        return embeds, tokens

    def encode(self, token_rows: List[List]):
        """token_rows: 77-length rows of token ids or textual-inversion
        vectors -> (z, pooled), f32 tensors."""
        embeds, tokens = self._embed_rows(token_rows)
        x, inter, pooled = apply_clip_text(
            self.params, tokens, embeds,
            intermediate_output=self.layer_idx if self.layer == "hidden" else None,
            final_layer_norm_intermediate=self.layer_norm_hidden_state,
            num_layers=self.num_layers, heads=self.heads,
            eos_token_id=self.special_tokens["end"],
        )
        z = x if self.layer == "last" else inter
        if self.return_projected_pooled and "text_projection.weight" in self.params:
            pooled = nn.linear(pooled, self.params["text_projection.weight"])
        return z.float(), pooled.float()

    def encode_token_weights(self, token_weight_pairs):
        """Encode all rows plus an empty row, lerp weighted tokens against
        the empty-prompt baseline, concatenate rows on the sequence axis.
        Returns (cond (1, 77*rows, width), pooled (1, width)), f32."""
        with profiling.span("models.clip"):
            to_encode = []
            max_len = 0
            has_weights = False
            for row in token_weight_pairs:
                tokens = [a[0] for a in row]
                max_len = max(max_len, len(tokens))
                has_weights = has_weights or any(a[1] != 1.0 for a in row)
                to_encode.append(tokens)

            sections = len(to_encode)
            if has_weights or sections == 0:
                to_encode.append(_gen_empty_tokens(self.special_tokens, max_len))

            out, pooled = self.encode(to_encode)
            first_pooled = pooled[0:1]

            output = []
            for k in range(sections):
                z = out[k : k + 1].clone()
                if has_weights:
                    z_empty = out[-1]
                    for j in range(z.shape[1]):
                        weight = token_weight_pairs[k][j][1]
                        if weight != 1.0:
                            z[0, j] = (z[0, j] - z_empty[j]) * weight + z_empty[j]
                output.append(z)

            if not output:
                return out[-1:], first_pooled
            return torch.cat(output, dim=-2), first_pooled


def _gen_empty_tokens(special_tokens: dict, length: int) -> List[int]:
    start = special_tokens.get("start")
    end = special_tokens.get("end")
    pad = special_tokens.get("pad")
    out = []
    if start is not None:
        out.append(start)
    if end is not None:
        out.append(end)
    out.extend([pad] * (length - len(out)))
    return out


class SD1ClipModel:
    """{"l": rows} keyed wrapper."""

    def __init__(self, clip_model: SDClipModel, clip_name: str = "l"):
        self.clip_name = clip_name
        self.model = clip_model

    def set_clip_options(self, options):
        self.model.set_clip_options(options)

    def reset_clip_options(self):
        self.model.reset_clip_options()

    def encode_token_weights(self, token_weight_pairs: dict):
        return self.model.encode_token_weights(token_weight_pairs[self.clip_name])


def init_params(num_layers: int = 2, width: int = 64, heads: int = 4,
                vocab: int = 49408, mlp_ratio: int = 4, seed: int = 0,
                with_projection: bool = False, max_positions: int = 77):
    """Random params drawn exactly as the JAX package's ``init_params``
    draws them. Host numpy f32. (``heads`` is accepted for signature parity;
    it does not change the shapes.)"""
    rng = np.random.default_rng(seed)
    P = {}

    def lin(key, out_d, in_d):
        P[key + ".weight"] = rng.normal(0, in_d**-0.5, (out_d, in_d)).astype(np.float32)
        P[key + ".bias"] = np.zeros((out_d,), dtype=np.float32)

    def norm(key, c):
        P[key + ".weight"] = np.ones((c,), dtype=np.float32)
        P[key + ".bias"] = np.zeros((c,), dtype=np.float32)

    P["text_model.embeddings.token_embedding.weight"] = rng.normal(
        0, 0.02, (vocab, width)).astype(np.float32)
    P["text_model.embeddings.position_embedding.weight"] = rng.normal(
        0, 0.01, (max_positions, width)).astype(np.float32)
    for i in range(num_layers):
        pre = f"text_model.encoder.layers.{i}."
        norm(pre + "layer_norm1", width)
        norm(pre + "layer_norm2", width)
        for nme in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(pre + f"self_attn.{nme}", width, width)
        lin(pre + "mlp.fc1", width * mlp_ratio, width)
        lin(pre + "mlp.fc2", width, width * mlp_ratio)
    norm("text_model.final_layer_norm", width)
    if with_projection:
        P["text_projection.weight"] = rng.normal(
            0, width**-0.5, (width, width)).astype(np.float32)
    return P
