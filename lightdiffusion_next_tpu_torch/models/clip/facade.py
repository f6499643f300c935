"""CLIP facade: tokenizer + encoder with clip-skip.

Counterpart of lightdiffusion_next_tpu/models/clip/facade.py (``CLIP``,
``CLIPTextEncode``, ``CLIPSetLastLayer``) plus ``sd1_clip_from_params``,
the assembly the JAX loader does from a checkpoint's text-encoder dict.
"""

from __future__ import annotations

from typing import Dict, Optional

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te
from lightdiffusion_next_tpu_torch.models.clip import tokenizer as tok
from lightdiffusion_next_tpu_torch.sampling.cfg import CondInput


class CLIP:
    """Tokenizer + text model pair."""

    def __init__(self, tokenizer, model, layer_idx: Optional[int] = None):
        self.tokenizer = tokenizer
        self.model = model  # SD1ClipModel-like (encode_token_weights)
        self.layer_idx = layer_idx

    def clone(self) -> "CLIP":
        return CLIP(self.tokenizer, self.model, self.layer_idx)

    def clip_layer(self, layer_idx: Optional[int]):
        """-2 = clip-skip 2."""
        self.layer_idx = layer_idx

    def tokenize(self, text: str, return_word_ids: bool = False):
        return self.tokenizer.tokenize_with_weights(text, return_word_ids)

    def encode_from_tokens(self, tokens, return_pooled: bool = False):
        inner = getattr(self.model, "model", self.model)
        if self.layer_idx is not None:
            inner.set_clip_options({"layer": self.layer_idx})
        else:
            inner.reset_clip_options()
        out, pooled = self.model.encode_token_weights(tokens)
        return (out, pooled) if return_pooled else out

    def encode(self, text: str):
        return self.encode_from_tokens(self.tokenize(text))


class CLIPTextEncode:
    """text -> CondInput."""

    def encode(self, clip: CLIP, text: str) -> CondInput:
        cond, pooled = clip.encode_from_tokens(clip.tokenize(text), return_pooled=True)
        return CondInput(cross_attn=cond, pooled=pooled)


class CLIPSetLastLayer:
    """Clip-skip node."""

    def set_last_layer(self, clip: CLIP, stop_at_clip_layer: int) -> CLIP:
        c = clip.clone()
        c.clip_layer(stop_at_clip_layer)
        return c


def sd1_clip_from_params(clip_params: Dict, embedding_directory: Optional[str] = None,
                         dtype=None, device: _config.DeviceLike = None) -> CLIP:
    """The SD1.5 CLIP stack from a text-encoder param dict (keys
    "text_model.*"); layer count and width come from the shapes. The
    tokenizer resolves ``embedding:name`` against ``embedding_directory``
    (textual inversion)."""
    num_layers = 0
    while f"text_model.encoder.layers.{num_layers}.layer_norm1.weight" in clip_params:
        num_layers += 1
    width = clip_params["text_model.embeddings.token_embedding.weight"].shape[1]
    model = te.SDClipModel(
        clip_params, layer="last", num_layers=num_layers or te.CLIP_L_LAYERS,
        heads=max(1, width // 64), dtype=dtype, device=device,
    )
    tk = tok.SD1Tokenizer(embedding_directory=embedding_directory, embedding_size=width)
    return CLIP(tk, te.SD1ClipModel(model))
