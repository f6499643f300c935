"""The tensor-parallel (TP) layout of Flux's params.

Counterpart of lightdiffusion_next_tpu/parallel/layout.py. The BFL
checkpoint fuses projections along the output dim: a double block's
``*_attn.qkv.weight`` stacks rows [q (H); k (H); v (H)] and a single
block's ``linear1.weight`` stacks [qkv (3H); mlp]. Cut into n column
shards, those fused dims put projection boundaries inside a shard. This
module re-lays the params out so a shard holds whole heads:

- qkv rows are head-interleaved, [q_h0; k_h0; v_h0; q_h1; ...]: rank r's
  rows are then its heads' q, k and v, and K3 reads them with its
  ``interleaved`` stripes;
- the single block's ``linear1`` is split into ``linear1_qkv``
  (interleaved) and ``linear1_mlp``;
- its ``linear2`` (input [attn (H); mlp]) is split along its input dim into
  ``linear2_attn`` and ``linear2_mlp``, each cleanly row-parallel: the two
  partial sums are added and reduced once, and the bias, kept on
  ``linear2_attn``, is added once after the reduction.

The transform only permutes and splits, so it preserves values; the
forward reads it through ``FluxConfig.tp_layout``. It works on every leaf
form the port has (tensors or numpy arrays, ``QTensor8``, ``QTensor8T``,
``QTensor8W``, ``QTensorLoRA``), on the host before the upload
(``pipelines.loader``) or on a loaded model (``parallel.inference``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.ops import ggml


def qkv_interleave_perm(num_heads: int, head_dim: int) -> np.ndarray:
    """Row permutation [q; k; v] (proj-major) -> head-major [h0: (q, k, v), ...]."""
    idx = np.arange(3 * num_heads * head_dim).reshape(3, num_heads, head_dim)
    return np.ascontiguousarray(idx.transpose(1, 0, 2)).reshape(-1)


def _take(t, idx: np.ndarray, dim: int):
    """``t`` (tensor or numpy array) indexed by ``idx`` along ``dim``."""
    if isinstance(t, torch.Tensor):
        return torch.index_select(t, dim, torch.as_tensor(idx, device=t.device))
    return np.take(np.asarray(t), idx, axis=dim)


def _take_rows(leaf, idx: np.ndarray):
    """The logical OUTPUT rows ``idx`` of a weight or bias leaf."""
    if isinstance(leaf, ggml.QTensorLoRA):
        return ggml.QTensorLoRA(base=_take_rows(leaf.base, idx), up=_take(leaf.up, idx, 0),
                                down=leaf.down)
    if isinstance(leaf, ggml.QTensor8T):  # codes (K, N)
        return ggml.QTensor8T(qt=_take(leaf.qt, idx, 1), scales_t=_take(leaf.scales_t, idx, 1),
                              shape=(len(idx), leaf.shape[1]))
    if isinstance(leaf, ggml.QTensor8):  # row layout (rows, nb, 32)
        return ggml.QTensor8(q=_take(leaf.q, idx, 0), scales=_take(leaf.scales, idx, 0),
                             shape=(len(idx),) + tuple(leaf.shape[1:]))
    if isinstance(leaf, ggml.QTensor8W):  # codes (N, K)
        return ggml.QTensor8W(q=_take(leaf.q, idx, 0), col_scales=_take(leaf.col_scales, idx, 1),
                              shape=(len(idx), leaf.shape[1]))
    return _take(leaf, idx, 0)  # dense weight (out, in) or bias (out,)


def _take_input_cols(leaf, lo: int, hi: int):
    """The logical INPUT columns [lo, hi) of a weight leaf; for Q8_0 leaves
    lo and hi fall on 32-element block boundaries."""
    if isinstance(leaf, ggml.QTensorLoRA):
        return ggml.QTensorLoRA(base=_take_input_cols(leaf.base, lo, hi), up=leaf.up,
                                down=leaf.down[:, lo:hi])
    if isinstance(leaf, ggml.QTensor8T):
        assert lo % 32 == 0 and hi % 32 == 0
        return ggml.QTensor8T(qt=leaf.qt[lo:hi, :], scales_t=leaf.scales_t[lo // 32:hi // 32, :],
                              shape=(leaf.shape[0], hi - lo))
    if isinstance(leaf, ggml.QTensor8):
        assert lo % 32 == 0 and hi % 32 == 0
        return ggml.QTensor8(q=leaf.q[:, lo // 32:hi // 32, :],
                             scales=leaf.scales[:, lo // 32:hi // 32],
                             shape=(leaf.shape[0], hi - lo))
    if isinstance(leaf, ggml.QTensor8W):  # the column scales are per output row
        return ggml.QTensor8W(q=leaf.q[:, lo:hi], col_scales=leaf.col_scales,
                              shape=(leaf.shape[0], hi - lo))
    return leaf[:, lo:hi]


def to_tp_layout_patches(patches: Dict, cfg) -> Dict:
    """LoRA patches (key -> (up (out, rank), down (rank, in), alpha)) from
    the checkpoint's keys to the TP layout's: ``up`` rows of the qkv
    targets interleaved, single-block ``linear1`` patches split (and their
    qkv part interleaved), ``linear2`` patches split along ``down``'s
    columns. A no-op unless ``cfg.tp_layout``."""
    if not getattr(cfg, "tp_layout", False):
        return patches
    hidden = cfg.hidden_size
    perm = qkv_interleave_perm(cfg.num_heads, cfg.head_dim)
    mlp_hidden = int(hidden * cfg.mlp_ratio)
    out = {}
    for key, (up, down, alpha) in patches.items():
        if key.endswith("attn.qkv.weight"):
            out[key] = (_take(up, perm, 0), down, alpha)
        elif "single_blocks" in key and key.endswith(".linear1.weight"):
            base = key[:-len("linear1.weight")]
            out[base + "linear1_qkv.weight"] = (_take(up[:3 * hidden], perm, 0), down, alpha)
            out[base + "linear1_mlp.weight"] = (up[3 * hidden:3 * hidden + mlp_hidden], down,
                                                alpha)
        elif "single_blocks" in key and key.endswith(".linear2.weight"):
            base = key[:-len("linear2.weight")]
            out[base + "linear2_attn.weight"] = (up, down[:, :hidden], alpha)
            out[base + "linear2_mlp.weight"] = (up, down[:, hidden:hidden + mlp_hidden], alpha)
        else:
            out[key] = (up, down, alpha)
    return out


def permute_rope_basis_rows(params: Dict, cfg) -> Dict:
    """``models.flux.permute_rope_basis`` for a state dict in the
    checkpoint's keys, BEFORE ``to_tp_layout``, on every leaf form
    (``QTensor8`` included): K3 needs q and k in the half-split RoPE basis,
    and that permutation (inside each head's 128 rows of the q and k
    sections) commutes with the interleave (whole 128-row blocks), so it
    runs first, in the simple proj-major indexing. The other order would
    rope the wrong basis without an error, hence the refusal of an
    interleaved layout. Refuses LoRA-patched leaves. Returns a new dict."""
    if getattr(cfg, "tp_layout", False):
        raise ValueError("permute the rope basis BEFORE to_tp_layout")
    hidden, d = cfg.hidden_size, cfg.head_dim
    pi = flux_mod.rope_pair_permutation(d)
    qkv_idx = flux_mod._qk_out_index(3 * hidden, hidden, d)
    lin1_idx = flux_mod._qk_out_index(3 * hidden + int(hidden * cfg.mlp_ratio), hidden, d)
    out = dict(params)

    def do(prefix, idx):
        for k in (prefix + ".weight", prefix + ".bias"):
            if k not in out:
                continue
            if isinstance(out[k], ggml.QTensorLoRA):
                raise ValueError("fused_attn cannot permute LoRA-patched qkv weights; "
                                 "load without fused attention or merge the LoRA first")
            out[k] = _take_rows(out[k], idx)

    for i in range(cfg.depth):
        for s in ("img", "txt"):
            do(f"double_blocks.{i}.{s}_attn.qkv", qkv_idx)
            for nk in ("query_norm", "key_norm"):
                key = f"double_blocks.{i}.{s}_attn.norm.{nk}.scale"
                out[key] = _take(out[key], pi, 0)
    for i in range(cfg.depth_single_blocks):
        do(f"single_blocks.{i}.linear1", lin1_idx)
        for nk in ("query_norm", "key_norm"):
            key = f"single_blocks.{i}.norm.{nk}.scale"
            out[key] = _take(out[key], pi, 0)
    return out


def to_tp_layout(params: Dict, cfg) -> Tuple[Dict, object]:
    """Re-lay Flux params head-interleaved with ``linear1`` and ``linear2``
    split; returns (new params, ``cfg`` with ``tp_layout``). Idempotent
    through ``cfg.tp_layout``."""
    if getattr(cfg, "tp_layout", False):
        return params, cfg
    if flux_mod.is_stacked(params):
        raise ValueError("lay the params out before stacking them")
    hidden = cfg.hidden_size
    perm = qkv_interleave_perm(cfg.num_heads, cfg.head_dim)
    mlp_hidden = int(hidden * cfg.mlp_ratio)
    mlp_rows = np.arange(3 * hidden, 3 * hidden + mlp_hidden)
    out = dict(params)
    for i in range(cfg.depth):
        for s in ("img", "txt"):
            for suf in ("weight", "bias"):
                k = f"double_blocks.{i}.{s}_attn.qkv.{suf}"
                if k in out:
                    out[k] = _take_rows(out[k], perm)
    for i in range(cfg.depth_single_blocks):
        pre = f"single_blocks.{i}."
        for suf in ("weight", "bias"):
            if pre + "linear1." + suf not in out:
                continue
            leaf = out.pop(pre + "linear1." + suf)
            out[pre + "linear1_qkv." + suf] = _take_rows(leaf, perm)
            out[pre + "linear1_mlp." + suf] = _take_rows(leaf, mlp_rows)
        if pre + "linear2.weight" in out:
            leaf = out.pop(pre + "linear2.weight")
            out[pre + "linear2_attn.weight"] = _take_input_cols(leaf, 0, hidden)
            out[pre + "linear2_mlp.weight"] = _take_input_cols(leaf, hidden, hidden + mlp_hidden)
        if pre + "linear2.bias" in out:  # the output bias: on one part, added once
            out[pre + "linear2_attn.bias"] = out.pop(pre + "linear2.bias")
    return out, dataclasses.replace(cfg, tp_layout=True)
