"""Flux.1 DiT as plain functions over a flat param dict.

Counterpart of lightdiffusion_next_tpu/models/flux.py in the configurations
this port runs: unrolled blocks or the scan layout (``stack_block_params``:
every block family stacked along a depth axis, the forward looping over
block indices with ``ops.nn.StackView``), and the matmul weights as Q8_0
(``QTensor8T``, K5), W8A8 (``QTensor8W``, K7) or either under an unmerged
LoRA (``QTensorLoRA``). On W8A8 weights with
``RuntimeConfig.fused_ew`` on, the LayerNorm + modulation or the GELU
before a matmul runs in its row quantization (K9, K10) and the bias, gate
and residual in the matmul's epilogue (K11). In the scan layout the same
matmuls read block ``idx`` of their stack in place: K6 on Q8_0 stacks, K8
and the stacked K11 on W8A8 stacks.

Attention takes one of two paths, as ``FluxConfig.fused_attn`` says:
fused, where the params are in the permuted half-split RoPE basis
(``permute_rope_basis``) and QKNorm, RoPE and the product run in K3
(``ops.flash_attention.fused_qkv_attention``); or unfused, where the heads
are split, normed, roped by ``ops/rope.py`` and attended through
``ops.attention.attention_heads`` (K2 for sequences of 512 tokens or
more). The same BFL checkpoint keys ("double_blocks.0.img_attn.qkv.weight",
...), NHWC latent in and out, LayerNorm eps 1e-6, f32 norms.

Tensor parallelism (``parallel/``): with ``FluxConfig.tp_layout`` the params
are in the TP layout (``parallel.layout.to_tp_layout``: qkv rows
head-interleaved, the single blocks' ``linear1`` and ``linear2`` split);
with ``FluxConfig.tp_axis`` set to the "model" process group they are also
this rank's shards (``parallel.sharding``), the forward runs the rank's
``num_heads // tp`` heads (K3 with its ``interleaved`` stripes when fused)
and sums each row-parallel partial over the group with
``parallel.mesh.reduce_from_model`` at the sites where the JAX forward
calls ``jax.lax.psum``: four per double block (each stream's ``proj`` and
``mlp.2``) and one per single block (``linear2_attn`` + ``linear2_mlp``
added first); the gate, bias and residual apply after the sum. For the
backward (``parallel.trainer``), each column-parallel matmul's input
passes ``parallel.mesh.copy_to_model`` (four per double block, the
modulated input of each stream's ``qkv`` and ``mlp.0``; one per single
block, the input ``linear1_qkv`` and ``linear1_mlp`` share), and so does
each QKNorm scale, which multiplies only the rank's heads: each all-reduces
its gradient. With ``FluxConfig.remat_blocks`` on stacked params, the
blocks after double block 0 run under ``torch.utils.checkpoint``: their
activations are recomputed in the backward (JAX ``jax.checkpoint`` of the
scan bodies).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.ops import ggml, nn
from lightdiffusion_next_tpu_torch.ops import rope as rope_ops
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
from lightdiffusion_next_tpu_torch.sampling.schedules import timestep_embedding_flux
from lightdiffusion_next_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 16
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    qkv_bias: bool = True
    guidance_embed: bool = True
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    patch_size: int = 2
    dtype: Any = torch.float32
    # the params are in the permuted RoPE basis and attention runs through
    # K3; set by models.base.flux_model exactly when it permutes, so config
    # and weights cannot disagree
    fused_attn: bool = False
    # the params are in the TP layout (parallel.layout.to_tp_layout): qkv
    # rows head-interleaved, the single blocks' linear1 split into
    # linear1_qkv + linear1_mlp and linear2 into linear2_attn + linear2_mlp
    tp_layout: bool = False
    # the "model" process group whose ranks each hold their shards of the
    # params (parallel.spmd): the forward runs num_heads // its size heads
    # and all-reduces the row-parallel partial sums over it. None: one
    # device holds every param
    tp_axis: Any = None
    # on stacked params, recompute the blocks after double block 0 in the
    # backward instead of keeping their activations (parallel.trainer's
    # remat); no effect without grad
    remat_blocks: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


FLUX_DEV = FluxConfig()
FLUX_SCHNELL = dataclasses.replace(FLUX_DEV, guidance_embed=False)

# the Q8_0 matmul weights of the published GGUF checkpoints; the other 2-D
# weights are dense
Q8_0_SUFFIXES = ("qkv.weight", "proj.weight", "mlp.0.weight", "mlp.2.weight",
                 "linear1.weight", "linear2.weight")


def _mlp_embedder(p: nn.ParamView, x):
    """in_layer -> silu -> out_layer."""
    h = nn.linear(x, p("in_layer.weight"), p("in_layer.bias"))
    return nn.linear(nn.silu(h), p("out_layer.weight"), p("out_layer.bias"))


def _modulation(p: nn.ParamView, vec, n: int):
    """silu(vec) -> lin -> 3 * (n // 3) chunks (shift, scale, gate groups),
    each (B, 1, hidden)."""
    out = nn.linear(nn.silu(vec), p("lin.weight"), p("lin.bias"))
    return torch.chunk(out[:, None, :], 3 * (n // 3), dim=-1)


def rope_pair_permutation(d: int) -> np.ndarray:
    """NEW -> OLD index map from interleaved RoPE pairs to the half-split
    layout: new lane j holds old feature 2j for j < d/2 and 2(j - d/2) + 1
    above, so lane j's rotation partner is lane j + d/2."""
    half = d // 2
    idx = np.empty((d,), np.int64)
    idx[:half] = np.arange(half) * 2
    idx[half:] = np.arange(half) * 2 + 1
    return idx


def _qk_out_index(out_dim: int, hidden: int, head_dim: int) -> np.ndarray:
    """Output-column permutation of a fused [q; k; v (; mlp)] projection:
    the rope pair permutation inside every head's segment of the q and k
    sections; v and mlp columns stay put."""
    idx = np.arange(out_dim, dtype=np.int64)
    pi = rope_pair_permutation(head_dim)
    for sec in (0, hidden):
        for h0 in range(sec, sec + hidden, head_dim):
            idx[h0:h0 + head_dim] = h0 + pi
    return idx


def permute_rope_basis(params: Dict, cfg: FluxConfig) -> Dict:
    """Permute the q/k output columns of every qkv and single-block linear1
    projection (weights, biases and QKNorm scales) into the half-split RoPE
    basis. Attention logits are invariant (the same permutation hits q and
    k); v and every other weight are untouched. Returns a new dict.
    Refuses a stacked dict (permute before stacking, as the JAX loader
    does) and LoRA-patched weights, as the JAX function does."""
    if is_stacked(params):
        raise ValueError("permute before stacking (the scan layout is not permuted)")
    if cfg.tp_layout or cfg.tp_axis is not None:
        raise ValueError("permute_rope_basis takes the checkpoint's layout; the TP load "
                         "permutes before the interleave (parallel.layout."
                         "permute_rope_basis_rows)")
    hidden, d = cfg.hidden_size, cfg.head_dim

    def take(t, idx, dim):
        return torch.index_select(t, dim, torch.as_tensor(idx, device=t.device))

    def permute_out(leaf, idx):
        if isinstance(leaf, ggml.QTensorLoRA):
            raise ValueError("fused_attn cannot permute LoRA-patched qkv weights; load "
                             "with fused_attn off or merge the LoRA first")
        if isinstance(leaf, ggml.QTensor8T):
            return ggml.QTensor8T(qt=take(leaf.qt, idx, 1),
                                  scales_t=take(leaf.scales_t, idx, 1), shape=leaf.shape)
        if isinstance(leaf, ggml.QTensor8W):  # codes (N, K): output columns are rows
            return ggml.QTensor8W(q=take(leaf.q, idx, 0),
                                  col_scales=take(leaf.col_scales, idx, 1), shape=leaf.shape)
        return take(leaf, idx, 0)

    out = dict(params)
    pi = rope_pair_permutation(d)
    qkv_idx = _qk_out_index(3 * hidden, hidden, d)
    lin1_idx = _qk_out_index(3 * hidden + int(hidden * cfg.mlp_ratio), hidden, d)

    def do(prefix, idx):
        out[prefix + ".weight"] = permute_out(params[prefix + ".weight"], idx)
        if prefix + ".bias" in params:
            out[prefix + ".bias"] = take(params[prefix + ".bias"], idx, 0)

    for i in range(cfg.depth):
        for s in ("img", "txt"):
            do(f"double_blocks.{i}.{s}_attn.qkv", qkv_idx)
            for nk in ("query_norm", "key_norm"):
                key = f"double_blocks.{i}.{s}_attn.norm.{nk}.scale"
                out[key] = take(params[key], pi, 0)
    for i in range(cfg.depth_single_blocks):
        do(f"single_blocks.{i}.linear1", lin1_idx)
        for nk in ("query_norm", "key_norm"):
            key = f"single_blocks.{i}.norm.{nk}.scale"
            out[key] = take(params[key], pi, 0)
    return out


def rope_cos_sin(ids, axes_dim, theta: int = 10000):
    """(cos, sin) for K3 in the half-split layout: C = [cos; cos],
    S = [-sin; sin], each (L, sum(axes_dim)) f32 and contiguous. ``ids`` is
    (B, L, n_axes); positions are the same for every batch entry, so row 0
    serves all."""
    pos = ids[0].float()
    parts_c, parts_s = [], []
    for ax, dim in enumerate(axes_dim):
        scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
        omega = 1.0 / (theta ** scale)
        ang = pos[:, ax][:, None] * omega[None]
        parts_c.append(torch.cos(ang))
        parts_s.append(torch.sin(ang))
    c = torch.cat(parts_c, dim=-1)
    s = torch.cat(parts_s, dim=-1)
    return torch.cat([c, c], dim=-1).contiguous(), torch.cat([-s, s], dim=-1).contiguous()


def _fused_ew(x) -> bool:
    """Whether ``x``'s matmul takes the fused-elementwise W8A8 path
    (``RuntimeConfig.fused_ew``, "auto": on the GPU)."""
    return _config.get_config().resolve_fused_ew(x.device)


def _mod_linears(p: nn.ParamView, keys, x, scale, shift, tp_axis=None):
    """layer_norm(x, 1e-6) * (1 + scale) + shift -> one linear per key of
    ``keys``, all on that one modulated input; on the fused W8A8 path the
    norm and modulation run in the row quantization (K9 "ln_mod") and the
    bias in K11's epilogue (``modulated_matmul`` returns None where it does
    not apply, and the unfused ops run). Under ``tp_axis`` the matmuls are
    column-parallel, so the modulated input passes ``copy_to_model`` once."""
    out = []
    xm = None
    for key in keys:
        w = p(key + ".weight")
        b = p.get(key + ".bias")
        fm = getattr(w, "modulated_matmul", None) if _fused_ew(x) else None
        if fm is not None:
            y = fm(x, prologue="ln_mod", mod_scale=1.0 + scale.float(), mod_shift=shift,
                   bias=b)
            if y is not None:
                out.append(y)
                continue
        if xm is None:
            xm = nn.layer_norm(x, eps=1e-6) * (1 + scale) + shift
            if tp_axis is not None:
                xm = mesh_mod.copy_to_model(xm, tp_axis)
        out.append(nn.linear(xm, w, b))
    return out


def _mod_linear(p: nn.ParamView, key: str, x, scale, shift, tp_axis=None):
    """``_mod_linears`` of one key."""
    return _mod_linears(p, (key,), x, scale, shift, tp_axis)[0]


def _row_parallel(x, w, b, tp_axis):
    """A row-parallel linear: the local product is a partial sum over the
    rank's slice of the input dim, summed over ``tp_axis``; the (whole)
    bias is added once, after."""
    out = mesh_mod.reduce_from_model(nn.linear(x, w, None), tp_axis)
    return out if b is None else out + b.to(out.dtype)


def _gated_out_linear(x_res, h, w, b, gate, tp_axis=None, gelu: bool = False):
    """x_res + gate * linear(gelu?(h), w, b); on the fused W8A8 path the
    GELU runs in the row quantization (K9) and the gate, bias and residual
    in K11's epilogue. Under ``tp_axis`` the epilogue must come after the
    sum over the ranks, so K9 and K11 emit the raw local partial, which is
    all-reduced, and the bias, gate and residual follow."""
    fm = getattr(w, "modulated_matmul", None) if _fused_ew(h) else None
    if fm is not None:
        if tp_axis is None:
            y = fm(h, prologue="gelu" if gelu else "none", gate=gate, bias=b,
                   residual=x_res)
            if y is not None:
                return y
        else:
            part = fm(h, prologue="gelu" if gelu else "none")
            if part is not None:
                out = mesh_mod.reduce_from_model(part, tp_axis)
                return x_res + gate * (out if b is None else out + b.to(out.dtype))
    if gelu:
        h = nn.gelu(h, approximate=True)
    if tp_axis is None:
        return x_res + gate * nn.linear(h, w, b)
    return x_res + gate * _row_parallel(h, w, b, tp_axis)


def _fused_attention(*args, **kw):
    """K3, or its plain version when ``attention_backend`` is "sdpa" (the
    plain reference path, as for the UNet's attention)."""
    if _config.get_config().attention_backend == "flash":
        return fa.fused_qkv_attention(*args, **kw)
    return fa.fused_qkv_attention_plain(*args, **kw)


def _norm_scale(p: nn.ParamView, key: str, cfg: FluxConfig):
    """A QKNorm scale; under ``tp_axis`` it multiplies only the rank's
    heads, so it passes ``copy_to_model``."""
    s = p(key)
    return s if cfg.tp_axis is None else mesh_mod.copy_to_model(s, cfg.tp_axis)


def _qk_norm(p: nn.ParamView, q, k, cfg: FluxConfig):
    """QKNorm: RMSNorm of each head's q and k with their scales."""
    return (nn.rms_norm(q, _norm_scale(p, "query_norm.scale", cfg)),
            nn.rms_norm(k, _norm_scale(p, "key_norm.scale", cfg)))


def _attention(q, k, v, pe):
    """RoPE, then attention on (B, H, L, D) heads; returns (B, L, H*D)."""
    q, k = rope_ops.apply_rope(q, k, pe)
    return attn_ops.attention_heads(q, k, v)


def _split_heads(qkv, num_heads: int, interleaved: bool = False):
    """(B, L, 3 * heads * head_dim) -> q, k, v, each a (B, heads, L,
    head_dim) view; ``interleaved``: the rows are head-major [h0: (q, k,
    v), h1: ...] (the TP layout)."""
    b, l, _ = qkv.shape
    if interleaved:
        qkv = qkv.reshape(b, l, num_heads, 3, -1).permute(3, 0, 2, 1, 4)
    else:
        qkv = qkv.reshape(b, l, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def local_heads(cfg: FluxConfig) -> int:
    """The heads this rank runs: all of them, or under ``tp_axis`` its
    num_heads // tp."""
    if cfg.tp_axis is None:
        return cfg.num_heads
    return cfg.num_heads // torch.distributed.get_world_size(cfg.tp_axis)


def _double_block(p: nn.ParamView, img, txt, vec, pe, cfg: FluxConfig):
    """DoubleStreamBlock; text rows come first in the joint sequence."""
    heads = local_heads(cfg)
    im1_shift, im1_scale, im1_gate, im2_shift, im2_scale, im2_gate = _modulation(
        p.scope("img_mod."), vec, 6)
    tx1_shift, tx1_scale, tx1_gate, tx2_shift, tx2_scale, tx2_gate = _modulation(
        p.scope("txt_mod."), vec, 6)

    img_qkv = _mod_linear(p, "img_attn.qkv", img, im1_scale, im1_shift, cfg.tp_axis)
    txt_qkv = _mod_linear(p, "txt_attn.qkv", txt, tx1_scale, tx1_shift, cfg.tp_axis)
    if cfg.fused_attn:
        cos, sin = pe
        attn = _fused_attention(
            torch.cat([txt_qkv, img_qkv], dim=1),
            _norm_scale(p, "img_attn.norm.query_norm.scale", cfg),
            _norm_scale(p, "img_attn.norm.key_norm.scale", cfg),
            cos, sin, num_heads=heads, txt_len=txt.shape[1],
            txt_q_scale=_norm_scale(p, "txt_attn.norm.query_norm.scale", cfg),
            txt_k_scale=_norm_scale(p, "txt_attn.norm.key_norm.scale", cfg),
            interleaved=cfg.tp_layout,
        )
    else:
        img_q, img_k, img_v = _split_heads(img_qkv, heads, cfg.tp_layout)
        img_q, img_k = _qk_norm(p.scope("img_attn.norm."), img_q, img_k, cfg)
        txt_q, txt_k, txt_v = _split_heads(txt_qkv, heads, cfg.tp_layout)
        txt_q, txt_k = _qk_norm(p.scope("txt_attn.norm."), txt_q, txt_k, cfg)
        attn = _attention(torch.cat([txt_q, img_q], dim=2), torch.cat([txt_k, img_k], dim=2),
                          torch.cat([txt_v, img_v], dim=2), pe)
    txt_attn, img_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]

    img = _gated_out_linear(img, img_attn, p("img_attn.proj.weight"),
                            p("img_attn.proj.bias"), im1_gate, cfg.tp_axis)
    h = _mod_linear(p, "img_mlp.0", img, im2_scale, im2_shift, cfg.tp_axis)
    img = _gated_out_linear(img, h, p("img_mlp.2.weight"), p("img_mlp.2.bias"),
                            im2_gate, cfg.tp_axis, gelu=True)

    txt = _gated_out_linear(txt, txt_attn, p("txt_attn.proj.weight"),
                            p("txt_attn.proj.bias"), tx1_gate, cfg.tp_axis)
    h = _mod_linear(p, "txt_mlp.0", txt, tx2_scale, tx2_shift, cfg.tp_axis)
    txt = _gated_out_linear(txt, h, p("txt_mlp.2.weight"), p("txt_mlp.2.bias"),
                            tx2_gate, cfg.tp_axis, gelu=True)
    return img, txt


def _tp_linear2(p: nn.ParamView, attn, mlp, x, gate, cfg: FluxConfig):
    """The single block's output under the TP layout: ``linear2_attn`` on
    attn plus ``linear2_mlp`` on gelu(mlp), two row-parallel partials added
    and then all-reduced ONCE under ``tp_axis``, the bias (on
    ``linear2_attn``) added once after. With fused-EW the two partials come
    from K9 and K11 ("none" and "gelu" prologues, no epilogue)."""
    out = None
    if _fused_ew(x):
        fm_a = getattr(p("linear2_attn.weight"), "modulated_matmul", None)
        fm_m = getattr(p("linear2_mlp.weight"), "modulated_matmul", None)
        if fm_a is not None and fm_m is not None:
            pa = fm_a(attn, prologue="none")
            pm = fm_m(mlp, prologue="gelu")
            if pa is not None and pm is not None:
                out = pa + pm
    if out is None:
        out = (nn.linear(attn, p("linear2_attn.weight"), None)
               + nn.linear(nn.gelu(mlp, approximate=True), p("linear2_mlp.weight"), None))
    if cfg.tp_axis is not None:
        out = mesh_mod.reduce_from_model(out, cfg.tp_axis)
    b2 = p.get("linear2_attn.bias")
    if b2 is not None:
        out = out + b2.to(out.dtype)
    return x + gate * out


def _single_block(p: nn.ParamView, x, vec, pe, cfg: FluxConfig):
    """SingleStreamBlock. Fused, K3 reads the q/k/v stripes straight out of
    the full linear1 output (its MLP lanes are never touched); under the TP
    layout out of ``linear1_qkv``'s interleaved rows."""
    heads = local_heads(cfg)
    shift, scale, gate = _modulation(p.scope("modulation."), vec, 3)
    hidden = cfg.hidden_size
    if cfg.tp_layout:
        # two column-parallel matmuls over the one input (on the fused W8A8
        # path each with its own LayerNorm + modulation prologue)
        qkv, mlp = _mod_linears(p, ("linear1_qkv", "linear1_mlp"), x, scale, shift,
                                cfg.tp_axis)
    else:
        proj = _mod_linear(p, "linear1", x, scale, shift)
        qkv = proj[..., :3 * hidden]
    if cfg.fused_attn:
        cos, sin = pe
        attn = _fused_attention(
            qkv if cfg.tp_layout else proj, _norm_scale(p, "norm.query_norm.scale", cfg),
            _norm_scale(p, "norm.key_norm.scale", cfg), cos, sin, num_heads=heads,
            interleaved=cfg.tp_layout,
        )
    else:
        q, k, v = _split_heads(qkv, heads, cfg.tp_layout)
        q, k = _qk_norm(p.scope("norm."), q, k, cfg)
        attn = _attention(q, k, v, pe)
    if cfg.tp_layout:
        return _tp_linear2(p, attn, mlp, x, gate, cfg)
    mlp = proj[..., 3 * hidden:]
    w2, b2 = p("linear2.weight"), p("linear2.bias")
    fm = getattr(w2, "modulated_matmul", None) if _fused_ew(x) else None
    if fm is not None and qm.supported_rowquant(attn.shape[-1] + mlp.shape[-1]):
        # K10 reads attn and the MLP window of the full linear1 projection
        # (the qkv lanes are never read) and the concat is never built; the
        # gate, bias and residual ride K11's epilogue. Where K11 declines (a
        # batched gate), K10's launch was spent for nothing, as the JAX
        # package traces it and drops it.
        pq = qm.row_quantize_concat_gelu(attn, proj, 3 * hidden, proj.shape[-1])
        y = fm(None, prequant=pq, gate=gate, bias=b2, residual=x)
        if y is not None:
            return y
    out = nn.linear(torch.cat([attn, nn.gelu(mlp, approximate=True)], dim=-1), w2, b2)
    return x + gate * out


DOUBLE_STACK_KEY = "__double_stack__"
SINGLE_STACK_KEY = "__single_stack__"


def group_block_params(params: Dict, cfg: FluxConfig) -> Tuple[Dict, Dict[str, Dict[str, list]]]:
    """Split a flat Flux param dict into (the non-block leaves, families)
    where ``families[head][rel]`` is the depth-ordered leaf list of the keys
    ``{head}.{i}.{rel}``. Raises ValueError for a ragged family (block
    indices other than 0..depth-1)."""
    out: Dict[str, Any] = {}
    depths = {"double_blocks": cfg.depth, "single_blocks": cfg.depth_single_blocks}
    per_key: Dict[str, Dict[str, Dict[int, Any]]] = {g: {} for g in depths}
    for k, v in params.items():
        head, _, rest = k.partition(".")
        if head in depths and rest:
            idx_s, _, rel = rest.partition(".")
            if idx_s.isdigit() and rel:
                per_key[head].setdefault(rel, {})[int(idx_s)] = v
                continue
        out[k] = v
    fams: Dict[str, Dict[str, list]] = {}
    for head, groups in per_key.items():
        depth = depths[head]
        fams[head] = {}
        for rel, by_idx in groups.items():
            if sorted(by_idx) != list(range(depth)):
                raise ValueError(f"{head}.*.{rel}: blocks {sorted(by_idx)} != 0..{depth - 1}")
            fams[head][rel] = [by_idx[i] for i in range(depth)]
    return out, fams


def stack_block_params(params: Dict, cfg: FluxConfig) -> Dict:
    """The scan layout: every ``double_blocks.{i}.K`` and
    ``single_blocks.{i}.K`` family stacked along a leading depth axis
    (``ggml.stack_leaves``) under ``DOUBLE_STACK_KEY`` and
    ``SINGLE_STACK_KEY``; the non-block keys stay flat.

    Validates every family first and raises ValueError, with ``params``
    untouched, for a ragged or non-uniform family. Then CONSUMES ``params``:
    the dict is cleared and the families stack one at a time, each
    family's per-block leaves dropped once its stack exists, so the extra
    device memory peaks at one family's stack (the single blocks'
    ``linear1``: 38 x 21504 x 3072 bytes = 2.5 GB), not a second copy of
    the model. Under the TP layout it stacks a rank's shards (``cfg``
    with its ``tp_axis``, as ``parallel.spmd.to_spmd_model`` gives it),
    so K6, K8 and the stacked K11 read depth slices whose N or K is the
    local one; the whole laid-out dict, before it is cut, is refused."""
    if cfg.tp_layout and cfg.tp_axis is None:
        raise ValueError("TP-laid-out params stack per rank: cut them into shards first "
                         "(parallel.spmd.to_spmd_model)")
    if is_stacked(params):
        raise ValueError("the params are stacked already")
    out, fams = group_block_params(params, cfg)
    # moved out of ``fams``, so each family's leaves go with its stack
    families = {(head, rel): fams[head].pop(rel) for head in fams for rel in list(fams[head])}
    stacks = ggml.stack_families(params, families)
    out[DOUBLE_STACK_KEY], out[SINGLE_STACK_KEY] = {}, {}
    for (head, rel), stack in stacks.items():
        out[DOUBLE_STACK_KEY if head == "double_blocks" else SINGLE_STACK_KEY][rel] = stack
    return out


def is_stacked(params: Dict) -> bool:
    return DOUBLE_STACK_KEY in params


def patchify(x, patch: int = 2):
    """NHWC (B, H, W, C) -> tokens (B, H/2 * W/2, C * 4), channel-major per
    patch."""
    b, h, w, c = x.shape
    hh, ww = h // patch, w // patch
    x = x.reshape(b, hh, patch, ww, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, hh * ww, c * patch * patch)


def unpatchify(tokens, h: int, w: int, patch: int = 2):
    """Inverse of patchify -> NHWC (B, H, W, C)."""
    b, l, d = tokens.shape
    hh, ww = h // patch, w // patch
    c = d // (patch * patch)
    x = tokens.reshape(b, hh, ww, c, patch, patch).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hh * patch, ww * patch, c)


def img_ids(batch: int, h: int, w: int, patch: int = 2, device=None):
    """3-axis position ids of the image tokens: (B, h/2 * w/2, 3) f32."""
    hh, ww = h // patch, w // patch
    ids = np.zeros((hh, ww, 3), dtype=np.float32)
    ids[..., 1] = np.arange(hh, dtype=np.float32)[:, None]
    ids[..., 2] = np.arange(ww, dtype=np.float32)[None, :]
    ids = np.tile(ids.reshape(1, hh * ww, 3), (batch, 1, 1))
    with profiling.span("sync.img_ids"):
        return torch.from_numpy(ids).to(device)


def apply_flux(params: Dict, x, timesteps, context, y, guidance=None,
               cfg: FluxConfig = FLUX_DEV, first_block_hook=None):
    """Flux forward. x: NHWC latent (B, H, W, 16); timesteps (B,) sigmas in
    [0, 1]; context (B, L, 4096) T5 sequence; y (B, 768) CLIP pooled;
    guidance (B,). ``first_block_hook(img_before, img_after_block0,
    run_rest)`` is FBCache's boundary after double block 0. Returns the
    NHWC f32 prediction."""
    if cfg.fused_attn and cfg.tp_layout and cfg.tp_axis is None:
        # TP-laid-out params in the permuted basis need K3's interleaved
        # stripes on a rank's whole heads; a single device would rope them
        # through the unfused path in the wrong basis
        raise ValueError("fused_attn + tp_layout requires the tensor-parallel forward "
                         "(parallel.spmd.make_spmd_apply_fn)")
    b, h, w, c = x.shape
    dtype = cfg.dtype

    img = nn.linear(patchify(x.to(dtype), cfg.patch_size),
                    params["img_in.weight"], params["img_in.bias"])
    txt = nn.linear(context.to(dtype), params["txt_in.weight"], params["txt_in.bias"])

    vec = _mlp_embedder(nn.ParamView(params, "time_in."),
                        timestep_embedding_flux(timesteps, 256).to(dtype))
    if cfg.guidance_embed:
        if guidance is None:
            guidance = torch.full((b,), 3.5, dtype=torch.float32, device=x.device)
        vec = vec + _mlp_embedder(nn.ParamView(params, "guidance_in."),
                                  timestep_embedding_flux(guidance, 256).to(dtype))
    vec = vec + _mlp_embedder(nn.ParamView(params, "vector_in."), y.to(dtype))

    txt_ids = torch.zeros((b, txt.shape[1], 3), dtype=torch.float32, device=x.device)
    ids = torch.cat([txt_ids, img_ids(b, h, w, cfg.patch_size, device=x.device)], dim=1)
    if cfg.fused_attn:
        pe = rope_cos_sin(ids, cfg.axes_dim, cfg.theta)
    else:
        pe = rope_ops.embed_nd(ids, cfg.axes_dim, cfg.theta)

    if is_stacked(params):
        dstack, sstack = params[DOUBLE_STACK_KEY], params[SINGLE_STACK_KEY]

        def double_view(i):
            return nn.StackView(dstack, i)

        def single_view(i):
            return nn.StackView(sstack, i)
    else:
        def double_view(i):
            return nn.ParamView(params, f"double_blocks.{i}.")

        def single_view(i):
            return nn.ParamView(params, f"single_blocks.{i}.")

    img_prev = img
    # double block 0 on its own: FBCache's boundary needs its output
    img, txt = _double_block(double_view(0), img, txt, vec, pe, cfg)
    remat = cfg.remat_blocks and is_stacked(params) and torch.is_grad_enabled()

    def block(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def run_rest(img):
        """The remaining double blocks and all single blocks; returns the
        image tokens before the final layer."""
        txt_ = txt
        for i in range(1, cfg.depth):
            img, txt_ = block(_double_block, double_view(i), img, txt_, vec, pe, cfg)
        xx = torch.cat([txt_, img], dim=1)
        for i in range(cfg.depth_single_blocks):
            xx = block(_single_block, single_view(i), xx, vec, pe, cfg)
        return xx[:, txt_.shape[1]:]

    if first_block_hook is not None:
        img_out = first_block_hook(img_prev, img, run_rest)
    else:
        img_out = run_rest(img)

    pl = nn.ParamView(params, "final_layer.")
    mod = nn.linear(nn.silu(vec), pl("adaLN_modulation.1.weight"),
                    pl("adaLN_modulation.1.bias"))
    shift, scale = torch.chunk(mod, 2, dim=-1)
    img_out = nn.layer_norm(img_out, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]
    tokens = nn.linear(img_out, pl("linear.weight"), pl("linear.bias"))
    return unpatchify(tokens.float(), h, w, cfg.patch_size)


def detect_config(sd: Dict, dtype=None) -> FluxConfig:
    """FluxConfig from state-dict shapes (leaves may be quantized records:
    only ``.shape``, logical (out, in), is read)."""
    def shape(k):
        return tuple(sd[k].shape)

    hidden = shape("img_in.weight")[0]
    patch = FLUX_DEV.patch_size
    head_dim = shape("double_blocks.0.img_attn.norm.key_norm.scale")[0]
    if hidden % head_dim:
        raise ValueError(f"hidden {hidden} not divisible by head_dim {head_dim}")
    depth = 0
    while f"double_blocks.{depth}.img_attn.qkv.weight" in sd:
        depth += 1
    depth_single = 0
    while (f"single_blocks.{depth_single}.linear2.weight" in sd
           or f"single_blocks.{depth_single}.linear1.weight" in sd):
        depth_single += 1
    if head_dim == 128:
        axes = (16, 56, 56)
    else:
        axes = tuple(a * head_dim // 128 for a in (16, 56, 56))
        if sum(axes) != head_dim or any(a % 2 for a in axes):
            raise ValueError(f"cannot derive axes_dim for head_dim {head_dim}; "
                             "pass an explicit FluxConfig")
    return dataclasses.replace(
        FLUX_DEV,
        in_channels=shape("img_in.weight")[1] // patch**2,
        hidden_size=hidden,
        mlp_ratio=shape("double_blocks.0.img_mlp.0.weight")[0] / hidden,
        num_heads=hidden // head_dim,
        depth=depth,
        depth_single_blocks=depth_single,
        axes_dim=axes,
        qkv_bias="double_blocks.0.img_attn.qkv.bias" in sd,
        guidance_embed="guidance_in.in_layer.weight" in sd,
        vec_in_dim=shape("vector_in.in_layer.weight")[1],
        context_in_dim=shape("txt_in.weight")[1],
        dtype=dtype or FLUX_DEV.dtype,
    )


def make_apply_fn(cfg: FluxConfig):
    def apply_fn(p, x, t, context, y=None, guidance=None, first_block_hook=None, **_):
        with profiling.span("models.dit"):
            return apply_flux(p, x, t, context, y, guidance=guidance, cfg=cfg,
                              first_block_hook=first_block_hook)

    return apply_fn


def _layout(cfg: FluxConfig):
    """(key, shape, kind) of every param in ``init_params``' order; kind is
    "lin" (normal(0, in^-0.5)), "bias" (zeros) or "scale" (ones)."""
    H = cfg.hidden_size
    out = []

    def lin(key, out_d, in_d, bias=True):
        out.append((key + ".weight", (out_d, in_d), "lin"))
        if bias:
            out.append((key + ".bias", (out_d,), "bias"))

    def scale(key, d):
        out.append((key, (d,), "scale"))

    lin("img_in", H, cfg.in_channels * cfg.patch_size**2)
    lin("txt_in", H, cfg.context_in_dim)
    lin("time_in.in_layer", H, 256)
    lin("time_in.out_layer", H, H)
    lin("vector_in.in_layer", H, cfg.vec_in_dim)
    lin("vector_in.out_layer", H, H)
    if cfg.guidance_embed:
        lin("guidance_in.in_layer", H, 256)
        lin("guidance_in.out_layer", H, H)
    mlp_hidden = int(H * cfg.mlp_ratio)
    for i in range(cfg.depth):
        pre = f"double_blocks.{i}."
        for s in ("img", "txt"):
            lin(pre + f"{s}_mod.lin", 6 * H, H)
            lin(pre + f"{s}_attn.qkv", 3 * H, H, bias=cfg.qkv_bias)
            scale(pre + f"{s}_attn.norm.query_norm.scale", cfg.head_dim)
            scale(pre + f"{s}_attn.norm.key_norm.scale", cfg.head_dim)
            lin(pre + f"{s}_attn.proj", H, H)
            lin(pre + f"{s}_mlp.0", mlp_hidden, H)
            lin(pre + f"{s}_mlp.2", H, mlp_hidden)
    for i in range(cfg.depth_single_blocks):
        pre = f"single_blocks.{i}."
        lin(pre + "linear1", 3 * H + mlp_hidden, H)
        lin(pre + "linear2", H, H + mlp_hidden)
        scale(pre + "norm.query_norm.scale", cfg.head_dim)
        scale(pre + "norm.key_norm.scale", cfg.head_dim)
        lin(pre + "modulation.lin", 3 * H, H)
    lin("final_layer.linear", cfg.patch_size**2 * cfg.in_channels, H)
    lin("final_layer.adaLN_modulation.1", 2 * H, H)
    return out


def init_params(cfg: FluxConfig = FLUX_DEV, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random params drawn exactly as the JAX package's ``init_params``
    draws them (numpy float64, then f32). For the tests' small widths."""
    rng = np.random.default_rng(seed)
    P = {}
    for key, shape, kind in _layout(cfg):
        if kind == "lin":
            P[key] = rng.normal(0, shape[1] ** -0.5, shape)
        else:
            P[key] = (np.ones if kind == "scale" else np.zeros)(shape)
    return {k: np.asarray(v, dtype=np.float32) for k, v in P.items()}


def random_leaves(cfg: FluxConfig = FLUX_DEV, seed: int = 0, device="cuda",
                  dtype=torch.bfloat16):
    """``random_params``' leaves one at a time, as (key, leaf) in
    ``_layout``'s order, with the weights named by ``Q8_0_SUFFIXES`` as
    row-layout ``QTensor8`` records (what a GGUF file holds): a writer can
    stream a full-width model with one leaf in memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for key, shape, kind in _layout(cfg):
        if kind == "lin":
            w = torch.randn(shape, generator=gen, device=device) * shape[1] ** -0.5
            yield key, ggml.quantize(w) if key.endswith(Q8_0_SUFFIXES) else w.to(dtype)
            del w
        elif kind == "bias":
            yield key, torch.zeros(shape, dtype=dtype, device=device)
        else:
            yield key, torch.ones(shape, dtype=torch.float32, device=device)


def random_params(cfg: FluxConfig = FLUX_DEV, seed: int = 0, device="cuda",
                  dtype=torch.bfloat16):
    """Seeded params at any width, drawn on ``device`` by a
    ``torch.Generator`` with ``init_params``' distributions (not its
    numbers): the weights named by ``Q8_0_SUFFIXES`` are quantized there to
    Q8_0 (``QTensor8T``), the other 2-D weights and biases are ``dtype``,
    the QKNorm scales f32. At Flux.1-dev's width that is 8.6e9 Q8_0
    weights (9.7 GB with their f32 scales) and 3.3e9 dense ones (6.6 GB in
    bf16, most of them the modulation weights)."""
    return {key: ggml.transpose_for_matmul(leaf) if isinstance(leaf, ggml.QTensor8) else leaf
            for key, leaf in random_leaves(cfg, seed, device, dtype)}
