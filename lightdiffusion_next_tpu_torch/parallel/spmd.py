"""The tensor-parallel Flux forward with explicit collectives.

Counterpart of lightdiffusion_next_tpu/parallel/spmd.py, the JAX package's
``shard_map`` design: every rank runs the same Megatron math on its LOCAL
shards as ordinary tensors, so every matmul takes the single-device kernels
(K5/K6 on Q8_0, K9 + K11 / K7 / K8 on W8A8) at the local shapes, K3 runs
with its ``interleaved`` stripes on the rank's whole heads, and the
row-parallel partial sums are completed by the all-reduces that
``models/flux.py`` makes under ``FluxConfig.tp_axis`` (one per stream per
double block sublayer pair, one per single block: 4 * depth +
depth_single_blocks a call, each (B, L, hidden) wide). Activations, the
output and every host decision taken on them (FBCache's) are the same on
every rank.

The port builds no GSPMD counterpart: ``LDT_FLUX_TP`` "auto" and "spmd"
both run this forward, configured by the ``RuntimeConfig`` toggles.

Where each JAX piece went:

- ``_local_view`` rebuilt each quantized leaf with its local shape and the
  ``tp`` flag cleared; the port's leaves are local records already
  (``parallel.sharding.shard_leaf``), so it has no counterpart and
  ``make_spmd_apply_fn`` returns the forward alone;
- ``flux_tp_in_specs``, ``_leaf_specs``, ``_stacked_leaf_specs``,
  ``_qt_spec``, ``_cs_spec`` and ``_lead`` built ``shard_map``'s
  ``in_specs``; the port has no ``in_specs`` tree, and the same rules cut
  each rank's slices in ``parallel.sharding.shard_leaf``;
- ``stack_tp_block_params`` stacked the global sharded arrays with their
  shardings kept; here ``to_spmd_model`` stacks the rank's local shards
  with ``models.flux.stack_block_params``;
- ``ggml.to_w8a8`` on the global arrays took each column's maximum over
  the whole K; ``to_w8a8`` here all-reduces a row-parallel shard's column
  maxima first, so each rank's codes are its slice of the same result.

Kernel coverage, as in the JAX package: a row-parallel Q8_0 shard at
tp = 8 has K_local = 384, not a multiple of 256, so those matmuls take
dequantize + matmul (``quant_matmul.supported``); W8A8's gate (K in
128-multiples) takes every shape at tp = 2, 4 and 8.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict

import torch
import torch.distributed as dist

from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.parallel import sharding as shard_rules

logger = logging.getLogger(__name__)


def tp_config(cfg: flux_mod.FluxConfig, mesh, axis: str = "model") -> flux_mod.FluxConfig:
    """``cfg`` for a rank's shards: the TP layout is required, the heads
    must split evenly over the mesh's ``axis``, whose process group becomes
    ``tp_axis``."""
    if not cfg.tp_layout:
        raise ValueError("the tensor-parallel forward requires the TP-aligned layout "
                         "(parallel.layout.to_tp_layout, or the loader with mesh=)")
    tp = mesh.size(mesh.mesh_dim_names.index(axis))
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp={tp}")
    return dataclasses.replace(cfg, tp_axis=mesh.get_group(axis))


def make_spmd_apply_fn(cfg: flux_mod.FluxConfig, mesh, axis: str = "model"):
    """The tensor-parallel forward ``apply_fn(local_params, x, t, context,
    y, guidance=..., first_block_hook=...)``, with
    ``DiffusionModel.apply_fn``'s signature, on this rank's shards. The inputs are the same on every rank of a
    "model" row and so is the output. On a dp x tp mesh each "data" row of
    ranks takes its rows of the batch (``inference.shard_batch``) and
    returns them; a first-block hook (FBCache, whose decisions are for the
    whole batch) is refused there, as in the JAX package."""
    tcfg = tp_config(cfg, mesh, axis)
    fwd = flux_mod.make_apply_fn(tcfg)
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    data_rank = mesh.get_local_rank("data")

    def apply_fn(p, x, t, context, y=None, guidance=None, first_block_hook=None, **_):
        b = x.shape[0]
        if y is None:
            y = torch.zeros((b, cfg.vec_in_dim), dtype=torch.float32, device=x.device)
        if guidance is None and cfg.guidance_embed:
            guidance = torch.full((b,), 3.5, dtype=torch.float32, device=x.device)
        if n_data > 1:
            if first_block_hook is not None:
                raise ValueError("stateful first_block_hook (FBCache) is not supported on a "
                                 "dp x tp spmd mesh; use a pure-TP (1, N) mesh or disable "
                                 "FBCache")
            if b % n_data:
                raise ValueError(f"batch {b} not divisible by data-axis size {n_data}")
            rows = slice(data_rank * (b // n_data), (data_rank + 1) * (b // n_data))
            x, t, context, y = x[rows], t[rows], context[rows], y[rows]
            guidance = None if guidance is None else guidance[rows]
        return fwd(p, x, t, context, y, guidance=guidance, first_block_hook=first_block_hook)

    return apply_fn


def to_spmd_model(model, mesh, axis: str = "model", scan_blocks: bool = False):
    """A TP-loaded ``DiffusionModel`` (the loader with ``mesh=``) with the
    tensor-parallel forward; ``scan_blocks`` stacks its shards first
    (``flux.stack_block_params`` on the rank's leaves, consuming the
    model's dict) and keeps the unrolled forward, with a warning and the
    dict intact, where they cannot stack (LoRA-patched blocks)."""
    cfg = tp_config(model.config, mesh, axis)
    params = model.params
    if scan_blocks:
        try:
            params = flux_mod.stack_block_params(params, cfg)
        except ValueError as e:
            logger.warning("flux_scan unavailable under spmd (%s); keeping the "
                           "unrolled shard_map forward", e)
    return dataclasses.replace(model, apply_fn=make_spmd_apply_fn(model.config, mesh, axis),
                               params=params, config=cfg)


def _stack_rep_key(stack_key: str, rel: str) -> str:
    """The flat key of block 0 of a stacked family, for ``flux_param_spec``."""
    head = "double_blocks.0." if stack_key == flux_mod.DOUBLE_STACK_KEY else "single_blocks.0."
    return head + rel


def to_w8a8(params: Dict, cfg: flux_mod.FluxConfig) -> Dict:
    """``ggml.to_w8a8`` on a rank's shards (flat or stacked), CONSUMING
    ``params`` leaf by leaf. A column-parallel shard holds whole columns,
    so its per-column requant is its slice of the whole weight's; a
    row-parallel shard holds a K slice of every column, so its column
    maxima are all-reduced (MAX) over ``cfg.tp_axis`` first. Each rank's
    codes and scales are then the slices of the one requantization the JAX
    package computes on the global arrays. A load-time collective, per
    row-parallel leaf in the same order on every rank."""
    group = cfg.tp_axis

    def global_max(amax):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        return amax

    def conv(key, leaf):
        reduce = global_max if shard_rules.flux_param_spec(key) == shard_rules.ROW else None
        if isinstance(leaf, ggml.QTensor8T):
            return ggml.requant_col(leaf, reduce)
        if isinstance(leaf, ggml.QTensorLoRA) and isinstance(leaf.base, ggml.QTensor8T):
            return ggml.QTensorLoRA(ggml.requant_col(leaf.base, reduce), leaf.up, leaf.down)
        if isinstance(leaf, ggml.StackedQTensor8T):
            return ggml.requant_col_stacked(leaf, reduce)
        return leaf

    out = {}
    for key in list(params):
        leaf = params.pop(key)
        if isinstance(leaf, dict):
            out[key] = {rel: conv(_stack_rep_key(key, rel), leaf.pop(rel)) for rel in list(leaf)}
        else:
            out[key] = conv(key, leaf)
        del leaf
    return out
