"""Which Flux params are cut across the "model" ranks, and each rank's cut.

Counterpart of lightdiffusion_next_tpu/parallel/sharding.py and of the
spec half of parallel/spmd.py. Flux tensor parallelism is the Megatron
pattern: column-parallel qkv, ``mlp.0`` and ``linear1`` (their output dim
cut), row-parallel ``proj``, ``mlp.2`` and ``linear2`` (their input dim
cut, so each rank's product is a partial sum the forward all-reduces);
embedders, modulations, norms and the in and out projections replicate.
``flux_param_spec`` is that one rule table, in the JAX package's
PartitionSpec form as tuples: ``COLUMN`` = ("model", None), ``ROW`` =
(None, "model"), ``("model",)`` for a column-parallel bias, ``()`` to
replicate.

The JAX package hands those specs to GSPMD or to ``shard_map``'s
``in_specs``; the port has neither, and a rank holds plain local tensors.
So what JAX spreads over ``_quantized_sharding``, ``flux_sharding_for``,
``shard_params`` and spmd's ``_qt_spec``, ``_cs_spec``, ``_leaf_specs`` and
``flux_tp_in_specs`` is here ``shard_leaf``, which cuts a rank's slice of
any leaf from its logical spec. JAX's ``replicated_shardings`` and
``batch_sharding`` have no counterpart: a replicated leaf is the leaf
itself, and a rank's rows of a batch are ``inference.shard_batch``'s.

- Q8_0 ``QTensor8T`` (codes (K, N), scales (K/32, N)): column-parallel
  cuts N of both, row-parallel K and K/32 (``_qt_spec``); the row layout
  ``QTensor8`` of a GGUF file likewise, along its rows or its 32-blocks;
- W8A8 ``QTensor8W`` (the port's codes are (N, K)): the column scales
  (1, N) are cut with N when column-parallel and kept whole when
  row-parallel (``_cs_spec``);
- ``QTensorLoRA``: ``up`` is cut with a column-parallel base, ``down``
  with a row-parallel one, so the low-rank correction of a row-parallel
  weight is itself a partial sum folded into the all-reduce
  (``_leaf_specs``).
"""

from __future__ import annotations

from typing import Dict

import torch

from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod

COLUMN = ("model", None)
ROW = (None, "model")

_COLUMN_WEIGHTS = ("attn.qkv.weight", "mlp.0.weight", "linear1.weight", "linear1_qkv.weight",
                   "linear1_mlp.weight")
_COLUMN_BIASES = ("attn.qkv.bias", "mlp.0.bias", "linear1.bias", "linear1_qkv.bias",
                  "linear1_mlp.bias")
_ROW_WEIGHTS = ("attn.proj.weight", "mlp.2.weight", "linear2.weight", "linear2_attn.weight",
                "linear2_mlp.weight")


def flux_param_spec(key: str) -> tuple:
    """The logical (out, in) spec of one Flux param key."""
    if key.endswith(_COLUMN_WEIGHTS):
        return COLUMN
    if key.endswith(_COLUMN_BIASES):
        return ("model",)
    if key.endswith(_ROW_WEIGHTS):
        return ROW
    return ()


def _cut(t, dim: int, rank: int, tp: int):
    """Slice ``rank`` of ``tp`` equal slices of ``t`` along ``dim``."""
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {tp} ways")
    step = n // tp
    index = [slice(None)] * len(t.shape)
    index[dim] = slice(rank * step, (rank + 1) * step)
    return t[tuple(index)]


def shard_leaf(leaf, spec: tuple, rank: int, tp: int):
    """Rank ``rank``'s slice, of ``tp``, of a leaf whose logical spec is
    ``spec`` (a view where the layout allows, not a copy)."""
    if "model" not in spec or tp == 1:
        return leaf
    column = spec[0] == "model"
    if isinstance(leaf, ggml.QTensorLoRA):
        return ggml.QTensorLoRA(base=shard_leaf(leaf.base, spec, rank, tp),
                                up=_cut(leaf.up, 0, rank, tp) if column else leaf.up,
                                down=leaf.down if column else _cut(leaf.down, 1, rank, tp))
    if isinstance(leaf, (ggml.QTensor8T, ggml.QTensor8, ggml.QTensor8W)):
        out_d, in_d = leaf.shape
        shape = (out_d // tp, in_d) if column else (out_d, in_d // tp)
        if in_d // tp % qm.QBLOCK and not column and not isinstance(leaf, ggml.QTensor8W):
            raise ValueError(f"a row-parallel Q8_0 slice of {in_d} // {tp} inputs is not "
                             f"whole {qm.QBLOCK}-blocks")
        if isinstance(leaf, ggml.QTensor8T):  # (K, N)
            d = 1 if column else 0
            return ggml.QTensor8T(_cut(leaf.qt, d, rank, tp), _cut(leaf.scales_t, d, rank, tp),
                                  shape)
        if isinstance(leaf, ggml.QTensor8):  # (rows, nb, 32)
            d = 0 if column else 1
            return ggml.QTensor8(_cut(leaf.q, d, rank, tp), _cut(leaf.scales, d, rank, tp),
                                 shape)
        if column:  # QTensor8W, (N, K) and (1, N)
            return ggml.QTensor8W(_cut(leaf.q, 0, rank, tp),
                                  _cut(leaf.col_scales, 1, rank, tp), shape)
        return ggml.QTensor8W(_cut(leaf.q, 1, rank, tp), leaf.col_scales, shape)
    return _cut(leaf, spec.index("model"), rank, tp)


def _coords(mesh):
    return mesh_mod.model_rank(mesh), mesh_mod.model_size(mesh)


def shard_state_dict(sd: Dict, mesh, dtype=torch.bfloat16, device=None) -> Dict:
    """A TP-laid-out Flux state dict (host records, numpy arrays or
    tensors) -> this rank's slices on ``device`` (``ggml.to_device_quantized``:
    Q8_0 matmul weights as ``QTensor8T``, dense leaves in ``dtype``).
    CONSUMES ``sd``, leaf by leaf, so the host copy shrinks as the slices
    go up; only the slices are uploaded."""
    rank, tp = _coords(mesh)
    out = {}
    for key in list(sd):
        leaf = shard_leaf(sd.pop(key), flux_param_spec(key), rank, tp)
        out.update(ggml.to_device_quantized({key: leaf}, dtype=dtype, device=device))
    return out


def shard_patches(patches: Dict, rank: int, tp: int) -> Dict:
    """LoRA patches (key -> (up, down, alpha)) in the TP layout's keys, cut
    as ``shard_leaf`` cuts a ``QTensorLoRA`` of the key: ``up``'s rows with
    a column-parallel weight, ``down``'s columns with a row-parallel one."""
    out = {}
    for key, (up, down, alpha) in patches.items():
        spec = flux_param_spec(key)
        if spec == COLUMN:
            up = _cut(up, 0, rank, tp)
        elif spec == ROW:
            down = _cut(down, 1, rank, tp)
        out[key] = (up, down, alpha)
    return out


def flux_param_shardings(params: Dict, mesh=None) -> Dict:
    """{key: spec} of a flat Flux param dict."""
    return {k: flux_param_spec(k) for k in params}


def shard_params(params: Dict, shardings: Dict, mesh) -> Dict:
    """Each leaf's slice for this rank, per ``shardings`` ({key: spec})."""
    rank, tp = _coords(mesh)
    return {k: shard_leaf(v, shardings[k], rank, tp) for k, v in params.items()}
