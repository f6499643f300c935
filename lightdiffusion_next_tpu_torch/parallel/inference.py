"""Multi-GPU inference: Flux tensor-parallel, SD1.5 data-parallel.

Counterpart of lightdiffusion_next_tpu/parallel/inference.py. One process
per GPU under ``torch.distributed``:

- Flux: the Megatron layout over the mesh's "model" ranks
  (``parallel.sharding``), each rank holding its shard of every column-
  and row-parallel weight and the rest whole, running the explicit
  forward of ``parallel.spmd``. For one image the mesh is (1, N).
- SD1.5: data-parallel; each rank keeps the whole params and takes its
  rows of the batch (``shard_batch``); the forward has no collective.
  JAX's ``shard_sd15_model`` replicates the params over the mesh; a rank's
  model is already whole, so the port has no counterpart.

Every host draw the ranks must share (the seed, the stop flag) goes
through ``agree``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.parallel import layout
from lightdiffusion_next_tpu_torch.parallel import sharding as shard_rules
from lightdiffusion_next_tpu_torch.parallel import spmd
from lightdiffusion_next_tpu_torch.parallel.mesh import make_mesh

_MESHES: dict = {}


def inference_mesh(n_model: int = -1, n_data: int = 1):
    """The serving layout: pure TP over every rank by default. One mesh
    (and its process groups) per layout and default group, made once."""
    key = (id(dist.group.WORLD), n_data, n_model)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(n_data, n_model)
    return _MESHES[key]


def _owned(x):
    """A slice copied out of the whole leaf, so the rest can be freed."""
    if isinstance(x, torch.Tensor):
        return x.clone(memory_format=torch.contiguous_format)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _owned(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if isinstance(getattr(x, f.name), torch.Tensor)
                                         or dataclasses.is_dataclass(getattr(x, f.name))})
    return x


def shard_flux_model(model, mesh):
    """An already-loaded single-device Flux ``DiffusionModel`` (unstacked)
    re-laid out tensor-parallel: ``layout.to_tp_layout`` first, so a rank's
    shard holds whole heads, then each rank keeps its slices. For models
    built in memory (tests, seeded weights); the loader with ``mesh=``
    uploads only the slices."""
    params, cfg = layout.to_tp_layout(model.params, model.config)
    cfg = spmd.tp_config(cfg, mesh)
    local = shard_rules.shard_params(params, shard_rules.flux_param_shardings(params), mesh)
    return dataclasses.replace(model, params={k: _owned(v) for k, v in local.items()},
                               config=cfg, apply_fn=flux_mod.make_apply_fn(cfg))


def shard_batch(x, mesh):
    """This rank's rows of a batch along "data"."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by data-axis size {n}")
    rows = x.shape[0] // n
    r = mesh.get_local_rank("data")
    return x[r * rows:(r + 1) * rows]


def agree(value: int) -> int:
    """Rank 0's ``value`` on every rank of the default process group (the
    value itself without one): the host draws every rank must share."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def is_writer() -> bool:
    """Whether this process writes the run's files and prints: rank 0, or
    a process outside any process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
