"""The ("data", "model") mesh over ranks, and the counted all-reduce.

Counterpart of lightdiffusion_next_tpu/parallel/mesh.py. The JAX package
runs one process over every device and builds a ``jax.sharding.Mesh``; the
port runs one process per GPU under ``torch.distributed`` and builds a
``DeviceMesh`` over the process group the caller initialised (with
``init_process_group``, or ``torchrun`` and ``app/cli.py``). The mesh's
"model" sub-group is the one the tensor-parallel forward's row-parallel
sums are reduced on (``all_reduce``). JAX's ``single_device_mesh`` is
``make_mesh()`` here.
"""

from __future__ import annotations

import collections
import logging

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def make_mesh(data: int = 1, model: int = 1, device_type: str = None):
    """A ("data", "model") ``DeviceMesh`` of data * model ranks. That
    product must not exceed the world size; with -1 for one axis, it
    absorbs the remaining ranks; with fewer ranks than the world it warns.
    ``device_type`` defaults to "cuda" under the nccl backend, else "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data == -1 and model == -1:
        raise ValueError("only one mesh axis may be -1")
    if data == -1:
        data = n // model
    if model == -1:
        model = n // data
    if data < 1 or model < 1:
        raise ValueError(f"invalid mesh {data}x{model} for {n} devices")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    if data * model < n:
        logger.warning("mesh %dx%d uses %d of %d devices", data, model, data * model, n)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` in its own dtype (as ``psum``
    does) and return it. Every collective of the tensor-parallel forward
    goes through here: ``calls`` counts them and ``widths`` counts them by
    the reduced tensor's last dimension."""
    all_reduce.calls += 1
    all_reduce.widths[t.shape[-1]] += 1
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def reset_counts() -> None:
    all_reduce.calls = 0
    all_reduce.widths = collections.Counter()


reset_counts()


def model_rank(mesh) -> int:
    """This rank's coordinate along "model"."""
    return mesh.get_local_rank("model")


def model_size(mesh) -> int:
    return mesh.size(1)
