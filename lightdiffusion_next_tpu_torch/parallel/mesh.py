"""The ("data", "model") mesh over ranks, and the counted all-reduce.

Counterpart of lightdiffusion_next_tpu/parallel/mesh.py. The JAX package
runs one process over every device and builds a ``jax.sharding.Mesh``; the
port runs one process per GPU under ``torch.distributed`` and builds a
``DeviceMesh`` over the process group the caller initialised (with
``init_process_group``, or ``torchrun`` and ``app/cli.py``). The mesh's
"model" sub-group is the one the tensor-parallel forward's row-parallel
sums are reduced on. JAX's ``single_device_mesh`` is ``make_mesh()`` here.

The JAX package differentiates its ``shard_map`` forward with JAX's
autodiff, which transposes each ``psum``. The port's tensor-parallel
forward reduces through Megatron's pair of conjugate functions over the
"model" group, each a ``torch.autograd.Function``:

- ``reduce_from_model`` sums a row-parallel partial (forward all-reduce,
  backward identity: every rank's partial gets the whole gradient);
- ``copy_to_model`` marks a replicated tensor that enters rank-local work
  (forward identity, backward all-reduce: the gradients of a
  column-parallel matmul's input, or of a QKNorm scale over the rank's
  heads, are partial sums over the ranks).

Both go through ``all_reduce``, which counts the forward's reductions in
``calls`` and ``widths`` and the backward's in ``backward_calls`` and
``backward_widths``. Where no gradient is asked for, ``reduce_from_model``
is ``all_reduce`` and ``copy_to_model`` returns its input.
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


def all_reduce(t: torch.Tensor, group, backward: bool = False) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` in its own dtype (as ``psum`` does) and
    return it. Every collective of the tensor-parallel forward and backward
    goes through here: ``calls`` counts the forward's and ``widths`` counts
    them by the reduced tensor's last dimension; ``backward`` ones count in
    ``backward_calls`` and ``backward_widths``."""
    if backward:
        all_reduce.backward_calls += 1
        all_reduce.backward_widths[t.shape[-1]] += 1
    else:
        all_reduce.calls += 1
        all_reduce.widths[t.shape[-1]] += 1
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def reset_counts() -> None:
    all_reduce.calls = 0
    all_reduce.widths = collections.Counter()
    all_reduce.backward_calls = 0
    all_reduce.backward_widths = collections.Counter()


reset_counts()


def _grad_wanted(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce(grad, ctx.group, backward=True), None


def reduce_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of each rank's partial ``t`` over ``group``; its gradient
    passes to every rank's partial unchanged."""
    if _grad_wanted(t):
        return _ReduceFromModel.apply(t, group)
    return all_reduce(t, group)


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, the same on every rank of ``group``, as the input of
    rank-local work: its gradient is summed over the group."""
    if _grad_wanted(t):
        return _CopyToModel.apply(t, group)
    return t


def model_rank(mesh) -> int:
    """This rank's coordinate along "model"."""
    return mesh.get_local_rank("model")


def model_size(mesh) -> int:
    return mesh.size(1)
