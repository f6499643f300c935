"""Multi-GPU execution: the ("data", "model") mesh over ``torch.distributed``
ranks, Flux's tensor-parallel layout and forward, SD1.5 data parallelism,
and the flow-matching trainer with its checkpoints and input pipeline.

Counterpart of lightdiffusion_next_tpu/parallel/ (``mesh``, ``layout``,
``sharding``, ``spmd``, ``inference``, ``trainer``, ``data``).
"""

from lightdiffusion_next_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
