"""Multi-GPU execution: the ("data", "model") mesh over ``torch.distributed``
ranks, Flux's tensor-parallel layout and forward, SD1.5 data parallelism.

Counterpart of lightdiffusion_next_tpu/parallel/ (``mesh``, ``layout``,
``sharding``, ``spmd``, ``inference``). Its trainer and data loader
(``parallel/trainer.py``, ``parallel/data.py``) are not ported yet.
"""

from lightdiffusion_next_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
