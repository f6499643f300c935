"""The compile nodes: ``ApplyStableFastUnet`` and ``EnhancedCompileModel``.

Counterpart of lightdiffusion_next_tpu/pipelines/compile.py, a shim that
keeps the reference's node API and returns the model unchanged. There the
nodes turn on XLA's compilation cache; the port's counterpart of that
cache is the kernel build cache (``ops/cuda_build.py``): for a model on
the GPU the nodes build every hand-written kernel not built yet, so the
first sampler step does not wait for ``nvcc``; on the CPU they do nothing.

No CUDA graph is captured here. PyTorch runs eagerly and ``jit`` has no
counterpart the port needs; where launch overhead rules a loop of small
kernels, a CUDA graph is the tool, in a change that makes the port faster
and is measured as such, not in one that ports the module (ROADMAP's
speed queue).
"""

from __future__ import annotations

from lightdiffusion_next_tpu_torch.ops import cuda_build


def _build_kernels(model) -> None:
    device = getattr(model, "device", None)
    if device is not None and device.type == "cuda":
        cuda_build.build()


class ApplyStableFastUnet:
    """StableFast's node: builds the kernels for a model on the GPU and
    returns ``(model,)``; ``enable_cuda_graph`` is accepted and not read."""

    def apply_stable_fast(self, model, enable_cuda_graph: bool = False):
        _build_kernels(model)
        return (model,)


class EnhancedCompileModel:
    """WaveSpeed's ``EnhancedCompileModel`` node, as ``ApplyStableFastUnet``."""

    def patch(self, model, *args, **kwargs):
        _build_kernels(model)
        return (model,)
