"""PyTorch/CUDA port of lightdiffusion_next_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference; each module here is the
counterpart of the JAX module of the same path. This slice covers SD1.5
txt2img (``pipelines.pipeline.pipeline``) with hand-written CUDA attention
kernels (``ops/flash_attention.py``, sources in ``csrc/``).
"""
