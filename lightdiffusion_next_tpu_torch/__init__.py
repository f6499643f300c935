"""PyTorch/CUDA port of lightdiffusion_next_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference; each module here is the
counterpart of the JAX module of the same path. The port covers SD1.5 and
Flux.1-dev txt2img (``pipelines.pipeline.pipeline``) with hand-written CUDA
kernels: flash attention (``ops/flash_attention.py``), Flux's fused
QKNorm+RoPE attention and the Q8_0 dequant-matmul (``ops/quant_matmul.py``);
sources in ``csrc/``.
"""
