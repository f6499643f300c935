"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

FLOPS = {
    "int8": 1979e12,  # int8 tensor-core operations per second
    "fp8": 1979e12,
    "bf16": 989e12,  # bf16 and fp16 tensor-core FLOP/s
    "tf32": 495e12,
    "f32": 67e12,  # f32 outside the tensor cores (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12
EXP_PER_S = 3.86e12  # MUFU exponentials per second (132 SMs x 16 a clock x 1.83 GHz)
