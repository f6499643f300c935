"""quant_matmul_roofline (%; layer: kernels; moves s_per_image): as
``attention_roofline``, over the quantized matmuls and their row
quantizations (K5-K11); a wrapper that launches two kernels (K9 then K7)
is one call whose bound is the sum of both."""

LAYER = "kernels"
OPS = ("quant_matmul", "quant_matmul_stacked", "w8a8_matmul", "w8a8_matmul_stacked",
       "w8a8_matmul_ep", "w8a8_matmul_ep_stacked", "row_quantize_fused",
       "row_quantize_concat_gelu")


def read(run):
    calls = [(b, t) for op, b, t in run.op_calls if op in OPS]
    device = sum(t for _, t in calls)
    return 100.0 * sum(b for b, _ in calls) / device if calls and device > 0 else None
