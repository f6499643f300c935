"""attention_roofline (%; layer: kernels; moves s_per_image): the sum over
every attention kernel call of the window of its least time
(``benchmark/rooflines/<op>.py``, from the call's shapes) over the sum of
the calls' device times (CUDA events around each call, traced run). The
bound is keyed by the operation and its shapes, so it reads the same work
whatever kernel implements it."""

LAYER = "kernels"
OPS = ("packed_flash_attention", "flash_attention", "fused_qkv_attention", "sage_attention")


def read(run):
    calls = [(b, t) for op, b, t in run.op_calls if op in OPS]
    device = sum(t for _, t in calls)
    return 100.0 * sum(b for b, _ in calls) / device if calls and device > 0 else None
