"""K4: ``ops.sage_attention.sage_attention(q, k, v)``, its preparation and
kernel together: both products at the int8 rate (bf16 for P.V with
``pv_int8=False``), against the exponentials and the bytes."""

from benchmark import peaks
from benchmark.rooflines import formulas

TARGET = ("lightdiffusion_next_tpu_torch.ops.sage_attention", "sage_attention")


def shapes(q, k, v, int8_mxu=True, pv_int8=True):
    return {"b": q.shape[0], "h": q.shape[1], "lq": q.shape[2], "lk": k.shape[2],
            "d": q.shape[3], "qk": "int8" if int8_mxu else "bf16",
            "pv": "int8" if pv_int8 and int8_mxu else "bf16"}


def bound_s(s):
    half = 2.0 * s["b"] * s["h"] * s["lq"] * s["lk"] * s["d"]
    ops = half / peaks.FLOPS[s["qk"]] + half / peaks.FLOPS[s["pv"]]
    return max(ops, formulas.attention(s["b"], s["h"], s["lq"], s["lk"], s["d"], rate="int8"))
