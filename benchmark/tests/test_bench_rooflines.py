"""The rooflines and operation counts against the bounds PERF.md prints
and against counts written out by hand."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import manifest

ROOF = {op: manifest.load_module("rooflines", op) for op in (
    "packed_flash_attention", "flash_attention", "fused_qkv_attention", "w8a8_matmul",
    "quant_matmul", "w8a8_matmul_ep", "row_quantize_fused", "sage_attention")}


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("op,args,kwargs,ms", [
    # K1 at SD2.1's (2, 5, 16384, 64) (PERF.md's kernel table)
    ("packed_flash_attention", (meta(2, 5, 16384, 64),) * 3, {}, 0.695),
    # K1 at hires-fix's (8, 8, 16384, 40)
    ("packed_flash_attention", (meta(8, 8, 16384, 40),) * 3, {}, 4.445),
    # K2's f32 VAE attention at 2048^2
    ("flash_attention", (meta(1, 1, 65536, 512, dtype=torch.float32),) * 3, {}, 8.894),
    # K3 interleaved at 24 heads, 4352 tokens
    ("fused_qkv_attention", (meta(1, 4352, 9216), None, None, None, None), {"num_heads": 24},
     0.2353),
])
def test_attention_bounds_match_perf_md(op, args, kwargs, ms):
    mod = ROOF[op]
    assert mod.bound_s(mod.shapes(*args, **kwargs)) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_w8a8_bounds():
    ep = ROOF["w8a8_matmul_ep"]
    # K7's bf16-rate variant at (4352, 3072, 12288): 0.332 ms (PERF.md's kernel table)
    from benchmark.rooflines import formulas
    assert formulas.w8a8_product(4352, 3072, 12288, int8_mxu=False) * 1e3 == pytest.approx(
        0.332, rel=2e-3)
    # at the int8 rate half of it, the operations bound
    s = ep.shapes(meta(4352, 3072, dtype=torch.int8), None, meta(12288, 3072, dtype=torch.int8),
                  None, None)
    assert ep.bound_s(s) == pytest.approx(2 * 4352 * 3072 * 12288 / 1979e12)
    # a stacked operand reads one block
    s3 = ep.shapes(meta(4352, 3072, dtype=torch.int8), None,
                   (meta(38, 12288, 3072, dtype=torch.int8), 5), None, None, meta(4352, 12288))
    assert s3["n"] == 12288 and s3["k"] == 3072 and s3["residual"]
    # K9 with ln_mod is bytes alone
    k9 = ROOF["row_quantize_fused"]
    s = k9.shapes(meta(4352, 3072), prologue="ln_mod")
    assert k9.bound_s(s) == pytest.approx((3 * 4352 * 3072 + 4 * 4352 + 8 * 3072) / 3.35e12)
    # K5 at Flux's (4352, 3072, 12288): operations bound at the bf16 rate
    q = ROOF["quant_matmul"]
    assert q.bound_s(q.shapes(meta(4352, 3072), meta(3072, 12288, dtype=torch.int8))) == \
        pytest.approx(2 * 4352 * 3072 * 12288 / 989e12)


def _cfg(name):
    return json.load(open(os.path.join(manifest.HERE, "configs", name + ".json")))


def test_unet_count_by_hand():
    """SD1.5's UNet at 1024^2, batch 2 (CFG), 77 text tokens, MSW-MSA off."""
    count = manifest.load_module("flops", "unet").count
    b, L, ctx = 2, 77, 768
    total = 2 * b * (320 * 1280 + 1280 * 1280)  # time embedding
    conv = lambda n, i, o, k=3: 2 * b * n * k * k * i * o
    res = lambda n, i, o: conv(n, i, o) + conv(n, o, o) + 2 * b * 1280 * o + (
        conv(n, i, o, 1) if i != o else 0)
    attn = lambda n, c: (2 * 2 * b * n * c * c  # proj_in, proj_out
                         + 4 * 2 * b * n * c * c + 4 * b * n * n * c + 2 * 2 * b * n * c * c
                         + 2 * 2 * b * L * ctx * c + 4 * b * n * L * c + 24 * b * n * c * c)
    n0, n1, n2, n3 = 128 * 128, 64 * 64, 32 * 32, 16 * 16
    total += conv(n0, 4, 320)
    total += 2 * (res(n0, 320, 320) + attn(n0, 320)) + conv(n1, 320, 320)
    total += res(n1, 320, 640) + attn(n1, 640) + res(n1, 640, 640) + attn(n1, 640)
    total += conv(n2, 640, 640)
    total += res(n2, 640, 1280) + attn(n2, 1280) + res(n2, 1280, 1280) + attn(n2, 1280)
    total += conv(n3, 1280, 1280) + 2 * res(n3, 1280, 1280)
    total += 2 * res(n3, 1280, 1280) + attn(n3, 1280)  # middle
    total += 3 * res(n3, 2560, 1280) + conv(n2, 1280, 1280)  # output level 3 (up)
    total += (res(n2, 2560, 1280) + res(n2, 2560, 1280) + res(n2, 1920, 1280)
              + 3 * attn(n2, 1280) + conv(n1, 1280, 1280))
    total += (res(n1, 1920, 640) + res(n1, 1280, 640) + res(n1, 960, 640)
              + 3 * attn(n1, 640) + conv(n0, 640, 640))
    total += res(n0, 960, 320) + res(n0, 640, 320) + res(n0, 640, 320) + 3 * attn(n0, 320)
    total += conv(n0, 320, 4)
    got = count(_cfg("sd15")["unet"], {"b": b, "h": 128, "w": 128, "ctx": L, "windowed": False})
    assert got == {"bf16": pytest.approx(total, rel=1e-12)}


def test_flux_count_by_hand():
    """Flux.1-dev at 1024^2: 4096 image tokens and 256 text tokens."""
    count = manifest.load_module("flops", "flux").count
    D, L, li, txt = 3072, 4352, 4096, 256
    int8 = 19 * 2 * L * D * 12 * D + 38 * (2 * L * D * 7 * D + 2 * L * 5 * D * D)
    bf16 = (57 * 4 * L * L * D + 19 * 2 * 12 * D * D + 38 * 2 * 3 * D * D
            + 2 * (li * 64 * D + txt * 4096 * D + 2 * (256 * D + D * D) + 768 * D + D * D
                   + 2 * D * D + li * D * 64))
    got = count(_cfg("flux1-dev-w8a8")["dit"], {"b": 1, "h": 128, "w": 128, "txt": txt})
    assert got["int8"] == pytest.approx(int8, rel=1e-12)
    assert got["bf16"] == pytest.approx(bf16, rel=1e-12)
    hit = count(_cfg("flux1-dev-w8a8")["dit"], {"b": 1, "h": 128, "w": 128, "txt": txt,
                                                "hit": True})
    assert hit["int8"] == pytest.approx(2 * L * D * 12 * D, rel=1e-12)


def test_readers_on_a_synthetic_run():
    """The roofline readers sum bounds and device times over their ops."""
    att = manifest.load_module("metrics", "attention_roofline")
    qm = manifest.load_module("metrics", "quant_matmul_roofline")
    run = NS(op_calls=[("fused_qkv_attention", 1.0, 2.0), ("flash_attention", 1.0, 2.0),
                       ("w8a8_matmul_ep", 1.0, 4.0)])
    assert att.read(run) == pytest.approx(50.0)
    assert qm.read(run) == pytest.approx(25.0)
    assert qm.read(NS(op_calls=[])) is None
