"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels
have no CPU mode; on the CPU the wrappers run the plain versions, which the
other ``test_torch_*`` files hold against the JAX package). This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)

Tolerances, as in ``chip_smoke.py``: ``flash_attention.agreement``. bf16:
max |kernel - plain| within three bf16 ulps at the largest |plain| (both round
their f32 result and p to bf16, p against different running maxima); f32:
within a fixed share of max |plain|, because the kernel rounds q, k, v and p
to bf16 for the tensor cores. Both also bound the relative RMS error, which
planted faults exceed (``test_planted_faults_fail_the_check``).
"""

import pytest
import torch

from lightdiffusion_next_tpu_torch import config
from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return config.resolve_device("cuda")


def _check(out, q, k, v):
    check = fa.agreement(out, fa.attention_plain(q, k, v))
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kernel,b,h,lq,lk,d,dtype",
    [
        ("packed", 2, 8, 1024, 1024, 40, torch.bfloat16),
        ("packed", 1, 2, 600, 700, 40, torch.bfloat16),   # ragged, masked tail
        ("packed", 1, 3, 512, 520, 64, torch.bfloat16),
        ("flash", 2, 8, 1024, 1024, 160, torch.bfloat16),
        ("flash", 1, 3, 577, 650, 80, torch.bfloat16),
        ("flash", 1, 2, 530, 700, 36, torch.float32),     # d not a multiple of 8
        ("flash", 1, 1, 1024, 1024, 512, torch.float32),  # the VAE's head
        ("flash", 1, 1, 600, 600, 300, torch.float32),    # column slices, ragged d
    ],
)
def test_kernel_matches_plain(cuda, kernel, b, h, lq, lk, d, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    fn = fa.packed_flash_attention if kernel == "packed" else fa.flash_attention
    launches = fn.launches
    out = fn(q, k, v)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert out.shape == q.shape and out.dtype == dtype
    _check(out, q, k, v)


@pytest.mark.cuda
def test_strided_views_of_fused_projection(cuda):
    """The UNet hands over head-split views of one q|k|v matmul output; the
    kernel reads them through their strides and the folded output needs no
    copy."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, l, h, d = 2, 1024, 8, 40
    x = torch.randn((b, l, 3 * h * d), generator=gen, device="cuda").bfloat16()
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2) for t in x.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out = fa.packed_flash_attention(q, k, v)
    _check(out, q, k, v)
    folded = attn_ops._fold_heads(out)
    assert folded.data_ptr() == out.data_ptr()


@pytest.mark.cuda
def test_dispatch_launches_kernels(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    q40, q80 = (torch.randn((1, 1024, 8 * d), generator=gen, device="cuda").bfloat16()
                for d in (40, 80))
    before = (fa.packed_flash_attention.launches, fa.flash_attention.launches)
    attn_ops.attention(q40, q40, q40, heads=8)
    attn_ops.attention(q80, q80, q80, heads=8)
    attn_ops.attention(q80, q80[:, :77], q80[:, :77], heads=8)  # short kv: sdpa
    after = (fa.packed_flash_attention.launches, fa.flash_attention.launches)
    assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_unsupported_input_raises(cuda):
    q = torch.zeros((1, 1, 512, 40), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 40, 512), device="cuda", dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,b,h,l,d,dtype",
    [
        ("packed_flash_attention", 2, 8, 16384, 40, torch.bfloat16),  # K1 unwindowed
        ("flash_attention", 2, 8, 4096, 80, torch.bfloat16),
        ("flash_attention", 1, 1, 16384, 512, torch.float32),          # the VAE's call
    ],
)
def test_planted_faults_fail_the_check(cuda, name, b, h, l, d, dtype):
    """The check passes the kernel and fails it with a fault planted through
    its C interface: the q scale without LOG2E, or the last kv tile of 64
    rows skipped. The longest sequences of the main path, where a dropped
    tile weighs least."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    ref = fa.attention_plain(q, k, v)
    assert fa.agreement(fa._launch(name, q, k, v), ref)["ok"]
    wrong_scale = fa._launch(name, q, k, v, q_scale=d**-0.5)
    assert not fa.agreement(wrong_scale, ref)["ok"]
    tile_skipped = fa._launch(name, q, k[:, :, :-64], v[:, :, :-64])
    assert not fa.agreement(tile_skipped, ref)["ok"]
