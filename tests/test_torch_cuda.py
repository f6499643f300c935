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
within 1e-3 of max |plain| and a relative RMS error of 1e-4, since the kernel
keeps about 16 mantissa bits in every product (split-bf16). K3 is held to
the bf16 limits; K5 states its own (``quant_matmul.MAX_ULPS`` and
``REL_RMSE_LIMIT``). Every check also bounds the relative RMS error, which
planted faults exceed (``test_*planted_faults*``).
"""

import dataclasses

import pytest
import torch

from lightdiffusion_next_tpu_torch import config
from lightdiffusion_next_tpu_torch.models import flux
from lightdiffusion_next_tpu_torch.ops import attention as attn_ops
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm



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
        # SD2.1's head layout (64 channels a head): a level-1 self-attention
        # at 1024^2 and a level-0 MSW-MSA window
        ("packed", 2, 10, 4096, 4096, 64, torch.bfloat16),
        ("packed", 8, 5, 4096, 4096, 64, torch.bfloat16),
        ("packed", 1, 2, 530, 650, 24, torch.bfloat16),   # the d <= 32 bucket
        ("packed", 1, 2, 520, 530, 40, torch.float32),    # the split kernel at d <= 64
        ("flash", 2, 8, 1024, 1024, 160, torch.bfloat16),
        ("flash", 1, 3, 577, 650, 80, torch.bfloat16),
        ("flash", 1, 2, 530, 1000, 160, torch.bfloat16),  # 64-row kv tiles, ragged
        ("flash", 1, 2, 600, 777, 128, torch.bfloat16),
        ("flash", 1, 2, 530, 700, 256, torch.bfloat16),   # bf16 on the split kernel
        ("flash", 1, 2, 530, 700, 36, torch.float32),     # d not a multiple of 8
        ("flash", 1, 1, 1024, 1024, 512, torch.float32),  # the VAE's head
        ("flash", 1, 1, 1000, 1100, 512, torch.float32),  # ragged Lq and Lk
        ("flash", 1, 1, 600, 600, 300, torch.float32),    # ragged d
        # past the f32 fold every 256 kv tiles: one fold and a ragged tail,
        # two heads at a ragged d, and the 2048^2 decode's 65 536 tokens,
        # where an unfolded sum drifted 2.3e-4 (limit 1e-4)
        ("flash", 1, 1, 1000, 4200, 512, torch.float32),
        ("flash", 1, 2, 530, 8300, 300, torch.float32),
        ("flash", 1, 1, 65536, 65536, 512, torch.float32),
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


@pytest.fixture(scope="module")
def no_fold_flash():
    """K2's C entry point built with its f32 fold out of reach
    (``kFoldTiles`` = 2^30): the running sum stays in the tensor cores'
    accumulator through every kv tile, as it did before the fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import ctypes
    import re
    import shutil
    import subprocess

    from lightdiffusion_next_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "no_fold"
    out.mkdir(parents=True, exist_ok=True)
    header = (cuda_build.CSRC / "flash_attention.cuh").read_text()
    header, n = re.subn(r"constexpr int kFoldTiles = \d+;", "constexpr int kFoldTiles = 1 << 30;",
                        header)
    assert n == 1
    (out / "flash_attention.cuh").write_text(header)  # found before -I's copy
    shutil.copy(cuda_build.CSRC / "flash_attention.cu", out / "flash_attention.cu")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                    "-o", str(out / "libflash_no_fold.so"), str(out / "flash_attention.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "libflash_no_fold.so")).ldt_flash_attention_fwd
    fn.argtypes = cuda_build.KERNELS["flash_attention"][2]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("lk", [5184, 16384, 65536])
@pytest.mark.parametrize("v_shift", [0.0, 1.0])
def test_f32_fold_holds_the_drift(cuda, no_fold_flash, monkeypatch, lk, v_shift):
    """K2's f32 path (the VAE head) at the USDU tile's, the 1024^2 and the
    2048^2 decode's kv lengths, v centred and v + 1: within its limits and
    within 3e-5 of the plain version's size (the bias, sum(out * plain) /
    sum(plain^2) - 1), with its sum folded into the output every 256 kv
    tiles. Without the fold the sum shrinks in proportion to the tiles (the
    tensor cores' accumulation does not round to nearest). Prints one line
    per case: both kernels against the plain version and against float64
    on 256 q rows, their bias and ms (run with -s)."""
    import json
    import math

    from lightdiffusion_next_tpu_torch.ops import cuda_build

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, 1, lk, 512), generator=gen, device="cuda") for _ in range(3))
    v = v + v_shift
    ref = fa.attention_plain(q, k, v)
    s64 = (q[0, 0, :256].double() @ k[0, 0].double().T) / math.sqrt(512)
    ref64 = torch.softmax(s64, -1) @ v[0, 0].double()

    def rel(x, y):
        x, y = x.double(), y.double()
        return ((x - y).pow(2).mean().sqrt() / y.pow(2).mean().sqrt()).item()

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3

    row = {"lk": lk, "v_shift": v_shift, "plain_vs_f64": rel(ref[0, 0, :256], ref64)}
    built = cuda_build.entry_point("flash_attention")
    for name, fn in (("folded", built), ("no_fold", no_fold_flash)):
        monkeypatch.setattr(cuda_build, "entry_point", lambda _name, fn=fn: fn)
        out = fa._launch("flash_attention", q, k, v)
        torch.cuda.synchronize()
        check = fa.agreement(out, ref)
        row[name] = {"rel_rmse": check["rel_rmse"], "ok": check["ok"],
                     "vs_f64": rel(out[0, 0, :256], ref64),
                     "bias": ((out.double() * ref.double()).sum()
                              / ref.double().pow(2).sum()).item() - 1.0,
                     "ms": ms(lambda: fa._launch("flash_attention", q, k, v))}
    monkeypatch.undo()
    print("f32 drift", json.dumps(row))
    assert row["folded"]["ok"], row
    assert abs(row["folded"]["bias"]) < 3e-5, row


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
    "name,b,h,lq,lk,d,dtype",
    [
        ("packed_flash_attention", 2, 8, 16384, 16384, 40, torch.bfloat16),  # K1 unwindowed
        ("flash_attention", 2, 8, 4096, 4096, 80, torch.bfloat16),
        ("flash_attention", 1, 1, 16384, 16384, 512, torch.float32),          # the VAE's call
        ("packed_flash_attention", 1, 2, 600, 700, 40, torch.bfloat16),      # ragged
        ("flash_attention", 1, 3, 577, 650, 80, torch.bfloat16),
        ("flash_attention", 1, 2, 530, 1000, 160, torch.bfloat16),
        ("flash_attention", 1, 1, 1000, 1100, 512, torch.float32),
    ],
)
def test_planted_faults_fail_the_check(cuda, name, b, h, lq, lk, d, dtype):
    """The check passes the kernel and fails it with a fault planted through
    its C interface: the q scale without LOG2E, or the last kv tile of 64
    rows skipped. The longest sequences of the main path, where a dropped
    tile weighs least, and a ragged shape of each (d, dtype) the kernels
    serve on the main path."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    ref = fa.attention_plain(q, k, v)
    assert fa.agreement(fa._launch(name, q, k, v), ref)["ok"]
    wrong_scale = fa._launch(name, q, k, v, q_scale=d**-0.5)
    assert not fa.agreement(wrong_scale, ref)["ok"]
    tile_skipped = fa._launch(name, q, k[:, :, :-64], v[:, :, :-64])
    assert not fa.agreement(tile_skipped, ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("l", [4352, 1280])
def test_flux_unfused_attention_shapes(cuda, l):
    """K2 at the unfused Flux attention's shapes, 24 heads of 128 in bf16
    over the 256 + 4096 tokens of a 1024^2 DiT call and the 256 + 1024 of
    a dy call: q and k normed and roped (contiguous), v a head-split view
    of the projection, as ``models.flux._attention`` hands them over;
    through the dispatch, against the plain version, with both planted
    faults caught."""
    from lightdiffusion_next_tpu_torch.ops import rope

    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn((1, l, 3 * 24 * 128), generator=gen, device="cuda").bfloat16()
    q, k, v = flux._split_heads(qkv, 24)
    ids = torch.cat([torch.zeros((1, 256, 3), device="cuda"),
                     flux.img_ids(1, 2 * int((l - 256) ** 0.5), 2 * int((l - 256) ** 0.5),
                                  device="cuda")], dim=1)
    q, k = rope.apply_rope(q.contiguous(), k.contiguous(),
                           rope.embed_nd(ids, flux.FLUX_DEV.axes_dim))
    launches = fa.flash_attention.launches
    out = attn_ops.attention_heads(q, k, v)
    assert fa.flash_attention.launches == launches + 1
    assert out.shape == (1, l, 24 * 128) and out.dtype == torch.bfloat16
    ref = fa.attention_plain(q, k, v)
    check = fa.agreement(out.reshape(1, l, 24, 128).transpose(1, 2), ref)
    assert check["ok"], check
    assert not fa.agreement(fa._launch("flash_attention", q, k, v, q_scale=128**-0.5),
                            ref)["ok"]
    assert not fa.agreement(fa._launch("flash_attention", q, k[:, :, :-64], v[:, :, :-64]),
                            ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,lk,d,dtype",
    [
        ("packed_flash_attention", 128, 40, torch.bfloat16),  # one 128-row kv tile
        ("flash_attention", 128, 80, torch.bfloat16),
        ("flash_attention", 64, 160, torch.bfloat16),         # one 64-row kv tile
        ("flash_attention", 16, 512, torch.float32),          # one 16-row kv tile
        ("flash_attention", 16, 256, torch.bfloat16),
    ],
)
def test_single_tile_pins_the_layout(cuda, name, lk, d, dtype):
    """One q tile of 64 rows against one kv tile: the first launch's tile
    images equal the layout mirror ``pack_kv`` bit for bit, and the result,
    which reads every k16 step of q and K and every V row exactly once
    through the descriptors, agrees with the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((1, 1, 64, d), (1, 1, lk, d), (1, 1, lk, d)))
    geom = fa.kv_geometry(d, dtype, packed=name == "packed_flash_attention")
    assert geom.tiles(lk) == 1
    scratch = torch.full((1, 1, geom.tile_bytes), 0xAB, dtype=torch.uint8, device="cuda")
    out = fa._launch(name, q, k, v, scratch=scratch)
    torch.cuda.synchronize()
    assert torch.equal(scratch, fa.pack_kv(k, v, geom))
    _check(out, q, k, v)


@pytest.mark.cuda
def test_kv_images_match_the_layout_mirror(cuda):
    """Strided views of a fused projection, several tiles and a ragged Lk:
    the first launch writes exactly ``pack_kv``'s images."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for name, d, dtype in (("packed_flash_attention", 40, torch.bfloat16),
                           ("flash_attention", 160, torch.bfloat16),
                           ("flash_attention", 512, torch.float32)):
        x = torch.randn((2, 700, 3 * 2 * d), generator=gen, device="cuda").to(dtype)
        q, k, v = (t.reshape(2, 700, 2, d).transpose(1, 2) for t in x.chunk(3, dim=-1))
        geom = fa.kv_geometry(d, dtype, packed=name == "packed_flash_attention")
        scratch = torch.full((4, geom.tiles(700), geom.tile_bytes), 0xAB, dtype=torch.uint8,
                             device="cuda")
        fa._launch(name, q, k, v, scratch=scratch)
        torch.cuda.synchronize()
        assert torch.equal(scratch, fa.pack_kv(k, v, geom)), (name, d, dtype)


def _q8_weight(k, n, gen):
    w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
    return ggml.transpose_for_matmul(ggml.quantize(w))


def _q8_check(out, ref):
    return fa.agreement(out, ref, max_ulps=qm.MAX_ULPS, rel_rmse_limit=qm.REL_RMSE_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (4352, 3072, 21504),   # single block linear1, the longest
    (4352, 15360, 3072),   # single block linear2, the deepest K
    (256, 4096, 10240),    # T5 wi
    (1000, 3072, 3072),    # ragged M
    # both tile configurations of the dispatch, ragged M on each:
    (1, 3072, 3072),       # 64 x 64 tiles, one row
    (77, 4096, 4096),      # 64 x 64
    (256, 3072, 3072),     # T5 / text stream: 64 x 64, 4 x 48 blocks
    (257, 3072, 9216),     # 256 x 128, one row in the second row of tiles
    (1100, 3072, 3072),    # 256 x 128
    (1100, 3072, 384),     # 64 x 64: 256 x 128 tiles would fill 15 SMs
])
def test_quant_matmul_matches_plain(cuda, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(4)
    t = _q8_weight(k, n, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    launches = qm.quant_matmul.launches
    out = qm.quant_matmul(x, t.qt, t.scales_t)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == launches + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    assert _q8_check(out, qm.quant_matmul_plain(x, t.qt, t.scales_t))["ok"]


@pytest.mark.cuda
def test_quant_matmul_planted_faults_fail_the_check(cuda):
    """The last K tile of 64 rows skipped, and every 32-row block read with
    its neighbour's scale row: both fail the check, at the deepest K."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    m, k, n = 4352, 15360, 3072
    t = _q8_weight(k, n, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    ref = qm.quant_matmul_plain(x, t.qt, t.scales_t)
    assert _q8_check(qm._launch(x, t.qt, t.scales_t), ref)["ok"]
    assert not _q8_check(qm._launch(x, t.qt, t.scales_t, k=k - 64), ref)["ok"]
    rolled = torch.roll(t.scales_t, -1, 0).contiguous()
    assert not _q8_check(qm._launch(x, t.qt, rolled), ref)["ok"]


def _fused_inputs(l, w, txt_len, gen, h=24, b=1):
    qkv = torch.randn((b, l, w), generator=gen, device="cuda").bfloat16()
    scales = [(1.0 + 0.3 * torch.randn((128,), generator=gen, device="cuda")).float()
              for _ in range(4)]
    side = int(max(l - 256, l // 2) ** 0.5)
    ids = torch.cat([torch.zeros((1, l - side * side, 3), device="cuda"),
                     flux.img_ids(1, 2 * side, 2 * side, device="cuda")], dim=1)
    cos, sin = flux.rope_cos_sin(ids, (16, 56, 56))
    kw = dict(num_heads=h, txt_len=txt_len, txt_q_scale=scales[2], txt_k_scale=scales[3])
    return qkv, scales, cos, sin, kw


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,w,txt_len", [
    (1, 4352, 21504, 0),   # single blocks: linear1's full output, MLP lanes unread
    (1, 4352, 9216, 256),  # double blocks: text rows first, their own scales
    (1, 1281, 9224, 17),   # ragged L, odd text length, 8 trailing lanes
    (1, 1280, 9216, 256),  # the half-res dy calls: double blocks
    (1, 1280, 21504, 0),   #   and single blocks
    (2, 1000, 9216, 200),  # two batch entries; ragged L; the text rows end inside
                           # the second q tile and the second kv tile
    (1, 77, 776, 0),       # L below one q tile, 2 heads
    (1, 200, 768, 70),     # L not a whole q tile, text rows ending inside tile 0
])
def test_fused_qkv_attention_matches_plain(cuda, b, l, w, txt_len):
    gen = torch.Generator(device="cuda").manual_seed(6)
    h = 24 if w >= 9216 else 2
    qkv, scales, cos, sin, kw = _fused_inputs(l, w, txt_len, gen, h=h, b=b)
    launches = fa.fused_qkv_attention.launches
    out = fa.fused_qkv_attention(qkv, scales[0], scales[1], cos, sin, **kw)
    torch.cuda.synchronize()
    assert fa.fused_qkv_attention.launches == launches + 1
    assert out.shape == (b, l, h * 128)
    ref = fa.fused_qkv_attention_plain(qkv, scales[0], scales[1], cos, sin, **kw)
    check = fa.agreement(out, ref)
    assert check["ok"], check


@pytest.mark.cuda
def test_fused_qkv_planted_faults_fail_the_check(cuda):
    """The last kv tile of 64 rows skipped, and the RoPE sine's sign flipped:
    both fail the check at the longest shape."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    l = 4352
    qkv, s, cos, sin, kw = _fused_inputs(l, 9216, 256, gen)
    ref = fa.fused_qkv_attention_plain(qkv, s[0], s[1], cos, sin, **kw)
    args = (24, 256, s[2], s[3], 1e-6)
    assert fa.agreement(fa._launch_fused(qkv, s[0], s[1], cos, sin, *args), ref)["ok"]
    skipped = fa._launch_fused(qkv, s[0], s[1], cos, sin, *args, lk=l - 64)
    assert not fa.agreement(skipped, ref)["ok"]
    assert not fa.agreement(fa._launch_fused(qkv, s[0], s[1], cos, -sin, *args), ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [24, 12, 6])
@pytest.mark.parametrize("txt_len", [0, 256])
def test_fused_qkv_interleaved_matches_plain(cuda, h, txt_len):
    """K3's head-interleaved stripes (the TP layout: a rank's whole heads,
    12 at tp = 2, 6 at tp = 4) at Flux's 4352 tokens against the plain
    version; the same qkv read with the proj-major offsets fails the
    check, and so does the input with each head's k and v stripes
    swapped."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv, s, cos, sin, kw = _fused_inputs(4352, 3 * h * 128, txt_len, gen, h=h)
    launches = fa.fused_qkv_attention.launches
    interleaved = fa.fused_qkv_attention.launches_interleaved
    out = fa.fused_qkv_attention(qkv, s[0], s[1], cos, sin, interleaved=True, **kw)
    torch.cuda.synchronize()
    assert fa.fused_qkv_attention.launches_interleaved == interleaved + 1
    assert fa.fused_qkv_attention.launches == launches
    ref = fa.fused_qkv_attention_plain(qkv, s[0], s[1], cos, sin, interleaved=True, **kw)
    check = fa.agreement(out, ref)
    assert check["ok"], check
    args = (h, txt_len, s[2], s[3], 1e-6)
    proj_major = fa._launch_fused(qkv, s[0], s[1], cos, sin, *args)
    assert not fa.agreement(proj_major, ref)["ok"]
    heads = qkv.reshape(1, 4352, h, 3, 128)
    swapped = heads[:, :, :, [0, 2, 1]].reshape(qkv.shape).contiguous()
    kv_swapped = fa._launch_fused(swapped, s[0], s[1], cos, sin, *args, interleaved=True)
    assert not fa.agreement(kv_swapped, ref)["ok"]


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((8, 256), device="cuda")
    qt = torch.zeros((256, 128), dtype=torch.int8, device="cuda")
    st = torch.zeros((8, 128), device="cuda")
    with pytest.raises(TypeError):
        qm.quant_matmul(x, qt, st)  # f32 x
    with pytest.raises(ValueError):
        qm.quant_matmul(x.bfloat16()[:, :200], qt[:200], st)  # K not a multiple of 256
    qkv = torch.zeros((1, 64, 3 * 128), device="cuda", dtype=torch.bfloat16)
    one = torch.ones((128,), device="cuda")
    cs = torch.zeros((64, 128), device="cuda")
    with pytest.raises(ValueError):
        fa.fused_qkv_attention(qkv, one, one, cs, cs, num_heads=2)  # width < 3*H*128
    with pytest.raises(TypeError):
        fa.fused_qkv_attention(qkv.float(), one, one, cs, cs, num_heads=1)


# --- W8A8: K7, K9, K10, K11 -------------------------------------------------
# K7 and K11 are held to their plain versions bit for bit, as is K9 with the
# "none" prologue; K9 "gelu" / "ln_mod" and K10 to the code limits stated in
# ops/quant_matmul.py (``codes_agreement``).


def _w8_weight(k, n, gen):
    return ggml.to_w8a8({"w": _q8_weight(k, n, gen)})["w"]


def _activations(m, k, gen):
    """bf16 rows with a mean of their own, as the DiT's activations have."""
    x = 2 * torch.randn((m, k), generator=gen, device="cuda")
    return (x + torch.randn((m, 1), generator=gen, device="cuda")).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,mode", [
    (4352, 3072, 21504, "bias"),       # single block linear1
    (4352, 15360, 3072, "residual"),   # single block linear2, the deepest K
    (256, 12288, 3072, "residual"),    # txt mlp.2: few row tiles
    (1000, 3072, 3072, "k7"),          # ragged M through K9 + K7
    (1, 3072, 9216, "k7"),             # one row
    (1281, 3072, 9216, "bias"),        # ragged M
])
def test_w8a8_matmuls_match_plain(cuda, m, k, n, mode):
    gen = torch.Generator(device="cuda").manual_seed(8)
    w = _w8_weight(k, n, gen)
    x = _activations(m, k, gen)
    if mode == "k7":
        before = (qm.w8a8_matmul.launches, qm.row_quantize_fused.launches)
        out = qm.w8a8_matmul(x, w.q, w.col_scales)
        torch.cuda.synchronize()
        assert (qm.w8a8_matmul.launches, qm.row_quantize_fused.launches) == (
            before[0] + 1, before[1] + 1)
        ref = qm.w8a8_matmul_plain(x, w.q, w.col_scales)
    else:
        xq, sx = qm.row_quantize_fused(x)
        gate = torch.randn((1, n), generator=gen, device="cuda")
        cs, b = w.col_scales * gate, 0.1 * torch.randn((1, n), generator=gen, device="cuda") * gate
        r = _activations(m, n, gen) if mode == "residual" else None
        launches = qm.w8a8_matmul_ep.launches
        out = qm.w8a8_matmul_ep(xq, sx, w.q, cs, b, residual=r)
        torch.cuda.synchronize()
        assert qm.w8a8_matmul_ep.launches == launches + 1
        ref = qm.w8a8_matmul_ep_plain(xq, sx, w.q, cs, b, residual=r)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    check = qm.matmul_agreement(out, ref)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("ep", [False, True])
def test_w8a8_matmul_planted_faults_fail_the_check(cuda, ep):
    """The last K tile of 128 skipped, and every column scaled by its
    neighbour's scale: both fail the check, at the deepest K."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    m, k, n = 4352, 15360, 3072
    w = _w8_weight(k, n, gen)
    xq, sx = qm.row_quantize_fused(_activations(m, k, gen))
    cs = w.col_scales.reshape(-1).contiguous()
    kw = {}
    if ep:
        kw = dict(bias=0.1 * torch.randn((n,), generator=gen, device="cuda"),
                  residual=_activations(m, n, gen), ep=True)
    ref = qm._epilogue_plain(xq, sx, w.q, cs, kw.get("bias"), kw.get("residual"))
    assert qm.matmul_agreement(qm._launch_w8a8(xq, sx.reshape(-1), w.q, cs, **kw), ref)["ok"]
    skipped = qm._launch_w8a8(xq, sx.reshape(-1), w.q, cs, k=k - 128, **kw)
    assert not qm.matmul_agreement(skipped, ref)["ok"]
    rolled = torch.roll(cs, -1).contiguous()
    assert not qm.matmul_agreement(qm._launch_w8a8(xq, sx.reshape(-1), w.q, rolled, **kw),
                                   ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("prologue,m,k", [
    ("ln_mod", 4352, 3072), ("none", 4096, 3072), ("gelu", 1024, 12288),
    ("ln_mod", 1000, 3072), ("gelu", 1, 12288), ("none", 4352, 15360)])
def test_row_quantize_matches_plain(cuda, prologue, m, k):
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = _activations(m, k, gen)
    s = 1 + 0.2 * torch.randn((1, k), generator=gen, device="cuda")
    t = 0.1 * torch.randn((1, k), generator=gen, device="cuda")
    launches = qm.row_quantize_fused.launches
    codes, sx = qm.row_quantize_fused(x, s, t, prologue=prologue)
    torch.cuda.synchronize()
    assert qm.row_quantize_fused.launches == launches + 1
    assert codes.shape == (m, k) and codes.dtype == torch.int8 and sx.shape == (m, 1)
    ref = qm.row_quantize_fused_plain(x, s, t, prologue=prologue)
    check = qm.codes_agreement(codes, sx, *ref, exact=prologue == "none")
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4352, 1281])
def test_row_quantize_concat_gelu_matches_plain(cuda, m):
    gen = torch.Generator(device="cuda").manual_seed(11)
    a, b = _activations(m, 3072, gen), _activations(m, 21504, gen)
    launches = qm.row_quantize_concat_gelu.launches
    codes, sx = qm.row_quantize_concat_gelu(a, b, 9216, 21504)
    torch.cuda.synchronize()
    assert qm.row_quantize_concat_gelu.launches == launches + 1
    assert codes.shape == (m, 15360)
    check = qm.codes_agreement(codes, sx, *qm.row_quantize_concat_gelu_plain(a, b, 9216, 21504))
    assert check["ok"], check


@pytest.mark.cuda
def test_row_quantize_planted_faults_fail_the_check(cuda):
    """K9: LayerNorm without the mean subtracted, and a scale of absmax /
    128; K10: the window shifted by 128 lanes, and the GELU dropped."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    m, k = 4352, 3072
    x = _activations(m, k, gen)
    s = 1 + 0.2 * torch.randn((1, k), generator=gen, device="cuda")
    t = 0.1 * torch.randn((1, k), generator=gen, device="cuda")
    ref = qm.row_quantize_fused_plain(x, s, t, prologue="ln_mod")
    assert qm.codes_agreement(*qm._launch_rowquant(x, "ln_mod", s, t, 1e-6), *ref)["ok"]
    for fault in (dict(center=0), dict(inv_qmax=1.0 / 128)):
        bad = qm._launch_rowquant(x, "ln_mod", s, t, 1e-6, **fault)
        assert not qm.codes_agreement(*bad, *ref)["ok"], fault
    a, b = _activations(m, 3072, gen), _activations(m, 21504, gen)
    ref = qm.row_quantize_concat_gelu_plain(a, b, 9216, 21504)
    assert qm.codes_agreement(*qm._launch_concat(a, b, 9216, 21504), *ref)["ok"]
    assert not qm.codes_agreement(*qm._launch_concat(a, b, 9216 - 128, 21504 - 128), *ref)["ok"]
    assert not qm.codes_agreement(*qm._launch_concat(a, b, 9216, 21504, gelu=0), *ref)["ok"]


def _finite_bf16_rows(device):
    """Every finite bf16 value sorted by magnitude (v and -v side by side),
    as 510 rows of 128: each row's scale resolves its own codes."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x.float())]
    x = x[torch.sort(x.float().abs(), stable=True).indices]
    return x.reshape(-1, 128).to(device)


@pytest.mark.cuda
def test_row_quantize_gelu_every_bf16(cuda):
    """K9's GELU (2^x and a reciprocal on the SFU) over every finite bf16
    input, under the unchanged codes_agreement limits."""
    x = _finite_bf16_rows(cuda)
    codes, sx = qm.row_quantize_fused(x, prologue="gelu")
    torch.cuda.synchronize()
    check = qm.codes_agreement(codes, sx, *qm.row_quantize_fused_plain(x, prologue="gelu"))
    assert check["ok"], check


def _rowquant_case(prologue, m, k, gen, ld=None):
    """K9's input (a view of row stride ``ld`` if given) and its s, t."""
    x = _activations(m, ld or k, gen)[:, :k]
    s = 1 + 0.2 * torch.randn((1, k), generator=gen, device="cuda")
    t = 0.1 * torch.randn((1, k), generator=gen, device="cuda")
    return x, s, t


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", ["none", "gelu", "ln_mod"])
@pytest.mark.parametrize("m,k,ld,grid", [
    (1, 3072, None, "picked"), (255, 3072, None, "picked"), (257, 3072, None, "picked"),
    (4353, 3072, None, "picked"), (4353, 3072, None, "one block"),
    (257, 12288, None, "one row each"), (300, 3072, 3456, "picked"),
    (129, 12288, 12800, "picked"), (300, 32768, None, "picked"),
    (33, 32768, 33024, "one block")])
def test_row_quantize_tails_strides_and_grids(cuda, prologue, m, k, ld, grid):
    """The persistent grid's tails (M = 1, 255, 257, 4353), one block
    walking every row or one row per group, row strides larger than K, and
    the longest rows (K = 32768: 16 chunks per lane, ln_mod's s and t
    through L1)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, s, t = _rowquant_case(prologue, m, k, gen, ld)
    vpt, w, g, blocks = qm.rowquant_geometry(m, k, prologue)
    blocks = {"picked": blocks, "one block": 1, "one row each": -(-m // g)}[grid]
    codes, sx = qm._launch_rowquant(x, prologue, s, t, 1e-6, geometry=(vpt, w, g, blocks))
    torch.cuda.synchronize()
    ref = qm.row_quantize_fused_plain(x, s, t, prologue=prologue)
    check = qm.codes_agreement(codes, sx, *ref, exact=prologue == "none")
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("m,lda", [(1, 3072), (257, 3072), (4353, 3584)])
def test_row_quantize_concat_gelu_tails_and_strides(cuda, m, lda):
    """K10 at the grid's tails, with ``a`` a view of row stride > K."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    a, b = _activations(m, lda, gen)[:, :3072], _activations(m, 21504, gen)
    codes, sx = qm.row_quantize_concat_gelu(a, b, 9216, 21504)
    torch.cuda.synchronize()
    check = qm.codes_agreement(codes, sx, *qm.row_quantize_concat_gelu_plain(a, b, 9216, 21504))
    assert check["ok"], check


def _w8a8_operands(m, k, n, mode, gen):
    """Codes, scales and the epilogue's operands of one W8A8 launch; the
    keyword arguments of ``_launch_w8a8`` for ``mode`` ("k7": K7's plain
    epilogue, "bias", "residual")."""
    w = _w8_weight(k, n, gen)
    xq, sx = qm.row_quantize_fused(_activations(m, k, gen))
    cs, kw = w.col_scales.reshape(-1).contiguous(), {}
    if mode != "k7":
        kw = dict(bias=0.1 * torch.randn((n,), generator=gen, device="cuda"), ep=True,
                  residual=_activations(m, n, gen) if mode == "residual" else None)
    return w, xq, sx, cs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k7", "bias", "residual"])
@pytest.mark.parametrize("tile", range(len(qm.W8A8_TILES)))
def test_w8a8_every_tile_and_mode_matches_plain(cuda, tile, mode):
    """Every tile of ``quant_matmul.W8A8_TILES`` in every epilogue, forced,
    at a ragged M (a partial last row tile for every tile height)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    m, k, n = 1000, 3072, 768
    w, xq, sx, cs, kw = _w8a8_operands(m, k, n, mode, gen)
    out = qm._launch_w8a8(xq, sx.reshape(-1), w.q, cs, tile=tile, **kw)
    torch.cuda.synchronize()
    ref = qm._epilogue_plain(xq, sx, w.q, cs, kw.get("bias"), kw.get("residual"))
    check = qm.matmul_agreement(out, ref)
    assert check["ok"], (tile, check)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(64, 128), (130, 256), (1, 384), (257, 640)])
def test_w8a8_short_k_matches_plain(cuda, m, k):
    """K shorter than the copy ring (1-3 steps of 128) and just past it."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for tile in range(len(qm.W8A8_TILES)):
        w, xq, sx, cs, kw = _w8a8_operands(m, k, 512, "residual", gen)
        out = qm._launch_w8a8(xq, sx.reshape(-1), w.q, cs, tile=tile, **kw)
        torch.cuda.synchronize()
        ref = qm._epilogue_plain(xq, sx, w.q, cs, kw["bias"], kw["residual"])
        check = qm.matmul_agreement(out, ref)
        assert check["ok"], (tile, check)


@pytest.mark.cuda
def test_w8a8_kernels_refuse_what_they_do_not_take(cuda):
    xq = torch.zeros((8, 192), dtype=torch.int8, device="cuda")
    q = torch.zeros((128, 192), dtype=torch.int8, device="cuda")
    ones = torch.ones((128,), device="cuda")
    with pytest.raises(ValueError):
        qm._launch_w8a8(xq, torch.ones((8,), device="cuda"), q, ones)  # K % 128
    xq2, q2 = xq[:, :128].contiguous(), q[:, :128].contiguous()
    with pytest.raises(ValueError):  # a 256-column tile on N = 128
        qm._launch_w8a8(xq2, torch.ones((8,), device="cuda"), q2, ones,
                        tile=[t[1] for t in qm.W8A8_TILES].index(256))
    with pytest.raises(TypeError):
        qm.row_quantize_fused(torch.zeros((8, 256), device="cuda"))  # f32 x
    with pytest.raises(ValueError):
        qm.row_quantize_fused(torch.zeros((8, 200), device="cuda", dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        qm.w8a8_matmul(torch.zeros((8, 256), device="cuda", dtype=torch.bfloat16),
                       q[:, :128].repeat(1, 2).contiguous(), ones, out_dtype=torch.float32)


# --- the scan layout: K6, K8 and the stacked K11 ----------------------------
# Each reads block idx of a stack in place with K5's, K7's or K11's device
# code: held to the same limits as those (K6 to K5's ulp limits, K8 and the
# stacked K11 bit for bit), and bit for bit to the unstacked kernel on a copy
# of the block. The largest stack (the single blocks' linear1, 2.5 GB) at its
# last block checks the 64-bit block offsets.


def _q8_stack(d, k, n, gen):
    qt3 = torch.randint(-127, 128, (d, k, n), generator=gen, device="cuda", dtype=torch.int8)
    scales3 = 1e-3 + 4e-4 * torch.rand((d, k // 32, n), generator=gen, device="cuda")
    return qt3, scales3


def _w8_stack(d, k, n, gen):
    q3 = torch.randint(-127, 128, (d, n, k), generator=gen, device="cuda", dtype=torch.int8)
    cs3 = (0.5 + torch.rand((d, 1, n), generator=gen, device="cuda")) / (127 * k**0.5)
    return q3, cs3


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,k,n,idx", [
    (38, 4352, 3072, 21504, 37),   # single linear1: the 2.5 GB stack, last block
    (24, 256, 4096, 10240, 0),     # T5 wi
    (24, 256, 10240, 4096, 23),    # T5 wo
    (19, 1000, 3072, 3072, 7),     # ragged M
    # the last block of a stack in both tile configurations
    (24, 1, 4096, 4096, 23),       # 64 x 64 tiles
    (19, 256, 3072, 3072, 18),     # 64 x 64
    (19, 257, 3072, 9216, 18),     # 256 x 128
    (38, 4352, 15360, 3072, 37),   # 256 x 128, single linear2: the deepest K
    (19, 1100, 3072, 384, 18),     # 64 x 64
])
def test_quant_matmul_stacked_matches_plain(cuda, d, m, k, n, idx):
    gen = torch.Generator(device="cuda").manual_seed(13)
    qt3, scales3 = _q8_stack(d, k, n, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    launches = qm.quant_matmul_stacked.launches
    out = qm.quant_matmul_stacked(x, qt3, scales3, idx)
    torch.cuda.synchronize()
    assert qm.quant_matmul_stacked.launches == launches + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    ref = qm.quant_matmul_stacked_plain(x, qt3, scales3, idx)
    assert _q8_check(out, ref)["ok"]
    assert torch.equal(out, qm._launch(x, qt3[idx].contiguous(), scales3[idx].contiguous()))
    # planted faults: the neighbouring block, the last K tile skipped
    assert not _q8_check(qm._launch(x, qt3, scales3, idx=idx - 1 if idx else 1), ref)["ok"]
    assert not _q8_check(qm._launch(x, qt3, scales3, k=k - 64, idx=idx), ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,k,n,mode,idx", [
    (38, 4352, 3072, 21504, "bias", 37),      # single linear1: the 2.5 GB stack
    (38, 4352, 15360, 3072, "residual", 0),   # single linear2, the deepest K
    (19, 256, 12288, 3072, "residual", 18),   # txt mlp.2
    (19, 1000, 3072, 3072, "k8", 5),          # ragged M through K9 + K8
    (19, 4096, 3072, 9216, "k8", 18),
])
def test_w8a8_stacked_matches_plain(cuda, d, m, k, n, mode, idx):
    gen = torch.Generator(device="cuda").manual_seed(14)
    q3, cs3 = _w8_stack(d, k, n, gen)
    x = _activations(m, k, gen)
    xq, sx = qm.row_quantize_fused(x)
    if mode == "k8":
        before = (qm.w8a8_matmul_stacked.launches, qm.row_quantize_fused.launches)
        out = qm.w8a8_matmul_stacked(x, q3, cs3, idx)
        torch.cuda.synchronize()
        assert (qm.w8a8_matmul_stacked.launches, qm.row_quantize_fused.launches) == (
            before[0] + 1, before[1] + 1)
        ref = qm.w8a8_matmul_stacked_plain(x, q3, cs3, idx)
        cs, kw = cs3, {}
        unstacked = qm._launch_w8a8(xq, sx.reshape(-1), q3[idx].contiguous(),
                                    cs3[idx].reshape(-1).contiguous())
    else:
        gate = torch.randn((1, n), generator=gen, device="cuda")
        cs = (cs3[idx] * gate).reshape(-1).contiguous()
        b = (0.1 * torch.randn((1, n), generator=gen, device="cuda") * gate).reshape(-1)
        r = _activations(m, n, gen) if mode == "residual" else None
        before = (qm.w8a8_matmul_ep_stacked.launches, qm.w8a8_matmul_ep.launches)
        out = qm.w8a8_matmul_ep(xq, sx, (q3, idx), cs, b, residual=r)
        torch.cuda.synchronize()
        assert (qm.w8a8_matmul_ep_stacked.launches, qm.w8a8_matmul_ep.launches) == (
            before[0] + 1, before[1])
        ref = qm.w8a8_matmul_ep_plain(xq, sx, (q3, idx), cs, b, residual=r)
        kw = dict(bias=b, residual=r, ep=True)
        unstacked = qm._launch_w8a8(xq, sx.reshape(-1), q3[idx].contiguous(), cs, **kw)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    check = qm.matmul_agreement(out, ref)
    assert check["ok"], check
    assert torch.equal(out, unstacked)
    # planted faults: the neighbouring block, the last K tile skipped
    sx1 = sx.reshape(-1)
    near = idx - 1 if idx else 1
    assert not qm.matmul_agreement(qm._launch_w8a8(xq, sx1, q3, cs, idx=near, **kw), ref)["ok"]
    assert not qm.matmul_agreement(qm._launch_w8a8(xq, sx1, q3, cs, k=k - 128, idx=idx, **kw),
                                   ref)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k8", "bias", "residual"])
@pytest.mark.parametrize("tile", range(len(qm.W8A8_TILES)))
def test_w8a8_stacked_equals_unstacked_at_first_and_last_block(cuda, tile, mode):
    """The stacked entry points launch the unstacked kernel at the block's
    offset: bit for bit the unstacked launch on a copy of the block, at
    blocks 0 and D - 1, in every tile and epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    d, m, k, n = 3, 300, 1024, 512
    q3, cs3 = _w8_stack(d, k, n, gen)
    xq, sx = qm.row_quantize_fused(_activations(m, k, gen))
    sx1 = sx.reshape(-1)
    kw = {}
    if mode != "k8":
        kw = dict(bias=0.1 * torch.randn((n,), generator=gen, device="cuda"), ep=True,
                  residual=_activations(m, n, gen) if mode == "residual" else None)
    for idx in (0, d - 1):
        cs = cs3[idx].reshape(-1).contiguous()
        out = qm._launch_w8a8(xq, sx1, q3, cs if kw else cs3, idx=idx, tile=tile, **kw)
        alone = qm._launch_w8a8(xq, sx1, q3[idx].contiguous(), cs, tile=tile, **kw)
        torch.cuda.synchronize()
        ref = qm._epilogue_plain(xq, sx, q3[idx], cs, kw.get("bias"), kw.get("residual"))
        assert torch.equal(out, alone), (tile, idx)
        check = qm.matmul_agreement(out, ref)
        assert check["ok"], (tile, idx, check)


@pytest.mark.cuda
def test_stacked_kernels_refuse_a_block_outside_the_stack(cuda):
    gen = torch.Generator(device="cuda").manual_seed(15)
    qt3, scales3 = _q8_stack(2, 256, 128, gen)
    x = torch.zeros((8, 256), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(IndexError):
        qm.quant_matmul_stacked(x, qt3, scales3, 2)
    q3, cs3 = _w8_stack(2, 256, 128, gen)
    with pytest.raises(IndexError):
        qm.w8a8_matmul_stacked(x, q3, cs3, -1)


# --- K4: the int8 attention --------------------------------------------------
# Held to its plain version at the limits stated in ops/sage_attention.py
# (``MAX_ULPS`` at max |plain|, ``REL_RMSE_LIMIT``): the same softmax blocks,
# scores in the base-2 domain, another order of the row sums of p. The
# preparation kernel is held to ``prepare_plain`` by ``prep_agreement``
# (codes within one, at most ``PREP_CODE_SHARE`` of them off; scales within
# ``PREP_SCALE_ULPS``).


def _sage_check(out, ref):
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    return fa.agreement(out, ref, max_ulps=sa.MAX_ULPS, rel_rmse_limit=sa.REL_RMSE_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 8, 16384, 16384, 40),   # level 0 unwindowed
    (8, 8, 1024, 1024, 40),     # level 0 under MSW windows
    (2, 8, 1024, 1024, 80),
    (2, 8, 256 * 2, 512, 160),
    (1, 3, 600, 700, 80),       # ragged: masked kv tail, partial q tile
    (1, 2, 577, 530, 40),       # d = 40: P.V padded to 48 columns
    (1, 2, 640, 640, 128),
    (1, 2, 300, 2100, 64),      # three softmax blocks, the last partial
    (1, 2, 200, 520, 32),
])
def test_sage_attention_matches_plain(cuda, b, h, lq, lk, d):
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    launches = (sa.sage_attention.launches, sa.prepare_kernel.launches)
    out = sa.sage_attention(q, k, v)
    torch.cuda.synchronize()
    assert (sa.sage_attention.launches, sa.prepare_kernel.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    check = _sage_check(out, sa.sage_attention_plain(q, k, v))
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,fused", [
    (2, 8, 4096, 4096, 40, True),    # head views of the fused q|k|v projection
    (2, 8, 1000, 1000, 80, True),    # ragged
    (1, 8, 1024, 1024, 160, True),
    (4, 2, 700, 300, 64, False),     # separate tensors, cross lengths
    (1, 3, 130, 2100, 32, False),    # three token slices
    (1, 2, 640, 640, 128, False),
])
def test_sage_prepare_matches_plain(cuda, b, h, lq, lk, d, fused):
    """The preparation kernel's images against ``prepare_plain``'s, read
    back through ``unpack_operands``: codes and scales to the stated limits,
    the padding zero (it is compared too), the inputs read through their
    strides."""
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(19)
    if fused:
        x = torch.randn((b, lq, 3 * h * d), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in x.chunk(3, dim=-1))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16() + 0.5
                   for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    launches = sa.prepare_kernel.launches
    ops = sa.prepare_kernel(q, k, v)
    torch.cuda.synchronize()
    assert sa.prepare_kernel.launches == launches + 1
    ref = sa.prepare_plain(q, k, v)
    assert ops.qimg.shape == ref.qimg.shape and ops.kvimg.shape == ref.kvimg.shape
    check = sa.prep_agreement(ops, ref, d)
    assert check["ok"], check
    got, want = sa.unpack_operands(ops, d), sa.unpack_operands(ref, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])  # q: exact


@pytest.mark.cuda
def test_sage_attention_planted_faults_fail_the_check(cuda):
    """The last kv tile skipped, and sk not applied: both fail the check at
    the longest sequence, where a dropped tile weighs least; the sound
    launch on the same operands passes."""
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn((2, 8, 16384, 40), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    ref = sa.sage_attention_plain(q, k, v)
    ops = sa.prepare_kernel(q, k, v)
    kt = ops.kvimg.shape[1]
    assert _sage_check(sa._launch(q, ops), ref)["ok"]
    assert not _sage_check(sa._launch(q, ops, kv_tiles=kt - 1), ref)["ok"]
    assert not _sage_check(sa._launch(q, ops, use_sk=False), ref)["ok"]


@pytest.mark.cuda
def test_sage_kernels_refuse_what_they_do_not_take(cuda):
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    q = torch.zeros((1, 2, 512, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sa.sage_attention(q, q, q)                     # head dim 48
    q = torch.zeros((1, 2, 512, 40), device="cuda")
    with pytest.raises(TypeError):
        sa.sage_attention(q, q, q)                     # f32
    x = torch.zeros((1, 2, 512, 41), device="cuda", dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError):
        sa.prepare_kernel(x, x, x)                     # rows not 4-byte aligned
    q = torch.zeros((1, 2, 512, 40), device="cuda", dtype=torch.bfloat16)
    ops = sa.prepare_kernel(q, q, q)
    with pytest.raises(RuntimeError):
        sa._launch(q, ops, kv_tiles=ops.kvimg.shape[1] + 1)


@pytest.mark.cuda
def test_sage_dispatch_launches_k4(cuda):
    """With ``sage_attention`` on, the UNet's long-sequence attention goes to
    K4 at every head dim (ahead of K1), short kv to sdpa, and the VAE's
    attention stays on K2."""
    import dataclasses

    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(18)
    q40, q80 = (torch.randn((1, 1024, 8 * d), generator=gen, device="cuda").bfloat16()
                for d in (40, 80))
    vae_q = torch.randn((1, 32, 32, 512), generator=gen, device="cuda")
    saved = config.get_config()
    config.set_config(dataclasses.replace(saved, sage_attention=True))
    try:
        before = (sa.sage_attention.launches, fa.packed_flash_attention.launches,
                  fa.flash_attention.launches)
        attn_ops.attention(q40, q40, q40, heads=8)
        attn_ops.attention(q80, q80, q80, heads=8)
        attn_ops.attention(q80, q80[:, :77], q80[:, :77], heads=8)  # short kv: sdpa
        attn_ops.vae_attention_core(vae_q, vae_q, vae_q)
        after = (sa.sage_attention.launches, fa.packed_flash_attention.launches,
                 fa.flash_attention.launches)
    finally:
        config.set_config(saved)
    assert after == (before[0] + 2, before[1], before[2] + 1)


# --- the WebUI's toggles and the UNet's FBCache on the card -------------------

WEBUI_UNET = dict(model_channels=160, channel_mult=(1, 2), num_res_blocks=(1, 1),
                  transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
                  num_heads=4)  # level 0: d = 40 over 32 x 32 = 1024 tokens; level 1: sdpa


@pytest.fixture(scope="module")
def webui_models():
    """A small UNet (K1 or K2 at level 0 only), CLIP and VAE (mid-block at
    d = 512, K2 in f32) on the card from seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lightdiffusion_next_tpu_torch.models import base, unet
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import facade
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    ucfg = unet.UNetConfig(**WEBUI_UNET, dtype=torch.bfloat16)
    vcfg = vae_mod.VAEConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1)
    params = unet.init_params(ucfg, seed=0)
    models = {}
    for fuse in (True, False):
        saved = config.get_config()
        config.set_config(dataclasses.replace(saved, qkv_fuse=fuse))
        try:
            models[fuse] = base.sd15_model(params, cfg=ucfg, device="cuda")
        finally:
            config.set_config(saved)
    vae = vae_mod.VAE(vae_mod.init_params(vcfg, seed=1), vcfg, device="cuda")
    clip = facade.sd1_clip_from_params(te.init_params(num_layers=2, width=64, heads=4, seed=2),
                                       device="cuda")
    return models, clip, vae


def _webui_generate(tmp_path, models, clip, vae, model=None, **kw):
    """One Generate through the WebUI handler with the given models (20
    ``dpmpp_2m_cfgpp`` steps at CFG 7, no multi-scale, no MSW-MSA): the
    launches of every kernel wrapper during it, the final latent and the
    statuses. The process-wide config comes back as it was."""
    from lightdiffusion_next_tpu_torch.app import webui
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    wrappers = (fa.packed_flash_attention, fa.flash_attention, sa.sage_attention,
                sa.prepare_kernel)
    before = [w.launches for w in wrappers]
    last = {}
    saved, settings = config.get_config(), webui.SETTINGS_FILE
    webui.SETTINGS_FILE = str(tmp_path / "webui_settings.json")
    try:
        statuses = [s for _, s in webui.generate_images_with_preview(
            output_dir=str(tmp_path), prompt="a cat", w=256, h=256, seed=7,
            model=model or models[True], clip=clip, vae=vae, prio_speed=True,
            enable_multiscale=False, hidiffusion=False, autohdr=False,
            progress_callback=lambda info: last.update(x=info["x"]), **kw)]
    finally:
        config.set_config(saved)
        webui.SETTINGS_FILE = settings
    launches = [w.launches - b for w, b in zip(wrappers, before)]
    return dict(zip(("k1", "k2", "k4", "prepare"), launches)), last["x"], statuses


def _level0_sites():
    from lightdiffusion_next_tpu_torch.models import unet

    cfg = unet.UNetConfig(**WEBUI_UNET)
    return [block for block, level, _, _ in unet.attention_blocks(cfg) if level == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("toggle", ["defaults", "sage_attention", "packed_attn_off"])
def test_webui_toggle_launch_plans(cuda, webui_models, tmp_path, toggle):
    """The toggles from the WebUI's Generate, the kernels launched from its
    worker thread: 20 model calls x the level-0 attention sites on K1 (K2
    with ``packed_attn`` off, K4 and its preparation with
    ``sage_attention``), and the VAE's one f32 K2 call."""
    models, clip, vae = webui_models
    kw = {"sage_attention": {"sage_attention": True},
          "packed_attn_off": {"packed_attn": False}}.get(toggle, {})
    launches, x, statuses = _webui_generate(tmp_path, models, clip, vae, **kw)
    n = 20 * len(_level0_sites())
    want = {"defaults": dict(k1=n, k2=1, k4=0, prepare=0),
            "sage_attention": dict(k1=0, k2=1, k4=n, prepare=n),
            "packed_attn_off": dict(k1=0, k2=n + 1, k4=0, prepare=0)}[toggle]
    assert statuses[-1] == "done" and launches == want
    assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_webui_qkv_fuse_off_same_launches(cuda, webui_models, tmp_path):
    """The UNet built with ``qkv_fuse`` off launches what the joined one
    does, and its final latent stays within 2e-2 relative RMS of the joined
    run's (bf16 products of other widths)."""
    models, clip, vae = webui_models
    joined, ref, _ = _webui_generate(tmp_path, models, clip, vae)
    unjoined, x, statuses = _webui_generate(tmp_path, models, clip, vae, model=models[False],
                                            qkv_fuse=False)
    assert statuses[-1] == "done" and unjoined == joined
    rel = ((x - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    assert rel <= 2e-2, rel


@pytest.mark.cuda
def test_unet_fbcache_hits_launch_plan(cuda, webui_models, tmp_path):
    """FBCache forced to hit on the UNet: a hit runs input blocks 0 and 1,
    so it launches K1 once (input block 1's self-attention); a miss
    launches every level-0 site. Threshold 0 hits never and gives the run
    without the cache bit for bit."""
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    models, clip, vae = webui_models
    forced = models[True].with_options(fbcache=fbcache.FBCacheConfig(
        residual_diff_threshold=1e30, max_consecutive_cache_hits=2))
    fbcache.history.clear()
    launches, x, statuses = _webui_generate(tmp_path, models, clip, vae, model=forced)
    hits = list(fbcache.history)
    assert statuses[-1] == "done" and len(hits) == 20 and 0 < sum(hits) < 20
    sites = len(_level0_sites())
    assert ("input", 1) in _level0_sites()
    assert launches == dict(k1=sum(1 if h else sites for h in hits), k2=1, k4=0, prepare=0)
    assert bool(torch.isfinite(x).all())
    zero = models[True].with_options(fbcache=fbcache.FBCacheConfig(0.0))
    fbcache.history.clear()
    _, x0, _ = _webui_generate(tmp_path, models, clip, vae, model=zero)
    assert fbcache.history == [False] * 20
    _, plain, _ = _webui_generate(tmp_path, models, clip, vae)
    assert torch.equal(x0, plain)


@pytest.mark.cuda
def test_kernel_backward_guard_on_the_card(cuda):
    """Under grad K2 and K5 still launch (their launch counts move, the
    outputs match the plain versions), the results carry the guard's node,
    and the backward raises ``NoBackwardError`` instead of handing q, k, v
    or x a zero gradient."""
    from lightdiffusion_next_tpu_torch.ops import grad_guard

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 2, 600, 128), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    q.requires_grad_(True)
    launches = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == launches + 1 and out.grad_fn is not None
    _check(out.detach(), q.detach(), k, v)
    with pytest.raises(grad_guard.NoBackwardError, match=r"flash_attention \(K2\)"):
        out.float().sum().backward()
    x = torch.randn((256, 512), generator=gen, device="cuda").bfloat16().requires_grad_(True)
    w = ggml.transpose_for_matmul(ggml.quantize(
        torch.randn((256, 512), generator=gen, device="cuda")))
    launches = qm.quant_matmul.launches
    y = qm.quant_matmul(x, w.qt, w.scales_t)
    assert qm.quant_matmul.launches == launches + 1 and y.grad_fn is not None
    with pytest.raises(grad_guard.NoBackwardError, match=r"quant_matmul \(K5\)"):
        y.float().sum().backward()


@pytest.mark.cuda
def test_prefetch_loader_side_stream_and_pinned_copies(cuda, monkeypatch):
    """On the GPU the loader stages each leaf in pinned host memory and
    copies it with ``non_blocking=True`` on its side stream, not the
    consumer's; the consumer's stream waits for the copy and records the
    batch's use, and the values arrive whole."""
    import numpy as np

    from lightdiffusion_next_tpu_torch.parallel import data as data_mod

    copies = []
    real_to = torch.Tensor.to

    def spy(self, *a, **kw):
        out = real_to(self, *a, **kw)
        if out.is_cuda and not self.is_cuda:
            copies.append((self.is_pinned(), kw.get("non_blocking", False),
                           torch.cuda.current_stream().cuda_stream))
        return out

    recorded = []
    real_record = torch.Tensor.record_stream
    monkeypatch.setattr(torch.Tensor, "to", spy)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: (recorded.append(s.cuda_stream), real_record(self, s)))
    src = [{"x": np.full((4, 1024), i, np.float32), "i": np.int32(i)} for i in range(3)]
    main = torch.cuda.current_stream().cuda_stream
    seen = []
    loader = data_mod.PrefetchLoader(iter(src), device="cuda")
    for b in loader:
        assert b["x"].is_cuda and b["i"].is_cuda
        seen.append((float(b["x"].sum().item()), int(b["i"].item())))
    assert seen == [(4 * 1024 * i, i) for i in range(3)]
    assert len(copies) == 6 and all(p and nb and s != main for p, nb, s in copies)
    assert recorded == [main] * 6 and loader.transferred == 3


# --- the flag variants: K4's (int8_mxu, pv_int8) and the bf16-rate W8A8 -----
# The sage variants are held to their plain version at K4's limits; the
# bf16-rate W8A8 matmuls at K5's limits, ``_q8_check`` (the f32 sums may
# round past 2^24, in another order than the plain version's).

SAGE_FLAG_PAIRS = [(False, True), (True, False), (False, False)]  # (int8_mxu, pv_int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_mxu,pv_int8", SAGE_FLAG_PAIRS)
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (1, 3, 600, 700, 80),       # ragged: masked kv tail, partial q tile
    (1, 2, 577, 530, 40),       # d = 40: DP 64, int8 V padded to 48 channels
    (1, 2, 300, 2100, 160),     # kv tiles of 64, three softmax blocks
    (1, 2, 640, 640, 128),
    (1, 2, 200, 520, 32),
    (2, 2, 256, 1024, 64),
])
def test_sage_variants_match_plain(cuda, b, h, lq, lk, d, int8_mxu, pv_int8):
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    counter = sa.VARIANT_COUNTERS[(int8_mxu, pv_int8)]
    launches = (getattr(sa.sage_attention, counter), sa.sage_attention.launches,
                sa.prepare_kernel.launches)
    out = sa.sage_attention(q, k, v, int8_mxu=int8_mxu, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert (getattr(sa.sage_attention, counter), sa.sage_attention.launches,
            sa.prepare_kernel.launches) == (launches[0] + 1, launches[1], launches[2] + 1)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    check = _sage_check(out, sa.sage_attention_plain(q, k, v, pv_int8=pv_int8))
    assert check["ok"], check
    flags = dict(pv_int8=pv_int8, int8_mxu=int8_mxu)
    ops = sa.prepare_kernel(q, k, v, **flags)
    prep = sa.prep_agreement(ops, sa.prepare_plain(q, k, v, **flags), d)
    assert prep["ok"], prep


@pytest.mark.cuda
@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (1, 2, 577, 530, 40),       # ragged: masked kv tail, partial q tile
    (1, 2, 200, 520, 32),
    (2, 2, 256, 1024, 64),
    (1, 3, 600, 2100, 80),      # three softmax blocks of 768
    (1, 2, 640, 640, 128),
    (1, 2, 300, 2100, 160),     # kv tiles of 64, the ring of two stages
])
def test_sage_bf16_rate_equals_int8_bit_for_bit(cuda, b, h, lq, lk, d, pv_int8):
    """Q.K^T at the bf16 rate multiplies the same integers exactly, in the
    same order of f32 operations: int8_mxu=False gives K4's output bit for
    bit, and (False, False) gives (True, False)'s."""
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(26)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    bf16 = sa.sage_attention(q, k, v, int8_mxu=False, pv_int8=pv_int8)
    int8 = sa.sage_attention(q, k, v, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert torch.equal(bf16, int8), (bf16.float() - int8.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("int8_mxu,pv_int8", SAGE_FLAG_PAIRS)
def test_sage_variant_planted_faults_fail_the_check(cuda, int8_mxu, pv_int8):
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn((2, 4, 4096, 40), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    ref = sa.sage_attention_plain(q, k, v, pv_int8=pv_int8)
    ops = sa.prepare_kernel(q, k, v, pv_int8=pv_int8, int8_mxu=int8_mxu)
    kt = ops.kvimg.shape[1]
    assert _sage_check(sa._launch_variant(q, ops, int8_mxu, pv_int8), ref)["ok"]
    assert not _sage_check(sa._launch_variant(q, ops, int8_mxu, pv_int8, kv_tiles=kt - 1),
                           ref)["ok"]
    assert not _sage_check(sa._launch_variant(q, ops, int8_mxu, pv_int8, use_sk=False),
                           ref)["ok"]
    with pytest.raises(ValueError):  # operands of the other V layout
        sa._launch_variant(q, sa.prepare_kernel(q, k, v, pv_int8=not pv_int8,
                                                int8_mxu=int8_mxu), int8_mxu, pv_int8)
    with pytest.raises(ValueError):  # operands of the other Q and K layout
        sa._launch_variant(q, sa.prepare_kernel(q, k, v, pv_int8=pv_int8,
                                                int8_mxu=not int8_mxu), int8_mxu, pv_int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,mode", [
    (1000, 3072, 3072, "k7"),          # ragged M through K9
    (256, 12288, 3072, "k8"),
    (1, 3072, 9216, "bias"),           # one row
    (300, 1024, 384, "residual"),
    (256, 12288, 3072, "stacked_residual"),
])
def test_w8a8_bf16_rate_matches_plain(cuda, m, k, n, mode):
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = _activations(m, k, gen)
    if mode in ("k8", "stacked_residual"):
        q3 = torch.randint(-127, 128, (2, n, k), generator=gen, device="cuda", dtype=torch.int8)
        cs3 = (0.5 + torch.rand((2, 1, n), generator=gen, device="cuda")) * (3 / (127 * k**0.5))
        q, cs, idx = q3, cs3, 1
    else:
        w = _w8_weight(k, n, gen)
        q, cs, idx = w.q, w.col_scales, None
    if mode == "k7":
        out = qm.w8a8_matmul(x, q, cs, int8_mxu=False)
        ref = qm.w8a8_matmul_plain(x, q, cs, int8_mxu=False)
    elif mode == "k8":
        out = qm.w8a8_matmul_stacked(x, q, cs, idx, int8_mxu=False)
        ref = qm.w8a8_matmul_stacked_plain(x, q, cs, idx, int8_mxu=False)
    else:
        fn = qm.w8a8_matmul_ep_stacked if idx is not None else qm.w8a8_matmul_ep
        xq, sx = qm.row_quantize_fused(x)
        cs_eff = (cs if idx is None else cs[idx]) * 1.5
        b = 0.1 * torch.randn((1, n), generator=gen, device="cuda")
        r = _activations(m, n, gen) if "residual" in mode else None
        operand = q if idx is None else (q, idx)
        launches = (fn.launches_bf16, fn.launches)
        out = qm.w8a8_matmul_ep(xq, sx, operand, cs_eff, b, residual=r, int8_mxu=False)
        torch.cuda.synchronize()
        assert (fn.launches_bf16, fn.launches) == (launches[0] + 1, launches[1])
        ref = qm.w8a8_matmul_ep_plain(xq, sx, operand, cs_eff, b, residual=r, int8_mxu=False)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    check = _q8_check(out, ref)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k7", "bias", "residual"])
@pytest.mark.parametrize("tile", range(len(qm.W8A8_BF16_TILES)))
def test_w8a8_bf16_rate_every_tile_and_mode_matches_plain(cuda, tile, mode):
    """Every tile of ``quant_matmul.W8A8_BF16_TILES`` in every epilogue,
    forced, at a ragged M and an odd number of K steps of 64."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    m, n = 1000, 768
    w, xq, sx, cs, kw = _w8a8_operands(m, 3072, n, mode, gen)
    k = 3008  # 47 steps of 64 summed: the unrolled pair's second half skipped once
    out = qm._launch_w8a8(xq, sx.reshape(-1), w.q, cs, k=k, tile=tile, int8_mxu=False, **kw)
    torch.cuda.synchronize()
    ref = qm._epilogue_plain(xq[:, :k], sx, w.q[:, :k], cs, kw.get("bias"), kw.get("residual"),
                             int8_mxu=False)
    check = _q8_check(out, ref)
    assert check["ok"], (tile, check)
    exact = qm._epilogue_plain(xq[:, :k], sx, w.q[:, :k], cs, kw.get("bias"), kw.get("residual"))
    assert qm.matmul_agreement(out, exact)["ok"], tile


@pytest.mark.cuda
def test_w8a8_bf16_rate_planted_faults_fail_the_check(cuda):
    """The last K step of 64 skipped, and cs not applied: both fail the
    check at the deepest K."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    m, k, n = 4352, 15360, 3072
    w = _w8_weight(k, n, gen)
    xq, sx = qm.row_quantize_fused(_activations(m, k, gen))
    cs = w.col_scales.reshape(-1).contiguous()
    ref = qm._epilogue_plain(xq, sx, w.q, cs, int8_mxu=False)
    sx1 = sx.reshape(-1)
    assert _q8_check(qm._launch_w8a8(xq, sx1, w.q, cs, int8_mxu=False), ref)["ok"]
    skipped = qm._launch_w8a8(xq, sx1, w.q, cs, k=k - qm.W8A8_BF16_BK, int8_mxu=False)
    assert not _q8_check(skipped, ref)["ok"]
    unscaled = qm._launch_w8a8(xq, sx1, w.q, torch.ones_like(cs), int8_mxu=False)
    assert not _q8_check(unscaled, ref)["ok"]


@pytest.mark.cuda
def test_native_split_on_the_card_machine(cuda):
    """The C++ Q8_0 split builds with this machine's g++ and equals its
    plain version bit for bit, on blocks enough for several threads."""
    from lightdiffusion_next_tpu_torch.utils import native

    gen = torch.Generator().manual_seed(24)
    blocks = torch.randint(0, 256, (300_000, 34), generator=gen, dtype=torch.uint8)
    blocks[:, 1] &= 0x7B  # finite f16 scales
    q, s = native.split_q8_0(blocks)
    pq, ps = native.split_q8_0_plain(blocks)
    assert torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32))
