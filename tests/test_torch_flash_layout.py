"""K1 and K2's kv tile images (``flash_attention.kv_geometry``, ``pack_kv``,
``unpack_kv``), the generated ``wgmma`` forms, and K2's plain version at
d = 160 against the JAX kernel.

The CUDA kernels read k and v from a scratch that their first launch writes
(``csrc/flash_attention.cuh``, ``flash_kv_kernel``). ``pack_kv`` is the
plain mirror of that launch; the card tests (``tests/test_torch_cuda.py``)
hold the launch to it bit for bit, and these tests pin the mirror itself:
exact round trips for bf16, the 128-byte swizzle at chosen bytes, zero
padding, and f32 split into bf16 hi + lo within 2^-16 relative (each half
rounds to nearest: |x - hi - lo| <= 2^-9 |x - hi| <= 2^-18 |x|).

The d = 160 case runs the Pallas kernel in interpret mode, as the JAX
package's own tests do on the CPU; tolerance as ``test_torch_attention.py``'s
f32 cases (atol 2e-5, rtol 1e-4: only the summation order differs).
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu_torch.ops import cuda_build
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa


def _kv(seed, b, h, lk, d, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, lk, d)).astype(np.float32))
                 .to(dtype) for _ in range(2))


# (d, dtype, K1) at each main-path head dim, plus the split kernel's bf16
LAYOUTS = [(40, torch.bfloat16, True), (80, torch.bfloat16, False),
           (160, torch.bfloat16, False), (512, torch.float32, False),
           (256, torch.bfloat16, False)]


@pytest.mark.parametrize("d,dtype,packed", LAYOUTS)
def test_pack_unpack_round_trip_and_zero_padding(d, dtype, packed):
    b, h, lk = 1, 2, 300  # a ragged last tile at every tile height
    k, v = _kv(0, b, h, lk, d, dtype)
    geom = tfa.kv_geometry(d, dtype, packed=packed)
    img = tfa.pack_kv(k, v, geom)
    assert img.dtype == torch.uint8
    assert img.shape == (b * h, geom.tiles(lk), geom.tile_bytes)
    ks, vs = tfa.unpack_kv(img, geom)
    assert len(ks) == len(vs) == geom.parts
    for parts, x in ((ks, k), (vs, v)):
        rows = geom.tiles(lk) * geom.bn
        assert all(p.dtype == torch.bfloat16 and p.shape[:2] == (b * h, rows) for p in parts)
        back = sum(p.float() for p in parts)
        assert (back[:, lk:] == 0).all(), "rows past Lk must be zero"
        assert (back[:, :, d:] == 0).all(), "columns past d must be zero"
        real = back[:, :lk, :d].reshape(x.shape)
        if dtype == torch.bfloat16:
            assert torch.equal(real, x.float())
        else:
            assert torch.equal(parts[0][:, :lk, :d].reshape(x.shape), x.bfloat16())


@pytest.mark.parametrize("d", [36, 300, 512])
def test_f32_hi_plus_lo_reconstructs_k_and_v(d):
    k, v = _kv(1, 1, 1, 100, d, torch.float32)
    geom = tfa.kv_geometry(d, torch.float32)
    assert geom.split and geom.parts == 2
    ks, vs = tfa.unpack_kv(tfa.pack_kv(k, v, geom), geom)
    for (hi, lo), x in ((ks, k), (vs, v)):
        x = x.reshape(100, d)
        back = hi[0, :100, :d].float() + lo[0, :100, :d].float()
        assert ((back - x).abs() <= 2.0**-16 * x.abs()).all()
        assert not torch.equal(hi[0, :100, :d].float(), x), "lo must carry bits"


def _bf16_bytes(x):
    return bytes(torch.tensor([x], dtype=torch.bfloat16).view(torch.uint8).tolist())


@pytest.mark.parametrize("d,dtype,packed", LAYOUTS[:3])
def test_swizzle_puts_each_value_where_the_kernel_reads_it(d, dtype, packed):
    """Chosen elements at the byte the kernel's descriptors address: K row r,
    column c of a tile at block c // 64, row r, 16-byte chunk (c % 64) // 8
    XOR (r % 8); V transposed, its kv row r at row c of block r // 64,
    chunk (r % 64) // 8 XOR (c % 8)."""
    lk = 200
    k, v = _kv(2, 1, 1, lk, d, dtype)
    geom = tfa.kv_geometry(d, dtype, packed=packed)
    img = tfa.pack_kv(k, v, geom)[0]
    for row, c in ((0, 0), (1, 9), (7, d - 1), (130, 17), (lk - 1, d // 2), (63, 33 % d)):
        t, r = divmod(row, geom.bn)
        at = (c // 64) * geom.bn * 128 + r * 128 + ((((c % 64) // 8) ^ (r % 8)) << 4) \
            + (c % 8) * 2
        assert bytes(img[t, at:at + 2].tolist()) == _bf16_bytes(k[0, 0, row, c].item())
        at = geom.k_bytes + (r // 64) * geom.dv * 128 + c * 128 \
            + ((((r % 64) // 8) ^ (c % 8)) << 4) + (r % 8) * 2
        assert bytes(img[t, at:at + 2].tolist()) == _bf16_bytes(v[0, 0, row, c].item())


def test_geometry_of_the_main_path():
    """The tiles each main-path (d, dtype) takes: d = 40 pads K to the k16
    step (48 of 64 columns read) and V to 40 rows; d = 160 takes 64-row kv
    tiles; the VAE's f32 head 16-row tiles of hi and lo halves."""
    g = tfa.kv_geometry(40, torch.bfloat16, packed=True)
    assert (g.split, g.bn, g.blocks, g.dv, g.parts, g.tile_bytes) == \
        (False, 128, 1, 40, 1, 128 * 128 + 2 * 40 * 128)
    g = tfa.kv_geometry(80, torch.bfloat16)
    assert (g.bn, g.blocks, g.dv, g.tile_bytes) == (128, 2, 80, 2 * 128 * 128 + 2 * 80 * 128)
    g = tfa.kv_geometry(160, torch.bfloat16)
    assert (g.bn, g.blocks, g.dv, g.tile_bytes) == (64, 3, 160, 3 * 64 * 128 + 160 * 128)
    g = tfa.kv_geometry(512, torch.float32)
    assert (g.split, g.bn, g.blocks, g.parts, g.tile_bytes) == (True, 16, 8, 2, 65536)
    # K2 buckets bf16 d <= 64 at 64; K1 at 32, 40 and 64
    assert tfa.kv_geometry(40, torch.bfloat16).dv == 64
    assert tfa.kv_geometry(24, torch.bfloat16, packed=True).dv == 32
    assert tfa.kv_geometry(300, torch.float32).blocks == 8


def test_wgmma_forms_header_is_generated():
    """``csrc/wgmma_forms.cuh`` is what ``csrc/wgmma_forms.py`` writes."""
    path = cuda_build.CSRC / "wgmma_forms.py"
    spec = importlib.util.spec_from_file_location("wgmma_forms", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (cuda_build.CSRC / "wgmma_forms.cuh").read_text() == gen.header()
    text = gen.header()
    for kind, n, tnsp in gen.FORMS:
        assert f"m64n{n}k" in text
    # every P.V width the flash kernels issue has its register-A form
    for d in (32, 40, 64, 80, 96, 128, 160):
        assert ("rs", d, 0) in gen.FORMS
    for dh in (64, 128, 256):
        assert ("rs", dh, 1) in gen.FORMS


def test_plain_matches_pallas_f32_at_d160():
    """K2's plain version at SD1.5's level-2 head dim against the JAX kernel
    in interpret mode, ragged Lq and Lk."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 1, 520, 160), (1, 1, 530, 160), (1, 1, 530, 160)))
    ref = np.asarray(jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v))))
    out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
