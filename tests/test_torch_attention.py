"""The port's attention (lightdiffusion_next_tpu_torch.ops) against the JAX
package's.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold that version against the Pallas kernels run in interpret mode
(what the JAX package's own tests do on the CPU). The CUDA kernels
themselves are checked on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.

Tolerances: f32 inputs, atol 2e-5 / rtol 1e-4 (the JAX package's own
packed-vs-sdpa tolerance; the kernels run an online softmax, the plain
version one pass per row, so only summation order differs). bf16 inputs:
``flash_attention.agreement``, the check the CUDA kernels are held to on
the card: both sides round q after the f32 pre-scale, p and the output to
bf16, p against different running maxima, so an element may differ by a
bf16 ulp; the limit is three ulps at the largest |output|, and a relative RMS
error of 1e-2, which planted faults exceed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import attention as jattn
from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.ops import attention as tattn
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa



def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))
    )


@pytest.mark.parametrize(
    "kernel,b,h,lq,lk,d",
    [
        ("packed", 1, 8, 512, 512, 40),   # SD1.5 level 0: 8 heads at d=40
        ("packed", 1, 2, 600, 700, 40),   # ragged Lq and Lk, masked kv tail
        ("packed", 2, 2, 512, 640, 64),   # the 2-per-tile pack group
        ("flash", 1, 2, 512, 512, 80),    # level 1
        ("flash", 1, 2, 600, 700, 80),    # ragged
        ("flash", 1, 1, 512, 512, 512),   # the VAE's single head at d=512
        ("flash", 1, 2, 520, 530, 36),    # d not a multiple of 8
    ],
)
def test_plain_matches_pallas_f32(kernel, b, h, lq, lk, d):
    q, k, v = _qkv(0, b, h, lq, lk, d)
    jfn = jfa.packed_flash_attention if kernel == "packed" else jfa.flash_attention
    tfn = tfa.packed_flash_attention if kernel == "packed" else tfa.flash_attention
    ref = np.asarray(jfn(*(jnp.asarray(x) for x in (q, k, v))))
    out = tfn(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("kernel,d", [("packed", 40), ("flash", 80)])
def test_plain_matches_pallas_bf16(kernel, d):
    """bf16 in and out: the q pre-scale is rounded back to bf16 on both
    sides (flash_attention.py:133 and its port)."""
    q, k, v = _qkv(1, 1, 2, 512, 576, d)
    jfn = jfa.packed_flash_attention if kernel == "packed" else jfa.flash_attention
    tfn = tfa.packed_flash_attention if kernel == "packed" else tfa.flash_attention
    ref = np.asarray(jfn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
                     .astype(jnp.float32))
    out = tfn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    check = tfa.agreement(out, torch.from_numpy(ref.copy()).bfloat16())
    assert check["ok"], check


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize(
    "fault", [None, "q scale without LOG2E", "last kv tile of 64 rows skipped"])
def test_agreement_passes_sound_and_rejects_planted_faults(dtype, fault):
    """The check the kernels are held to on the card: the Pallas kernel (a
    second sound implementation) passes it against the plain version; the
    plain version with a planted fault fails it."""
    q, k, v = _qkv(6, 1, 2, 512, 640, 40)
    if dtype == "bf16":
        q, k, v = (x.astype(jnp.bfloat16) for x in (jnp.asarray(q), jnp.asarray(k),
                                                     jnp.asarray(v)))
        tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                      for x in (q, k, v))
    else:
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ref = tfa.attention_plain(tq, tk, tv)
    if fault is None:
        out = torch.from_numpy(np.array(
            jfa.packed_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            .astype(jnp.float32))).to(ref.dtype)
    elif fault == "q scale without LOG2E":
        out = tfa.attention_plain((tq.float() / tfa.LOG2E).to(tq.dtype), tk, tv)
    else:
        out = tfa.attention_plain(tq, tk[:, :, :-64], tv[:, :, :-64])
    check = tfa.agreement(out, ref)
    assert check["ok"] == (fault is None), check


def test_bf16_ulp():
    """One ulp above a bf16 value is the next bf16 value; a quarter ulp
    rounds back to it."""
    for x in (1.0, 0.3, 0.07, 1.5e-3):
        v = torch.tensor(x).bfloat16().float()
        ulp = tfa.bf16_ulp(v.item())
        assert (v + ulp).bfloat16().float() == v + ulp
        assert (v + ulp / 4).bfloat16().float() == v
    assert tfa.bf16_ulp(1.0) == 2.0**-7 and tfa.bf16_ulp(0.0) == 0.0


def test_bf16_q_rounding_is_mirrored():
    """Without the bf16 rounding of the pre-scaled q the plain version
    would drift from the JAX kernel; with it, the logits agree exactly."""
    q, k, _ = _qkv(2, 1, 1, 4, 4, 40)
    qb = torch.from_numpy(q).bfloat16()
    scaled = (qb.float() * (tfa.LOG2E / np.sqrt(40))).bfloat16()
    jq = jnp.asarray(q, jnp.bfloat16)
    jscaled = (jq.astype(jnp.float32) * (jfa.LOG2E / np.sqrt(40))).astype(jnp.bfloat16)
    np.testing.assert_array_equal(scaled.float().numpy(),
                                  np.asarray(jscaled.astype(jnp.float32)))


def test_sdpa_matches_jax_with_causal_mask():
    q, k, v = _qkv(3, 2, 3, 77, 77, 16)
    mask = np.triu(np.full((77, 77), -np.inf, np.float32), k=1)
    ref = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=jnp.asarray(mask)))
    out = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_dispatch_gate_and_kernel_choice():
    q = torch.zeros(1, 8, 512, 40)
    assert tfa.supported(q, q, q)
    assert not tfa.supported(q, torch.zeros(1, 8, 77, 40), torch.zeros(1, 8, 77, 40))
    assert not tfa.supported(*(torch.zeros(1, 1, 512, 513),) * 3)
    assert [tfa.pack_group(d) for d in (40, 64, 80, 160)] == [
        jfa.pack_group(d) for d in (40, 64, 80, 160)]
    assert tattn._flash_kernel(40) is tfa.packed_flash_attention
    assert tattn._flash_kernel(80) is tfa.flash_attention
    saved = tconfig.get_config()
    try:
        tconfig.set_config(dataclasses.replace(saved, packed_attn=False))
        assert tattn._flash_kernel(40) is tfa.flash_attention
    finally:
        tconfig.set_config(saved)
    with pytest.raises(ValueError):
        tfa.packed_flash_attention(*(torch.zeros(1, 1, 512, 80),) * 3)


@pytest.mark.parametrize("heads,l", [(8, 1024), (2, 77)])
def test_folded_attention_matches_jax(heads, l):
    """Folded (B, L, H*D) entry: kernel route at L >= 512, sdpa below."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, l, heads * 40)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jattn.attention_xla(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), heads))
    out = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), heads).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_vae_attention_core_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 24, 24, 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jattn.vae_attention_core(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v)))
    out = tattn.vae_attention_core(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_cpu_path_counts_no_launch():
    before = (tfa.flash_attention.launches, tfa.packed_flash_attention.launches)
    q = torch.zeros(1, 1, 512, 40)
    tfa.flash_attention(q, q, q)
    tfa.packed_flash_attention(q, q, q)
    assert (tfa.flash_attention.launches, tfa.packed_flash_attention.launches) == before
