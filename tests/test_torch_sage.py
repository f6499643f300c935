"""The port's int8 attention (K4's plain version, ``sage_attention_plain``)
and its dispatch against the JAX package, and the tiny SD1.5 slice with
``sage_attention`` on through ``pipeline()``.

Inputs come from a numpy seed and go through both packages; the JAX Pallas
kernel runs in interpret mode on the CPU. Tolerances:

- the plain version against the JAX kernel at the JAX kernel's softmax
  block (the port's default, ``softmax_block``), or at any other block
  width given to both: the same f32 operations, so most outputs agree to
  f32 rounding (measured 1.5e-7 relative RMS error in f32), but a
  last-bit difference (the means, the sums, exp) can move a p or a code
  across a rounding edge of the int8 quantization, a step of 1/127 of its
  scale (measured up to 2.0e-4 with bf16 inputs). Limit: SAGE_REL_RMSE,
  1e-3, and max |error| within 1e-2 of max |ref|;
- V + c moves the output by c to 5e-3, the JAX package's own limit;
- the plain version against exact attention: 5e-2 relative RMS error (the
  JAX package's bound on the quantization error);
- the slice: the final latent within 1e-3 relative RMS error of the JAX
  package's, the image within 1 level (the SD1.5 slice's own limits are
  1e-4 and 1; a code flip inside one attention call moves the latent by
  more than f32 rounding).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.clip import facade as jfacade
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.ops import attention as jattn
from lightdiffusion_next_tpu.ops import sage_attention as jsa
from lightdiffusion_next_tpu.ops import window as jwin
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.utils import image as jimage
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import facade as tfacade
from lightdiffusion_next_tpu_torch.ops import attention as tattn
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa
from lightdiffusion_next_tpu_torch.ops import sage_attention as tsa
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from test_torch_flux import _rel_rmse, _t
from test_torch_slice import PROMPT, SEED, TINY, TINY_VAE, _read_png

SAGE_REL_RMSE = 1e-3
SLICE_LATENT_REL_RMSE = 1e-3


@pytest.fixture
def sage_on():
    """Both packages' ``RuntimeConfig`` with ``sage_attention`` on (and the
    JAX package's kernels on, its "auto" being plain XLA on the CPU);
    restored after."""
    saved_j, saved_t = jconfig.get_config(), tconfig.get_config()
    jconfig.set_config(dataclasses.replace(saved_j, sage_attention=True,
                                           attention_backend="pallas"))
    tconfig.set_config(dataclasses.replace(saved_t, sage_attention=True))
    yield
    jconfig.set_config(saved_j)
    tconfig.set_config(saved_t)


def _qkv(rng, b, h, lq, lk, d, scale=1.0):
    return tuple((rng.standard_normal(s) * scale).astype(np.float32)
                 for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))


def _both(q, k, v, dtype, block_k=None):
    """(port plain, JAX kernel) on the same inputs in ``dtype``, as f32."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    kw = {} if block_k is None else {"block_k": block_k}
    ref = jsa.sage_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
    out = tsa.sage_attention_plain(*(_t(a).to(td) for a in (q, k, v)), **kw)
    assert out.dtype == td and out.shape == q.shape
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("b,h,lq,lk,d,dtype", [
    (1, 2, 300, 300, 40, "f32"),     # SD1.5 level 0's head dim, ragged L
    (1, 2, 256, 520, 80, "f32"),     # cross lengths
    (1, 1, 200, 700, 160, "bf16"),   # ragged kv in one block of 768
    (2, 2, 512, 512, 128, "f32"),
    (1, 2, 1024, 1024, 40, "bf16"),  # one block of 1024
    (1, 1, 96, 1300, 40, "f32"),     # two blocks, the second partial and masked
])
def test_sage_plain_matches_jax(b, h, lq, lk, d, dtype):
    rng = np.random.default_rng(lq + lk + d)
    out, ref = _both(*_qkv(rng, b, h, lq, lk, d), dtype)
    assert _rel_rmse(out, ref) <= SAGE_REL_RMSE
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("block_k", [64, 128])
def test_sage_plain_matches_jax_at_other_blocks(block_k):
    """The block width is part of the function (P is quantized against the
    running maximum after each block): given the same width, the two
    agree; the kernel's tile (64) is one such width."""
    rng = np.random.default_rng(block_k)
    q, k, v = _qkv(rng, 1, 2, 192, 320, 40)
    out, ref = _both(q, k, v, "f32", block_k=block_k)
    assert _rel_rmse(out, ref) <= SAGE_REL_RMSE
    default, _ = _both(q, k, v, "f32")
    assert not np.array_equal(out, default)


def test_sage_plain_close_to_exact_attention_and_shift_invariant():
    """Quantization-level error against exact attention, even with a large
    offset on K (centring makes it a no-op); V + c moves the output by c."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 256, 256, 40))
    exact = tattn.sdpa(q.double(), k.double(), v.double()).float().numpy()
    assert _rel_rmse(tsa.sage_attention_plain(q, k, v).numpy(), exact) < 5e-2
    assert _rel_rmse(tsa.sage_attention_plain(q, k + 25.0, v).numpy(), exact) < 5e-2
    base = tsa.sage_attention_plain(q, k, v).numpy()
    shifted = tsa.sage_attention_plain(q, k, v + 100.0).numpy()
    np.testing.assert_allclose(shifted - base, 100.0, rtol=0, atol=5e-3)


def test_prepare_matches_jax_quantization():
    """The preparation's codes and scales against the JAX wrapper's: Q's
    codes and scales exactly (the same f32 operations on the same values);
    K's and V's after the mean over tokens, whose last bits may differ, to
    one code and 1e-6 of their scales (of the largest mean for V's)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 1, 2, 130, 150, 40, scale=2.0)
    qq, sq, kq, sk, vq, svs, vmu = tsa.prepare(_t(q), _t(k), _t(v))
    jq, jsq = jsa._quant_rows(jnp.asarray(q))
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq) * np.float32(1 / np.sqrt(40)))
    kf = jnp.asarray(k) - jnp.mean(jnp.asarray(k), axis=2, keepdims=True)
    jk, jsk = jsa._quant_rows(kf)
    assert np.abs(kq.numpy().astype(int) - np.asarray(jk).astype(int)).max() <= 1
    np.testing.assert_allclose(sk.numpy(), np.asarray(jsk), rtol=1e-6)
    jmu = np.asarray(jnp.mean(jnp.asarray(v), axis=2, keepdims=True))
    assert np.abs(vmu.numpy() - jmu).max() <= 1e-6 * np.abs(jmu).max()
    assert vq.dtype == torch.int8 and svs.shape == (1, 2, 1, 40)


def test_softmax_block_matches_jax():
    from lightdiffusion_next_tpu.ops import flash_attention as jfa

    for lk in (64, 100, 300, 512, 520, 577, 700, 1024, 1281, 4096, 4352, 9000, 16384):
        ref = jsa._int8_block(lk, 1024, lane=128) or min(1024, jfa._round_up(lk, 128))
        assert tsa.softmax_block(lk) == ref and ref % 128 == 0
        assert all(ref % tsa.geometry(d)[2] == 0 for d in tsa.HEAD_DIMS)


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 3, 70, 100, 40),     # DP 64, P.V padded to 48, one kv tile
    (1, 2, 300, 1000, 80),   # d = 80: DP 96; a ragged length
    (1, 1, 130, 200, 160),   # kv tiles of 64 tokens, one consumer's images
])
def test_kernel_operands_layout(b, h, lq, lk, d):
    """What the launch hands the kernel (``pack_operands``, the plain
    layout): inverting the tile images recovers ``prepare``'s codes and
    scales, the padding holds zero codes (sq 0 and sk 1 past the lengths),
    and V's tokens sit in the kernel's order per group of 32."""
    rng = np.random.default_rng(9 + d)
    q, k, v = (_t(a) for a in _qkv(rng, b, h, lq, lk, d))
    qq, sq, kq, sk, vq, svs, vmu = tsa.prepare(q, k, v)
    ops = tsa.pack_operands(qq, sq, kq, sk, vq, svs, vmu)
    dp, dv, bn = tsa.geometry(d)
    bh, qt, kt = b * h, tsa.q_images(lq), -(-lk // bn)
    assert ops.qimg.dtype == torch.uint8 and ops.qimg.shape == (bh, qt, 64 * (dp + 4))
    assert ops.kvimg.shape == (bh, kt, bn * (dp + 4 + dv)) and ops.lk == lk
    assert qt % 2 == 0 and qt * 64 >= lq and dp % 32 == 0 and dv % 16 == 0
    assert torch.equal(ops.svs, svs.reshape(bh, d)) and torch.equal(ops.vmu, vmu.reshape(bh, d))
    qc, qs, kc, ks, vc = tsa.unpack_operands(ops, d)
    assert torch.equal(qc[:, :lq, :d], qq.reshape(bh, lq, d))
    assert torch.equal(qs[:, :lq], sq.reshape(bh, lq))
    assert torch.equal(kc[:, :lk, :d], kq.reshape(bh, lk, d))
    assert torch.equal(ks[:, :lk], sk.reshape(bh, lk))
    assert torch.equal(vc[:, :lk, :d], vq.reshape(bh, lk, d))
    assert not qc[:, lq:].any() and not qc[..., d:].any() and not qs[:, lq:].any()
    assert not kc[:, lk:].any() and not kc[..., d:].any() and bool((ks[:, lk:] == 1).all())
    assert not vc[:, lk:].any() and not vc[..., d:].any()
    order = tsa._V_ORDER
    assert sorted(order) == list(range(32)) and order[:8] == [0, 1, 8, 9, 2, 3, 10, 11]
    # V's first k32 block of the first image, unswizzled by hand: channel
    # row c holds the group's tokens in the kernel's order
    first = ops.kvimg[0, 0, bn * (dp + 4):bn * (dp + 4) + 32 * dv].view(dv, 2, 16)
    swap = torch.tensor([(c >> 2) & 1 for c in range(dv)]).bool().view(dv, 1, 1)
    first = torch.where(swap, first.flip(1), first).reshape(dv, 32).view(torch.int8)
    want = F.pad(vq.reshape(bh, lk, d)[0, :32], (0, dv - d))[order].T
    assert torch.equal(first, want)


def test_launch_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 512, 40))
    ops = tsa.prepare_plain(q, q, q)
    with pytest.raises(ValueError):
        tsa._launch(q, ops)
    with pytest.raises(ValueError):
        tsa.prepare_kernel(q, q, q)


# --- the dispatch -------------------------------------------------------------


def test_dispatch_sends_long_attention_to_k4(sage_on, monkeypatch):
    """With ``sage_attention`` on: long unmasked attention goes to K4 at any
    head dim, ahead of the packed kernel, in both packages; short kv and
    masked calls go to sdpa; the VAE's attention stays on K2."""
    assert jattn._flash_kernel(40) is jsa.sage_attention
    calls = []

    def recorder(name, fn):
        def wrapped(q, k, v):
            calls.append((name, q.shape[-1], k.shape[2]))
            return fn(q, k, v)
        return wrapped

    monkeypatch.setattr(tsa, "sage_attention", recorder("k4", tsa.sage_attention))
    monkeypatch.setattr(tfa, "packed_flash_attention", recorder("k1", tfa.packed_flash_attention))
    monkeypatch.setattr(tfa, "flash_attention", recorder("k2", tfa.flash_attention))
    rng = np.random.default_rng(10)
    q40 = _t(rng.standard_normal((1, 512, 80)).astype(np.float32))
    q160 = _t(rng.standard_normal((1, 512, 320)).astype(np.float32))
    tattn.attention(q40, q40, q40, heads=2)
    tattn.attention(q160, q160, q160, heads=2)
    tattn.attention(q40, q40[:, :77], q40[:, :77], heads=2)   # short kv
    mask = torch.zeros((1, 1, 512, 512))
    tattn.attention(q40, q40, q40, heads=2, mask=mask)        # masked
    vq = _t(rng.standard_normal((1, 32, 16, 64)).astype(np.float32))
    tattn.vae_attention_core(vq, vq, vq)
    assert calls == [("k4", 40, 512), ("k4", 160, 512), ("k2", 64, 512)]
    # sage off: back to K1 where packed_attn resolves on for the tensors'
    # device (pinned on here; its "auto" is off on the CPU, where d = 40
    # takes K2, as in the JAX package)
    tconfig.set_config(dataclasses.replace(tconfig.get_config(), sage_attention=False,
                                           packed_attn=True))
    calls.clear()
    tattn.attention(q40, q40, q40, heads=2)
    assert calls == [("k1", 40, 512)]
    tconfig.set_config(dataclasses.replace(tconfig.get_config(), packed_attn="auto"))
    calls.clear()
    tattn.attention(q40, q40, q40, heads=2)
    assert calls == [("k2", 40, 512)]


def test_dispatched_output_matches_jax(sage_on):
    """``attention`` on folded tensors with sage on, both packages."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 600, 160)).astype(np.float32)
    ref = np.asarray(jattn.attention_pallas(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                                            heads=2))
    out = tattn.attention(_t(x), _t(x), _t(x), heads=2).numpy()
    assert _rel_rmse(out, ref) <= SAGE_REL_RMSE


# --- the whole slice ----------------------------------------------------------


def test_sd15_sage_slice_matches_jax_composition(tmp_path, sage_on):
    """pipeline() on the tiny SD1.5 models at 256^2 with ``sage_attention``
    on, against the JAX package's functions with its ``sage_attention`` on:
    level 0 holds 1024 tokens, so K4 takes its unwindowed calls."""
    ucfg_j, ucfg_t = junet.UNetConfig(**TINY), tunet.UNetConfig(**TINY)
    vcfg_j, vcfg_t = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    unet_p = junet.init_params(ucfg_j, seed=0)
    vae_p = jvae.init_params(vcfg_j, seed=1)
    clip_p = jte.init_params(num_layers=2, width=64, heads=4, seed=2)

    model = tbase.sd15_model(from_jax(unet_p), cfg=ucfg_t, device="cpu")
    vae = tvae.VAE(from_jax(vae_p), vcfg_t, device="cpu")
    clip = tfacade.sd1_clip_from_params(from_jax(clip_p), device="cpu")
    calls = []
    real = tsa.sage_attention

    def counting(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    tsa.sage_attention = counting
    latents = []
    try:
        paths = tpipe.pipeline(
            PROMPT, 256, 256, prio_speed=True, autohdr=False, model=model, clip=clip,
            vae=vae, seed=SEED, output_dir=str(tmp_path),
            progress_callback=lambda info: latents.append(info["x"]),
        )
    finally:
        tsa.sage_attention = real
    assert len(latents) == 20 and os.path.basename(paths[0]) == "LD_00001_.png"
    assert calls and all(s[2] == 1024 for s in calls)

    jclip = jfacade.CLIPSetLastLayer().set_last_layer(
        jfacade.sd1_clip_from_state_dict(clip_p), -2)
    enc = jfacade.CLIPTextEncode()
    pos, neg = enc.encode(jclip, PROMPT), enc.encode(jclip, tpipe.DEFAULT_NEGATIVE)
    jmodel = jbase.sd15_model(unet_p, cfg=ucfg_j)
    jmodel = jmodel.with_options(attn1_override_factory=jwin.make_msw_msa_factory(
        model_sampling=jmodel.model_sampling))
    res = jks.ksample(
        jmodel, seed=SEED, steps=20, cfg_scale=7.0, sampler_name="dpmpp_2m_cfgpp",
        scheduler="karras", positive=pos, negative=neg,
        latent_image=jlatent.empty_latent(256, 256, 1), denoise=1.0,
        ms=jsamp.MultiScale(enabled=True), callback=lambda info: None,
    )
    jax.effects_barrier()
    jimg = jimage.to_uint8(np.asarray(jvae.VAE(vae_p, vcfg_j).decode(res.latent)))[0]
    assert _rel_rmse(latents[-1].numpy(), res.raw) <= SLICE_LATENT_REL_RMSE
    diff = np.abs(_read_png(paths[0]).astype(np.int32) - jimg.astype(np.int32))
    assert diff.max() <= 1
