"""The UNet's SD2-class branches against the JAX package, at tiny widths on
the CPU in f32: linear ``proj_in``/``proj_out`` (``use_linear_in_transformer``),
the label embedding fed by ``y`` (``label_emb.0.*``), heads set by channels
(``num_head_channels``), and all three together; K1's plain version at
d = 64, the head width those branches give SD2.1's UNet.

Params come from the JAX package's ``init_params`` (plus a seeded label
embedding, which neither ``init_params`` creates) and reach the port
through ``weights.from_jax``; the port's own ``init_params`` must draw the
same numbers. Tolerances: whole forwards atol/rtol 1e-4, as the SD1.5 UNet's
parity test (f32, summation order differs between XLA and PyTorch over a
few dozen layers); K1's plain version against the JAX kernel in bf16 by
``flash_attention.agreement``, the check the CUDA kernel is held to on the
card (three bf16 ulps at the largest |output| and a relative RMS error of
1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.ops import attention as tattn
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1,
            context_dim=64, num_heads=2)
ADM = 24
BRANCHES = {
    "linear": dict(use_linear_in_transformer=True),
    "label_emb": dict(adm_in_channels=ADM),
    "head_channels": dict(num_head_channels=8),
    "all": dict(use_linear_in_transformer=True, adm_in_channels=ADM, num_head_channels=8),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models of many small ops: one torch thread is as fast, and does
    not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def label_emb_params(cfg, seed):
    """A seeded ``label_emb.0.0`` (adm -> time dim) and ``label_emb.0.2``
    (time dim -> time dim), with non-zero biases."""
    rng = np.random.default_rng(seed)
    td = cfg.model_channels * 4
    return {"label_emb.0.0.weight": rng.normal(0, ADM**-0.5, (td, ADM)),
            "label_emb.0.0.bias": rng.normal(0, 0.1, (td,)),
            "label_emb.0.2.weight": rng.normal(0, td**-0.5, (td, td)),
            "label_emb.0.2.bias": rng.normal(0, 0.1, (td,))}


def branch_params(branch, seed=0):
    """(JAX config, port config, JAX-layout params) of one branch."""
    jcfg = junet.UNetConfig(**TINY, **BRANCHES[branch])
    tcfg = tunet.UNetConfig(**TINY, **BRANCHES[branch])
    params = junet.init_params(jcfg, seed=seed)
    if jcfg.adm_in_channels:
        params.update(label_emb_params(jcfg, seed + 1))
    return jcfg, tcfg, {k: np.asarray(v, np.float32) for k, v in params.items()}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_unet_branch_matches_jax(branch):
    """A 24x24 latent: level 0's 576 tokens take the kernel route (K1's
    plain version here)."""
    jcfg, tcfg, params = branch_params(branch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 24, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([981.0, 311.0], np.float32)
    y = rng.standard_normal((2, ADM)).astype(np.float32) if jcfg.adm_in_channels else None
    japply = jax.jit(lambda p, x, t, c, y: junet.apply_unet(p, x, t, c, y=y, cfg=jcfg))
    ref = np.asarray(japply({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            None if y is None else jnp.asarray(y)))
    model = tbase.sd15_model(from_jax(params), cfg=tcfg, device="cpu")
    out = model.apply_fn(model.params, torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ctx),
                         y=None if y is None else torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    if y is not None:  # y reaches the output, and is ignored without label_emb
        without = model.apply_fn(model.params, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx)).numpy()
        assert np.abs(without - out).max() > 1e-3
        bare = {k: v for k, v in model.params.items() if not k.startswith("label_emb.")}
        np.testing.assert_array_equal(
            model.apply_fn(bare, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), y=torch.from_numpy(y)).numpy(), without)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_init_params_and_heads_match_jax(branch):
    """The port's ``init_params`` draws the JAX one's numbers (linear
    projections 2-D, no label embedding in either), and ``heads_for``
    gives the same heads at every width."""
    jcfg, tcfg, _ = branch_params(branch, seed=4)
    ours = tunet.init_params(tcfg, seed=4)
    theirs = from_jax(junet.init_params(jcfg, seed=4))
    assert ours.keys() == theirs.keys()
    assert not any(k.startswith("label_emb.") for k in ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, theirs[k].numpy(), err_msg=k)
    proj = ours["input_blocks.1.1.proj_in.weight"]
    assert proj.ndim == (2 if tcfg.use_linear_in_transformer else 4)
    for ch in (32, 64, 320, 640, 1280):
        assert tcfg.heads_for(ch) == jcfg.heads_for(ch)


def test_sd21_head_layout_routes_k1_at_d64():
    """SD2.1's UNet (``num_head_channels`` 64) has 5, 10 and 20 heads of 64
    at its three transformer levels, and each long self-attention goes to
    K1 (``pack_group(64)`` = 2)."""
    cfg = tunet.UNetConfig(num_head_channels=64, context_dim=1024,
                           use_linear_in_transformer=True)
    jcfg = junet.UNetConfig(num_head_channels=64, context_dim=1024,
                            use_linear_in_transformer=True)
    assert [cfg.heads_for(320 * m) for m in (1, 2, 4)] == [(5, 64), (10, 64), (20, 64)]
    assert [cfg.heads_for(320 * m) for m in (1, 2, 4)] == \
        [jcfg.heads_for(320 * m) for m in (1, 2, 4)]
    assert tfa.pack_group(64) == jfa.pack_group(64) == 2
    assert tattn._flash_kernel(64, "cuda") is tfa.packed_flash_attention
    assert tunet.attention_blocks(cfg) == tunet.attention_blocks(tunet.SD15_CONFIG)


@pytest.mark.parametrize("b,h,lq,lk", [(1, 5, 512, 512), (2, 3, 600, 700)])
def test_k1_plain_at_d64_matches_pallas_bf16(b, h, lq, lk):
    """K1's plain version at d = 64 against the JAX kernel (G = 2, interpret
    mode on the CPU) in bf16, at SD2.1's odd head count (the pack pads a
    zero head) and at ragged lengths."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, lq, 64), (b, h, lk, 64), (b, h, lk, 64)))
    ref = np.asarray(jfa.packed_flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                                  for x in (q, k, v))).astype(jnp.float32))
    out = tfa.packed_flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, lq, 64)
    check = tfa.agreement(out, torch.from_numpy(ref.copy()).bfloat16())
    assert check["ok"], check


def test_label_emb_through_cfg_denoiser_matches_jax():
    """The pooled vectors of cond and uncond reach the label embedding as
    ``y`` through the CFG denoiser in both packages."""
    from lightdiffusion_next_tpu.sampling import cfg as jcfg_mod
    from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg_mod

    jcfg, tcfg, params = branch_params("all", seed=2)
    rng = np.random.default_rng(3)
    ctx = [rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2)]
    pooled = [rng.standard_normal((1, ADM)).astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    jmodel = jbase.sd15_model(params, cfg=jcfg)
    jconds = [jcfg_mod.CondInput(jnp.asarray(c), pooled=jnp.asarray(p))
              for c, p in zip(ctx, pooled)]
    jden = jcfg_mod.make_cfg_denoiser(jmodel.apply_fn, jmodel.params, jmodel.model_sampling,
                                      jconds[0], jconds[1], 7.0)
    ref = [np.asarray(r) for r in jax.jit(jden.pure_fn)(
        jden.jit_args, jnp.asarray(x), jnp.asarray([2.5], jnp.float32))]
    tmodel = tbase.sd15_model(from_jax(params), cfg=tcfg, device="cpu")
    tconds = [tcfg_mod.CondInput(torch.from_numpy(c), pooled=torch.from_numpy(p))
              for c, p in zip(ctx, pooled)]
    tden = tcfg_mod.make_cfg_denoiser(tmodel.apply_fn, tmodel.params, tmodel.model_sampling,
                                      tconds[0], tconds[1], 7.0)
    out = [r.numpy() for r in tden(torch.from_numpy(x), 2.5)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    moved = tcfg_mod.make_cfg_denoiser(
        tmodel.apply_fn, tmodel.params, tmodel.model_sampling,
        dataclasses.replace(tconds[0], pooled=torch.zeros(1, ADM)), tconds[1], 7.0)
    assert np.abs(moved(torch.from_numpy(x), 2.5)[0].numpy() - out[0]).max() > 1e-4
