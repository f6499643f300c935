"""FBCache on the UNet, and the UNet with ``qkv_fuse`` off, against the JAX
package.

A tiny UNet (two levels, 32 channels) from the JAX package's seeded params
runs ``ksample(fbcache=...)`` in both packages with the same numpy
conditioning, MSW-MSA on and CFG 7: the cache's hit-or-miss decision at
every model call must be the JAX one (the JAX decision is read back from
its compiled loop with ``jax.debug.callback``), and the final latent must
agree to 1e-5 relative RMS error (f32 on both sides; only the summation
order differs). With threshold 0 no call can hit, and the port's latent is
bit for bit its run without the cache. With ``qkv_fuse`` off the port's
UNet keeps the checkpoint's separate projections, and one forward agrees
with the JAX UNet's unfused forward to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.ops import window as jwin
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import fbcache as jfb
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.ops import window as twin
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import fbcache as tfb
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1,
            context_dim=64, num_heads=2)
SEED = 20261017
# the tiny random UNet's relative first-block change between calls sits
# around 0.1-0.3 over these schedules: this threshold gives hits and misses
THRESHOLD = 0.25


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unet_params():
    return junet.init_params(junet.UNetConfig(**TINY), seed=0)


def _conds():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2)]


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)))


def _port_run(params, sampler, fb_cfg, steps=8):
    model = tbase.sd15_model(from_jax(params), cfg=tunet.UNetConfig(**TINY), device="cpu")
    model = model.with_options(attn1_override_factory=twin.make_msw_msa_factory(
        model_sampling=model.model_sampling))
    pos, neg = (tcfg.CondInput(cross_attn=torch.from_numpy(c)) for c in _conds())
    tfb.history.clear()
    res = tks.ksample(model, seed=SEED, steps=steps, cfg_scale=7.0, sampler_name=sampler,
                      scheduler="karras", positive=pos, negative=neg,
                      latent_image=torch.zeros(1, 16, 16, 4), fbcache=fb_cfg)
    return res.raw.numpy(), list(tfb.history)


def _jax_run(params, sampler, threshold, monkeypatch, steps=8):
    hits = []
    real_make_hook = jfb.make_hook

    def recording_make_hook(box, fb_cfg, gate):
        hook = real_make_hook(box, fb_cfg, gate)

        def wrapped(h_prev, h_first, run_rest):
            h = hook(h_prev, h_first, run_rest)
            jax.debug.callback(lambda hit: hits.append(bool(hit)),
                               box[0].consecutive_hits > 0, ordered=True)
            return h

        return wrapped

    monkeypatch.setattr(jfb, "make_hook", recording_make_hook)
    model = jbase.sd15_model(params, cfg=junet.UNetConfig(**TINY))
    model = model.with_options(attn1_override_factory=jwin.make_msw_msa_factory(
        model_sampling=model.model_sampling))
    pos, neg = (jcfg.CondInput(cross_attn=jnp.asarray(c)) for c in _conds())
    res = jks.ksample(model, seed=SEED, steps=steps, cfg_scale=7.0, sampler_name=sampler,
                      scheduler="karras", positive=pos, negative=neg,
                      latent_image=jnp.zeros((1, 16, 16, 4), jnp.float32),
                      fbcache=jfb.FBCacheConfig(threshold))
    jax.effects_barrier()
    return np.asarray(res.raw), hits


@pytest.mark.parametrize("sampler", ["dpmpp_2m_cfgpp", "dpmpp_sde_cfgpp"])
def test_unet_fbcache_matches_jax(sampler, unet_params, monkeypatch):
    port, port_hits = _port_run(unet_params, sampler, tfb.FBCacheConfig(THRESHOLD))
    ref, jax_hits = _jax_run(unet_params, sampler, THRESHOLD, monkeypatch)
    assert port_hits == jax_hits
    assert any(port_hits) and not all(port_hits)
    assert _rel_rmse(port, ref) <= 1e-5


def test_unet_fbcache_threshold_zero_is_no_cache(unet_params):
    """No call hits at threshold 0, and the run is the one without the
    cache, bit for bit."""
    cached, hits = _port_run(unet_params, "dpmpp_2m_cfgpp", tfb.FBCacheConfig(0.0))
    plain, none = _port_run(unet_params, "dpmpp_2m_cfgpp", None)
    assert hits == [False] * 8 and none == []
    assert np.array_equal(cached, plain)


def test_unet_fbcache_state_shape(unet_params):
    """The state is f32 in input block 1's output shape, batch doubled under
    CFG; the hook sits after input blocks 0 and 1."""
    model = tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                             device="cpu")
    pos, neg = (tcfg.CondInput(cross_attn=torch.from_numpy(c)) for c in _conds())
    den = tfb.for_model(model, pos, neg, 7.0, tfb.FBCacheConfig())
    state = den.init_state(torch.zeros(1, 16, 12, 4))
    assert tuple(state.cached_residual.shape) == (2, 16, 12, 32)
    assert state.cached_residual.dtype == torch.float32 and not state.valid
    seen = []
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 12, 4))
                         .astype(np.float32))
    t = torch.tensor([500.0, 500.0])
    ctx = torch.from_numpy(np.concatenate(_conds()))

    def hook(h_prev, h_first, run_rest):
        seen.append((tuple(h_prev.shape), tuple(h_first.shape)))
        return run_rest(h_first)

    with_hook = model.apply_fn(model.params, x, t, ctx, first_block_hook=hook)
    assert seen == [((2, 16, 12, 32), (2, 16, 12, 32))]
    assert torch.equal(with_hook, model.apply_fn(model.params, x, t, ctx))


def test_unet_qkv_fuse_off_matches_jax(unet_params):
    """``qkv_fuse=False``: the port builds the UNet without joining its
    projections, and its forward equals the JAX UNet's unfused forward
    within f32 1e-5 (and the joined build's, the same contraction)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 250.0], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    saved_t, saved_j = tconfig.get_config(), jconfig.get_config()
    try:
        tconfig.set_config(dataclasses.replace(saved_t, qkv_fuse=False))
        jconfig.set_config(dataclasses.replace(saved_j, qkv_fuse=False))
        model = tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                                 device="cpu")
        assert "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight" in model.params
        assert not any(k.endswith(("to_qkv.weight", "to_kv.weight")) for k in model.params)
        out = model.apply_fn(model.params, torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ctx)).numpy()
        ref = np.asarray(junet.apply_unet(unet_params, jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(ctx), cfg=junet.UNetConfig(**TINY)))
    finally:
        tconfig.set_config(saved_t)
        jconfig.set_config(saved_j)
    assert _rel_rmse(out, ref) <= 1e-5
    fused = tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                             device="cpu")
    assert "input_blocks.1.1.transformer_blocks.0.attn1.to_qkv.weight" in fused.params
    joined = fused.apply_fn(fused.params, torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(ctx)).numpy()
    assert _rel_rmse(out, joined) <= 1e-5
