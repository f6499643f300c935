"""``ksample``'s ComfyUI hooks, T5's attention mask and a guidance-free Flux
DiT (Flux.1-schnell's config) against the JAX package, at tiny widths on
the CPU in f32.

``ksample``: a tiny UNet from the JAX package's seeded params with the same
numpy conditioning in both packages: no hook, ``sigmas_override``,
``disable_noise``, a ``model_function_wrapper`` that counts its calls and
scales the model's output (FBCache off and on; on, forced to hit every call
it may serve, at most two in a row), and ``disable_cfg1_optimization`` at
CFG 1.0 (the
uncond pass runs: the wrapper sees the doubled batch). The final latents
agree to a relative RMS error of 1e-5 (f32 on both sides; only the
summation order differs, as in ``tests/test_torch_fbcache_unet.py``). The
JAX wrapper runs once per trace of its compiled loop, the port's once per
model call, so only the port's count is exact.

T5: ``apply_t5`` with a mask against the JAX one, unrolled and in the scan
layout, to a relative RMS error of 1e-4 (the encoder's tolerance in
``tests/test_torch_t5.py``); masked tokens leave the first token's output
unchanged to 1e-5 (``tests/test_t5.py``'s bound). Flux: a state dict
without ``guidance_in`` detects as ``guidance_embed=False`` in both, and
one DiT forward agrees to 1e-4 relative RMS error (the DiT's tolerance in
``tests/test_torch_flux.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models.clip import t5 as jt5
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import fbcache as jfb
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import fbcache as tfb
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), transformer_depth_middle=1,
            context_dim=64, num_heads=2)
SEED = 20261018
SIGMAS = np.asarray([9.0, 4.0, 1.5, 0.4, 0.0], np.float32)
SCALE = 0.9  # the wrapper's factor on the model's output
FORCED = dict(residual_diff_threshold=1e30, max_consecutive_cache_hits=2)
T5_TINY = dict(d_model=32, d_ff=64, num_heads=4, num_layers=2, vocab_size=100)
FLUX_TINY = dict(hidden_size=256, num_heads=2, depth=1, depth_single_blocks=1,
                 context_in_dim=64, vec_in_dim=32, axes_dim=(16, 56, 56),
                 guidance_embed=False)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unet_params():
    return junet.init_params(junet.UNetConfig(**TINY), seed=0)


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)))


def _inputs():
    rng = np.random.default_rng(3)
    conds = [rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2)]
    return conds, rng.standard_normal((1, 16, 16, 4)).astype(np.float32)


def _wrapper(seen):
    """Counts its calls with each call's batch, and scales the output."""

    def wrapper(apply, x, t, context, y):
        seen.append(int(x.shape[0]))
        return apply(x, t, context, y) * SCALE

    return wrapper


CASES = {
    "none": dict(),
    "sigmas_override": dict(kw=dict(sigmas_override=SIGMAS)),
    "disable_noise": dict(kw=dict(disable_noise=True, denoise=0.6)),
    "wrapper": dict(wrap=True),
    "wrapper_fbcache": dict(wrap=True, fbcache=True),
    "disable_cfg1": dict(wrap=True, cfg=1.0, disable_cfg1=True),
}


def _run(pkg, params, case, seen):
    spec = CASES[case]
    conds, latent = _inputs()
    cfg_scale = spec.get("cfg", 7.0)
    if pkg == "jax":
        model = jbase.sd15_model(params, cfg=junet.UNetConfig(**TINY))
        pos, neg = (jcfg.CondInput(cross_attn=jnp.asarray(c)) for c in conds)
        fb = jfb.FBCacheConfig(**FORCED) if spec.get("fbcache") else None
        ks, latent = jks.ksample, jnp.asarray(latent)
    else:
        model = tbase.sd15_model(from_jax(params), cfg=tunet.UNetConfig(**TINY),
                                 device="cpu")
        pos, neg = (tcfg.CondInput(cross_attn=torch.from_numpy(c)) for c in conds)
        fb = tfb.FBCacheConfig(**FORCED) if spec.get("fbcache") else None
        ks, latent = tks.ksample, torch.from_numpy(latent)
    opts = {}
    if spec.get("wrap"):
        opts["model_function_wrapper"] = _wrapper(seen)
    if spec.get("disable_cfg1"):
        opts["disable_cfg1_optimization"] = True
    if opts:
        model = model.with_options(**opts)
    res = ks(model, seed=SEED, steps=4, cfg_scale=cfg_scale, sampler_name="dpmpp_2m_cfgpp",
             scheduler="karras", positive=pos, negative=neg, latent_image=latent,
             fbcache=fb, **spec.get("kw", {}))
    return np.asarray(res.raw)


@pytest.mark.parametrize("case", list(CASES))
def test_ksample_hook_matches_jax(case, unet_params):
    spec = CASES[case]
    tfb.history.clear()
    port_seen, jax_seen = [], []
    port = _run("torch", unet_params, case, port_seen)
    hits = list(tfb.history)
    ref = _run("jax", unet_params, case, jax_seen)
    assert _rel_rmse(port, ref) <= 1e-5
    steps = len(SIGMAS) - 1
    if spec.get("wrap"):
        # the port: once per model call; JAX: once per trace
        assert len(port_seen) == steps and jax_seen
        batch = 2  # CFG 7 batches cond and uncond; disable_cfg1 keeps both at CFG 1
        assert set(port_seen) == {batch} and set(jax_seen) == {batch}
    if spec.get("fbcache"):
        assert hits and any(hits) and not all(hits)
    if case == "sigmas_override":
        plain = _run("torch", unet_params, "none", [])  # the karras schedule
        assert _rel_rmse(port, plain) > 1e-3
    if case == "disable_noise":
        # the initial noise is zero: the run depends on the seed no more
        conds, latent = _inputs()
        other = tks.ksample(
            tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                             device="cpu"),
            seed=SEED + 1, steps=4, cfg_scale=7.0, sampler_name="dpmpp_2m_cfgpp",
            scheduler="karras", positive=tcfg.CondInput(torch.from_numpy(conds[0])),
            negative=tcfg.CondInput(torch.from_numpy(conds[1])),
            latent_image=torch.from_numpy(latent), denoise=0.6, disable_noise=True)
        assert np.array_equal(other.raw.numpy(), port)


def test_cfg1_runs_cond_only_unless_disabled(unet_params):
    """At CFG 1.0 the denoiser runs the cond pass alone, and both passes
    under ``disable_cfg1_optimization`` (whose result is the cond pass's,
    as the lerp is skipped); FBCache's state follows the batch."""
    model = tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                             device="cpu")
    conds, latent = _inputs()
    pos, neg = (tcfg.CondInput(cross_attn=torch.from_numpy(c)) for c in conds)
    x = torch.from_numpy(latent)
    outs = {}
    for disable in (False, True):
        seen = []
        den = tcfg.make_cfg_denoiser(model.apply_fn, model.params, model.model_sampling,
                                     pos, neg, 1.0, model_wrapper=_wrapper(seen),
                                     disable_cfg1_optimization=disable)
        outs[disable] = den(x, 3.0)
        assert seen == [2 if disable else 1]
        m = model.with_options(disable_cfg1_optimization=disable)
        state = tfb.for_model(m, pos, neg, 1.0).init_state(x)
        assert state.cached_residual.shape[0] == (2 if disable else 1)
    np.testing.assert_allclose(outs[True][0].numpy(), outs[False][0].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert not torch.equal(outs[True][1], outs[True][0])  # the uncond prediction


def test_explicit_model_wrapper_wins_over_option(unet_params):
    """``ksample(model_wrapper=...)`` takes the option's place without
    FBCache; under FBCache only the option is read, as in the JAX
    ``ksample``."""
    conds, latent = _inputs()
    pos, neg = (tcfg.CondInput(cross_attn=torch.from_numpy(c)) for c in conds)
    for fb in (None, tfb.FBCacheConfig(0.0)):
        given, option = [], []
        model = tbase.sd15_model(from_jax(unet_params), cfg=tunet.UNetConfig(**TINY),
                                 device="cpu").with_options(
            model_function_wrapper=_wrapper(option))
        tks.ksample(model, seed=1, steps=2, cfg_scale=7.0, sampler_name="euler",
                    scheduler="karras", positive=pos, negative=neg,
                    latent_image=torch.from_numpy(latent), fbcache=fb,
                    model_wrapper=_wrapper(given))
        assert (len(given), len(option)) == ((2, 0) if fb is None else (0, 2))


# --- T5's attention mask ----------------------------------------------------


@pytest.mark.parametrize("layout", ["unrolled", "scan"])
def test_t5_attention_mask_matches_jax(layout):
    cfg_j, cfg_t = jt5.T5Config(**T5_TINY), tt5.T5Config(**T5_TINY)
    P = {k: np.asarray(v, np.float32) for k, v in jt5.init_params(cfg_j, seed=1).items()}
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 100, (2, 7)).astype(np.int32)
    mask = np.asarray([[1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 0]], np.float32)
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    tp = from_jax(P)
    if layout == "scan":
        jp = jt5.stack_t5_block_params(jp, cfg_j)
        tp = tt5.stack_t5_block_params(tp, cfg_t)
        assert tt5.is_stacked(tp)
    ref, jinter, _ = jt5.apply_t5(jp, jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
                                  intermediate_output=0, cfg=cfg_j)
    out, inter, _ = tt5.apply_t5(tp, torch.from_numpy(tokens.astype(np.int64)),
                                 attention_mask=torch.from_numpy(mask),
                                 intermediate_output=0, cfg=cfg_t)
    assert _rel_rmse(out.numpy(), ref) <= 1e-4
    assert _rel_rmse(inter.numpy(), jinter) <= 1e-4
    unmasked, _, _ = tt5.apply_t5(tp, torch.from_numpy(tokens.astype(np.int64)), cfg=cfg_t)
    assert _rel_rmse(unmasked.numpy(), out.numpy()) > 1e-3


def test_t5_masked_tokens_leave_first_token_unchanged():
    """The counterpart of ``tests/test_t5.py::test_t5_attention_mask``."""
    cfg = tt5.T5Config(**T5_TINY)
    P = from_jax(jt5.init_params(jt5.T5Config(**T5_TINY), seed=1))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 100, (1, 6)))
    mask = torch.tensor([[1, 1, 1, 0, 0, 0]], dtype=torch.float32)
    full, _, _ = tt5.apply_t5(P, tokens, attention_mask=mask, cfg=cfg)
    tokens2 = tokens.clone()
    tokens2[0, 4] = (tokens2[0, 4] + 1) % 100
    full2, _, _ = tt5.apply_t5(P, tokens2, attention_mask=mask, cfg=cfg)
    np.testing.assert_allclose(full[0, 0].numpy(), full2[0, 0].numpy(), atol=1e-5)
    free, _, _ = tt5.apply_t5(P, tokens2, cfg=cfg)
    assert np.abs(free[0, 0].numpy() - full[0, 0].numpy()).max() > 1e-5


# --- Flux without guidance (Flux.1-schnell's config) -------------------------


def test_flux_schnell_config_matches_jax():
    assert not tflux.FLUX_SCHNELL.guidance_embed
    port = {k: v for k, v in dataclasses.asdict(tflux.FLUX_SCHNELL).items() if k != "dtype"}
    want = {k: v for k, v in dataclasses.asdict(jflux.FLUX_SCHNELL).items() if k != "dtype"}
    assert port == want
    assert dataclasses.replace(tflux.FLUX_SCHNELL, guidance_embed=True) == tflux.FLUX_DEV


def test_guidance_free_flux_detects_and_matches_jax():
    jcfg_ = jflux.FluxConfig(**FLUX_TINY)
    params = {k: np.asarray(v, np.float32) for k, v in jflux.init_params(jcfg_, seed=2).items()}
    rng = np.random.default_rng(5)
    for k in params:
        if k.endswith(".bias"):
            params[k] = (0.05 * rng.standard_normal(params[k].shape)).astype(np.float32)
    assert not any(k.startswith("guidance_in.") for k in params)
    jdet = jflux.detect_config(params)
    tdet = tflux.detect_config(from_jax(params))
    assert not jdet.guidance_embed and not tdet.guidance_embed
    model = tbase.flux_model(from_jax(params), device="cpu")
    assert not model.config.guidance_embed
    x = rng.standard_normal((1, 16, 16, 16)).astype(np.float32)
    t = np.asarray([0.7], np.float32)
    ctx = rng.standard_normal((1, 32, 64)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x, t, c, y: jflux.apply_flux(
        p, x, t, c, y, None, cfg=dataclasses.replace(jdet, dtype=jnp.float32)))(
        {k: jnp.asarray(v) for k, v in params.items()}, *(jnp.asarray(a)
                                                          for a in (x, t, ctx, y))))
    out = model.apply_fn(model.params, *(torch.from_numpy(a) for a in (x, t, ctx)),
                         y=torch.from_numpy(y)).numpy()
    assert out.shape == x.shape
    assert _rel_rmse(out, ref) <= 1e-4
