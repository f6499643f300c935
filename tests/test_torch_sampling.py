"""The port's sampling modules against the JAX package's.

Schedules and step constants are host numpy in both packages and must be
equal. ``prepare_noise`` must match bit for bit (both draw from torch's CPU
generator in the latent's NHWC shape). The sampler loop is compared with a
closed-form denoiser so that only the loop, the multi-scale resizing and
the update arithmetic are under test: f32, atol/rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import noise as jnoise
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling import schedules as jsched
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import noise as tnoise
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling import schedules as tsched
from lightdiffusion_next_tpu_torch.sampling.model_sampling import (
    ModelSamplingDiscrete as TMSD,
)


@pytest.mark.parametrize("steps", [4, 12, 20])
def test_karras_sigmas_equal(steps):
    jms, tms = JMSD(), TMSD()
    np.testing.assert_array_equal(tks.sigmas_for(tms, "karras", steps),
                                  jks.sigmas_for(jms, "karras", steps))
    np.testing.assert_array_equal(tks.sigmas_for(tms, "karras", steps, denoise=0.5),
                                  jks.sigmas_for(jms, "karras", steps, denoise=0.5))


def test_trim_sigmas_equal():
    s = jks.sigmas_for(JMSD(), "karras", 10)
    for args in ((2, None, False), (None, 5, True), (9, None, False)):
        np.testing.assert_array_equal(tks.trim_sigmas(s, *args), jks.trim_sigmas(s, *args))


def test_unported_scheduler_raises():
    """"normal" (hires-fix's) is ported and equals the JAX schedule; an
    unknown name raises ValueError, as in the JAX package."""
    np.testing.assert_array_equal(tks.sigmas_for(TMSD(), "normal", 10),
                                  jks.sigmas_for(JMSD(), "normal", 10))
    with pytest.raises(ValueError, match="invalid scheduler"):
        tks.sigmas_for(TMSD(), "exponential", 10)


@pytest.mark.parametrize("steps", [6, 20])
def test_step_consts_equal(steps):
    sig = jks.sigmas_for(JMSD(), "karras", steps)
    jc = jsamp._step_consts(sig, 1.0, 0.5)
    tc = tsamp._step_consts(sig)
    for key, val in tc.items():
        np.testing.assert_array_equal(val, jc[key], err_msg=key)


@pytest.mark.parametrize(
    "n,ms,hw",
    [
        (20, (True, 0.5, 3, 8, False), (128, 128)),
        (20, (True, 0.5, 5, 8, True), (64, 96)),
        (6, (True, 0.5, 1, 2, False), (32, 32)),
        (20, (False, 0.5, 3, 8, False), (128, 128)),
        (10, (True, 0.25, 3, 4, False), (24, 24)),
    ],
)
def test_fullres_flags_and_segments_equal(n, ms, hw):
    jf = jsamp.fullres_flags(n, jsamp.MultiScale(*ms), *hw)
    tf = tsamp.fullres_flags(n, tsamp.MultiScale(*ms), *hw)
    np.testing.assert_array_equal(tf, jf)
    assert tsamp.segment_flags(tf) == jsamp.segment_flags(jf)
    assert tsamp.scaled_dims(*hw, ms[1]) == jsamp.scaled_dims(*hw, ms[1])


@pytest.mark.parametrize("shape,seed", [((1, 128, 128, 4), 0),
                                        ((2, 9, 7, 4), 2**63 - 1), ((1, 4, 4, 4), 123)])
def test_prepare_noise_bit_for_bit(shape, seed):
    ref = jnoise.prepare_noise(shape, seed, mode="torch")
    out = tnoise.prepare_noise(shape, seed).numpy()
    np.testing.assert_array_equal(out, ref)


def test_noise_is_drawn_nhwc_not_nchw():
    """Transposing an NCHW draw gives other numbers: the shape matters."""
    nhwc = tnoise.prepare_noise((1, 8, 8, 4), 5)
    nchw = tnoise.prepare_noise((1, 4, 8, 8), 5).permute(0, 2, 3, 1)
    assert not torch.equal(nhwc, nchw)


def test_timestep_embedding_matches_jax():
    """XLA's and PyTorch's f32 exp may differ by an ulp in the frequencies;
    times t up to 999 that moves a sin/cos argument by ~1e-4."""
    t = np.array([0.0, 1.0, 499.0, 999.0], np.float32)
    ref = np.asarray(jsched.timestep_embedding(jnp.asarray(t), 320))
    out = tsched.timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_eps_scaling_matches_jax():
    jms, tms = JMSD(), TMSD()
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 4)).astype(np.float32)
    sig = np.array([3.0, 0.5], np.float32)
    np.testing.assert_allclose(
        tms.calculate_input(torch.from_numpy(sig), torch.from_numpy(x)).numpy(),
        np.asarray(jms.calculate_input(jnp.asarray(sig), jnp.asarray(x))), rtol=1e-6)
    s0 = np.float32(14.6146)
    np.testing.assert_allclose(
        tms.noise_scaling(torch.tensor(s0), torch.from_numpy(x), torch.zeros(2, 4, 4, 4),
                          max_denoise=True).numpy(),
        np.asarray(jms.noise_scaling(jnp.asarray(s0), jnp.asarray(x),
                                     jnp.zeros((2, 4, 4, 4)), max_denoise=True)),
        rtol=1e-6)


def _fake_apply(params, x, t, context, y=None, **_):
    """A closed-form "UNet": depends on x, t and the context."""
    if isinstance(x, torch.Tensor):
        return (torch.tanh(x) * 0.5 + context.mean() * 0.1
                + 1e-3 * t.reshape(-1, 1, 1, 1))
    return (jnp.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("cfg_scale", [7.0, 1.0])
def test_cfg_denoiser_matches_jax(cfg_scale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    jden = jcfg.make_cfg_denoiser(_fake_apply, {}, JMSD(), jcfg.CondInput(jnp.asarray(c)),
                                  jcfg.CondInput(jnp.asarray(u)), cfg_scale)
    tden = tcfg.make_cfg_denoiser(_fake_apply, {}, TMSD(),
                                  tcfg.CondInput(torch.from_numpy(c)),
                                  tcfg.CondInput(torch.from_numpy(u)), cfg_scale)
    jd, ju = jden(jnp.asarray(x), jnp.float32(2.5))
    td, tu = tden(torch.from_numpy(x), torch.tensor(2.5))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5, rtol=1e-5)


def test_pad_cross_attn_to_lcm():
    a, b = torch.zeros(1, 77, 4), torch.ones(1, 154, 4)
    pa, pb = tcfg.pad_cross_attn_to_match(a, b)
    assert pa.shape == pb.shape == (1, 154, 4)


@pytest.mark.parametrize("ms,true_cfgpp", [((True, 0.5, 1, 2, False), False),
                                           ((False, 0.5, 3, 8, False), False),
                                           ((True, 0.5, 1, 2, False), True)])
def test_dpmpp_2m_cfgpp_loop_matches_jax(ms, true_cfgpp):
    """Six steps over a 32x32 latent, with and without half-res steps, with
    the reference-effective CFG++ and with the true-CFG++ momentum."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32) * 14.6
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    sig = jks.sigmas_for(JMSD(), "karras", 6)
    jden = jcfg.make_cfg_denoiser(_fake_apply, {}, JMSD(), jcfg.CondInput(jnp.asarray(c)),
                                  jcfg.CondInput(jnp.asarray(u)), 7.0)
    tden = tcfg.make_cfg_denoiser(_fake_apply, {}, TMSD(),
                                  tcfg.CondInput(torch.from_numpy(c)),
                                  tcfg.CondInput(torch.from_numpy(u)), 7.0)
    ref = np.asarray(jsamp.sample(jden, jnp.asarray(x), sig, sampler="dpmpp_2m_cfgpp",
                                  ms=jsamp.MultiScale(*ms),
                                  opts=jsamp.SamplerOptions(cfg_scale=7.0,
                                                            true_cfgpp=true_cfgpp)))
    out = tsamp.sample(tden, torch.from_numpy(x), sig, sampler="dpmpp_2m_cfgpp",
                       ms=tsamp.MultiScale(*ms),
                       opts=tsamp.SamplerOptions(cfg_scale=7.0,
                                                 true_cfgpp=true_cfgpp)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_unported_sampler_raises():
    """Every sampler name of the JAX package is ported (hires-fix's
    euler_ancestral_cfgpp: tests/test_torch_hires.py); an unknown name
    raises ValueError, as in the JAX package."""
    assert tsamp.SAMPLER_NAMES == jsamp.SAMPLER_NAMES
    assert tsamp.SAMPLER_ALIASES == jsamp.SAMPLER_ALIASES
    out = tsamp.sample(lambda x, s: (x * 0.5, x), torch.ones(1, 8, 8, 4),
                       np.array([1.0, 0.0], np.float32), sampler="euler_ancestral_cfgpp")
    torch.testing.assert_close(out, torch.full((1, 8, 8, 4), 0.5))
    for samplers in (tsamp, jsamp):
        with pytest.raises(ValueError, match="unknown sampler"):
            samplers.sample(lambda x, s: (x, x), np.zeros((1, 8, 8, 4), np.float32),
                            np.array([1.0, 0.0], np.float32), sampler="euler_a")
