"""The port's DPM++ SDE against the JAX package's: the Brownian-tree noise,
the step constants, the sampler loop and ``ksample``'s SDE path.

The noise is host numpy and torch's CPU generator in both packages, so the
tree and ``sde_noise_for_steps`` must be equal bit for bit, at two latent
shapes and three seeds (one above 2^32, which ``SeedSequence`` takes as a
multi-word entropy). ``_step_consts`` is host numpy in both: exactly equal.
The loop is compared with a closed-form denoiser, as in
test_torch_sampling.py, so only the loop, the midpoint calls on the
multi-scale route and the update arithmetic are under test: f32,
atol/rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import noise as jnoise
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch.models.base import DiffusionModel
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import noise as tnoise
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling.model_sampling import (
    ModelSamplingDiscrete as TMSD,
)
from lightdiffusion_next_tpu_torch.utils import latent as tlatent

SHAPES = [(1, 16, 16, 4), (2, 8, 12, 4)]
SEEDS = [0, 123456789, 2**40 + 17]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_brownian_tree_bit_for_bit(shape, seed):
    """Increments over nested, overlapping and reversed intervals, more
    queries than the 64-node cache holds."""
    jt = jnoise.TorchSDEBrownianTree(shape, 0.03, 14.6, entropy=seed)
    tt = tnoise.TorchSDEBrownianTree(shape, 0.03, 14.6, entropy=seed)
    rng = np.random.default_rng(seed % 2**32)
    queries = [(14.6, 0.03), (3.0, 2.0), (2.0, 3.0), (0.5, 0.49999)]
    queries += [tuple(rng.uniform(0.03, 14.6, 2)) for _ in range(12)]
    for ta, tb in queries:
        a, b = jt(ta, tb), tt(ta, tb)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_sde_noise_for_steps_bit_for_bit(shape, seed):
    sig = jks.sigmas_for(JMSD(), "karras", 20)
    j1, j2 = jnoise.sde_noise_for_steps(shape, sig, r=0.5, eta=1.0, seed=seed)
    t1, t2 = tnoise.sde_noise_for_steps(shape, sig, r=0.5, eta=1.0, seed=seed)
    assert t1.shape == (20,) + shape
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert not t1[-1].any() and t1[0].any()  # the last step draws nothing


def test_sde_noise_unported_mode_raises():
    """Both of the JAX package's modes are ported (tests/test_torch_noise_modes.py);
    a mode neither package has raises."""
    with pytest.raises(ValueError, match="rng mode"):
        tnoise.sde_noise_for_steps((1, 8, 8, 4), np.array([1.0, 0.0]), 0.5, 1.0, 1,
                                   mode="numpy")


@pytest.mark.parametrize("eta,r", [(1.0, 0.5), (0.5, 0.3), (0.0, 0.5)])
@pytest.mark.parametrize("steps", [6, 20])
def test_step_consts_with_eta_and_r_equal(eta, r, steps):
    sig = jks.sigmas_for(JMSD(), "karras", steps)
    jc = jsamp._step_consts(sig, eta, r)
    tc = tsamp._step_consts(sig, eta, r)
    assert set(tc) == set(jc)
    for key, val in tc.items():
        np.testing.assert_array_equal(val, jc[key], err_msg=key)


def _fake_apply(params, x, t, context, y=None, **_):
    """A closed-form "UNet": depends on x, t and the context."""
    if isinstance(x, torch.Tensor):
        return torch.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)
    return jnp.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)


def _conds(rng):
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    jden = jcfg.make_cfg_denoiser(_fake_apply, {}, JMSD(), jcfg.CondInput(jnp.asarray(c)),
                                  jcfg.CondInput(jnp.asarray(u)), 7.0)
    tden = tcfg.make_cfg_denoiser(_fake_apply, {}, TMSD(),
                                  tcfg.CondInput(torch.from_numpy(c)),
                                  tcfg.CondInput(torch.from_numpy(u)), 7.0)
    return c, u, jden, tden


@pytest.mark.parametrize("ms,true_cfgpp", [((False, 0.5, 3, 8, False), False),
                                           ((True, 0.5, 1, 2, False), False),
                                           ((True, 0.5, 1, 2, True), True)])
def test_dpmpp_sde_cfgpp_loop_matches_jax(ms, true_cfgpp):
    """Six steps over a 32x32 latent with the Brownian noise, with and
    without half-res steps (the midpoint call on its step's route), with
    the reference-effective CFG++ and the true-CFG++ momentum; the last
    step is the Euler branch."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32) * 14.6
    _, _, jden, tden = _conds(rng)
    sig = jks.sigmas_for(JMSD(), "karras", 6)
    noise = jnoise.sde_noise_for_steps(x.shape, sig, 0.5, 1.0, 99)
    ref = np.asarray(jsamp.sample(
        jden, jnp.asarray(x), sig, sampler="dpmpp_sde_cfgpp", ms=jsamp.MultiScale(*ms),
        sde_noise=noise, opts=jsamp.SamplerOptions(cfg_scale=7.0, true_cfgpp=true_cfgpp)))
    calls = []

    def counting(xx, ss):
        calls.append(tuple(xx.shape))
        return tden(xx, ss)

    out = tsamp.sample(counting, torch.from_numpy(x), sig, sampler="dpmpp_sde_cfgpp",
                       ms=tsamp.MultiScale(*ms), sde_noise=noise,
                       opts=tsamp.SamplerOptions(cfg_scale=7.0,
                                                 true_cfgpp=true_cfgpp)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert len(calls) == 11  # two per step, one on the last
    flags = tsamp.fullres_flags(6, tsamp.MultiScale(*ms), 32, 32)
    expect = [(1, 32, 32, 4) if f else (1, 16, 16, 4) for f in flags for _ in range(2)]
    assert calls == expect[:-1]


def test_ksample_sde_matches_jax():
    """``ksample`` draws the tree noise from its seed and runs the SDE loop:
    the same final latent as the JAX package's ``ksample``."""
    rng = np.random.default_rng(5)
    c, u, _, _ = _conds(rng)
    jmodel = type("M", (), {})()
    jmodel.latent_format, jmodel.model_sampling = jlatent.SD15, JMSD()
    jmodel.apply_fn, jmodel.params, jmodel.model_options, jmodel.uid = _fake_apply, {}, {}, 1
    tmodel = DiffusionModel(apply_fn=_fake_apply, params={}, model_sampling=TMSD(),
                            latent_format=tlatent.SD15)
    kw = dict(seed=2**33 + 5, steps=8, cfg_scale=7.0, sampler_name="dpmpp_sde_cfgpp",
              scheduler="karras", denoise=1.0)
    ref = jks.ksample(jmodel, positive=jcfg.CondInput(jnp.asarray(c)),
                      negative=jcfg.CondInput(jnp.asarray(u)),
                      latent_image=jnp.zeros((1, 16, 16, 4)), **kw)
    out = tks.ksample(tmodel, positive=tcfg.CondInput(torch.from_numpy(c)),
                      negative=tcfg.CondInput(torch.from_numpy(u)),
                      latent_image=torch.zeros(1, 16, 16, 4), **kw)
    np.testing.assert_allclose(out.latent.numpy(), np.asarray(ref.latent),
                               atol=1e-5, rtol=1e-5)
