"""``ksample`` with a denoise mask and differential diffusion in the port
against the JAX package (``_MaskedDenoiser``).

- The hardened mask itself: at sigmas down the whole karras schedule and
  between its entries, on a radial soft mask, the port's ``m >= thr`` is
  the JAX package's, pixel for pixel (``ts_from``, ``ts_to`` host floats of
  f32 timesteps, the call's timestep and the threshold in f32), and the
  area grows as sigma falls; an all-ones mask stays whole, an all-zeros one
  stays empty inside the trajectory.
- ``ksample`` on a closed-form model (``_fake_apply``: a smooth function
  of x, t and the context, the same in both packages) over a 16 x 16
  latent: static and differential masks, fractional and all-ones, euler
  and dpmpp_2m_cfgpp, multi-scale low-res segments, the dy sampler's
  half-res steps (euler_cfgpp), and a stateful inner denoiser; f32, atol
  and rtol 1e-5, as tests/test_torch_hires.py holds the samplers.
- The tiny UNet (tests/test_torch_img2img.py's) through ``ksample`` with a
  static and a differential mask at denoise 0.5: final latents to 1e-4
  relative RMS, as that file holds its UNet runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete as TMSD
from lightdiffusion_next_tpu_torch.utils import latent as tlatent

TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
                 transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
                 num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_rmse(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)))


def _soft_mask(h=16, w=16):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.exp(-(((yy - 8) ** 2 + (xx - 6) ** 2) / 40.0)).astype(np.float32)[None, ..., None]


# --------------------------------------------------------------------------
# The hardened mask
# --------------------------------------------------------------------------


def _areas(mask, sigma_start, sigmas):
    """The hardened mask's area at each sigma, in each package."""
    jden = jks._MaskedDenoiser(lambda x, s: (x, x), jnp.asarray(mask),
                               jnp.zeros_like(jnp.asarray(mask)), JMSD(), sigma_start, True)
    tden = tks._MaskedDenoiser(lambda x, s: (x, x), torch.from_numpy(mask),
                               torch.zeros(mask.shape), TMSD(), sigma_start, True)
    out = []
    for s in sigmas:
        jm, _ = jden._mask_at(jden.jit_args, jnp.asarray(s, jnp.float32), mask.shape[1:3])
        tm, _ = tden.mask_at(np.float32(s), mask.shape[1:3])
        tm2, _ = tden.mask_at(torch.tensor([s, s / 2], dtype=torch.float32), mask.shape[1:3])
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=f"sigma {s}")
        np.testing.assert_array_equal(tm2.numpy(), tm.numpy())  # max over the batch
        out.append(float(tm.sum()))
    return out


def test_hardened_mask_equals_jax_down_the_schedule():
    sig = tks.sigmas_for(TMSD(), "karras", 20, denoise=0.5)
    between = np.sqrt(sig[:-2] * sig[1:-1]).astype(np.float32)
    mask = _soft_mask()
    areas = _areas(mask, float(sig[0]), list(sig[:-1]) + list(between))
    assert all(a2 >= a1 for a1, a2 in zip(areas[:20], areas[1:20])), areas
    assert areas[0] < areas[19] == mask.size
    # from sigma_max, as test_differential_diffusion.py does
    s0 = float(TMSD().sigma_max)
    areas = _areas(mask, s0, np.geomspace(s0, float(TMSD().sigma_min), 6))
    assert areas[0] < areas[-1] == mask.size


def test_binary_extremes():
    s0 = float(TMSD().sigma_max)
    sigmas = np.geomspace(s0, float(TMSD().sigma_min), 4)
    ones = np.ones((1, 8, 8, 1), np.float32)
    assert _areas(ones, s0, sigmas) == [64.0] * 4
    assert _areas(np.zeros_like(ones), s0, sigmas[1:-1]) == [0.0, 0.0]


# --------------------------------------------------------------------------
# ksample on a closed-form model
# --------------------------------------------------------------------------


def _fake_apply(params, x, t, context, y=None, attn1_override=None, **kw):
    if isinstance(x, torch.Tensor):
        return torch.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)
    return jnp.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)


@pytest.fixture(scope="module")
def fakes():
    rng = np.random.default_rng(1)
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    jm = jbase.DiffusionModel(_fake_apply, {}, JMSD(), jlatent.SD15)
    tm = tbase.DiffusionModel(_fake_apply, {}, TMSD(), tlatent.SD15)
    return (jm, jcfg.CondInput(jnp.asarray(c)), jcfg.CondInput(jnp.asarray(u)),
            tm, tcfg.CondInput(torch.from_numpy(c)), tcfg.CondInput(torch.from_numpy(u)))


def _masks():
    frac = np.full((1, 16, 16, 1), 0.5, np.float32)
    frac[:, :4] = 1.0
    half = np.zeros((1, 16, 16, 1), np.float32)
    half[:, :8] = 1.0
    return {"fractional": frac, "half": half, "ones": np.ones((1, 16, 16, 1), np.float32),
            "soft": _soft_mask()}


CASES = [
    # (mask, differential, sampler, denoise, steps, multiscale)
    ("fractional", False, "euler", 0.5, 4, None),
    ("fractional", True, "euler", 0.5, 4, None),
    ("soft", True, "dpmpp_2m_cfgpp", 0.5, 6, None),
    ("ones", True, "euler", 0.5, 4, None),
    ("half", False, "euler", 1.0, 6, (True, 0.5, 2, 2, False)),
    ("soft", True, "dpmpp_2m_cfgpp", 1.0, 8, (True, 0.5, 3, 2, False)),
    ("half", False, "euler_cfgpp", 1.0, 5, None),
    ("soft", True, "euler_cfgpp", 0.6, 5, None),
]


def _ksample_both(fakes, mask, differential, sampler, denoise, steps, ms, latent):
    jm, jc, ju, tm, tc, tu = fakes
    kw = dict(seed=5, steps=steps, cfg_scale=7.0, sampler_name=sampler, scheduler="karras",
              denoise=denoise, differential_diffusion=differential)
    ref = jks.ksample(jm, positive=jc, negative=ju, latent_image=jnp.asarray(latent),
                      denoise_mask=jnp.asarray(mask),
                      ms=None if ms is None else jsamp.MultiScale(*ms), **kw)
    out = tks.ksample(tm, positive=tc, negative=tu, latent_image=torch.from_numpy(latent),
                      denoise_mask=torch.from_numpy(mask),
                      ms=None if ms is None else tsamp.MultiScale(*ms), **kw)
    return out, ref


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[5] is not None}"
                                             for c in CASES])
def test_masked_ksample_matches_jax(fakes, case):
    name, differential, sampler, denoise, steps, ms = case
    latent = np.random.default_rng(2).standard_normal((1, 16, 16, 4)).astype(np.float32)
    out, ref = _ksample_both(fakes, _masks()[name], differential, sampler, denoise, steps,
                             ms, latent)
    assert np.isfinite(out.latent.numpy()).all()
    np.testing.assert_allclose(out.latent.numpy(), np.asarray(ref.latent), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.raw.numpy(), np.asarray(ref.raw), atol=1e-5, rtol=1e-5)


def test_static_and_differential_differ_and_ones_agree(fakes):
    latent = np.random.default_rng(3).standard_normal((1, 16, 16, 4)).astype(np.float32)
    m = _masks()
    runs = {(name, d): _ksample_both(fakes, m[name], d, "euler", 0.5, 4, None, latent)[0]
            .latent.numpy() for name in ("fractional", "ones") for d in (False, True)}
    assert not np.allclose(runs["fractional", False], runs["fractional", True])
    np.testing.assert_allclose(runs["ones", False], runs["ones", True], atol=1e-6)
    # outside an all-zeros mask the latent is kept: the input comes back
    zeros = np.zeros((1, 16, 16, 1), np.float32)
    out, _ = _ksample_both(fakes, zeros, False, "euler", 0.5, 4, None, latent)
    np.testing.assert_allclose(out.latent.numpy(), latent, atol=1e-5)


class _Stateful:
    """A closed-form denoiser with a state: a call counter that scales its
    output, the same in both packages (FBCache's interface)."""

    def __init__(self, xp):
        self.xp = xp

    def init_state(self, x):
        return self.xp.zeros(())

    def __call__(self, x, sigma, state):
        den = self.xp.tanh(x) * (0.4 + 0.01 * state)
        return den, den * 0.5, state + 1


def test_masked_stateful_denoiser_matches_jax():
    """The masked denoiser passes the state through, over full-res and
    low-res segments (the state is made anew when the resolution
    changes)."""
    x = np.random.default_rng(4).standard_normal((1, 16, 16, 4)).astype(np.float32) * 3
    mask = _soft_mask()
    base = np.random.default_rng(5).standard_normal((1, 16, 16, 4)).astype(np.float32)
    sig = tks.sigmas_for(TMSD(), "karras", 8)
    ms = (True, 0.5, 2, 3, False)
    jden = jks._MaskedDenoiser(_Stateful(jnp), jnp.asarray(mask), jnp.asarray(base), JMSD(),
                               float(sig[0]), True)
    tden = tks._MaskedDenoiser(_Stateful(torch), torch.from_numpy(mask),
                               torch.from_numpy(base), TMSD(), float(sig[0]), True)
    assert hasattr(tden, "init_state")
    ref = np.asarray(jsamp.sample(jden, jnp.asarray(x), sig, sampler="euler",
                                  ms=jsamp.MultiScale(*ms)))
    out = tsamp.sample(tden, torch.from_numpy(x), sig, sampler="euler",
                       ms=tsamp.MultiScale(*ms)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# The tiny UNet
# --------------------------------------------------------------------------


@pytest.mark.parametrize("differential", [False, True])
def test_masked_ksample_tiny_unet_matches_jax(differential):
    unet_p = junet.init_params(junet.UNetConfig(**TINY_UNET), seed=0)
    jm = jbase.sd15_model(unet_p, cfg=junet.UNetConfig(**TINY_UNET))
    tm = tbase.sd15_model(from_jax(unet_p), cfg=tunet.UNetConfig(**TINY_UNET), device="cpu")
    rng = np.random.default_rng(6)
    c, u = (rng.standard_normal((1, 77, 64)).astype(np.float32) for _ in range(2))
    latent = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    mask = _soft_mask()
    kw = dict(seed=7, steps=4, cfg_scale=7.0, sampler_name="euler", scheduler="karras",
              denoise=0.5, differential_diffusion=differential)
    ref = jks.ksample(jm, positive=jcfg.CondInput(jnp.asarray(c)),
                      negative=jcfg.CondInput(jnp.asarray(u)),
                      latent_image=jnp.asarray(latent), denoise_mask=jnp.asarray(mask), **kw)
    out = tks.ksample(tm, positive=tcfg.CondInput(torch.from_numpy(c)),
                      negative=tcfg.CondInput(torch.from_numpy(u)),
                      latent_image=torch.from_numpy(latent),
                      denoise_mask=torch.from_numpy(mask), **kw)
    assert _rel_rmse(out.latent.numpy(), np.asarray(ref.latent)) < 1e-4
