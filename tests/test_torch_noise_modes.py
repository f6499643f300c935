"""The port's host noise in both rng modes against the JAX package's.

Both packages draw on the host: "torch" with torch's CPU generator, "jax"
with numpy's Philox generator (the JAX package's ``prepare_noise``,
``step_noise_batch`` and ``BrownianIntervalSampler``, whose path is a
float64 cumulative sum). So every draw must be equal bit for bit
(``np.array_equal``), including the batch-repeat ``noise_inds``, and
``ksample`` must read ``RuntimeConfig.rng_mode`` at its three draws.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import noise as jnoise
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import noise as tnoise

MODES = ["torch", "jax"]
SHAPES = [(1, 16, 16, 4), (3, 8, 12, 4)]
SEEDS = [0, 987654321, 2**40 + 17]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_prepare_noise_equal(mode, shape, seed):
    got = tnoise.prepare_noise(shape, seed, mode=mode)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), jnoise.prepare_noise(shape, seed, mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("inds", [[0, 0, 2], [3, 1, 1, 3], [1]])
def test_noise_inds_equal(mode, inds):
    """Batch-repeat indices: draws up to the largest index, repeats where
    an index recurs."""
    shape = (len(inds), 8, 8, 4)
    got = tnoise.prepare_noise(shape, 77, mode=mode, noise_inds=inds).numpy()
    want = jnoise.prepare_noise(shape, 77, mode=mode, noise_inds=inds)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    for i, a in enumerate(inds):
        for j, b in enumerate(inds):
            assert np.array_equal(got[i], got[j]) == (a == b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_step_noise_batch_equal(mode, seed):
    got = tnoise.step_noise_batch((1, 8, 12, 4), 7, seed, mode=mode)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), jnoise.step_noise_batch((1, 8, 12, 4), 7, seed,
                                                               mode=mode))


@pytest.mark.parametrize("seed", [None, 5, 2**40 + 17])
def test_brownian_interval_sampler_equal(seed):
    """The "jax" mode's path over unsorted, repeated levels, queried
    forwards, backwards and over an empty interval."""
    levels = [14.6, 0.03, 3.0, 2.0, 3.0, 0.5]
    jb = jnoise.BrownianIntervalSampler((1, 8, 8, 4), levels, seed=seed, mode="jax")
    tb = tnoise.BrownianIntervalSampler((1, 8, 8, 4), levels, seed=seed)
    assert np.array_equal(tb.W, jb.W)
    for a, b in [(14.6, 0.03), (2.0, 3.0), (3.0, 2.0), (0.5, 0.5)]:
        got, want = tb(a, b), jb(a, b)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    with pytest.raises(KeyError):
        tb(1.0, 2.0)


@pytest.mark.parametrize("steps", [6, 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_sde_noise_jax_mode_equal(steps, seed):
    sig = jks.sigmas_for(JMSD(), "karras", steps)
    j1, j2 = jnoise.sde_noise_for_steps((1, 8, 8, 4), sig, r=0.5, eta=1.0, seed=seed,
                                        mode="jax")
    t1, t2 = tnoise.sde_noise_for_steps((1, 8, 8, 4), sig, r=0.5, eta=1.0, seed=seed,
                                        mode="jax")
    assert np.array_equal(t1, j1) and np.array_equal(t2, j2)
    assert not t1[-1].any() and t1[0].any()


def test_rng_mode_field():
    assert tconfig.RuntimeConfig().rng_mode == jconfig.RuntimeConfig().rng_mode == "torch"
    with pytest.raises(ValueError):
        tconfig.RuntimeConfig(rng_mode="numpy")
    with pytest.raises(ValueError, match="rng mode"):
        tnoise.prepare_noise((1, 4, 4, 4), 1, mode="numpy")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sampler", ["euler_ancestral_cfgpp", "dpmpp_sde_cfgpp"])
def test_ksample_reads_rng_mode(mode, sampler, monkeypatch):
    """``ksample`` hands the configured mode to each draw it makes, and the
    draws are the JAX functions' in that mode."""
    from lightdiffusion_next_tpu_torch.models.base import DiffusionModel
    from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
    from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete
    from lightdiffusion_next_tpu_torch.utils import latent as tlatent

    seen = {}
    real = {name: getattr(tnoise, name)
            for name in ("prepare_noise", "step_noise_batch", "sde_noise_for_steps")}

    def spy(name):
        def call(*args, **kwargs):
            out = real[name](*args, **kwargs)
            seen[name] = (kwargs["mode"], out)
            return out
        return call

    for name in real:
        monkeypatch.setattr(tnoise, name, spy(name))
    model = DiffusionModel(apply_fn=lambda p, x, t, c, **_: 0.1 * x, params={},
                           model_sampling=ModelSamplingDiscrete(),
                           latent_format=tlatent.SD15)
    cond = tcfg.CondInput(cross_attn=torch.zeros(1, 4, 8))
    saved = tconfig.get_config()
    try:
        tconfig.set_config(dataclasses.replace(saved, rng_mode=mode))
        tks.ksample(model, seed=11, steps=4, cfg_scale=1.0, sampler_name=sampler,
                    scheduler="karras", positive=cond, negative=None,
                    latent_image=torch.zeros(1, 8, 8, 4))
    finally:
        tconfig.set_config(saved)
    shape = (1, 8, 8, 4)
    assert seen["prepare_noise"][0] == mode
    assert np.array_equal(seen["prepare_noise"][1].numpy(),
                          jnoise.prepare_noise(shape, 11, mode=mode))
    sigmas = tks.sigmas_for(ModelSamplingDiscrete(), "karras", 4)
    if sampler != "dpmpp_sde_cfgpp":
        assert seen["step_noise_batch"][0] == mode
        assert np.array_equal(seen["step_noise_batch"][1].numpy(),
                              jnoise.step_noise_batch(shape, 4, 11, mode=mode))
    else:
        assert seen["sde_noise_for_steps"][0] == mode
        want = jnoise.sde_noise_for_steps(shape, sigmas, r=0.5, eta=1.0, seed=11, mode=mode)
        for got, ref in zip(seen["sde_noise_for_steps"][1], want):
            assert np.array_equal(got, ref)
