"""SD1.5 hires-fix in the port against the JAX package: its modules, then
the whole flow.

Host numpy in both packages, held bit for bit: the "normal" and "simple"
schedules with the denoise slicing, the ancestral step noise
(``step_noise_batch``, the torch CPU stream ``prepare_noise`` started) and
bislerp. The Euler samplers (euler, euler_ancestral and the CFG++ and dy
CFG++ variants, with the alias hires-fix uses) run on a closed-form
denoiser, with the multi-scale plan on and off: f32, atol/rtol 1e-5.

The whole flow: ``pipeline(prompt, 128, 128, hires_fix=True)`` in both
packages from the tiny checkpoint of scripts/make_tiny_assets.py, the
first pass at 16 x 16 latents, bislerp to 32 x 32, 10 steps of
``euler_ancestral_cfgpp`` over "normal" at denoise 0.45 from a seed both
draw from Python's ``random``, decoded to a 256 x 256 PNG. Tolerance as in
tests/test_torch_defaults.py: the PNGs within one uint8 level, the final
latents to 1e-4 relative RMS.
"""

import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import noise as jnoise
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling import schedules as jsched
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu.utils import upscale as jup
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import noise as tnoise
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling import schedules as tsched
from lightdiffusion_next_tpu_torch.sampling.model_sampling import (
    ModelSamplingDiscrete as TMSD,
)
from lightdiffusion_next_tpu_torch.utils import upscale as tup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a (cute:1.2) cat on a mat"
SEED = 2**40 + 15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tiny models are thousands of small ops: with one torch thread
    they run as fast as with many, and do not crowd the other test workers'
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scheduler", ["normal", "simple"])
@pytest.mark.parametrize("steps", [1, 10, 22])
def test_schedules_equal(scheduler, steps):
    np.testing.assert_array_equal(tsched.calculate_sigmas(TMSD(), scheduler, steps),
                                  jsched.calculate_sigmas(JMSD(), scheduler, steps))


@pytest.mark.parametrize("scheduler", ["normal", "simple", "karras"])
@pytest.mark.parametrize("steps,denoise", [(10, 0.45), (8, 0.3), (8, 0.2)])
def test_denoise_slicing_equal(scheduler, steps, denoise):
    """The hires pass (10 steps, denoise 0.45) and USDU's redraw and seams
    (8 steps at 0.3 and 0.2): ``steps`` + 1 sigmas of a longer schedule."""
    got = tks.sigmas_for(TMSD(), scheduler, steps, denoise)
    np.testing.assert_array_equal(got, jks.sigmas_for(JMSD(), scheduler, steps, denoise))
    assert got.shape == (steps + 1,) and got[-1] == 0


def test_unknown_scheduler_raises_as_jax():
    for sched in (tsched, jsched):
        with pytest.raises(ValueError, match="invalid scheduler"):
            sched.calculate_sigmas(TMSD(), "exponential", 10)


@pytest.mark.parametrize("shape,n", [((1, 16, 16, 4), 10), ((2, 6, 10, 4), 3)])
def test_step_noise_batch_equal(shape, n):
    got = tnoise.step_noise_batch(shape, n, 2**40 + 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,) + shape
    np.testing.assert_array_equal(got.numpy(), jnoise.step_noise_batch(shape, n, 2**40 + 3))
    # it continues the stream of the initial noise
    g = torch.Generator().manual_seed(2**40 + 3)
    np.testing.assert_array_equal(tnoise.prepare_noise(shape, 2**40 + 3).numpy(),
                                  torch.randn(shape, generator=g).numpy())
    np.testing.assert_array_equal(got.numpy(), torch.randn((n,) + shape, generator=g).numpy())


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)), ((12, 20), (24, 40)),
                                     ((17, 9), (8, 30))])
def test_bislerp_equal(src, dst):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + src + (4,)).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero vector
    x[0, 0, 1] = -x[0, 0, 2]  # opposite vectors
    x[1, 1, 1] = x[1, 1, 2]  # equal vectors
    got = tup.bislerp(x, dst[1], dst[0])
    assert got.shape == (2,) + dst + (4,)
    np.testing.assert_array_equal(got, jup.bislerp(x, dst[1], dst[0]))
    np.testing.assert_array_equal(tup.bislerp(torch.from_numpy(x), dst[1], dst[0]), got)
    np.testing.assert_array_equal(tup.LatentUpscale().upscale(x, 8 * dst[1], 8 * dst[0]),
                                  jup.LatentUpscale().upscale(x, 8 * dst[1], 8 * dst[0]))


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_common_upscale_matches_jax(method):
    """Nearest picks the same pixels; bilinear's f32 weights are torch's in
    the port and the JAX package's own gather there, a last-bit apart."""
    x = np.random.default_rng(6).standard_normal((1, 9, 13, 4)).astype(np.float32)
    np.testing.assert_allclose(tup.common_upscale(x, 20, 14, method),
                               jup.common_upscale(x, 20, 14, method), atol=1e-6, rtol=1e-5)


def _fake_apply(params, x, t, context, attn1_override=None, **kw):
    if isinstance(x, torch.Tensor):
        return torch.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)
    return jnp.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("ms", [(True, 0.5, 1, 2, False), (False, 0.5, 3, 8, False)])
@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral", "euler_cfg_pp",
                                     "euler_ancestral_cfg_pp", "euler_ancestral_dy_cfg_pp",
                                     "euler_ancestral_cfgpp"])
def test_euler_samplers_match_jax(sampler, ms):
    """Six steps over a 32x32 latent from the hires pass's "normal" schedule
    (denoise 0.45), the ancestral ones with the same step noise; euler and
    euler_ancestral take the half-res steps of the plan, the CFG++ variants
    run at full resolution in both packages."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32) * 3.0
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    sig = jks.sigmas_for(JMSD(), "normal", 6, denoise=0.45)
    noise = jnoise.step_noise_batch(x.shape, 6, 11)
    jden = jcfg.make_cfg_denoiser(_fake_apply, {}, JMSD(), jcfg.CondInput(jnp.asarray(c)),
                                  jcfg.CondInput(jnp.asarray(u)), 8.0)
    tden = tcfg.make_cfg_denoiser(_fake_apply, {}, TMSD(),
                                  tcfg.CondInput(torch.from_numpy(c)),
                                  tcfg.CondInput(torch.from_numpy(u)), 8.0)
    ref = np.asarray(jsamp.sample(jden, jnp.asarray(x), sig, sampler=sampler,
                                  ms=jsamp.MultiScale(*ms), step_noise=noise,
                                  opts=jsamp.SamplerOptions(cfg_scale=8.0)))
    out = tsamp.sample(tden, torch.from_numpy(x), sig, sampler=sampler,
                       ms=tsamp.MultiScale(*ms), step_noise=torch.from_numpy(noise),
                       opts=tsamp.SamplerOptions(cfg_scale=8.0)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    if "ancestral" in sampler:  # the noise reaches the update
        quiet = tsamp.sample(tden, torch.from_numpy(x), sig, sampler=sampler,
                             ms=tsamp.MultiScale(*ms)).numpy()
        assert np.abs(quiet - out).max() > 1e-2


def test_callback_requests_stop():
    class Stop:
        def __init__(self, flag):
            self.flag = flag

        def should_stop(self):
            if self.flag is None:
                raise RuntimeError("broken hook")
            return self.flag

    assert tsamp.callback_requests_stop(Stop(True))
    for cb in (None, lambda info: None, Stop(False)):
        assert not tsamp.callback_requests_stop(cb)
        assert jsamp.callback_requests_stop(cb) == tsamp.callback_requests_stop(cb)
    # a broken hook is an error in the port; the JAX package reads it as False
    assert not jsamp.callback_requests_stop(Stop(None))
    with pytest.raises(RuntimeError, match="broken hook"):
        tsamp.callback_requests_stop(Stop(None))


# --------------------------------------------------------------------------
# The whole flow
# --------------------------------------------------------------------------


def _write_checkpoint(root):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_tiny_assets
    finally:
        sys.path.pop(0)
    return make_tiny_assets.main(str(root))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``pipeline(PROMPT, 128, 128, hires_fix=True,
    prio_speed=True)`` from one asset root, the seed read back from the
    seed file, Python's ``random`` seeded alike before each."""
    root = tmp_path_factory.mktemp("assets")
    _write_checkpoint(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("LDT_ASSET_ROOT", str(root))
    mp.setenv("LDT_OFFLINE", "1")
    (root / "last_seed.txt").write_text(str(SEED))
    try:
        port_x, jax_x = [], []
        random.seed(7)
        port = tpipe.pipeline(PROMPT, 128, 128, hires_fix=True, prio_speed=True,
                              reuse_seed=True, device="cpu", output_dir=str(root / "port"),
                              progress_callback=lambda info: port_x.append(info["x"]))
        random.seed(7)
        ref = jpipe.pipeline(PROMPT, 128, 128, hires_fix=True, prio_speed=True,
                             reuse_seed=True, output_dir=str(root / "jax"),
                             progress_callback=lambda info: jax_x.append(np.asarray(info["x"])))
        yield dict(root=root, port=port, ref=ref, port_x=port_x, jax_x=jax_x)
    finally:
        mp.undo()


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


def test_hires_pipeline_png_matches_jax(runs):
    assert [os.path.basename(p) for p in runs["port"]] == ["LD_00001_.png"]
    assert os.path.dirname(runs["port"][0]).endswith("HiresFix")
    ours, theirs = _png(runs["port"][0]), _png(runs["ref"][0])
    assert ours.shape == theirs.shape == (256, 256, 3)
    assert np.abs(ours - theirs).max() <= 1


def test_hires_pipeline_latents_match_jax(runs):
    """20 first-pass steps at 16 x 16, then 10 hires steps at 32 x 32; the
    first pass's and the hires pass's final latents each to 1e-4."""
    shapes = [tuple(x.shape) for x in runs["port_x"]]
    assert shapes == [(1, 16, 16, 4)] * 20 + [(1, 32, 32, 4)] * 10
    assert len(runs["jax_x"]) == 30
    for i in (19, 29):
        out, ref = runs["port_x"][i].numpy(), runs["jax_x"][i]
        assert np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)) < 1e-4, i


def test_cli_hires_fix_end_to_end(runs, capsys):
    """``--hires-fix`` through the CLI on the cached model: a 256 x 256 PNG
    under HiresFix/."""
    out_dir = str(runs["root"] / "cli")
    assert tcli.main([PROMPT, "128", "128", "--hires-fix", "--prio-speed", "--output-dir",
                      out_dir], device="cpu") == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [os.path.join(out_dir, "HiresFix", "LD_00001_.png")]
    assert _png(printed[0]).shape == (256, 256, 3)


def test_hires_stops_between_passes(runs):
    """A callback whose ``should_stop`` turns true during the first pass
    ends the run before the hires pass: the first pass's decode is saved."""
    steps = []

    class Hook:
        def __call__(self, info):
            steps.append(tuple(info["x"].shape))

        def should_stop(self):
            return len(steps) >= 20

    paths = tpipe.pipeline(PROMPT, 128, 128, hires_fix=True, prio_speed=True, seed=3,
                           device="cpu", output_dir=str(runs["root"] / "stop"),
                           progress_callback=Hook())
    assert steps == [(1, 16, 16, 4)] * 20
    assert _png(paths[0]).shape == (128, 128, 3)
