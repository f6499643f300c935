"""Progress and previews (``app.instance``) in the port against the JAX
package.

- The steps a ``PreviewHook`` callback sees: ``ksample`` in both packages
  on a closed-form model (the same smooth function of x, t and the
  context in both) with the hook's stage callback at ``every`` 1 and 5
  (and 3 on the default plan), for the default multi-scale plan (2M and
  SDE), multi-scale off, the hires pass, an 8-step USDU tile, ADetailer's
  20 steps at denoise 0.5 and the dy sampler's extra steps: the same ``i``
  values with the same ``"chunk"``, equal by value; the same progress
  after each; a preview at each.
- The interrupt (``request_interrupt``): the loop stops after the step
  whose callback saw it, the partial latent comes back, and the loops over
  passes poll ``should_stop`` (a ``PreviewHook``'s reads its instance).
- A preview through TAESD and through the linear RGB map, as the JAX
  package writes it (uint8 within one level); a failed preview is logged
  and skipped; the preview file names do not collide (the JAX package's
  do: the test pins both).
- ``_resolve_callback`` (the latent format's decoder file) and
  ``_load_taesd_params`` (cached per path and mtime, a foreign file read
  as None).
- The whole flow, ``pipeline(..., progress_callback=PreviewHook(...))``,
  is in tests/test_torch_adetailer_previews.py.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch
from PIL import Image

from lightdiffusion_next_tpu.app import instance as jinst
from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import taesd as jtaesd
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu.sampling import cfg as jcfg
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch.app import instance as tinst
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling.model_sampling import ModelSamplingDiscrete as TMSD
from lightdiffusion_next_tpu_torch.utils import image as timage
from lightdiffusion_next_tpu_torch.utils import latent as tlatent



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(base):
    """An app instance that keeps each preview image and the progress at
    it, beside writing the file."""

    class Recording(base):
        def __init__(self, preview_dir):
            super().__init__(preview_dir)
            self.images, self.progress_at = [], []

        def update_image(self, image):
            self.images.append(np.asarray(image).copy())
            self.progress_at.append(self.progress.get())
            return super().update_image(image)

    return Recording


TRec, JRec = _recording(tinst.AppInstance), _recording(jinst.AppInstance)


# --------------------------------------------------------------------------
# The steps a preview callback sees, through ksample
# --------------------------------------------------------------------------


def _fake_apply(params, x, t, context, y=None, attn1_override=None, **kw):
    if isinstance(x, torch.Tensor):
        return torch.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)
    return jnp.tanh(x) * 0.5 + context.mean() * 0.1 + 1e-3 * t.reshape(-1, 1, 1, 1)


@pytest.fixture(scope="module")
def fakes():
    rng = np.random.default_rng(1)
    c, u = (rng.standard_normal((1, 77, 16)).astype(np.float32) for _ in range(2))
    return ((jbase.DiffusionModel(_fake_apply, {}, JMSD(), jlatent.SD15),
             jcfg.CondInput(jnp.asarray(c)), jcfg.CondInput(jnp.asarray(u))),
            (tbase.DiffusionModel(_fake_apply, {}, TMSD(), tlatent.SD15),
             tcfg.CondInput(torch.from_numpy(c)), tcfg.CondInput(torch.from_numpy(u))))


DEFAULT_MS = (True, 0.5, 3, 8, False)
PLANS = {
    # name: (sampler, scheduler, steps, denoise, multi-scale, latent side)
    "txt2img": ("dpmpp_2m_cfgpp", "karras", 20, 1.0, DEFAULT_MS, 16),
    "txt2img_sde": ("dpmpp_sde_cfgpp", "karras", 20, 1.0, DEFAULT_MS, 16),
    "multiscale_off": ("dpmpp_2m_cfgpp", "karras", 20, 1.0, (False, 0.5, 3, 8, False), 16),
    "intermittent": ("dpmpp_2m_cfgpp", "karras", 20, 1.0, (True, 0.5, 5, 8, True), 16),
    "hires": ("euler_ancestral_cfgpp", "normal", 10, 0.45, None, 32),
    "usdu_tile": ("dpmpp_2m_cfgpp", "karras", 8, 0.3, None, 8),
    "detailer": ("dpmpp_2m_cfgpp", "karras", 20, 0.5, None, 16),
    "dy": ("euler_cfgpp", "karras", 20, 1.0, None, 16),
}


def _steps_seen(pkg, fakes, plan, every, tmp_path):
    sampler, scheduler, steps, denoise, ms, side = PLANS[plan]
    if pkg == "jax":
        (model, c, u), _ = fakes
        inst, samp, pipe, ks = JRec(str(tmp_path / "j")), jsamp, jpipe, jks
        hook, latent = jinst.PreviewHook(inst, every=every), jnp.zeros((1, side, side, 4))
        cb = pipe._resolve_callback(hook, model.latent_format, steps, None)  # no TAESD
    else:
        _, (model, c, u) = fakes
        inst, samp, pipe, ks = TRec(str(tmp_path / "t")), tsamp, tpipe, tks
        hook, latent = tinst.PreviewHook(inst, every=every), torch.zeros((1, side, side, 4))
        cb = hook.for_stage(model.latent_format, steps)  # no TAESD
    seen = []

    def rec(info):
        seen.append((info["i"], info.get("chunk"), float(info["sigma"])))
        return cb(info)

    rec.chunk, rec.should_stop = cb.chunk, cb.should_stop
    out = ks.ksample(model, seed=3, steps=steps, cfg_scale=7.0, sampler_name=sampler,
                     scheduler=scheduler, positive=c, negative=u, latent_image=latent,
                     denoise=denoise, ms=None if ms is None else samp.MultiScale(*ms),
                     callback=rec)
    return seen, inst, np.asarray(out.latent)


@pytest.mark.parametrize("plan,every", [(plan, every) for plan in sorted(PLANS)
                                        for every in (1, 5)] + [("txt2img", 3)])
def test_preview_steps_match_jax(fakes, plan, every, tmp_path):
    seen, inst, out = _steps_seen("torch", fakes, plan, every, tmp_path)
    jseen, jinst_, jout = _steps_seen("jax", fakes, plan, every, tmp_path)
    assert seen == jseen
    assert inst.progress_at == jinst_.progress_at
    assert inst.progress.get() == jinst_.progress.get() == 1.0
    steps = PLANS[plan][2]
    assert [round(p * steps) - 1 for p in inst.progress_at] == [i for i, *_ in seen]
    if every == 1:
        assert [i for i, *_ in seen] == list(range(steps))
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=1e-5)
    assert len(os.listdir(tmp_path / "t")) == min(len(seen), tinst.KEEP_PREVIEWS)


def test_default_plan_marks():
    """SD1.5's default plan at 20 steps: full resolution for steps 0-2 and
    12-19, so with every=5 the chunks end after steps 2, 4, 9, 11, 14, 19."""
    flags = tsamp.fullres_flags(20, tsamp.MultiScale(True, 0.5, 3, 8), 128, 128)
    assert sorted(tsamp.chunk_marks(20, flags, set(), 5)) == [0, 3, 5, 10, 12, 15, 20]
    assert tsamp.chunk_marks(20, flags, set(), 1) == set()


# --------------------------------------------------------------------------
# Interrupt
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
def test_interrupt_stops_sampling(tmp_path, chunked):
    """After ``request_interrupt`` in step 1's callback the loop stops:
    steps 0 and 1 ran (chunked: the chunk that ends at step 1, every=2),
    progress 2/6, the partial latent returned; the stop poll reads it."""
    calls = {"torch": [], "jax": []}
    out = {}
    for pkg, inst_mod, samp, x0 in (("torch", tinst, tsamp, torch.zeros((1, 8, 8, 4))),
                                    ("jax", jinst, jsamp, jnp.zeros((1, 8, 8, 4)))):
        inst = inst_mod.AppInstance(preview_dir=str(tmp_path / pkg))
        inst.previewer_enabled = False
        cb = inst_mod.make_preview_callback(inst, tlatent.SD15, every=2, total_steps=6)

        def denoise(x, sigma, calls=calls[pkg]):
            calls.append(1)
            return 0.3 * x, 0.2 * x

        def interrupting(info, inst=inst, cb=cb):
            if info["i"] == 1:
                inst.request_interrupt()
            cb(info)

        if chunked:
            interrupting.chunk = cb.chunk
        sigmas = np.asarray([14.0, 8.0, 4.0, 2.0, 1.0, 0.5, 0.0], np.float32)
        out[pkg] = np.asarray(samp.sample(denoise, x0, sigmas, sampler="euler",
                                          callback=interrupting))
        assert inst.progress.get() == pytest.approx(2 / 6)
        assert cb.should_stop()
        inst.clear_interrupt()
        assert not cb.should_stop()
    assert len(calls["torch"]) == 2 and out["torch"].shape == (1, 8, 8, 4)
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_pipeline_stop_requested(tmp_path):
    """The pipeline's one stop poll, ``callback_requests_stop``, reads a
    ``PreviewHook``'s instance as the JAX ``_stop_requested`` does, and a
    callback's own ``should_stop``."""
    inst = tinst.AppInstance(str(tmp_path))
    hook, jhook = tinst.PreviewHook(inst), jinst.PreviewHook(inst)
    assert not tsamp.callback_requests_stop(hook) and not tsamp.callback_requests_stop(None)
    assert not jpipe._stop_requested(jhook)
    inst.request_interrupt()
    assert tsamp.callback_requests_stop(hook) and jpipe._stop_requested(jhook)

    class Hook:
        def __call__(self, info):
            pass

        def should_stop(self):
            return True

    assert tsamp.callback_requests_stop(Hook())
    # an interrupted hook stops the loop before anything loads
    assert tpipe.pipeline("a cat", 64, 64, seed=1, device="cpu", progress_callback=hook,
                          output_dir=str(tmp_path)) == []


# --------------------------------------------------------------------------
# Preview images and files
# --------------------------------------------------------------------------


def _info(lat, i=0):
    return {"x": lat, "i": i, "sigma": 1.0, "denoised": lat}


@pytest.mark.parametrize("taesd", [False, True])
def test_preview_image_matches_jax(tmp_path, taesd):
    lat = np.random.default_rng(8).standard_normal((2, 6, 5, 4)).astype(np.float32)
    jp = jtaesd.init_params(seed=2) if taesd else None
    tp = from_jax(jp) if taesd else None
    t, j = TRec(str(tmp_path / "t")), JRec(str(tmp_path / "j"))
    tinst.make_preview_callback(t, tlatent.SD15, tp)(_info(torch.from_numpy(lat)))
    jinst.make_preview_callback(j, jlatent.SD15, jp)(_info(jnp.asarray(lat)))
    assert t.images[0].shape == j.images[0].shape == ((1, 48, 40, 3) if taesd else (1, 6, 5, 3))
    np.testing.assert_allclose(t.images[0], j.images[0], atol=1e-4)
    (path,) = t.get_latest_previews(1)
    png = np.asarray(Image.open(path))
    want = np.asarray(Image.open(j.get_latest_previews(1)[0]))
    assert png.shape == want.shape and np.abs(png.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(png, timage.to_uint8(t.images[0])[0])


def test_failed_preview_is_logged_and_skipped(tmp_path, caplog):
    inst = tinst.AppInstance(str(tmp_path))
    bad = {k: v[..., :1] for k, v in from_jax(jtaesd.init_params(seed=2)).items()}
    cb = tinst.make_preview_callback(inst, tlatent.SD15, bad, total_steps=4)
    with caplog.at_level(logging.ERROR, logger="lightdiffusion_next_tpu_torch"):
        cb(_info(torch.zeros(1, 4, 4, 4), i=0))
    assert inst.get_latest_previews(4) == [] and inst.progress.get() == 0.25
    assert any("preview of step 0 failed" in r.getMessage() for r in caplog.records)


def test_preview_files_do_not_collide(tmp_path, monkeypatch):
    """Five previews in one millisecond: the port keeps the newest four
    files; the JAX package writes all five to one path and its pruning
    deletes it."""
    monkeypatch.setattr(tinst.time, "time", lambda: 1234.5)
    monkeypatch.setattr(jinst.time, "time", lambda: 1234.5)
    img = np.full((1, 4, 4, 3), 0.5, np.float32)
    t, j = tinst.AppInstance(str(tmp_path / "t")), jinst.AppInstance(str(tmp_path / "j"))
    for _ in range(5):
        t.update_image(img)
        j.update_image(img)
    latest = t.get_latest_previews(4)
    assert len(set(latest)) == 4 and all(os.path.exists(p) for p in latest)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.path.basename(p) for p in latest)
    assert not os.path.exists(j.get_latest_previews(1)[0])
    t.clear_previews()
    assert os.listdir(tmp_path / "t") == [] and t.get_latest_previews(4) == []
    t.previewer_enabled = False
    assert t.update_image(img) is None


def _write_taesd(root, seed=2, layout="bare"):
    dec = {k: v for k, v in jtaesd.init_params(seed=seed).items() if k.startswith("decoder.")}
    oihw = {k: np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if v.ndim == 4 else v
            for k, v in dec.items()}
    if layout == "bare":
        oihw = {k[len("decoder."):]: v for k, v in oihw.items()}
    path = os.path.join(root, "vae_approx", "taesd_decoder.safetensors")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    safetensors.numpy.save_file(oihw, path)
    return path, dec


def test_resolve_callback_and_taesd_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    monkeypatch.setattr(tpipe, "_TAESD_CACHE", {})
    assert tpipe._resolve_callback(None, tlatent.SD15, 20, "cpu") is None
    raw = lambda info: None  # noqa: E731
    assert tpipe._resolve_callback(raw, tlatent.SD15, 20, "cpu") is raw
    name = tlatent.SD15.taesd_decoder_file
    assert tpipe._load_taesd_params(name, torch.device("cpu")) is None  # no file
    path, dec = _write_taesd(str(tmp_path))
    got = tpipe._load_taesd_params(name, torch.device("cpu"))
    assert got.keys() == dec.keys()
    for k, v in from_jax(dec).items():
        assert torch.equal(got[k], v)
    assert tpipe._load_taesd_params(name, torch.device("cpu")) is got  # cached
    # a rewritten file is read again; a foreign one is None, cached too
    safetensors.numpy.save_file({"foo": np.zeros(3, np.float32)}, path)
    os.utime(path, (1, 1))
    assert tpipe._load_taesd_params(name, torch.device("cpu")) is None
    assert len(tpipe._TAESD_CACHE) == 2
    # the stage callback gets the format's decoder: the foreign file gives
    # None (the linear RGB map), a decoder file its params
    stages = []

    class Hook(tinst.PreviewHook):
        def for_stage(self, latent_format, total_steps, taesd_params=None):
            stages.append((latent_format, total_steps, taesd_params))
            return super().for_stage(latent_format, total_steps, taesd_params)

    hook = Hook(tinst.AppInstance(str(tmp_path)), every=4)
    cb = tpipe._resolve_callback(hook, tlatent.SD15, 12, "cpu")
    assert cb.chunk == 4 and not cb.should_stop()
    _write_taesd(str(tmp_path))
    tpipe._resolve_callback(hook, tlatent.SD15, 10, "cpu")
    tpipe._resolve_callback(hook, tlatent.FLUX1, 20, "cpu")  # no Flux decoder file
    assert [s[:2] for s in stages] == [(tlatent.SD15, 12), (tlatent.SD15, 10),
                                       (tlatent.FLUX1, 20)]
    assert stages[0][2] is None and stages[1][2].keys() == dec.keys() and stages[2][2] is None
