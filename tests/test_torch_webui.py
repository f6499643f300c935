"""The port's WebUI handlers (``app/webui.py``) case for case against the JAX
package's ``tests/test_app.py``, with ``pipeline`` monkeypatched where that
test patches it, plus what the port adds to check: the settings table and
the multi-scale mapping equal to the JAX ones, the seven toggles setting
the port's ``RuntimeConfig``, a pipeline error reported as a status, and
``build_app`` without ``gradio``.

The first cases (preview hook, callback resolution, interrupt) run the
port's tiny UNet or a closed-form denoiser through its sampler; f32, no
tolerance is compared there, only progress, files and call counts.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.app import webui as jwebui
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.app import instance as instance_mod
from lightdiffusion_next_tpu_torch.app import webui
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.pipelines import loader as loader_mod
from lightdiffusion_next_tpu_torch.pipelines import pipeline as pipeline_mod
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg
from lightdiffusion_next_tpu_torch.sampling import ksampler as ks
from lightdiffusion_next_tpu_torch.utils import image as image_utils
from lightdiffusion_next_tpu_torch.utils import latent as latent_mod

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), context_dim=64, num_heads=4)


@pytest.fixture(autouse=True)
def settings_in_tmp(monkeypatch, tmp_path):
    """webui_settings.json lands in the test's directory, and the process-wide
    config, preview switch and cache switch come back as they were."""
    monkeypatch.chdir(tmp_path)
    saved = tconfig.get_config()
    keep = loader_mod.get_model_cache().keep_models_loaded
    yield
    tconfig.set_config(saved)
    instance_mod.app.previewer_enabled = True
    loader_mod.get_model_cache().set_keep_models_loaded(keep)


def test_preview_hook_produces_previews_and_progress(tmp_path):
    """PreviewHook -> _resolve_callback -> ksample: preview PNGs appear and
    progress lands in (0, 1]."""
    model = tbase.sd15_model(from_jax(junet.init_params(junet.UNetConfig(**TINY), seed=0)),
                             cfg=tunet.UNetConfig(**TINY), device="cpu")
    rng = np.random.default_rng(2)
    positive, negative = (tcfg.CondInput(cross_attn=torch.from_numpy(
        rng.standard_normal((1, 77, 64)).astype(np.float32))) for _ in range(2))
    inst = instance_mod.AppInstance(preview_dir=str(tmp_path / "preview"))
    hook = instance_mod.PreviewHook(inst, every=1)
    cb = pipeline_mod._resolve_callback(hook, model.latent_format, 3, "cpu")
    assert callable(cb)
    ks.ksample(model, seed=1, steps=3, cfg_scale=7.0, sampler_name="euler",
               scheduler="normal", positive=positive, negative=negative,
               latent_image=latent_mod.empty_latent(64, 64, 1), callback=cb)
    assert 0.0 < inst.progress.get() <= 1.0
    previews = inst.get_latest_previews(4)
    assert previews, "no preview files were written"
    for p in previews:
        assert os.path.exists(p) and p.endswith(".png")


def test_resolve_callback_passthrough_and_none():
    assert pipeline_mod._resolve_callback(None, latent_mod.SD15, 20, "cpu") is None
    raw = lambda info: None  # noqa: E731
    assert pipeline_mod._resolve_callback(raw, latent_mod.SD15, 20, "cpu") is raw


def test_webui_generator_injects_preview_hook(monkeypatch, tmp_path):
    captured = {}

    def fake_pipeline(output_dir=None, progress_callback=None, **kw):
        captured["cb"] = progress_callback
        return [os.path.join(str(tmp_path), "out.png")]

    monkeypatch.setattr(pipeline_mod, "pipeline", fake_pipeline)
    outputs = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="hello",
                                                      w=64, h=64))
    assert isinstance(captured["cb"], instance_mod.PreviewHook)
    paths, status = outputs[-1]
    assert status == "done" and paths


def test_interrupt_stops_sampling(tmp_path):
    """request_interrupt() stops the loop: the partial latent comes back and
    the later steps never run."""
    from lightdiffusion_next_tpu_torch.sampling import samplers

    inst = instance_mod.AppInstance(preview_dir=str(tmp_path / "p"))
    inst.previewer_enabled = False
    cb = instance_mod.make_preview_callback(inst, latent_mod.SD15, total_steps=6)
    calls = []

    def denoise(x, sigma):
        calls.append(1)
        return 0.3 * x, 0.2 * x

    sigmas = np.asarray([14.0, 8.0, 4.0, 2.0, 1.0, 0.5, 0.0], np.float32)
    x0 = torch.zeros((1, 8, 8, 4))

    def interrupting_cb(info):
        if info["i"] == 1:
            inst.request_interrupt()
        cb(info)

    out = samplers.sample(denoise, x0, sigmas, sampler="euler", callback=interrupting_cb)
    assert out.shape == x0.shape
    assert len(calls) == 2  # steps 0 and 1 ran; the interrupt fired in step 1's callback
    assert inst.progress.get() == pytest.approx(2 / 6)
    inst.clear_interrupt()
    assert not inst.interrupt_flag


def test_history_delete_and_clear(tmp_path):
    out = tmp_path / "output"
    (out / "Classic").mkdir(parents=True)
    (out / "Flux").mkdir()
    (out / "preview").mkdir()
    a = out / "Classic" / "LD_00001_.png"
    b = out / "Flux" / "LD_00002_.png"
    for p in (a, b, out / "preview" / "p.png"):
        p.write_bytes(b"png")
    outside = tmp_path / "precious.png"
    outside.write_bytes(b"png")

    assert sorted(webui.list_history(str(out))) == sorted([str(a), str(b)])
    assert sorted(webui.list_history(str(out))) == sorted(jwebui.list_history(str(out)))
    msg = webui.delete_history_image(str(a), output_dir=str(out))
    assert "deleted" in msg and not a.exists() and b.exists()
    msg = webui.delete_history_image(str(outside), output_dir=str(out))
    assert "refusing" in msg and outside.exists()
    assert "no image" in webui.delete_history_image("", output_dir=str(out))

    listing = webui.list_history(str(out))
    for index in (0, len(listing), None, "x"):
        assert (webui.select_from_history(listing, index)
                == jwebui.select_from_history(listing, index))
    assert webui.select_from_history(listing, 0) == listing[0]
    assert webui.select_from_history(listing, len(listing)) == ""

    msg = webui.clear_history(str(out))
    assert "deleted 1" in msg
    assert webui.list_history(str(out)) == []


@pytest.mark.parametrize("args", [("custom", True, False, 0.25, 2, 5),
                                  ("disabled", True, True, 0.5, 3, 8),
                                  ("quality", False, False, 0.5, 3, 8),
                                  ("balanced", True, True, 0.75, "1", "9")])
def test_multiscale_kwargs_mapping(args):
    assert webui.multiscale_kwargs(*args) == jwebui.multiscale_kwargs(*args)
    if args[0] == "custom":
        assert webui.multiscale_kwargs(*args) == {
            "enable_multiscale": True, "multiscale_intermittent_fullres": False,
            "multiscale_factor": 0.25, "multiscale_fullres_start": 2,
            "multiscale_fullres_end": 5}


def test_default_settings_equal_jax():
    assert webui.DEFAULT_SETTINGS == jwebui.DEFAULT_SETTINGS
    assert webui.load_settings() == webui.DEFAULT_SETTINGS  # no file yet
    with open(webui.SETTINGS_FILE, "w") as f:
        f.write("{not json")
    assert webui.load_settings() == webui.DEFAULT_SETTINGS


def test_settings_merge_save(monkeypatch):
    """The handler merge-updates the settings, and does not overwrite the
    whole saved UI state with its partial kwargs."""
    webui.save_settings({**webui.DEFAULT_SETTINGS, "multiscale_factor": 0.25, "junk": 1})
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: ["x.png"])
    list(webui.generate_images_with_preview(prompt="p", w=64, h=64))
    assert webui.load_settings()["multiscale_factor"] == 0.25
    assert webui.load_settings()["prompt"] == "p"
    assert "junk" not in webui.load_settings()


def test_img2img_temp_file_routing(monkeypatch, tmp_path):
    """The img2img checkbox and an uploaded array go through a temporary PNG
    (the port's writer) that is the pipeline's prompt and is removed after
    the run; a path upload passes through."""
    captured = {}

    def fake_pipeline(**kw):
        captured.update(kw)
        captured["image"] = image_utils.load_image(kw["prompt"])
        return ["x.png"]

    monkeypatch.setattr(pipeline_mod, "pipeline", fake_pipeline)
    img = np.random.default_rng(0).integers(0, 256, (16, 12, 3), dtype=np.uint8)
    outputs = list(webui.generate_images_with_preview(
        output_dir=str(tmp_path / "out"), prompt="ignored", w=64, h=64,
        img2img_enabled=True, img2img_image=img))
    assert outputs[-1][1] == "done"
    assert captured["img2img"] is True
    assert captured["prompt"].endswith("temp_img2img.png")
    assert np.array_equal(image_utils.to_uint8(captured["image"])[0], img)
    assert not os.path.exists(captured["prompt"])  # cleaned up

    src = tmp_path / "src.png"
    src.write_bytes(image_utils.encode_png(img))
    list(webui.generate_images_with_preview(
        output_dir=str(tmp_path / "out"), prompt="ignored", w=64, h=64,
        img2img_enabled=True, img2img_image=str(src)))
    assert captured["prompt"] == str(src) and src.exists()


def test_preview_and_keep_models_toggles(monkeypatch, tmp_path):
    captured = {}
    monkeypatch.setattr(pipeline_mod, "pipeline",
                        lambda **kw: captured.update(kw) or ["x.png"])
    cache = loader_mod.get_model_cache()
    cache.put(str(tmp_path / "m.ckpt"), "resident", "v")
    list(webui.generate_images_with_preview(
        output_dir=str(tmp_path), prompt="p", w=64, h=64, enable_preview=False,
        keep_models_loaded=False, reuse_seed=True))
    assert instance_mod.app.previewer_enabled is False
    assert cache.keep_models_loaded is False
    assert cache.get_memory_info()["cached_models"] == 0  # turning it off emptied it
    cache.put(str(tmp_path / "m.ckpt"), "resident", "v")
    assert cache.get(str(tmp_path / "m.ckpt"), "v") is None  # and nothing is kept
    assert captured["reuse_seed"] is True
    assert "enable_preview" not in captured and "keep_models_loaded" not in captured
    saved = webui.load_settings()
    assert saved["enable_preview"] is False
    assert saved["keep_models_loaded"] is False
    assert saved["reuse_seed"] is True
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64))
    cache.put(str(tmp_path / "m.ckpt"), "resident", "v")
    assert cache.get(str(tmp_path / "m.ckpt"), "v") == "resident"


def _slow_pipeline(calls, started, release):
    def slow(**kw):
        calls.append(1)
        started.set()
        release.wait(timeout=10)
        return ["x.png"]
    return slow


def test_concurrent_generation_guard(monkeypatch, tmp_path):
    """A second Generate while one runs starts no second pipeline thread."""
    release, started, calls = threading.Event(), threading.Event(), []
    monkeypatch.setattr(pipeline_mod, "pipeline", _slow_pipeline(calls, started, release))
    first_result = []
    t = threading.Thread(target=lambda: first_result.extend(
        webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64)))
    t.start()
    assert started.wait(timeout=10)
    second = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="q",
                                                     w=64, h=64))
    assert second == [([], "busy: a generation is already in progress")]
    release.set()
    t.join(timeout=10)
    assert len(calls) == 1
    assert first_result[-1][1] == "done"
    third = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="r",
                                                    w=64, h=64))
    assert third[-1][1] == "done" and len(calls) == 2


def test_disconnect_mid_run_keeps_guard_until_worker_done(monkeypatch, tmp_path):
    """Closing the generator while the worker runs keeps the guard (and the
    temporary input) until the worker is done."""
    release, started, calls = threading.Event(), threading.Event(), []
    seen = {}
    slow = _slow_pipeline(calls, started, release)

    def pipeline(**kw):
        seen["prompt"] = kw["prompt"]
        return slow(**kw)

    monkeypatch.setattr(pipeline_mod, "pipeline", pipeline)
    gen = webui.generate_images_with_preview(
        output_dir=str(tmp_path), prompt="p", w=64, h=64, img2img_enabled=True,
        img2img_image=np.zeros((8, 8, 3), np.uint8))
    next(gen)
    assert started.wait(timeout=10)
    gen.close()
    second = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="q",
                                                     w=64, h=64))
    assert second == [([], "busy: a generation is already in progress")]
    assert len(calls) == 1 and os.path.exists(seen["prompt"])
    release.set()
    deadline = time.time() + 10
    while time.time() < deadline:
        if webui._GENERATION_LOCK.acquire(blocking=False):
            webui._GENERATION_LOCK.release()
            break
        time.sleep(0.05)
    else:
        raise AssertionError("guard never released after worker completion")
    assert not os.path.exists(seen["prompt"])
    third = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="r",
                                                    w=64, h=64))
    assert third[-1][1] == "done" and len(calls) == 2


def test_img2img_without_image_errors(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: calls.append(1) or ["x.png"])
    outs = list(webui.generate_images_with_preview(
        output_dir=str(tmp_path), prompt="p", w=64, h=64, img2img_enabled=True,
        img2img_image=None))
    assert outs == [([], "error: img2img is enabled but no input image was provided")]
    assert calls == []


def test_pipeline_error_is_a_status(monkeypatch, tmp_path):
    """A pipeline that raises ends the run with an "error: ..." status and
    releases the guard."""
    def broken(**kw):
        raise FileNotFoundError("checkpoint missing: x")

    monkeypatch.setattr(pipeline_mod, "pipeline", broken)
    outs = list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p",
                                                   w=64, h=64))
    assert outs[-1] == ([], "error: checkpoint missing: x")
    assert webui._GENERATION_LOCK.acquire(blocking=False)
    webui._GENERATION_LOCK.release()


def test_cli_preview_flag_parses():
    from lightdiffusion_next_tpu_torch.app.cli import build_parser

    assert build_parser().parse_args(["a cat", "64", "64", "--preview"]).preview


@pytest.mark.parametrize("field", webui.TOGGLES)
@pytest.mark.parametrize("value", [True, False])
def test_toggle_sets_config(field, value, monkeypatch, tmp_path):
    """Each checkbox sets its RuntimeConfig field, is saved, and is popped
    before the pipeline call; the other toggles take their resolved values
    for the pipeline's device."""
    captured = {}
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: captured.update(kw) or ["x"])
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            device="cpu", **{field: value}))
    cfg = tconfig.get_config()
    assert getattr(cfg, field) is value
    assert field not in captured and captured["device"] == "cpu"
    assert webui.load_settings()[field] is value
    auto = tconfig.RuntimeConfig()
    for other in webui.TOGGLES:
        if other != field:
            want = webui._resolved(auto, "cpu")[other]
            assert getattr(cfg, other) is want


def test_w8a8_toggle_sets_config(monkeypatch, tmp_path):
    captured = {}
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: captured.update(kw) or ["x"])
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            w8a8=True))
    assert tconfig.get_config().w8a8 is True
    assert "w8a8" not in captured
    assert webui.load_settings()["w8a8"] is True
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            w8a8=False))
    assert tconfig.get_config().w8a8 is False


def test_packed_attn_toggle_sets_config(monkeypatch, tmp_path):
    captured = {}
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: captured.update(kw) or ["x"])
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            packed_attn=True))
    assert tconfig.get_config().packed_attn is True
    assert "packed_attn" not in captured
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            packed_attn=False))
    assert tconfig.get_config().packed_attn is False


def test_cli_packed_attn_flags():
    from lightdiffusion_next_tpu_torch.app.cli import build_parser

    p = build_parser()
    assert p.parse_args(["a cat", "64", "64", "--packed-attn"]).packed_attn
    assert p.parse_args(["a cat", "64", "64", "--no-packed-attn"]).no_packed_attn


def test_memory_info_and_build_app_without_gradio(monkeypatch):
    """The memory panel's text on the CPU, and ``build_app`` (like ``main``)
    raising an ImportError that names gradio, which neither machine has."""
    assert webui.memory_info().endswith("cached model(s)")
    monkeypatch.setitem(__import__("sys").modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        webui.build_app()
    with pytest.raises(ImportError, match="gradio"):
        webui.main()


def test_rerun_after_config_change_uses_new_values(monkeypatch, tmp_path):
    """Values set by one Generate persist into the next one's defaults: a
    toggle not passed keeps the config's current value."""
    monkeypatch.setattr(pipeline_mod, "pipeline", lambda **kw: ["x"])
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            qkv_fuse=False, device="cpu"))
    list(webui.generate_images_with_preview(output_dir=str(tmp_path), prompt="p", w=64, h=64,
                                            sage_attention=True, device="cpu"))
    cfg = tconfig.get_config()
    assert cfg.qkv_fuse is False and cfg.sage_attention is True


def test_generation_guard_under_contention(monkeypatch, tmp_path):
    """Many Generates at once, thread switches forced often: exactly one
    runs the pipeline, every other one is refused, and the lock is free
    after."""
    import sys

    release, started, calls = threading.Event(), threading.Event(), []
    monkeypatch.setattr(pipeline_mod, "pipeline", _slow_pipeline(calls, started, release))
    results, barrier = [], threading.Barrier(16)

    def click():
        barrier.wait(timeout=10)
        results.append(list(webui.generate_images_with_preview(
            output_dir=str(tmp_path), prompt="p", w=64, h=64)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=click) for _ in range(16)]
        for t in threads:
            t.start()
        assert started.wait(timeout=10)
        time.sleep(0.2)
        release.set()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    busy = [([], "busy: a generation is already in progress")]
    assert len(calls) == 1 and len(results) == 16
    assert sum(r == busy for r in results) == 15
    assert sum(r[-1][1] == "done" for r in results) == 1
    assert webui._GENERATION_LOCK.acquire(blocking=False)
    webui._GENERATION_LOCK.release()
