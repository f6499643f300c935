"""The Gradio WebUI and its handlers.

Counterpart of lightdiffusion_next_tpu/app/webui.py: settings kept in
``webui_settings.json``, Generate run by ``generate_images_with_preview``
(one generation at a time, ``pipeline()`` on a worker thread, the previews
and progress polled every 0.5 s, an error reported as an ``"error: ..."``
status), the history gallery, the memory panel and the launch modes. The
seven runtime toggles set the port's process-wide ``RuntimeConfig``; the
pipeline runs on the GPU unless a ``device`` is passed through. Gradio is
imported only inside ``build_app`` and ``main``, so the handlers need
nothing beyond the port.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import List

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.app.instance import app as app_instance
from lightdiffusion_next_tpu_torch.utils import image as image_utils

logger = logging.getLogger(__name__)

SETTINGS_FILE = "webui_settings.json"

DEFAULT_SETTINGS = {
    "prompt": "",
    "negative_prompt": "",
    "width": 512,
    "height": 512,
    "num_images": 1,
    "batch_size": 1,
    "hires_fix": False,
    "adetailer": False,
    "enhance_prompt": False,
    "img2img_enabled": False,
    "reuse_seed": False,
    "prio_speed": False,
    "autohdr": True,
    "realistic_model": False,
    "flux_enabled": False,
    "multiscale_preset": "disabled",
    "multiscale_enabled": True,
    "multiscale_intermittent": False,
    "multiscale_factor": 0.5,
    "multiscale_fullres_start": 3,
    "multiscale_fullres_end": 8,
    "keep_models_loaded": True,
    "enable_preview": True,
    "w8a8": None,  # None: RuntimeConfig.resolve_w8a8() (GPU on, CPU off)
    "sage_attention": False,
    "flux_scan": None,  # None: resolve_flux_scan() (GPU on, CPU off)
    "fused_attn": None,  # None: resolve_fused_attn() (GPU on, CPU off)
    "fused_ew": None,  # None: resolve_fused_ew() (GPU on, CPU off)
    "packed_attn": None,  # None: resolve_packed_attn() (GPU on, CPU off)
    "qkv_fuse": None,  # None: resolve_qkv_fuse() (on everywhere)
}

# the RuntimeConfig fields a Generate call may set
TOGGLES = ("w8a8", "sage_attention", "flux_scan", "fused_attn", "fused_ew", "packed_attn",
           "qkv_fuse")


def _resolved(cfg: _config.RuntimeConfig, device=None) -> dict:
    """Each toggle's value under ``cfg`` for ``device`` (None: the GPU)."""
    return {"w8a8": cfg.resolve_w8a8(device), "sage_attention": cfg.sage_attention,
            "flux_scan": cfg.resolve_flux_scan(device),
            "fused_attn": cfg.resolve_fused_attn(device),
            "fused_ew": cfg.resolve_fused_ew(device),
            "packed_attn": cfg.resolve_packed_attn(device),
            "qkv_fuse": cfg.resolve_qkv_fuse()}


def load_settings() -> dict:
    """The saved settings over ``DEFAULT_SETTINGS`` (unknown keys dropped);
    the defaults when the file is missing or unreadable."""
    try:
        with open(SETTINGS_FILE) as f:
            data = json.load(f)
        out = dict(DEFAULT_SETTINGS)
        out.update({k: v for k, v in data.items() if k in DEFAULT_SETTINGS})
        return out
    except (OSError, ValueError, AttributeError):  # missing, not JSON, not an object
        return dict(DEFAULT_SETTINGS)


def save_settings(settings: dict) -> None:
    try:
        with open(SETTINGS_FILE, "w") as f:
            json.dump(settings, f, indent=2)
    except OSError:
        pass


# One generation at a time: a second Generate while one runs must not start
# a second thread on the shared interrupt and progress state.
_GENERATION_LOCK = threading.Lock()


def generate_images_with_preview(output_dir: str = "./output", img2img_image=None, **kwargs):
    """Run ``pipeline(output_dir=..., **kwargs)`` on a worker thread and
    yield (gallery paths, status) every 0.5 s while it runs, then the
    saved paths and "done", or ``[]`` and "error: ...".

    Handled here, not passed on: ``enable_preview``, ``keep_models_loaded``
    (the model cache's switch), the ``TOGGLES`` (a new process-wide
    ``RuntimeConfig``; a toggle not given keeps its resolved value), and
    ``img2img_enabled`` with ``img2img_image`` (a path, or an HxWx3 uint8
    array written to a temporary PNG in ``output_dir`` and removed after
    the run). A second call while one runs yields one "busy" status. If
    the caller stops iterating mid-run, the lock and the temporary file are
    released only once the worker has finished."""
    from lightdiffusion_next_tpu_torch.app.instance import PreviewHook
    from lightdiffusion_next_tpu_torch.pipelines import loader
    from lightdiffusion_next_tpu_torch.pipelines.pipeline import pipeline

    if not _GENERATION_LOCK.acquire(blocking=False):
        yield [], "busy: a generation is already in progress"
        return

    temp_img = None
    worker = None
    try:
        # merge-save: a direct caller updates only the keys it passes
        merged = load_settings()
        merged.update({k: v for k, v in kwargs.items() if k in DEFAULT_SETTINGS})
        save_settings(merged)

        app_instance.previewer_enabled = bool(kwargs.pop("enable_preview", True))
        loader.get_model_cache().set_keep_models_loaded(
            bool(kwargs.pop("keep_models_loaded", True)))

        if any(k in kwargs for k in TOGGLES):
            cfg = _config.get_config()
            values = {k: bool(kwargs.pop(k, v))
                      for k, v in _resolved(cfg, kwargs.get("device")).items()}
            _config.set_config(dataclasses.replace(cfg, **values))

        if kwargs.pop("img2img_enabled", False):
            if img2img_image is None:
                yield [], "error: img2img is enabled but no input image was provided"
                return
            if isinstance(img2img_image, str):
                kwargs["prompt"] = img2img_image
            else:
                os.makedirs(output_dir, exist_ok=True)
                temp_img = os.path.join(output_dir, "temp_img2img.png")
                with open(temp_img, "wb") as f:
                    f.write(image_utils.encode_png(img2img_image))
                kwargs["prompt"] = temp_img
            kwargs["img2img"] = True

        kwargs.setdefault("progress_callback", PreviewHook(app_instance))
        app_instance.clear_interrupt()
        app_instance.progress.set(0.0)
        result: dict = {}

        def run():
            try:
                result["paths"] = pipeline(output_dir=output_dir, **kwargs)
            except Exception as e:  # reported as the run's status
                logger.exception("generation failed")
                result["error"] = str(e)

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        while worker.is_alive():
            yield (app_instance.get_latest_previews(),
                   f"generating... {app_instance.progress.get():.0%}")
            time.sleep(0.5)
        worker.join()
        if "error" in result:
            yield [], f"error: {result['error']}"
        else:
            yield result.get("paths", []), "done"
    finally:
        def cleanup_and_release():
            if temp_img is not None and os.path.exists(temp_img):
                try:
                    os.remove(temp_img)
                except OSError:
                    pass
            _GENERATION_LOCK.release()

        if worker is not None and worker.is_alive():
            # the caller went away mid-run: the worker still samples
            def wait_then_release():
                worker.join()
                cleanup_and_release()

            threading.Thread(target=wait_then_release, daemon=True).start()
        else:
            cleanup_and_release()


def list_history(output_dir: str = "./output") -> List[str]:
    """Every PNG under ``output_dir`` outside ``preview/`` directories,
    newest first."""
    out = []
    for root, _dirs, files in os.walk(output_dir):
        if os.path.basename(root) == "preview":
            continue
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".png")]

    def mtime(p: str) -> float:
        try:  # deleted since the walk
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    return sorted(out, key=mtime, reverse=True)


def select_from_history(paths: List[str], index) -> str:
    """The history path at a gallery select event's ``index`` into the
    listing the gallery was rendered from ("" when out of range): Gradio
    serves gallery images from its own cache, and the workflow folders'
    file names collide, so the index is the only reliable handle."""
    try:
        i = int(index)
    except (TypeError, ValueError):
        return ""
    return paths[i] if 0 <= i < len(paths) else ""


def delete_history_image(path: str, output_dir: str = "./output") -> str:
    """Remove one generated image; refuses a path outside ``output_dir``."""
    if not path:
        return "no image selected"
    real = os.path.realpath(path)
    if not real.startswith(os.path.realpath(output_dir) + os.sep):
        return f"refusing to delete outside {output_dir}: {path}"
    try:
        os.remove(real)
        return f"deleted {os.path.basename(real)}"
    except OSError as e:
        return f"error deleting {os.path.basename(real)}: {e}"


def clear_history(output_dir: str = "./output") -> str:
    """Delete every generated PNG under ``output_dir``."""
    n = errors = 0
    for p in list_history(output_dir):
        try:
            os.remove(p)
            n += 1
        except OSError:
            errors += 1
    return f"deleted {n} image(s)" + (f", {errors} failed" if errors else "")


def multiscale_kwargs(preset: str, enabled: bool, intermittent: bool, factor: float,
                      fullres_start: int, fullres_end: int) -> dict:
    """The multi-scale accordion as ``pipeline()`` arguments: a named preset
    wins, "custom" passes the fields, "disabled" turns multi-scale off."""
    if preset == "custom":
        return {
            "enable_multiscale": bool(enabled),
            "multiscale_intermittent_fullres": bool(intermittent),
            "multiscale_factor": float(factor),
            "multiscale_fullres_start": int(fullres_start),
            "multiscale_fullres_end": int(fullres_end),
        }
    if preset == "disabled":
        return {"enable_multiscale": False}
    return {"multiscale_preset": preset}


def memory_info() -> str:
    from lightdiffusion_next_tpu_torch.pipelines.loader import get_model_cache

    info = get_model_cache().get_memory_info()
    gib = 1024**3
    if "bytes_in_use" in info:
        return (f"GPU {info['bytes_in_use'] / gib:.2f} / {info.get('bytes_limit', 0) / gib:.2f}"
                f" GiB · {info['cached_models']} cached model(s)")
    return f"{info['cached_models']} cached model(s)"


def build_app():
    """The Gradio Blocks app (needs ``gradio``)."""
    import gradio as gr

    s = load_settings()
    auto = _resolved(_config.get_config())

    def toggle(name: str) -> bool:
        return auto[name] if s[name] is None else s[name]

    with gr.Blocks(title="LightDiffusion") as demo:
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", value=s["prompt"], lines=3)
                negative = gr.Textbox(label="Negative prompt", value=s["negative_prompt"],
                                      lines=2)
                with gr.Row():
                    width = gr.Slider(256, 2048, value=s["width"], step=64, label="Width")
                    height = gr.Slider(256, 2048, value=s["height"], step=64, label="Height")
                with gr.Row():
                    num_images = gr.Slider(1, 8, value=s["num_images"], step=1, label="Images")
                    batch_size = gr.Slider(1, 4, value=s["batch_size"], step=1, label="Batch")
                with gr.Row():
                    hires = gr.Checkbox(value=s["hires_fix"], label="Hires fix")
                    adet = gr.Checkbox(value=s["adetailer"], label="ADetailer")
                    enh = gr.Checkbox(value=s["enhance_prompt"], label="Enhance prompt")
                with gr.Row():
                    speed = gr.Checkbox(value=s["prio_speed"], label="Prioritize speed")
                    hdr = gr.Checkbox(value=s["autohdr"], label="AutoHDR")
                    realistic = gr.Checkbox(value=s["realistic_model"], label="Realistic model")
                    flux = gr.Checkbox(value=s["flux_enabled"], label="Flux")
                with gr.Row():
                    reuse_seed = gr.Checkbox(value=s["reuse_seed"], label="Reuse seed")
                    keep_loaded = gr.Checkbox(value=s["keep_models_loaded"],
                                              label="Keep models loaded",
                                              info="Keep models resident for instant reuse")
                    preview_on = gr.Checkbox(value=s["enable_preview"],
                                             label="Real-time preview",
                                             info="TAESD previews during generation")
                    w8a8 = gr.Checkbox(value=toggle("w8a8"), label="W8A8 int8 compute (Flux)",
                                       info="int8 x int8 matmuls (K7-K11); default on the GPU")
                    sage_attn = gr.Checkbox(value=s["sage_attention"], label="Int8 attention",
                                            info="the UNet's long attention in int8 (K4)")
                    flux_scan = gr.Checkbox(value=toggle("flux_scan"),
                                            label="Flux scan-over-blocks",
                                            info="stacked DiT blocks; default on the GPU; "
                                                 "off when patching Flux with a LoRA")
                    fused_attn = gr.Checkbox(value=toggle("fused_attn"),
                                             label="Fused-prologue attention (Flux)",
                                             info="QKNorm and RoPE inside the attention "
                                                  "kernel (K3); default on the GPU")
                    fused_ew = gr.Checkbox(value=toggle("fused_ew"),
                                           label="Fused elementwise (Flux W8A8)",
                                           info="LN/modulation/GELU in the row quantization "
                                                "and gate/bias/residual in the matmul's "
                                                "epilogue; default on the GPU")
                    packed_attn = gr.Checkbox(value=toggle("packed_attn"),
                                              label="Head-packed attention (SD1.5)",
                                              info="d = 40 heads packed per tile (K1); "
                                                   "default on the GPU")
                    qkv_fuse = gr.Checkbox(value=toggle("qkv_fuse"),
                                           label="Fused QKV projection (UNet)",
                                           info="one q|k|v matmul instead of three; "
                                                "the same math (default on)")
                with gr.Row():
                    img2img = gr.Checkbox(value=s["img2img_enabled"], label="Image to image")
                img2img_image = gr.Image(label="Input image for img2img",
                                         visible=bool(s["img2img_enabled"]))
                img2img.change(fn=lambda x: gr.update(visible=x), inputs=[img2img],
                               outputs=[img2img_image])
                with gr.Accordion("Multi-scale diffusion", open=False):
                    ms_preset = gr.Dropdown(
                        ["custom", "disabled", "quality", "performance", "balanced"],
                        value=s["multiscale_preset"],
                        label="Preset (custom = use fields below)")
                    ms_enabled = gr.Checkbox(value=s["multiscale_enabled"],
                                             label="Enable multi-scale")
                    ms_intermittent = gr.Checkbox(value=s["multiscale_intermittent"],
                                                  label="Intermittent full-res")
                    ms_factor = gr.Slider(0.1, 1.0, value=s["multiscale_factor"], step=0.05,
                                          label="Scale factor")
                    ms_start = gr.Slider(0, 10, value=s["multiscale_fullres_start"], step=1,
                                         label="Full-res start steps")
                    ms_end = gr.Slider(0, 10, value=s["multiscale_fullres_end"], step=1,
                                       label="Full-res end steps")
                with gr.Row():
                    go = gr.Button("Generate", variant="primary")
                    stop = gr.Button("Interrupt")
            with gr.Column():
                gallery = gr.Gallery(label="Output")
                status = gr.Textbox(label="Status", interactive=False)
                mem = gr.Textbox(label="Memory", value=memory_info(), interactive=False)
                with gr.Row():
                    refresh_mem = gr.Button("Refresh memory")
                    clear_cache = gr.Button("Clear model cache")
                initial_history = list_history()
                history = gr.Gallery(label="History", value=initial_history)
                with gr.Row():
                    refresh_hist = gr.Button("Refresh history")
                    delete_img = gr.Button("Delete selected image")
                    clear_all = gr.Button("Clear all images", variant="stop")
                action_status = gr.Textbox(label="History actions", interactive=False)
                selected_path = gr.State("")
                history_paths = gr.State(initial_history)

        def on_generate(prompt, negative, width, height, num_images, batch_size, hires,
                        adet, enh, speed, hdr, realistic, flux, reuse, keep, prev,
                        use_w8a8, use_sage, use_flux_scan, use_fused, use_fused_ew,
                        use_packed, use_qkv_fuse, i2i_enabled, i2i_image, ms_preset,
                        ms_enabled, ms_intermittent, ms_factor, ms_start, ms_end):
            ms_kwargs = multiscale_kwargs(ms_preset, ms_enabled, ms_intermittent, ms_factor,
                                          ms_start, ms_end)
            toggles = {"w8a8": bool(use_w8a8), "sage_attention": bool(use_sage),
                       "flux_scan": bool(use_flux_scan), "fused_attn": bool(use_fused),
                       "fused_ew": bool(use_fused_ew), "packed_attn": bool(use_packed),
                       "qkv_fuse": bool(use_qkv_fuse)}
            save_settings({
                "prompt": prompt, "negative_prompt": negative, "width": int(width),
                "height": int(height), "num_images": int(num_images),
                "batch_size": int(batch_size), "hires_fix": hires, "adetailer": adet,
                "enhance_prompt": enh, "img2img_enabled": bool(i2i_enabled),
                "reuse_seed": bool(reuse), "prio_speed": speed, "autohdr": hdr,
                "realistic_model": realistic, "flux_enabled": flux,
                "multiscale_preset": ms_preset, "multiscale_enabled": bool(ms_enabled),
                "multiscale_intermittent": bool(ms_intermittent),
                "multiscale_factor": float(ms_factor),
                "multiscale_fullres_start": int(ms_start),
                "multiscale_fullres_end": int(ms_end),
                "keep_models_loaded": bool(keep), "enable_preview": bool(prev), **toggles,
            })
            paths, state = [], "starting"
            for paths, state in generate_images_with_preview(
                prompt=prompt, negative_prompt=negative or None, w=int(width), h=int(height),
                number=int(num_images), batch=int(batch_size), hires_fix=hires,
                adetailer=adet, enhance_prompt=enh, reuse_seed=bool(reuse),
                keep_models_loaded=bool(keep), enable_preview=bool(prev), **toggles,
                img2img_enabled=bool(i2i_enabled), img2img_image=i2i_image,
                prio_speed=speed, autohdr=hdr, realistic_model=realistic,
                flux_enabled=flux, **ms_kwargs,
            ):
                yield paths, state, gr.update(), gr.update()
            listing = list_history()  # the finished images, from disk
            yield paths, state, listing, listing

        go.click(on_generate,
                 [prompt, negative, width, height, num_images, batch_size, hires, adet, enh,
                  speed, hdr, realistic, flux, reuse_seed, keep_loaded, preview_on, w8a8,
                  sage_attn, flux_scan, fused_attn, fused_ew, packed_attn, qkv_fuse, img2img,
                  img2img_image, ms_preset, ms_enabled, ms_intermittent, ms_factor, ms_start,
                  ms_end],
                 [gallery, status, history, history_paths])

        def on_refresh_history():
            listing = list_history()
            return listing, listing

        refresh_hist.click(on_refresh_history, None, [history, history_paths])
        refresh_mem.click(lambda: memory_info(), None, mem)
        stop.click(lambda: app_instance.request_interrupt(), None, None)

        def on_clear():
            from lightdiffusion_next_tpu_torch.pipelines.loader import get_model_cache

            get_model_cache().clear()
            return memory_info()

        clear_cache.click(on_clear, None, mem)

        def on_select(paths, evt: gr.SelectData):
            return select_from_history(paths, evt.index)

        history.select(on_select, history_paths, selected_path)

        def on_delete(path):
            msg = delete_history_image(path)
            listing = list_history()
            return msg, listing, listing, ""

        delete_img.click(on_delete, selected_path,
                         [action_status, history, history_paths, selected_path])

        def on_clear_all():
            msg = clear_history()
            listing = list_history()
            return msg, listing, listing, ""

        clear_all.click(on_clear_all, None,
                        [action_status, history, history_paths, selected_path])
    return demo


def main():
    """Launch: a Hugging Face Space (``SPACE_ID``: 0.0.0.0:7860), Docker
    (both ``GRADIO_SERVER_NAME`` and ``GRADIO_SERVER_PORT``), else
    127.0.0.1 at ``GRADIO_SERVER_PORT`` or ``LDT_PORT`` (7860), with a
    public share link only under ``LDT_SHARE=1``."""
    demo = build_app()
    os.makedirs("./output/preview", exist_ok=True)
    if "SPACE_ID" in os.environ:
        demo.launch(server_name="0.0.0.0", server_port=7860)
    elif "GRADIO_SERVER_NAME" in os.environ and "GRADIO_SERVER_PORT" in os.environ:
        demo.launch(server_name=os.environ["GRADIO_SERVER_NAME"],
                    server_port=int(os.environ["GRADIO_SERVER_PORT"]))
    else:
        demo.launch(server_name="127.0.0.1",
                    server_port=int(os.environ.get("GRADIO_SERVER_PORT",
                                                   os.environ.get("LDT_PORT", "7860"))),
                    share=os.environ.get("LDT_SHARE") == "1")


if __name__ == "__main__":
    main()
