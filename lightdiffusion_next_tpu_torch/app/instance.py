"""App state: progress, interrupt and the preview files.

Counterpart of lightdiffusion_next_tpu/app/instance.py: ``ProgressTracker``,
``AppInstance`` (the ``app`` singleton), ``PreviewHook`` (what
``pipeline(progress_callback=...)`` turns into a callback per sampling
stage through its ``for_stage``) and ``make_preview_callback``. A preview decodes the step's latent with TAESD
when the pipeline found a decoder file, else through the latent format's
linear RGB map, on the latent's device, and writes a PNG on the host with
the standard-library encoder (``utils.image.encode_png``). A preview that
fails is logged with its traceback and skipped, as in the JAX package: it
never stops the generation.

One deviation: a preview's file name carries the instance's sequence
number after the millisecond clock, so two previews in one millisecond do
not share a path (in the JAX package they do, and pruning the older then
deletes the newer file; ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import List, Optional

import numpy as np

from lightdiffusion_next_tpu_torch.utils import image as image_utils

logger = logging.getLogger(__name__)

# the newest previews kept on disk
KEEP_PREVIEWS = 4


class ProgressTracker:
    """A 0..1 progress value, read and written under a lock."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value


class AppInstance:
    """The preview files, progress and interrupt flag of one app."""

    def __init__(self, preview_dir: str = "./output/preview"):
        self.preview_dir = preview_dir
        self.preview_lock = threading.Lock()
        self.progress = ProgressTracker()
        self.previewer_enabled = True
        self.interrupt_flag = False  # set through request_interrupt()
        self._preview_paths: List[str] = []
        self._written = 0

    def request_interrupt(self) -> None:
        """Stop the running generation after its current step (the preview
        callback raises ``SampleInterrupted``) and between stages."""
        self.interrupt_flag = True

    def clear_interrupt(self) -> None:
        self.interrupt_flag = False

    def update_image(self, image) -> Optional[str]:
        """Write a preview PNG of ``image`` (NHWC or HWC, [0, 1]; the first
        of a batch) and keep only the newest ``KEEP_PREVIEWS``; returns its
        path (None with the previewer off)."""
        if not self.previewer_enabled:
            return None
        arr = image_utils.to_uint8(np.asarray(image))  # the saved images' rounding
        if arr.ndim == 4:
            arr = arr[0]
        data = image_utils.encode_png(arr)
        os.makedirs(self.preview_dir, exist_ok=True)
        with self.preview_lock:
            self._written += 1
            path = os.path.join(self.preview_dir,
                                f"preview_{int(time.time() * 1e3)}_{self._written:05d}.png")
            with open(path, "wb") as f:
                f.write(data)
            self._preview_paths.append(path)
            while len(self._preview_paths) > KEEP_PREVIEWS:
                old = self._preview_paths.pop(0)
                try:
                    os.remove(old)
                except OSError:
                    pass
        return path

    def get_latest_previews(self, n: int = 1) -> List[str]:
        with self.preview_lock:
            return list(self._preview_paths[-n:])

    def clear_previews(self) -> None:
        with self.preview_lock:
            for p in self._preview_paths:
                try:
                    os.remove(p)
                except OSError:
                    pass
            self._preview_paths.clear()


app = AppInstance()


@dataclasses.dataclass
class PreviewHook:
    """A ``pipeline(progress_callback=...)`` that previews every ``every``
    steps into ``instance``: the pipeline calls ``for_stage`` at each
    sampling stage, and polls ``should_stop`` between images and stages."""

    instance: AppInstance
    every: int = 5

    def for_stage(self, latent_format, total_steps: int, taesd_params=None):
        """This stage's sampler callback: ``make_preview_callback`` with its
        latent format, step count and TAESD decoder (None: linear RGB)."""
        return make_preview_callback(self.instance, latent_format, taesd_params,
                                     every=self.every, total_steps=total_steps)

    def should_stop(self) -> bool:
        return self.instance.interrupt_flag


def make_preview_callback(instance: AppInstance, latent_format, taesd_params=None,
                          every: int = 5, total_steps: int = 20):
    """Sampler callback: progress (i + 1) / total_steps, the interrupt
    (``SampleInterrupted``), and a preview of the step's first latent when
    the sampler fires at a chunk mark (``callback.chunk = every``: the
    sampler fires only there) or, fired at every step, at each ``every``-th.
    ``callback.should_stop`` reads the interrupt flag for the loops over
    passes, tiles and segments."""

    def callback(info):
        i = info["i"]
        instance.progress.set((i + 1) / max(total_steps, 1))
        if instance.interrupt_flag:
            from lightdiffusion_next_tpu_torch.sampling.samplers import SampleInterrupted

            raise SampleInterrupted()
        chunked = bool(info.get("chunk"))
        if not instance.previewer_enabled or (not chunked and i % every != 0):
            return
        try:
            x = info["x"][:1]
            if taesd_params is not None:
                from lightdiffusion_next_tpu_torch.models import taesd

                img = taesd.decode_preview(taesd_params, x)
            else:
                from lightdiffusion_next_tpu_torch.utils.latent import latent_preview_rgb

                img = latent_preview_rgb(latent_format, x)
            instance.update_image(img)
        except Exception:
            logger.exception("preview of step %d failed", i)

    callback.chunk = every
    callback.should_stop = lambda: instance.interrupt_flag
    return callback
