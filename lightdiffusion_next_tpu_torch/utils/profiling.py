"""Tracing, timing and progress.

Counterpart of lightdiffusion_next_tpu/utils/profiling.py:

- ``set_progress_bar_enabled`` and ``ProgressBar``: an it/s bar on stderr;
- ``trace(log_dir)``: ``torch.profiler`` around a block (the CPU, and the
  GPU where there is one), written as a Chrome trace under ``log_dir``;
- ``timed(label)``: the block's wall seconds, logged;
- ``device_memory_stats()``: ``torch.cuda.memory_stats()`` with the JAX
  names the UI reads (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``); ``{}`` without a GPU;
- ``compile_log(enabled)``: logs each kernel library ``ops/cuda_build``
  builds or loads, the port's counterpart of XLA's compile log.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Optional

import torch

from lightdiffusion_next_tpu_torch.ops import cuda_build

logger = logging.getLogger(__name__)
_handler = logging.StreamHandler()
_handler.setFormatter(logging.Formatter("%(message)s"))
if not logger.handlers:
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)

PROGRESS_BAR_ENABLED = True


def set_progress_bar_enabled(enabled: bool) -> None:
    global PROGRESS_BAR_ENABLED
    PROGRESS_BAR_ENABLED = enabled


class ProgressBar:
    """A minimal bar: count of total and iterations per second."""

    def __init__(self, total: int, desc: str = "", stream=sys.stderr):
        self.total = total
        self.current = 0
        self.desc = desc
        self.start = time.perf_counter()
        self.stream = stream

    def update(self, n: int = 1) -> None:
        self.current += n
        if not PROGRESS_BAR_ENABLED:
            return
        self.stream.write(f"\r{self.desc} {self.current}/{self.total} [{self.it_per_s:.2f} it/s]")
        if self.current >= self.total:
            self.stream.write("\n")
        self.stream.flush()

    def update_absolute(self, value: int) -> None:
        self.update(value - self.current)

    @property
    def it_per_s(self) -> float:
        dt = time.perf_counter() - self.start
        return self.current / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``log_dir/trace_<ms>.json``; nothing without ``log_dir``."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    yield
    logger.info("%s: %.3fs", label, time.perf_counter() - t0)


def device_memory_stats() -> dict:
    """The GPU's allocator statistics and, under the JAX names, the bytes
    in use, their peak and the card's total; ``{}`` without a GPU."""
    if not torch.cuda.is_available():
        return {}
    stats = dict(torch.cuda.memory_stats())
    stats.update(bytes_in_use=stats.get("allocated_bytes.all.current", 0),
                 peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
                 bytes_limit=torch.cuda.mem_get_info()[1])
    return stats


def compile_log(enabled: bool = True) -> None:
    """Log every kernel library built or loaded (off by default)."""
    cuda_build.logger.setLevel(logging.DEBUG if enabled else logging.NOTSET)
    if enabled and _handler not in cuda_build.logger.handlers:
        cuda_build.logger.addHandler(_handler)
    elif not enabled:
        cuda_build.logger.removeHandler(_handler)
