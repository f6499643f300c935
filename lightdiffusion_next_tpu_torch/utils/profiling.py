"""Spans, tracing and device statistics.

Counterpart of lightdiffusion_next_tpu/utils/profiling.py's ``trace``,
``device_memory_stats`` and compile log, with the port's own spans:

- ``span(name)``: a context manager around a piece of the program's host
  work. Off (the default) it returns one shared no-op object: no clock is
  read and nothing is allocated, after one look at a module flag. On
  (``enable(True)``, or inside ``trace``) it appends ``(id, parent id,
  request id, name, start_ns, end_ns)`` to its thread's list when it
  closes. The stamps are ``time.time_ns()``, the clock ``torch.profiler``
  puts its host and device events on, so spans and device intervals can be
  laid side by side. The parent is the innermost span open on the same
  thread (a per-thread stack: the WebUI runs ``pipeline()`` from a worker
  thread);
- ``request(name)``: a span that takes the next request id; every span
  opened inside it on its thread carries that id (``pipeline()`` opens one
  per call; spans outside any request carry None);
- ``kernel_span(name)``: a decorator, each call of the function in
  ``span(name)`` (the kernel wrappers take it through
  ``ops.grad_guard.no_backward``);
- ``enable(on)``, ``spans(thread=None)`` (every thread's records, or one
  thread's by its ident) and ``reset()``;
- ``trace(log_dir)``: ``torch.profiler`` around a block (the CPU, and the
  GPU where there is one), written as a Chrome trace under ``log_dir``,
  with spans on for the block, each also a ``record_function`` range so
  the trace shows the program's spans above the device rows;
- ``device_memory_stats()``: ``torch.cuda.memory_stats()`` with the JAX
  names the UI reads (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``); ``{}`` without a GPU;
- ``compile_log(enabled)``: logs each kernel library ``ops/cuda_build``
  builds or loads, the port's counterpart of XLA's compile log.

Span names start with their layer: ``pipeline``, ``sampling.``,
``models.``, ``kernels.``; ``sync.<site>`` is a point that blocks the host
until the device has drained its queue; ``callback`` is the caller's
progress callback. No span synchronises the device, allocates device
memory or writes a file.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)
_handler = logging.StreamHandler()
_handler.setFormatter(logging.Formatter("%(message)s"))
if not logger.handlers:
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)

Record = Tuple[int, Optional[int], Optional[int], str, int, int]

_enabled = False
_record_function = False  # inside trace(): spans also enter record_function
_clock = time.time_ns
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_threads: List[Tuple[int, List[Record]]] = []  # (thread ident, its records)
_threads_lock = threading.Lock()


class _Off:
    """The span while tracing is off: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _thread_state():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.records = []
        with _threads_lock:
            _threads.append((threading.get_ident(), _local.records))
    return stack


class _Span:
    __slots__ = ("name", "new_request", "id", "parent", "request", "start", "range")

    def __init__(self, name: str, new_request: bool):
        self.name, self.new_request = name, new_request

    def __enter__(self):
        stack = _thread_state()
        self.parent, self.request = stack[-1] if stack else (None, None)
        if self.new_request:
            self.request = next(_requests)
        self.id = next(_ids)
        stack.append((self.id, self.request))
        self.range = None
        if _record_function:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _local.records.append((self.id, self.parent, self.request, self.name, self.start, end))
        return False


def span(name: str):
    """The block as a span named ``name`` (see the module's docstring)."""
    if not _enabled:
        return _OFF
    return _Span(name, False)


def request(name: str):
    """A span that takes the next request id for itself and every span
    inside it on its thread."""
    if not _enabled:
        return _OFF
    return _Span(name, True)


def kernel_span(name: str):
    """Decorate a function: each call runs in ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _Span(name, False):
                return fn(*args, **kwargs)

        return spanned

    return wrap


def enable(on: bool = True) -> None:
    """Record spans (``on``) or not; what was recorded stays until
    ``reset()``."""
    global _enabled
    _enabled = bool(on)


def spans(thread: Optional[int] = None) -> List[Record]:
    """The closed spans, in the order they closed within each thread: every
    thread's, or only those of the thread whose ident is ``thread``."""
    with _threads_lock:
        lists = [recs for ident, recs in _threads if thread is None or ident == thread]
    return [r for recs in lists for r in list(recs)]


def reset() -> None:
    """Forget every closed span (open ones are recorded when they close),
    and the threads that have ended."""
    alive = {t.ident for t in threading.enumerate()}
    with _threads_lock:
        _threads[:] = [(ident, recs) for ident, recs in _threads if ident in alive]
        for _, recs in _threads:
            recs.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block with spans on, its Chrome trace
    written to ``log_dir/trace_<ms>.json``; nothing without ``log_dir``."""
    global _enabled, _record_function
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = _enabled
    with torch.profiler.profile(activities=activities) as prof:
        _enabled = _record_function = True
        try:
            yield
        finally:
            _enabled, _record_function = was, False
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


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
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    cuda_build.logger.setLevel(logging.DEBUG if enabled else logging.NOTSET)
    if enabled and _handler not in cuda_build.logger.handlers:
        cuda_build.logger.addHandler(_handler)
    elif not enabled:
        cuda_build.logger.removeHandler(_handler)
