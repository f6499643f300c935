"""The trainer's input pipeline: batches copied to the device ahead of the
step that takes them.

Counterpart of lightdiffusion_next_tpu/parallel/data.py. A background
thread pulls host batches (dicts, lists or tuples of numpy arrays or
tensors) from the source, keeps this rank's rows of each along the mesh's
"data" axis, copies them to the device and parks up to ``depth`` of them in
a bounded queue, so the next batch's host-to-device copy runs under the
current step. Leaves of rank 0 (per-batch scalars, step counters) stay
whole, as JAX's loader replicates the leaves below its spec's rank. A
numpy leaf of a 64-bit dtype arrives in its 32-bit one, as ``jax.device_put``
places it; a tensor keeps its dtype.

On the GPU each batch is staged in pinned host memory and copied with
``non_blocking=True`` on a side stream; the consumer's stream waits on an
event recorded after the copy, and each tensor is marked as used by the
consumer's stream (``record_stream``), so the caching allocator does not
hand its memory to the next copy while the step still reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.parallel import inference


# numpy's 64-bit dtypes as jax.device_put places them (64-bit types off, JAX's
# default): a float64 draw reaches the step as float32
_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
        np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


class _Stop:
    pass


def _map(fn, batch):
    """``fn`` on every array or tensor leaf of a dict, list or tuple."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


class PrefetchLoader:
    """Iterate device-resident batches, copied ``depth`` ahead.

    ``source``: an iterable (or a zero-argument callable returning an
    iterator) of host batches. ``mesh``: None (each batch whole) or the
    trainer's mesh (this rank's "data" rows of every leaf of rank >= 1).
    ``device``: where the batches go (default: the GPU). Exceptions in the
    source reach the consumer at the batch where they occurred; ``close()``
    (also called on exhaustion and on such an exception) stops the thread
    within 5 s. Single pass. ``transferred`` counts the batches copied."""

    def __init__(self, source: Iterable[Any] | Callable[[], Iterator[Any]], mesh=None,
                 depth: int = 2, device=None):
        self._stop = threading.Event()
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._mesh = mesh
        self._depth = depth
        self._device = _config.resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device) if self._device.type == "cuda"
                        else None)
        self._q = None
        self._thread = None
        self._started = False
        self.transferred = 0

    # -- background producer ------------------------------------------------

    def _leaf(self, x):
        if isinstance(x, torch.Tensor):
            t = x
        else:
            x = np.asarray(x)
            t = torch.as_tensor(x.astype(_X32.get(x.dtype, x.dtype), copy=False))
        if t.dim() >= 1 and self._mesh is not None:
            t = inference.shard_batch(t, self._mesh)
        if self._stream is None:  # a copy, as jax.device_put makes
            return t.to(self._device, copy=True)
        return t.contiguous().pin_memory().to(self._device, non_blocking=True)

    def _put(self, batch):
        """(the batch on the device, the event its copies end with)."""
        if self._stream is None:
            return _map(self._leaf, batch), None
        with torch.cuda.stream(self._stream):
            dev = _map(self._leaf, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _run(self, it):
        try:
            for batch in it:
                if self._stop.is_set():
                    return
                item = self._put(batch)
                self.transferred += 1
                if not self._offer(item):
                    return
            self._offer(_Stop())
        except BaseException as e:  # raised to the consumer at its batch
            self._offer(e)

    def _offer(self, item) -> bool:
        """Queue ``item`` unless the loader is closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer -----------------------------------------------------------

    def __iter__(self):
        if self._started:
            raise RuntimeError("PrefetchLoader is single-pass; make a new one")
        self._started = True
        it = iter(self._source() if callable(self._source) else self._source)
        self._q = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True,
                                        name="ldt-prefetch")
        self._thread.start()
        return self

    def __next__(self):
        if self._q is None:
            iter(self)
        item = self._q.get()
        if isinstance(item, _Stop):
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            _map(lambda t: t.record_stream(stream), batch)
        return batch

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def __del__(self):
        self._stop.set()


def prefetch_to_mesh(source, mesh, depth: int = 2, device=None) -> PrefetchLoader:
    """Prefetch host batches cut to this rank's rows over the mesh's "data"
    axis (the trainer's batch layout: ``trainer.build_sharded_trainer``'s
    ``make_batch`` rows)."""
    return PrefetchLoader(source, mesh, depth=depth, device=device)
