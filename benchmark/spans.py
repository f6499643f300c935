"""The device's idle time put down to the program's spans.

In a traced run the program records its spans (``utils/profiling.py`` of
the port: ``(id, parent id, request id, name, start_ns, end_ns)``, stamped
with ``time.time_ns()``) over the same images the profiler records the
device over, and ``torch.profiler`` puts its device events on that same
clock. ``idle_by_span`` walks the device's busy intervals and gives each
idle nanosecond of the profiled window to the innermost span open on the
main thread at that instant: the host work that left the device without
work. A ``sync.*`` span (the host waiting for the device to drain) counts
as its parent; idle outside every span is ``(none)``.

A program without spans (one that predates them) records none: ``stop``
returns [] and every idle nanosecond is ``(none)``.

``harness.py`` does not call this module yet: the edit that would (spans
on over the profiled images, the device intervals kept, and
``breakdown["idle_by_span"]``) and the metrics it would feed are listed
under Open questions in ``PERF.md``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

NONE = "(none)"


def _tracer():
    """The port's span recorder, or None where the program has none."""
    from lightdiffusion_next_tpu_torch.utils import profiling

    needed = ("enable", "reset", "spans")
    return profiling if all(hasattr(profiling, n) for n in needed) else None


def start() -> None:
    """Forget earlier spans and record from now on (where the program can)."""
    tracer = _tracer()
    if tracer is not None:
        tracer.reset()
        tracer.enable(True)


def stop() -> List[tuple]:
    """Stop recording; the main thread's spans, [] where the program has
    none."""
    tracer = _tracer()
    if tracer is None:
        return []
    tracer.enable(False)
    return list(tracer.spans(threading.main_thread().ident))


def device_intervals(prof) -> List[Tuple[int, int]]:
    """The sorted (start_ns, end_ns) of every CUDA-type event the profiler
    recorded: the set ``harness.device_timeline`` takes."""
    import torch

    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)


def _innermost(spans: Sequence[tuple], window: Tuple[int, int]):
    """The window cut into (start, end, name) pieces, in time order, each
    named after the innermost span open over it (``sync.*`` as its parent,
    ``(none)`` where none is open). Spans of one thread nest."""
    by_id = {s[0]: s for s in spans}

    def label(s):
        while s is not None and s[3].startswith("sync."):
            s = by_id.get(s[1])
        return NONE if s is None else s[3]

    w0, w1 = window
    pieces = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the open spans
    t = w0

    def advance(to):
        nonlocal t
        while stack and stack[-1][0] <= to:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end
        if to > t:
            pieces.append((t, to, stack[-1][1] if stack else NONE))
            t = to

    for s in sorted(spans, key=lambda s: (s[4], -s[5], s[0])):
        start, end = max(s[4], w0), min(s[5], w1)
        if end <= start:
            continue
        advance(start)
        if stack:
            end = min(end, stack[-1][0])
        stack.append((end, label(s)))
    advance(w1)
    return pieces


def idle_by_span(intervals: Sequence[Tuple[int, int]], window: Tuple[int, int],
                 spans: Sequence[tuple]) -> Dict[str, float]:
    """Seconds of device idle inside ``window`` (start_ns, end_ns) by the
    name of the innermost span open then (see the module's docstring);
    ``intervals``: the device's busy (start_ns, end_ns), sorted by start.
    The parts sum to the window's length less the busy time within it."""
    w0, w1 = window
    idle = []
    t = w0
    for s, e in intervals:
        s, e = max(s, w0), min(e, w1)
        if e <= t:
            continue
        if s > t:
            idle.append((t, s))
        t = e
    if t < w1:
        idle.append((t, w1))
    out: Dict[str, float] = {}
    pieces = _innermost(spans, window)
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + (hi - lo) * 1e-9
            k += 1
    return out

