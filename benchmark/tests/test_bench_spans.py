"""``benchmark/spans.py`` on the CPU: the idle attribution on synthetic
intervals and spans, and the recording switched on and off around the
program's own spans."""

from __future__ import annotations

import threading

import pytest

from benchmark import spans


def test_idle_by_span_puts_each_idle_instant_down_to_the_innermost_span():
    """Idle inside the window goes to the innermost span open then; a
    sync.* span counts as its parent; idle at the window's edges and
    outside every span is (none); the parts sum to the window less the busy
    time within it."""
    window = (0, 100)
    busy = [(-10, 2), (10, 20), (15, 30), (50, 60)]  # within the window: 2 + 20 + 10
    records = [(1, None, 7, "pipeline", 5, 95), (2, 1, 7, "sampling.ksample", 25, 70),
               (3, 2, 7, "models.unet", 35, 45), (5, 3, 7, "kernels.k", 40, 44),
               (4, 1, 7, "sync.readback", 72, 80)]
    idle = spans.idle_by_span(busy, window, records)
    want = {"(none)": 3 + 5, "pipeline": 5 + 2 + 8 + 15, "sampling.ksample": 5 + 5 + 10,
            "models.unet": 5 + 1, "kernels.k": 4}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(idle.values()) == pytest.approx((100 - 32) * 1e-9)
    assert spans.idle_by_span(busy, window, []) == pytest.approx({"(none)": 68e-9})


def test_start_and_stop_record_the_main_threads_spans():
    """``start`` clears and switches the program's spans on, ``stop``
    switches them off and returns the main thread's alone; a span opened
    after ``stop`` is not recorded."""
    from lightdiffusion_next_tpu_torch.utils import profiling

    spans.start()
    try:
        with profiling.span("pipeline"):
            with profiling.span("sync.readback"):
                pass

        def other():
            with profiling.span("other"):
                pass

        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
    finally:
        got = spans.stop()
    with profiling.span("after"):
        pass
    assert [r[3] for r in got] == ["sync.readback", "pipeline"]
    assert got[0][1] == got[1][0]  # the sync span's parent is the pipeline span
    assert spans.stop() == got
    profiling.reset()
