"""step_ms.p95 (ms; layer: sampling; moves s_per_image): the 95th percentile
of the step-to-step times between synchronised step callbacks (steps 2..N
of every ``ksample`` call) over the whole window: a tail over hundreds of
steps, which shows a stall in one model call."""

import numpy as np

LAYER = "sampling"


def read(run):
    if len(run.step_gaps) < 20:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.step_gaps), 95))
