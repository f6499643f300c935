"""The model families the harness drives, one module each: the program's
models built for a configuration, the recorder's hooks on them, and the
comparison of the checked image with the plain reference. What the
families' comparisons share is here."""

from __future__ import annotations

import math

from benchmark.reference import common as C


def program_pieces(rec) -> list:
    """A checked ``ksample`` pass's values as the program computed them, in
    order: the state the sampler starts from; per step each model call's
    input, then the state after the step; the latent the pass returns."""
    got = [rec["x0"]]
    for i in range(rec["n"]):
        got += [c[0] for c in rec["calls"].get(i, [])] + [rec["steps"][i][0]]
    return got + [rec["latent"]]


def largest_gap(got: list, want: list) -> float:
    """The largest relative RMS gap of paired values; infinite where the
    lists differ in length (a model call too many or too few) or a pair in
    shape."""
    if len(got) != len(want):
        return math.inf
    gap = 0.0
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape):
            return math.inf
        gap = max(gap, C.rel_rms(g, w))
    return gap
