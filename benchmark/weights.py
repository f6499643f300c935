"""Seeded weights, drawn on the device from ``--seed``.

A model's parameters are described by a layout: groups of ``Leaf``
entries (key, shape, how it is drawn, its dtype, and whether it is stored
as Q8_0, as the published GGUF files store Flux.1-dev's and T5-XXL's
matmul weights). Each group is drawn by one ``torch.Generator`` on the
device, seeded from the run's seed and the group's name, with one
``torch.randn`` call for all of its leaves, so any group can be drawn again
alone (the reference redraws the Flux DiT block by block after the timed
window) and gives the same values each time.

The benchmark hands these tensors to the program and, drawn again, to the
plain reference; the reference reads nothing the program built from them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
QBLOCK = 32  # Q8_0's elements per scale


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter. ``init``: "normal" (N(0, std)) or "one_plus"
    (1 + N(0, std), norm scales)."""

    key: str
    shape: Tuple[int, ...]
    init: str = "normal"
    std: float = 0.0
    dtype: str = "bf16"
    q8: bool = False


@dataclasses.dataclass
class Q8:
    """A Q8_0 weight as the GGUF reader lays it out: codes (rows, in/32,
    32) int8 and one f16-exact scale per block, held in f32."""

    q: torch.Tensor
    scales: torch.Tensor
    shape: Tuple[int, ...]

    def dequantize(self) -> torch.Tensor:
        return (self.q.float() * self.scales[..., None]).reshape(self.shape)


Layout = List[Tuple[str, List[Leaf]]]


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def quantize_q8_0(w: torch.Tensor) -> Q8:
    """Q8_0 of an (out, in) f32 weight: per 32 inputs, scale = absmax / 127
    rounded to f16 (the file's type), codes round(w / scale) clipped to
    +-127."""
    rows, k = w.shape
    blocks = w.reshape(rows, k // QBLOCK, QBLOCK)
    scales = (blocks.abs().amax(dim=-1) / 127.0).half().float()
    inv = torch.where(scales > 0, 1.0 / scales.clamp(min=1e-30), torch.zeros_like(scales))
    q = torch.clamp(torch.round(blocks * inv[..., None]), -127, 127).to(torch.int8)
    return Q8(q=q, scales=scales, shape=(rows, k))


def draw_group(seed: int, group: str, leaves: Sequence[Leaf], device) -> Dict[str, object]:
    """The group's leaves as tensors (or ``Q8`` records) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    sizes = [math.prod(leaf.shape) for leaf in leaves]
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for leaf, n in zip(leaves, sizes):
        v = buf[off:off + n].view(leaf.shape) * leaf.std
        off += n
        if leaf.init == "one_plus":
            v = v + 1.0
        out[leaf.key] = quantize_q8_0(v) if leaf.q8 else v.to(DTYPES[leaf.dtype])
        del v
    return out


def draw(seed: int, layout: Layout, device) -> Dict[str, object]:
    """Every group of ``layout``, drawn one after another."""
    params: Dict[str, object] = {}
    for group, leaves in layout:
        params.update(draw_group(seed, group, leaves, device))
    return params


def as_f32(leaf) -> torch.Tensor:
    """A drawn leaf's values in f32 (a Q8_0 record dequantized)."""
    return leaf.dequantize() if isinstance(leaf, Q8) else leaf.float()
