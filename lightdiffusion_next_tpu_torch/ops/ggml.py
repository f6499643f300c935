"""GGUF reader and quantized weights.

Counterpart of lightdiffusion_next_tpu/ops/ggml.py, its single-device part:
the GGUF v2/v3 reader (``parse_gguf``, ``gguf_sd_loader``, the T5 key map
of ``gguf_clip_loader``), the ``QTensor8`` record (int8 codes (rows, nb, 32)
and f32 scales (rows, nb), one scale per 32 elements along the input axis),
the ``QTensor8T`` matmul layout (codes transposed to (K, N), scales to
(K/32, N)) whose ``fused_matmul`` sends the shapes K5 takes to the kernel
(``ops/quant_matmul.py``) and the rest to dequantize + ``torch.matmul``,
and the W8A8 record ``QTensor8W`` (``to_w8a8``: int8 codes with one f32
scale per output column) with K7 in ``fused_matmul`` and the fused
K9/K10 + K11 path in ``modulated_matmul``. Each tensor is read into a
buffer of its own and Q8_0's 34-byte blocks (f16 scale, 32 int8 codes)
are split by the C++ split of ``utils/native.py``, as the JAX reader's.

The scan layout stacks D same-shaped records along a leading depth axis
(``stack_leaves``): ``StackedQTensor8T`` (codes (D, K, N), scales (D, K/32,
N)) and ``StackedQTensor8W`` (codes (D, N, K): each block the port's (N, K)
layout, the JAX record's (D, K, N) transposed per block; column scales (D,
1, N)). ``at_index(idx)`` returns a view of block ``idx`` whose matmuls go
to K6, K8 and the stacked K11, which read the block in place.

``QTensorLoRA`` is a quantized weight (``QTensor8T`` or ``QTensor8W``)
under an unmerged low-rank patch, applied at compute time. ``write_gguf``
writes a GGUF v3 file as the JAX package's writer does (the same bytes for
the same f32 inputs), and also takes ``QTensor8`` records, and streams
leaves one at a time when given their layout.

Leaves are torch tensors; a record's ``to`` moves its tensors.

The JAX records carry a ``tp`` flag: a leaf that is a sharded global array
under GSPMD takes the partitionable dequantize + dot instead of its
single-device kernel, and ``shard_map``'s local view clears it. The port
has no global arrays: under tensor parallelism a rank holds its slice of
each leaf as an ordinary record of the local shape
(``parallel.sharding.shard_leaf``), whose matmuls take the kernels
exactly as a single device's do. So no record here has that flag.
"""

from __future__ import annotations

import dataclasses
import math
import mmap
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
from lightdiffusion_next_tpu_torch.utils import native

GGUF_MAGIC = 0x46554747

# ggml tensor types
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_BF16 = 30

_SCALAR_FMT = {
    0: ("B", 1), 1: ("b", 1), 2: ("H", 2), 3: ("h", 2), 4: ("I", 4),
    5: ("i", 4), 6: ("f", 4), 7: ("?", 1), 10: ("Q", 8), 11: ("q", 8),
    12: ("d", 8),
}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def read_string(self) -> str:
        n = self.read("Q")
        s = bytes(self.buf[self.pos : self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def read_value(self, vtype: int):
        if vtype == 8:
            return self.read_string()
        if vtype == 9:
            atype = self.read("I")
            count = self.read("Q")
            return [self.read_value(atype) for _ in range(count)]
        fmt, _ = _SCALAR_FMT[vtype]
        return self.read(fmt)


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]  # numpy order (reversed ggml dims)
    ggml_type: int
    offset: int


def parse_gguf(path: str):
    """Parse the header: (metadata dict, [GGUFTensorInfo], data_start,
    mmap buffer)."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    r = _Reader(buf)
    if r.read("I") != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file")
    version = r.read("I")
    if version < 2:
        raise ValueError(f"GGUF version {version} unsupported")
    tensor_count = r.read("Q")
    kv_count = r.read("Q")
    metadata: Dict[str, Any] = {}
    for _ in range(kv_count):
        key = r.read_string()
        vtype = r.read("I")
        metadata[key] = r.read_value(vtype)
    infos = []
    for _ in range(tensor_count):
        name = r.read_string()
        n_dims = r.read("I")
        dims = [r.read("Q") for _ in range(n_dims)]
        ggml_type = r.read("I")
        offset = r.read("Q")
        infos.append(GGUFTensorInfo(name, tuple(reversed(dims)), ggml_type, offset))
    alignment = metadata.get("general.alignment", 32)
    data_start = (r.pos + alignment - 1) // alignment * alignment
    return metadata, infos, data_start, buf


# ---------------------------------------------------------------------------
# Quantized records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QTensor8:
    """Q8_0 weight in row layout: int8 codes (…, n_blocks, 32) and f32
    scales (…, n_blocks); value = q * scale per 32-element block of the
    last (input) axis. Embedding tables keep this layout for row lookup."""

    q: torch.Tensor
    scales: torch.Tensor
    shape: Tuple[int, ...]  # logical (out, in)

    def dequantize(self, dtype=torch.bfloat16):
        w = self.q.float() * self.scales.float()[..., None]
        return w.reshape(self.shape).to(dtype)

    def to(self, device):
        return QTensor8(self.q.to(device), self.scales.to(device), self.shape)


@dataclasses.dataclass
class QTensor8T:
    """Q8_0 weight in the matmul layout: codes (K, N) int8 and scales
    (K/32, N) f32; the same value as a ``QTensor8`` of ``shape`` (N, K)."""

    qt: torch.Tensor
    scales_t: torch.Tensor
    shape: Tuple[int, ...]  # logical (out=N, in=K)

    def dequantize(self, dtype=torch.bfloat16):
        """The logical (N, K) weight in ``dtype``."""
        return qm.dequantize_t(self.qt, self.scales_t, dtype).t()

    def fused_matmul(self, x, out_dtype=None):
        """x (..., K) -> (..., N): K5 for the shapes it takes, otherwise
        dequantize to x's dtype and ``torch.matmul``."""
        k, n = self.qt.shape
        m = 1
        for d in x.shape[:-1]:
            m *= d
        if qm.supported(m, k, n):
            return qm.quant_matmul(x, self.qt, self.scales_t, out_dtype)
        return torch.matmul(x, self.dequantize(x.dtype).t())

    def to(self, device):
        return QTensor8T(self.qt.to(device), self.scales_t.to(device), self.shape)


def _modulated_matmul_impl(q, col_scales, x, *, prologue="none", mod_scale=None,
                           mod_shift=None, gate=None, bias=None, residual=None,
                           out_dtype=None, prequant=None):
    """The fused-elementwise W8A8 matmul (K9, then K11), or None when this
    call cannot take it, as in the JAX package: a shape the kernels do not
    take, or batched or mismatched modulation, gate or bias vectors (the
    kernels fold them as one (1, K) or (1, N) row); the caller then runs the
    unfused ops. ``q`` is the (N, K) codes, or ``(q3, idx)``: block ``idx``
    of a (D, N, K) stack (the stacked K11); ``col_scales`` the block's (1,
    N) f32; ``prequant`` (codes, scales) replaces the row quantization of
    ``x``."""
    n, k = q[0].shape[1:] if isinstance(q, tuple) else q.shape
    ref = x if prequant is None else prequant[0]
    if not (qm.supported_w8a8(math.prod(ref.shape[:-1]), k, n)
            and qm.supported_rowquant(k)):
        return None

    def _vec(v, size):
        """(..., size) -> (1, size) f32, or None if batched or mismatched."""
        if v is None:
            return None
        if math.prod(v.shape[:-1]) != 1 or v.shape[-1] != size:
            return None
        return v.float().reshape(1, size)

    if prologue == "ln_mod":
        mod_scale = _vec(mod_scale, k)
        mod_shift = _vec(mod_shift, k)
        if mod_scale is None or mod_shift is None:
            return None
    gate_v = _vec(gate, n)
    if gate is not None and gate_v is None:
        return None
    bias_v = _vec(bias, n)
    if bias is not None and bias_v is None:
        return None

    if prequant is None:
        codes, sx = qm.row_quantize_fused(x, mod_scale, mod_shift, prologue=prologue)
    else:
        codes, sx = prequant
        if codes.shape[-1] != k:
            return None
    cs_eff = col_scales.reshape(1, n)
    b_eff = bias_v if bias_v is not None else torch.zeros(
        (1, n), dtype=torch.float32, device=cs_eff.device)
    if gate_v is not None:
        cs_eff = cs_eff * gate_v
        b_eff = b_eff * gate_v
    out_dtype = out_dtype or (residual.dtype if residual is not None else ref.dtype)
    if out_dtype == torch.int8:  # prequant codes as the dtype ref
        out_dtype = torch.bfloat16
    return qm.w8a8_matmul_ep(codes, sx, q, cs_eff, b_eff, residual=residual,
                             out_dtype=out_dtype)


@dataclasses.dataclass
class QTensor8W:
    """Per-output-column int8 weight of the W8A8 path (``to_w8a8``): codes
    ``q`` int8 (N, K) and ``col_scales`` f32 (1, N); value = q * scale of
    its column.

    The codes are (N, K), K-contiguous: the JAX record's ``qt`` (K, N)
    transposed. Hopper's int8 tensor-core instructions take both operands
    K-major (``mma.sync`` m16n8k32 wants B K-contiguous per column, 8-bit
    ``wgmma`` takes K-major operands only, and ``ldmatrix`` transposes only
    16-bit elements), and ``torch._int_mm`` wants the same. ``dequantize``
    returns the same logical (N, K) weight as the JAX record's."""

    q: torch.Tensor
    col_scales: torch.Tensor
    shape: Tuple[int, ...]  # logical (out=N, in=K)

    def dequantize(self, dtype=torch.bfloat16):
        """The logical (N, K) weight in ``dtype``: f32(q) * scale, rounded
        once."""
        return (self.q.float() * self.col_scales.reshape(-1, 1)).to(dtype)

    def fused_matmul(self, x, out_dtype=None):
        """x (..., K) -> (..., N): K7 for the shapes it takes, otherwise
        dequantize to x's dtype and ``torch.matmul``."""
        n, k = self.q.shape
        if qm.supported_w8a8(math.prod(x.shape[:-1]), k, n):
            return qm.w8a8_matmul(x, self.q, self.col_scales, out_dtype)
        return torch.matmul(x, self.dequantize(x.dtype).t())

    def modulated_matmul(self, x, **kw):
        """The fused-elementwise path (``_modulated_matmul_impl``); None
        when the caller must run the unfused ops."""
        return _modulated_matmul_impl(self.q, self.col_scales, x, **kw)

    def to(self, device):
        return QTensor8W(self.q.to(device), self.col_scales.to(device), self.shape)


def is_quantized(x) -> bool:
    return isinstance(x, (QTensor8, QTensor8T, QTensor8W))


@dataclasses.dataclass
class QTensorLoRA:
    """A quantized matmul weight (``QTensor8T`` or ``QTensor8W``) under an
    unmerged LoRA: ``y = base(x) + (x @ down^T) @ up^T``. The base keeps its
    kernel (K5, or K9 "none" and K7) and the weight stays int8 in memory;
    merging would make it dense. ``up`` (out, rank) f32 carries strength *
    alpha / rank; ``down`` (rank, in) f32. Stacked LoRAs concatenate their
    ranks. There is no ``modulated_matmul``: the fused-elementwise path
    does not apply and the block takes its plain ops, as in the JAX
    package."""

    base: Any
    up: torch.Tensor
    down: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.base.shape

    def fused_matmul(self, x, out_dtype=None):
        """The base's matmul plus the two skinny products in x's dtype."""
        y = self.base.fused_matmul(x, out_dtype)
        h = torch.matmul(x, self.down.to(x.dtype).t())
        corr = torch.matmul(h, self.up.to(x.dtype).t())
        return y + corr.to(y.dtype)

    def dequantize(self, dtype=torch.bfloat16):
        """The logical (N, K) weight with the patch added in f32."""
        return (self.base.dequantize(torch.float32) + self.up @ self.down).to(dtype)

    def to(self, device):
        return QTensorLoRA(self.base.to(device), self.up.to(device), self.down.to(device))


@dataclasses.dataclass
class StackedQTensor8T:
    """D same-shaped ``QTensor8T`` weights stacked for the scan layout:
    codes ``qt3`` int8 (D, K, N), scales ``scales3`` f32 (D, K/32, N);
    ``shape`` is one block's logical (N, K)."""

    qt3: torch.Tensor
    scales3: torch.Tensor
    shape: Tuple[int, ...]

    def at_index(self, idx: int) -> "_StackedSlice8T":
        return _StackedSlice8T(self, idx)

    def to(self, device):
        return StackedQTensor8T(self.qt3.to(device), self.scales3.to(device), self.shape)


@dataclasses.dataclass
class StackedQTensor8W:
    """D same-shaped ``QTensor8W`` weights stacked for the scan layout:
    codes ``q3`` int8 (D, N, K), each block K-contiguous as ``QTensor8W``'s,
    column scales ``col_scales3`` f32 (D, 1, N); ``shape`` is one block's
    logical (N, K)."""

    q3: torch.Tensor
    col_scales3: torch.Tensor
    shape: Tuple[int, ...]

    def at_index(self, idx: int) -> "_StackedSlice8W":
        return _StackedSlice8W(self, idx)

    def to(self, device):
        return StackedQTensor8W(self.q3.to(device), self.col_scales3.to(device), self.shape)


class _StackedSlice8T:
    """Block ``idx`` of a ``StackedQTensor8T``, used as a ``QTensor8T`` is
    (``ops.nn.linear``): ``fused_matmul`` sends the shapes K6 takes to the
    kernel, which reads the block in place, and the rest to dequantize +
    ``torch.matmul``."""

    __slots__ = ("stack", "idx")

    def __init__(self, stack: StackedQTensor8T, idx: int):
        self.stack = stack
        self.idx = idx

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.stack.shape

    def dequantize(self, dtype=torch.bfloat16):
        """The block's logical (N, K) weight in ``dtype``."""
        s = self.stack
        return qm.dequantize_t(s.qt3[self.idx], s.scales3[self.idx], dtype).t()

    def fused_matmul(self, x, out_dtype=None):
        _, k, n = self.stack.qt3.shape
        if qm.supported(math.prod(x.shape[:-1]), k, n):
            return qm.quant_matmul_stacked(x, self.stack.qt3, self.stack.scales3, self.idx,
                                           out_dtype)
        return torch.matmul(x, self.dequantize(x.dtype).t())


class _StackedSlice8W:
    """Block ``idx`` of a ``StackedQTensor8W``, used as a ``QTensor8W`` is:
    K8 in ``fused_matmul``, the fused K9/K10 + stacked K11 path in
    ``modulated_matmul``; the kernels read the block in place."""

    __slots__ = ("stack", "idx")

    def __init__(self, stack: StackedQTensor8W, idx: int):
        self.stack = stack
        self.idx = idx

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.stack.shape

    def dequantize(self, dtype=torch.bfloat16):
        """The block's logical (N, K) weight in ``dtype``."""
        s = self.stack
        return (s.q3[self.idx].float() * s.col_scales3[self.idx].reshape(-1, 1)).to(dtype)

    def fused_matmul(self, x, out_dtype=None):
        _, n, k = self.stack.q3.shape
        if qm.supported_w8a8(math.prod(x.shape[:-1]), k, n):
            return qm.w8a8_matmul_stacked(x, self.stack.q3, self.stack.col_scales3, self.idx,
                                          out_dtype)
        return torch.matmul(x, self.dequantize(x.dtype).t())

    def modulated_matmul(self, x, **kw):
        """``_modulated_matmul_impl`` on ``(q3, idx)``; the block's (1, N)
        column scales for the epilogue's folds are a view of the stack's."""
        s = self.stack
        return _modulated_matmul_impl((s.q3, self.idx), s.col_scales3[self.idx], x, **kw)


_STACKED = (StackedQTensor8T, StackedQTensor8W)


def _leaf_device(leaf):
    return leaf.qt.device if isinstance(leaf, QTensor8T) else (
        leaf.q.device if isinstance(leaf, QTensor8W) else leaf.device)


def check_stackable(leaves) -> None:
    """Raise ValueError unless ``leaves`` (one key's leaf of every block)
    can stack: all ``QTensor8T`` or all ``QTensor8W`` of one shape, or all
    tensors of one shape and dtype, on one device. Stackers call it on
    every family before they consume anything."""
    first = leaves[0]
    if isinstance(first, (QTensor8T, QTensor8W)):
        kind = type(first)
        if any(not isinstance(leaf, kind) or leaf.shape != first.shape
               or _leaf_device(leaf) != _leaf_device(first) for leaf in leaves):
            raise ValueError(f"non-uniform {kind.__name__} group")
        return
    if is_quantized(first) or isinstance(first, _STACKED + (QTensorLoRA,)):
        raise ValueError(f"cannot stack {type(first).__name__} leaves (matmul layouts only)")
    if any(not isinstance(leaf, torch.Tensor) or leaf.shape != first.shape
           or leaf.dtype != first.dtype or leaf.device != first.device for leaf in leaves):
        raise ValueError("non-uniform dense leaf group")


def stack_leaves(leaves):
    """D per-block leaves (one key across the blocks) stacked along a new
    leading depth axis on their device: ``QTensor8T`` -> ``StackedQTensor8T``,
    ``QTensor8W`` -> ``StackedQTensor8W``, tensors -> a (D, ...) tensor."""
    check_stackable(leaves)
    first = leaves[0]
    if isinstance(first, QTensor8T):
        return StackedQTensor8T(qt3=torch.stack([leaf.qt for leaf in leaves]),
                                scales3=torch.stack([leaf.scales_t for leaf in leaves]),
                                shape=first.shape)
    if isinstance(first, QTensor8W):
        return StackedQTensor8W(q3=torch.stack([leaf.q for leaf in leaves]),
                                col_scales3=torch.stack([leaf.col_scales for leaf in leaves]),
                                shape=first.shape)
    return torch.stack(leaves)


def requant_col(t: QTensor8T, reduce_max=None) -> QTensor8W:
    """A Q8_0 ``QTensor8T`` requantized per output column, on its device:
    the weight dequantized in f32, ``cs = max(max_k |w|, 1e-12) * (1/127)``
    per column, codes ``clip(round(w / cs), +-127)`` (the JAX package's
    law), laid out (N, K). ``reduce_max`` maps the (1, N) column maxima
    of this K slice to those of the whole weight (a rank's row-parallel
    shard: ``parallel.spmd.to_w8a8``)."""
    w = qm.dequantize_t(t.qt, t.scales_t, torch.float32)
    amax = w.abs().amax(dim=0, keepdim=True)
    if reduce_max is not None:
        amax = reduce_max(amax)
    cs = torch.clamp(amax, min=1e-12) * qm.INV_QMAX
    codes = torch.clamp(torch.round(w / cs), -qm.QMAX, qm.QMAX).to(torch.int8)
    del w
    return QTensor8W(q=codes.t().contiguous(), col_scales=cs, shape=t.shape)


def stack_families(params: Dict[str, Any], families: Dict[Any, list]) -> Dict[Any, Any]:
    """The stackers' contract: validate every family ({key: one leaf per
    block}) first and raise ValueError with ``params`` untouched; then
    consume ``params`` (it is cleared) and stack the families one at a time,
    each family's leaves dropped once its stack exists, so the extra memory
    peaks at one family's stack. Returns {key: stack}."""
    for leaves in families.values():
        check_stackable(leaves)
    params.clear()
    return {key: stack_leaves(families.pop(key)) for key in list(families)}


def requant_col_stacked(t: StackedQTensor8T, reduce_max=None) -> StackedQTensor8W:
    """A Q8_0 stack requantized per output column, block by block, each
    block exactly as ``requant_col`` requantizes it (so the stacked requant
    equals the unstacked one bit for bit); the f32 temporary is one block."""
    d, k, n = t.qt3.shape
    q3 = torch.empty((d, n, k), dtype=torch.int8, device=t.qt3.device)
    cs3 = torch.empty((d, 1, n), dtype=torch.float32, device=t.qt3.device)
    for i in range(d):
        w = requant_col(QTensor8T(t.qt3[i], t.scales3[i], t.shape), reduce_max)
        q3[i], cs3[i] = w.q, w.col_scales
        del w
    return StackedQTensor8W(q3=q3, col_scales3=cs3, shape=t.shape)


def to_w8a8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every ``QTensor8T`` leaf of a param dict as its per-column
    ``QTensor8W`` (also the base of a ``QTensorLoRA``), and every
    ``StackedQTensor8T`` (in the nested dicts of the scan layout) as its
    ``StackedQTensor8W``; embeddings (row-layout ``QTensor8``) and dense
    leaves pass through. ``params`` is consumed:
    each leaf is taken out of it as it converts, so the old codes are freed
    leaf by leaf (when nothing else holds them) and the 12 GB of a Flux
    DiT's codes never exist twice."""
    out = {}
    for key in list(params):
        leaf = params.pop(key)
        if isinstance(leaf, dict):
            out[key] = to_w8a8(leaf)
        elif isinstance(leaf, QTensor8T):
            out[key] = requant_col(leaf)
        elif isinstance(leaf, QTensorLoRA) and isinstance(leaf.base, QTensor8T):
            out[key] = QTensorLoRA(requant_col(leaf.base), leaf.up, leaf.down)
        elif isinstance(leaf, StackedQTensor8T):
            out[key] = requant_col_stacked(leaf)
        else:
            out[key] = leaf
        del leaf
    return out


def quantize_q8_0(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float (rows, in) -> (q int8 (rows, nb, 32), scales f32 (rows, nb)),
    on w's device: scale = absmax / 127 per block, codes rounded half to
    even and clipped to [-128, 127], as the JAX function computes them."""
    rows = tuple(w.shape[:-1])
    nb = w.shape[-1] // 32
    blocks = w.reshape(rows + (nb, 32)).float()
    scales = blocks.abs().amax(dim=-1) / 127.0
    inv = torch.where(scales > 0, 1.0 / torch.clamp(scales, min=1e-30),
                      torch.zeros_like(scales))
    q = torch.clamp(torch.round(blocks * inv[..., None]), -128, 127).to(torch.int8)
    return q, scales


def quantize(w: torch.Tensor) -> QTensor8:
    """A (out, in) float weight as a ``QTensor8`` on its device."""
    q, scales = quantize_q8_0(w)
    return QTensor8(q=q, scales=scales, shape=tuple(w.shape))


def _q8_0_blob(q, scales) -> np.ndarray:
    """Q8_0 codes (…, nb, 32) and scales (…, nb) -> the file's (blocks, 34)
    bytes: each block's scale as f16, then its 32 codes. Built on the
    record's device, copied to the host once."""
    blob = torch.cat([scales.reshape(-1, 1).to(torch.float16).view(torch.uint8),
                      q.reshape(-1, 32).view(torch.uint8)], dim=1)
    return blob.cpu().numpy()


def _gguf_header(arch: str, layout) -> Tuple[bytes, list]:
    """The header (magic, counts, metadata, tensor infos, padding to the
    32-byte alignment) of ``layout`` [(name, shape, q8)], and each tensor's
    byte count in the file."""
    align = 32

    def enc_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    metadata = {"general.architecture": arch}
    head = struct.pack("<IIQQ", GGUF_MAGIC, 3, len(layout), len(metadata))
    for k, v in metadata.items():
        head += enc_string(k) + struct.pack("<I", 8) + enc_string(v)
    sizes, offset = [], 0
    for name, shape, q8 in layout:
        n = math.prod(shape)
        size = n // 32 * 34 if q8 else 4 * n
        dims = list(reversed(shape))
        head += enc_string(name) + struct.pack("<I", len(dims))
        head += b"".join(struct.pack("<Q", d) for d in dims)
        head += struct.pack("<IQ", GGML_Q8_0 if q8 else GGML_F32, offset)
        sizes.append(size)
        offset += size + (-size) % align
    return head + b"\0" * ((-len(head)) % align), sizes


def write_gguf(path: str, tensors, arch: str = "flux", quantize: Tuple[str, ...] = (),
               layout=None) -> int:
    """GGUF v3 writer: the JAX package's ``write_gguf`` layout and bytes
    (Q8_0 for names ending in a ``quantize`` suffix whose last dim is a
    multiple of 32, F32 otherwise, 32-byte alignment). A value is an
    array or tensor (f32 values), or a ``QTensor8`` record, written as it
    is (Q8_0).

    ``tensors`` is a dict, or, with ``layout`` ([(name, shape, q8)] in file
    order), an iterable of (name, value) pairs in that order, written as
    they come: a model streams with one leaf in memory. Returns the bytes
    written."""
    if layout is None:
        def q8(name, w):
            return isinstance(w, QTensor8) or (
                any(name.endswith(sfx) for sfx in quantize) and w.shape[-1] % 32 == 0)
        layout = [(name, tuple(w.shape), q8(name, w)) for name, w in tensors.items()]
        tensors = tensors.items()
    header, sizes = _gguf_header(arch, layout)
    written = 0
    with open(path, "wb") as f:
        f.write(header)
        written += len(header)
        entries = iter(tensors)
        for (name, shape, q8), size in zip(layout, sizes):
            got, w = next(entries)
            if got != name or tuple(w.shape) != tuple(shape):
                raise ValueError(f"write_gguf: {got} {tuple(w.shape)} where the layout "
                                 f"has {name} {tuple(shape)}")
            if isinstance(w, QTensor8):
                if not q8:
                    raise ValueError(f"write_gguf: {name} is Q8_0 but laid out as F32")
                blob = _q8_0_blob(w.q, w.scales)
            else:
                wf = torch.as_tensor(w).detach().to("cpu", torch.float32)
                blob = _q8_0_blob(*quantize_q8_0(wf)) if q8 else wf.contiguous().numpy()
            del w
            if blob.nbytes != size:
                raise ValueError(f"write_gguf: {name} has {blob.nbytes} bytes, not {size}")
            f.write(memoryview(np.ascontiguousarray(blob)).cast("B"))
            f.write(b"\0" * ((-size) % 32))
            written += size + (-size) % 32
    return written


def transpose_for_matmul(t: QTensor8) -> QTensor8T:
    """2-D ``QTensor8`` -> ``QTensor8T`` on the same device."""
    if len(t.shape) != 2:
        raise ValueError(f"transpose_for_matmul: 2-D weights only, got {t.shape}")
    n, k = t.shape
    return QTensor8T(
        qt=t.q.reshape(n, k).t().contiguous(),
        scales_t=t.scales.float().t().contiguous(),
        shape=t.shape,
    )


def _load_tensor(info: GGUFTensorInfo, f, data_start: int):
    """One tensor read from the open file ``f`` with ``readinto`` into a
    buffer of its own (no page of the file stays mapped, and the kernel
    copies from its page cache without a fault per page); Q8_0's 34-byte
    blocks are split by ``utils.native.split_q8_0``, the C++ split, as the
    JAX reader's (``native.split_q8_0_plain`` is torch's copies)."""
    n_elems = math.prod(info.shape)
    nbytes = {GGML_F32: 4 * n_elems, GGML_F16: 2 * n_elems, GGML_BF16: 2 * n_elems,
              GGML_Q8_0: n_elems // 32 * 34}.get(info.ggml_type)
    if nbytes is None:
        raise NotImplementedError(f"GGML type {info.ggml_type} for {info.name} not supported")
    raw = torch.empty(nbytes, dtype=torch.uint8)
    f.seek(data_start + info.offset)
    if f.readinto(memoryview(raw.numpy())) != nbytes:
        raise ValueError(f"{info.name}: the file ends inside the tensor")
    if info.ggml_type == GGML_F32:
        return raw.view(torch.float32).reshape(info.shape)
    if info.ggml_type == GGML_F16:
        return raw.view(torch.float16).reshape(info.shape).float()
    if info.ggml_type == GGML_BF16:
        return raw.view(torch.bfloat16).reshape(info.shape).float()
    q, scales = native.split_q8_0(raw.reshape(-1, 34))
    rows = info.shape[:-1]
    per_row = info.shape[-1] // 32
    return QTensor8(q=q.reshape(rows + (per_row, 32)), scales=scales.reshape(rows + (per_row,)),
                    shape=tuple(info.shape))


KNOWN_ARCHS = {"flux", "sd1", "sdxl", "t5", "t5encoder"}


def gguf_sd_loader(path: str, keep_quantized: bool = True) -> Dict[str, Any]:
    """GGUF -> flat state dict of f32 CPU tensors and ``QTensor8`` records.
    Strips a leading 'model.diffusion_model.' prefix if every tensor has it."""
    metadata, infos, data_start, buf = parse_gguf(path)
    buf.close()
    arch = metadata.get("general.architecture")
    if arch is not None and arch not in KNOWN_ARCHS:
        raise ValueError(f"unexpected GGUF architecture {arch!r}")
    sd = {}
    prefix = "model.diffusion_model."
    has_prefix = all(i.name.startswith(prefix) for i in infos) if infos else False
    with open(path, "rb", buffering=0) as f:
        for info in infos:
            key = info.name[len(prefix):] if has_prefix else info.name
            t = _load_tensor(info, f, data_start)
            if not keep_quantized and is_quantized(t):
                t = t.dequantize(torch.float32)
            sd[key] = t
    return sd


# llama.cpp T5 naming -> HF naming
T5_KEY_MAP = {
    "enc.": "encoder.",
    ".blk.": ".block.",
    "token_embd": "shared",
    "output_norm": "final_layer_norm",
    "attn_q": "layer.0.SelfAttention.q",
    "attn_k": "layer.0.SelfAttention.k",
    "attn_v": "layer.0.SelfAttention.v",
    "attn_o": "layer.0.SelfAttention.o",
    "attn_norm": "layer.0.layer_norm",
    "attn_rel_b": "layer.0.SelfAttention.relative_attention_bias",
    "ffn_up": "layer.1.DenseReluDense.wi_1",
    "ffn_down": "layer.1.DenseReluDense.wo",
    "ffn_gate": "layer.1.DenseReluDense.wi_0",
    "ffn_norm": "layer.1.layer_norm",
}


def t5_gguf_name(key: str) -> str:
    """An HF T5 key -> its llama.cpp GGUF name: ``T5_KEY_MAP`` inverted
    (its replacements undone in reverse order), so ``gguf_clip_loader``
    maps the name back to ``key``."""
    for s, d in reversed(T5_KEY_MAP.items()):
        key = key.replace(d, s)
    return key


def gguf_clip_loader(path: str) -> Dict[str, Any]:
    """T5 GGUF -> HF-keyed state dict."""
    raw = gguf_sd_loader(path)
    if not any(k.startswith("enc.") for k in raw):
        raise ValueError("not a text-encoder GGUF")
    sd = {}
    for k, v in raw.items():
        for s, d in T5_KEY_MAP.items():
            k = k.replace(s, d)
        sd[k] = v
    return sd


EMBED_KEYS = (
    "shared.weight",
    "token_embd.weight",
    # T5's relative-attention bias is a lookup table, not a matmul weight
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
)


def to_device_quantized(sd: Dict[str, Any], dtype=torch.bfloat16, device=None,
                        embed_keys: Tuple[str, ...] = EMBED_KEYS) -> Dict[str, Any]:
    """Place a state dict on ``device``: 2-D Q8_0 matmul weights as
    ``QTensor8T``, Q8_0 embedding tables (``embed_keys``) and other Q8_0
    leaves as row-layout ``QTensor8``, W8A8 and stacked records as they
    are, dense tensors cast to ``dtype`` (None: kept); the nested dicts of
    the scan layout likewise."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out[k] = to_device_quantized(v, dtype, device, embed_keys)
        elif isinstance(v, QTensor8):
            if len(v.shape) == 2 and k not in embed_keys:
                out[k] = transpose_for_matmul(v.to(device))
            else:
                out[k] = v.to(device)
        elif isinstance(v, (QTensor8T, QTensor8W, QTensorLoRA) + _STACKED):
            out[k] = v.to(device)
        else:
            out[k] = torch.as_tensor(v).to(device=device, dtype=dtype)
    return out
