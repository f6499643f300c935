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
K9/K10 + K11 path in ``modulated_matmul``. Q8_0's 34-byte blocks (f16
scale, 32 int8 codes) are split in numpy.

Leaves are torch tensors; a record's ``to`` moves both of its tensors.
Not ported: the stacked records of the scan layout, the tensor-parallel
flag, ``QTensorLoRA`` and ``write_gguf`` (the tests use the JAX package's
writer).
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
    unfused ops. ``q`` is the (N, K) codes, ``col_scales`` (1, N) f32;
    ``prequant`` (codes, scales) replaces the row quantization of ``x``."""
    n, k = q.shape
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


def requant_col(t: QTensor8T) -> QTensor8W:
    """A Q8_0 ``QTensor8T`` requantized per output column, on its device:
    the weight dequantized in f32, ``cs = max(max_k |w|, 1e-12) * (1/127)``
    per column, codes ``clip(round(w / cs), +-127)`` (the JAX package's
    law), laid out (N, K)."""
    w = qm.dequantize_t(t.qt, t.scales_t, torch.float32)
    cs = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12) * qm.INV_QMAX
    codes = torch.clamp(torch.round(w / cs), -qm.QMAX, qm.QMAX).to(torch.int8)
    del w
    return QTensor8W(q=codes.t().contiguous(), col_scales=cs, shape=t.shape)


def to_w8a8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every ``QTensor8T`` leaf of a flat param dict as its per-column
    ``QTensor8W``; embeddings (row-layout ``QTensor8``) and dense leaves pass
    through. ``params`` is consumed: each leaf is taken out of it as it
    converts, so the old codes are freed leaf by leaf (when nothing else
    holds them) and the 12 GB of a Flux DiT's codes never exist twice."""
    out = {}
    for key in list(params):
        leaf = params.pop(key)
        out[key] = requant_col(leaf) if isinstance(leaf, QTensor8T) else leaf
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


def _load_tensor(info: GGUFTensorInfo, buf, data_start: int):
    n_elems = int(np.prod(info.shape))
    off = data_start + info.offset
    if info.ggml_type == GGML_F32:
        arr = np.frombuffer(buf, dtype=np.float32, count=n_elems, offset=off)
        return torch.from_numpy(arr.reshape(info.shape).copy())
    if info.ggml_type == GGML_F16:
        arr = np.frombuffer(buf, dtype=np.float16, count=n_elems, offset=off)
        return torch.from_numpy(arr.reshape(info.shape).astype(np.float32))
    if info.ggml_type == GGML_BF16:
        raw = np.frombuffer(buf, dtype=np.uint16, count=n_elems, offset=off)
        arr = (raw.astype(np.uint32) << 16).view(np.float32)
        return torch.from_numpy(arr.reshape(info.shape))
    if info.ggml_type == GGML_Q8_0:
        n_blocks = n_elems // 32
        raw = np.frombuffer(buf, dtype=np.uint8, count=n_blocks * 34, offset=off)
        raw = raw.reshape(n_blocks, 34)
        scales = raw[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = raw[:, 2:].copy().view(np.int8)
        rows = info.shape[:-1]
        per_row = info.shape[-1] // 32
        return QTensor8(
            q=torch.from_numpy(q.reshape(rows + (per_row, 32))),
            scales=torch.from_numpy(scales.reshape(rows + (per_row,))),
            shape=tuple(info.shape),
        )
    raise NotImplementedError(f"GGML type {info.ggml_type} for {info.name} not supported")


KNOWN_ARCHS = {"flux", "sd1", "sdxl", "t5", "t5encoder"}


def gguf_sd_loader(path: str, keep_quantized: bool = True) -> Dict[str, Any]:
    """GGUF -> flat state dict of f32 CPU tensors and ``QTensor8`` records.
    Strips a leading 'model.diffusion_model.' prefix if every tensor has it."""
    metadata, infos, data_start, buf = parse_gguf(path)
    arch = metadata.get("general.architecture")
    if arch is not None and arch not in KNOWN_ARCHS:
        raise ValueError(f"unexpected GGUF architecture {arch!r}")
    sd = {}
    prefix = "model.diffusion_model."
    has_prefix = all(i.name.startswith(prefix) for i in infos) if infos else False
    for info in infos:
        key = info.name[len(prefix):] if has_prefix else info.name
        t = _load_tensor(info, buf, data_start)
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
    leaves as row-layout ``QTensor8``, W8A8 records as they are, dense
    tensors cast to ``dtype``."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, QTensor8):
            if len(v.shape) == 2 and k not in embed_keys:
                out[k] = transpose_for_matmul(v.to(device))
            else:
                out[k] = v.to(device)
        elif isinstance(v, (QTensor8T, QTensor8W)):
            out[k] = v.to(device)
        else:
            out[k] = torch.as_tensor(v).to(device=device, dtype=dtype)
    return out
