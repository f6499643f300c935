"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; a source
may export several kernels' entry points (``quant_matmul.cu``: K5 and K6;
``w8a8_matmul.cu``: K7, K8, K11 and the stacked K11; ``row_quantize.cu``:
K9 and K10; ``sage_attention.cu``: K4, its flag variants and their
preparation; ``w8a8_matmul_bf16.cu``: the W8A8 matmuls' flag variant). The
build
happens at first use, into ``build/kernels/`` at the repository root
(listed in ``.gitignore``); the file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a built one is reused. ``build()`` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.

Each library built or loaded is logged at DEBUG on this module's logger
(``utils.profiling.compile_log`` shows them): the port's counterpart of a
compile.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

_FLASH_ARGTYPES = (
    [ctypes.c_void_p] * 4            # q, k, v, o
    + [ctypes.c_int] * 6             # dtype, batch, heads, lq, lk, d
    + [ctypes.c_longlong] * 12       # (b, h, l) strides of q, k, v, o
    + [ctypes.c_float, ctypes.c_int]  # q_scale, vec
    + [ctypes.c_void_p, ctypes.c_longlong]  # the tile images' scratch, its bytes
    + [ctypes.c_void_p]              # stream
)

_FUSED_QKV_ARGTYPES = (
    [ctypes.c_void_p] * 9            # qkv, out, kv scratch, 4 scales, cos, sin
    + [ctypes.c_int] * 4             # batch, heads, l, lk
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # row width, txt_len, interleaved
    + [ctypes.c_float] * 2           # eps, q_scale
    + [ctypes.c_void_p]              # stream
)

_QUANT_MATMUL_ARGTYPES = (
    [ctypes.c_void_p] * 4            # x, qt, scales_t, out
    + [ctypes.c_int] * 3             # m, n, k
    + [ctypes.c_longlong]            # row stride of x
    + [ctypes.c_void_p]              # stream
)

_STACK_ARGTYPES = [ctypes.c_int] * 2  # depth, idx

_QUANT_MATMUL_STACKED_ARGTYPES = (
    _QUANT_MATMUL_ARGTYPES[:-1] + _STACK_ARGTYPES + [ctypes.c_void_p]
)

_W8A8_ARGTYPES = (
    [ctypes.c_void_p] * 5            # xq, sx, q, cs, out
    + [ctypes.c_int] * 3             # m, n, k
    + [ctypes.c_longlong] * 2        # row strides of xq, q
    + [ctypes.c_int]                 # tile id (quant_matmul.w8a8_tile)
    + [ctypes.c_void_p]              # stream
)

_W8A8_EP_ARGTYPES = (
    [ctypes.c_void_p] * 7            # xq, sx, q, cs, bias, residual, out
    + [ctypes.c_int] * 3             # m, n, k
    + [ctypes.c_longlong] * 3        # row strides of xq, q, residual
    + [ctypes.c_int]                 # tile id
    + [ctypes.c_void_p]              # stream
)

_W8A8_STACKED_ARGTYPES = _W8A8_ARGTYPES[:-1] + _STACK_ARGTYPES + [ctypes.c_void_p]
_W8A8_EP_STACKED_ARGTYPES = (
    _W8A8_EP_ARGTYPES[:-1] + _STACK_ARGTYPES + [ctypes.c_void_p]
)

_SAGE_ARGTYPES = (
    [ctypes.c_void_p] * 5            # q images, kv images, svs, vmu, out
    + [ctypes.c_int] * 5             # batch, heads, lq, lk, d
    + [ctypes.c_longlong] * 3        # (b, h, l) strides of out
    + [ctypes.c_int] * 5             # q images, kv images, kv tiles attended,
                                     # softmax block in tiles, apply sk
    + [ctypes.c_void_p]              # stream
)

_SAGE_VARIANT_ARGTYPES = (
    _SAGE_ARGTYPES[:-1]
    + [ctypes.c_int] * 2             # Q.K^T in int8 (else bf16), P.V on codes (else bf16 V)
    + [ctypes.c_void_p]              # stream
)

_SAGE_PREPARE_ARGTYPES = (
    [ctypes.c_void_p] * 8            # q, k, v, q images, kv images, svs, vmu, scratch
    + [ctypes.c_int] * 5             # batch, heads, lq, lk, d
    + [ctypes.c_longlong] * 9        # (b, h, l) strides of q, k, v
    + [ctypes.c_int] * 2             # q images, kv images
    + [ctypes.c_float]               # 1 / sqrt(d)
    + [ctypes.c_int] * 2             # Q and K as int8 codes (else widened to bf16),
                                     # V as codes (else centred bf16)
    + [ctypes.c_void_p]              # stream
)

_W8A8_BF16_ARGTYPES = (
    [ctypes.c_void_p] * 7            # xq, sx, q, cs, bias, residual, out
    + [ctypes.c_int] * 3             # m, n, k
    + [ctypes.c_longlong] * 3        # row strides of xq, q, residual
    + [ctypes.c_int]                 # tile id (quant_matmul.w8a8_bf16_tile)
    + _STACK_ARGTYPES                # depth, idx (1, 0: a plain weight)
    + [ctypes.c_void_p]              # stream
)

_ROW_QUANTIZE_ARGTYPES = (
    [ctypes.c_void_p] * 5            # x, s, t, codes, sx
    + [ctypes.c_int] * 2             # m, k
    + [ctypes.c_longlong]            # row stride of x
    + [ctypes.c_int] * 2             # prologue, center
    + [ctypes.c_float] * 2           # eps, inv_qmax
    + [ctypes.c_int] * 4             # chunks per lane, warps per row, rows
                                     # per block, blocks (rowquant_geometry)
    + [ctypes.c_void_p]              # stream
)

_ROW_QUANTIZE_CONCAT_ARGTYPES = (
    [ctypes.c_void_p] * 4            # a, b window, codes, sx
    + [ctypes.c_int] * 3             # m, ka, kb
    + [ctypes.c_longlong] * 2        # row strides of a, b
    + [ctypes.c_int, ctypes.c_float]  # prologue of the window, inv_qmax
    + [ctypes.c_int] * 4             # the geometry, as for K9
    + [ctypes.c_void_p]              # stream
)

# kernel name -> (source file, exported C entry point, its argtypes)
KERNELS = {
    "flash_attention": (
        "flash_attention.cu", "ldt_flash_attention_fwd", _FLASH_ARGTYPES,
    ),
    "packed_flash_attention": (
        "packed_flash_attention.cu", "ldt_packed_flash_attention_fwd",
        _FLASH_ARGTYPES,
    ),
    "fused_qkv_attention": (
        "fused_qkv_attention.cu", "ldt_fused_qkv_attention_fwd",
        _FUSED_QKV_ARGTYPES,
    ),
    "quant_matmul": (
        "quant_matmul.cu", "ldt_quant_matmul_fwd", _QUANT_MATMUL_ARGTYPES,
    ),
    "quant_matmul_stacked": (
        "quant_matmul.cu", "ldt_quant_matmul_stacked_fwd",
        _QUANT_MATMUL_STACKED_ARGTYPES,
    ),
    "w8a8_matmul": (
        "w8a8_matmul.cu", "ldt_w8a8_matmul_fwd", _W8A8_ARGTYPES,
    ),
    "w8a8_matmul_stacked": (
        "w8a8_matmul.cu", "ldt_w8a8_matmul_stacked_fwd", _W8A8_STACKED_ARGTYPES,
    ),
    "w8a8_matmul_ep": (
        "w8a8_matmul.cu", "ldt_w8a8_matmul_ep_fwd", _W8A8_EP_ARGTYPES,
    ),
    "w8a8_matmul_ep_stacked": (
        "w8a8_matmul.cu", "ldt_w8a8_matmul_ep_stacked_fwd",
        _W8A8_EP_STACKED_ARGTYPES,
    ),
    "sage_attention": (
        "sage_attention.cu", "ldt_sage_attention_fwd", _SAGE_ARGTYPES,
    ),
    "sage_prepare": (
        "sage_attention.cu", "ldt_sage_prepare_fwd", _SAGE_PREPARE_ARGTYPES,
    ),
    "sage_attention_variant": (
        "sage_attention.cu", "ldt_sage_variant_fwd", _SAGE_VARIANT_ARGTYPES,
    ),
    "w8a8_matmul_bf16": (
        "w8a8_matmul_bf16.cu", "ldt_w8a8_bf16_matmul_fwd", _W8A8_BF16_ARGTYPES,
    ),
    "row_quantize_fused": (
        "row_quantize.cu", "ldt_row_quantize_fwd", _ROW_QUANTIZE_ARGTYPES,
    ),
    "row_quantize_concat_gelu": (
        "row_quantize.cu", "ldt_row_quantize_concat_fwd",
        _ROW_QUANTIZE_CONCAT_ARGTYPES,
    ),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}

logger = logging.getLogger(__name__)


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def _source_library(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def library_path(name: str) -> Path:
    """The built library of kernel ``name``'s source."""
    return _source_library(KERNELS[name][0])


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the sources of every listed kernel that are not built yet,
    one ``nvcc`` per source, started together. Returns per source its wall
    seconds, its library's path and the compiler's register/spill report
    (``-Xptxas -v``, kept beside the library for a cached build). Raises
    with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    running = {}
    t0 = time.perf_counter()
    for source in dict.fromkeys(KERNELS[name][0] for name in names):
        out = _source_library(source)
        if out.exists():
            log = out.with_suffix(".log")
            report[source] = {"seconds": 0.0, "path": str(out),
                              "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / source)]
        running[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for source, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[source] = {
            "seconds": time.perf_counter() - t0, "log": log, "path": str(out),
        }
        logger.debug("kernel library built: %s in %.1f s", out.name,
                     report[source]["seconds"])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed, with its C signature
    declared (every pointer and the stream as ``c_void_p``)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        lib.ldt_error_string.argtypes = [ctypes.c_int]
        lib.ldt_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
        logger.debug("kernel library loaded: %s for %s", path.name, name)
    return lib


def entry_point(name: str):
    return getattr(load(name), KERNELS[name][1])


def error_string(name: str, code: int) -> str:
    return load(name).ldt_error_string(code).decode()
