"""Host C++ under the GGUF reader: the Q8_0 block split.

Counterpart of lightdiffusion_next_tpu/utils/native.py. The library is the
port's own copy of what it needs of ``native/ldt_native.cpp``
(``csrc/ldt_native.cpp``: ``ldt_split_q8_0``, threaded), built with ``g++
-O3 -shared -fPIC -pthread`` at first use into ``build/native/`` at the
repository root (listed in ``.gitignore``; the file name carries a hash of
the source, the flags and the toolchain: the machine, g++'s version and the
C library's, so a library built on another machine is rebuilt, not loaded)
and loaded with ``ctypes``. A failed build or load
raises with the compiler's message: there is no numpy fallback, so a reader
that runs went through the C++ split.

``split_q8_0`` serves ``ops.ggml._load_tensor``, as the JAX reader's does
(JAX ``ops/ggml.py:830-835``); ``split_q8_0_plain`` is its plain version
(torch copies), which the tests hold it to.

The JAX module's other functions have no caller in the port:

- ``bf16_to_f32`` and ``f16_to_f32`` (JAX ``utils/state_dict.py``'s
  safetensors bf16): the port widens bf16 and f16 payloads with torch's own
  dtypes (``tensor.view(torch.bfloat16).float()``);
- ``transpose2d`` (JAX ``ggml.transpose_for_matmul``'s host transpose of
  the Q8_0 codes): the port's ``transpose_for_matmul`` is one
  ``.t().contiguous()`` on the device the record lies on, and its W8A8
  codes stay (N, K), K-contiguous, as the file stores them;
- ``dequant_q8_0``: the port keeps Q8_0 codes and scales apart and
  dequantizes on the card (``QTensor8.dequantize``, K5);
- ``box_blur_2d``: no caller in the JAX package either.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "ldt_native.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
Q8_0_BLOCK_BYTES = 34  # an f16 scale, then 32 int8 codes

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

logger = logging.getLogger(__name__)


def _gxx(*args: str) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native: g++ not found ({e}); the GGUF reader needs it") from e


def toolchain() -> str:
    """What a built library depends on besides its source and flags: the
    machine, g++'s version and target, and the C library's version."""
    version, target = (_gxx(flag).stdout.strip() for flag in ("-dumpfullversion",
                                                                "-dumpmachine"))
    return " ".join((platform.machine(), version, target, *platform.libc_ver()))


def library_path(source: Path = SOURCE) -> Path:
    """The built library of ``source``: its name carries a hash of the
    source, the flags and ``toolchain()``, so an edited source, or a
    library built on another machine, is rebuilt."""
    digest = hashlib.sha256("\n".join((*CXX_FLAGS, toolchain())).encode()
                            + source.read_bytes())
    return BUILD_DIR / f"libldt_native-{digest.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless it is built; raises with the compiler's
    output when ``g++`` fails or is missing."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = _gxx(*CXX_FLAGS, "-o", str(tmp), str(source))
    if proc.returncode != 0:
        raise RuntimeError(f"native: g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    logger.debug("native library built: %s", out.name)
    return out


def load_library(source: Path = SOURCE) -> ctypes.CDLL:
    """The library of ``source`` (built first if needed) with its entry
    point declared; the package's own is loaded once."""
    global _lib
    with _lock:
        if _lib is not None and source == SOURCE:
            return _lib
        lib = ctypes.CDLL(str(build(source)))
        lib.ldt_split_q8_0.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
        lib.ldt_split_q8_0.restype = None
        if source == SOURCE:
            _lib = lib
        return lib


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def split_q8_0(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q8_0 blocks (n, 34) uint8 on the CPU -> (codes (n, 32) int8, scales
    (n,) f32), through the C++ split."""
    if blocks.device.type != "cpu" or blocks.dtype != torch.uint8 \
            or blocks.dim() != 2 or blocks.shape[1] != Q8_0_BLOCK_BYTES:
        raise ValueError(f"split_q8_0: (n, 34) uint8 CPU blocks, got {tuple(blocks.shape)} "
                         f"{blocks.dtype} on {blocks.device}")
    blocks = blocks.contiguous()
    n = blocks.shape[0]
    q = torch.empty((n, 32), dtype=torch.int8)
    scales = torch.empty((n,), dtype=torch.float32)
    load_library().ldt_split_q8_0(blocks.data_ptr(), q.data_ptr(), scales.data_ptr(), n,
                                  _threads())
    return q, scales


def split_q8_0_plain(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``split_q8_0``: torch's copies of the codes and of
    the f16 scales widened to f32."""
    return (blocks[:, 2:].contiguous().view(torch.int8),
            blocks[:, :2].contiguous().view(torch.float16).float().reshape(-1))
