#!/usr/bin/env python3
"""What bounds the bf16-rate K7/K8/K11 (``csrc/w8a8_matmul_bf16.cu``) on one
NVIDIA GPU.

    python3 ablate_w8a8_bf16.py

Builds variants of the kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times each through its
C entry point at chip_smoke.py phase 25's shapes (K7 at M = 4352, K11 with
the residual at M = 256), with the tile ``ops.quant_matmul.w8a8_bf16_tile``
picks, beside ``torch.matmul`` on the codes cast to bf16 (the same-rate
yardstick, no epilogue) and the bound:

- ``kernel``: the source as it is, timed first and last (the spread), and
  at every tile of ``W8A8_BF16_TILES``;
- ablations (timing only: their outputs are wrong): ``no_convert`` (the
  products run on whatever the bf16 buffers hold), ``no_mma``,
  ``no_copies`` (the conversion reads whatever the ring holds),
  ``mma_alone`` (no copies, no conversion). An ablation's time is what the
  remaining work costs by itself;
- ``f32_convert``: hopper.cuh's exact int8 -> bf16 conversion as first
  written (each byte as the f32 2^23 + 128 + b, less 2^23 + 128, truncated:
  11 instructions a word against the two bf16x2 subtractions' 8), checked
  bit for bit against ``kernel``.

Prints one line per shape and writes every time (ms per call) as JSON to
``build/ablate/ablate_w8a8_bf16.json``.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "ablate")
sys.path.insert(0, REPO)

# (M, K, N, residual): phase 25's K7 shapes and the text stream's mlp.2
SHAPES = ((4352, 3072, 3072, False), (4352, 3072, 12288, False), (4352, 12288, 3072, False),
          (4352, 3072, 9216, False), (256, 12288, 3072, True))
CONVERT = ("  convert_tile<C::BM, C::kThreads>(codes, w);\n",
           "  convert_tile<BN, C::kThreads>(codes + C::kABytes, w + C::kABuf);\n")
MMA = "    mma_step<WGS, BN>(acc, base, t % kWBufs, t > 0);\n"
COPIES = ("    if (s < steps) load_step<WGS, BN>(base + C::kRing, s, s, g, m0, n0);\n",
          "      load_step<WGS, BN>(base + C::kRing, t % kStages, t + kStages, g, m0, n0);\n")
# s8x4_to_bf16 as it was first written: each byte as the f32 2^23 + 128 + b,
# less 2^23 + 128, truncated to bf16 (11 instructions a word)
F32_CONVERT = r"""
__device__ __forceinline__ void s8x4_to_bf16_f32(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  constexpr float kBias = 8388736.0f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}
"""
EDITS = {
    "no_convert": tuple((line, "") for line in CONVERT),
    "no_mma": ((MMA, ""),),
    "no_copies": tuple((line, "") for line in COPIES),
    "mma_alone": tuple((line, "") for line in COPIES + CONVERT),
    "f32_convert": (("    s8x4_to_bf16(x.", "    s8x4_to_bf16_f32(x."),),
}
EXACT = ("f32_convert",)  # variants that must give the kernel's output
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def build_all():
    """{variant: its ldt_w8a8_bf16_matmul_fwd}; one nvcc per variant,
    started together."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(OUT, exist_ok=True)
    source = (cuda_build.CSRC / "w8a8_matmul_bf16.cu").read_text()
    texts = {"kernel": source}
    for name, edits in EDITS.items():
        text = source
        for line, replacement in edits:
            if line not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {line!r}")
            text = text.replace(line, replacement)
        if name == "f32_convert":  # the helper goes before the function that calls it
            at = text.index("template <int ROWS, int THREADS>")
            text = text[:at] + F32_CONVERT.lstrip() + "\n" + text[at:]
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"w8a8_bf16_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "w8a8_bf16_matmul_kernel" in ln and ("C75" in ln or "spill" in ln)]
        fn = ctypes.CDLL(os.path.join(OUT, f"w8a8_bf16_{name}.so")).ldt_w8a8_bf16_matmul_fwd
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns, logs


def main() -> int:
    import torch

    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    if not torch.cuda.is_available():
        print("ablate_w8a8_bf16: no CUDA device", file=sys.stderr)
        return 2
    print("gpu:", chip_smoke.gpu_line())
    fns, logs = build_all()
    for name, lines in logs.items():
        print(f"ptxas {name}: {lines or 'no C75xx warning, no spill line'}")
    gen = torch.Generator(device="cuda").manual_seed(28)
    stream = torch.cuda.current_stream().cuda_stream
    results, ok = [], True
    for m, k, n, residual in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        xq, sx = qm.row_quantize_fused(x)
        sx = sx.reshape(-1)
        q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        cs = (0.5 + torch.rand((n,), generator=gen, device="cuda")) * (3 / (127 * k**0.5))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda") if residual else None
        res = torch.randn((m, n), generator=gen, device="cuda").bfloat16() if residual else None
        tile = qm.w8a8_bf16_tile(m, n, k)

        def call(name, tile=tile):
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            rc = fns[name](xq.data_ptr(), sx.data_ptr(), q.data_ptr(), cs.data_ptr(),
                           bias.data_ptr() if residual else None,
                           res.data_ptr() if residual else None, out.data_ptr(), m, n, k, k, k,
                           n if residual else 0, tile, 1, 0, stream)
            if rc:
                raise RuntimeError(f"{name}: kernel returned {rc}")
            return out

        ref = call("kernel")
        same = {name: torch.equal(call(name), ref) for name in EXACT}
        ok = ok and all(same.values())
        times = {"kernel": chip_smoke.cuda_ms(lambda: call("kernel"), 20)}
        for name in EDITS:
            times[name] = chip_smoke.cuda_ms(lambda name=name: call(name), 20)
        for t_ in range(len(qm.W8A8_BF16_TILES)):  # every tile, the chosen one included
            times[f"kernel_tile_{t_}"] = chip_smoke.cuda_ms(lambda t_=t_: call("kernel", t_), 20)
        times["kernel_again"] = chip_smoke.cuda_ms(lambda: call("kernel"), 20)
        a16, b16 = xq.to(torch.bfloat16), q.t().to(torch.bfloat16)
        times["torch_matmul_bf16"] = chip_smoke.cuda_ms(lambda: torch.matmul(a16, b16), 20)
        bound = chip_smoke.bf16_rate_bound(m, k, n, residual, residual)
        rec = {"shape": [m, k, n], "residual": residual,
               "tile": qm.W8A8_BF16_TILES[tile], "bound_ms": bound[0], "bound_by": bound[1],
               "bit_for_bit": same, **times}
        results.append(rec)
        print(json.dumps(rec))
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ablate_w8a8_bf16.json"), "w") as f:
        json.dump({"gpu": chip_smoke.gpu_line(), "ptxas": logs, "shapes": results}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
