#!/usr/bin/env python3
"""What bounds K5 (``csrc/quant_matmul.cu``) on one NVIDIA GPU.

    python3 ablate_quant_matmul.py

Builds variants of the kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times them at main-path
shapes of the Flux Q8_0 image beside ``torch.matmul`` on the weight
dequantized beforehand (the library yardstick) and the bound:

- the tile configurations (two warpgroups of 256 x 128 and 128 x 128, one
  warpgroup of 64 x 128 and 64 x 64), each checked against the plain
  version before it is timed;
- ablations of the 256 x 128 tile (timing only: their outputs are wrong):
  no dequant, no MMA, no copies (neither x nor codes), and MMA alone.
  An ablation's time is what the remaining work costs by itself.

The full kernel is timed first and last, so the spread of one call shows.
Prints one line per shape and a JSON object of every time (ms per call).
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
SHAPES = ((4352, 3072, 21504), (4352, 15360, 3072), (4096, 3072, 3072), (1024, 3072, 9216),
          (256, 3072, 9216), (256, 12288, 3072), (256, 3072, 3072))
TILES = {"256x128": (2, 2, 128), "128x128": (2, 1, 128), "64x128": (1, 1, 128),
         "64x64": (1, 1, 64)}
# source lines an ablation drops
DEQUANT = "    if (t + 1 < steps) dequant_step<C>(smem, (t + 1) % kStages, (t + 1) % kWBufs);\n"
MMA = "    mma_step<C, MT>(acc, base, t % kStages, t % kWBufs);\n"
XCOPY = "    cp_async_16(xs + r * 128 + ((ch ^ (r & 7)) << 4), src, ok ? 16 : 0);\n"
QCOPY = ("    cp_async_16(qs + c * 16,\n"
         "                qt + static_cast<long long>(k0 + r) * n + n0 + ch * 16, 16);\n")
ABLATIONS = {"no_dequant": (DEQUANT,), "no_mma": (MMA,), "no_copies": (XCOPY, QCOPY),
             "mma_alone": (DEQUANT, XCOPY, QCOPY)}


def entry(tiles):
    cases = "".join(
        f"  if (id == {i}) return launch<{w}, {mt}, {bn}, false>(xb, q, sc, o, m, n, k, k, 0, 0, "
        "0, s);\n" for i, (w, mt, bn) in enumerate(tiles))
    return ('\nextern "C" int ablate_launch(int id, const void* x, const void* qt, '
            "const void* scales, void* out, int m, int n, int k, void* stream) {\n"
            "  const auto* xb = static_cast<const __nv_bfloat16*>(x);\n"
            "  const auto* q = static_cast<const int8_t*>(qt);\n"
            "  const auto* sc = static_cast<const float*>(scales);\n"
            "  auto* o = static_cast<__nv_bfloat16*>(out);\n"
            "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
            f"{cases}  return -1;\n}}\n")


def build_all(source):
    """{variant: ctypes library}; one nvcc per variant, started together."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(OUT, exist_ok=True)
    texts = {"tiles": source + entry(TILES.values())}
    for name, drops in ABLATIONS.items():
        text = source
        for line in drops:
            if line not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {line!r}")
            text = text.replace(line, "")
        texts[name] = text + entry([TILES["256x128"]])
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
             "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        lib.ablate_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_quant_matmul: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    print("gpu:", chip_smoke.gpu_line(), flush=True)
    with open(os.path.join(REPO, "lightdiffusion_next_tpu_torch", "csrc",
                           "quant_matmul.cu")) as f:
        libs = build_all(f.read())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for m, k, n in SHAPES:
        qt = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        sc = 1e-3 + 4e-4 * torch.rand((k // 32, n), generator=gen, device="cuda")
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        ref = qm.quant_matmul_plain(x, qt, sc)

        def launcher(lib, i):
            return lambda: lib.ablate_launch(i, x.data_ptr(), qt.data_ptr(), sc.data_ptr(),
                                             out.data_ptr(), m, n, k, stream)

        def timed(fn):
            return chip_smoke.cuda_ms(fn, chip_smoke.repeats_for(fn, 200.0))

        row = {"full": timed(launcher(libs["tiles"], 0))}
        for i, tile in enumerate(TILES):
            if launcher(libs["tiles"], i)() != 0:
                raise RuntimeError(f"tile {tile} failed to launch at {(m, k, n)}")
            check = fa.agreement(out, ref, max_ulps=qm.MAX_ULPS,
                                 rel_rmse_limit=qm.REL_RMSE_LIMIT)
            if not check["ok"]:
                raise RuntimeError(f"tile {tile} disagrees at {(m, k, n)}: {check}")
            row[tile] = timed(launcher(libs["tiles"], i))
        for name in ABLATIONS:
            row[name] = timed(launcher(libs[name], 0))
        row["full_again"] = timed(launcher(libs["tiles"], 0))
        w = qm.dequantize_t(qt, sc, torch.bfloat16)
        row["library"] = timed(lambda: torch.matmul(x, w))
        row["bound"] = chip_smoke.q8_bound(m, k, n)[0]
        results[f"{m}x{k}x{n}"] = row
        print(f"({m}, {k}, {n}) " + " ".join(f"{a}={b:.4f}" for a, b in row.items()),
              flush=True)
        del qt, sc, x, out, ref, w
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
