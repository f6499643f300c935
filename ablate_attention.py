#!/usr/bin/env python3
"""What bounds K3 (``csrc/fused_qkv_attention.cu``) on one NVIDIA GPU.

    python3 ablate_attention.py

Builds variants of the kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times whole K3 calls (the
k and v prologue launch and the attention kernel) at main-path shapes of the Flux
1024^2 image beside ``scaled_dot_product_attention`` on q and k normed and
roped beforehand (the library yardstick; it skips the prologue) and the
bound:

- the tile configurations (one or two consumer warpgroups of 64 q rows),
  each checked against the plain version before it is timed;
- the k and v prologue alone (``norm_rope_kv_kernel``);
- ablations of the configuration ``dispatch()`` picks at L = 4352 (timing
  only: their outputs are wrong): no softmax (the row maxima and exp2
  dropped, s goes to P.V as it is), no P.V, and no K/V copies (the
  producer arms each stage without copying). An ablation's time is what
  the remaining work costs by itself.

The full kernel is timed first and last, so the spread of one call shows.
Prints one line per shape and a JSON object of every time (ms per call).
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "ablate")
HEADS = 24
SHAPES = ((4352, 21504, 0), (1280, 9216, 256))  # (L, qkv width, txt_len)
# name: consumer warpgroups of 64 q rows
TILES = {"128 rows": 2, "64 rows": 1}
ABLATED_TILE = "128 rows"
# source lines an ablation replaces (by "": drops)
SOFTMAX = "    softmax_tile(s, m_i, alpha, rsum);\n"
PV = "    pv_issue(o, pf, kv_base + prev * C::kStageBytes + kTileBytes);\n"
ARM = "        mbar_expect_tx(full + 8 * st, C::kStageBytes);\n"
KCOPY = ("        bulk_copy(dst, src + static_cast<long long>(t) * 2 * kTileElems, kTileBytes,"
         " full + 8 * st);\n")
VCOPY = ("        bulk_copy(dst + kTileBytes, src + (2LL * t + 1) * kTileElems, kTileBytes,"
         " full + 8 * st);\n")
ABLATIONS = {"no_softmax": ((SOFTMAX, ""),), "no_pv": ((PV, ""),),
             "no_copies": ((ARM, "        mbar_arrive(full + 8 * st);\n"), (KCOPY, ""),
                           (VCOPY, ""))}


def entry(tiles):
    """``ablate_launch(id, <K3's C arguments>)``: the k and v prologue, then
    tile ``id``'s kernel (id < 0: the prologue alone)."""
    cases = "".join(f"  if (id == {i}) return launch<{w}>(p, batch, s);\n"
                    for i, w in enumerate(tiles))
    return ('\nextern "C" int ablate_launch(int id, LDT_FUSED_QKV_ARGS) {\n'
            "  Params p;\n"
            "  const int rc = LDT_FUSED_QKV_START(p);\n"
            "  if (rc != 0 || id < 0) return rc;\n"
            "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
            f"{cases}  return -1;\n}}\n")


def build_all(source):
    """{variant: ctypes library}; one nvcc per variant, started together."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(OUT, exist_ok=True)
    texts = {"tiles": source + entry(TILES.values())}
    for name, edits in ABLATIONS.items():
        text = source
        for line, replacement in edits:
            if line not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {line!r}")
            text = text.replace(line, replacement)
        texts[name] = text + entry([TILES[ABLATED_TILE]])
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"attention_{name}.cu")
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
        for ln in log.splitlines():
            if "wgmma" in ln or ("spill" in ln and " 0 bytes spill" not in ln):
                print(f"  {name} ptxas: {ln.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"attention_{name}.so"))
        lib.ablate_launch.argtypes = ([ctypes.c_int]
                                      + cuda_build.KERNELS["fused_qkv_attention"][2])
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablate_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    print("gpu:", chip_smoke.gpu_line(), flush=True)
    with open(os.path.join(REPO, "lightdiffusion_next_tpu_torch", "csrc",
                           "fused_qkv_attention.cu")) as f:
        libs = build_all(f.read())
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for l, width, txt_len in SHAPES:
        qkv = torch.randn((1, l, width), generator=gen, device="cuda").bfloat16()
        sc = [(1.0 + 0.2 * torch.randn((128,), generator=gen, device="cuda")).float()
              for _ in range(4)]
        cos, sin = chip_smoke.flux_rope(l)
        out = torch.empty((1, l, HEADS * 128), dtype=torch.bfloat16, device="cuda")
        kv_scratch = torch.empty((1, HEADS, -(-l // 128) * 128, 256), dtype=torch.bfloat16,
                                 device="cuda")
        kw = dict(num_heads=HEADS, txt_len=txt_len, txt_q_scale=sc[2], txt_k_scale=sc[3])
        ref = fa.fused_qkv_attention_plain(qkv, sc[0], sc[1], cos, sin, **kw)
        args = (qkv.data_ptr(), out.data_ptr(), kv_scratch.data_ptr(), sc[0].data_ptr(),
                sc[1].data_ptr(), sc[2].data_ptr(), sc[3].data_ptr(), cos.data_ptr(),
                sin.data_ptr(), 1, HEADS, l, l, width, txt_len, 1e-6,
                fa.LOG2E / math.sqrt(128), stream)

        def launcher(lib, i):
            return lambda: lib.ablate_launch(i, *args)

        def timed(fn):
            return chip_smoke.cuda_ms(fn, chip_smoke.repeats_for(fn, 200.0))

        row = {"full": timed(launcher(libs["tiles"], 0))}
        for i, tile in enumerate(TILES):
            if launcher(libs["tiles"], i)() != 0:
                raise RuntimeError(f"tile {tile} failed to launch at {(l, width, txt_len)}")
            check = fa.agreement(out, ref)
            if not check["ok"]:
                raise RuntimeError(f"tile {tile} disagrees at {(l, width, txt_len)}: {check}")
            row[tile] = timed(launcher(libs["tiles"], i))
        row["kv_prologue"] = timed(launcher(libs["tiles"], -1))
        for name in ABLATIONS:
            row[name] = timed(launcher(libs[name], 0))
        row["full_again"] = timed(launcher(libs["tiles"], 0))
        hd = HEADS * 128
        q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(1, l, HEADS, 128) for i in range(3))
        qn = fa._norm_rope(q, sc[0], sc[2], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        kn = fa._norm_rope(k, sc[1], sc[3], txt_len, cos, sin, 1e-6).bfloat16().transpose(1, 2)
        vh = v.transpose(1, 2)
        row["library"] = timed(lambda: F.scaled_dot_product_attention(qn, kn, vh))
        row["bound"] = chip_smoke.fused_bound(l)[0]
        results[f"{l}x{width}x{txt_len}"] = row
        print(f"({l}, {width}, {txt_len}) " + " ".join(f"{a}={b:.4f}" for a, b in row.items()),
              flush=True)
        del qkv, out, kv_scratch, ref, q, k, v, qn, kn, vh
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
