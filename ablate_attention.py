#!/usr/bin/env python3
"""What bounds K3 (``csrc/fused_qkv_attention.cu``), K1 and K2
(``csrc/packed_flash_attention.cu``, ``csrc/flash_attention.cu``, both on
``csrc/flash_attention.cuh``) on one NVIDIA GPU.

    python3 ablate_attention.py            # K3, then K1 and K2
    python3 ablate_attention.py --flash    # K1 and K2 only

Builds variants of each kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), one ``nvcc`` per variant, all
started together, and times whole calls (the k and v prologue launch and the
attention kernel) at main-path shapes beside the library yardstick and the
bound.

K3, at the Flux 1024^2 shapes, against ``scaled_dot_product_attention`` on q
and k normed and roped beforehand (it skips the prologue):
- the tile configurations (one or two consumer warpgroups of 64 q rows),
  each checked against the plain version before it is timed;
- the k and v prologue alone (``norm_rope_kv_kernel``);
- ablations of the configuration ``dispatch()`` picks at L = 4352 (timing
  only: their outputs are wrong): no softmax (the row maxima and exp2
  dropped, s goes to P.V as it is), no P.V, and no K/V copies (the
  producer arms each stage without copying). An ablation's time is what
  the remaining work costs by itself.

K1 and K2, at (2, 8, 16384, 40), (8, 8, 4096, 40), (2, 8, 4096, 80) bf16 and
the VAE's (1, 1, 16384, 512) f32 call, against
``scaled_dot_product_attention`` on the same q, k, v: the configuration the
entry point dispatches (three consumer warpgroups at d = 40, two at d = 80)
and the other count beside it (each checked against the plain version), the tile-image prologue alone
(``flash_kv_kernel``), and the same three ablations (no softmax, no P.V, no
copies).

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
SOFTMAX = "    softmax_tile<kBN>(s, m_i, alpha, rsum);\n"
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


def ablate_k3(torch, F, chip_smoke, fa):
    """K3's rows: {shape: {variant: ms}}."""
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
                sin.data_ptr(), 1, HEADS, l, l, width, txt_len, 0, 1e-6,
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
    return results


# K1 and K2: (name, B, H, L, d, dtype); the entry point's configuration, the
# alternatives timed beside it ({label: C++ launch}), the prologue alone
FLASH_SHAPES = (("packed_flash_attention", 2, 8, 16384, 40, "bf16"),
                ("packed_flash_attention", 8, 8, 4096, 40, "bf16"),
                ("flash_attention", 2, 8, 4096, 80, "bf16"),
                ("flash_attention", 1, 1, 16384, 512, "f32"))
FLASH_LAUNCH = {40: "launch_tiles<40>", 80: "launch_tiles<80>",
                512: "launch_split<true, 256>"}
FLASH_ALTERNATIVES = {40: {"two consumers": "launch_tiles<40, 2>"},
                      80: {"three consumers": "launch_tiles<80, 3>"}}
FLASH_PROLOGUE = {40: "launch_prologue<TileCfg<40, 2>, __nv_bfloat16>",
                  80: "launch_prologue<TileCfg<80, 2>, __nv_bfloat16>",
                  512: "launch_prologue<SplitCfg<true, 256>, float>"}
# the ablations' edits of csrc/flash_attention.cuh (regular expressions)
FLASH_ABLATIONS = {
    "no_softmax": ((r"softmax_tile<C::BN>\(s, m_i, alpha, rsum\);",
                    "alpha[0] = alpha[1] = 1.f; rsum[0] = rsum[1] = 0.f;"),),
    "no_pv": ((r"\n    pv_issue<C>\(o, pf, kv_base \+ prev \* C::kTileBytes \+ C::kKBytes\);", ""),
              (r"\n    pv_split_issue<C>\(o, ph\[0\], pl\[0\], va, wg\);", "")),
    "no_copies": ((r"mbar_expect_tx\(([^,]+), [^;]+\);", r"mbar_arrive(\1);"),
                  (r"bulk_copy\([^;]*\);", "")),
}


def flash_entry():
    """``ablate_flash(id, <K1's and K2's C arguments>)``: the configuration
    (id 0), an alternative (1), the prologue alone (-1), for d = 40, 80 or
    512."""
    cases = []
    for d, launch in FLASH_LAUNCH.items():
        cases.append(f"  if (d == {d} && id == 0) return {launch}(p, batch, scratch, scratch_bytes, s);")
        for alt in FLASH_ALTERNATIVES.get(d, {}).values():
            cases.append(f"  if (d == {d} && id == 1) return {alt}(p, batch, scratch, scratch_bytes, s);")
        cases.append(f"  if (d == {d} && id == -1) return {FLASH_PROLOGUE[d]}"
                     "(p, batch, scratch, scratch_bytes, s);")
    return ('\nnamespace ldt {\nextern "C" int ablate_flash(int id, LDT_FLASH_ARGS) {\n'
            "  Params p = LDT_MAKE_PARAMS;\n"
            "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
            "  (void)dtype;\n" + "\n".join(cases) + "\n  return -1;\n}\n}  // namespace ldt\n")


def build_flash(source):
    """{variant: ctypes library} of the flash header's variants."""
    import re

    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(OUT, exist_ok=True)
    texts = {"full": source}
    for name, edits in FLASH_ABLATIONS.items():
        text = source
        for pattern, replacement in edits:
            text, n = re.subn(pattern, replacement, text)
            if n == 0:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {pattern!r}")
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"flash_{name}.cu")
        with open(path, "w") as f:
            f.write(text + flash_entry())
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
             "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for flash {name}:\n{log}")
        for ln in log.splitlines():
            if "Used" in ln or "wgmma" in ln or ("spill" in ln and " 0 bytes spill" not in ln):
                print(f"  flash {name} ptxas: {ln.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"flash_{name}.so"))
        lib.ablate_flash.argtypes = [ctypes.c_int] + cuda_build.KERNELS["flash_attention"][2]
        libs[name] = lib
    return libs


def ablate_flash(torch, F, chip_smoke, fa):
    """K1's and K2's rows: {shape: {variant: ms}}."""
    with open(os.path.join(REPO, "lightdiffusion_next_tpu_torch", "csrc",
                           "flash_attention.cuh")) as f:
        libs = build_flash(f.read())
    gen = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for name, b, h, l, d, dtype in FLASH_SHAPES:
        q, k, v = chip_smoke.make_inputs(b, h, l, d, dtype, gen)
        out = torch.empty((b, l, h, d), dtype=q.dtype, device="cuda")
        geom = fa.kv_geometry(d, q.dtype, packed=name == "packed_flash_attention")
        scratch = torch.empty((b * h, geom.tiles(l), geom.tile_bytes), dtype=torch.uint8,
                              device="cuda")
        ref = fa.attention_plain(q, k, v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.float32), b, h, l, l, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], out.stride(0), out.stride(2),
                out.stride(1), fa.LOG2E / math.sqrt(d), 1, scratch.data_ptr(),
                scratch.numel(), stream)

        def launcher(lib, i):
            return lambda: lib.ablate_flash(i, *args)

        def timed(fn):
            return chip_smoke.cuda_ms(fn, chip_smoke.repeats_for(fn, 200.0))

        def checked(i, label):
            if launcher(libs["full"], i)() != 0:
                raise RuntimeError(f"{label} failed to launch at {(b, h, l, d, dtype)}")
            check = fa.agreement(out.permute(0, 2, 1, 3), ref)
            if not check["ok"]:
                raise RuntimeError(f"{label} disagrees at {(b, h, l, d, dtype)}: {check}")
            return timed(launcher(libs["full"], i))

        row = {"full": checked(0, "the dispatched configuration")}
        for i, label in enumerate(FLASH_ALTERNATIVES.get(d, {}), start=1):
            row[label] = checked(i, label)
        row["kv_prologue"] = timed(launcher(libs["full"], -1))
        for variant in FLASH_ABLATIONS:
            row[variant] = timed(launcher(libs[variant], 0))
        row["full_again"] = timed(launcher(libs["full"], 0))
        row["library"] = timed(lambda: F.scaled_dot_product_attention(q, k, v))
        row["bound"] = chip_smoke.bound(b, h, l, d, q.element_size())[0]
        results[f"{name} {b}x{h}x{l}x{d} {dtype}"] = row
        print(f"{name} ({b}, {h}, {l}, {d}) {dtype} "
              + " ".join(f"{a}={c:.4f}" for a, c in row.items()), flush=True)
        del q, k, v, out, scratch, ref
        torch.cuda.empty_cache()
    return results


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablate_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa

    config.configure_cuda_math()
    print("gpu:", chip_smoke.gpu_line(), flush=True)
    results = {} if "--flash" in sys.argv[1:] else ablate_k3(torch, F, chip_smoke, fa)
    results.update(ablate_flash(torch, F, chip_smoke, fa))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
