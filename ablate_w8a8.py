#!/usr/bin/env python3
"""What bounds K7 and K11 (``csrc/w8a8_matmul.cu``) on one NVIDIA GPU.

    python3 ablate_w8a8.py              # every shape of chip_smoke.W8A8_TABLE
    python3 ablate_w8a8.py --shapes 10  # the ten that take the most time
    python3 ablate_w8a8.py --parent DIR # and DIR's kernel beside it, in turns
    python3 ablate_w8a8.py --sass DIR   # the SASS of DIR/w8a8_matmul.cu

Builds variants of the kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times them at the
shapes of ``chip_smoke.W8A8_TABLE`` (the Flux W8A8 image's, a TP rank's, a
ragged M), each with its epilogue (bias or gated residual), beside ``torch._int_mm`` on the same codes (the library
yardstick, without the epilogue) and the bound:

- the tiles (``TILES``), each checked bit for bit against the plain
  version before it is timed;
- ablations of the tile ``ops.quant_matmul.w8a8_tile`` picks (timing only:
  their outputs are wrong): no MMA, no copies (the producer arrives on each
  stage's mbarrier without a TMA copy), no epilogue (the sums folded into
  one word instead, so the products stay live), and MMA alone (no copies,
  no epilogue). An ablation's time is what the remaining work costs by
  itself;
- the production entry points, unstacked and on the last block of a stack
  of two (they launch one kernel instantiation);
- with ``--parent DIR``, DIR's production entry point (another design of the
  kernel, e.g. the parent commit's from git archive under scratch_chip/),
  built by DIR's own ``ops/cuda_build.py`` and given the tile DIR's
  ``w8a8_tile`` picks, bit for bit against this tree's output and timed in
  turns with it (DIR's, this, this, DIR's).

The kernel as the wrapper picks it is timed first and last, so the spread
of one call shows. Prints one line per shape and a JSON object of every
time (ms per call).

``--sass DIR`` builds ``DIR/w8a8_matmul.cu`` (with ``-I DIR``), prints each
``w8a8_matmul_kernel`` instantiation's ptxas line, instruction count and
opcode counts, and the opcodes whose counts differ between instantiations
that differ only in a bool template argument; it writes each one's SASS to
``build/ablate/sass/``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

OUT = os.path.join(REPO, "build", "ablate")
SHAPES = chip_smoke.W8A8_TABLE  # (M, K, N, epilogue), the costliest first
MODES = {"plain": 0, "bias": 1, "residual": 2}
# name -> (consumer warpgroups, m64 tiles per warpgroup, BN, blocks a
# cluster, ring stages: as many as fit the block's share of an SM)
TILES = {"256x128x2": (2, 2, 128, 2, 4), "256x128": (2, 2, 128, 1, 4),
         "128x128x2": (2, 1, 128, 2, 6), "128x128": (2, 1, 128, 1, 6),
         "64x128": (1, 1, 128, 1, 4), "64x64": (1, 1, 64, 1, 6)}
# source lines an ablation replaces: the copies (the producer arrives on the
# stage's full mbarrier instead, so the consumers still walk the ring) and
# the products dropped, the epilogue replaced by a sink that keeps the
# products live (ptxas drops wgmmas whose sums are never read)
COPIES = ("          load_step<WGS, MT, BN, CL>(ta, tb, base + st * C::kStage, full + 8 * st, t,"
          " m0, n0,\n                                     rank, g);\n",
          "          mbar_arrive(full + 8 * st);\n")
MMA = "        mma_step<WGS, MT, BN, CL>(acc, base + st * C::kStage, wg, t > 0);\n"
EPILOGUE = ("      store_tile<WGS, MT, BN, MODE>(acc, p, g, to, m0, n0, params + (wg * 2 + parity)"
            " * 2 * BN,\n                                    outs + wg * C::kOut);\n")
SINK = ("      {\n        uint32_t x = 0;\n#pragma unroll\n"
        "        for (int mt = 0; mt < MT; ++mt)\n"
        "#pragma unroll\n          for (int j = 0; j < BN / 2; ++j) x ^= acc[mt][j];\n"
        "        if (x == 0x9E3779B9u) reinterpret_cast<uint32_t*>(g.out)[threadIdx.x] = x;\n"
        "      }\n")
ABLATIONS = {"no_mma": ((MMA, ""),), "no_copies": (COPIES,),
             "no_epilogue": ((EPILOGUE, SINK),),
             "mma_alone": (COPIES, (EPILOGUE, SINK))}


def entry(tiles):
    cases = "".join(
        f"  if (id == {i} && mode == {mode}) return run<{w}, {mt}, {bn}, {cl}, {st}, {mode}>(p, s);\n"
        for i, (w, mt, bn, cl, st) in enumerate(tiles) for mode in MODES.values())
    return ('\nextern "C" int ablate_launch(int id, int mode, const void* xq, const void* sx, '
            "const void* q, const void* cs, const void* bias, const void* res, void* out, "
            "int m, int n, int k, void* stream) {\n"
            "  const Problem p{xq, static_cast<const float*>(sx), q,\n"
            "                  static_cast<const float*>(cs), static_cast<const float*>(bias),\n"
            "                  static_cast<const __nv_bfloat16*>(res),\n"
            "                  static_cast<__nv_bfloat16*>(out), m, n, k, k, k, n, n, 0};\n"
            "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
            f"{cases}  return -1;\n}}\n")


def nvcc(path, include):
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    return subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", include, "-o",
         path[:-3] + ".so", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(source, chosen):
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
        texts[name] = text + entry([TILES[chosen]])
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"w8a8_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = nvcc(path, str(cuda_build.CSRC))
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"w8a8_{name}.so"))
        lib.ablate_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def sass_report(src_dir):
    """The ptxas lines and SASS opcode counts of every w8a8_matmul_kernel
    instantiation built from ``src_dir``/w8a8_matmul.cu."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(os.path.join(OUT, "sass"), exist_ok=True)
    path = os.path.join(OUT, "sass_w8a8_matmul.cu")
    with open(os.path.join(src_dir, "w8a8_matmul.cu")) as f, open(path, "w") as g:
        g.write(f.read())
    proc = nvcc(path, os.path.abspath(src_dir))
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    ptxas = chip_smoke.ptxas_functions(log)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", path[:-3] + ".so"], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "w8a8_matmul_kernel" not in name:
            continue
        ops = chip_smoke.SASS_OPCODE.findall(part)
        counts[name] = collections.Counter(ops)
        with open(os.path.join(OUT, "sass", f"{name[:120]}.txt"), "w") as f:
            f.write(part)
        print(f"{name}: {'; '.join(ptxas.get(name, []))}; {len(ops)} instructions; "
              + ", ".join(f"{op} {n}" for op, n in counts[name].most_common()), flush=True)
    groups = collections.defaultdict(list)
    for name in counts:
        groups[re.sub(r"Lb[01]E", "", name)].append(name)
    for names in groups.values():
        if len(names) != 2:
            continue
        a, b = sorted(names)
        diff = {op: (counts[a][op], counts[b][op]) for op in set(counts[a]) | set(counts[b])
                if counts[a][op] != counts[b][op]}
        print(f"differ: {a} vs {b}: "
              + ", ".join(f"{op} {x} vs {y}" for op, (x, y) in sorted(diff.items())), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", type=int, default=len(SHAPES))
    parser.add_argument("--sass", metavar="DIR")
    parser.add_argument("--parent", metavar="DIR")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ablate_w8a8: no CUDA device", file=sys.stderr)
        return 2
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    print("gpu:", chip_smoke.gpu_line(), flush=True)
    if args.sass:
        return sass_report(args.sass)
    chosen = {qm.w8a8_tile(m, n, k) for m, k, n, _ in SHAPES[:args.shapes]}
    by_id = {(w * mt * 64, bn, w, cl, st): name for name, (w, mt, bn, cl, st) in TILES.items()}
    picked = {t: by_id[qm.W8A8_TILES[t]] for t in chosen}
    main_tile = by_id[qm.W8A8_TILES[qm.w8a8_tile(SHAPES[0][0], SHAPES[0][2], SHAPES[0][1])]]
    with open(os.path.join(REPO, "lightdiffusion_next_tpu_torch", "csrc",
                           "w8a8_matmul.cu")) as f:
        libs = build_all(f.read(), main_tile)
    other = None
    if args.parent:
        import compare_builds

        other = compare_builds.load_build(os.path.abspath(args.parent))
        other.build(["w8a8_matmul_ep"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    ids = {name: i for i, name in enumerate(TILES)}
    results = {"ablated_tile": main_tile, "picked": {str(t): n for t, n in picked.items()},
               "parent": args.parent}

    def timed(fn):
        return chip_smoke.cuda_ms(fn, chip_smoke.repeats_for(fn, 200.0))

    for m, k, n, ep in SHAPES[:args.shapes]:
        mode = MODES[ep]
        q3 = torch.randint(-127, 128, (2, n, k), generator=gen, device="cuda", dtype=torch.int8)
        q = q3[1]
        cs = (0.5 + torch.rand((n,), generator=gen, device="cuda")) / (127 * k**0.5)
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        xq, sx = qm.row_quantize_fused(chip_smoke.activations(m, k, gen))
        sx1 = sx.reshape(-1)
        r = chip_smoke.activations(m, n, gen) if ep == "residual" else None
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        ref = qm._epilogue_plain(xq, sx, q, cs, bias, r)
        tile = picked[qm.w8a8_tile(m, n, k)]

        def launcher(lib, i):
            return lambda: lib.ablate_launch(
                i, mode, xq.data_ptr(), sx1.data_ptr(), q.data_ptr(), cs.data_ptr(),
                bias.data_ptr(), None if r is None else r.data_ptr(), out.data_ptr(),
                m, n, k, stream)

        row = {"tile": tile, "full": timed(launcher(libs["tiles"], ids[tile]))}
        for name in TILES:
            if launcher(libs["tiles"], ids[name])() != 0:
                raise RuntimeError(f"tile {name} failed to launch at {(m, k, n)}")
            check = qm.matmul_agreement(out, ref)
            if not check["ok"]:
                raise RuntimeError(f"tile {name} disagrees at {(m, k, n)}: {check}")
            row[name] = timed(launcher(libs["tiles"], ids[name]))
        if tile == main_tile:
            for name in ABLATIONS:
                row[name] = timed(launcher(libs[name], 0))
        kw = dict(bias=bias, residual=r, ep=True)
        row["entry"] = timed(lambda: qm._launch_w8a8(xq, sx1, q, cs, **kw))
        row["entry_stacked"] = timed(lambda: qm._launch_w8a8(xq, sx1, q3, cs, idx=1, **kw))
        if other is not None:
            ptile = compare_builds.other_tile(args.parent, m, n, k)
            pout = torch.empty_like(out)

            def parent_entry():
                rc = other.entry_point("w8a8_matmul_ep")(
                    xq.data_ptr(), sx1.data_ptr(), q.data_ptr(), cs.data_ptr(), bias.data_ptr(),
                    None if r is None else r.data_ptr(), pout.data_ptr(), m, n, k, k, k,
                    n if r is not None else 0, ptile, stream)
                if rc != 0:
                    raise RuntimeError(f"the parent's kernel failed at {(m, k, n)}: {rc}")
            parent_entry()
            torch.cuda.synchronize()
            if not torch.equal(pout, qm._launch_w8a8(xq, sx1, q, cs, **kw)):
                raise RuntimeError(f"the two designs disagree at {(m, k, n)}")
            this_entry = lambda: qm._launch_w8a8(xq, sx1, q, cs, **kw)  # noqa: E731
            row["parent_tile"] = ptile
            row["parent_entry"], row["entry_turn"], row["entry_turn2"], row["parent_entry2"] = (
                timed(parent_entry), timed(this_entry), timed(this_entry), timed(parent_entry))
        row["full_again"] = timed(launcher(libs["tiles"], ids[tile]))
        row["library"] = timed(lambda: torch._int_mm(xq, q.t()))
        row["bound"] = chip_smoke.int8_bound(m, k, n, True, r is not None)[0]
        row["fastest"] = min(TILES, key=lambda name: row[name])
        results[f"{m}x{k}x{n}"] = row
        print(f"({m}, {k}, {n}) {ep} " + " ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}" for a, b in row.items()),
            flush=True)
        del q3, q, cs, bias, xq, sx, sx1, r, out, ref
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
