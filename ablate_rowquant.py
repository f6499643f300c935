#!/usr/bin/env python3
"""What bounds K9 and K10 (``csrc/row_quantize.cu``) on one NVIDIA GPU.

    python3 ablate_rowquant.py              # the kernel in the repository
    python3 ablate_rowquant.py --parent DIR # and DIR/row_quantize.cu beside it
                                            # (e.g. a parent tree from git
                                            # archive)
    python3 ablate_rowquant.py --sass       # SASS opcode counts per instantiation

Builds variants of each kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times them at every K9
and K10 shape of the Flux W8A8 1024^2 path (``SHAPES``), each beside its
bound (``chip_smoke.rowquant_bound``):

- the kernel as it stands, checked against the plain version first
  (``quant_matmul.codes_agreement``, bit for bit for the "none" prologue);
- a copy of the same bytes: the same loads and one-byte stores, no
  arithmetic (the bandwidth this access pattern reaches);
- ablations (timing only: their codes are wrong). Of the kernel with one
  block per row: the prologue dropped, the division replaced by a
  multiply, the GELU's tanh replaced by a cheaper form. Of the persistent
  kernel: the prologue dropped, the
  multiply without its guarded division, the GELU back on ``tanhf``, and
  "one_pass", the kernel on a grid of one row per group (nothing in flight
  behind a row). An ablation's time is what the remaining work costs by
  itself.

Each timing is one C loop of launches over rotating copies of the inputs,
enough of them to exceed the 50 MB L2 cache, so every launch reads its
rows from device memory as the bound assumes. It also times the wrapper
``quant_matmul.row_quantize_fused`` at (256, 3072) on the host, the
repository's and (``--parent``: DIR's tree) the parent's in turns, each in
a subprocess: 1000 calls under ``time.perf_counter`` without a sync, beside
CUDA events over the same calls, the repository wrapper's parts, and the
backward guard's share (``grad_guard.no_backward``: the wrapper against
its body without the guard, in ten turns).
Prints one line per shape and a JSON object of every time (µs per call).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "ablate")
# (kernel, prologue, M, K of a, K10's window (lo, hi) of a row of width
# hi, calls per DiT call) at batch 1, 4096 image and 256 text tokens
SHAPES = (("K9", "ln_mod", 4096, 3072, None, 38), ("K9", "ln_mod", 256, 3072, None, 38),
          ("K9", "ln_mod", 4352, 3072, None, 38), ("K9", "none", 4096, 3072, None, 19),
          ("K9", "none", 256, 3072, None, 19), ("K9", "gelu", 4096, 12288, None, 19),
          ("K9", "gelu", 256, 12288, None, 19), ("K10", "gelu", 4352, 3072, (9216, 21504), 38))
PROLOGUES = {"none": 0, "gelu": 1, "ln_mod": 2}
L2_BYTES = 50e6

# Per kernel generation: the line that identifies its source, the source
# lines each ablation replaces, and the C entry the variants export
# (ablate_launch: `reps` launches over `nbuf` copies of the inputs).
BLOCK_PER_ROW = {
    "marker": "__device__ __forceinline__ float block_reduce(",
    "ablations": {
        "copy": (
            ("      v[i][j] = prologue == kGelu ? gelu_tanh(x) : x;\n", "      v[i][j] = x;\n"),
            ("  if (p.prologue_a == kLnMod) {\n", "  if (false) {\n"),
            ("      for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(v[i][j]));\n", ""),
            ("  amax = block_reduce(amax, scratch, Max());\n", ""),
            ("        float q = rintf(__fdiv_rn(v[i][j], scale));\n"
             "        q = fminf(fmaxf(q, -127.f), 127.f);\n"
             "        const uint32_t byte = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;\n",
             "        const uint32_t byte = __float_as_uint(v[i][j]) >> 16 & 0xffu;\n"),
        ),
        "no_prologue": (
            ("      v[i][j] = prologue == kGelu ? gelu_tanh(x) : x;\n", "      v[i][j] = x;\n"),
            ("  if (p.prologue_a == kLnMod) {\n", "  if (false) {\n"),
        ),
        "multiply": (
            ("  if (threadIdx.x == 0) p.sx[row] = scale;\n",
             "  if (threadIdx.x == 0) p.sx[row] = scale;\n  const float inv = 1.f / scale;\n"),
            ("        float q = rintf(__fdiv_rn(v[i][j], scale));\n",
             "        float q = rintf(v[i][j] * inv);\n"),
        ),
        "cheap_tanh": (
            ("  return 0.5f * x * (1.0f + tanhf(inner));\n",
             "  return __fdividef(x, 1.0f + __expf(-2.0f * inner));\n"),
        ),
    },
    "entry": """
extern "C" int ablate_launch(const void* a, const void* b, const void* s, const void* t,
                             void* codes, void* sx, int m, int ka, int kb, long long lda,
                             long long ldb, int prologue, int reps, int nbuf,
                             long long a_step, long long b_step, long long c_step,
                             int, int, int, int, void* stream) {  // one block per row
  for (int r = 0; r < reps; ++r) {
    const long long i = r % nbuf;
    Params p{};
    p.a = static_cast<const __nv_bfloat16*>(a) + i * a_step;
    p.b = kb > 0 ? static_cast<const __nv_bfloat16*>(b) + i * b_step : nullptr;
    p.lda = lda;
    p.ldb = ldb;
    p.ka = ka;
    p.kb = kb;
    p.prologue_a = kb > 0 ? kNone : prologue;
    p.prologue_b = kb > 0 ? prologue : kNone;
    p.s = static_cast<const float*>(s);
    p.t = static_cast<const float*>(t);
    p.eps = 1e-6f;
    p.center = 1;
    p.inv_qmax = 1.0f / 127.0f;
    p.codes = static_cast<int8_t*>(codes) + i * c_step;
    p.sx = static_cast<float*>(sx) + i * m;
    const int rc = launch(p, m, static_cast<cudaStream_t>(stream));
    if (rc) return rc;
  }
  return 0;
}
""",
}
GELU = ("  const float p = __fmaf_rn(__fmul_rn(x, x), kGeluB, kGeluA);\n"
        "  const float e = ex2_approx(__fmul_rn(x, p));\n"
        "  return __fmul_rn(x, rcp_approx(__fadd_rn(1.0f, e)));\n")
GELU_CALL = "          for (int e = 0; e < kVec; ++e) v[j][e] = gelu(v[j][e]);\n"
LN_MOD = "\n    if (kPA == kLnMod) {\n"
TIE = "          tie |= r_lo != r_hi;\n"
# The persistent kernel: the ablations, and "one_pass" (the same kernel, a
# grid of one row per group, so no group has a next row in flight)
PERSISTENT = {
    "marker": "__global__ void __launch_bounds__(kMaxWarps * 32, kW > 0 ? 2 : 1)",
    "ablations": {
        "copy": (
            (GELU_CALL, ""), (LN_MOD, "\n    if (false) {\n"),
            ("      for (int e = 0; e < kVec; ++e) part[e & 3] = fmaxf(part[e & 3], "
             "fabsf(v[j][e]));\n", ""),
            ("          const float r_lo = __fmaf_rn(v[j][e], inv_lo, kRound);\n"
             "          const float r_hi = __fmaf_rn(v[j][e], inv_hi, kRound);\n" + TIE
             + "          bits[e] = __float_as_uint(fminf(fmaxf(r_lo, kRound - 127.f), "
             "kRound + 127.f));\n",
             "          bits[e] = __float_as_uint(v[j][e]) >> 16;\n"),
        ),
        "no_prologue": ((GELU_CALL, ""), (LN_MOD, "\n    if (false) {\n")),
        "no_guard": ((TIE, ""),),
        "tanhf": ((GELU, "  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);\n"
                         "  return 0.5f * x * (1.0f + tanhf(inner));\n"),),
    },
    "entry": """
extern "C" int ablate_launch(const void* a, const void* b, const void* s, const void* t,
                             void* codes, void* sx, int m, int ka, int kb, long long lda,
                             long long ldb, int prologue, int reps, int nbuf,
                             long long a_step, long long b_step, long long c_step,
                             int vpt, int warps_per_row, int rows_per_block, int blocks,
                             void* stream) {
  for (int r = 0; r < reps; ++r) {
    const long long i = r % nbuf;
    Params p{};
    p.a = static_cast<const __nv_bfloat16*>(a) + i * a_step;
    p.b = kb > 0 ? static_cast<const __nv_bfloat16*>(b) + i * b_step : nullptr;
    p.lda = lda;
    p.ldb = ldb;
    p.m = m;
    p.ka = ka;
    p.kb = kb;
    p.s = static_cast<const float*>(s);
    p.t = static_cast<const float*>(t);
    p.eps = 1e-6f;
    p.center = 1;
    p.inv_qmax = 1.0f / 127.0f;
    p.codes = static_cast<int8_t*>(codes) + i * c_step;
    p.sx = static_cast<float*>(sx) + i * m;
    p.warps_per_row = warps_per_row;
    p.rows_per_block = rows_per_block;
    const int rc = launch(p, kb > 0 ? kNone : prologue, kb > 0 ? prologue : kNone, vpt,
                          blocks, static_cast<cudaStream_t>(stream));
    if (rc) return rc;
  }
  return 0;
}
""",
}
GENERATIONS = {"block_per_row": BLOCK_PER_ROW, "persistent": PERSISTENT}
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])


def generation(source):
    for name, gen in GENERATIONS.items():
        if gen["marker"] in source:
            return name
    raise RuntimeError("ablate_rowquant: no known kernel generation in the source")


def build(label, src_dir):
    """{variant: ctypes library} of ``src_dir``/row_quantize.cu, one nvcc
    per variant, started together; "one_pass" of the persistent kernel is
    its full library (the wrapper's geometry with one row per group)."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    with open(os.path.join(src_dir, "row_quantize.cu")) as f:
        source = f.read()
    gen = GENERATIONS[generation(source)]
    texts = {"full": source}
    for name, edits in gen["ablations"].items():
        text = source
        for line, replacement in edits:
            if line not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {line!r}")
            text = text.replace(line, replacement)
        texts[name] = text
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"rowquant_{label}_{name}.cu")
        with open(path, "w") as f:
            f.write(text + gen["entry"])
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.abspath(src_dir),
             "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label} {name}:\n{log}")
        if name == "full":
            print(f"{label}: " + "; ".join(sorted({ln.split("info    :")[-1].strip()
                                                   for ln in log.splitlines()
                                                   if "registers" in ln or "spill" in ln})),
                  flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"rowquant_{label}_{name}.so"))
        lib.ablate_launch.argtypes = ARGTYPES
        lib.ablate_launch.restype = ctypes.c_int
        libs[name] = lib
    if gen is PERSISTENT:
        libs["one_pass"] = libs["full"]
    return libs


# Run in a subprocess with the package tree to time on sys.path first: the
# host µs per row_quantize_fused call at (256, 3072) over 1000 calls without
# a sync, the µs per call by CUDA events over the same calls (the host's
# pace where it is slower than the kernel), and, where the tree has the
# geometry function, the host µs of the wrapper's parts.
WRAPPER_TIMER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from lightdiffusion_next_tpu_torch.ops import cuda_build, quant_matmul as qm

def per_call(fn, n=1000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / n * 1e3

x = torch.randn((256, 3072), device="cuda").bfloat16()
out = {"wrapper": per_call(lambda: qm.row_quantize_fused(x))}
if hasattr(qm, "rowquant_geometry"):
    codes = torch.empty((256, 3072), dtype=torch.int8, device="cuda")
    sx = torch.empty((256, 1), dtype=torch.float32, device="cuda")
    geo = qm.rowquant_geometry(256, 3072, "none")
    fn = cuda_build.entry_point("row_quantize_fused")
    stream = torch.cuda.current_stream().cuda_stream
    out["c_entry_alone"] = per_call(lambda: fn(x.data_ptr(), None, None, codes.data_ptr(),
                                               sx.data_ptr(), 256, 3072, 3072, 0, 1, 1e-6,
                                               qm.INV_QMAX, *geo, stream))
    out["launch_rowquant"] = per_call(lambda: qm._launch_rowquant(x, "none", None, None, 1e-6))
    out["two_empty"] = per_call(lambda: (torch.empty((256, 3072), dtype=torch.int8, device="cuda"),
                                         torch.empty((256, 1), dtype=torch.float32, device="cuda")))
    out["current_stream"] = per_call(lambda: torch.cuda.current_stream(x.device).cuda_stream)
if hasattr(qm.row_quantize_fused, "__wrapped__"):
    # the backward guard's share: the wrapper and its body without the
    # guard, ten turns of each, the medians by host time
    body = qm.row_quantize_fused.__wrapped__
    turns = {"guarded": [], "body_unguarded": []}
    for _ in range(10):
        turns["guarded"].append(per_call(lambda: qm.row_quantize_fused(x)))
        turns["body_unguarded"].append(per_call(lambda: body(x)))
    out.update({k: sorted(v)[len(v) // 2] for k, v in turns.items()})
print(json.dumps(out))
"""


def wrapper_times(root):
    """{part: (host µs, µs by CUDA events)} of the wrapper of the package
    tree at ``root`` (WRAPPER_TIMER)."""
    proc = subprocess.run([sys.executable, "-c", WRAPPER_TIMER, root], capture_output=True,
                          text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sass_report():
    """Each row_quantize_kernel instantiation of the repository's build:
    its ptxas line, instruction count and opcode counts (the counts of one
    row's worth of unrolled code, not of a run)."""
    import collections

    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    rep = cuda_build.build(["row_quantize_fused"])["row_quantize.cu"]
    ptxas = chip_smoke.ptxas_functions(rep["log"])
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", rep["path"]], capture_output=True,
                          text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "row_quantize_kernel" not in name:
            continue
        ops = collections.Counter(chip_smoke.SASS_OPCODE.findall(part))
        config = name.split("row_quantize_kernel")[-1].split("EEEv")[0]
        print(f"{config}: {'; '.join(ptxas.get(name, []))}; {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common()), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", metavar="DIR",
                        help="also time DIR/row_quantize.cu (e.g. the parent's)")
    parser.add_argument("--sass", action="store_true",
                        help="only the SASS opcode counts of each instantiation")
    args = parser.parse_args()
    if args.sass:
        return sass_report()
    import torch

    if not torch.cuda.is_available():
        print("ablate_rowquant: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import cuda_build
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    print("gpu:", chip_smoke.gpu_line(), flush=True)
    sources = {"repo": str(cuda_build.CSRC)}
    if args.parent:
        sources = {"parent": os.path.abspath(args.parent), **sources}
    libs = {label: build(label, d) for label, d in sources.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    # the wrappers at (256, 3072), in turns: parent, repo, repo, parent
    roots = {"repo": REPO}
    if args.parent:
        roots["parent"] = os.path.abspath(os.path.join(args.parent, "..", ".."))
    order = ["parent", "repo", "repo", "parent"] if args.parent else ["repo", "repo"]
    results = {"wrapper_256x3072": {label: [] for label in roots}}
    for label in order:
        times = wrapper_times(roots[label])
        results["wrapper_256x3072"][label].append(times)
        print(f"row_quantize_fused (256, 3072), {label}'s wrapper: " + "; ".join(
            f"{part} host {h:.2f} us, events {e:.2f} us per call"
            for part, (h, e) in times.items()), flush=True)

    for kernel, prologue, m, ka, window, per_call in SHAPES:
        lo, hi = window or (0, 0)
        kb = hi - lo
        k = ka + kb
        per_buf = 2.0 * m * (ka + hi) + m * k
        nbuf = max(1, int(-(-3 * L2_BYTES // per_buf)))
        a = chip_smoke.activations(nbuf * m, ka, gen)
        b = chip_smoke.activations(nbuf * m, hi, gen) if kb else None
        s = 1 + 0.2 * torch.randn((1, ka), generator=gen, device="cuda")
        t = 0.1 * torch.randn((1, ka), generator=gen, device="cuda")
        codes = torch.empty((nbuf * m, k), dtype=torch.int8, device="cuda")
        sx = torch.empty((nbuf * m,), dtype=torch.float32, device="cuda")
        if kb:
            ref = qm.row_quantize_concat_gelu_plain(a[:m], b[:m], lo, hi)
        else:
            ref = qm.row_quantize_fused_plain(a[:m], s, t, prologue=prologue)

        geometry = qm.rowquant_geometry(m, k, "concat_gelu" if kb else prologue)
        one_pass = geometry[:3] + (-(-m // geometry[2]),)

        def launcher(lib, reps, geo=geometry):
            return lambda: lib.ablate_launch(
                a.data_ptr(), None if b is None else b[:, lo:].data_ptr(), s.data_ptr(),
                t.data_ptr(), codes.data_ptr(), sx.data_ptr(), m, ka, kb, ka,
                hi, PROLOGUES[prologue], reps, nbuf, m * ka, m * hi, m * k, *geo, stream)

        def timed(lib, geo=geometry):
            reps = max(nbuf, 200)
            if launcher(lib, nbuf, geo)() != 0:
                raise RuntimeError(f"launch failed at {(m, k)}")
            return chip_smoke.cuda_ms(launcher(lib, reps, geo), 3) / reps * 1e3

        bound = chip_smoke.rowquant_bound(m, k, prologue if not kb else "none")[0] * 1e3
        row = {"kernel": kernel, "prologue": prologue, "shape": [m, ka, kb],
               "calls_per_dit_call": per_call, "geometry": list(geometry), "bound_us": bound}
        for label, variants in libs.items():
            codes.zero_()
            if launcher(variants["full"], 1)() != 0:
                raise RuntimeError(f"{label} failed to launch at {(m, k)}")
            check = qm.codes_agreement(codes[:m], sx[:m].reshape(-1, 1), *ref,
                                       exact=prologue == "none")
            if not check["ok"]:
                raise RuntimeError(f"{label} disagrees at {(m, k)} {prologue}: {check}")
            for name, lib in variants.items():
                row[f"{label}_{name}"] = timed(lib, one_pass if name == "one_pass" else geometry)
        results[f"{kernel} {prologue} {m}x{k}"] = row
        print(f"{kernel} {prologue} ({m}, {ka}{f' + {kb}' if kb else ''}) " + " ".join(
            f"{key}={val:.2f}" for key, val in row.items() if isinstance(val, float)),
            flush=True)
        del a, b, s, t, codes, sx, ref
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
