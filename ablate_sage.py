#!/usr/bin/env python3
"""What bounds K4 (``csrc/sage_attention.cu``) on one NVIDIA GPU.

    python3 ablate_sage.py

Builds variants of the kernel from its source text, each into its own
library under ``build/ablate/`` (git-ignored), and times K4 alone on the
operands of one preparation at the SD1.5 sage path's largest shapes, beside
the preparation kernel alone, the whole wrapper,
``scaled_dot_product_attention`` on the same bf16 q, k, v (the library
yardstick) and the bound:

- the full kernel, checked against the plain version before it is timed;
- ablations (timing only: their outputs are wrong): no pass 0 (the block's
  maxima are not taken and its K tiles are copied once), no exp (p = s -
  m), no P.V (its products are not issued), and no copies (the producer
  arms each stage without copying), and the products alone (no scalar work
  in either pass: the products, copies and barriers). An ablation's time
  is what the remaining work costs by itself.

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
SHAPES = ((2, 8, 16384, 40), (8, 8, 4096, 40), (2, 8, 4096, 80))  # (B, H, L, d)
# source lines an ablation replaces
PASS0_LOOP = ("    float mb[2] = {kNegInf, kNegInf};\n"
              "    for (int i = 0; i < nt; ++i, ++st) {\n")
PRODUCER_PASSES = "        for (int pass = 0; pass < 2; ++pass) {\n"
TURNS = "  Turns turns{2 * p.kv_tiles + n_blocks};\n"
EXP = "    const float pr = fast_exp2(__fsub_rn(__uint_as_float(s[i]), m[r]));\n"
PV_LOOP = "      pv_issue<D>(pv, pf, stage_of(st - 1) + C::Pass0Bytes);\n"
PV_LAST = "    pv_issue<D>(pv, pf, stage_of(st - 1) + C::Pass0Bytes);\n"  # after PV_LOOP's
COPY = ("            mbar_expect_tx(full + 8 * stage, bytes);\n"
        "            bulk_copy(kv_base + stage * C::Stage, src + static_cast<long long>(t0 + i)"
        " * C::Img,\n"
        "                      bytes, full + 8 * stage);\n")
# the scalar work of both passes (scores, maxima, p, codes); the 6-space
# lines go first, since the 4-space ones of the peeled tile end them
SCALAR = ("      scores<D>(s, sk_of(st), sq0, sq1, (t0 + i) * C::BN, p);\n",
          "    scores<D>(s, sk_of(st), sq0, sq1, t0 * C::BN, p);\n",
          "      row_max<D>(s, mb);\n",
          "      softmax_codes<D>(s, m_r, lsum);\n", "    softmax_codes<D>(s, m_r, lsum);\n",
          "      pack_p<D>(pf, s);\n", "    pack_p<D>(pf, s);\n")
ABLATIONS = {
    "no_pass0": ((PASS0_LOOP, PASS0_LOOP.replace("int i = 0;", "int i = nt;")),
                 (PRODUCER_PASSES, PRODUCER_PASSES.replace("pass = 0;", "pass = 1;")),
                 (TURNS, TURNS.replace("2 * p.kv_tiles", "p.kv_tiles"))),
    "no_exp": ((EXP, EXP.replace("fast_exp2(", "(")),),
    "no_pv": ((PV_LOOP, ""), (PV_LAST, "")),
    "no_copies": ((COPY, "            mbar_arrive(full + 8 * stage);\n"),),
    "products_only": tuple((line, "") for line in SCALAR),
}


def build_all(source):
    """{variant: ctypes library}; one nvcc per variant, started together."""
    from lightdiffusion_next_tpu_torch.ops import cuda_build

    os.makedirs(OUT, exist_ok=True)
    texts = {"full": source}
    for name, edits in ABLATIONS.items():
        text = source
        for line, replacement in edits:
            if line not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {line!r}")
            text = text.replace(line, replacement)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"sage_{name}.cu")
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
        lib = ctypes.CDLL(os.path.join(OUT, f"sage_{name}.so"))
        for entry in ("sage_attention", "sage_prepare"):
            fn = getattr(lib, cuda_build.KERNELS[entry][1])
            fn.argtypes = cuda_build.KERNELS[entry][2]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablate_sage: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    print("gpu:", chip_smoke.gpu_line(), flush=True)
    with open(os.path.join(REPO, "lightdiffusion_next_tpu_torch", "csrc",
                           "sage_attention.cu")) as f:
        libs = build_all(f.read())
    gen = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for b, h, l, d in SHAPES:
        q, k, v = chip_smoke.make_inputs(b, h, l, d, "bf16", gen)
        ops = sa.prepare_kernel(q, k, v)
        bn = sa.geometry(d)[2]
        qt, kt = ops.qimg.shape[1], ops.kvimg.shape[1]
        out = torch.empty((b, l, h, d), dtype=torch.bfloat16, device="cuda")
        args = (ops.qimg.data_ptr(), ops.kvimg.data_ptr(), ops.svs.data_ptr(),
                ops.vmu.data_ptr(), out.data_ptr(), b, h, l, l, d, out.stride(0),
                out.stride(2), out.stride(1), qt, kt, kt, sa.softmax_block(l) // bn, 1, stream)

        def launcher(lib):
            return lambda: lib.ldt_sage_attention_fwd(*args)

        def timed(fn):
            return chip_smoke.cuda_ms(fn, chip_smoke.repeats_for(fn, 300.0))

        if launcher(libs["full"])() != 0:
            raise RuntimeError(f"K4 failed to launch at {(b, h, l, d)}")
        check = sa.prep_agreement(ops, sa.prepare_plain(q, k, v), d)
        kcheck = fa.agreement(out.permute(0, 2, 1, 3), sa.sage_attention_plain(q, k, v),
                              max_ulps=sa.MAX_ULPS, rel_rmse_limit=sa.REL_RMSE_LIMIT)
        if not (check["ok"] and kcheck["ok"]):
            raise RuntimeError(f"disagrees at {(b, h, l, d)}: {check} {kcheck}")
        row = {"full": timed(launcher(libs["full"]))}
        for name in ABLATIONS:
            row[name] = timed(launcher(libs[name]))
        row["full_again"] = timed(launcher(libs["full"]))
        row["prepare"] = timed(lambda: sa.prepare_kernel(q, k, v))
        row["wrapper"] = timed(lambda: sa.sage_attention(q, k, v))
        row["library"] = timed(lambda: F.scaled_dot_product_attention(q, k, v))
        row["bound"] = chip_smoke.sage_bound(b, h, l, l, d)[0]
        row["prepare_bound"] = chip_smoke.prepare_bound(b, h, l, l, d)[0]
        results[f"{b}x{h}x{l}x{d}"] = row
        print(f"({b}, {h}, {l}, {d}) " + " ".join(f"{a}={c:.4f}" for a, c in row.items()),
              flush=True)
        del q, k, v, ops, out
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
