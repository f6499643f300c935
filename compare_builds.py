#!/usr/bin/env python3
"""K4, the W8A8 matmuls and their flag variants: this tree's kernels beside
another tree's, on the card, in one process.

    python3 compare_builds.py --parent DIR [--out build/compare_builds.json]
    python3 compare_builds.py --parent DIR --w8a8-table   # the int8 table alone
    python3 compare_builds.py --parent DIR --w8a8-host    # host us a W8A8 call

DIR is a checkout of another commit (e.g. ``git archive <commit> | tar -x
-C scratch_chip/parent``); its ``ops/cuda_build.py`` builds its own sources
into DIR/build/kernels with its own C signatures, beside this tree's build.
At chip_smoke.py phase 25's shapes, on the same seeded inputs:

- K4 (``int8_mxu``, ``pv_int8`` both on): the two preparations' images,
  svs and vmu byte for byte, and the two K4 kernels' outputs on the same
  images bit for bit;
- K7, K8 and the stacked K11 with its residual (int8): the two kernels'
  outputs on the same operands bit for bit;
- each of them timed kernel alone in turns (other, this, this, other:
  CUDA events over repeats of about 100 ms each), with the spread of the
  two turns of each tree;
- the flag variants (K4's three and the bf16-rate K7/K8/K11), each tree's
  kernel on its own tree's preparation, timed the same way; their outputs
  against each other (K4's int8_mxu=False and the bf16-rate W8A8 are equal
  bit for bit in both trees; the pv_int8=False P.V sums in another order);
- the int8 W8A8 table (``chip_smoke.W8A8_TABLE``: every main-path shape of
  the Flux W8A8 path with its epilogue, a TP rank's, a ragged M): each
  tree's K11 entry point, called directly, with the tile its own
  ``w8a8_tile`` picks (``other_tile`` reads DIR's), bit for bit against
  each other, in turns, beside ``torch._int_mm`` on the same codes (no
  epilogue) and the bound.

``--w8a8-host`` times the host's side of a W8A8 call instead: each tree's
stacked K11 entry point at a text-stream shape (the device's work per call
shorter than the host's), blocks of calls in turns, and this tree's whole
wrapper (``w8a8_matmul_ep`` on a stack) beside them.

Prints one line per kernel and shape and writes the records as JSON. Needs
one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SAGE_SHAPES = ((8, 8, 4096, 40), (2, 8, 4096, 80), (2, 8, 1024, 160), (1, 24, 4352, 128),
               (2, 8, 1000, 80))
W8A8_SHAPES = (("k7", 4352, 3072, 3072), ("k7", 4352, 3072, 12288), ("k7", 4352, 12288, 3072),
               ("k7", 4352, 3072, 9216), ("k8", 256, 12288, 3072),
               ("k11_stacked", 256, 12288, 3072))
SAGE_FLAGS = ((False, True), (True, False), (False, False))  # the variants' (int8_mxu, pv_int8)


def load_build(tree):
    """``tree``'s ops/cuda_build.py as a module of its own (stdlib only)."""
    path = os.path.join(tree, "lightdiffusion_next_tpu_torch", "ops", "cuda_build.py")
    spec = importlib.util.spec_from_file_location(f"cuda_build_{abs(hash(tree))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_tile(tree, m, n, k):
    """The tile id ``tree``'s ``quant_matmul.w8a8_tile`` picks for (M, K,
    N): the function's source run alone (its module imports torch and the
    package, which the other tree's would shadow)."""
    import ast

    path = os.path.join(tree, "lightdiffusion_next_tpu_torch", "ops", "quant_matmul.py")
    with open(path) as f:
        mod = ast.parse(f.read())
    fn = next(node for node in mod.body
              if isinstance(node, ast.FunctionDef) and node.name == "w8a8_tile")
    space = {"SMS": 132}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), space)
    return space["w8a8_tile"](m, n, k)


def ms_of(fn, budget_ms=100.0):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def in_turns(other, this):
    """Kernel-alone ms in turns other, this, this, other."""
    o1, t1, t2, o2 = ms_of(other), ms_of(this), ms_of(this), ms_of(other)
    return {"other_ms": [o1, o2], "this_ms": [t1, t2],
            "this_over_other": (t1 + t2) / (o1 + o2)}


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel returned {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout of the other tree")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "compare_builds.json"))
    ap.add_argument("--w8a8-table", action="store_true",
                    help="only the int8 W8A8 table (chip_smoke.W8A8_TABLE)")
    ap.add_argument("--w8a8-host", action="store_true",
                    help="only the host's microseconds a W8A8 call")
    args = ap.parse_args()

    import torch

    import chip_smoke

    from lightdiffusion_next_tpu_torch.ops import cuda_build
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
    from lightdiffusion_next_tpu_torch.ops import sage_attention as sa

    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print("gpu:", gpu)
    other = load_build(os.path.abspath(args.parent))
    names = ["sage_attention", "sage_prepare", "sage_attention_variant", "w8a8_matmul",
             "w8a8_matmul_stacked", "w8a8_matmul_ep_stacked", "w8a8_matmul_bf16"]
    if args.w8a8_table or args.w8a8_host:
        names = ["w8a8_matmul"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(cuda_build.build, names), pool.submit(other.build, names)]:
            f.result()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(21)
    records = {"gpu": gpu, "sage": [], "w8a8": [], "w8a8_table": []}
    ok = True
    parent = os.path.abspath(args.parent)

    if args.w8a8_host:
        records["w8a8_host"] = w8a8_host(other, parent, gen, stream())
        return finish(records, ok, args.out)
    for m, k, n, ep in chip_smoke.W8A8_TABLE:
        ok = w8a8_row(records, other, parent, gen, stream, m, k, n, ep) and ok
    if args.w8a8_table:
        return finish(records, ok, args.out)

    for shape in SAGE_SHAPES:
        b, h, lq, d = shape
        lk = lq
        q, k, v = (torch.randn((b, lq, h, d), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for _ in range(3))
        bn = sa.geometry(d)[2]

        def prepare(fn, pv_int8, *flags):
            """The other tree's preparation (int8 Q and K: its only layout)."""
            qt, kt = sa.q_images(lq), -(-lk // bn)
            qimg = torch.empty((b * h, qt, sa.q_image_bytes(d)), dtype=torch.uint8, device="cuda")
            kvimg = torch.empty((b * h, kt, sa.kv_image_bytes(d, pv_int8)), dtype=torch.uint8,
                                device="cuda")
            svs, vmu = (torch.empty((b * h, d), device="cuda") for _ in range(2))
            part = torch.empty((b * h, sa.STAT_SPLITS, 4, d), device="cuda")
            check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qimg.data_ptr(), kvimg.data_ptr(),
                     svs.data_ptr(), vmu.data_ptr(), part.data_ptr(), b, h, lq, lk, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], qt, kt,
                     1.0 / math.sqrt(d), *flags, stream()), "prepare")
            return sa.Operands(qimg, kvimg, svs, vmu, lk, True, pv_int8)

        def launch(fn, ops, *flags):
            out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device="cuda")
            kt = ops.kvimg.shape[1]
            check(fn(ops.qimg.data_ptr(), ops.kvimg.data_ptr(), ops.svs.data_ptr(),
                     ops.vmu.data_ptr(), out.data_ptr(), b, h, lq, lk, d, out.stride(0),
                     out.stride(2), out.stride(1), ops.qimg.shape[1], kt, kt,
                     sa.softmax_block(lk) // bn, 1, *flags, stream()), "attention")
            return out

        # K4: this tree's preparation (int8_mxu, pv_int8 on) against the other's
        this_ops = sa.prepare_kernel(q, k, v)
        other_ops = prepare(other.entry_point("sage_prepare"), True, 1)
        same_images = all(torch.equal(a_, b_) for a_, b_ in zip(this_ops[:4], other_ops[:4]))
        k4_this = lambda: launch(cuda_build.entry_point("sage_attention"), this_ops)  # noqa: E731
        k4_other = lambda: launch(other.entry_point("sage_attention"), this_ops)  # noqa: E731
        same_out = torch.equal(k4_this(), k4_other())
        rec = {"kernel": "K4", "shape": list(shape), "images_bit_for_bit": same_images,
               "output_bit_for_bit": same_out, **in_turns(k4_other, k4_this)}
        ok = ok and same_images and same_out
        records["sage"].append(rec)
        print(json.dumps(rec))
        # the variants: each tree's kernel on its own tree's preparation
        for int8_mxu, pv_int8 in SAGE_FLAGS:
            this_var = sa.prepare_kernel(q, k, v, pv_int8=pv_int8, int8_mxu=int8_mxu)
            other_var = prepare(other.entry_point("sage_prepare"), pv_int8, int(pv_int8))
            run_this = lambda: sa._launch_variant(q, this_var, int8_mxu, pv_int8)  # noqa: E731
            run_other = lambda: launch(other.entry_point("sage_attention_variant"),  # noqa: E731
                                       other_var, int(int8_mxu), int(pv_int8))
            a_, b_ = run_this().contiguous(), run_other().permute(0, 2, 1, 3).contiguous()
            rec = {"kernel": f"sage int8_mxu={int8_mxu} pv_int8={pv_int8}", "shape": list(shape),
                   "output_bit_for_bit": bool(torch.equal(a_, b_)),
                   "max_abs_diff": (a_.float() - b_.float()).abs().max().item(),
                   **in_turns(run_other, run_this)}
            records["sage"].append(rec)
            print(json.dumps(rec))
        del q, k, v, this_ops, other_ops
        torch.cuda.empty_cache()

    for kind, m, k, n in W8A8_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        xq, sx = qm.row_quantize_fused(x)
        sx = sx.reshape(-1)
        depth = 1 if kind == "k7" else 2
        q3 = torch.randint(-127, 128, (depth, n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        cs = (0.5 + torch.rand((depth, 1, n), generator=gen, device="cuda")) * (3 / (127 * k**0.5))
        idx = depth - 1
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        res = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
        cs_blk = cs[idx].reshape(-1).contiguous()
        tile = other_tile(parent, m, n, k)

        def int8_this():
            if kind == "k7":
                return qm._launch_w8a8(xq, sx, q3[0], cs_blk)
            if kind == "k8":
                return qm._launch_w8a8(xq, sx, q3, cs, idx=idx)
            return qm._launch_w8a8(xq, sx, q3, cs_blk, bias, res, ep=True, idx=idx)

        def int8_other():
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            if kind == "k7":
                rc = other.entry_point("w8a8_matmul")(
                    xq.data_ptr(), sx.data_ptr(), q3.data_ptr(), cs_blk.data_ptr(),
                    out.data_ptr(), m, n, k, k, k, tile, stream())
            elif kind == "k8":
                rc = other.entry_point("w8a8_matmul_stacked")(
                    xq.data_ptr(), sx.data_ptr(), q3.data_ptr(), cs.data_ptr(), out.data_ptr(),
                    m, n, k, k, k, tile, depth, idx, stream())
            else:
                rc = other.entry_point("w8a8_matmul_ep_stacked")(
                    xq.data_ptr(), sx.data_ptr(), q3.data_ptr(), cs_blk.data_ptr(),
                    bias.data_ptr(), res.data_ptr(), out.data_ptr(), m, n, k, k, k, n, tile,
                    depth, idx, stream())
            check(rc, "w8a8")
            return out

        def bf16_this():
            if kind == "k7":
                return qm._launch_w8a8(xq, sx, q3[0], cs_blk, int8_mxu=False)
            if kind == "k8":
                return qm._launch_w8a8(xq, sx, q3, cs, idx=idx, int8_mxu=False)
            return qm._launch_w8a8(xq, sx, q3, cs_blk, bias, res, ep=True, idx=idx,
                                   int8_mxu=False)

        def bf16_other():
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            ep = kind == "k11_stacked"
            cs_ptr = cs_blk.data_ptr() if ep or kind == "k7" else cs.data_ptr() + 4 * idx * n
            check(other.entry_point("w8a8_matmul_bf16")(
                xq.data_ptr(), sx.data_ptr(), q3.data_ptr(), cs_ptr,
                bias.data_ptr() if ep else None, res.data_ptr() if ep else None,
                out.data_ptr(), m, n, k, k, k, n if ep else 0, depth, idx if kind != "k7" else 0,
                stream()), "w8a8 bf16")
            return out

        same = torch.equal(int8_this(), int8_other())
        rec = {"kernel": f"{kind} int8", "shape": [m, k, n], "tile": qm.w8a8_tile(m, n, k),
               "other_tile": tile,
               "output_bit_for_bit": same, **in_turns(int8_other, int8_this)}
        ok = ok and same
        records["w8a8"].append(rec)
        print(json.dumps(rec))
        a_, b_ = bf16_this(), bf16_other()
        rec = {"kernel": f"{kind} bf16 rate", "shape": [m, k, n],
               "tile": qm.W8A8_BF16_TILES[qm.w8a8_bf16_tile(m, n, k)],
               "output_bit_for_bit": bool(torch.equal(a_, b_)),
               "max_abs_diff": (a_.float() - b_.float()).abs().max().item(),
               **in_turns(bf16_other, bf16_this)}
        records["w8a8"].append(rec)
        print(json.dumps(rec))
        del x, xq, q3, res
        torch.cuda.empty_cache()

    return finish(records, ok, args.out)


def w8a8_host(other, parent, gen, stream, m=256, k=3072, n=3072, calls=200, turns=5):
    """Host microseconds a call of the stacked K11 with its residual at (M,
    K, N) on block 7 of a stack of 19: each tree's entry point (the tile its
    own ``w8a8_tile`` picks) in blocks of ``calls`` calls, in turns other,
    this, this, other, ``turns`` times, the queue drained between blocks;
    this tree's wrapper the same way. Medians and every block's mean."""
    import statistics
    import time

    import torch

    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import cuda_build
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    q3 = torch.randint(-127, 128, (19, n, k), generator=gen, device="cuda", dtype=torch.int8)
    xq, sx = qm.row_quantize_fused(chip_smoke.activations(m, k, gen))
    cs = torch.rand((n,), generator=gen, device="cuda") / 1000
    bias = torch.randn((n,), generator=gen, device="cuda")
    res = chip_smoke.activations(m, n, gen)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

    def entry(build, tile):
        fn = build.entry_point("w8a8_matmul_ep_stacked")
        args = (xq.data_ptr(), sx.data_ptr(), q3.data_ptr(), cs.data_ptr(), bias.data_ptr(),
                res.data_ptr(), out.data_ptr(), m, n, k, k, k, n, tile, 19, 7, stream)
        return lambda: check(fn(*args), "w8a8 host")

    fns = {"other": entry(other, other_tile(parent, m, n, k)),
           "this": entry(cuda_build, qm.w8a8_tile(m, n, k)),
           "this_wrapper": lambda: qm.w8a8_matmul_ep(xq, sx, (q3, 7), cs, bias, residual=res)}
    us = {name: [] for name in fns}

    def block(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        us[name].append((time.perf_counter() - t0) / calls * 1e6)

    for name in fns:  # warm: every map encoded, every kernel loaded
        block(name)
        us[name].clear()
    for _ in range(turns):
        for name in ("other", "this", "this_wrapper", "this_wrapper", "this", "other"):
            block(name)
    torch.cuda.synchronize()
    rec = {"shape": [m, k, n], "calls_a_block": calls,
           **{f"{name}_us_median": statistics.median(v) for name, v in us.items()},
           **{f"{name}_us": v for name, v in us.items()}}
    print(json.dumps(rec))
    return rec


def w8a8_row(records, other, parent, gen, stream, m, k, n, ep):
    """One shape of chip_smoke.W8A8_TABLE: both trees' K11 (``ep`` "bias" or
    "residual") bit for bit and in turns, ``torch._int_mm``, the bound.
    Returns whether the outputs agree."""
    import torch

    import chip_smoke
    from lightdiffusion_next_tpu_torch.ops import cuda_build
    from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

    xq, sx = qm.row_quantize_fused(chip_smoke.activations(m, k, gen))
    sx = sx.reshape(-1)
    q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    cs = (0.5 + torch.rand((n,), generator=gen, device="cuda")) * (3 / (127 * k**0.5))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    res = chip_smoke.activations(m, n, gen) if ep == "residual" else None
    tile = other_tile(parent, m, n, k)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

    mine = torch.empty_like(out)

    def launch(build, tile_id, dst):
        check(build.entry_point("w8a8_matmul_ep")(
            xq.data_ptr(), sx.data_ptr(), q.data_ptr(), cs.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), dst.data_ptr(), m, n, k, k, k,
            0 if res is None else n, tile_id, stream()), "w8a8")
        return dst

    this = lambda: launch(cuda_build, qm.w8a8_tile(m, n, k), mine)  # noqa: E731
    theirs = lambda: launch(other, tile, out)  # noqa: E731
    same = torch.equal(this(), theirs())
    rec = {"kernel": f"k11 {ep}", "shape": [m, k, n], "tile": qm.w8a8_tile(m, n, k),
           "other_tile": tile, "output_bit_for_bit": same, **in_turns(theirs, this),
           "int_mm_ms": ms_of(lambda: torch._int_mm(xq, q.t())),
           "bound_ms": chip_smoke.int8_bound(m, k, n, True, res is not None)[0]}
    records["w8a8_table"].append(rec)
    print(json.dumps(rec))
    del xq, sx, q, res, out, mine
    torch.cuda.empty_cache()
    return same


def finish(records, ok, out):
    records["ok"] = ok
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    print("compare_builds:", "ok" if ok else "FAILED: K4 or an int8 W8A8 kernel moved")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
