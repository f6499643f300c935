#!/usr/bin/env python3
"""Write ``wgmma_forms.cuh``: the ``wgmma`` instructions the kernels issue.

    python3 lightdiffusion_next_tpu_torch/csrc/wgmma_forms.py

Each form is one inline-PTX ``wgmma.mma_async`` whose accumulator list has
N / 2 registers, so every N is its own asm string. They are generated here
from ``FORMS`` and not written by hand; ``tests/test_torch_flash_layout.py``
checks that the committed header is this script's output.

Forms (M = 64 rows, f32 accumulators for bf16, s32 for s8):
- ``wgmma<N, TNSP_B>(d, a_desc, b_desc, scale_d)``: bf16, A and B in
  shared memory (A K-major; B K-major for TNSP_B = 0, N-major for 1);
- ``wgmma_rs<N, TNSP_B>(d, a, b_desc, scale_d)``: bf16, A in registers
  (``a[0..3]``: mma.sync m16n8k16's A fragment of the warp's 16 rows);
- ``wgmma_s8<N>(d, a_desc, b_desc, scale_d)``: s8, both K-major in shared
  memory, k32;
- ``wgmma_rs_s8<N>(d, a, b_desc, scale_d)``: s8, A in registers.
``scale_d = 0`` overwrites d instead of adding to it.
"""

from __future__ import annotations

import os
import sys

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wgmma_forms.cuh")

# (kind, N, TNSP_B) of every form a kernel issues
FORMS = (
    [("ss", n, 0) for n in (16, 64, 128, 256)]
    + [("ss", n, 1) for n in (64, 128)]
    + [("rs", n, 0) for n in (32, 40, 64, 80, 96, 128, 160)]
    + [("rs", n, 1) for n in (64, 128, 256)]
    + [("ss_s8", n, 0) for n in (64, 128, 256)]
    + [("rs_s8", n, 0) for n in (32, 48, 64, 80, 128, 160)]
)

PRIMARY = """\
// d (64 x N, f32) = A (64 x 16, shared, K-major) * B (16 x N, shared;
// TNSP_B = 0: K-major, 1: N-major) + (scale_d ? d : 0)
template <int N, int TNSP_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b,
                                      int scale_d = 1);

// d (64 x N, f32) = A (64 x 16, bf16 in registers) * B (16 x N, shared;
// TNSP_B as above) + (scale_d ? d : 0)
template <int N, int TNSP_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d = 1);

// d (64 x N, s32) = A (64 x 32, s8, shared) * B (32 x N, s8, shared), both
// K-major, + (scale_d ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d);

// d (64 x N, s32) = A (64 x 32, s8 in registers: mma.sync m16n8k32's A
// fragment) * B (32 x N, s8, shared, K-major) + (scale_d ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma_rs_s8(uint32_t (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d);
"""


def _numbers(first, count, per_line=16):
    """'%first, ..., %(first+count-1)' as C string-literal lines."""
    ops = [f"%{i}" for i in range(first, first + count)]
    lines = [", ".join(ops[i:i + per_line]) for i in range(0, count, per_line)]
    return [f'      "{ln}{", " if i + 1 < len(lines) else ""}"' for i, ln in enumerate(lines)]


def form(kind, n, tnsp):
    """The C++ specialization of one form."""
    r = n // 2
    s8 = kind.endswith("s8")
    rs = kind.startswith("rs")
    acc_t, cons = ("uint32_t", "+r") if s8 else ("float", "+f")
    ptx_type = f"m64n{n}k32.s32.s8.s8" if s8 else f"m64n{n}k16.f32.bf16.bf16"
    name = {"ss": "wgmma", "rs": "wgmma_rs", "ss_s8": "wgmma_s8", "rs_s8": "wgmma_rs_s8"}[kind]
    targs = f"{n}" if s8 else f"{n}, {tnsp}"
    a_param = "const uint32_t (&a)[4]" if rs else "uint64_t a"
    if rs:
        a_ops = f"{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}"
        ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)'
        scale_op = r + 5
    else:
        a_ops = f"%{r}, %{r + 1}"
        ins = '"l"(a), "l"(b), "r"(scale_d)'
        scale_op = r + 2
    if s8:
        tail = "p"
    elif rs:
        tail = f"p, 1, 1, {tnsp}"
    else:
        tail = f"p, 1, 1, 0, {tnsp}"
    accs = [f'"{cons}"(d[{i}])' for i in range(r)]
    acc_lines = [", ".join(accs[i:i + 4]) for i in range(0, r, 4)]
    out = [
        "template <>",
        f"__device__ __forceinline__ void {name}<{targs}>({acc_t} (&d)[{r}], {a_param},",
        f"    uint64_t b, int scale_d) {{",
        "  asm volatile(",
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale_op}, 0;\\n"',
        f'      "wgmma.mma_async.sync.aligned.{ptx_type} {{"',
        *_numbers(0, r),
        f'      "}}, {a_ops}, {tail};\\n}}\\n"',
        "      : " + (",\n        ".join(acc_lines)),
        f"      : {ins});",
        "}",
    ]
    return "\n".join(out)


def header():
    parts = [
        "// The wgmma instructions of the port's kernels, one specialization per",
        "// (form, N). Generated by wgmma_forms.py in this directory; do not edit,",
        "// change its FORMS and run it again.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace hopper {",
        "",
        PRIMARY,
    ]
    for kind, n, tnsp in FORMS:
        parts.append(form(kind, n, tnsp))
        parts.append("")
    parts.append("}  // namespace hopper")
    return "\n".join(parts) + "\n"


def main() -> int:
    with open(HEADER, "w") as f:
        f.write(header())
    print(f"wrote {HEADER}: {len(FORMS)} forms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
