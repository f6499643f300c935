// mma.sync building blocks of the bf16-rate variants (w8a8_matmul_bf16.cu,
// sage_attention_variants.cu): the warp-level products and the exact int8 ->
// bf16 conversion of their operands.
//
// Fragments of m16n8k16 (bf16, f32 accumulators) for lane = 4 g + t:
//   A (16 x 16, row-major): a[0] row g, k 2t, 2t+1; a[1] row g+8, the same k;
//                           a[2] row g, k 2t+8, 2t+9; a[3] row g+8, the same
//   B (16 x 8, k-major):    b0 k 2t, 2t+1 of column g; b1 k 2t+8, 2t+9
//   C (16 x 8):             c[0], c[1] row g, columns 2t, 2t+1; c[2], c[3] row g+8
// and of m16n8k32 (s8, s32 accumulators): a[0] row g, k 4t..4t+3; a[1] row
// g+8; a[2] row g, k 16+4t..; a[3] row g+8; b0 k 4t..4t+3 of column g, b1 k
// 16+4t..; C as above.
//
// Four int8 codes read with one 4-byte load at k offsets 4t..4t+3 become the
// bf16 pairs of logical k (2t, 2t+1) and (2t+8, 2t+9): a permutation of the
// 16 k of a step, taken by both operands alike, so the product is the same.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mmasync {

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k32, s8 operands, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 codes (bytes 0..3 of x) as two bf16 pairs, exactly: byte b as
// the f32 whose bits are 0x4B000000 | (b ^ 0x80), 2^23 + 128 + b, less
// 2^23 + 128; a small integer's f32 truncates to its bf16 exactly, so the
// pair is the two floats' upper halves. lo holds bytes 0, 1; hi bytes 2, 3.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Sixteen int8 codes (a 16-byte chunk) as eight bf16 pairs, in order
__device__ __forceinline__ void s8x16_to_bf16(const uint4& x, uint32_t (&o)[8]) {
  s8x4_to_bf16(x.x, o[0], o[1]);
  s8x4_to_bf16(x.y, o[2], o[3]);
  s8x4_to_bf16(x.z, o[4], o[5]);
  s8x4_to_bf16(x.w, o[6], o[7]);
}

}  // namespace mmasync
