// The online softmax of a wgmma attention tile, shared by K3
// (fused_qkv_attention.cu) and K1/K2 (flash_attention.cuh): the m64nN f32
// accumulator fragment of S masked, exponentiated in base 2 against running
// row maxima, and rounded to bf16 as the register-A fragment of P.V.
#pragma once

#include "hopper.cuh"

namespace hopper {

constexpr float kNegInf = -1e30f;  // masked logits

// hi = bf16(x), lo = bf16(x - hi) for a pair
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator fragment of m64nN: warp w of the warpgroup holds rows 16w +
// g and 16w + g + 8 (g = lane / 4); per 8 columns j, x[4j], x[4j+1] are row
// g's columns 8j + 2 (lane % 4) + {0, 1} and x[4j+2], x[4j+3] row g + 8's.

template <int BN>
__device__ __forceinline__ void mask_tail(float (&s)[BN / 2], int k0, int lk) {
  const int c0 = k0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + j * 8;
    if (col >= lk) s[4 * j] = s[4 * j + 2] = kNegInf;
    if (col + 1 >= lk) s[4 * j + 1] = s[4 * j + 3] = kNegInf;
  }
}

// The online softmax (base 2) of one tile: new running maxima over the
// quad's rows, p = exp2(s - m) in place, and per row the factor exp2(m_old -
// m) and the tile's partial row sum
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m_i)[2],
                                             float (&alpha)[2], float (&rsum)[2]) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(m_i[r] - mx[r]);
    m_i[r] = mx[r];
  }
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = fast_exp2(s[4 * j] - mx[0]);
    s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mx[0]);
    s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mx[1]);
    s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mx[1]);
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  rsum[0] = rs0;
  rsum[1] = rs1;
}

// o and the per-thread sums l (reduced at the end) rescaled to the new maxima
template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], float (&l_i)[2], const float (&alpha)[2],
                                        const float (&rsum)[2]) {
  l_i[0] = l_i[0] * alpha[0] + rsum[0];
  l_i[1] = l_i[1] * alpha[1] + rsum[1];
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

// p rounded to bf16: the s fragments of two adjacent 8-column groups are the
// register-A fragment of one k16 step of 16 kv rows; SPLIT also writes the
// lo halves
template <int BN, bool SPLIT>
__device__ __forceinline__ void pack_p(uint32_t (&hi)[BN / 16][4], uint32_t (&lo)[BN / 16][4],
                                       const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (SPLIT) {
        split_pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
      } else {
        hi[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }
    fence_operands(hi[kk]);
    if constexpr (SPLIT) fence_operands(lo[kk]);
  }
}

template <int KK>
__device__ __forceinline__ void fence_p(uint32_t (&pf)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) fence_operands(pf[kk]);
}

}  // namespace hopper
