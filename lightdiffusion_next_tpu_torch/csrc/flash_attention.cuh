// Exact non-causal flash attention for Hopper (sm_90a), shared by the entry
// points in flash_attention.cu and packed_flash_attention.cu.
//
// What it computes (the same function as the Pallas kernels of
// lightdiffusion_next_tpu/ops/flash_attention.py):
//   q is pre-scaled by LOG2E/sqrt(d) in f32 and rounded to the input dtype;
//   s = q k^T with f32 accumulation, already in the base-2 domain;
//   padded kv columns (ragged Lk) are set to -1e30;
//   online softmax with exp2, f32 running max m, sum l and accumulator;
//   p is rounded to the input dtype for the p v product, f32 accumulation;
//   o = acc / l, rounded to the output dtype.
//
// Design: one block of 4 warps per (q tile of 64 rows, batch*head, output
// column slice). Each warp owns 16 q rows. A loop inside the block walks the
// kv tiles of BN rows: K and V are copied into shared memory with cp.async
// (every thread's 16-byte copies in flight at once, none through registers),
// QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), and the softmax state lives in registers. The L x L logits
// never leave registers. The head dim is padded to a multiple of 16 (the mma
// k-step) inside shared memory only: the pad lanes are zero-filled there,
// device memory is read at the real width.
//
// f32 inputs (the VAE's attention) keep f32 products, as the JAX kernel
// computes them, on the bf16 tensor cores: each f32 operand x is split into
// hi = bf16(x) and lo = bf16(x - hi) (split-bf16, about 16 mantissa bits)
// and each product is taken as three mma on the same fragments: hi*hi +
// hi*lo + lo*hi. q is split while its tile is staged (after the f32
// pre-scale); k and v are split once per call into a scratch buffer of four
// bf16 arrays by split_kernel; p stays f32 until it is split in registers
// right before the p v product. Softmax state and both accumulations stay
// f32. The split tiles double the shared memory, so at d > 256 a kv tile
// holds 32 rows instead of 64.
//
// Inputs are read through (batch, head, row) strides with a unit stride
// along d, so the UNet's q|k|v views of its fused projection need no copy;
// the output is written in the folded (B, L, H, D) layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ldt {

constexpr int kBlockM = 64;   // q rows per block: 4 warps x 16 rows
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemPad = 8;   // bf16 elements (16 bytes) of row padding:
                              // keeps ldmatrix rows on distinct banks
constexpr float kNegInf = -1e30f;
constexpr int kErrUnsupported = 1000;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* k_lo;  // f32 inputs: the lo halves of the split k and v
  const void* v_lo;  //   (same strides as k and v)
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int heads, lq, lk, d;
  float q_scale;
  int vec;  // 1: base pointers and row strides are 16-byte aligned
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi) for a pair, packed as two mma operands
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage ROWS x COLS elements of a row-major global tile (row stride g_sl,
// unit column stride) into bf16 shared memory with leading dimension ld.
// Rows >= rows_valid and columns >= cols_valid are zero-filled. SCALE
// multiplies in f32 before the rounding to bf16 (the q pre-scale). SPLIT
// (f32 input) writes hi = bf16(x) to smem and lo = bf16(x - hi) to smem_lo.
// Aligned bf16 chunks that need no arithmetic go through cp.async: the
// caller waits with cp_async_wait_all before the tile is read.
template <typename T, int ROWS, int COLS, bool SCALE, bool SPLIT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ smem,
                                          __nv_bfloat16* __restrict__ smem_lo,
                                          int ld, const T* __restrict__ g,
                                          long long g_sl, int rows_valid,
                                          int cols_valid, float scale,
                                          bool vec) {
  constexpr int kChunksPerRow = COLS / 8;
  constexpr bool kAsync = std::is_same<T, __nv_bfloat16>::value && !SCALE;
  static_assert(!SPLIT || std::is_same<T, float>::value, "split f32 only");
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c - r * kChunksPerRow) * 8;
    const bool row_ok = r < rows_valid;
    const T* src = g + static_cast<long long>(r) * g_sl + cc;
    if (kAsync && row_ok && vec && cc + 8 <= cols_valid) {
      cp_async_16(smem + r * ld + cc, src);
      continue;
    }
    float f[8];
    if (row_ok && vec && cc + 8 <= cols_valid) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const uint4 packed = *reinterpret_cast<const uint4*>(src);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 t = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          f[2 * j] = t.x;
          f[2 * j + 1] = t.y;
        }
      } else {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = (row_ok && cc + j < cols_valid) ? to_float(src[j]) : 0.0f;
    }
    if (SCALE) {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] *= scale;
    }
    uint4 hi, lo;
    if constexpr (SPLIT) {
      split_pack(f[0], f[1], hi.x, lo.x);
      split_pack(f[2], f[3], hi.y, lo.y);
      split_pack(f[4], f[5], hi.z, lo.z);
      split_pack(f[6], f[7], hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem_lo + r * ld + cc) = lo;
    } else {
      hi.x = pack_bf16(f[0], f[1]);
      hi.y = pack_bf16(f[2], f[3]);
      hi.z = pack_bf16(f[4], f[5]);
      hi.w = pack_bf16(f[6], f[7]);
    }
    *reinterpret_cast<uint4*>(smem + r * ld + cc) = hi;
  }
}

// T: the dtype of q and o; k and v are bf16 (f32 inputs are split into
// hi/lo scratch arrays first, see run()).
// D: the head dim padded to a multiple of 16 (the QK^T contraction).
// DV: the output columns one block computes; D / DV blocks share a q tile
// when the f32 accumulator of all D columns would not fit in registers.
// BN: kv rows per tile.
template <typename T, int D, int DV, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0 && DV % 16 == 0 && D % DV == 0, "tile shape");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int kParts = SPLIT ? 2 : 1;
  constexpr int kLdK = D + kSmemPad;
  constexpr int kLdV = DV + kSmemPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sQlo = sQ + kBlockM * kLdK;
  __nv_bfloat16* sK = sQ + kParts * kBlockM * kLdK;
  __nv_bfloat16* sKlo = sK + BN * kLdK;
  __nv_bfloat16* sV = sK + kParts * BN * kLdK;
  __nv_bfloat16* sVlo = sV + BN * kLdV;

  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int dv0 = blockIdx.z * DV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                static_cast<long long>(q0) * p.q_sl;
  const long long k_off = b * p.k_sb + h * p.k_sh;
  const long long v_off = b * p.v_sb + h * p.v_sh + dv0;
  const __nv_bfloat16* gk = static_cast<const __nv_bfloat16*>(p.k) + k_off;
  const __nv_bfloat16* gv = static_cast<const __nv_bfloat16*>(p.v) + v_off;
  const __nv_bfloat16* gk_lo =
      SPLIT ? static_cast<const __nv_bfloat16*>(p.k_lo) + k_off : nullptr;
  const __nv_bfloat16* gv_lo =
      SPLIT ? static_cast<const __nv_bfloat16*>(p.v_lo) + v_off : nullptr;

  load_tile<T, kBlockM, D, true, SPLIT>(sQ, sQlo, kLdK, gq, p.q_sl,
                                        p.lq - q0, p.d, p.q_scale, p.vec);

  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // rows (lane / 4) and (lane / 4 + 8) of this warp's 16
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  const uint32_t q_base = smem_addr(sQ);
  const uint32_t k_base = smem_addr(sK);
  const uint32_t v_base = smem_addr(sV);
  const uint32_t q_lo_base = smem_addr(sQlo);
  const uint32_t k_lo_base = smem_addr(sKlo);
  const uint32_t v_lo_base = smem_addr(sVlo);
  const int n_tiles = (p.lk + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile is consumed (and sQ is ready)
    load_tile<__nv_bfloat16, BN, D, false, false>(
        sK, nullptr, kLdK, gk + k0 * p.k_sl, p.k_sl, p.lk - k0, p.d, 1.f,
        p.vec);
    load_tile<__nv_bfloat16, BN, DV, false, false>(
        sV, nullptr, kLdV, gv + k0 * p.v_sl, p.v_sl, p.lk - k0, p.d - dv0,
        1.f, p.vec);
    if constexpr (SPLIT) {
      load_tile<__nv_bfloat16, BN, D, false, false>(
          sKlo, nullptr, kLdK, gk_lo + k0 * p.k_sl, p.k_sl, p.lk - k0, p.d,
          1.f, p.vec);
      load_tile<__nv_bfloat16, BN, DV, false, false>(
          sVlo, nullptr, kLdV, gv_lo + k0 * p.v_sl, p.v_sl, p.lk - k0,
          p.d - dv0, 1.f, p.vec);
    }
    cp_async_wait_all();
    __syncthreads();

    // s = q k^T for this warp's 16 rows x BN kv columns
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t a_off =
          ((warp * 16 + (lane & 15)) * kLdK + ks * 16 + (lane >> 4) * 8) * 2;
      uint32_t a[4], a_lo[4];
      ldmatrix_x4(a, q_base + a_off);
      if constexpr (SPLIT) ldmatrix_x4(a_lo, q_lo_base + a_off);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        const uint32_t b_off = (row * kLdK + col) * 2;
        uint32_t bk[4];
        ldmatrix_x4(bk, k_base + b_off);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        if constexpr (SPLIT) {
          uint32_t bk_lo[4];
          ldmatrix_x4(bk_lo, k_lo_base + b_off);
          mma_bf16(s[2 * np], a, bk_lo[0], bk_lo[1]);
          mma_bf16(s[2 * np + 1], a, bk_lo[2], bk_lo[3]);
          mma_bf16(s[2 * np], a_lo, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a_lo, bk[2], bk[3]);
        }
      }
    }

    if (k0 + BN > p.lk) {  // ragged tail: mask padded kv columns
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = k0 + j * 8 + (lane & 3) * 2;
        if (col >= p.lk) s[j][0] = s[j][2] = kNegInf;
        if (col + 1 >= p.lk) s[j][1] = s[j][3] = kNegInf;
      }
    }

    // online softmax (base 2)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha0 = fast_exp2(m_i[0] - mx[0]);
    const float alpha1 = fast_exp2(m_i[1] - mx[1]);
    m_i[0] = mx[0];
    m_i[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - mx[0]);
      s[j][1] = fast_exp2(s[j][1] - mx[0]);
      s[j][2] = fast_exp2(s[j][2] - mx[1]);
      s[j][3] = fast_exp2(s[j][3] - mx[1]);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l_i[0] = l_i[0] * alpha0 + rs0;
    l_i[1] = l_i[1] * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[i][0] *= alpha0;
      o[i][1] *= alpha0;
      o[i][2] *= alpha1;
      o[i][3] *= alpha1;
    }

    // o += p v: the s accumulators of two adjacent n-tiles are exactly the
    // A fragment of one k-step of 16 kv rows
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4], a_lo[4];
      if constexpr (SPLIT) {
        split_pack(s[2 * kk][0], s[2 * kk][1], a[0], a_lo[0]);
        split_pack(s[2 * kk][2], s[2 * kk][3], a[1], a_lo[1]);
        split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], a_lo[2]);
        split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], a_lo[3]);
      } else {
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        const uint32_t b_off = (row * kLdV + col) * 2;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_base + b_off);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
        if constexpr (SPLIT) {
          uint32_t bv_lo[4];
          ldmatrix_x4_trans(bv_lo, v_lo_base + b_off);
          mma_bf16(o[2 * dp], a, bv_lo[0], bv_lo[1]);
          mma_bf16(o[2 * dp + 1], a, bv_lo[2], bv_lo[3]);
          mma_bf16(o[2 * dp], a_lo, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], a_lo, bv[2], bv[3]);
        }
      }
    }
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_i[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = dv0 + i * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row < p.lq) {
        T* dst = go + static_cast<long long>(row) * p.o_sl + col;
        if (col < p.d) store_out(dst, o[i][2 * half] / l[half]);
        if (col + 1 < p.d) store_out(dst + 1, o[i][2 * half + 1] / l[half]);
      }
    }
  }
}

template <typename T, int D, int DV>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int BN = (SPLIT && D > 256) ? 32 : 64;
  constexpr int kParts = SPLIT ? 2 : 1;
  const int smem = kParts *
                   (kBlockM * (D + kSmemPad) + BN * (D + kSmemPad) +
                    BN * (DV + kSmemPad)) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_fwd_kernel<T, D, DV, BN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((p.lq + kBlockM - 1) / kBlockM, batch * p.heads,
            (p.d + DV - 1) / DV);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// x (B, H, L, D) f32 through its strides -> contiguous bf16 hi = bf16(x)
// and lo = bf16(x - hi), each rounded to nearest even.
__global__ void split_kernel(const float* __restrict__ x,
                             __nv_bfloat16* __restrict__ hi,
                             __nv_bfloat16* __restrict__ lo, int heads, int l,
                             int d, long long sb, long long sh, long long sl,
                             long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / d;
    const int col = static_cast<int>(i - row * d);
    const long long bh = row / l;
    const long long r = row - bh * l;
    const long long b = bh / heads;
    const long long h = bh - b * heads;
    const float v = x[b * sb + h * sh + r * sl + col];
    const __nv_bfloat16 vh = __float2bfloat16_rn(v);
    hi[i] = vh;
    lo[i] = __float2bfloat16_rn(v - __bfloat162float(vh));
  }
}

// Launch the attention of one entry point. Dispatch picks the tile shape
// for p.d: dispatch.template operator()<T>(p, batch, stream). dtype 0 is
// bf16 q/k/v/o; dtype 1 is f32, for which k and v are first split into
// scratch (4 * batch * heads * lk * d bf16 elements, 16-byte aligned:
// k hi, k lo, v hi, v lo).
template <typename Dispatch>
int run(Params p, int dtype, int batch, void* scratch, cudaStream_t stream,
        Dispatch dispatch) {
  if (p.d < 1) return kErrUnsupported;
  if (dtype == 0) return dispatch.template operator()<__nv_bfloat16>(p, batch, stream);
  if (dtype != 1 || scratch == nullptr) return kErrUnsupported;
  const long long n = static_cast<long long>(batch) * p.heads * p.lk * p.d;
  __nv_bfloat16* k_hi = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* k_lo = k_hi + n;
  __nv_bfloat16* v_hi = k_lo + n;
  __nv_bfloat16* v_lo = v_hi + n;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  split_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(p.k), k_hi, k_lo, p.heads, p.lk, p.d, p.k_sb,
      p.k_sh, p.k_sl, n);
  split_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(p.v), v_hi, v_lo, p.heads, p.lk, p.d, p.v_sb,
      p.v_sh, p.v_sl, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  p.k = k_hi;
  p.k_lo = k_lo;
  p.v = v_hi;
  p.v_lo = v_lo;
  p.k_sb = p.v_sb = static_cast<long long>(p.heads) * p.lk * p.d;
  p.k_sh = p.v_sh = static_cast<long long>(p.lk) * p.d;
  p.k_sl = p.v_sl = p.d;
  p.vec = p.vec && p.d % 8 == 0;  // 16-byte rows of the bf16 copies
  return dispatch.template operator()<float>(p, batch, stream);
}

inline Params make_params(const void* q, const void* k, const void* v, void* o,
                          int heads, int lq, int lk, int d, long long q_sb,
                          long long q_sh, long long q_sl, long long k_sb,
                          long long k_sh, long long k_sl, long long v_sb,
                          long long v_sh, long long v_sl, long long o_sb,
                          long long o_sh, long long o_sl, float q_scale,
                          int vec) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.q_scale = q_scale;
  p.vec = vec;
  return p;
}

inline const char* error_string(int code) {
  if (code == kErrUnsupported) return "head dim or dtype not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace ldt

#define LDT_FLASH_ARGS                                                      \
  const void *q, const void *k, const void *v, void *o, int dtype,          \
      int batch, int heads, int lq, int lk, int d, long long q_sb,          \
      long long q_sh, long long q_sl, long long k_sb, long long k_sh,       \
      long long k_sl, long long v_sb, long long v_sh, long long v_sl,       \
      long long o_sb, long long o_sh, long long o_sl, float q_scale,        \
      int vec, void *scratch, void *stream

#define LDT_MAKE_PARAMS                                                     \
  ldt::make_params(q, k, v, o, heads, lq, lk, d, q_sb, q_sh, q_sl, k_sb,    \
                   k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, q_scale, \
                   vec)
