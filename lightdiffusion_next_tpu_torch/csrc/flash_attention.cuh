// Exact non-causal flash attention for Hopper (sm_90a), shared by the two
// entry points in flash_attention.cu and packed_flash_attention.cu.
//
// What it computes (the same function as the Pallas kernels of
// lightdiffusion_next_tpu/ops/flash_attention.py):
//   q is pre-scaled by LOG2E/sqrt(d) in f32 and rounded to bf16;
//   s = q k^T with f32 accumulation, already in the base-2 domain;
//   padded kv columns (ragged Lk) are set to -1e30;
//   online softmax with exp2, f32 running max m, sum l and accumulator;
//   p is rounded to bf16 for the p v product, f32 accumulation;
//   o = acc / l, rounded to the output dtype.
//
// Design: one block of 4 warps per (q tile of 64 rows, batch*head, output
// column slice). Each warp owns 16 q rows. A loop inside the block walks the
// kv tiles of 64 rows: K and V are copied into shared memory with cp.async
// (every thread's 16-byte copies in flight at once, none through registers),
// QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), and the softmax state lives in registers. The L x L logits
// never leave registers. The head dim is padded to a multiple of 16 (the mma
// k-step) inside shared memory only: the pad lanes are zero-filled there,
// device memory is read at the real width.
//
// f32 inputs (the VAE's attention): the products run on the bf16 tensor
// cores. q is rounded while its tile is staged (after the f32 pre-scale);
// k and v are rounded once per call into a bf16 scratch buffer by
// to_bf16_kernel, so the kv loop reads half the bytes and never converts.
// Softmax state and both accumulations stay f32.
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
constexpr int kBlockN = 64;   // kv rows per tile
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
// multiplies in f32 before the rounding to bf16 (the q pre-scale). Aligned
// bf16 chunks that need no arithmetic go through cp.async: the caller waits
// with cp_async_wait_all before the tile is read.
template <typename T, int ROWS, int COLS, bool SCALE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ smem,
                                          int ld, const T* __restrict__ g,
                                          long long g_sl, int rows_valid,
                                          int cols_valid, float scale,
                                          bool vec) {
  constexpr int kChunksPerRow = COLS / 8;
  constexpr bool kAsync = std::is_same<T, __nv_bfloat16>::value && !SCALE;
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
    uint4 packed;
    if (row_ok && vec && cc + 8 <= cols_valid) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        packed = *reinterpret_cast<const uint4*>(src);
        uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          w[j] = pack_bf16(f.x * scale, f.y * scale);
        }
      } else {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        const float s = SCALE ? scale : 1.0f;
        packed.x = pack_bf16(a.x * s, a.y * s);
        packed.y = pack_bf16(a.z * s, a.w * s);
        packed.z = pack_bf16(b.x * s, b.y * s);
        packed.w = pack_bf16(b.z * s, b.w * s);
      }
    } else {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        f[j] = (row_ok && cc + j < cols_valid) ? to_float(src[j]) : 0.0f;
        if (SCALE) f[j] *= scale;
      }
      packed.x = pack_bf16(f[0], f[1]);
      packed.y = pack_bf16(f[2], f[3]);
      packed.z = pack_bf16(f[4], f[5]);
      packed.w = pack_bf16(f[6], f[7]);
    }
    *reinterpret_cast<uint4*>(smem + r * ld + cc) = packed;
  }
}

// T: the dtype of q and o; k and v are bf16 (f32 inputs are rounded into
// a scratch buffer first, see run()).
// D: the head dim padded to a multiple of 16 (the QK^T contraction).
// DV: the output columns one block computes; D / DV blocks share a q tile
// when the f32 accumulator of all D columns would not fit in registers.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0 && DV % 16 == 0 && D % DV == 0, "tile shape");
  constexpr int kLdK = D + kSmemPad;
  constexpr int kLdV = DV + kSmemPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLdK;
  __nv_bfloat16* sV = sK + kBlockN * kLdK;

  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int dv0 = blockIdx.z * DV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                static_cast<long long>(q0) * p.q_sl;
  const __nv_bfloat16* gk =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* gv =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh + dv0;

  load_tile<T, kBlockM, D, true>(sQ, kLdK, gq, p.q_sl, p.lq - q0, p.d,
                                 p.q_scale, p.vec);

  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // rows (lane / 4) and (lane / 4 + 8) of this warp's 16
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  const uint32_t q_base = smem_addr(sQ);
  const uint32_t k_base = smem_addr(sK);
  const uint32_t v_base = smem_addr(sV);
  const int n_tiles = (p.lk + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is consumed (and sQ is ready)
    load_tile<__nv_bfloat16, kBlockN, D, false>(
        sK, kLdK, gk + k0 * p.k_sl, p.k_sl, p.lk - k0, p.d, 1.f, p.vec);
    load_tile<__nv_bfloat16, kBlockN, DV, false>(
        sV, kLdV, gv + k0 * p.v_sl, p.v_sl, p.lk - k0, p.d - dv0, 1.f, p.vec);
    cp_async_wait_all();
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 kv columns
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, q_base + ((warp * 16 + (lane & 15)) * kLdK + ks * 16 +
                               (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bk[4];
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk, k_base + (row * kLdK + col) * 2);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    if (k0 + kBlockN > p.lk) {  // ragged tail: mask padded kv columns
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int col = k0 + j * 8 + (lane & 3) * 2;
        if (col >= p.lk) s[j][0] = s[j][2] = kNegInf;
        if (col + 1 >= p.lk) s[j][1] = s[j][3] = kNegInf;
      }
    }

    // online softmax (base 2)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
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
    for (int j = 0; j < kBlockN / 8; ++j) {
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
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bv, v_base + (row * kLdV + col) * 2);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
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
  const int smem =
      (kBlockM * (D + kSmemPad) + kBlockN * (D + kSmemPad) +
       kBlockN * (DV + kSmemPad)) * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_fwd_kernel<T, D, DV>;
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

// x (B, H, L, D) f32 through its strides -> contiguous bf16, rounded to
// nearest even (the rounding the tile loads apply).
__global__ void to_bf16_kernel(const float* __restrict__ x,
                               __nv_bfloat16* __restrict__ out, int heads,
                               int l, int d, long long sb, long long sh,
                               long long sl, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / d;
    const int col = static_cast<int>(i - row * d);
    const long long bh = row / l;
    const long long r = row - bh * l;
    const long long b = bh / heads;
    const long long h = bh - b * heads;
    out[i] = __float2bfloat16_rn(x[b * sb + h * sh + r * sl + col]);
  }
}

// Launch the attention of one entry point. Dispatch picks the tile shape
// for p.d: dispatch.template operator()<T>(p, batch, stream). dtype 0 is
// bf16 q/k/v/o; dtype 1 is f32, for which k and v are first rounded into
// scratch (2 * batch * heads * lk * d bf16 elements, 16-byte aligned).
template <typename Dispatch>
int run(Params p, int dtype, int batch, void* scratch, cudaStream_t stream,
        Dispatch dispatch) {
  if (p.d < 1) return kErrUnsupported;
  if (dtype == 0) return dispatch.template operator()<__nv_bfloat16>(p, batch, stream);
  if (dtype != 1 || scratch == nullptr) return kErrUnsupported;
  const long long n = static_cast<long long>(batch) * p.heads * p.lk * p.d;
  __nv_bfloat16* k16 = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* v16 = k16 + n;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  to_bf16_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(p.k), k16, p.heads, p.lk, p.d, p.k_sb, p.k_sh,
      p.k_sl, n);
  to_bf16_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(p.v), v16, p.heads, p.lk, p.d, p.v_sb, p.v_sh,
      p.v_sl, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  p.k = k16;
  p.v = v16;
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
  Params p;
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
