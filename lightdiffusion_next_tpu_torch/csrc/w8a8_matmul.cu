// K7, K8 and K11: int8 activations times int8 weights on the tensor cores,
// s32 accumulator, f32 epilogue, bf16 out.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py
//   _w8a8_matmul_2d (K7, pallas_call at :669; body _kernel_w8a8 at :89),
//   _w8a8_matmul_stacked_2d (K8, pallas_call at :793) and
//   _w8a8_matmul_ep_2d (K11, pallas_call at :1293, stacked at :1284;
//   bodies _kernel_w8a8_ep and _kernel_w8a8_ep_res). K8 and the stacked K11
//   are K7's and K11's kernel instantiated with STACKED: the weight is block
//   idx of a (D, N, K) stack of codes (and, for K8, of (D, 1, N) column
//   scales), read in place at a 64-bit offset (block 37 of the single
//   blocks' linear1 stack starts 2.4e9 bytes in), never copied out.
//
// Operands: xq int8 (M, K) with per-row f32 scales sx (M,), from the row
// quantization (K9, K10); the weight's codes int8 (N, K), K-contiguous (the
// port's QTensor8W layout: int8 mma takes B K-major, and ldmatrix has no
// transposing form for 8-bit elements), with per-column f32 scales cs (N,).
// The accumulator is exact (|acc| <= 127 * 127 * K < 2^31). Epilogues, in
// the JAX kernels' order of f32 operations, each rounded (no contraction to
// FMA), so the bf16 result equals the plain version's bit for bit:
//   K7:  o = (f32(acc) * sx) * cs
//   K11: o = ((f32(acc) * sx) * cs) + b            (cs, b: gate folded in)
//   K11: o = (r + (f32(acc) * sx) * cs) + b        (gated residual)
//
// What bounds it on an H100: operations at the int8 tensor-core rate
// (1979 TOP/s) at every Flux shape with M >= 1024; at M = 256 (the text
// stream) the weight's bytes: 2 M K N operations against M K + K N + 4 M +
// 8 N + 2 M N bytes (+ 2 M N for the residual). linear1 (4352, 3072, 21504)
// 0.290 ms (operations); txt mlp.2 (256, 12288, 3072) with its residual
// 0.0132 ms (bytes).
//
// What the design does about it: blocks of BM x 128 outputs, 8 warps of
// (BM / 2) x 32, K steps of 128 bytes staged with cp.async in a ring of
// three stages (two steps' copies in flight under one step's products);
// mma.sync m16n8k32 s8 fed by ldmatrix (16 bytes per row per matrix, the
// 16-bit fragment layout equals the 8-bit one byte for byte); rows of 144
// bytes in shared memory so ldmatrix's eight rows hit distinct banks. BM =
// 128 above M = 1024, 64 below, so small-M calls still start more blocks.
// Blocks walk M fastest, so the blocks in flight share weight tiles in L2.
// Rows past M are zero-filled by the copy and not stored: no padding copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 128;          // K bytes per step
constexpr int kRow = kBK + 16;    // shared row stride in bytes
constexpr int kStages = 3;
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kErrUnsupported = 1000;

enum Mode { kPlain = 0, kBias = 1, kResidual = 2 };

template <int BM>
struct Smem {
  int8_t a[kStages][BM][kRow];
  int8_t b[kStages][kBN][kRow];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, s32) += a (16x32, s8, row) * b (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of K step `step` into stage `buf` (not committed).
template <int BM>
__device__ __forceinline__ void load_step(Smem<BM>& sm, int buf, int step,
                                          const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ b, int m,
                                          long long lda, long long ldb, int m0,
                                          int n0) {
  const long long k0 = static_cast<long long>(step) * kBK;
  for (int c = threadIdx.x; c < BM * (kBK / 16); c += kThreads) {
    const int r = c >> 3;
    const int cc = (c & 7) * 16;
    const bool ok = m0 + r < m;
    const int8_t* src = a + (ok ? static_cast<long long>(m0 + r) * lda + k0 + cc : 0);
    cp_async_16(&sm.a[buf][r][cc], src, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < kBN * (kBK / 16); c += kThreads) {
    const int r = c >> 3;
    const int cc = (c & 7) * 16;
    cp_async_16(&sm.b[buf][r][cc],
                b + static_cast<long long>(n0 + r) * ldb + k0 + cc, 16);
  }
}

// STACKED: b (and cs, when cs_block is not 0) are stacks; block idx starts
// b_block codes and cs_block scales in.
template <int BM, int MODE, bool STACKED>
__global__ void __launch_bounds__(kThreads)
    w8a8_matmul_kernel(const int8_t* __restrict__ a,
                       const float* __restrict__ sx,
                       const int8_t* __restrict__ b,
                       const float* __restrict__ cs,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ res,
                       __nv_bfloat16* __restrict__ out, int m, int n, int k,
                       long long lda, long long ldb, long long ldr,
                       long long b_block, long long cs_block, int idx) {
  if (STACKED) {
    b += static_cast<long long>(idx) * b_block;
    cs += static_cast<long long>(idx) * cs_block;
  }
  constexpr int WM = BM / 2;  // warp tile rows
  constexpr int WN = 32;      // warp tile columns
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BM>& sm = *reinterpret_cast<Smem<BM>*>(smem_raw);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM;
  const int wn = (warp & 3) * WN;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int steps = k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step<BM>(sm, s, s, a, b, m, lda, ldb, m0, n0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step t has landed; step t - 1's reads are done
    const int pre = t + kStages - 1;
    if (pre < steps) load_step<BM>(sm, pre % kStages, pre, a, b, m, lda, ldb, m0, n0);
    cp_async_commit();
    const int buf = t % kStages;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm + mi * 16 + (lane & 15);
        const int col = ks * 32 + (lane >> 4) * 16;
        ldmatrix_x4(af[mi], smem_addr(&sm.a[buf][row][col]));
      }
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t bf[4];
        const int row = wn + nj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int col = ks * 32 + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(bf, smem_addr(&sm.b[buf][row][col]));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = n0 + wn + j * 8 + tq * 2;
    const float cs0 = __ldg(cs + col), cs1 = __ldg(cs + col + 1);
    float b0 = 0.f, b1 = 0.f;
    if (MODE != kPlain) {
      b0 = __ldg(bias + col);
      b1 = __ldg(bias + col + 1);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= m) continue;
        const float s = __ldg(sx + row);
        float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][j][2 * half]), s), cs0);
        float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][j][2 * half + 1]), s), cs1);
        if (MODE == kResidual) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(
              res + static_cast<long long>(row) * ldr + col);
          v0 = __fadd_rn(__fadd_rn(__low2float(r2), v0), b0);
          v1 = __fadd_rn(__fadd_rn(__high2float(r2), v1), b1);
        } else if (MODE == kBias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Where a launch reads the weight: a plain (N, K) matrix, or block idx of
// a stack (b_block codes per block; cs_block scales per block, 0 for a
// folded vector).
struct Block {
  long long b_block = 0;
  long long cs_block = 0;
  int idx = 0;
};

template <int BM, int MODE, bool STACKED>
int launch_tile(const int8_t* a, const float* sx, const int8_t* b,
                const float* cs, const float* bias, const __nv_bfloat16* res,
                __nv_bfloat16* out, int m, int n, int k, long long lda,
                long long ldb, long long ldr, Block blk, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<BM>));
  auto kernel = w8a8_matmul_kernel<BM, MODE, STACKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((m + BM - 1) / BM, n / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(a, sx, b, cs, bias, res, out, m, n,
                                           k, lda, ldb, ldr, blk.b_block,
                                           blk.cs_block, blk.idx);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool STACKED = false>
int launch(const void* xq, const void* sx, const void* q, const void* cs,
           const void* bias, const void* res, void* out, int m, int n, int k,
           long long lda, long long ldb, long long ldr, void* stream,
           Block blk = Block()) {
  if (m < 1 || n < kBN || n % kBN != 0 || k < 0 || k % kBK != 0 ||
      lda < k || lda % 16 != 0 || ldb < k || ldb % 16 != 0 ||
      (MODE == kResidual && (ldr < n || ldr % 2 != 0))) {
    return kErrUnsupported;
  }
  const auto* a8 = static_cast<const int8_t*>(xq);
  const auto* b8 = static_cast<const int8_t*>(q);
  const auto* s = static_cast<const float*>(sx);
  const auto* c = static_cast<const float*>(cs);
  const auto* bb = static_cast<const float*>(bias);
  const auto* r = static_cast<const __nv_bfloat16*>(res);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 1024) {
    return launch_tile<64, MODE, STACKED>(a8, s, b8, c, bb, r, o, m, n, k, lda,
                                          ldb, ldr, blk, st);
  }
  return launch_tile<128, MODE, STACKED>(a8, s, b8, c, bb, r, o, m, n, k, lda,
                                         ldb, ldr, blk, st);
}

// Block idx of a stack of depth blocks of n rows of ldb codes each.
bool stack_block(int depth, int idx, int n, long long ldb, long long cs_block,
                 Block* blk) {
  if (idx < 0 || idx >= depth) return false;
  blk->b_block = static_cast<long long>(n) * ldb;
  blk->cs_block = cs_block;
  blk->idx = idx;
  return true;
}

}  // namespace

// K7. xq (M, K) int8 with row stride lda, sx (M,) f32, q (N, K) int8 with
// row stride ldb (both strides multiples of 16), cs (N,) f32, out (M, N)
// bf16 contiguous; every pointer 16-byte aligned. ``k`` is the number of K
// bytes summed (a multiple of 128).
extern "C" int ldt_w8a8_matmul_fwd(const void* xq, const void* sx,
                                   const void* q, const void* cs, void* out,
                                   int m, int n, int k, long long lda,
                                   long long ldb, void* stream) {
  return launch<kPlain>(xq, sx, q, cs, nullptr, nullptr, out, m, n, k, lda,
                        ldb, 0, stream);
}

// K11. As K7 with bias (N,) f32 and, when res is not null, the residual
// (M, N) bf16 with row stride ldr (even).
extern "C" int ldt_w8a8_matmul_ep_fwd(const void* xq, const void* sx,
                                      const void* q, const void* cs,
                                      const void* bias, const void* res,
                                      void* out, int m, int n, int k,
                                      long long lda, long long ldb,
                                      long long ldr, void* stream) {
  if (bias == nullptr) return kErrUnsupported;
  if (res != nullptr) {
    return launch<kResidual>(xq, sx, q, cs, bias, res, out, m, n, k, lda, ldb,
                             ldr, stream);
  }
  return launch<kBias>(xq, sx, q, cs, bias, nullptr, out, m, n, k, lda, ldb,
                       0, stream);
}

// K8. As K7 on block idx (0 <= idx < depth) of q3 (depth, N, K) int8 with
// row stride ldb, and of cs3 (depth, 1, N) f32; both contiguous.
extern "C" int ldt_w8a8_matmul_stacked_fwd(const void* xq, const void* sx,
                                           const void* q3, const void* cs3,
                                           void* out, int m, int n, int k,
                                           long long lda, long long ldb,
                                           int depth, int idx, void* stream) {
  Block blk;
  if (!stack_block(depth, idx, n, ldb, n, &blk)) return kErrUnsupported;
  return launch<kPlain, true>(xq, sx, q3, cs3, nullptr, nullptr, out, m, n, k,
                              lda, ldb, 0, stream, blk);
}

// The stacked K11. As K11 on block idx (0 <= idx < depth) of q3 (depth, N,
// K) int8 with row stride ldb; cs (N,) and bias (N,) are the caller's folds
// of that block's column scales.
extern "C" int ldt_w8a8_matmul_ep_stacked_fwd(
    const void* xq, const void* sx, const void* q3, const void* cs,
    const void* bias, const void* res, void* out, int m, int n, int k,
    long long lda, long long ldb, long long ldr, int depth, int idx,
    void* stream) {
  Block blk;
  if (bias == nullptr || !stack_block(depth, idx, n, ldb, 0, &blk)) {
    return kErrUnsupported;
  }
  if (res != nullptr) {
    return launch<kResidual, true>(xq, sx, q3, cs, bias, res, out, m, n, k,
                                   lda, ldb, ldr, stream, blk);
  }
  return launch<kBias, true>(xq, sx, q3, cs, bias, nullptr, out, m, n, k, lda,
                             ldb, 0, stream, blk);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
