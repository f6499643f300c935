// K7, K8 and K11 with int8_mxu=False: the int8 codes multiplied at the bf16
// rate, f32 accumulator, the W8A8 epilogues, bf16 out.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py with int8_mxu=False:
//   _w8a8_matmul_2d (K7, pallas_call at :669; body _kernel_w8a8 at :89, its
//   bf16 branch :112-124), _w8a8_matmul_stacked_2d (K8, pallas_call at :793;
//   _kernel_w8a8_stacked :171-185) and _w8a8_matmul_ep_2d (K11, pallas_call
//   at :1293, stacked at :1284; _w8a8_ep_dot :1090-1102). The TPU's A/B
//   fallback: the same int8 operands, cast to bf16 and contracted at the bf16
//   rate into an f32 accumulator.
//
// The function: acc = sum_k bf16(xq[m, k]) * bf16(q[n, k]) in f32 (int8 codes
// are exact in bf16 and their products exact in f32; a sum rounds only past
// 2^24, which K = 3072-15360 can reach: near-exact, where the int8 kernels
// (w8a8_matmul.cu) are exact), then the epilogues of w8a8_matmul.cu in the
// same order of rounded f32 operations:
//   K7:  o = (acc * sx) * cs
//   K11: o = ((acc * sx) * cs) + b            (cs, b: gate folded in)
//   K11: o = (r + (acc * sx) * cs) + b        (gated residual)
// K8 and the stacked K11 run the same kernel on block idx of a (D, N, K)
// stack: the entry point adds the block's offset (idx * N * ldb codes) on the
// host, in 64 bits; the wrapper hands K8's column scales at the block.
//
// What bounds it on an H100: operations at the bf16 tensor-core rate (989
// TFLOP/s), twice the int8 kernels' bound, at every Flux shape with M >=
// 1024; the weight's int8 bytes at M = 256.
//
// The design: a plain multistage mma.sync GEMM (mma_sync.cuh), right first.
// - A block of 8 warps takes a 128 x 128 tile of the output, each warp 64 x
//   32 (4 x 4 m16n8k16 products per k16 step, 64 f32 accumulators).
// - K steps of 64 codes: a ring of 4 cp.async stages, each the A (128 x 64)
//   and B (128 x 64) int8 tiles, 64-byte rows whose 16-byte chunk c lies at
//   c ^ ((row >> 1) & 3), so the fragment loads of a warp (8 rows, 4 bytes
//   each of 4 lanes) fall on 32 distinct banks.
// - Each warp reads its fragments as int8 (one 4-byte load gives four k of
//   a row) and converts them to bf16 in registers (mma_sync.cuh): the
//   operands stay int8 in device and shared memory, as on the TPU.
// - The epilogue from the accumulator fragments: 4-byte stores of bf16
//   pairs, the residual read the same way.
// Rows past M are zero-filled by the copy and never stored. K must be a
// positive multiple of 64, N a multiple of 128.
//
// Left for later: wgmma (bf16 operands from the int8 tiles converted in
// shared memory), a producer warpgroup, tiles by shape, as w8a8_matmul.cu has.
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace hopper;
using namespace mmasync;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;       // K codes per step
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kTile = kBM * kBK;  // bytes of the A tile, and of the B tile
constexpr int kSmem = kStages * 2 * kTile;
constexpr int kErrUnsupported = 1000;

enum Mode { kPlain = 0, kBias = 1, kResidual = 2 };

struct Args {
  const int8_t* a;
  const float* sx;
  const int8_t* b;
  const float* cs;
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int m, n, k;
  long long lda, ldb, ldr;
};

// Byte offset of byte `col` (a multiple of 4) of row `row` in a 64-byte-row tile
__device__ __forceinline__ int tile_offset(int row, int col) {
  return row * kBK + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// The copies of K step `step` into ring stage `stage`: 512 chunks of 16
// bytes per tile, two per thread
__device__ __forceinline__ void load_step(uint32_t base, int stage, int step, const Args& g,
                                          int m0, int n0) {
  const uint32_t as = base + stage * 2 * kTile;
  const uint32_t bs = as + kTile;
  const long long k0 = static_cast<long long>(step) * kBK;
#pragma unroll
  for (int i = 0; i < kBM * 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2;
    const int ch = c & 3;
    const bool ok = m0 + r < g.m;
    const int8_t* src = g.a + (ok ? static_cast<long long>(m0 + r) * g.lda + k0 + ch * 16 : 0);
    cp_async_16(as + tile_offset(r, ch * 16), src, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < kBN * 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2;
    const int ch = c & 3;
    cp_async_16(bs + tile_offset(r, ch * 16),
                g.b + static_cast<long long>(n0 + r) * g.ldb + k0 + ch * 16, 16);
  }
}

// One K step's products of a warp: 4 k16 steps of its 4 x 4 m16n8 tiles
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4], const unsigned char* at,
                                         const unsigned char* bt, int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const int col = kk * 16 + 4 * t;
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16 + g;
      s8x4_to_bf16(*reinterpret_cast<const uint32_t*>(at + tile_offset(r, col)), a[i][0],
                   a[i][2]);
      s8x4_to_bf16(*reinterpret_cast<const uint32_t*>(at + tile_offset(r + 8, col)), a[i][1],
                   a[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b0, b1;
      s8x4_to_bf16(*reinterpret_cast<const uint32_t*>(bt + tile_offset(wn * 32 + j * 8 + g, col)),
                   b0, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) w8a8_bf16_matmul_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = g.k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(base, s, s, g, m0, n0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // own copies of step t have landed
    __syncthreads();               // everyone's; step t - 1's stage is read
    const int next = t + kStages - 1;
    if (next < steps) load_step(base, next % kStages, next, g, m0, n0);
    cp_async_commit();
    const unsigned char* at = smem + (t % kStages) * 2 * kTile;
    mma_step(acc, at, at + kTile, wm, wn);
  }
  cp_async_wait<0>();

  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + i * 16 + gr + 8 * h;
      if (r >= g.m) continue;
      const float s = __ldg(g.sx + r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + 2 * tc;
        float v0 = __fmul_rn(__fmul_rn(acc[i][j][2 * h], s), __ldg(g.cs + c));
        float v1 = __fmul_rn(__fmul_rn(acc[i][j][2 * h + 1], s), __ldg(g.cs + c + 1));
        if (MODE == kResidual) {
          const __nv_bfloat162 rr = *reinterpret_cast<const __nv_bfloat162*>(
              g.res + static_cast<long long>(r) * g.ldr + c);
          v0 = __fadd_rn(__low2float(rr), v0);
          v1 = __fadd_rn(__high2float(rr), v1);
        }
        if (MODE != kPlain) {
          v0 = __fadd_rn(v0, __ldg(g.bias + c));
          v1 = __fadd_rn(v1, __ldg(g.bias + c + 1));
        }
        *reinterpret_cast<uint32_t*>(g.out + static_cast<long long>(r) * g.n + c) =
            pack_bf16(v0, v1);
      }
    }
  }
}

template <int MODE>
int run(const Args& g, cudaStream_t stream) {
  auto kernel = w8a8_bf16_matmul_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((g.m + kBM - 1) / kBM, g.n / kBN);
  kernel<<<grid, kThreads, kSmem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7, K8 and K11 at the bf16 rate. xq (M, K) int8 with row stride lda, sx
// (M,) f32, q3 (depth, N, K) int8 with row stride ldb (a plain weight is
// depth 1; both strides multiples of 16; the codes 16-byte aligned), block
// idx taken; cs (N,) f32 (the block's); out (M, N) bf16 contiguous. bias
// null: K7 (and K8); else (N,) f32, and res null or the residual (M, N) bf16
// with row stride ldr (a multiple of 2). ``k`` is the number of K codes
// summed (a multiple of 64).
extern "C" int ldt_w8a8_bf16_matmul_fwd(const void* xq, const void* sx, const void* q3,
                                        const void* cs, const void* bias, const void* res,
                                        void* out, int m, int n, int k, long long lda,
                                        long long ldb, long long ldr, int depth, int idx,
                                        void* stream) {
  const int mode = bias == nullptr ? kPlain : (res == nullptr ? kBias : kResidual);
  if (m < 1 || n < 1 || n % kBN != 0 || k < kBK || k % kBK != 0 || lda < k || lda % 16 != 0 ||
      ldb < k || ldb % 16 != 0 || idx < 0 || idx >= depth ||
      (mode == kResidual && (ldr < n || ldr % 2 != 0))) {
    return kErrUnsupported;
  }
  const long long off = static_cast<long long>(idx) * n * ldb;
  const Args g{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
               static_cast<const int8_t*>(q3) + off, static_cast<const float*>(cs),
               static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
               static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, ldr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kResidual) return run<kResidual>(g, s);
  if (mode == kBias) return run<kBias>(g, s);
  return run<kPlain>(g, s);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
