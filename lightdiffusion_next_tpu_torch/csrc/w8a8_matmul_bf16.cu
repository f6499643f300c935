// K7, K8 and K11 with int8_mxu=False: the int8 codes multiplied at the bf16
// rate on wgmma, f32 accumulator, the W8A8 epilogues, bf16 out.
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
// 1024; the weight's int8 bytes at M = 256. Besides the products, every code
// has to become a bf16 value on the way to the tensor cores (about 3 issue
// slots a code): the design converts each code of a block's tiles once.
//
// The design: K5's (quant_matmul.cu) wgmma GEMM on w8a8_matmul.cu's operands
// and epilogue, the dequant replaced by the exact int8 -> bf16 conversion
// (hopper.cuh s8x4_to_bf16) of both operands.
// - The int8 tiles land by cp.async in a ring of 3 stages, each a K step of
//   64 codes: A (BM x 64, the xq rows) and B (BN x 64, the weight's rows,
//   K-major), 64-byte rows. Rows past M are zero-filled (src size 0) and
//   never stored.
// - Both operands are converted once per block into bf16 K-major tiles with
//   the 128-byte swizzle (rows of 128 bytes, K5's x-tile layout; wgmma reads
//   them through make_desc, k16 = 32 bytes into the row), under the
//   previous step's products: in step t every thread issues step t's wgmmas
//   on buffer set t % 3, converts step t + 1's codes into set (t + 1) % 3,
//   then waits for step t - 1's wgmmas (step t's stay in flight), so set
//   (t + 1) % 3 was last read two steps ago.
// - A thread converts exactly the 16-byte chunks it copied (the same chunk
//   of the same row), so the conversion waits for its own copies only
//   (cp.async.wait_group, no barrier), and a stage is refilled by the
//   thread that converted it: step t + 3's copies go into step t's stage,
//   two steps ahead of their conversion. One barrier a step, before the
//   wgmmas, publishes everyone's conversion (after fence.proxy.async).
// - A chunk of 16 codes of a k16 group becomes 32 bytes: s8x4_to_bf16 of
//   codes 4t..4t+3 gives the bf16 pairs of logical k (2t, 2t+1) and (2t+8,
//   2t+9), stored at those positions; both operands take the same
//   permutation of their 16 k, so the product is the same.
// - Tried on the card and dropped (PERF.md):
//   - A in registers (wgmma_rs, each warpgroup converting its rows of A
//     with 4-byte loads), as the first design: ptxas serialised its wgmmas
//     (C7513, "non wgmma instructions defining input registers of a wgmma
//     between start and end of the pipeline stage") whenever step t + 1's
//     A fragments were written while step t's wgmmas ran, and the kernel
//     sat at 2.6-3.1x its bound;
//   - the codes loaded from global memory into registers two steps ahead
//     instead of the cp.async ring, which would spare shared memory their
//     write and read: each step's warpgroup.arrive waits for the loads in
//     flight (ptxas puts one back where the source leaves it out, C7519),
//     and the kernel was slower at every shape.
// - The first step's wgmmas overwrite the accumulator (scale-d 0), which is
//   never zeroed (moves into it made ptxas serialise the int8 kernel's
//   wgmmas, C7515).
// - The epilogue in two passes through shared memory, w8a8_matmul.cu's:
//   (acc * sx) * cs from the fragments into an f32 tile, then the residual
//   and bias added and 16-byte chunks of bf16 stored in whole lines.
// - Tiles by shape, chosen in Python (ops/quant_matmul.w8a8_bf16_tile, which
//   states the same table by id) and passed to the entry point:
//     id  tile       warpgroups x wgmma per k16   smem, blocks/SM
//     0   128 x 256  2 x one m64n256               217 KB, 1
//     1   128 x 128  2 x one m64n128               145 KB, 1 (N % 256 != 0)
//     2   64 x 64    1 x one m64n64                 73 KB, 3
//   128 x 256 where the grid runs waves, 64 x 64 at M = 256, where a
//   128 x 256 grid (24 blocks at N = 3072) would leave most SMs idle.
// - Blocks walk M fastest (grid x over M, y over N): the blocks in flight
//   share one weight column tile through L2.
// K must be a positive multiple of 64 and N a multiple of the tile's width.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;       // K codes per step: four k16 steps
constexpr int kKS = kBK / 16;
constexpr int kStages = 3;    // cp.async ring of the int8 tiles
constexpr int kWBufs = 3;     // bf16 buffer sets: two wgmma groups in flight
                              // read two, the conversion writes the third
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

// The shared-memory plan of a block of WGS warpgroups of 64 rows by BN
// columns: kWBufs bf16 buffer sets (A's BM rows, then B's BN rows, of 128
// bytes each, on 1024-byte atoms), then the ring of int8 A and B tiles.
// After the last products the whole plan holds the epilogue's f32 tile,
// rows kTRow floats apart.
template <int WGS, int BN>
struct Cfg {
  static constexpr int kThreads = WGS * 128;
  static constexpr int BM = WGS * 64;
  static constexpr int kABuf = BM * kBK * 2;
  static constexpr int kSet = kABuf + BN * kBK * 2;
  static constexpr int kRing = kWBufs * kSet;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kStage = kABytes + BN * kBK;
  static constexpr int kPlan = kRing + kStages * kStage;
  static constexpr int kSmem = kPlan + kAtom;  // + alignment
  static constexpr int kTRow = BN + 8;
  static_assert(BM * kTRow * 4 <= kPlan, "the epilogue tile fits the plan");
  static_assert(BN * 4 % kThreads == 0, "B chunks per thread");
};

// Issue the copies of K step `step` into ring stage `stage`: thread i's
// chunks c = i + j * threads, chunk c = 16 codes ch = c % 4 of row c / 4
template <int WGS, int BN>
__device__ __forceinline__ void load_step(uint32_t ring, int stage, int step, const Args& g,
                                          int m0, int n0) {
  using C = Cfg<WGS, BN>;
  const uint32_t as = ring + stage * C::kStage;
  const uint32_t bs = as + C::kABytes;
  const long long k0 = static_cast<long long>(step) * kBK;
#pragma unroll
  for (int i = 0; i < C::BM * 4 / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    const int r = c >> 2;
    const bool ok = m0 + r < g.m;
    const int8_t* src =
        g.a + (ok ? static_cast<long long>(m0 + r) * g.lda + k0 + (c & 3) * 16 : 0);
    cp_async_16(as + c * 16, src, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < BN * 4 / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    const long long r = n0 + (c >> 2);
    cp_async_16(bs + c * 16, g.b + r * g.ldb + k0 + (c & 3) * 16, 16);
  }
}

// The chunks of a tile of `rows` int8 rows that this thread copied -> bf16
// rows of 128 bytes, swizzled (chunk j of row r at j ^ (r & 7)): chunk c is
// row c / 4's k16 group kk = c % 4, whose word t (codes 4t..4t+3) gives the
// bf16 words t and 4 + t of the group's 32 bytes, chunks 2kk and 2kk + 1.
template <int ROWS, int THREADS>
__device__ __forceinline__ void convert_tile(const unsigned char* codes, unsigned char* w) {
#pragma unroll
  for (int i = 0; i < ROWS * 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 2;
    const int kk = c & 3;
    const uint4 x = *reinterpret_cast<const uint4*>(codes + c * 16);
    uint32_t o[8];
    s8x4_to_bf16(x.x, o[0], o[4]);
    s8x4_to_bf16(x.y, o[1], o[5]);
    s8x4_to_bf16(x.z, o[2], o[6]);
    s8x4_to_bf16(x.w, o[3], o[7]);
    unsigned char* row = w + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * kk) ^ (r & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((2 * kk + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// Ring stage `stage` -> bf16 buffer set `set`: A's rows, then B's
template <int WGS, int BN>
__device__ __forceinline__ void convert_step(unsigned char* smem, int stage, int set) {
  using C = Cfg<WGS, BN>;
  const unsigned char* codes = smem + C::kRing + stage * C::kStage;
  unsigned char* w = smem + set * C::kSet;
  convert_tile<C::BM, C::kThreads>(codes, w);
  convert_tile<BN, C::kThreads>(codes + C::kABytes, w + C::kABuf);
}

// One step's products: four m64nBNk16 wgmmas per warpgroup on buffer set
// `set`; scale = 0 (the first step) overwrites the accumulator
template <int WGS, int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], uint32_t base, int set,
                                         int scale) {
  using C = Cfg<WGS, BN>;
  const uint32_t a0 = base + set * C::kSet + (threadIdx.x >> 7) * 64 * 128;
  const uint32_t b0 = base + set * C::kSet + C::kABuf;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    // 8-row atoms 1024 bytes apart (SBO); k16 = 32 bytes into the row
    wgmma<BN, 0>(acc, make_desc(a0 + kk * 32, 16, kAtom), make_desc(b0 + kk * 32, 16, kAtom),
                 scale | kk);
  }
}

// The epilogue, w8a8_matmul.cu's store_tile on the f32 accumulator: pass 1
// writes (acc * sx) * cs of each fragment into the f32 tile; pass 2 adds the
// residual and the bias in the same rounded order and stores 16 bytes a
// thread.
template <int WGS, int BN, int MODE>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const Args& g, int m0,
                                           int n0, unsigned char* smem) {
  using C = Cfg<WGS, BN>;
  float* tile = reinterpret_cast<float*>(smem);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  __syncthreads();  // every warpgroup's last wgmmas have read the plan
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
    const float s = m0 + r < g.m ? __ldg(g.sx + m0 + r) : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      float2 v;
      v.x = __fmul_rn(__fmul_rn(acc[4 * j + 2 * h], s), __ldg(g.cs + n0 + c));
      v.y = __fmul_rn(__fmul_rn(acc[4 * j + 2 * h + 1], s), __ldg(g.cs + n0 + c + 1));
      *reinterpret_cast<float2*>(tile + r * C::kTRow + c) = v;
    }
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;  // 16-byte output chunks per row
  static_assert(C::BM * kChunks % C::kThreads == 0, "chunks per thread");
#pragma unroll
  for (int it = 0; it < C::BM * kChunks / C::kThreads; ++it) {
    const int i = threadIdx.x + it * C::kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (m0 + r >= g.m) continue;
    const float4 t0 = *reinterpret_cast<const float4*>(tile + r * C::kTRow + c);
    const float4 t1 = *reinterpret_cast<const float4*>(tile + r * C::kTRow + c + 4);
    float v[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    if (MODE == kResidual) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          g.res + static_cast<long long>(m0 + r) * g.ldr + n0 + c));
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __fadd_rn(__low2float(r2[e]), v[2 * e]);
        v[2 * e + 1] = __fadd_rn(__high2float(r2[e]), v[2 * e + 1]);
      }
    }
    if (MODE != kPlain) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], __ldg(g.bias + n0 + c + e));
    }
    uint4 o;
    o.x = pack_bf16(v[0], v[1]);
    o.y = pack_bf16(v[2], v[3]);
    o.z = pack_bf16(v[4], v[5]);
    o.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(g.out + static_cast<long long>(m0 + r) * g.n + n0 + c) = o;
  }
}

// BM = WGS x 64 rows by BN columns per block.
template <int WGS, int BN, int MODE>
__global__ void __launch_bounds__(WGS * 128, 1) w8a8_bf16_matmul_kernel(const Args g) {
  using C = Cfg<WGS, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));
  unsigned char* smem = smem_raw + (base - raw);
  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * BN;

  float acc[BN / 2];

  const int steps = g.k / kBK;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < steps) load_step<WGS, BN>(base + C::kRing, s, s, g, m0, n0);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // own copies of step 0 have landed
  convert_step<WGS, BN>(smem, 0, 0);
  for (int t = 0; t < steps; ++t) {
    fence_proxy_async();         // own conversion stores of step t -> wgmma
    __syncthreads();             // everyone's; step t - 2's wgmmas are done
    fence_operands(acc);
    wgmma_fence();
    mma_step<WGS, BN>(acc, base, t % kWBufs, t > 0);
    wgmma_commit();
    if (t + 1 < steps) {
      cp_async_wait<kStages - 2>();  // own copies of step t + 1 have landed
      // buffer set (t + 1) % 3 was last read by step t - 2's wgmmas
      convert_step<WGS, BN>(smem, (t + 1) % kStages, (t + 1) % kWBufs);
    }
    wgmma_wait<1>();             // step t - 1's wgmmas are done
    fence_operands(acc);
    // stage t % 3 held step t's codes, which this thread converted in step
    // t - 1: it takes step t + 3's
    if (t + kStages < steps) {
      load_step<WGS, BN>(base + C::kRing, t % kStages, t + kStages, g, m0, n0);
    }
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  fence_operands(acc);
  store_tile<WGS, BN, MODE>(acc, g, m0, n0, smem);
}

template <int WGS, int BN, int MODE>
int run(const Args& g, cudaStream_t stream) {
  using C = Cfg<WGS, BN>;
  if (g.n % BN != 0) return kErrUnsupported;
  auto kernel = w8a8_bf16_matmul_kernel<WGS, BN, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((g.m + C::BM - 1) / C::BM, g.n / BN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The tiles by id, as ops/quant_matmul.W8A8_BF16_TILES states them:
// (warpgroups, BN).
template <int MODE>
int dispatch(int tile, const Args& g, cudaStream_t s) {
  switch (tile) {
    case 0: return run<2, 256, MODE>(g, s);  // 128 x 256
    case 1: return run<2, 128, MODE>(g, s);  // 128 x 128
    case 2: return run<1, 64, MODE>(g, s);   // 64 x 64
  }
  return kErrUnsupported;
}

}  // namespace

// K7, K8 and K11 at the bf16 rate. xq (M, K) int8 with row stride lda, sx
// (M,) f32, q3 (depth, N, K) int8 with row stride ldb (a plain weight is
// depth 1; both strides multiples of 16; the codes 16-byte aligned), block
// idx taken; cs (N,) f32 (the block's); out (M, N) bf16 contiguous, 16-byte
// aligned. bias null: K7 (and K8); else (N,) f32, and res null or the
// residual (M, N) bf16, 16-byte aligned, with row stride ldr (a multiple of
// 8). ``k`` is the number of K codes summed (a multiple of 64); ``tile`` the
// tile's id (ops/quant_matmul.w8a8_bf16_tile).
extern "C" int ldt_w8a8_bf16_matmul_fwd(const void* xq, const void* sx, const void* q3,
                                        const void* cs, const void* bias, const void* res,
                                        void* out, int m, int n, int k, long long lda,
                                        long long ldb, long long ldr, int tile, int depth,
                                        int idx, void* stream) {
  const int mode = bias == nullptr ? kPlain : (res == nullptr ? kBias : kResidual);
  if (m < 1 || n < 1 || k < kBK || k % kBK != 0 || lda < k || lda % 16 != 0 || ldb < k ||
      ldb % 16 != 0 || idx < 0 || idx >= depth ||
      (mode == kResidual &&
       (ldr < n || ldr % 8 != 0 || reinterpret_cast<uintptr_t>(res) % 16 != 0))) {
    return kErrUnsupported;
  }
  const long long off = static_cast<long long>(idx) * n * ldb;
  const Args g{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
               static_cast<const int8_t*>(q3) + off, static_cast<const float*>(cs),
               static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
               static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, ldr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kResidual) return dispatch<kResidual>(tile, g, s);
  if (mode == kBias) return dispatch<kBias>(tile, g, s);
  return dispatch<kPlain>(tile, g, s);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
