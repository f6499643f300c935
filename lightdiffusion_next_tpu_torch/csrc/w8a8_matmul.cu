// K7, K8 and K11: int8 activations times int8 weights on the tensor cores,
// s32 accumulator, f32 epilogue, bf16 out.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py
//   _w8a8_matmul_2d (K7, pallas_call at :669; body _kernel_w8a8 at :89),
//   _w8a8_matmul_stacked_2d (K8, pallas_call at :793) and
//   _w8a8_matmul_ep_2d (K11, pallas_call at :1293, stacked at :1284;
//   bodies _kernel_w8a8_ep at :1105 and _kernel_w8a8_ep_res at :1128). K8
//   and the stacked K11 launch the very kernel K7 and K11 launch: their
//   entry points add block idx's offset to the codes (idx * N * ldb, and
//   for K8 idx * N to the column scales) on the host, in 64 bits (block 37
//   of the single blocks' linear1 stack starts 2.4e9 bytes in), and read
//   the block in place, never copied out.
//
// Operands: xq int8 (M, K) with per-row f32 scales sx (M,), from the row
// quantization (K9, K10); the weight's codes int8 (N, K), K-contiguous (the
// port's QTensor8W layout: 8-bit wgmma reads both operands K-major only),
// with per-column f32 scales cs (N,). The accumulator is exact (|acc| <=
// 127 * 127 * K < 2^31). Epilogues, in the JAX kernels' order of f32
// operations, each rounded (no contraction to FMA), so the bf16 result
// equals the plain version's bit for bit:
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
// The design: a wgmma GEMM, K5's (quant_matmul.cu) without the dequant.
// Hopper reaches its int8 rate only through wgmma.mma_async (m64nNk32
// .s32.s8.s8, the s32 accumulator in registers, both operands read from
// shared memory through 64-bit descriptors), so:
// - A (the xq tile) and B (the codes tile) are K-major with the 128-byte
//   swizzle: a K step is 128 codes, one 128-byte row per M or N row, and
//   the cp.async of 16-byte chunk c of row r lands at chunk c ^ (r & 7),
//   already swizzled: exactly K5's x tile with bytes in place of bf16
//   pairs, so hopper.cuh's make_desc serves as it is (stride offset = the
//   1024-byte atom of 8 rows) and each k32 slice advances the descriptor's
//   start by 32 bytes. The 32-byte swizzle of K4 (make_desc_sw32) was not
//   taken: it holds one k32 slice per 32-byte row, so a K step of 128 would
//   be four sub-tiles with four times the descriptors, and a thread's
//   16-byte copy would cover a quarter of a row's K step instead of an
//   eighth of a 128-byte line that 8 threads read whole.
// - A software pipeline with no producer warps: a ring of 4 cp.async
//   stages, each a K step's A and B tiles. Every thread copies. In step t
//   each thread waits for its own copies of step t, fences them to the
//   async proxy and meets the block at one barrier; past it, every
//   warpgroup has waited for its step t - 2 wgmmas, so the thread issues
//   the copies of step t + 2 into that stage, then step t's wgmmas, then
//   waits for its step t - 1 wgmmas (step t's stay in flight). Every
//   warpgroup reads the B tile of a stage, so a stage is refilled two steps
//   after it was read, not one (K5's B buffers are written by the dequant,
//   so its ring refills after one): two steps' copies are in flight under
//   one step's products. The first step's wgmmas overwrite the accumulator
//   (scale-d 0) instead of adding to zeroed registers: moves into the
//   accumulator made ptxas serialise the wgmmas (C7515).
// - The epilogue in two passes through shared memory (the ring, free after
//   the last products): the f32 (f32(acc) * sx) * cs from the fragments
//   (m64nNk32's s32 fragment is laid out per n8 column block like mma.sync
//   m16n8's: warp w of the warpgroup holds rows 16w + (lane >> 2) and 8
//   below, columns 2 (lane & 3) and the next), then the residual and bias
//   added and 16-byte chunks of bf16 stored, a warp's 32 chunks whole
//   128-byte lines, where 4-byte stores of the fragments wrote and read
//   half sectors.
// - Tiles by shape, chosen in Python (ops/quant_matmul.w8a8_tile, which
//   states the same table by id) and passed to the entry points:
//     id  tile       warpgroups x wgmmas per k32   registers  smem, blocks/SM
//     0   256 x 128  2 x two m64n128               254        193 KB, 1
//     1   192 x 256  3 x one m64n256               168        225 KB, 1
//     2   64 x 64    1 x one m64n64                96          65 KB, 3
//   ms per call on an H100 80GB HBM3 at 700 W (ablate_w8a8.py, with each
//   shape's epilogue), the chosen tile marked *, beside torch._int_mm
//   (no epilogue) and the bound:
//     (M, K, N)            256x128  192x256  128x256  64x128  64x64  _int_mm  bound
//     (4352, 3072, 21504)  0.5772*  0.5988   0.6399   0.7323  0.9301 0.7924  0.2905
//     (4352, 15360, 3072)  0.4612*  0.4651   0.4572   0.4878  0.7043 0.5279  0.2075
//     (4096, 12288, 3072)  0.2876   0.2706*  0.3025   0.3534  0.4989 0.3408  0.1563
//     (4096, 3072, 12288)  0.3159*  0.3229   0.3442   0.3934  0.4972 0.4511  0.1563
//     (4096, 3072, 9216)   0.2470*  0.2466   0.2632   0.2899  0.3744 0.3448  0.1172
//     (4096, 3072, 3072)   0.1022   0.0901*  0.1028   0.1145  0.1352 0.1097  0.0391
//     (1024, 12288, 3072)  0.0970*  0.1296   0.0966   0.1112  0.1080 0.1153  0.0391
//     (1280, 3072, 21504)  0.1882*  0.2033   0.2065   0.2124  0.2608 0.2337  0.0855
//     (256, 3072, 9216)    0.0287   0.0428   0.0313   0.0295  0.0270* 0.0318  0.0101
//     (256, 12288, 3072)   0.0962   0.1293   0.0961   0.0509  0.0447* 0.0586  0.0132
//     (256, 3072, 12288)   0.0304*  0.0441   0.0333   0.0369  0.0335 0.0321  0.0134
//   (the other five main-path shapes: PERF.md). 256 x 128 has the best
//   rate where a grid runs many waves; 192 x 256 wins where its grid is
//   whole waves and 256 x 128's last wave is partly empty; 64 x 64 at
//   M = 256, where larger tiles leave most SMs idle.
//   At linear1, MMA alone takes 0.30-0.34 ms (the bound: 0.2905), the
//   copies add 0.12-0.16 and the epilogue 0.075-0.12 (ablate_w8a8.py):
//   with every thread copying and one block per SM, neither hides under
//   the products.
// - Blocks walk M fastest (grid x over M, y over N): the blocks in flight
//   share one weight column tile through L2, so the weight streams from
//   device memory about once.
// - Rows past M are zero-filled by the copy (src size 0) and never stored,
//   so ragged M needs no padding copy.
// K must be a positive multiple of 128 and N a multiple of the tile's
// width.
//
// Left for later: TMA copies with a producer warpgroup and setmaxnreg (the
// copies under the products), a persistent grid (one tile's epilogue under
// the next tile's copies), and split-K or stream-K for N = 3072 (17 x 24
// tiles of 256 x 128 at M = 4352 are 3.09 waves) and M = 256 (s32 partial
// sums are exact, so a split-K stays bit for bit).
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;     // K codes per step: one 128-byte swizzle row
constexpr int kStages = 4;   // cp.async ring depth
constexpr int kErrUnsupported = 1000;

enum Mode { kPlain = 0, kBias = 1, kResidual = 2 };

// A launch's operands; b and cs already at the block of a stack.
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

// The shared-memory plan of a block of WGS warpgroups, each MT tiles of 64
// rows, by BN columns: a ring of stages, each the A tile then the B tile,
// every tile on a 1024-byte atom. After the last products the ring holds the
// epilogue's f32 tile, rows kTRow floats apart (8 of padding, so the 8 rows
// a warp's fragment store touches fall on distinct banks, two rows per
// 128-byte wavefront).
template <int WGS, int MT, int BN>
struct Cfg {
  static constexpr int kThreads = WGS * 128;
  static constexpr int BM = WGS * MT * 64;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kStage = kABytes + BN * kBK;
  static constexpr int kSmem = kStages * kStage + kAtom;  // + alignment
  static constexpr int kTRow = BN + 8;
  static_assert(BM * kTRow * 4 <= kStages * kStage, "the epilogue tile fits the ring");
};

// Issue the copies of K step `step` into ring stage `stage`: 16-byte chunk
// ch of row r lands at chunk ch ^ (r & 7) of the row's 128 bytes.
template <int WGS, int MT, int BN>
__device__ __forceinline__ void load_step(uint32_t base, int stage, int step,
                                          const Args& g, int m0, int n0) {
  using C = Cfg<WGS, MT, BN>;
  const uint32_t as = base + stage * C::kStage;
  const uint32_t bs = as + C::kABytes;
  const long long k0 = static_cast<long long>(step) * kBK;
#pragma unroll
  for (int i = 0; i < (C::BM * 8 + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (C::BM * 8 % C::kThreads != 0 && c >= C::BM * 8) break;
    const int r = c >> 3;
    const int ch = c & 7;
    const bool ok = m0 + r < g.m;
    const int8_t* src = g.a + (ok ? static_cast<long long>(m0 + r) * g.lda + k0 + ch * 16 : 0);
    cp_async_16(as + r * 128 + ((ch ^ (r & 7)) << 4), src, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < (BN * 8 + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (BN * 8 % C::kThreads != 0 && c >= BN * 8) break;
    const int r = c >> 3;
    const int ch = c & 7;
    cp_async_16(bs + r * 128 + ((ch ^ (r & 7)) << 4),
                g.b + static_cast<long long>(n0 + r) * g.ldb + k0 + ch * 16, 16);
  }
}

// One K step's products: 4 k32 slices of MT m64nBN wgmmas per warpgroup;
// scale = 0 (the first step) overwrites the accumulator, which is never
// zeroed: moves into it made ptxas serialise the wgmmas (C7515).
template <int WGS, int MT, int BN>
__device__ __forceinline__ void mma_step(uint32_t (&acc)[MT][BN / 2], uint32_t base,
                                         int stage, int scale) {
  using C = Cfg<WGS, MT, BN>;
  const int wg = threadIdx.x >> 7;
  const uint32_t a0 = base + stage * C::kStage + wg * MT * 64 * 128;
  const uint32_t b0 = base + stage * C::kStage + C::kABytes;
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    // 8-row atoms 1024 bytes apart (SBO); k32 = 32 bytes into the row
    const uint64_t db = make_desc(b0 + ks * 32, 16, kAtom);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wgmma_s8<BN>(acc[mt], make_desc(a0 + mt * 64 * 128 + ks * 32, 16, kAtom), db, scale | ks);
    }
  }
}

// The epilogue, in two passes through shared memory (the ring, free once
// every warpgroup's last products are done). Pass 1: each thread writes
// (f32(acc) * sx) * cs of its fragment into the f32 tile. Pass 2: each
// thread takes 8 consecutive columns of a row (a warp 256 consecutive
// columns of one row, or of two or four rows at BN = 128 or 64), adds the
// residual and the bias in the same rounded order and stores 16 bytes: the
// residual is read and the output written in whole 128-byte lines.
template <int WGS, int MT, int BN, int MODE>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[MT][BN / 2], const Args& g,
                                           int m0, int n0, unsigned char* smem) {
  using C = Cfg<WGS, MT, BN>;
  float* tile = reinterpret_cast<float*>(smem);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  __syncthreads();  // every warpgroup's last wgmmas have read the ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * MT + mt) * 64 + warp * 16 + (lane >> 2) + h * 8;
      const float s = m0 + r < g.m ? __ldg(g.sx + m0 + r) : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        float2 v;
        v.x = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc[mt][4 * j + 2 * h])), s),
                        __ldg(g.cs + n0 + c));
        v.y = __fmul_rn(
            __fmul_rn(__int2float_rn(static_cast<int>(acc[mt][4 * j + 2 * h + 1])), s),
            __ldg(g.cs + n0 + c + 1));
        *reinterpret_cast<float2*>(tile + r * C::kTRow + c) = v;
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;  // 16-byte output chunks per row
  static_assert(C::BM * kChunks % C::kThreads == 0, "chunks per thread");
  // unrolled with the residual read through the read-only path, so the
  // loads of every chunk are in flight together
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

// BM = WGS x MT x 64 rows by BN columns per block.
template <int WGS, int MT, int BN, int MODE>
__global__ void __launch_bounds__(WGS * 128, 1) w8a8_matmul_kernel(const Args g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));
  const int m0 = blockIdx.x * Cfg<WGS, MT, BN>::BM;
  const int n0 = blockIdx.y * BN;

  uint32_t acc[MT][BN / 2];

  const int steps = g.k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load_step<WGS, MT, BN>(base, s, s, g, m0, n0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 3>();  // own copies of step t have landed
    fence_proxy_async();           // ... and are visible to wgmma
    __syncthreads();               // everyone's; step t - 2's wgmmas are done
    // the stage of step t - 2 takes step t + 2
    const int next = t + kStages - 2;
    if (next < steps) load_step<WGS, MT, BN>(base, next % kStages, next, g, m0, n0);
    cp_async_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
    wgmma_fence();
    mma_step<WGS, MT, BN>(acc, base, t % kStages, t > 0);
    wgmma_commit();
    wgmma_wait<1>();               // step t - 1's wgmmas are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
  store_tile<WGS, MT, BN, MODE>(acc, g, m0, n0, smem_raw + (base - raw));
}

template <int WGS, int MT, int BN, int MODE>
int run(const Args& g, cudaStream_t stream) {
  using C = Cfg<WGS, MT, BN>;
  if (g.n % BN != 0) return kErrUnsupported;
  auto kernel = w8a8_matmul_kernel<WGS, MT, BN, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((g.m + C::BM - 1) / C::BM, g.n / BN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The tiles by id, as ops/quant_matmul.W8A8_TILES states them:
// (warpgroups, m64 tiles per warpgroup, BN).
template <int MODE>
int dispatch(int tile, const Args& g, cudaStream_t s) {
  switch (tile) {
    case 0: return run<2, 2, 128, MODE>(g, s);  // 256 x 128
    case 1: return run<3, 1, 256, MODE>(g, s);  // 192 x 256
    case 2: return run<1, 1, 64, MODE>(g, s);   // 64 x 64
  }
  return kErrUnsupported;
}

int launch(const void* xq, const void* sx, const void* q, const void* cs,
           const void* bias, const void* res, void* out, int m, int n, int k,
           long long lda, long long ldb, long long ldr, int tile, void* stream) {
  const int mode = bias == nullptr ? kPlain : (res == nullptr ? kBias : kResidual);
  if (m < 1 || n < 1 || k < kBK || k % kBK != 0 || lda < k || lda % 16 != 0 || ldb < k ||
      ldb % 16 != 0 ||
      (mode == kResidual &&
       (ldr < n || ldr % 8 != 0 || reinterpret_cast<uintptr_t>(res) % 16 != 0))) {
    return kErrUnsupported;
  }
  const Args g{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
               static_cast<const int8_t*>(q), static_cast<const float*>(cs),
               static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
               static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, ldr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kResidual) return dispatch<kResidual>(tile, g, s);
  if (mode == kBias) return dispatch<kBias>(tile, g, s);
  return dispatch<kPlain>(tile, g, s);
}

// Block idx of a stack of depth blocks of n rows of ldb codes each: its
// offset in codes, or -1 outside the stack.
long long block_offset(int depth, int idx, int n, long long ldb) {
  if (idx < 0 || idx >= depth) return -1;
  return static_cast<long long>(idx) * n * ldb;
}

}  // namespace

// K7. xq (M, K) int8 with row stride lda, sx (M,) f32, q (N, K) int8 with
// row stride ldb (both strides multiples of 16), cs (N,) f32, out (M, N)
// bf16 contiguous; every pointer 16-byte aligned. ``k`` is the number of K
// bytes summed (a multiple of 128); ``tile`` the tile's id
// (ops/quant_matmul.w8a8_tile).
extern "C" int ldt_w8a8_matmul_fwd(const void* xq, const void* sx,
                                   const void* q, const void* cs, void* out,
                                   int m, int n, int k, long long lda,
                                   long long ldb, int tile, void* stream) {
  return launch(xq, sx, q, cs, nullptr, nullptr, out, m, n, k, lda, ldb, 0, tile, stream);
}

// K11. As K7 with bias (N,) f32 and, when res is not null, the residual
// (M, N) bf16, 16-byte aligned, with row stride ldr (a multiple of 8).
extern "C" int ldt_w8a8_matmul_ep_fwd(const void* xq, const void* sx,
                                      const void* q, const void* cs,
                                      const void* bias, const void* res,
                                      void* out, int m, int n, int k,
                                      long long lda, long long ldb,
                                      long long ldr, int tile, void* stream) {
  if (bias == nullptr) return kErrUnsupported;
  return launch(xq, sx, q, cs, bias, res, out, m, n, k, lda, ldb, ldr, tile, stream);
}

// K8. As K7 on block idx (0 <= idx < depth) of q3 (depth, N, K) int8 with
// row stride ldb, and of cs3 (depth, 1, N) f32; both contiguous.
extern "C" int ldt_w8a8_matmul_stacked_fwd(const void* xq, const void* sx,
                                           const void* q3, const void* cs3,
                                           void* out, int m, int n, int k,
                                           long long lda, long long ldb,
                                           int tile, int depth, int idx,
                                           void* stream) {
  const long long off = block_offset(depth, idx, n, ldb);
  if (off < 0) return kErrUnsupported;
  return launch(xq, sx, static_cast<const int8_t*>(q3) + off,
                static_cast<const float*>(cs3) + static_cast<long long>(idx) * n, nullptr,
                nullptr, out, m, n, k, lda, ldb, 0, tile, stream);
}

// The stacked K11. As K11 on block idx (0 <= idx < depth) of q3 (depth, N,
// K) int8 with row stride ldb; cs (N,) and bias (N,) are the caller's folds
// of that block's column scales.
extern "C" int ldt_w8a8_matmul_ep_stacked_fwd(
    const void* xq, const void* sx, const void* q3, const void* cs,
    const void* bias, const void* res, void* out, int m, int n, int k,
    long long lda, long long ldb, long long ldr, int tile, int depth, int idx,
    void* stream) {
  const long long off = block_offset(depth, idx, n, ldb);
  if (bias == nullptr || off < 0) return kErrUnsupported;
  return launch(xq, sx, static_cast<const int8_t*>(q3) + off, cs, bias, res, out, m, n, k,
                lda, ldb, ldr, tile, stream);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
