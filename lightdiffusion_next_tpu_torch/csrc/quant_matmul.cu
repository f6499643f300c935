// K5: x (M, K) bf16 times a Q8_0 weight, out (M, N) bf16; K6: the same
// on block idx of a stack of D Q8_0 weights.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py _quant_matmul_2d
//   (K5, pallas_call at :360, kernel body _kernel at :39, _dequant at :30;
//   the opt-in weight-stationary grid at :319, _kernel_wstation at :56,
//   computes the same function) and _quant_matmul_stacked_2d (K6,
//   pallas_call at :497, body _kernel_stacked at :134, which takes the
//   block through scalar prefetch). K6 is K5's kernel instantiated with
//   STACKED: the block's codes and scales are read in place from the
//   (D, K, N) and (D, K/32, N) stacks at 64-bit offsets (block 37 of the
//   single blocks' linear1 stack starts 2.4e9 bytes in), never copied out.
//
// The weight is stored transposed, as on the TPU: codes qt int8 (K, N) and
// scales_t f32 (K/32, N), one scale per 32 consecutive K rows of a column.
// Each weight element is dequantized as f32(q) * scale, rounded to nearest
// even bf16 (the Pallas kernel's _dequant for a bf16 x), so the kernel's
// weights equal the plain version's bit for bit; the products accumulate in
// f32 and the result is rounded to bf16 once.
//
// What bounds it on an H100: 2 M K N FLOP at the bf16 tensor-core rate
// (989 TFLOP/s) against 2 M K + K N + 4 K N / 32 + 2 M N bytes at 3.35 TB/s.
// Every main-path call is bound by operations: linear1 (4352, 3072, 21504)
// 0.581 ms, img qkv (4096, 3072, 9216) 0.235 ms, T5 (256, 3072, 3072)
// 0.0049 ms.
//
// The design: a wgmma GEMM. Hopper reaches its bf16 tensor-core rate only
// through wgmma.mma_async (m64nNk16, f32 accumulators in registers, both
// operands read from shared memory through 64-bit descriptors), so:
// - A is the x tile, K-major with the 128-byte swizzle: a K step is 64
//   deep (two Q8_0 scale rows), one 128-byte row of bf16 per M row, and the
//   cp.async of 16-byte chunk c of row r lands at chunk c ^ (r & 7), already
//   swizzled. Each k16 slice advances the descriptor's start by 32 bytes.
// - B is the dequantized weight tile. The codes arrive as (K, N),
//   N-contiguous, and are dequantized into an N-major (MN-major) bf16 tile
//   with the 128-byte swizzle: atoms of 8 K rows x 64 N columns (1024
//   bytes, 16-byte chunk j of K row r at j ^ (r & 7)), K atoms 1024 bytes
//   apart (the descriptor's stride offset), 64-column blocks 8192 bytes
//   apart (its leading offset). wgmma reads it with its transpose-B form
//   (tnspB = 1), so nothing is transposed in registers.
// - A software pipeline with no producer warps: a ring of 4 cp.async
//   stages (x tile, int8 codes, the step's two f32 scale rows) and three
//   bf16 B buffers. In step t every thread waits for step t + 1's copies,
//   fences its generic-proxy writes (landed copies, dequant stores) to the
//   async proxy, meets the block at a barrier, issues step t's wgmmas on B
//   buffer t % 3, dequantizes step t + 1's codes into buffer (t + 1) % 3
//   while they run, waits for step t - 1's wgmmas (step t's stay in
//   flight) and issues the copies of step t + 3. A weight tile is
//   dequantized once per block, 1 byte per weight read from device memory.
//   The int8 -> f32 conversion is the exponent trick (0x4B000000 |
//   (q + 128), minus 2^23 + 128: exact) instead of I2F.
// - Tiles by shape: 256 x 128 (two warpgroups of two m64n128 tiles, 204
//   registers, 213 KB of shared memory, 1 block per SM), or 64 x 64 (one
//   warpgroup, 103 registers, 75 KB, 3 blocks per SM by shared memory)
//   where 256 x 128 tiles would leave more than half the SMs idle (T5's
//   and the text stream's M = 256 with N = 3072 or 4096: 4 x 48 blocks at
//   N = 3072). No instantiation spills. Of four tiles timed on the card
//   (also 64 x 128 and 128 x 128; ablate_quant_matmul.py), 256 x 128 was
//   the fastest at every shape timed with M >= 1024 or N >= 9216, 64 x 64
//   at the others.
// - Blocks walk M fastest (grid x over M, y over N): the blocks in flight
//   share one weight column tile through L2, so the weight streams from
//   device memory about once (the TPU kernel's weight-stationary order).
// - The epilogue rounds the m16n8-shaped accumulator fragments to bf16 and
//   stores them under the row < m mask; rows past M are zero-filled by the
//   copy (src size 0) and never stored, so ragged M needs no padding copy.
// K must be a multiple of 64 and N of 128 (ops/quant_matmul.supported asks
// for 256 and 128, as the JAX package does).
//
// Times on an H100 80GB HBM3 at 700 W (chip_smoke.py, ms per call, through
// the wrapper), the ldmatrix + mma.sync design this replaces beside this
// one, with torch.matmul on the weight dequantized beforehand and the bound:
//   (M, K, N)            calls/image  mma.sync  wgmma  library  bound
//   (256, 3072, 3072)    418          0.0798    0.0349 0.0139   0.0049
//   (256, 3072, 9216)    418          0.1771    0.0636 0.0298   0.0147
//   (256, 3072, 12288)   418          0.1765    0.0652 0.0332   0.0195
//   (256, 4096, 4096)    192          0.1063    0.0458 0.0210   0.0087
//   (256, 4096, 10240)   96           0.2295    0.0816 0.0414   0.0217
//   (256, 10240, 4096)   48           0.2558    0.1076 0.0436   0.0217
//   (256, 12288, 3072)   418          0.2996    0.1285 0.0491   0.0195
//   (1024, 3072, 3072)   38           0.1735    0.0642 0.0279   0.0195
//   (1024, 3072, 9216)   38           0.5191    0.1888 0.0801   0.0586
//   (1024, 3072, 12288)  38           0.6913    0.1925 0.1027   0.0782
//   (1024, 12288, 3072)  38           0.6831    0.2273 0.1001   0.0782
//   (1280, 3072, 21504)  76           1.0062    0.4312 0.2266   0.1710
//   (1280, 15360, 3072)  76           0.7079    0.2938 0.1533   0.1221
//   (4096, 3072, 3072)   380          0.3899    0.1944 0.1014   0.0782
//   (4096, 3072, 9216)   380          1.1340    0.5633 0.3031   0.2345
//   (4096, 3072, 12288)  380          1.5214    0.7428 0.3924   0.3127
//   (4096, 12288, 3072)  380          1.4842    0.7390 0.3820   0.3127
//   (4352, 3072, 21504)  760          2.7005    1.3893 0.7437   0.5814
//   (4352, 15360, 3072)  760          2.4683    1.1870 0.5252   0.4153
// per Q8_0 image: 6219 ms before, 3034 now; the library 1516, the bound
// 1174 (plus T5's calls of one W8A8 image). At linear1, MMA alone (no copies,
// no dequant) takes 0.77 ms and the copies and dequant alone 0.99 ms
// (ablate_quant_matmul.py): with every thread doing both, they overlap
// badly.
//
// Left for later: TMA copies with mbarrier transaction counts, warp
// specialisation (a producer warp and register reallocation), a persistent
// grid that overlaps one tile's epilogue with the next one's loads, and
// split-K for M = 256, whose grids are a single wave.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;       // K rows per step: two Q8_0 scale rows
constexpr int kQBlock = 32;
constexpr int kStages = 4;    // cp.async ring depth
constexpr int kWBufs = 3;     // bf16 B buffers: two wgmma groups in flight read
                              // two, the dequant writes the third
constexpr int kErrUnsupported = 1000;

// The shared-memory plan of a block of WGS warpgroups, each MT tiles of 64
// rows, by BN columns. The bf16 B buffers, then the ring of x tiles, codes
// and scales; x tiles and B buffers start on 1024-byte atoms.
template <int WGS, int MT, int BN>
struct Cfg {
  static constexpr int kThreads = WGS * 128;
  static constexpr int BM = WGS * MT * 64;
  static constexpr int kBN = BN;
  static constexpr int kWBytes = kBK * BN * 2;  // one B buffer
  static constexpr int kNBlock = kBK * 128;     // B: bytes per 64 N columns
  static constexpr int kXBytes = BM * kBK * 2;  // one x stage
  static constexpr int kQBytes = kBK * BN;      // one code stage
  static constexpr int kSBytes = (kBK / kQBlock) * BN * 4;
  static constexpr int kX = kWBufs * kWBytes;
  static constexpr int kQ = kX + kStages * kXBytes;
  static constexpr int kS = kQ + kStages * kQBytes;
  static constexpr int kSmem = kS + kStages * kSBytes + kAtom;  // + alignment
};

// four int8 codes -> four exact f32: 0x4B000000 | (q + 128) is 2^23 + q + 128
__device__ __forceinline__ void codes_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Issue the copies of step `step`'s x tile into ring stage `stage`: each
// warpgroup copies the rows its own wgmmas read, written swizzled.
template <class C>
__device__ __forceinline__ void load_x(uint32_t base, int stage, int step,
                                       const __nv_bfloat16* __restrict__ x,
                                       int m, long long lda, int m0) {
  constexpr int kWgRows = C::BM / (C::kThreads / 128);
  const uint32_t xs = base + C::kX + stage * C::kXBytes;
  const int k0 = step * kBK;
#pragma unroll
  for (int i = 0; i < kWgRows * 8 / 128; ++i) {
    const int c = (threadIdx.x & 127) + i * 128;
    const int r = (threadIdx.x >> 7) * kWgRows + (c >> 3);
    const int ch = c & 7;
    const bool ok = m0 + r < m;
    const __nv_bfloat16* src =
        x + (ok ? static_cast<long long>(m0 + r) * lda + k0 + ch * 8 : 0);
    cp_async_16(xs + r * 128 + ((ch ^ (r & 7)) << 4), src, ok ? 16 : 0);
  }
}

// Issue the copies of step `step`'s codes (64 rows x BN bytes) and its two
// scale rows into ring stage `stage`; all threads share them.
template <class C>
__device__ __forceinline__ void load_codes(uint32_t base, int stage, int step,
                                           const int8_t* __restrict__ qt,
                                           const float* __restrict__ scales,
                                           int n, int n0) {
  constexpr int BN = C::kBN;
  constexpr int kQRow = BN / 16;
  constexpr int kSRow = BN / 4;
  static_assert(kBK * kQRow % C::kThreads == 0 && 2 * kSRow <= C::kThreads,
                "copies per thread");
  const uint32_t qs = base + C::kQ + stage * C::kQBytes;
  const int k0 = step * kBK;
#pragma unroll
  for (int i = 0; i < kBK * kQRow / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    const int r = c / kQRow;
    const int ch = c % kQRow;
    cp_async_16(qs + c * 16,
                qt + static_cast<long long>(k0 + r) * n + n0 + ch * 16, 16);
  }
  if (threadIdx.x < 2 * kSRow) {
    const int c = threadIdx.x;
    const int r = c / kSRow;
    const int ch = c % kSRow;
    cp_async_16(base + C::kS + stage * C::kSBytes + c * 16,
                scales + static_cast<long long>(k0 / kQBlock + r) * n + n0 +
                    ch * 4,
                16);
  }
}

// Codes and scales of ring stage `stage` -> B buffer `buf` (bf16, N-major,
// 128-byte swizzle). Thread: one chunk of 8 columns over kRows K rows that
// share one scale row; a warp reads whole code rows and writes whole
// 128-byte swizzle rows.
template <class C>
__device__ __forceinline__ void dequant_step(unsigned char* smem, int stage,
                                             int buf) {
  constexpr int BN = C::kBN;
  constexpr int kChunks = BN / 8;
  constexpr int kRows = kBK * kChunks / C::kThreads;
  static_assert(kRows >= 1 && kQBlock % kRows == 0, "rows cross a scale row");
  const int c = threadIdx.x % kChunks;
  const int r0 = (threadIdx.x / kChunks) * kRows;
  const unsigned char* q = smem + C::kQ + stage * C::kQBytes + c * 8;
  const float* s = reinterpret_cast<const float*>(smem + C::kS + stage * C::kSBytes) +
                   (r0 / kQBlock) * BN + c * 8;
  const float4 s0 = *reinterpret_cast<const float4*>(s);
  const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
  unsigned char* w = smem + buf * C::kWBytes + (c >> 3) * C::kNBlock;
  const int cc = c & 7;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    const uint2 raw = *reinterpret_cast<const uint2*>(q + r * BN);
    float f[8];
    codes_to_f32(raw.x, f);
    codes_to_f32(raw.y, f + 4);
    uint4 v;
    v.x = pack_bf16(f[0] * s0.x, f[1] * s0.y);
    v.y = pack_bf16(f[2] * s0.z, f[3] * s0.w);
    v.z = pack_bf16(f[4] * s1.x, f[5] * s1.y);
    v.w = pack_bf16(f[6] * s1.z, f[7] * s1.w);
    *reinterpret_cast<uint4*>(w + (r >> 3) * kAtom + (r & 7) * 128 +
                              ((cc ^ (r & 7)) << 4)) = v;
  }
}

// one step's products: MT x 4 wgmmas per warpgroup on x stage `stage` and
// B buffer `buf`
template <class C, int MT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][C::kBN / 2],
                                         uint32_t base, int stage, int buf) {
  const int wg = threadIdx.x >> 7;
  const uint32_t a0 = base + C::kX + stage * C::kXBytes + wg * MT * 64 * 128;
  const uint32_t b0 = base + buf * C::kWBytes;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    // B: k16 = two 8-row atoms (SBO), 64-column blocks kNBlock apart (LBO)
    const uint64_t db = make_desc(b0 + ks * 2 * kAtom, C::kNBlock, kAtom);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // A: 8-row atoms 1024 bytes apart (SBO); k16 = 32 bytes into the row
      const uint64_t da = make_desc(a0 + mt * 64 * 128 + ks * 32, 16, kAtom);
      wgmma<C::kBN, 1>(acc[mt], da, db);
    }
  }
}

// BM = WGS x MT x 64 rows by BN columns per block, WGS warpgroups of MT
// m64 tiles each. STACKED: qt and scales are stacks; block idx starts
// q_block codes and s_block scales in.
template <int WGS, int MT, int BN, bool STACKED>
__global__ void __launch_bounds__(WGS * 128, 1)
    quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ qt,
                        const float* __restrict__ scales,
                        __nv_bfloat16* __restrict__ out, int m, int n, int k,
                        long long lda, long long q_block, long long s_block,
                        int idx) {
  using C = Cfg<WGS, MT, BN>;
  if (STACKED) {
    qt += static_cast<long long>(idx) * q_block;
    scales += static_cast<long long>(idx) * s_block;
  }
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const uint32_t base = smem_addr(smem);

  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * BN;

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[mt][j] = 0.f;

  const int steps = k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_x<C>(base, s, s, x, m, lda, m0);
      load_codes<C>(base, s, s, qt, scales, n, n0);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // step 0 has landed
  __syncthreads();
  dequant_step<C>(smem, 0, 0);

  // Step t: step t - 1's wgmmas may still run when step t's are issued, so
  // the tensor cores need not wait for the block's barrier.
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 3>();  // step t + 1 has landed (own copies)
    fence_proxy_async();           // own dequant stores and copies -> wgmma
    __syncthreads();               // everyone's; step t - 2's wgmmas are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
    wgmma_fence();
    mma_step<C, MT>(acc, base, t % kStages, t % kWBufs);
    wgmma_commit();
    // B buffer (t + 1) % 3 was last read by step t - 2's wgmmas
    if (t + 1 < steps) dequant_step<C>(smem, (t + 1) % kStages, (t + 1) % kWBufs);
    wgmma_wait<1>();               // step t - 1's wgmmas are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
    // ring stage (t + 3) % 4 held step t - 1: its x rows were read by this
    // warpgroup's step t - 1 wgmmas, its codes by the dequant in step t - 2
    const int next = t + kStages - 1;
    if (next < steps) {
      load_x<C>(base, next % kStages, next, x, m, lda, m0);
      load_codes<C>(base, next % kStages, next, qt, scales, n, n0);
    }
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);

  // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
  // per 8 columns, mma.sync m16n8's C fragment
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + (wg * MT + mt) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;
      if (row < m) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n + col) =
            pack_bf16(acc[mt][4 * j], acc[mt][4 * j + 1]);
      }
      if (row + 8 < m) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row + 8) * n + col) =
            pack_bf16(acc[mt][4 * j + 2], acc[mt][4 * j + 3]);
      }
    }
  }
}

template <int WGS, int MT, int BN, bool STACKED>
int launch(const __nv_bfloat16* x, const int8_t* qt, const float* scales,
           __nv_bfloat16* out, int m, int n, int k, long long lda,
           long long q_block, long long s_block, int idx, cudaStream_t stream) {
  using C = Cfg<WGS, MT, BN>;
  auto kernel = quant_matmul_kernel<WGS, MT, BN, STACKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((m + C::BM - 1) / C::BM, n / BN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      x, qt, scales, out, m, n, k, lda, q_block, s_block, idx);
  return static_cast<int>(cudaGetLastError());
}

template <bool STACKED>
int dispatch(const void* x, const void* qt, const void* scales, void* out,
             int m, int n, int k, long long lda, long long q_block,
             long long s_block, int idx, void* stream) {
  if (m < 1 || n < 128 || n % 128 != 0 || k < kBK || k % kBK != 0 ||
      lda < k || lda % 8 != 0) {
    return kErrUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const int8_t*>(qt);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  // 256 x 128 tiles (two warpgroups of two m64 tiles) unless their grid
  // would leave more than half the SMs idle: then 64 x 64 (one warpgroup)
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (2LL * ((m + 255) / 256) * (n / 128) >= sms) {
    return launch<2, 2, 128, STACKED>(xb, q, sc, o, m, n, k, lda, q_block,
                                      s_block, idx, s);
  }
  return launch<1, 1, 64, STACKED>(xb, q, sc, o, m, n, k, lda, q_block,
                                   s_block, idx, s);
}

}  // namespace

// K5. x (M, K) bf16 with row stride lda (elements, a multiple of 8), qt
// (K, N) int8 and scales (K/32, N) f32 contiguous, out (M, N) bf16
// contiguous. Every pointer 16-byte aligned. ``k`` is the number of K rows
// summed (K unless a check plants a fault).
extern "C" int ldt_quant_matmul_fwd(const void* x, const void* qt,
                                    const void* scales, void* out, int m,
                                    int n, int k, long long lda,
                                    void* stream) {
  return dispatch<false>(x, qt, scales, out, m, n, k, lda, 0, 0, 0, stream);
}

// K6. As K5 on block idx (0 <= idx < depth) of qt3 (depth, K, N) int8 and
// scales3 (depth, K/32, N) f32, both contiguous, with x contiguous: lda is
// the blocks' K, from which the block strides follow (k <= K rows summed).
extern "C" int ldt_quant_matmul_stacked_fwd(const void* x, const void* qt3,
                                            const void* scales3, void* out,
                                            int m, int n, int k, long long lda,
                                            int depth, int idx, void* stream) {
  if (idx < 0 || idx >= depth || lda % kQBlock != 0) return kErrUnsupported;
  const long long q_block = lda * static_cast<long long>(n);
  return dispatch<true>(x, qt3, scales3, out, m, n, k, lda, q_block,
                        q_block / kQBlock, idx, stream);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
